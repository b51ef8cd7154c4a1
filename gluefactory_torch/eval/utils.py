"""Per-pair evaluation of cached predictions (gluefactory_tpu/eval/utils.py):
match precision under the ground-truth homography, weighted DLT with IRLS,
RANSAC, and the AUC of a threshold sweep with the best threshold by mAA.

Predictions come in as numpy arrays of one pair; the geometry runs on
``device`` (the card unless the caller passes 'cpu'). Points only: a
prediction with line matches is refused until the line-aware estimators
are ported."""

from __future__ import annotations

import numpy as np
import torch

from ..geometry.homography import (
    compute_homography,
    homography_corner_error,
    sym_homography_error,
    warp_points,
)
from ..robust_estimators import load_estimator
from ..utils.device import resolve_device
from ..utils.tools import AUCMetric

DEFAULT_SIZE = (640.0, 480.0)  # (w, h) when a pair carries no image_size


def get_matches_scores(kpts0, kpts1, matches0, mscores0):
    """(kpts0, kpts1 gathered by the matches, scores, valid) of one pair;
    match code -1 is unmatched."""
    m0 = np.asarray(matches0)
    valid = m0 > -1
    return (np.asarray(kpts0), np.asarray(kpts1)[np.clip(m0, 0, None)],
            np.asarray(mscores0), valid)


def _refuse_lines(pred: dict) -> None:
    if "lines0" in pred or "line_matches0" in pred:
        raise NotImplementedError("line matches are not ported; the homography "
                                  "evaluation takes points only")


def _tensor(x, device, dtype=torch.float32) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


def _image_size(data: dict, device) -> torch.Tensor:
    size = data.get("view0", {}).get("image_size")
    return _tensor(DEFAULT_SIZE if size is None else size, device).reshape(2)


def eval_matches_homography(data: dict, pred: dict, device="cuda") -> dict:
    """Matches, keypoints, precision at 1/3/5 px and the mean error of the
    matches under the ground-truth homography."""
    _refuse_lines(pred)
    device = resolve_device(device)
    pts0, pts1, _, valid = get_matches_scores(pred["keypoints0"], pred["keypoints1"],
                                              pred["matches0"], pred["matching_scores0"])
    err = sym_homography_error(_tensor(pts0, device)[None], _tensor(pts1, device)[None],
                               _tensor(data["H_0to1"], device)[None])[0].cpu().numpy()
    err_m = err[valid]
    results = {"num_matches": int(valid.sum()),
               "num_keypoints": int(np.asarray(
                   pred.get("keypoint_valid0", np.ones(len(pts0)))).sum())}
    for th in (1, 3, 5):
        results[f"prec@{th}px"] = float((err_m < th).mean()) if valid.any() else np.nan
    results["match_error_mean"] = float(err_m.mean()) if valid.any() else np.nan
    return results


def eval_homography_dlt(data: dict, pred: dict, irls: int = 3, device="cuda") -> dict:
    """Corner error of the score-weighted DLT homography of the matches, after
    ``irls`` Cauchy reweighting passes (scale 2 px)."""
    _refuse_lines(pred)
    device = resolve_device(device)
    pts0, pts1, scores, valid = get_matches_scores(
        pred["keypoints0"], pred["keypoints1"], pred["matches0"], pred["matching_scores0"])
    if valid.sum() < 4:
        return {"H_error_dlt": np.nan}
    w = _tensor((scores * valid).astype(np.float32), device)[None]
    p0, p1 = _tensor(pts0, device)[None], _tensor(pts1, device)[None]
    H = compute_homography(p0, p1, w)
    for _ in range(int(irls)):
        r = torch.sqrt(((warp_points(p0, H) - p1) ** 2).sum(-1) + 1e-12)
        H = compute_homography(p0, p1, w / (1.0 + (r / 2.0) ** 2))
    err = float(homography_corner_error(H, _tensor(data["H_0to1"], device)[None],
                                        _image_size(data, device)[None])[0])
    return {"H_error_dlt": err if np.isfinite(err) else np.nan}


def eval_homography_robust(data: dict, pred: dict, conf: dict, device="cuda",
                           sample_idx: np.ndarray | None = None) -> dict:
    """Corner error and inliers of the robust estimator named by
    ``conf['estimator']`` (RANSAC). ``sample_idx`` (S, 4) fixes its minimal
    sets."""
    _refuse_lines(pred)
    device = resolve_device(device)
    pts0, pts1, _, valid = get_matches_scores(pred["keypoints0"], pred["keypoints1"],
                                              pred["matches0"], pred["matching_scores0"])
    estimator = load_estimator("homography", conf.get("estimator", "ransac"))(conf)
    est_data = {"m_kpts0": _tensor(pts0, device), "m_kpts1": _tensor(pts1, device),
                "valid": torch.as_tensor(valid, device=device)}
    if sample_idx is not None:
        est_data["sample_idx"] = torch.tensor(np.asarray(sample_idx), dtype=torch.long,
                                              device=device)
    est = estimator(est_data)
    if not est["success"]:
        return {"H_error_ransac": np.nan, "ransac_inl": 0, "ransac_inl%": 0.0}
    err = homography_corner_error(est["M_0to1"][None], _tensor(data["H_0to1"], device)[None],
                                  _image_size(data, device)[None])
    n_inliers = int(est["inliers"].sum())
    return {"H_error_ransac": float(err[0]), "ransac_inl": n_inliers,
            "ransac_inl%": float(n_inliers / max(valid.sum(), 1))}


def eval_poses(pose_results: dict, auc_ths: list, key: str, unit: str = "°") -> dict:
    """AUCs of each threshold's errors; the threshold with the best mean AUC
    (mAA) gives the summary."""
    pose_aucs = {}
    for th, results_i in pose_results.items():
        errs = [r[key] for r in results_i]
        errs = [1e6 if (e is None or not np.isfinite(e)) else e for e in errs]
        pose_aucs[th] = AUCMetric(auc_ths, errs).compute()
    mAAs = {k: np.mean(v) for k, v in pose_aucs.items()}
    best_th = max(mAAs, key=mAAs.get)
    summaries = {}
    for i, ath in enumerate(auc_ths):
        summaries[f"{key}@{ath}{unit}"] = round(pose_aucs[best_th][i] * 100, 3)
    summaries[f"{key}_mAA"] = round(mAAs[best_th] * 100, 3)
    summaries["best_ransac_th"] = best_th
    return summaries
