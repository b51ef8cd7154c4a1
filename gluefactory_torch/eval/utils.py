"""Per-pair evaluation of cached predictions (gluefactory_tpu/eval/utils.py):
match precision under the ground-truth homography or epipolar geometry,
weighted DLT with IRLS, robust homography and relative pose, and the AUC of
a threshold sweep with the best threshold by mAA. A failed estimate is NaN.

Predictions come in as numpy arrays of one pair; the geometry runs on
``device`` (the card unless the caller passes 'cpu'). The point metrics
ignore lines; the robust homography feeds a prediction's matched lines to
the estimator (``hybrid_ransac`` uses them, ``ransac`` does not)."""

from __future__ import annotations

import numpy as np
import torch

from ..geometry.epipolar import generalized_epi_dist, relative_pose_error
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


def _tensor(x, device, dtype=torch.float32) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


def _image_size(data: dict, device) -> torch.Tensor:
    size = data.get("view0", {}).get("image_size")
    return _tensor(DEFAULT_SIZE if size is None else size, device).reshape(2)


def eval_matches_homography(data: dict, pred: dict, device="cuda") -> dict:
    """Matches, keypoints, precision at 1/3/5 px and the mean error of the
    matches under the ground-truth homography."""
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
    ``conf['estimator']`` (``ransac``, ``hybrid_ransac``). Where the
    prediction holds ``lines0`` and ``line_matches0``, the matched segments
    go to the estimator as ``m_lines0``/``m_lines1`` (``orig_lines*`` where
    present), invalid lines and unmatched ones masked by ``valid_lines``.
    ``sample_idx`` (S, 4) fixes its minimal sets."""
    device = resolve_device(device)
    pts0, pts1, _, valid = get_matches_scores(pred["keypoints0"], pred["keypoints1"],
                                              pred["matches0"], pred["matching_scores0"])
    estimator = load_estimator("homography", conf.get("estimator", "ransac"))(conf)
    est_data = {"m_kpts0": _tensor(pts0, device), "m_kpts1": _tensor(pts1, device),
                "valid": torch.as_tensor(valid, device=device)}
    if "lines0" in pred and "line_matches0" in pred:
        l0 = np.asarray(pred.get("orig_lines0", pred["lines0"]))
        l1 = np.asarray(pred.get("orig_lines1", pred["lines1"]))
        lm0 = np.asarray(pred["line_matches0"]).astype(int)
        lvalid = lm0 > -1
        if "valid_lines0" in pred:
            lvalid = lvalid & np.asarray(pred["valid_lines0"]).astype(bool)
        est_data["m_lines0"] = _tensor(l0, device)
        est_data["m_lines1"] = _tensor(l1[np.clip(lm0, 0, len(l1) - 1)], device)
        est_data["valid_lines"] = torch.as_tensor(lvalid, device=device)
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


def eval_matches_epipolar(data: dict, pred: dict, device="cuda") -> dict:
    """Matches and the share of them within 1e-4, 5e-4 and 1e-3 (normalized
    units) of their epipolar lines under the ground-truth pose."""
    device = resolve_device(device)
    pts0, pts1, _, valid = get_matches_scores(pred["keypoints0"], pred["keypoints1"],
                                              pred["matches0"], pred["matching_scores0"])
    epi = generalized_epi_dist(_tensor(pts0, device)[None], _tensor(pts1, device)[None],
                               data["camera0"].to(device), data["camera1"].to(device),
                               data["T_0to1"].to(device))[0].cpu().numpy()
    epi_m = epi[valid]
    results = {"num_matches": int(valid.sum())}
    for th in (1e-4, 5e-4, 1e-3):
        results[f"epi_prec@{th:.0e}"] = float((epi_m < th).mean()) if valid.any() else np.nan
    return results


def eval_relative_pose_robust(data: dict, pred: dict, conf: dict, device="cuda") -> dict:
    """The larger of the rotation and translation errors (degrees) of the
    robust relative pose named by ``conf['estimator']`` (RANSAC), and its
    inliers."""
    device = resolve_device(device)
    pts0, pts1, _, valid = get_matches_scores(pred["keypoints0"], pred["keypoints1"],
                                              pred["matches0"], pred["matching_scores0"])
    estimator = load_estimator("relative_pose", conf.get("estimator", "ransac"))(conf)
    est_data = {"m_kpts0": _tensor(pts0, device), "m_kpts1": _tensor(pts1, device),
                "camera0": data["camera0"], "camera1": data["camera1"],
                "valid": torch.as_tensor(valid, device=device)}
    est = estimator(est_data)
    if not est["success"]:
        return {"rel_pose_error": np.nan, "ransac_inl": 0, "ransac_inl%": 0.0}
    M = est["M_0to1"]
    r_err, t_err = relative_pose_error(data["T_0to1"].to(device), M.R, M.t)
    n_inliers = int(est["inliers"].sum())
    return {"rel_pose_error": float(torch.maximum(r_err, t_err)), "ransac_inl": n_inliers,
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
