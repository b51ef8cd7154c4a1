"""Batched LO-RANSAC for homographies on the device
(gluefactory_tpu/robust_estimators/homography/ransac.py): every minimal
hypothesis is solved in one batched eigendecomposition and MSAC-scored in
one pass, then the best one is polished by iteratively reweighted DLT with a
shrinking inlier threshold. No step waits on the host.

A benchmark's sweep of thresholds runs as one batch: a run per threshold
from the same seed draws the same minimal sets, so the hypotheses are
solved once and each threshold's choice and LO steps are taken together
(``ransac_homography`` over T thresholds, ``HomographyEstimator.sweep``)."""

from __future__ import annotations

import numpy as np
import torch

from ...geometry.homography import compute_homography, sym_homography_error
from ..base_estimator import BaseEstimator


def sample_minimal_sets(valid: torch.Tensor, num_hypotheses: int,
                        generator: torch.Generator | None = None, size: int = 4) -> torch.Tensor:
    """(S, size) indices drawn uniformly, with replacement, among the valid
    correspondences (among all of them when none is valid)."""
    weights = valid.float()
    weights = torch.where(weights.sum() > 0, weights, torch.ones_like(weights))
    return torch.multinomial(weights.expand(num_hypotheses, -1).contiguous(), size,
                             replacement=True, generator=generator)


def _errors(kpts0, kpts1, H):
    e = sym_homography_error(kpts0[None], kpts1[None], H)
    return torch.nan_to_num(e, nan=float("inf"), posinf=float("inf"))


def lo_schedule(ths, lo_iters: int, start: float = 4.0) -> np.ndarray:
    """(max(lo_iters, 1), T) float32 inlier thresholds of the LO steps: for
    each threshold th of ``ths``, steps shrinking geometrically from
    ``start * th`` to th."""
    return np.stack([np.geomspace(start * th, th, max(lo_iters, 1)).astype(np.float32)
                     for th in ths], axis=-1)


def ransac_homography(
    kpts0: torch.Tensor,
    kpts1: torch.Tensor,
    valid: torch.Tensor,
    ths,
    num_hypotheses: int = 1024,
    lo_iters: int = 4,
    generator: torch.Generator | None = None,
    sample_idx: torch.Tensor | None = None,
):
    """kpts0/1 (N, 2), valid (N,), ``ths`` a sequence of T thresholds (px)
    -> (H (T, 3, 3), inliers (T, N), inlier share (T,)). ``sample_idx``
    (S, 4) replaces the random minimal sets when given."""
    th = torch.tensor([float(t) for t in ths], dtype=torch.float32, device=kpts0.device)
    if sample_idx is None:
        sample_idx = sample_minimal_sets(valid, num_hypotheses, generator)
    H = compute_homography(kpts0[sample_idx], kpts1[sample_idx])  # (S, 3, 3)
    err = _errors(kpts0, kpts1, H).masked_fill(~valid[None], float("inf"))  # (S, N)
    score = (1.0 - (err / th[:, None, None]) ** 2).clamp_min(0.0).sum(dim=-1)  # (T, S)
    H_cur = H[score.argmax(dim=-1)]  # (T, 3, 3)

    def msac(Hm):
        e = _errors(kpts0, kpts1, Hm)
        return torch.where(valid, (1.0 - (e / th[:, None]) ** 2).clamp_min(0.0), 0.0).sum(-1)

    pts0, pts1 = kpts0.expand(len(th), -1, -1), kpts1.expand(len(th), -1, -1)
    for th_i in torch.from_numpy(lo_schedule(ths, lo_iters)).to(kpts0.device):
        w = (valid & (_errors(kpts0, kpts1, H_cur) < th_i[:, None])).float()  # (T, N)
        H_new = compute_homography(pts0, pts1, w)
        ok = (torch.isfinite(H_new).flatten(-2).all(-1) & (w.sum(-1) > 8.0)
              & (msac(H_new) >= msac(H_cur)))
        H_cur = torch.where(ok[:, None, None], H_new, H_cur)
    inliers = valid & (_errors(kpts0, kpts1, H_cur) < th[:, None])
    return H_cur, inliers, inliers.sum(-1) / valid.sum().clamp_min(1)


class HomographyEstimator(BaseEstimator):
    """conf: ransac_th (px), num_hypotheses, lo_iters, seed. ``data`` may hold
    ``sample_idx`` (S, 4) to fix the minimal sets."""

    default_conf = {"ransac_th": 3.0, "num_hypotheses": 1024, "lo_iters": 4, "seed": 0}

    def sweep(self, data: dict, thresholds) -> list[dict]:
        kpts0 = data["m_kpts0"].float()
        kpts1 = data["m_kpts1"].float()
        valid = data.get("valid")
        if valid is None:
            valid = torch.ones(kpts0.shape[0], dtype=torch.bool, device=kpts0.device)
        generator = torch.Generator(device=kpts0.device).manual_seed(int(self.conf["seed"]))
        H, inliers, score = ransac_homography(
            kpts0, kpts1, valid.bool(), thresholds,
            num_hypotheses=int(self.conf["num_hypotheses"]),
            lo_iters=int(self.conf["lo_iters"]), generator=generator,
            sample_idx=data.get("sample_idx"))
        success = (inliers.sum(-1) >= 4) & torch.isfinite(H).flatten(-2).all(-1)
        return [{"success": ok, "M_0to1": H[i], "inliers": inliers[i], "score": s}
                for i, (ok, s) in enumerate(zip(success.tolist(), score.tolist()))]


__main_estimator__ = HomographyEstimator
