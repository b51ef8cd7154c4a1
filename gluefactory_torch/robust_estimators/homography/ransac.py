"""Batched LO-RANSAC for homographies on the device
(gluefactory_tpu/robust_estimators/homography/ransac.py): every minimal
hypothesis is solved in one batched eigendecomposition and MSAC-scored in
one pass, then the best one is polished by iteratively reweighted DLT with a
shrinking inlier threshold. No step waits on the host."""

from __future__ import annotations

import numpy as np
import torch

from ...geometry.homography import compute_homography, sym_homography_error
from ..base_estimator import BaseEstimator


def sample_minimal_sets(valid: torch.Tensor, num_hypotheses: int,
                        generator: torch.Generator | None = None) -> torch.Tensor:
    """(S, 4) indices drawn uniformly, with replacement, among the valid
    correspondences (among all of them when none is valid)."""
    weights = valid.float()
    weights = torch.where(weights.sum() > 0, weights, torch.ones_like(weights))
    return torch.multinomial(weights.expand(num_hypotheses, -1).contiguous(), 4,
                             replacement=True, generator=generator)


def _errors(kpts0, kpts1, H):
    e = sym_homography_error(kpts0[None], kpts1[None], H)
    return torch.nan_to_num(e, nan=float("inf"), posinf=float("inf"))


def ransac_homography(
    kpts0: torch.Tensor,
    kpts1: torch.Tensor,
    valid: torch.Tensor,
    th: float,
    num_hypotheses: int = 1024,
    lo_iters: int = 4,
    generator: torch.Generator | None = None,
    sample_idx: torch.Tensor | None = None,
):
    """kpts0/1 (N, 2), valid (N,) -> (H (3, 3), inliers (N,), score ()).
    ``sample_idx`` (S, 4) replaces the random minimal sets when given."""
    if sample_idx is None:
        sample_idx = sample_minimal_sets(valid, num_hypotheses, generator)
    H = compute_homography(kpts0[sample_idx], kpts1[sample_idx])  # (S, 3, 3)
    err = _errors(kpts0, kpts1, H).masked_fill(~valid[None], float("inf"))
    score = (1.0 - (err / th) ** 2).clamp_min(0.0).sum(dim=-1)
    H_cur = H[score.argmax()]

    def msac(Hm):
        e = _errors(kpts0, kpts1, Hm[None])[0]
        return torch.where(valid, (1.0 - (e / th) ** 2).clamp_min(0.0), 0.0).sum()

    for th_i in np.geomspace(4.0 * th, th, max(lo_iters, 1)).astype(np.float32):
        e = _errors(kpts0, kpts1, H_cur[None])[0]
        w = (valid & (e < float(th_i))).float()
        H_new = compute_homography(kpts0[None], kpts1[None], w[None])[0]
        ok = torch.isfinite(H_new).all() & (w.sum() > 8.0) & (msac(H_new) >= msac(H_cur))
        H_cur = torch.where(ok, H_new, H_cur)
    inliers = valid & (_errors(kpts0, kpts1, H_cur[None])[0] < th)
    return H_cur, inliers, inliers.sum() / valid.sum().clamp_min(1)


class HomographyEstimator(BaseEstimator):
    """conf: ransac_th (px), num_hypotheses, lo_iters, seed. ``data`` may hold
    ``sample_idx`` (S, 4) to fix the minimal sets."""

    default_conf = {"ransac_th": 3.0, "num_hypotheses": 1024, "lo_iters": 4, "seed": 0}

    def _forward(self, data: dict) -> dict:
        kpts0 = data["m_kpts0"].float()
        kpts1 = data["m_kpts1"].float()
        valid = data.get("valid")
        if valid is None:
            valid = torch.ones(kpts0.shape[0], dtype=torch.bool, device=kpts0.device)
        generator = torch.Generator(device=kpts0.device).manual_seed(int(self.conf["seed"]))
        H, inliers, score = ransac_homography(
            kpts0, kpts1, valid.bool(), th=float(self.conf["ransac_th"]),
            num_hypotheses=int(self.conf["num_hypotheses"]),
            lo_iters=int(self.conf["lo_iters"]), generator=generator,
            sample_idx=data.get("sample_idx"))
        return {
            "success": bool(inliers.sum() >= 4) and bool(torch.isfinite(H).all()),
            "M_0to1": H,
            "inliers": inliers,
            "score": float(score),
        }


__main_estimator__ = HomographyEstimator
