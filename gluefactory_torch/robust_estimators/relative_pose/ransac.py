"""Batched LO-RANSAC for relative pose on the device
(gluefactory_tpu/robust_estimators/relative_pose/ransac.py):

  1. pixels to rays through the cameras;
  2. minimal sets drawn with replacement among the valid matches, each
     solved by the 5-point solver (up to 10 candidates) or the 8-point one,
     all in one batch;
  3. every candidate MSAC-scored on the Sampson errors in one pass;
  4. the best one polished by the weighted 8-point on its inliers, with a
     threshold shrinking geometrically to the final one, a step taken only
     if it scores no worse;
  5. (R, t) by the cheirality vote, refined by Gauss-Newton on the Sampson
     error, and the final inliers.

No step of ``ransac_essential`` waits on the host; the estimator reads back
the mean focal length (the threshold is given in pixels) and the inlier
counts, as the JAX estimator does."""

from __future__ import annotations

import numpy as np
import torch

from ...geometry.essential import (
    eight_point_essential,
    five_point_essential,
    recover_pose_from_essential,
    refine_pose_sampson,
    sampson_distance,
)
from ...geometry.utils import skew_symmetric
from ...geometry.wrappers import Camera, Pose
from ..base_estimator import BaseEstimator
from ..homography.ransac import sample_minimal_sets


def _errors(rays0, rays1, E):
    e = sampson_distance(rays0[None], rays1[None], E)
    return torch.nan_to_num(e, nan=float("inf"), posinf=float("inf"))


def ransac_essential(
    rays0: torch.Tensor,
    rays1: torch.Tensor,
    valid: torch.Tensor,
    th: float,
    num_hypotheses: int = 1024,
    lo_iters: int = 4,
    minimal_solver: str = "5pt",
    generator: torch.Generator | None = None,
    sample_idx: torch.Tensor | None = None,
):
    """rays0/1 (N, 3) on the unit plane, valid (N,), ``th`` in normalized
    units -> (E, R, t, inliers, inlier share). ``sample_idx`` (S, 5|8)
    replaces the random minimal sets when given."""
    th2 = th * th
    if sample_idx is None:
        sample_idx = sample_minimal_sets(valid, num_hypotheses, generator,
                                         5 if minimal_solver == "5pt" else 8)
    x0, x1 = rays0[sample_idx], rays1[sample_idx]
    if minimal_solver == "5pt":
        E, valid_h = five_point_essential(x0[..., :2], x1[..., :2])
        E, valid_h = E.reshape(-1, 3, 3), valid_h.reshape(-1)  # (S * 10, 3, 3)
    else:
        E = eight_point_essential(x0, x1)
        valid_h = torch.ones(E.shape[0], dtype=torch.bool, device=E.device)
    err = _errors(rays0, rays1, E).masked_fill(~valid[None], float("inf"))
    score = (1.0 - err / th2).clamp_min(0.0).sum(-1)
    E_cur = E[torch.where(valid_h, score, -1.0).argmax()]

    def msac(Em):
        return torch.where(valid, (1.0 - _errors(rays0, rays1, Em[None])[0] / th2)
                           .clamp_min(0.0), 0.0).sum()

    # a wide threshold first, so that near-threshold inliers contribute
    for th2_i in np.geomspace(16.0 * th2, th2, max(lo_iters, 1)).astype(np.float32):
        w = (valid & (_errors(rays0, rays1, E_cur[None])[0] < float(th2_i))).to(rays0.dtype)
        E_new = eight_point_essential(rays0[None], rays1[None], w[None])[0]
        better = (msac(E_new) >= msac(E_cur)) & (w.sum() > 16.0) & torch.isfinite(E_new).all()
        E_cur = torch.where(better, E_new, E_cur)
    e_fin = _errors(rays0, rays1, E_cur[None])[0]
    inliers = valid & (e_fin < th2)
    R, t = recover_pose_from_essential(E_cur, rays0, rays1, inliers)
    w = torch.where(inliers, 1.0 / (1.0 + e_fin / th2), 0.0)
    R, t = refine_pose_sampson(R, t, rays0, rays1, w, iters=8)
    E_ref = skew_symmetric(t) @ R
    inliers = valid & (_errors(rays0, rays1, E_ref[None])[0] < th2)
    return E_ref, R, t, inliers, inliers.sum() / valid.sum().clamp_min(1)


class RelativePoseEstimator(BaseEstimator):
    """conf: ransac_th in pixels (divided by the mean focal length of both
    cameras), num_hypotheses, lo_iters, minimal_solver ('5pt' | '8pt'),
    seed. ``data``: m_kpts0/1 (N, 2) pixels, camera0/1 (``Camera``),
    optionally valid (N,) and sample_idx (S, 5|8) to fix the minimal sets."""

    default_conf = {"ransac_th": 2.0, "num_hypotheses": 512, "lo_iters": 6,
                    "minimal_solver": "5pt", "seed": 0}

    def _forward(self, data: dict) -> dict:
        kpts0 = data["m_kpts0"].float()
        kpts1 = data["m_kpts1"].float()
        device = kpts0.device
        camera0: Camera = data["camera0"]
        camera1: Camera = data["camera1"]
        valid = data.get("valid")
        valid = (torch.ones(kpts0.shape[0], dtype=torch.bool, device=device) if valid is None
                 else valid.bool())
        # read back where the cameras live (the host, in the benchmarks)
        f_mean = float(torch.cat([camera0.f.reshape(-1), camera1.f.reshape(-1)]).mean())
        rays0 = camera0.to(device).image2cam(kpts0[None])[0]
        rays1 = camera1.to(device).image2cam(kpts1[None])[0]
        generator = torch.Generator(device=device).manual_seed(int(self.conf["seed"]))
        E, R, t, inliers, _ = ransac_essential(
            rays0, rays1, valid, th=float(self.conf["ransac_th"]) / f_mean,
            num_hypotheses=int(self.conf["num_hypotheses"]),
            lo_iters=int(self.conf["lo_iters"]),
            minimal_solver=str(self.conf["minimal_solver"]), generator=generator,
            sample_idx=data.get("sample_idx"))
        n_inliers, n_valid = torch.stack([inliers.sum(), valid.sum()]).tolist()
        return {"success": n_inliers >= 8, "M_0to1": Pose.from_Rt(R, t), "E": E,
                "inliers": inliers, "score": n_inliers / max(n_valid, 1)}


__main_estimator__ = RelativePoseEstimator
