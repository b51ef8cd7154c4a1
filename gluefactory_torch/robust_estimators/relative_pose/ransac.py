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
counts, as the JAX estimator does. A sweep of thresholds shares steps 1-3
and takes step 4 for all of them in one batch (``ransac_essential_sweep``),
since a run per threshold from one seed draws the same minimal sets."""

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
from ..homography.ransac import lo_schedule, sample_minimal_sets


def _errors(rays0, rays1, E):
    e = sampson_distance(rays0[None], rays1[None], E)
    return torch.nan_to_num(e, nan=float("inf"), posinf=float("inf"))


def ransac_essential_sweep(
    rays0: torch.Tensor,
    rays1: torch.Tensor,
    valid: torch.Tensor,
    ths,
    num_hypotheses: int = 1024,
    lo_iters: int = 4,
    minimal_solver: str = "5pt",
    generator: torch.Generator | None = None,
    sample_idx: torch.Tensor | None = None,
) -> list[tuple]:
    """rays0/1 (N, 3) on the unit plane, valid (N,), ``ths`` a sequence of
    thresholds in normalized units -> for each, (E, R, t, inliers, inlier
    share). The thresholds share the minimal sets and their candidates (a
    run per threshold from one seed draws the same); the choice and the LO
    steps of all of them are taken in one batch, the pose recovery and its
    refinement for each in turn. ``sample_idx`` (S, 5|8) replaces the random
    minimal sets when given."""
    th2s = [th * th for th in ths]
    th2 = torch.tensor(th2s, dtype=rays0.dtype, device=rays0.device)
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
    score = (1.0 - err / th2[:, None, None]).clamp_min(0.0).sum(-1)  # (T, S')
    E_cur = E[torch.where(valid_h, score, -1.0).argmax(-1)]  # (T, 3, 3)

    def msac(Em):
        return torch.where(valid, (1.0 - _errors(rays0, rays1, Em) / th2[:, None])
                           .clamp_min(0.0), 0.0).sum(-1)

    r0, r1 = rays0.expand(len(th2s), -1, -1), rays1.expand(len(th2s), -1, -1)
    # a wide threshold first, so that near-threshold inliers contribute
    for th2_i in torch.from_numpy(lo_schedule(th2s, lo_iters, start=16.0)).to(rays0.device):
        w = (valid & (_errors(rays0, rays1, E_cur) < th2_i[:, None])).to(rays0.dtype)
        E_new = eight_point_essential(r0, r1, w)
        better = ((msac(E_new) >= msac(E_cur)) & (w.sum(-1) > 16.0)
                  & torch.isfinite(E_new).flatten(-2).all(-1))
        E_cur = torch.where(better[:, None, None], E_new, E_cur)
    e_fin = _errors(rays0, rays1, E_cur)
    out = []
    for i, th2_f in enumerate(th2s):
        inliers = valid & (e_fin[i] < th2_f)
        R, t = recover_pose_from_essential(E_cur[i], rays0, rays1, inliers)
        w = torch.where(inliers, 1.0 / (1.0 + e_fin[i] / th2_f), 0.0)
        R, t = refine_pose_sampson(R, t, rays0, rays1, w, iters=8)
        E_ref = skew_symmetric(t) @ R
        inliers = valid & (_errors(rays0, rays1, E_ref[None])[0] < th2_f)
        out.append((E_ref, R, t, inliers, inliers.sum() / valid.sum().clamp_min(1)))
    return out


def ransac_essential(rays0: torch.Tensor, rays1: torch.Tensor, valid: torch.Tensor,
                     th: float, **kwargs):
    """``ransac_essential_sweep`` at the one threshold ``th``: (E, R, t,
    inliers, inlier share)."""
    return ransac_essential_sweep(rays0, rays1, valid, [th], **kwargs)[0]


class RelativePoseEstimator(BaseEstimator):
    """conf: ransac_th in pixels (divided by the mean focal length of both
    cameras), num_hypotheses, lo_iters, minimal_solver ('5pt' | '8pt'),
    seed. ``data``: m_kpts0/1 (N, 2) pixels, camera0/1 (``Camera``),
    optionally valid (N,) and sample_idx (S, 5|8) to fix the minimal sets."""

    default_conf = {"ransac_th": 2.0, "num_hypotheses": 512, "lo_iters": 6,
                    "minimal_solver": "5pt", "seed": 0}

    def sweep(self, data: dict, thresholds) -> list[dict]:
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
        fits = ransac_essential_sweep(
            rays0, rays1, valid, [float(th) / f_mean for th in thresholds],
            num_hypotheses=int(self.conf["num_hypotheses"]),
            lo_iters=int(self.conf["lo_iters"]),
            minimal_solver=str(self.conf["minimal_solver"]), generator=generator,
            sample_idx=data.get("sample_idx"))
        counts = torch.stack([fit[3].sum() for fit in fits] + [valid.sum()]).tolist()
        n_valid = counts.pop()
        return [{"success": n_inliers >= 8, "M_0to1": Pose.from_Rt(R, t), "E": E,
                 "inliers": inliers, "score": n_inliers / max(n_valid, 1)}
                for (E, R, t, inliers, _), n_inliers in zip(fits, counts)]


__main_estimator__ = RelativePoseEstimator
