"""Triangulation (gluefactory_tpu/sfm/triangulation.py): the two-view depths
of ``geometry.essential.triangulate_depths``, and the N-view linear (DLT)
solution of every track at once as one batched 4x4 symmetric
eigendecomposition, masked for missing observations."""

from __future__ import annotations

import torch

from ..geometry.essential import triangulate_depths
from ..geometry.wrappers import Camera, Pose


def triangulate_two_view(rays0: torch.Tensor, rays1: torch.Tensor,
                         T_0to1: Pose) -> tuple[torch.Tensor, torch.Tensor]:
    """Depths along both rays (..., N, 3): (points in frame 0 (..., N, 3),
    whether both depths are positive (..., N))."""
    s, u = triangulate_depths(rays0, rays1, T_0to1.R, T_0to1.t)
    return rays0 * s[..., None], (s > 0) & (u > 0)


def triangulate_linear(poses: Pose, cameras: Camera, observations: torch.Tensor,
                       obs_mask: torch.Tensor) -> torch.Tensor:
    """World points (P, 3) of P tracks seen by V views: ``poses`` and
    ``cameras`` of batch (V,) (world to camera), ``observations`` (P, V, 2)
    pixels, ``obs_mask`` (P, V) which of them exist."""
    rays = cameras.image2cam(observations.transpose(0, 1)).transpose(0, 1)  # (P, V, 3)
    P_mat = torch.cat([poses.R, poses.t[..., None]], dim=-1)  # (V, 3, 4)
    x, y = rays[..., 0], rays[..., 1]
    r1 = x[..., None] * P_mat[None, :, 2, :] - P_mat[None, :, 0, :]  # (P, V, 4)
    r2 = y[..., None] * P_mat[None, :, 2, :] - P_mat[None, :, 1, :]
    A = torch.cat([r1, r2], dim=1)  # (P, 2V, 4)
    w = torch.cat([obs_mask, obs_mask], dim=1).to(A.dtype)
    AtA = torch.einsum("pni,pn,pnj->pij", A, w, A)
    X = torch.linalg.eigh(AtA)[1][..., :, 0]
    return X[..., :3] / (X[..., 3:4] + 1e-12)
