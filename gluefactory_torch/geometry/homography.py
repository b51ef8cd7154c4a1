"""Batched homography solving, warping and errors
(gluefactory_tpu/geometry/homography.py). The DLT solve is the weighted,
Hartley-normalized 8-point system reduced to a 9x9 symmetric eigenproblem,
so one batched ``eigh`` solves every hypothesis of a RANSAC at once."""

from __future__ import annotations

import math

import torch

from .utils import from_homogeneous, to_homogeneous


def _inv(m: torch.Tensor) -> torch.Tensor:
    # no error check: a singular hypothesis gives inf/nan and scores badly,
    # as in the JAX package, instead of raising or synchronising the device
    return torch.linalg.inv_ex(m).inverse


def _normalize_pts(pts: torch.Tensor, weights: torch.Tensor):
    """Weighted Hartley normalization: zero mean, mean norm sqrt(2).
    Returns (normalized points, 3x3 transform)."""
    wsum = weights.sum(dim=-1, keepdim=True) + 1e-8
    mean = (pts * weights[..., None]).sum(dim=-2, keepdim=True) / wsum[..., None]
    centered = pts - mean
    spread = (torch.linalg.vector_norm(centered, dim=-1) * weights).sum(
        dim=-1, keepdim=True) / wsum
    scale = math.sqrt(2.0) / (spread + 1e-8)  # (..., 1)
    s = scale[..., 0]
    zero, one = torch.zeros_like(s), torch.ones_like(s)
    T = torch.stack([
        torch.stack([s, zero, -mean[..., 0, 0] * s], dim=-1),
        torch.stack([zero, s, -mean[..., 0, 1] * s], dim=-1),
        torch.stack([zero, zero, one], dim=-1),
    ], dim=-2)
    return centered * scale[..., None], T


def compute_homography(pts0: torch.Tensor, pts1: torch.Tensor,
                       weights: torch.Tensor | None = None) -> torch.Tensor:
    """Weighted normalized DLT: (..., N, 2) x2 -> (..., 3, 3), H pts0 ~ pts1."""
    pts0, pts1 = pts0.float(), pts1.float()
    if weights is None:
        weights = torch.ones(pts0.shape[:-1], dtype=pts0.dtype, device=pts0.device)
    weights = weights.to(pts0.dtype)
    p0n, T0 = _normalize_pts(pts0, weights)
    p1n, T1 = _normalize_pts(pts1, weights)
    x0, y0 = p0n[..., 0], p0n[..., 1]
    x1, y1 = p1n[..., 0], p1n[..., 1]
    z, o = torch.zeros_like(x0), torch.ones_like(x0)
    r1 = torch.stack([-x0, -y0, -o, z, z, z, x1 * x0, x1 * y0, x1], dim=-1)
    r2 = torch.stack([z, z, z, -x0, -y0, -o, y1 * x0, y1 * y0, y1], dim=-1)
    A = torch.cat([r1, r2], dim=-2)  # (..., 2N, 9)
    w2 = torch.cat([weights, weights], dim=-1)
    AtA = torch.einsum("...ni,...n,...nj->...ij", A, w2, A)
    h = torch.linalg.eigh(AtA).eigenvectors[..., :, 0]
    H = _inv(T1) @ h.reshape(*h.shape[:-1], 3, 3) @ T0
    return H / (H[..., 2:3, 2:3] + 1e-12)


def warp_points(points: torch.Tensor, H: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """Warp (..., N, 2) points by (..., 3, 3) homographies (batch dims broadcast)."""
    M = _inv(H) if inverse else H
    return from_homogeneous(to_homogeneous(points) @ M.transpose(-1, -2))


def sym_homography_error(kpts0: torch.Tensor, kpts1: torch.Tensor,
                         H: torch.Tensor) -> torch.Tensor:
    """Mean of the forward and backward reprojection distances (..., N)."""
    err0 = torch.linalg.vector_norm(warp_points(kpts0, H) - kpts1, dim=-1)
    err1 = torch.linalg.vector_norm(warp_points(kpts1, H, inverse=True) - kpts0, dim=-1)
    return 0.5 * (err0 + err1)


def homography_corner_error(H_est: torch.Tensor, H_gt: torch.Tensor,
                            image_size: torch.Tensor) -> torch.Tensor:
    """Mean displacement of the four warped image corners (...,);
    image_size (..., 2) as (w, h)."""
    w, h = image_size[..., 0], image_size[..., 1]
    zeros = torch.zeros_like(w)
    corners = torch.stack([
        torch.stack([zeros, zeros], -1), torch.stack([w, zeros], -1),
        torch.stack([w, h], -1), torch.stack([zeros, h], -1),
    ], dim=-2)
    diff = warp_points(corners, H_est) - warp_points(corners, H_gt)
    return torch.linalg.vector_norm(diff, dim=-1).mean(dim=-1)
