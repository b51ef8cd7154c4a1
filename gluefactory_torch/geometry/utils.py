"""Low-level batched geometry (gluefactory_tpu/geometry/utils.py):
homogeneous coordinates, the cross-product matrix, the SO(3) exponential and
logarithm, and Brown distortion with its Jacobian. Every function broadcasts
over leading batch dimensions."""

from __future__ import annotations

import torch


def to_homogeneous(points: torch.Tensor) -> torch.Tensor:
    """(..., N, D) -> (..., N, D+1) with a trailing 1."""
    return torch.cat([points, torch.ones_like(points[..., :1])], dim=-1)


def from_homogeneous(points: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """(..., N, D+1) -> (..., N, D), dividing by the last coordinate."""
    return points[..., :-1] / (points[..., -1:] + eps)


def batched_eye_like(x: torch.Tensor, n: int) -> torch.Tensor:
    """Identity matrices (*x.shape[:-1], n, n) of x's dtype and device."""
    eye = torch.eye(n, dtype=x.dtype, device=x.device)
    return eye.expand(*x.shape[:-1], n, n)


def skew_symmetric(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) cross-product matrix [v]x."""
    z = torch.zeros_like(v[..., 0])
    return torch.stack([z, -v[..., 2], v[..., 1],
                        v[..., 2], z, -v[..., 0],
                        -v[..., 1], v[..., 0], z], dim=-1).reshape(*v.shape[:-1], 3, 3)


def so3exp_map(w: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Axis-angle (..., 3) -> rotation matrices (..., 3, 3) by Rodrigues'
    formula, with its Taylor expansion near zero so that derivatives stay
    finite at the identity."""
    theta2 = (w * w).sum(dim=-1, keepdim=True)[..., None]  # (..., 1, 1)
    small = theta2 < eps**2
    theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(theta2_safe)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2_safe)
    W = skew_symmetric(w)
    return batched_eye_like(w, 3) + a * W + b * (W @ W)


def so3log_map(R: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Rotation matrices (..., 3, 3) -> axis-angle (..., 3)."""
    trace = R.diagonal(dim1=-2, dim2=-1).sum(-1)
    cos = ((trace - 1.0) / 2.0).clamp(-1.0 + eps, 1.0 - eps)
    theta = torch.arccos(cos)[..., None]
    w_hat = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                         R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    sin = torch.sin(theta)
    sin_safe = torch.where(sin.abs() < eps, torch.ones_like(sin), sin)
    scale = torch.where(theta < eps, torch.full_like(theta, 0.5), theta / (2.0 * sin_safe))
    return w_hat * scale


def distort_points(pts: torch.Tensor, dist: torch.Tensor) -> torch.Tensor:
    """Brown distortion of normalized points (..., N, 2); ``dist`` (..., K)
    with K in {1, 2, 4+}: k1, k2[, p1, p2, ...]."""
    dist = dist[..., None, :]  # broadcast over N
    ndist = dist.shape[-1]
    x, y = pts[..., 0], pts[..., 1]
    r2 = x**2 + y**2
    radial = dist[..., 0] * r2
    if ndist >= 2:
        radial = radial + dist[..., 1] * r2**2
    out = pts * (1.0 + radial)[..., None]
    if ndist > 2:
        p12 = dist[..., 2:4]
        p21 = p12.flip(-1)
        uv = torch.stack([x, y], dim=-1)
        out = out + 2.0 * p12 * (x * y)[..., None] + p21 * (r2[..., None] + 2.0 * uv**2)
    return out


def J_distort_points(pts: torch.Tensor, dist: torch.Tensor) -> torch.Tensor:
    """Jacobian (..., N, 2, 2) of ``distort_points`` with respect to the points."""
    dist = dist[..., None, :]
    ndist = dist.shape[-1]
    x, y = pts[..., 0], pts[..., 1]
    r2 = x**2 + y**2
    radial = dist[..., 0] * r2
    dradial = 2.0 * dist[..., 0]
    if ndist >= 2:
        radial = radial + dist[..., 1] * r2**2
        dradial = dradial + 4.0 * dist[..., 1] * r2
    J_diag = 1.0 + radial
    J_off = x * y * dradial
    J = torch.stack([J_diag + x**2 * dradial, J_off, J_off, J_diag + y**2 * dradial],
                    dim=-1).reshape(*pts.shape[:-1], 2, 2)
    if ndist > 2:
        p1, p2 = dist[..., 2], dist[..., 3]
        J = J + torch.stack([2.0 * p1 * y + 6.0 * p2 * x, 2.0 * p1 * x + 2.0 * p2 * y,
                             2.0 * p1 * x + 2.0 * p2 * y, 6.0 * p1 * y + 2.0 * p2 * x],
                            dim=-1).reshape(*pts.shape[:-1], 2, 2)
    return J
