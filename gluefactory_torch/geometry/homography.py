"""Batched homography solving, warping and errors
(gluefactory_tpu/geometry/homography.py). The DLT solve is the weighted,
Hartley-normalized 8-point system reduced to a 9x9 symmetric eigenproblem,
so one batched ``eigh`` solves every hypothesis of a RANSAC at once.
``sample_homography_corners`` draws the benchmark renderer's homographies on
the host, in numpy."""

from __future__ import annotations

import math

import numpy as np
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


def warp_lines(lines: torch.Tensor, H: torch.Tensor, image_size: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Warp segments (..., L, 2, 2) by H (..., 3, 3) and clip them to the
    image [0, w - 1] x [0, h - 1] of ``image_size`` (..., 2) with a
    Liang-Barsky clip of the parametric segment. Returns (clipped segments,
    zero where invalid; valid (..., L): some part lies inside)."""
    shp = lines.shape
    pts = warp_points(lines.reshape(*shp[:-3], -1, 2), H).reshape(shp)
    p0, p1 = pts[..., 0, :], pts[..., 1, :]
    d = p1 - p0
    w = image_size[..., None, 0] - 1.0
    h = image_size[..., None, 1] - 1.0
    t0, t1 = torch.zeros_like(p0[..., 0]), torch.ones_like(p0[..., 0])
    ok = torch.ones_like(t0, dtype=torch.bool)
    for p, q in ((-d[..., 0], p0[..., 0]), (d[..., 0], w - p0[..., 0]),
                 (-d[..., 1], p0[..., 1]), (d[..., 1], h - p0[..., 1])):
        # the part of the segment where p * t <= q
        flat = p.abs() < 1e-9
        r = q / torch.where(flat, torch.where(p >= 0, 1e-9, -1e-9), p)
        t0 = torch.where(p < 0, torch.maximum(t0, r), t0)
        t1 = torch.where(p > 0, torch.minimum(t1, r), t1)
        ok = ok & torch.where(flat, q >= 0, True)
    valid = ok & (t0 < t1)
    clipped = torch.stack([p0 + t0[..., None] * d, p0 + t1[..., None] * d], dim=-2)
    return torch.where(valid[..., None, None], clipped, torch.zeros_like(clipped)), valid


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


# --- random homographies for the on-device data engine -------------------------

def _convex(quad: torch.Tensor) -> torch.Tensor:
    """True where the (B, 4, 2) quad is strictly convex."""
    d = torch.roll(quad, -1, dims=-2) - quad
    d2 = torch.roll(d, -1, dims=-2)
    cross = d[..., 0] * d2[..., 1] - d[..., 1] * d2[..., 0]
    return (cross > 1e-4).all(dim=-1) | (cross < -1e-4).all(dim=-1)


def homography_draws(generator: torch.Generator, batch: int) -> dict:
    """The uniforms in [0, 1) that ``homography_from_draws`` turns into
    ``batch`` homographies, drawn on the generator's device."""
    def rand(*shape):
        return torch.rand(*shape, generator=generator, device=generator.device)

    return {"pert": rand(batch, 4, 2), "shrink": rand(batch, 4, 1),
            "angle": rand(batch), "trans": rand(batch, 2)}


def homography_from_draws(draws: dict, shape: tuple[int, int], patch_shape: tuple[int, int],
                          difficulty: float = 0.7, translation: float = 0.3,
                          max_angle: float = 45.0) -> tuple[torch.Tensor, torch.Tensor]:
    """Random homographies from uniform draws (gluefactory_tpu/geometry/
    homography.py:sample_homography_batch): each maps a quad of the source
    image (w, h = ``shape``) onto a (pw, ph = ``patch_shape``) canvas. The
    corners are perturbed most away from the center, shrunk, rotated by up to
    ``max_angle`` degrees and translated within the remaining margin; a
    non-convex draw falls back to half the perturbation, then to the square.
    Returns (H (B, 3, 3) source -> canvas, quad (B, 4, 2) in source pixels)."""
    w, h = shape
    pw, ph = patch_shape
    device = draws["pert"].device
    base = torch.tensor([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0]], device=device)
    amp = 0.5 * difficulty
    pert = (draws["pert"] * (2 * amp) - amp).clamp_min(-amp)
    pert = pert * (base - 0.5).abs() * 2.0
    shrink = draws["shrink"] * amp
    quad = (0.5 + (base + pert - 0.5) * (1.0 - shrink)).clamp(0.0, 1.0)
    half = 0.5 * (quad + base)
    quad = torch.where(_convex(quad)[:, None, None], quad, half)
    quad = torch.where(_convex(quad)[:, None, None], quad, base)
    max_rad = torch.deg2rad(torch.tensor(float(max_angle), device=device))
    ang = torch.maximum(-max_rad, draws["angle"] * (2 * max_rad) - max_rad)
    ca, sa = torch.cos(ang), torch.sin(ang)
    rot = torch.stack([torch.stack([ca, -sa], -1), torch.stack([sa, ca], -1)], -2)
    center = quad.mean(dim=-2, keepdim=True)
    quad_r = torch.einsum("bij,bnj->bni", rot, quad - center) + center
    ext = (quad_r - center).abs().amax(dim=(-2, -1), keepdim=True)
    room = torch.minimum(center, 1.0 - center)
    scale = torch.clamp_max(room.amin(dim=-1, keepdim=True) / ext.clamp_min(1e-6), 1.0)
    quad_r = center + (quad_r - center) * scale
    t_lo = -quad_r.amin(dim=-2)
    t_hi = torch.maximum(1.0 - quad_r.amax(dim=-2), t_lo)
    t = (t_lo + draws["trans"] * (t_hi - t_lo)) * translation
    coords = (quad_r + t[:, None, :]) * torch.tensor([float(w), float(h)], device=device)
    target = (base * torch.tensor([float(pw), float(ph)], device=device)).expand_as(coords)
    return compute_homography(coords, target), coords


def sample_homography_batch(generator: torch.Generator, batch: int, shape, patch_shape,
                            **kwargs) -> tuple[torch.Tensor, torch.Tensor]:
    """``batch`` random homographies drawn from ``generator`` (see
    ``homography_from_draws`` for the arguments)."""
    return homography_from_draws(homography_draws(generator, batch), shape, patch_shape,
                                 **kwargs)


# --- host-side random homographies (the benchmark renderer) ---------------------

def _cross2d(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]


def _convex_np(quad: np.ndarray) -> bool:
    d = np.roll(quad, -1, axis=0) - quad
    cross = _cross2d(d, np.roll(d, -1, axis=0))
    return bool(np.all(cross > 0) or np.all(cross < 0))


def _min_convexity(quad: np.ndarray) -> float:
    d = np.roll(quad, -1, axis=0) - quad
    cross = np.abs(_cross2d(d, np.roll(d, -1, axis=0)))
    norms = np.linalg.norm(d, axis=-1)
    return float(np.min(cross / (norms * np.roll(norms, -1) + 1e-8)))


def compute_homography_np(pts0: np.ndarray, pts1: np.ndarray) -> np.ndarray:
    """Exact DLT from >= 4 correspondences, in float64 on the host (float32 out)."""
    pts0 = np.asarray(pts0, np.float64)
    pts1 = np.asarray(pts1, np.float64)
    n = pts0.shape[0]
    x0, y0 = pts0[:, 0], pts0[:, 1]
    x1, y1 = pts1[:, 0], pts1[:, 1]
    z, o = np.zeros(n), np.ones(n)
    r1 = np.stack([-x0, -y0, -o, z, z, z, x1 * x0, x1 * y0, x1], axis=-1)
    r2 = np.stack([z, z, z, -x0, -y0, -o, y1 * x0, y1 * y0, y1], axis=-1)
    _, _, vt = np.linalg.svd(np.concatenate([r1, r2], axis=0))
    H = vt[-1].reshape(3, 3)
    return (H / (H[2, 2] + 1e-12)).astype(np.float32)


def sample_homography_corners(shape: tuple, patch_shape: tuple, difficulty: float = 0.8,
                              translation: float = 0.3, max_angle: float = 60.0,
                              n_angles: int = 10, min_convexity: float = 0.05,
                              rng: np.random.Generator | None = None
                              ) -> tuple[np.ndarray, np.ndarray]:
    """A random homography from image pixels (w, h = ``shape``) to a patch
    (``patch_shape``) (gluefactory_tpu/geometry/homography.py:34): the unit
    square's corners perturbed (up to 20 tries for a convex quad), rotated by
    one of ``n_angles`` angles that keeps it in bounds, and translated. It
    makes the numpy draws of the JAX function in the same order, so a
    generator in the same state gives the same homography.
    Returns (H (3, 3) float32, the source quad (4, 2) float32)."""
    rng = rng or np.random.default_rng()
    w, h = shape
    pw, ph = patch_shape
    base = np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0]])
    center = np.array([0.5, 0.5])
    amp = 0.5 * difficulty
    for _ in range(20):
        quad = base + rng.uniform(-amp, amp, size=(4, 2)) * np.abs(base - center) * 2.0
        quad = center + (quad - center) * (1.0 - amp * rng.uniform(0.0, 1.0, size=(4, 1)))
        quad = np.clip(quad, 0.0, 1.0)
        if _convex_np(quad) and _min_convexity(quad) > min_convexity:
            break
    else:
        quad = base.copy()
    angles = np.linspace(-np.deg2rad(max_angle), np.deg2rad(max_angle), n_angles)
    rng.shuffle(angles)
    angles = np.concatenate([[0.0], angles])
    for ang in angles[::-1]:  # the shuffled angles first, 0 last
        ca, sa = np.cos(ang), np.sin(ang)
        rot = (quad - center) @ np.array([[ca, -sa], [sa, ca]]).T + center
        if rot.min() >= 0.0 and rot.max() <= 1.0:
            quad = rot
            break
    mn, mx = quad.min(axis=0), quad.max(axis=0)
    lo, hi = -np.minimum(mn, 1.0), np.maximum(1.0 - mx, 0.0)
    hi = np.maximum(hi, lo)
    quad = quad + rng.uniform(lo, hi) * translation
    coords = quad * np.array([w, h])
    H = compute_homography_np(coords, base * np.array([pw, ph]))
    return H.astype(np.float32), coords.astype(np.float32)
