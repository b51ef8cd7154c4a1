"""Depth sampling and two-view reprojection (gluefactory_tpu/geometry/depth.py)."""

from __future__ import annotations

import torch

from .wrappers import Camera, Pose


def sample_depth(pts: torch.Tensor, depth: torch.Tensor, eps: float = 1e-5):
    """Bilinear depth at pixels ``pts`` (..., N, 2) of ``depth`` (..., H, W),
    renormalised over the corners that hold a depth (> ``eps``); where a
    corner lacks one, the value of the valid corner of largest weight.
    Returns (depth (..., N), valid (..., N)): valid where the point lies in
    the image and a corner holds a depth; 0 elsewhere."""
    h, w = depth.shape[-2], depth.shape[-1]
    x = pts[..., 0].clamp(0.0, w - 1.0)
    y = pts[..., 1].clamp(0.0, h - 1.0)
    x0 = x.floor().long().clamp(0, w - 2)
    y0 = y.floor().long().clamp(0, h - 2)
    fx, fy = x - x0, y - y0
    flat = depth.reshape(*depth.shape[:-2], -1)

    def gather(yy, xx):
        return torch.take_along_dim(flat, yy * w + xx, dim=-1)

    corners = torch.stack([gather(y0, x0), gather(y0, x0 + 1),
                           gather(y0 + 1, x0), gather(y0 + 1, x0 + 1)], dim=-1)
    weights = torch.stack([(1 - fx) * (1 - fy), fx * (1 - fy), (1 - fx) * fy, fx * fy], dim=-1)
    corner_valid = corners > eps
    wv = weights * corner_valid
    bilinear = (wv * corners).sum(-1) / (wv.sum(-1) + 1e-12)
    nn = torch.take_along_dim(corners, wv.argmax(dim=-1, keepdim=True), dim=-1)[..., 0]
    out = torch.where(corner_valid.all(dim=-1), bilinear, nn)
    in_img = ((pts[..., 0] >= 0) & (pts[..., 0] <= w - 1)
              & (pts[..., 1] >= 0) & (pts[..., 1] <= h - 1))
    valid = corner_valid.any(dim=-1) & in_img
    return torch.where(valid, out, torch.zeros_like(out)), valid


def project(kpi: torch.Tensor, di: torch.Tensor, depthj: torch.Tensor | None,
            camera_i: Camera, camera_j: Camera, T_itoj: Pose, valid_i: torch.Tensor,
            ccth: float | None = None):
    """Keypoints of view i (..., N, 2) at depths ``di`` into view j. With
    ``ccth``, a point is kept only where view j's depth at its projection
    agrees with its own depth there within ``ccth`` of the smaller one.
    Returns (the pixels in view j (..., N, 2), valid (..., N))."""
    kpi_3d_j = T_itoj.transform(camera_i.image2cam(kpi) * di[..., None])
    kpi_j, visible = camera_j.cam2image(kpi_3d_j)
    valid = valid_i & visible
    if ccth is not None and depthj is not None:
        dj, valid_j = sample_depth(kpi_j, depthj)
        z_j = kpi_3d_j[..., -1]
        consistent = (dj - z_j).abs() < ccth * torch.minimum(dj.abs(), z_j.abs())
        valid = valid & valid_j & consistent
    return kpi_j, valid


def dense_warp_consistency(depthi: torch.Tensor, depthj: torch.Tensor, T_itoj: Pose,
                           camerai: Camera, cameraj: Camera, ccth: float = 0.05):
    """``project`` of every pixel of view i that holds a depth: (warped
    pixels (..., H, W, 2), valid (..., H, W))."""
    h, w = depthi.shape[-2], depthi.shape[-1]
    ys = torch.arange(h, dtype=depthi.dtype, device=depthi.device)
    xs = torch.arange(w, dtype=depthi.dtype, device=depthi.device)
    grid = torch.stack(torch.meshgrid(xs, ys, indexing="xy"), dim=-1).reshape(-1, 2)
    grid = grid.expand(*depthi.shape[:-2], h * w, 2)
    di = depthi.reshape(*depthi.shape[:-2], -1)
    warped, valid = project(grid, di, depthj, camerai, cameraj, T_itoj, di > 0, ccth)
    return warped.reshape(*depthi.shape[:-2], h, w, 2), valid.reshape(depthi.shape)
