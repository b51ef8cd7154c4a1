"""Keypoint non-maximum suppression, top-k selection and sub-pixel
refinement (gluefactory_tpu/ops/nms.py). Static shapes: every image gets
exactly k keypoint slots plus a validity mask."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def max_pool_2d(x: torch.Tensor, radius: int) -> torch.Tensor:
    """Sliding max over a (2r+1)^2 window with 'same' padding; x (..., H, W)."""
    h, w = x.shape[-2:]
    y = F.max_pool2d(x.reshape(-1, 1, h, w), kernel_size=2 * radius + 1, stride=1,
                     padding=radius)
    return y.reshape(x.shape)


def simple_nms(scores: torch.Tensor, radius: int, iterations: int = 2) -> torch.Tensor:
    """Iterative NMS: keep local maxima, suppress their neighbourhoods, let
    second-round maxima surface."""
    if radius <= 0:
        return scores
    zeros = torch.zeros_like(scores)
    max_mask = scores == max_pool_2d(scores, radius)
    for _ in range(iterations):
        supp_mask = max_pool_2d(max_mask.to(scores.dtype), radius) > 0
        supp_scores = torch.where(supp_mask, zeros, scores)
        new_max_mask = supp_scores == max_pool_2d(supp_scores, radius)
        max_mask = max_mask | (new_max_mask & ~supp_mask)
    return torch.where(max_mask, scores, zeros)


def select_top_k_keypoints(
    scores: torch.Tensor,
    k: int,
    threshold: float = 0.0,
    border: int = 0,
    image_size: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """scores (B, H, W) -> keypoints (B, k, 2) as (x, y) pixel indices,
    scores (B, k), valid (B, k). Slots at or below ``threshold``, or in the
    border or padding region, are invalid with position (0, 0) and score 0.

    Ties are broken by the lower flat index, as ``jax.lax.top_k`` does: a
    stable descending sort, then the first k."""
    b, h, w = scores.shape
    ys = torch.arange(h, device=scores.device)[:, None]
    xs = torch.arange(w, device=scores.device)[None, :]
    masked = scores
    if border > 0:
        inb = (ys >= border) & (ys < h - border) & (xs >= border) & (xs < w - border)
        masked = masked.masked_fill(~inb, float("-inf"))
    if image_size is not None:
        inside = (xs[None] < image_size[:, None, None, 0] - border) & (
            ys[None] < image_size[:, None, None, 1] - border)
        masked = masked.masked_fill(~inside, float("-inf"))
    top_scores, top_idx = torch.sort(masked.reshape(b, -1), dim=-1, descending=True,
                                     stable=True)
    top_scores, top_idx = top_scores[:, :k], top_idx[:, :k]
    keypoints = torch.stack([top_idx % w, top_idx // w], dim=-1).to(scores.dtype)
    valid = top_scores > threshold
    keypoints = keypoints.masked_fill(~valid[..., None], 0.0)
    kp_scores = top_scores.masked_fill(~valid, 0.0)
    return keypoints, kp_scores, valid


def com_refinement(keypoints: torch.Tensor, scores: torch.Tensor,
                   radius: int) -> torch.Tensor:
    """Center-of-mass sub-pixel refinement over a (2r+1)^2 window of the
    heatmap ``scores`` (B, H, W), with the window minimum subtracted."""
    b, k, _ = keypoints.shape
    h, w = scores.shape[-2:]
    win = torch.arange(-radius, radius + 1, dtype=keypoints.dtype,
                       device=keypoints.device)
    dy, dx = torch.meshgrid(win, win, indexing="ij")
    offsets = torch.stack([dx.reshape(-1), dy.reshape(-1)], dim=-1)  # (W2, 2)
    pos = keypoints[:, :, None, :] + offsets
    xi = pos[..., 0].clamp(0, w - 1).long()
    yi = pos[..., 1].clamp(0, h - 1).long()
    vals = torch.take_along_dim(scores.reshape(b, -1), (yi * w + xi).reshape(b, -1),
                                dim=1).reshape(b, k, -1)
    vals = (vals - vals.amin(dim=-1, keepdim=True)).clamp_min(0.0)
    weights = vals / vals.sum(dim=-1, keepdim=True).clamp_min(1e-12)
    return keypoints + (weights[..., None] * offsets).sum(dim=-2)
