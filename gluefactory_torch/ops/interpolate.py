"""Dense-map decoding and bilinear sampling at sparse points
(gluefactory_tpu/ops/interpolate.py). Maps keep the JAX layout
(B, H, W, C)."""

from __future__ import annotations

import torch


def bilinear_sample(fmap: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Sample fmap (B, H, W, C) at (x, y) points (B, N, 2) -> (B, N, C).
    (0, 0) is the center of the top-left pixel; coordinates outside the map
    are clamped to its border."""
    b, h, w, c = fmap.shape
    x = points[..., 0].clamp(0.0, w - 1.0)
    y = points[..., 1].clamp(0.0, h - 1.0)
    x0 = x.floor().long().clamp(0, w - 2)
    y0 = y.floor().long().clamp(0, h - 2)
    fx = (x - x0.to(x.dtype))[..., None]
    fy = (y - y0.to(y.dtype))[..., None]
    flat = fmap.reshape(b * h * w, c)
    base = (torch.arange(b, device=fmap.device) * (h * w)).reshape(b, *[1] * (points.ndim - 2))

    def gather(yy, xx):
        # one index a point, not one a channel: CAPS gathers 81 taps a keypoint
        index = base + yy * w + xx
        return flat.index_select(0, index.reshape(-1)).reshape(*index.shape, c)

    top = gather(y0, x0) * (1 - fx) + gather(y0, x0 + 1) * fx
    bot = gather(y0 + 1, x0) * (1 - fx) + gather(y0 + 1, x0 + 1) * fx
    return top * (1 - fy) + bot * fy


def sample_descriptors(descriptor_map: torch.Tensor, keypoints: torch.Tensor,
                       stride: int = 8, mode: str = "center") -> torch.Tensor:
    """L2-normalized descriptors at full-resolution keypoints (B, N, 2) from a
    stride-``stride`` map (B, H/s, W/s, C). 'center' puts cell i's center at
    stride/2 - 0.5 + stride*i; 'torch' maps kp/s - 0.5 as the official
    SuperPoint does."""
    if mode == "torch":
        pts = keypoints / stride - 0.5
    elif mode == "center":
        pts = (keypoints - (stride / 2.0 - 0.5)) / stride
    else:
        raise ValueError(f"unknown descriptor sampling mode {mode!r}")
    desc = bilinear_sample(descriptor_map, pts)
    return desc / (torch.linalg.vector_norm(desc, dim=-1, keepdim=True) + 1e-8)


def cell_logits_to_heatmap(logits: torch.Tensor, cell: int = 8) -> torch.Tensor:
    """Per-cell logits (B, Hc, Wc, cell*cell + 1) -> full-resolution
    probabilities (B, Hc*cell, Wc*cell): softmax over the channels, drop the
    dustbin, unshuffle the cells."""
    b, hc, wc, _ = logits.shape
    probs = torch.softmax(logits, dim=-1)[..., :-1]
    heat = probs.reshape(b, hc, wc, cell, cell).permute(0, 1, 3, 2, 4)
    return heat.reshape(b, hc * cell, wc * cell)
