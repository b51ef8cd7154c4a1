"""Homography warping of image batches on the device
(gluefactory_tpu/ops/warp.py): dst(p) = src(H^-1 p), bilinear, with a fill
value outside the source, as cv2.warpPerspective does (integer coordinates
index pixel centers)."""

from __future__ import annotations

import torch

from .interpolate import bilinear_sample


def warp_image(images: torch.Tensor, H: torch.Tensor, out_size: tuple[int, int],
               fill: float = 0.0) -> torch.Tensor:
    """Warp (B, Hs, Ws, C) images by (B, 3, 3) homographies from source to
    destination pixels into (B, h, w, C), ``out_size`` = (h, w)."""
    b, hs, ws, c = images.shape
    h, w = out_size
    Hinv = torch.linalg.inv(H.float())
    ys, xs = torch.meshgrid(torch.arange(h, device=images.device),
                            torch.arange(w, device=images.device), indexing="ij")
    grid = torch.stack([xs, ys, torch.ones_like(xs)], dim=-1).float().reshape(h * w, 3)
    src = torch.einsum("bij,nj->bni", Hinv, grid)
    src = src[..., :2] / (src[..., 2:3] + 1e-12)
    vals = bilinear_sample(images, src)
    inside = ((src[..., 0] >= 0.0) & (src[..., 0] <= ws - 1.0)
              & (src[..., 1] >= 0.0) & (src[..., 1] <= hs - 1.0))
    return torch.where(inside[..., None], vals, fill).reshape(b, h, w, c)
