"""Keypoint heatmap losses of SuperPoint training
(gluefactory_tpu/geometry/kp_losses.py): the ALIKE peakiness loss and the
sub-pixel localisation losses, batched over (B, K) keypoint slots with
validity masks and fixed window radii."""

from __future__ import annotations

import torch


def _windows(heatmap: torch.Tensor, keypoints: torch.Tensor, radius: int):
    """The (2r+1)^2 windows of ``heatmap`` (B, H, W) around the rounded
    keypoints (B, K, 2) (x, y; half to even, as ``jnp.round``), their centres
    clamped to r..size-1-r. Returns (values (B, K, W2), dx (W2,), dy (W2,),
    cx (B, K), cy (B, K))."""
    b, h, w = heatmap.shape
    r = radius
    cx = keypoints[..., 0].round().long().clamp(r, w - 1 - r)
    cy = keypoints[..., 1].round().long().clamp(r, h - 1 - r)
    offs = torch.arange(-r, r + 1, device=heatmap.device)
    dy, dx = torch.meshgrid(offs, offs, indexing="ij")
    dx, dy = dx.reshape(-1), dy.reshape(-1)
    index = (cy[..., None] + dy) * w + cx[..., None] + dx  # (B, K, W2)
    vals = torch.take_along_dim(heatmap.reshape(b, h * w), index.reshape(b, -1), dim=1)
    return (vals.reshape(*keypoints.shape[:2], -1), dx.to(heatmap.dtype),
            dy.to(heatmap.dtype), cx, cy)


def _masked_mean(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    w = valid.to(x.dtype)
    return (x * w).sum(-1) / w.sum(-1).clamp_min(1.0)


def _refined(p: torch.Tensor, dx, dy, cx, cy) -> torch.Tensor:
    return torch.stack([cx.to(p.dtype) + (p * dx).sum(-1), cy.to(p.dtype) + (p * dy).sum(-1)],
                       dim=-1)


def _softmax_window(vals: torch.Tensor, temperature: float) -> torch.Tensor:
    p = torch.exp(vals / temperature)
    return p / p.sum(-1, keepdim=True).clamp_min(1e-12)


def _distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    # eps-smoothed: the norm's gradient at a zero residual is NaN, which a
    # masked (0-weight) slot would still propagate through 0 * NaN
    return torch.sqrt(((a - b) ** 2).sum(-1) + 1e-12)


def peaky_loss(heatmap: torch.Tensor, keypoints: torch.Tensor, valid: torch.Tensor,
               radius: int = 2) -> torch.Tensor:
    """1 - (max - mean) of the window around each keypoint: small when the
    response is a sharp peak. Returns (B,)."""
    vals = _windows(heatmap, keypoints, radius)[0]
    return _masked_mean(1.0 - (vals.amax(-1) - vals.mean(-1)), valid)


def gt_anchored_loc_loss(heatmap: torch.Tensor, gt_keypoints: torch.Tensor,
                         valid: torch.Tensor, radius: int = 2, argmax_radius: int = 1,
                         temperature: float = 0.1, mode: str = "softargmax") -> torch.Tensor:
    """Localisation supervised at the GT corners: the local argmax within
    ``argmax_radius`` of each corner (the pixel NMS would keep) is refined
    over a ``radius`` window, by soft-argmax (``mode='softargmax'``, as
    ops/nms.soft_argmax_refinement) or by the centre of mass above the
    window's minimum (``'com'``, as ops/nms.com_refinement), and pulled onto
    the float corner. Returns (B,)."""
    vals, dx, dy, cx, cy = _windows(heatmap, gt_keypoints, argmax_radius)
    best = vals.argmax(-1)
    anchors = torch.stack([cx + dx.long()[best], cy + dy.long()[best]], dim=-1)
    vals, dx, dy, cx, cy = _windows(heatmap, anchors.to(heatmap.dtype), radius)
    if mode == "com":
        vals = (vals - vals.amin(-1, keepdim=True)).clamp_min(0.0)
        p = vals / vals.sum(-1, keepdim=True).clamp_min(1e-12)
    else:
        p = _softmax_window(vals, temperature)
    return _masked_mean(_distance(_refined(p, dx, dy, cx, cy), gt_keypoints), valid)


def soft_argmax_loc_loss(heatmap: torch.Tensor, keypoints: torch.Tensor,
                         gt_keypoints: torch.Tensor, valid: torch.Tensor, radius: int = 3,
                         temperature: float = 0.1, max_dist: float = 8.0) -> torch.Tensor:
    """The soft-argmax of the window around each detection should land on
    its matched GT corner; GT farther than ``max_dist`` px is ignored.
    Returns (B,)."""
    vals, dx, dy, cx, cy = _windows(heatmap, keypoints, radius)
    p = _softmax_window(vals, temperature)
    d = _distance(_refined(p, dx, dy, cx, cy), gt_keypoints)
    ok = valid & (torch.linalg.vector_norm(keypoints - gt_keypoints, dim=-1) < max_dist)
    return _masked_mean(d, ok)
