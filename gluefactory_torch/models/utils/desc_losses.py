"""Descriptor losses over warped correspondences
(gluefactory_tpu/models/utils/desc_losses.py): the keypoint InfoNCE, the
mutual-nearest pairing of detections under a homography and the CAPS
expected-position window loss, batched and mask-aware. (The triplet loss
serves only POLD2 and is not ported yet.)"""

from __future__ import annotations

import torch

from ...geometry.homography import warp_points
from ...ops.interpolate import bilinear_sample


def _logsumexp(x: torch.Tensor, dim: int) -> torch.Tensor:
    """JAX's max-shifted logsumexp, kept dims."""
    m = x.amax(dim=dim, keepdim=True)
    return m + torch.log(torch.exp(x - m).sum(dim=dim, keepdim=True))


def _weighted_mean(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    w = w.to(x.dtype)
    return (x * w).sum(-1) / w.sum(-1).clamp_min(1.0)


def nll_desc_loss(desc0: torch.Tensor, desc1: torch.Tensor, gt_matches0: torch.Tensor,
                  temperature: float = 0.07, valid0: torch.Tensor | None = None) -> torch.Tensor:
    """InfoNCE: the NLL of each view-0 descriptor's GT correspondence under a
    softmax over every view-1 descriptor. Returns (B,)."""
    sim = torch.einsum("bnd,bmd->bnm", desc0, desc1) / temperature
    log_p = sim - _logsumexp(sim, dim=-1)
    idx = gt_matches0.clamp(0, sim.shape[2] - 1)
    ll = torch.take_along_dim(log_p, idx[..., None], dim=2)[..., 0]
    w = gt_matches0 >= 0
    if valid0 is not None:
        w = w & valid0
    return -_weighted_mean(ll, w)


def mutual_detected_matches(kp0: torch.Tensor, kp1: torch.Tensor, valid0: torch.Tensor,
                            valid1: torch.Tensor, H_0to1: torch.Tensor, th: float = 3.0):
    """GT correspondences between two sets of detections (B, N, 2), index
    convention: mutual nearest within ``th`` px after warping view 0 by
    ``H_0to1``. Returns (matches0, matches1), -1 where unmatched."""
    big = 1e12
    d2 = ((warp_points(kp0, H_0to1)[:, :, None, :] - kp1[:, None, :, :]) ** 2).sum(-1)
    d2 = torch.where(valid1[:, None, :] & valid0[:, :, None], d2, big)
    min01, j01 = d2.min(dim=2)
    min10, i10 = d2.min(dim=1)
    ok01 = (min01 < th**2) & valid0
    ok10 = (min10 < th**2) & valid1
    arange0 = torch.arange(kp0.shape[1], device=kp0.device)
    arange1 = torch.arange(kp1.shape[1], device=kp1.device)
    mut01 = torch.take_along_dim(i10, j01, dim=1) == arange0[None]
    mut10 = torch.take_along_dim(j01, i10, dim=1) == arange1[None]
    return (torch.where(ok01 & mut01, j01, -1), torch.where(ok10 & mut10, i10, -1))


def caps_window_loss(desc0: torch.Tensor, kpts0_in1: torch.Tensor, desc_map1: torch.Tensor,
                     window: float = 8, temperature: float = 0.07,
                     valid0: torch.Tensor | None = None) -> torch.Tensor:
    """CAPS expected position: each view-0 descriptor (B, N, D) is correlated
    with 9x9 bilinear taps of the view-1 dense map (B, h, w, D) over a
    ``window`` (map cells) around its GT reprojection ``kpts0_in1`` (map
    coordinates); the loss is the distance of the softmax-expected offset
    from 0. Returns (B,).

    The taps of one direction are B*N*81*D floats (at batch 32, 512
    keypoints and D = 256, 1.36 GB in float32, and each of the 4 bilinear
    corners as much again under autograd)."""
    b, n, _ = desc0.shape
    ks = 9  # samples per axis
    r = window / 2.0
    lin = torch.linspace(-r, r, ks, dtype=desc0.dtype, device=desc0.device)
    dy, dx = torch.meshgrid(lin, lin, indexing="ij")
    offsets = torch.stack([dx.reshape(-1), dy.reshape(-1)], dim=-1)  # (81, 2)
    pts = kpts0_in1[:, :, None, :] + offsets
    feats = bilinear_sample(desc_map1, pts.reshape(b, n * ks * ks, 2)).reshape(b, n, ks * ks, -1)
    feats = feats / torch.linalg.vector_norm(feats, dim=-1, keepdim=True).clamp_min(1e-8)
    corr = torch.einsum("bnd,bnkd->bnk", desc0, feats) / temperature
    p = torch.exp(corr - _logsumexp(corr, dim=-1))
    expected = torch.einsum("bnk,kc->bnc", p, offsets)
    # eps-smoothed: a window clamped entirely outside the map has identical
    # taps, so p is uniform and the expected offset exactly 0, where the
    # norm's gradient is NaN (and a 0 mask weight still propagates a NaN)
    err = torch.sqrt((expected**2).sum(-1) + 1e-12)
    if valid0 is None:
        valid0 = torch.ones_like(err, dtype=torch.bool)
    return _weighted_mean(err, valid0)
