"""The ALIKED blocks that JPLDD is built from
(gluefactory_tpu/models/extractors/aliked.py: ``ConvBlock``,
``DeformableConv``, ``ResBlock``, ``SDDH``). The ALIKED model itself and the
official-checkpoint ``Compat*`` blocks are not ported.

The blocks run NCHW inside, except SDDH, which reads a feature map in the
JAX layout (B, H, W, C). Convolutions pad as flax's ``'SAME'`` does: a
stride-2 3x3 convolution of an even size pads one pixel at the bottom and
right only. The deformable convolution predicts k*k offsets a pixel (its
offset convolution starts at zero), samples the input bilinearly at the
offset k x k grid (clamped at the border) and mixes the samples, flattened
as (k*k, C), with one dense layer. SDDH samples a k x k patch around each
keypoint, regresses M offsets from it (the offset layer starts at zero),
samples the map there and aggregates the M samples with a (M, C, dim)
weight drawn from ``normal(0.02)``; descriptors are L2-normalised.
Parameters are named as the flax modules (``dcn1.offset``, ``dcn1.mix``,
``desc_head.agg``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.interpolate import bilinear_sample
from ..utils.init import flax_reset_, normal_, zeros_reset_


class Conv(nn.Conv2d):
    """flax's ``nn.Conv(features, (k, k), strides, padding='SAME')`` in NCHW,
    initialised as flax does (``zero_init``: ``kernel_init=zeros``)."""

    def __init__(self, c_in: int, c_out: int, kernel_size: int, stride: int = 1,
                 zero_init: bool = False):
        self.zero_init = zero_init
        super().__init__(c_in, c_out, kernel_size, stride=stride,
                         padding=(kernel_size - 1) // 2 if stride == 1 else 0)

    def reset_parameters(self) -> None:
        (zeros_reset_ if self.zero_init else flax_reset_)(self)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.stride[0]
        if s == 1:
            return super().forward(x)
        k = self.kernel_size[0]
        pads = []
        for n in (x.shape[-1], x.shape[-2]):  # F.pad lists the last dimension first
            total = max((-(-n // s) - 1) * s + k - n, 0)
            pads += [total // 2, total - total // 2]
        return F.conv2d(F.pad(x, pads), self.weight, self.bias, self.stride)


class Dense(nn.Linear):
    """flax's ``nn.Dense``, initialised as flax does."""

    def __init__(self, c_in: int, c_out: int, bias: bool = True, zero_init: bool = False):
        self.zero_init = zero_init
        super().__init__(c_in, c_out, bias=bias)

    def reset_parameters(self) -> None:
        (zeros_reset_ if self.zero_init else flax_reset_)(self)


def _grid(k: int, like: torch.Tensor) -> torch.Tensor:
    """The k x k offsets (k*k, 2) as (dx, dy), row-major over (dy, dx)."""
    r = (k - 1) / 2.0
    lin = torch.linspace(-r, r, k, dtype=like.dtype, device=like.device)
    dy, dx = torch.meshgrid(lin, lin, indexing="ij")
    return torch.stack([dx.reshape(-1), dy.reshape(-1)], dim=-1)


class ConvBlock(nn.Module):
    """conv 3x3 (stride) -> SELU -> conv 3x3 -> SELU."""

    def __init__(self, c_in: int, features: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv(c_in, features, 3, stride)
        self.conv2 = Conv(features, features, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.selu(self.conv2(F.selu(self.conv1(x))))


class DeformableConv(nn.Module):
    """Offsets (a zero-initialised 3x3 conv) + clamped bilinear gather of
    the k x k neighbourhood + a dense mix of the (k*k, C) samples."""

    def __init__(self, c_in: int, features: int, kernel: int = 3):
        super().__init__()
        self.kernel = kernel
        self.offset = Conv(c_in, 2 * kernel * kernel, 3, zero_init=True)
        self.mix = Dense(kernel * kernel * c_in, features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        kk = self.kernel * self.kernel
        offsets = self.offset(x).permute(0, 2, 3, 1).reshape(b, h, w, kk, 2)
        ys, xs = torch.meshgrid(torch.arange(h, dtype=x.dtype, device=x.device),
                                torch.arange(w, dtype=x.dtype, device=x.device), indexing="ij")
        centers = torch.stack([xs, ys], dim=-1)[None, :, :, None, :]
        pos = centers + _grid(self.kernel, x) + offsets  # (b, h, w, kk, 2)
        sampled = bilinear_sample(x.permute(0, 2, 3, 1), pos.reshape(b, h * w * kk, 2))
        return self.mix(sampled.reshape(b, h, w, kk * c)).permute(0, 3, 1, 2)


class ResBlock(nn.Module):
    """Two (deformable) 3x3 convolutions with SELU, plus the input (through
    a 1x1 ``proj`` where the width changes), then SELU."""

    def __init__(self, c_in: int, features: int, deformable: bool = False):
        super().__init__()
        self.deformable = deformable
        self.proj = Conv(c_in, features, 1) if c_in != features else None
        if deformable:
            self.dcn1 = DeformableConv(c_in, features)
            self.dcn2 = DeformableConv(features, features)
        else:
            self.conv1 = Conv(c_in, features, 3)
            self.conv2 = Conv(features, features, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.proj is None else self.proj(x)
        first, second = (self.dcn1, self.dcn2) if self.deformable else (self.conv1, self.conv2)
        return F.selu(second(F.selu(first(x))) + identity)


class SDDH(nn.Module):
    """Sparse deformable descriptor head: a k x k patch at each keypoint ->
    M offsets -> M bilinear samples -> (M, C, dim) aggregation, normalised."""

    def __init__(self, c_in: int, dim: int, k: int = 3, M: int = 16):
        super().__init__()
        self.k, self.M = k, M
        self.offset_hidden = Dense(k * k * c_in, c_in)
        self.offset = Dense(c_in, 2 * M, zero_init=True)
        self.agg = nn.Parameter(torch.empty(M, c_in, dim))
        self.reset_parameters()

    def reset_parameters(self) -> None:
        normal_(self.agg, 0.02)

    def forward(self, fmap: torch.Tensor, keypoints: torch.Tensor) -> torch.Tensor:
        """fmap (B, H, W, C), keypoints (B, N, 2) in pixels -> (B, N, dim)."""
        b, _, _, c = fmap.shape
        n, k, M = keypoints.shape[1], self.k, self.M
        pos = keypoints[:, :, None, :] + _grid(k, keypoints)
        patch = bilinear_sample(fmap, pos.reshape(b, n * k * k, 2)).reshape(b, n, k * k * c)
        offs = self.offset(F.selu(self.offset_hidden(patch))).reshape(b, n, M, 2)
        sample_pos = keypoints[:, :, None, :] + offs * (k * 2.0)
        feats = bilinear_sample(fmap, sample_pos.reshape(b, n * M, 2)).reshape(b, n, M, c)
        desc = torch.einsum("bnmc,mcd->bnd", feats, self.agg)
        return desc / (torch.linalg.vector_norm(desc, dim=-1, keepdim=True) + 1e-8)
