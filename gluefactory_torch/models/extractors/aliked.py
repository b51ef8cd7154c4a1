"""ALIKED, the keypoint detector with deformable descriptors
(gluefactory_tpu/models/extractors/aliked.py), and the blocks that JPLDD and
ALIKED-light are built from.

The trunk runs NCHW inside: two conv blocks (the second at stride 2), two
deformable residual blocks after 2x2 average pools, each stage through a
1x1 convolution to dim/4 channels, the deeper three upsampled bilinearly
(half-pixel centres, as ``jax.image.resize``), concatenated, SELU; the score
head (``sh1``-``sh4``, at the top level of the parameter tree as in flax)
ends in a sigmoid. Keypoints are the top ``max_num_keypoints`` of the NMS'd
score map away from a 2-pixel border, refined by soft-argmax, with the +0.5
pixel-centre convention; SDDH describes them. Convolutions pad as flax's
``'SAME'`` does: a stride-2 3x3 convolution of an even size pads one pixel
at the bottom and right only. The deformable convolution predicts k*k
offsets a pixel (its offset convolution starts at zero), samples the input
bilinearly at the offset k x k grid (clamped at the border) and mixes the
samples, flattened as (k*k, C), with one dense layer. SDDH samples a k x k
patch around each keypoint, regresses M offsets from it (the offset layer
starts at zero), samples the map there and aggregates the M samples with a
(M, C, dim) weight drawn from ``normal(0.02)``; descriptors are L2-normalised.

``compat: true`` runs the official checkpoint's graph (the ``Compat*``
blocks) on a state dict from ``torch_weight_converter``: the image
edge-padded to a multiple of 32, pools of 2, 4 and 4 between the blocks,
folded BatchNorms, torchvision's deformable convolution (offsets clamped to
max(h, w)/4, zero padding), ``align_corners=True`` upsampling, a raw score
head, an L2-normalised feature map, DKD's soft-argmax at temperature 0.1
and the official SDDH (an integer patch whose corner is clamped to
``[0, w-1-k]``, kept as the reference has it).

Images come in the JAX layout (B, H, W, C) with 3 channels (``compat``
tiles a grey one, as JAX does); the dense outputs keep it. Parameters are
named as the flax modules (``dcn1.offset``, ``dcn1.mix``, ``desc_head.agg``),
so ``utils.weights.params_from_flat`` maps a flax tree strictly."""

from __future__ import annotations

from typing import ClassVar

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ...ops.interpolate import bilinear_sample, bilinear_sample_zeros
from ...ops.nms import select_top_k_keypoints, simple_nms, soft_argmax_refinement
from ..base_model import BaseModel
from ..utils.init import flax_reset_, normal_, zeros_reset_

ALIKED_CFGS = {
    # c1, c2, c3, c4, dim, K (SDDH patch), M (SDDH samples)
    "aliked-t16": (8, 16, 32, 64, 64, 3, 16),
    "aliked-n16": (16, 32, 64, 128, 128, 3, 16),
    "aliked-n16rot": (16, 32, 64, 128, 128, 3, 16),
    "aliked-n32": (16, 32, 64, 128, 128, 3, 32),
}


class Conv(nn.Conv2d):
    """flax's ``nn.Conv(features, (k, k), strides, padding='SAME')`` in NCHW,
    initialised as flax does (``zero_init``: ``kernel_init=zeros``)."""

    def __init__(self, c_in: int, c_out: int, kernel_size: int, stride: int = 1,
                 zero_init: bool = False, bias: bool = True):
        self.zero_init = zero_init
        super().__init__(c_in, c_out, kernel_size, stride=stride,
                         padding=(kernel_size - 1) // 2 if stride == 1 else 0, bias=bias)

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


def _recomputed(recompute: bool, fn, *args):
    """``fn(*args)``; with ``recompute``, under autograd its intermediates
    are not kept but recomputed in the backward pass
    (``torch.utils.checkpoint``)."""
    if recompute and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


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
    the k x k neighbourhood + a dense mix of the (k*k, C) samples. With
    ``recompute``, under autograd the gather and the mix are recomputed in
    the backward pass: their taps hold ~40 times the input."""

    def __init__(self, c_in: int, features: int, kernel: int = 3, recompute: bool = False):
        super().__init__()
        self.kernel, self.recompute = kernel, recompute
        self.offset = Conv(c_in, 2 * kernel * kernel, 3, zero_init=True)
        self.mix = Dense(kernel * kernel * c_in, features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _recomputed(self.recompute, self._deform, x, self.offset(x))

    def _deform(self, x: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        kk = self.kernel * self.kernel
        offsets = offsets.permute(0, 2, 3, 1).reshape(b, h, w, kk, 2)
        ys, xs = torch.meshgrid(torch.arange(h, dtype=x.dtype, device=x.device),
                                torch.arange(w, dtype=x.dtype, device=x.device), indexing="ij")
        centers = torch.stack([xs, ys], dim=-1)[None, :, :, None, :]
        pos = centers + _grid(self.kernel, x) + offsets  # (b, h, w, kk, 2)
        sampled = bilinear_sample(x.permute(0, 2, 3, 1), pos.reshape(b, h * w * kk, 2))
        return self.mix(sampled.reshape(b, h, w, kk * c)).permute(0, 3, 1, 2)


class ResBlock(nn.Module):
    """Two (deformable) 3x3 convolutions with SELU, plus the input (through
    a 1x1 ``proj`` where the width changes), then SELU."""

    def __init__(self, c_in: int, features: int, deformable: bool = False,
                 recompute: bool = False):
        super().__init__()
        self.deformable = deformable
        self.proj = Conv(c_in, features, 1) if c_in != features else None
        if deformable:
            self.dcn1 = DeformableConv(c_in, features, recompute=recompute)
            self.dcn2 = DeformableConv(features, features, recompute=recompute)
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


# --- the official checkpoint's graph (compat) ------------------------------------------

def _resize_align_corners(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear resize of x (B, C, h, w) with ``align_corners=True`` (the
    official ``nn.Upsample``); a side of 1 is repeated."""
    return F.interpolate(x, size=(out_h, out_w), mode="bilinear", align_corners=True)


class CompatDCN(nn.Module):
    """torchvision's deformable convolution with the BatchNorm folded in: a
    3x3 offset convolution (bias), offsets clamped to +-max(h, w)/4 in its
    (dy, dx)-interleaved channel layout, zero-padded bilinear samples of the
    k x k grid, then the regular convolution's weights as one dense mix."""

    def __init__(self, c_in: int, features: int, kernel: int = 3):
        super().__init__()
        self.kernel = kernel
        self.offset = Conv(c_in, 2 * kernel * kernel, kernel)
        self.mix = Dense(kernel * kernel * c_in, features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        kk = self.kernel * self.kernel
        bound = max(h, w) / 4.0
        off = self.offset(x).clamp(-bound, bound)
        off = off.permute(0, 2, 3, 1).reshape(b, h, w, kk, 2).flip(-1)  # -> (dx, dy)
        ys, xs = torch.meshgrid(torch.arange(h, dtype=x.dtype, device=x.device),
                                torch.arange(w, dtype=x.dtype, device=x.device), indexing="ij")
        centers = torch.stack([xs, ys], dim=-1)[None, :, :, None, :]
        pos = centers + _grid(self.kernel, x) + off
        sampled = bilinear_sample_zeros(x.permute(0, 2, 3, 1), pos.reshape(b, h * w * kk, 2))
        return self.mix(sampled.reshape(b, h, w, kk * c)).permute(0, 3, 1, 2)


class CompatConvBlock(nn.Module):
    """conv 3x3 -> SELU twice (the BatchNorms folded into the biases)."""

    def __init__(self, c_in: int, features: int):
        super().__init__()
        self.conv1 = Conv(c_in, features, 3)
        self.conv2 = Conv(features, features, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.selu(self.conv2(F.selu(self.conv1(x))))


class CompatResBlock(nn.Module):
    """The official ResBlock: (deformable) conv, SELU, (deformable) conv,
    plus a 1x1 ``downsample`` of the input, SELU."""

    def __init__(self, c_in: int, features: int, deformable: bool = False):
        super().__init__()
        layer = CompatDCN if deformable else (lambda i, o: Conv(i, o, 3))
        self.conv1 = layer(c_in, features)
        self.conv2 = layer(features, features)
        self.downsample = Conv(c_in, features, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.selu(self.conv2(F.selu(self.conv1(x))) + self.downsample(x))


class CompatSDDH(nn.Module):
    """The official SDDH: the integer k x k patch at each truncated keypoint
    (its corner clamped to [0, w-1-k], a reference quirk), a dense offset
    layer, SELU and a second, offsets clamped to +-max(h, w)/4 and laid out
    as (2, M), zero-padded bilinear samples at keypoint + offset, a 1x1
    ``sf_conv`` without bias, SELU, the (M, C, dim) aggregation, normalised."""

    def __init__(self, c_in: int, dim: int, k: int = 3, M: int = 16):
        super().__init__()
        self.k, self.M = k, M
        self.offset1 = Dense(k * k * c_in, 2 * M)
        self.offset2 = Dense(2 * M, 2 * M)
        self.sf_conv = Dense(c_in, c_in, bias=False)
        self.agg = nn.Parameter(torch.empty(M, c_in, dim))
        self.reset_parameters()

    def reset_parameters(self) -> None:
        normal_(self.agg, 0.02)

    def forward(self, fmap: torch.Tensor, keypoints: torch.Tensor) -> torch.Tensor:
        """fmap (B, H, W, C), keypoints (B, N, 2) in pixels -> (B, N, dim)."""
        b, h, w, c = fmap.shape
        n, k, M = keypoints.shape[1], self.k, self.M
        corner = keypoints.floor().long() - (k - 1) // 2
        high = torch.tensor([w - 1 - k, h - 1 - k], device=corner.device)
        corner = torch.minimum(corner.clamp_min(0), high)
        ii, jj = torch.meshgrid(torch.arange(k, device=corner.device),
                                torch.arange(k, device=corner.device), indexing="ij")
        px = corner[:, :, None, 0] + jj.reshape(-1)  # (B, N, k*k), row-major (i, j)
        py = corner[:, :, None, 1] + ii.reshape(-1)
        patch = torch.take_along_dim(fmap.reshape(b, h * w, c),
                                     (py * w + px).reshape(b, n * k * k, 1), dim=1)
        offs = self.offset2(F.selu(self.offset1(patch.reshape(b, n, k * k * c))))
        bound = max(h, w) / 4.0
        offs = offs.clamp(-bound, bound).reshape(b, n, 2, M).transpose(2, 3)
        pos = keypoints[:, :, None, :] + offs
        feats = bilinear_sample_zeros(fmap, pos.reshape(b, n * M, 2)).reshape(b, n, M, c)
        desc = torch.einsum("bnmc,mcd->bnd", F.selu(self.sf_conv(feats)), self.agg)
        return desc / (torch.linalg.vector_norm(desc, dim=-1, keepdim=True) + 1e-8)


# --- the model ----------------------------------------------------------------------------

def _model_cfg(name: str) -> tuple:
    if name not in ALIKED_CFGS:
        raise ValueError(f"unknown ALIKED model_name {name!r}; known: {sorted(ALIKED_CFGS)}")
    return ALIKED_CFGS[name]


def _rgb(image: torch.Tensor, tile_grey: bool) -> torch.Tensor:
    """The (B, H, W, 3) image: block1 takes 3 channels (flax fixes its width
    at the first image; the benchmarks' and the datasets' images are RGB)."""
    if tile_grey and image.shape[-1] == 1:
        image = image.expand(*image.shape[:-1], 3)
    if image.shape[-1] != 3:
        raise ValueError(f"ALIKED takes (B, H, W, 3) images, got {tuple(image.shape)}"
                         + ("" if tile_grey else " (only compat tiles a grey image)"))
    return image


class ALIKEDTrunk(nn.Module):
    """The trunk and its aggregation, shared by ALIKED, ALIKED-light and
    JPLDD. With ``recompute`` (ALIKED's and ALIKED-light's trunks), under
    autograd the deformable gathers and the full-resolution aggregation are
    recomputed in the backward pass: a frozen ALIKED's gradients at batch
    32 of 640x640 pairs would keep ~100 GB. JPLDD keeps them."""

    def _trunk(self, c_in: int, c1: int, c2: int, c3: int, c4: int, dim: int,
               recompute: bool = False) -> None:
        self.recompute = recompute
        self.block1 = ConvBlock(c_in, c1)
        self.block2 = ConvBlock(c1, c2, stride=2)
        self.block3 = ResBlock(c2, c3, deformable=True, recompute=recompute)
        self.block4 = ResBlock(c3, c4, deformable=True, recompute=recompute)
        for i, c in enumerate((c1, c2, c3, c4), 1):
            setattr(self, f"agg_conv{i}", Conv(c, dim // 4, 1))

    def stages(self, image: torch.Tensor) -> tuple[torch.Tensor, ...]:
        """(B, H, W, C) image -> the four blocks' outputs (NCHW)."""
        x1 = self.block1(image.permute(0, 3, 1, 2))
        x2 = self.block2(x1)
        x3 = self.block3(F.avg_pool2d(x2, 2))
        x4 = self.block4(F.avg_pool2d(x3, 2))
        return x1, x2, x3, x4

    def features(self, image: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) image -> (B, dim, H, W) features (after the SELU)."""
        return _recomputed(self.recompute, self._aggregate, *self.stages(image))

    def _aggregate(self, x1, x2, x3, x4) -> torch.Tensor:
        def up(x):
            return F.interpolate(x, size=x1.shape[-2:], mode="bilinear", align_corners=False)

        return F.selu(torch.cat([self.agg_conv1(x1), up(self.agg_conv2(x2)),
                                 up(self.agg_conv3(x3)), up(self.agg_conv4(x4))], dim=1))


class ALIKED(BaseModel, ALIKEDTrunk):
    default_conf: ClassVar[dict] = {
        "model_name": "aliked-n16",
        "max_num_keypoints": 1024,
        "detection_threshold": 0.0002,
        "nms_radius": 2,
        "refinement_radius": 2,
        "dense_outputs": False,
        "weights": None,
        # the official checkpoint's graph, on torch_weight_converter's output
        "compat": False,
    }
    unported_conf: ClassVar[frozenset] = frozenset({"weights"})
    unported_note: ClassVar[str] = ("ALIKED loads a checkpoint through the pipeline's "
                                    "checkpoint, or an official .pth through "
                                    "torch_weight_converter with compat: true")
    required_data_keys: ClassVar[list] = ["image"]

    def __init__(self, conf: dict | None = None):
        super().__init__(conf)
        c1, c2, c3, c4, dim, k, M = _model_cfg(self.conf["model_name"])
        if self.conf["compat"]:
            self.block1 = CompatConvBlock(3, c1)
            self.block2 = CompatResBlock(c1, c2)
            self.block3 = CompatResBlock(c2, c3, deformable=True)
            self.block4 = CompatResBlock(c3, c4, deformable=True)
            for i, c in enumerate((c1, c2, c3, c4), 1):
                setattr(self, f"agg_conv{i}", Conv(c, dim // 4, 1, bias=False))
            bias = False
            self.desc_head = CompatSDDH(dim, dim, k=k, M=M)
        else:
            self._trunk(3, c1, c2, c3, c4, dim, recompute=True)
            bias = True
            self.desc_head = SDDH(dim, dim, k=k, M=M)
        self.sh1 = Conv(dim, 8, 1, bias=bias)
        self.sh2 = Conv(8, 4, 3, bias=bias)
        self.sh3 = Conv(4, 4, 3, bias=bias)
        self.sh4 = Conv(4, 1, 3, bias=bias)

    def score_head(self, x: torch.Tensor) -> torch.Tensor:
        """(B, dim, H, W) -> (B, H, W) raw scores."""
        return self.sh4(F.selu(self.sh3(F.selu(self.sh2(F.selu(self.sh1(x)))))))[:, 0]

    def extract_dense_map(self, image: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(B, H, W, 3) -> feature map (B, H, W, dim), score map (B, H, W);
        the full-resolution aggregation and score head recomputed in the
        backward pass (a frozen ALIKED's gradients at batch 32 of 640x640
        pairs would keep ~100 GB)."""
        def dense(*stages):
            features = self._aggregate(*stages)
            return features, torch.sigmoid(self.score_head(features))

        features, score_map = _recomputed(self.recompute, dense, *self.stages(image))
        return features.permute(0, 2, 3, 1), score_map

    def extract_dense_map_compat(self, image: torch.Tensor
                                 ) -> tuple[torch.Tensor, torch.Tensor]:
        """The official graph: edge-pad to a multiple of 32 (split top/bottom,
        left/right), pools of 2, 4 and 4 between the blocks, each stage
        through its 1x1 convolution and SELU, upsampled with
        ``align_corners=True``, the raw score head, the feature map
        L2-normalised (eps 1e-12), both cut back to the image."""
        h0, w0 = image.shape[1:3]
        pad_h, pad_w = (-h0) % 32, (-w0) % 32
        top, left = pad_h // 2, pad_w // 2
        x = image.permute(0, 3, 1, 2)
        if pad_h or pad_w:
            x = F.pad(x, (left, pad_w - left, top, pad_h - top), mode="replicate")
        h, w = x.shape[-2:]
        x1 = self.block1(x)
        x2 = self.block2(F.avg_pool2d(x1, 2))  # 1/2
        x3 = self.block3(F.avg_pool2d(x2, 4))  # 1/8
        x4 = self.block4(F.avg_pool2d(x3, 4))  # 1/32
        x1234 = torch.cat([F.selu(self.agg_conv1(x1)),
                           _resize_align_corners(F.selu(self.agg_conv2(x2)), h, w),
                           _resize_align_corners(F.selu(self.agg_conv3(x3)), h, w),
                           _resize_align_corners(F.selu(self.agg_conv4(x4)), h, w)], dim=1)
        score_map = self.score_head(x1234)
        feature_map = x1234 / (torch.linalg.vector_norm(x1234, dim=1, keepdim=True) + 1e-12)
        return (feature_map[:, :, top:top + h0, left:left + w0].permute(0, 2, 3, 1),
                score_map[:, top:top + h0, left:left + w0])

    def _forward(self, data: dict) -> dict:
        if self.conf["compat"]:
            return self._forward_compat(data)
        conf = self.conf
        feature_map, score_map = self.extract_dense_map(_rgb(data["image"], False))
        keypoints, scores, valid = select_top_k_keypoints(
            simple_nms(score_map, int(conf["nms_radius"])), k=int(conf["max_num_keypoints"]),
            threshold=float(conf["detection_threshold"]), border=2,
            image_size=data.get("image_size"))
        if conf["refinement_radius"] > 0:
            keypoints = soft_argmax_refinement(keypoints, score_map,
                                               int(conf["refinement_radius"]))
        pred = {"keypoints": keypoints + 0.5, "keypoint_scores": scores, "keypoint_valid": valid,
                "descriptors": self.desc_head(feature_map, keypoints)}
        if conf["dense_outputs"]:
            pred.update(descriptors_dense=feature_map, score_map=score_map)
        return pred

    def _forward_compat(self, data: dict) -> dict:
        """DKD's top-k detection and the official SDDH, in fixed slots:
        the NMS'd raw scores inside the border (and ``image_size``), the top
        ``max_num_keypoints`` by score (ties to the lower index, as
        ``lax.top_k``), DKD's soft-argmax at temperature 0.1 over the
        zero-padded (2r+1)^2 patch and its ``score_dispersity``, the score
        sampled at the refined position, and the official output scaling
        w / (w - 1)."""
        conf = self.conf
        image = _rgb(data["image"], True)
        b, h, w, _ = image.shape
        feature_map, score_map = self.extract_dense_map_compat(image)
        radius, k = int(conf["nms_radius"]), int(conf["max_num_keypoints"])
        nms = simple_nms(score_map, radius)
        dev = score_map.device
        ys = torch.arange(h, device=dev)[None, :, None]
        xs = torch.arange(w, device=dev)[None, None, :]
        border = (ys >= radius) & (xs >= radius) & (ys < h - radius) & (xs < w - radius)
        if data.get("image_size") is not None:
            size = data["image_size"]
            border = border & (xs < size[:, None, None, 0] - radius) & (
                ys < size[:, None, None, 1] - radius)
        nms = torch.where(border, nms, torch.zeros_like(nms))
        top_scores, top_idx = torch.sort(nms.reshape(b, -1), dim=-1, descending=True,
                                         stable=True)
        top_scores, top_idx = top_scores[:, :k], top_idx[:, :k]
        valid = top_scores > float(conf["detection_threshold"])
        kp_nms = torch.stack([top_idx % w, top_idx // w], dim=-1).to(score_map.dtype)
        win = torch.arange(-radius, radius + 1, dtype=score_map.dtype, device=dev)
        dyy, dxx = torch.meshgrid(win, win, indexing="ij")
        grid = torch.stack([dxx.reshape(-1), dyy.reshape(-1)], dim=-1)  # (W2, 2) as (x, y)
        pos = (kp_nms[:, :, None, :] + grid).long()
        pxi, pyi = pos[..., 0], pos[..., 1]
        inb = (pxi >= 0) & (pxi < w) & (pyi >= 0) & (pyi < h)
        idx = torch.where(inb, pyi * w + pxi, torch.zeros_like(pxi)).reshape(b, -1)
        patch = torch.take_along_dim(score_map.reshape(b, -1), idx, dim=1).reshape(b, k, -1)
        patch = patch * inb  # zero padding, as unfold pads
        x_exp = torch.exp((patch - patch.amax(dim=-1, keepdim=True)) / 0.1)
        denom = x_exp.sum(dim=-1, keepdim=True)
        residual = torch.einsum("bkp,pt->bkt", x_exp, grid) / denom
        dist2 = (((grid[None, None] - residual[:, :, None]) / radius) ** 2).sum(dim=-1)
        dispersity = (x_exp * dist2).sum(dim=-1) / denom[..., 0]
        kp_px = kp_nms + residual
        kp_scores = bilinear_sample(score_map[..., None], kp_px)[..., 0]
        desc = self.desc_head(feature_map, kp_px)
        wh1 = torch.tensor([w - 1.0, h - 1.0], dtype=kp_px.dtype, device=dev)
        wh = torch.tensor([float(w), float(h)], dtype=kp_px.dtype, device=dev)
        keypoints = torch.where(valid[..., None], kp_px / wh1 * wh, torch.zeros_like(kp_px))
        pred = {"keypoints": keypoints,
                "keypoint_scores": torch.where(valid, kp_scores, torch.zeros_like(kp_scores)),
                "keypoint_valid": valid, "score_dispersity": dispersity, "descriptors": desc}
        if conf["dense_outputs"]:
            pred.update(descriptors_dense=feature_map, score_map=score_map)
        return pred

    def loss(self, pred: dict, data: dict):
        raise NotImplementedError("ALIKED is used pretrained / as a teacher")


__main_model__ = ALIKED


def torch_weight_converter(state_dict: dict) -> dict:
    """The port's ``compat: true`` state dict of an official ALIKED checkpoint
    (Shiaoming/ALIKED ``*.pth``: give ``torch.load(path, weights_only=True)``,
    or any name -> array dict). Eval-mode BatchNorms (eps 1e-5) are folded
    into the preceding convolutions in float64; a deformable convolution's
    regular weights become its dense ``mix``; the layouts are the flax tree's
    of the JAX package's converter, carried over by ``params_from_flat``."""
    from ...utils.weights import params_from_flat

    eps = 1e-5
    sd = {k: np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach") else v, np.float64)
          for k, v in state_dict.items()}

    def bn_fold(prefix):
        a = sd[f"{prefix}.weight"] / np.sqrt(sd[f"{prefix}.running_var"] + eps)
        return a, sd[f"{prefix}.bias"] - a * sd[f"{prefix}.running_mean"]

    def conv_bn(conv_prefix, bn_prefix):
        a, b = bn_fold(bn_prefix)
        w = sd[f"{conv_prefix}.weight"] * a[:, None, None, None]
        return {"kernel": w.transpose(2, 3, 1, 0), "bias": b}

    def plain_conv(prefix, bias=True):
        p = {"kernel": sd[f"{prefix}.weight"].transpose(2, 3, 1, 0)}
        if bias:
            p["bias"] = sd[f"{prefix}.bias"]
        return p

    def dcn(conv_prefix, bn_prefix):
        a, b = bn_fold(bn_prefix)
        w = sd[f"{conv_prefix}.regular_conv.weight"] * a[:, None, None, None]
        cout, cin, kh, kw = w.shape
        return {"offset": plain_conv(f"{conv_prefix}.offset_conv"),
                "mix": {"kernel": w.transpose(2, 3, 1, 0).reshape(kh * kw * cin, cout),
                        "bias": b}}

    tree = {"block1": {"conv1": conv_bn("block1.conv1", "block1.bn1"),
                       "conv2": conv_bn("block1.conv2", "block1.bn2")}}
    for name, layer in (("block2", conv_bn), ("block3", dcn), ("block4", dcn)):
        tree[name] = {"conv1": layer(f"{name}.conv1", f"{name}.bn1"),
                      "conv2": layer(f"{name}.conv2", f"{name}.bn2"),
                      "downsample": plain_conv(f"{name}.downsample")}
    for i in range(1, 5):
        tree[f"agg_conv{i}"] = plain_conv(f"conv{i}", bias=False)
    for i, idx in enumerate((0, 2, 4, 6), 1):
        tree[f"sh{i}"] = plain_conv(f"score_head.{idx}", bias=False)
    w_off1 = sd["desc_head.offset_conv.0.weight"]  # (2M, C, K, K)
    m2, c, kh, kw = w_off1.shape
    tree["desc_head"] = {
        "offset1": {"kernel": w_off1.transpose(2, 3, 1, 0).reshape(kh * kw * c, m2),
                    "bias": sd["desc_head.offset_conv.0.bias"]},
        "offset2": {"kernel": sd["desc_head.offset_conv.2.weight"][:, :, 0, 0].T,
                    "bias": sd["desc_head.offset_conv.2.bias"]},
        "sf_conv": {"kernel": sd["desc_head.sf_conv.weight"][:, :, 0, 0].T},
        "agg": sd["desc_head.agg_weights"],
    }

    def flat(node, prefix):
        if isinstance(node, dict):
            return {k: v for key, sub in node.items() for k, v in flat(sub, f"{prefix}['{key}']")
                    .items()}
        return {prefix: node.astype(np.float32)}

    return params_from_flat(flat(tree, "['params']"))
