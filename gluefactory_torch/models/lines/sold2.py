"""SOLD2-class line detector and descriptor, inference
(gluefactory_tpu/models/lines/sold2.py).

A convolutional encoder to 1/4 resolution (residual blocks with GroupNorm)
feeds three heads: junctions (a cell softmax with a dustbin over 8 x 8
cells, unshuffled to a full-resolution map), a line heatmap (16 channels at
1/4 pixel-shuffled to full resolution, sigmoid) and a 128-d descriptor map
at 1/4, L2-normalised (for the Wunsch matcher). Lines come from a
static-shape search: the top ``max_num_junctions`` junctions after NMS, all
their pairs, ``num_samples`` heatmap samples along each pair's segment
(nearest pixel), kept where enough samples are above ``heatmap_threshold``
and their mean is high enough, scored mean x inlier share, the best
``max_num_lines`` in slots with a validity mask (ties by the lower pair
index, as ``lax.top_k``).

Layers are flax's: GroupNorm with flax's epsilon (1e-6) and its fast
variance (E[x^2] - E[x]^2), convolutions with explicit 1-pixel padding or,
for the 1 x 1 kernels, flax's 'SAME' padding (none, at any size and stride),
parameters named as the JAX package's (``stem.c1.weight``,
``stem.n1.scale``). Maps are returned in the JAX layout (B, H, W, C).

SOLD2's training (its ``loss``, the synthetic-shapes engines and
``sold2_train_pairs``) is not ported: the ``loss`` keys are refused."""

from __future__ import annotations

from typing import ClassVar

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops.nms import select_top_k_keypoints, simple_nms
from ..base_model import BaseModel
from ..utils.init import flax_reset_

GRAY = (0.299, 0.587, 0.114)


class Conv(nn.Conv2d):
    """flax's ``nn.Conv`` (initialised as flax does) in NCHW."""

    def __init__(self, c_in: int, c_out: int, kernel_size: int, stride: int = 1):
        super().__init__(c_in, c_out, kernel_size, stride=stride, padding=kernel_size // 2)

    def reset_parameters(self) -> None:
        flax_reset_(self)


class GroupNorm(nn.Module):
    """flax's ``nn.GroupNorm``: epsilon 1e-6, the fast variance
    max(E[x^2] - E[x]^2, 0), a per-channel ``scale`` and ``bias``."""

    def __init__(self, features: int, num_groups: int = 4, eps: float = 1e-6):
        super().__init__()
        self.num_groups, self.eps = num_groups, eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        g = x.reshape(b, self.num_groups, -1)
        mean = g.mean(-1, keepdim=True)
        var = ((g * g).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
        y = ((g - mean) * torch.rsqrt(var + self.eps)).reshape(b, c, h, w)
        return y * self.scale[:, None, None] + self.bias[:, None, None]


class ResBlock(nn.Module):
    """conv 3x3 (stride) -> GroupNorm -> ReLU -> conv 3x3 -> GroupNorm, plus
    the input (through a 1x1 ``proj`` where the stride or width changes),
    then ReLU."""

    def __init__(self, c_in: int, features: int, stride: int = 1):
        super().__init__()
        self.c1 = Conv(c_in, features, 3, stride)
        self.n1 = GroupNorm(features)
        self.c2 = Conv(features, features, 3)
        self.n2 = GroupNorm(features)
        self.proj = Conv(c_in, features, 1, stride) if stride != 1 or c_in != features else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.n2(self.c2(F.relu(self.n1(self.c1(x)))))
        return F.relu((x if self.proj is None else self.proj(x)) + y)


def pair_indices(n: int) -> np.ndarray:
    """The (n (n - 1) / 2, 2) pairs i < j, in row-major order."""
    return np.stack(np.triu_indices(n, k=1), axis=-1).astype(np.int32)


def unshuffle(x: torch.Tensor, g: int) -> torch.Tensor:
    """(B, hc, wc, g * g) cells -> (B, hc * g, wc * g), each cell's channels
    row-major within it, as the JAX package reshapes them."""
    b, hc, wc, _ = x.shape
    return x.reshape(b, hc, wc, g, g).permute(0, 1, 3, 2, 4).reshape(b, hc * g, wc * g)


class SOLD2(BaseModel):
    default_conf: ClassVar[dict] = {
        "channels": [32, 64, 128],
        "descriptor_dim": 128,
        "grid_size": 8,  # junction cell size
        "max_num_junctions": 250,
        "junction_threshold": 0.008,
        "nms_radius": 4,
        "max_num_lines": 512,
        "num_samples": 32,  # heatmap samples per candidate segment
        "heatmap_threshold": 0.5,  # a sample's inlier test
        "inlier_ratio": 0.85,
        "mean_score_threshold": 0.6,
        "min_length": 16.0,
        "sparse_outputs": True,
        "loss": {"heatmap_weight": 1.0, "junction_weight": 1.0, "pos_weight": 100.0,
                 "desc_nll_weight": 0.0, "desc_nll_temp": 0.1},
    }
    unported_conf: ClassVar[frozenset] = frozenset({"loss"})
    unported_note: ClassVar[str] = ("SOLD2's loss and training (the synthetic-shapes engines, "
                                    "sold2_train_pairs) are a later slice of the port")
    required_data_keys: ClassVar[list] = ["image"]

    def __init__(self, conf: dict | None = None):
        super().__init__(conf)
        c1, c2, c3 = self.conf["channels"]
        g = int(self.conf["grid_size"])
        self.stem = ResBlock(1, c1)
        self.down1 = ResBlock(c1, c2, stride=2)
        self.down2 = ResBlock(c2, c3, stride=2)
        self.trunk = ResBlock(c3, c3)
        self.junc_down = ResBlock(c3, c3, stride=g // 4)
        self.junc_out = Conv(c3, g * g + 1, 1)
        self.heat_out = Conv(c3, 16, 3)
        self.desc_out = Conv(c3, int(self.conf["descriptor_dim"]), 1)

    def _heads(self, image: torch.Tensor):
        """(B, H, W, C) -> (junction map (B, H, W), junction logits (B, H/g,
        W/g, g*g + 1), line heatmap (B, H, W), descriptors (B, H/4, W/4, D))."""
        x = image
        if x.shape[-1] != 1:
            x = (x[..., :3] @ x.new_tensor(GRAY))[..., None]
        b, h, w, _ = x.shape
        f = self.trunk(self.down2(self.down1(self.stem(x.permute(0, 3, 1, 2)))))
        g = int(self.conf["grid_size"])
        jl = self.junc_out(self.junc_down(f)).permute(0, 2, 3, 1)
        junc_map = unshuffle(torch.softmax(jl, dim=-1)[..., :-1], g)[:, :h, :w]
        heat = torch.sigmoid(unshuffle(self.heat_out(f).permute(0, 2, 3, 1), 4))[:, :h, :w]
        desc = self.desc_out(f).permute(0, 2, 3, 1)
        desc = desc / torch.linalg.vector_norm(desc, dim=-1, keepdim=True).clamp_min(1e-8)
        return junc_map, jl, heat, desc

    def _extract_lines(self, junc_map: torch.Tensor, heat: torch.Tensor, image_size) -> dict:
        conf = self.conf
        b = junc_map.shape[0]
        k = int(conf["max_num_junctions"])
        junc, jsc, jvalid = select_top_k_keypoints(
            simple_nms(junc_map, int(conf["nms_radius"])), k=k,
            threshold=float(conf["junction_threshold"]), border=2, image_size=image_size)
        pairs = torch.from_numpy(pair_indices(k)).long().to(junc.device)
        p0, p1 = junc[:, pairs[:, 0]], junc[:, pairs[:, 1]]
        pvalid = jvalid[:, pairs[:, 0]] & jvalid[:, pairs[:, 1]]
        pvalid = pvalid & (torch.linalg.vector_norm(p1 - p0, dim=-1)
                           >= float(conf["min_length"]))
        t = torch.linspace(0.0, 1.0, int(conf["num_samples"]), dtype=junc.dtype,
                           device=junc.device)[None, None, :, None]
        pts = p0[:, :, None] + (p1 - p0)[:, :, None] * t  # (B, C, S, 2)
        hgt, wdt = heat.shape[1:3]
        xi = pts[..., 0].round().to(torch.int32).clamp(0, wdt - 1)
        yi = pts[..., 1].round().to(torch.int32).clamp(0, hgt - 1)
        vals = heat.reshape(b, hgt * wdt).gather(
            1, (yi * wdt + xi).reshape(b, -1).long()).reshape(pts.shape[:3])
        inlier = (vals > float(conf["heatmap_threshold"])).float().mean(-1)
        mean_sc = vals.mean(-1)
        ok = (pvalid & (inlier >= float(conf["inlier_ratio"]))
              & (mean_sc >= float(conf["mean_score_threshold"])))
        score = torch.where(ok, mean_sc * inlier, 0.0)
        n_lines = int(conf["max_num_lines"])
        top, idx = torch.sort(score, dim=-1, descending=True, stable=True)
        top, idx = top[:, :n_lines], idx[:, :n_lines]
        lines = torch.stack([p0.gather(1, idx[..., None].expand(-1, -1, 2)),
                             p1.gather(1, idx[..., None].expand(-1, -1, 2))], dim=2)
        lvalid = top > 0.0
        return {"lines": torch.where(lvalid[..., None, None], lines, 0.0),
                "line_scores": torch.where(lvalid, top, 0.0), "valid_lines": lvalid,
                "junctions": junc, "junction_scores": jsc, "junction_valid": jvalid}

    def _forward(self, data: dict) -> dict:
        junc_map, junc_logits, heat, desc = self._heads(data["image"])
        pred = {"junction_map": junc_map, "junction_logits": junc_logits,
                "line_heatmap": heat, "descriptors_dense": desc}
        if self.conf["sparse_outputs"]:
            pred.update(self._extract_lines(junc_map, heat, data.get("image_size")))
        return pred

    def loss(self, pred: dict, data: dict):
        raise NotImplementedError(self.unported_note)


__main_model__ = SOLD2
