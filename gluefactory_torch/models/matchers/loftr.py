"""LoFTR, the detector-free semi-dense matcher
(gluefactory_tpu/models/matchers/loftr.py), and its training loss.

Each view's grey image goes through a ResNet-FPN (the official 8-2 layout: a
7x7 stride-2 stem, residual stages at 1/2, 1/4 and 1/8 with GroupNorm, a
top-down path with bilinear upsampling) to coarse features at 1/8 and fine
features at 1/2. The coarse features plus a 2-D sine encoding go through
interleaved self and cross layers of linear (elu + 1) attention; a
dual-softmax at temperature 0.1 scores every pair of coarse cells, and the
mutual maxima above ``match_threshold`` fill ``max_matches`` static slots
(highest first; ties by the lower flat index, as ``lax.top_k``; the rest
invalid), at the cell centres ``8 i + 4``. Around each match a 5 x 5 window
of fine features is gathered in each view, passed through the window
transformer, and view 1's keypoint moves by the softargmax of the
L2-normalised correlation of view 0's centre with view 1's window.

Matched pairs come out as ``keypoints0/1`` with identity ``matches0/1``,
``keypoint_valid0/1`` masks and the dual-softmax score, plus the coarse
confidence matrix for the loss: a focal loss on the confidence at each
view-0 cell's ground-truth cell in view 1 (the homography ``H_0to1``) and
the L2 of the refined keypoints against the warp of view 0's, over the
matches within 8 pixels.

Layers are flax's: GroupNorm and LayerNorm with epsilon 1e-6, the GroupNorm
over ``gcd(8, C)`` groups (4 at the width 196), convolutions with explicit
padding, every layer initialised as flax does. Parameters are named as the
JAX package's (``backbone.l2a.nproj.scale``, ``cself0.attn.q.weight``), so
the blobs load through ``utils.weights``. Views of equal size share each
backbone, transformer and window-transformer call (one batch of both)."""

from __future__ import annotations

import contextlib
import math
from typing import ClassVar

import torch
import torch.nn.functional as F
from torch import nn

from ...geometry.homography import warp_points
from ..base_model import BaseModel
from ..lines.sold2 import GroupNorm
from ..utils.init import flax_reset_
from .lightglue import Dense, LayerNorm

GRAY = (0.299, 0.587, 0.114)


class Conv(nn.Conv2d):
    """flax's ``nn.Conv`` with padding ``k // 2`` on each side (the JAX
    model's explicit padding, and 'SAME' for its 1 x 1 kernels), NCHW."""

    def __init__(self, c_in: int, c_out: int, kernel_size: int, stride: int = 1,
                 bias: bool = True):
        super().__init__(c_in, c_out, kernel_size, stride=stride, padding=kernel_size // 2,
                         bias=bias)

    def reset_parameters(self) -> None:
        flax_reset_(self)


def _gn(channels: int) -> GroupNorm:
    """GroupNorm over the largest group count <= 8 that divides ``channels``."""
    return GroupNorm(channels, num_groups=math.gcd(8, channels))


class ResBlock(nn.Module):
    def __init__(self, c_in: int, features: int, stride: int = 1):
        super().__init__()
        self.c1 = Conv(c_in, features, 3, stride, bias=False)
        self.n1 = _gn(features)
        self.c2 = Conv(features, features, 3, bias=False)
        self.n2 = _gn(features)
        if stride != 1 or c_in != features:
            self.proj = Conv(c_in, features, 1, stride, bias=False)
            self.nproj = _gn(features)
        else:
            self.proj = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.n2(self.c2(F.relu(self.n1(self.c1(x)))))
        if self.proj is not None:
            x = self.nproj(self.proj(x))
        return F.relu(x + y)


def _upsample(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``jax.image.resize(..., 'bilinear')`` of ``x`` to ``like``'s size: an
    upsampling (or identity), half-pixel centres."""
    return F.interpolate(x, size=like.shape[-2:], mode="bilinear", align_corners=False)


class ResNetFPN(nn.Module):
    """Features at 1/8 (coarse, ``block_dims[2]`` channels) and 1/2 (fine,
    ``fine_dim``) of a (B, 1, H, W) image."""

    def __init__(self, initial_dim: int, block_dims, fine_dim: int):
        super().__init__()
        d1, d2, d3 = block_dims
        self.stem = Conv(1, initial_dim, 7, 2, bias=False)
        self.stem_n = _gn(initial_dim)
        self.l1a, self.l1b = ResBlock(initial_dim, d1), ResBlock(d1, d1)
        self.l2a, self.l2b = ResBlock(d1, d2, 2), ResBlock(d2, d2)
        self.l3a, self.l3b = ResBlock(d2, d3, 2), ResBlock(d3, d3)
        self.p3 = Conv(d3, d3, 1)
        self.p2 = Conv(d2, d3, 1)
        self.p2s = Conv(d3, d2, 3)
        self.p1 = Conv(d1, d2, 1)
        self.p1s = Conv(d2, fine_dim, 3)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        x = F.relu(self.stem_n(self.stem(x)))
        c1 = self.l1b(self.l1a(x))
        c2 = self.l2b(self.l2a(c1))
        c3 = self.l3b(self.l3a(c2))
        p3 = self.p3(c3)
        p2 = self.p2s(self.p2(c2) + _upsample(p3, c2))
        p1 = self.p1s(self.p1(c1) + _upsample(p2, c1))
        return p3, p1


def sine_frequencies(q: int, device=None) -> torch.Tensor:
    """The encoding's q frequencies 10000^(-i / (q - 1)), in float32."""
    return torch.exp(torch.arange(q, dtype=torch.float32, device=device)
                     * (-math.log(10000.0) / max(q - 1, 1)))


def sine_pos_encoding(h: int, w: int, dim: int, device=None) -> torch.Tensor:
    """The (h, w, dim) 2-D sine encoding: the channels in 4 groups, sin and
    cos of x then of y."""
    q = dim // 4
    freq = sine_frequencies(q, device)
    ys = (torch.arange(h, dtype=torch.float32, device=device)[:, None, None] * freq).expand(h, w, q)
    xs = (torch.arange(w, dtype=torch.float32, device=device)[None, :, None] * freq).expand(h, w, q)
    return torch.cat([xs.sin(), xs.cos(), ys.sin(), ys.cos()], dim=-1)


class LinearAttention(nn.Module):
    """elu + 1 kernelised attention over contiguous heads."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q, self.k, self.v, self.merge = (Dense(dim, dim) for _ in range(4))

    def forward(self, x: torch.Tensor, source: torch.Tensor) -> torch.Tensor:
        def split(t):
            return t.unflatten(-1, (self.heads, -1))

        q = F.elu(split(self.q(x))) + 1.0
        k = F.elu(split(self.k(source))) + 1.0
        v = split(self.v(source))
        kv = torch.einsum("bshd,bshe->bhde", k, v)
        z = 1.0 / (torch.einsum("blhd,bhd->blh", q, k.sum(1)) + 1e-6)
        out = torch.einsum("blhd,bhde->blhe", q, kv) * z[..., None]
        return self.merge(out.flatten(-2))


class LoFTRLayer(nn.Module):
    """Linear attention, LayerNorm, then an MLP on [x, message], LayerNorm,
    and the residual."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.attn = LinearAttention(dim, heads)
        self.norm1 = LayerNorm(dim)
        self.mlp1 = Dense(2 * dim, 2 * dim)
        self.mlp2 = Dense(2 * dim, dim)
        self.norm2 = LayerNorm(dim)

    def forward(self, x: torch.Tensor, source: torch.Tensor) -> torch.Tensor:
        m = self.norm1(self.attn(x, source))
        m = self.norm2(self.mlp2(F.relu(self.mlp1(torch.cat([x, m], dim=-1)))))
        return x + m


@contextlib.contextmanager
def _cudnn_benchmark():
    """cuDNN's benchmark mode inside, its other settings untouched."""
    before = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    try:
        yield
    finally:
        torch.backends.cudnn.benchmark = before


def _pair(fn, x0: torch.Tensor, x1: torch.Tensor, *args):
    """(fn(x0, *args...), fn(x1, ...)) as one call on both when their shapes
    agree. ``args`` are (for view 0, for view 1) pairs."""
    if x0.shape == x1.shape and all(a.shape == b.shape for a, b in args):
        out = fn(torch.cat([x0, x1]), *(torch.cat([a, b]) for a, b in args))
        if isinstance(out, tuple):
            return tuple(o.chunk(2) for o in out)
        return out.chunk(2)
    out0 = fn(x0, *(a for a, _ in args))
    out1 = fn(x1, *(b for _, b in args))
    if isinstance(out0, tuple):
        return tuple(zip(out0, out1))
    return out0, out1


def _transformer_pairs(self_layers, cross_layers, t0, t1):
    """Interleaved self and cross layers on the two views' tokens."""
    for ls, lc in zip(self_layers, cross_layers):
        t0, t1 = _pair(ls, t0, t1, (t0, t1))
        t0, t1 = _pair(lc, t0, t1, (t1, t0))
    return t0, t1


class LoFTR(BaseModel):
    default_conf: ClassVar[dict] = {
        "initial_dim": 128,
        "block_dims": [128, 196, 256],
        "coarse_dim": 256,
        "fine_dim": 128,
        "coarse_layers": 4,  # self/cross pairs
        "fine_layers": 1,
        "heads": 8,
        "temperature": 0.1,
        "match_threshold": 0.2,
        "max_matches": 1024,  # static top-K slots
        "fine_window": 5,
        "loss": {"focal_alpha": 0.25, "focal_gamma": 2.0, "fine_weight": 1.0},
    }
    required_data_keys: ClassVar[list] = ["view0", "view1"]

    def __init__(self, conf: dict | None = None):
        super().__init__(conf)
        c = self.conf
        dims = [int(d) for d in c["block_dims"]]
        self.backbone = ResNetFPN(int(c["initial_dim"]), dims, int(c["fine_dim"]))
        h = int(c["heads"])
        # the coarse tokens are the backbone's 1/8 features: block_dims[2] wide
        # (as in JAX, where coarse_dim is not read)
        for i in range(int(c["coarse_layers"])):
            self.add_module(f"cself{i}", LoFTRLayer(dims[2], h))
            self.add_module(f"ccross{i}", LoFTRLayer(dims[2], h))
        for i in range(int(c["fine_layers"])):
            self.add_module(f"fself{i}", LoFTRLayer(int(c["fine_dim"]), h))
            self.add_module(f"fcross{i}", LoFTRLayer(int(c["fine_dim"]), h))
        self.fine_proj = Dense(int(c["fine_dim"]), int(c["fine_dim"]))
        r = int(c["fine_window"]) // 2
        dy, dx = torch.meshgrid(torch.arange(-r, r + 1), torch.arange(-r, r + 1), indexing="ij")
        # (w * w, (dy, dx)) window offsets, in fine cells
        self.register_buffer("offsets", torch.stack([dy, dx], -1).reshape(-1, 2),
                             persistent=False)

    def _layers(self, kind: str) -> list:
        n = int(self.conf["coarse_layers" if kind == "c" else "fine_layers"])
        return ([getattr(self, f"{kind}self{i}") for i in range(n)],
                [getattr(self, f"{kind}cross{i}") for i in range(n)])

    @staticmethod
    def _gray(img: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) -> (B, 1, H, W)."""
        if img.shape[-1] != 1:
            img = (img[..., :3] @ img.new_tensor(GRAY))[..., None]
        return img.permute(0, 3, 1, 2)

    def _backbone(self, data: dict):
        """(coarse0, fine0), (coarse1, fine1): each view's ResNet-FPN maps,
        NCHW. cuDNN chooses the convolutions by timing them (its benchmark
        mode, once a shape; deterministic ones where deterministic mode is
        on): its heuristic choice under deterministic mode runs the backbone
        of a 480-pixel pair 30 times slower (scripts/trace_loftr.py)."""
        img0 = self._gray(data["view0"]["image"])
        img1 = self._gray(data["view1"]["image"])
        with _cudnn_benchmark():
            (c0, c1), (f0, f1) = _pair(self.backbone, img0, img1)
        return (c0, f0), (c1, f1)

    def _coarse_transformer(self, c0: torch.Tensor, c1: torch.Tensor):
        """The coarse maps plus the sine encoding, through the coarse layers:
        (B, hc * wc, d) tokens of each view, row-major."""
        tokens = []
        for c in (c0, c1):
            b, d, hc, wc = c.shape
            pe = sine_pos_encoding(hc, wc, d, c.device)
            tokens.append((c.permute(0, 2, 3, 1) + pe).reshape(b, hc * wc, d))
        return _transformer_pairs(*self._layers("c"), *tokens)

    def _coarse_features(self, data: dict):
        (c0, f0), (c1, f1) = self._backbone(data)
        t0, t1 = self._coarse_transformer(c0, c1)
        return t0, t1, tuple(c0.shape[-2:]), tuple(c1.shape[-2:]), f0, f1

    def _confidence(self, t0: torch.Tensor, t1: torch.Tensor) -> torch.Tensor:
        """The dual-softmax confidence (B, L, S)."""
        d = t0.shape[-1]
        sim = torch.einsum("bld,bsd->bls", t0 / d ** 0.5, t1 / d ** 0.5) / float(
            self.conf["temperature"])
        return sim.softmax(1) * sim.softmax(2)

    def _select(self, conf: torch.Tensor):
        """The mutual maxima above the threshold in ``max_matches`` slots:
        (score, valid, index in view 0, index in view 1), highest score first,
        ties by the lower flat index (a stable sort), as ``lax.top_k``."""
        b, l, s = conf.shape
        mutual = (conf == conf.amax(2, keepdim=True)) & (conf == conf.amax(1, keepdim=True))
        score = torch.where(mutual & (conf > float(self.conf["match_threshold"])), conf, 0.0)
        top, idx = score.reshape(b, l * s).sort(dim=1, descending=True, stable=True)
        k = int(self.conf["max_matches"])
        top, idx = top[:, :k], idx[:, :k]
        return top, top > 0.0, idx // s, idx % s

    def _fine_refine(self, f0, f1, kp0, kp1, valid):
        """Gather w x w fine windows around each match, run the window
        transformer, correlate view 0's centre with view 1's window and move
        ``kp1`` by the expectation: (kp1 refined where ``valid``, probabilities)."""
        w = int(self.conf["fine_window"])
        b, k = kp0.shape[:2]
        offs = self.offsets

        def gather(fm, kp):
            # pixel-centre coordinates -> cells of this view's stride-2 map
            _, dc, hf, wf = fm.shape
            cell = torch.round((kp - 0.5) / 2.0).long()
            cy = (cell[..., 1, None] + offs[:, 0]).clamp(0, hf - 1)
            cx = (cell[..., 0, None] + offs[:, 1]).clamp(0, wf - 1)
            flat = fm.permute(0, 2, 3, 1).reshape(b, hf * wf, dc)
            idx = (cy * wf + cx).reshape(b, k * w * w, 1).expand(-1, -1, dc)
            return flat.gather(1, idx).reshape(b * k, w * w, dc)

        w0 = self.fine_proj(gather(f0, kp0))
        w1 = self.fine_proj(gather(f1, kp1))
        w0, w1 = _transformer_pairs(*self._layers("f"), w0, w1)
        # the L2-normalised correlation (raw fine features saturate the softmax)
        center = w0[:, (w * w) // 2]
        center = center / torch.linalg.vector_norm(center, dim=-1, keepdim=True).clamp_min(1e-6)
        w1n = w1 / torch.linalg.vector_norm(w1, dim=-1, keepdim=True).clamp_min(1e-6)
        sim = torch.einsum("nd,nsd->ns", center, w1n) / float(self.conf["temperature"])
        prob = sim.softmax(-1)
        exp = prob @ offs.to(prob.dtype)  # (n, (dy, dx)) in fine cells
        delta = (exp.flip(-1) * 2.0).reshape(b, k, 2)  # full-resolution pixels
        return torch.where(valid[..., None], kp1 + delta, kp1), prob

    def _forward(self, data: dict) -> dict:
        t0, t1, (hc0, wc0), (hc1, wc1), f0, f1 = self._coarse_features(data)
        conf = self._confidence(t0, t1)
        top, valid, i0, i1 = self._select(conf)
        kp0 = torch.stack([i0 % wc0, i0 // wc0], -1).float() * 8.0 + 4.0
        kp1 = torch.stack([i1 % wc1, i1 // wc1], -1).float() * 8.0 + 4.0
        kp1, _ = self._fine_refine(f0, f1, kp0, kp1, valid)
        kp0 = torch.where(valid[..., None], kp0, 0.0)
        kp1 = torch.where(valid[..., None], kp1, 0.0)
        ar = torch.arange(top.shape[1], device=top.device).expand_as(top)
        m = torch.where(valid, ar, -1)
        scores = torch.where(valid, top, 0.0)
        return {
            "keypoints0": kp0, "keypoints1": kp1,
            "keypoint_scores0": scores, "keypoint_scores1": scores,
            "keypoint_valid0": valid, "keypoint_valid1": valid,
            "matches0": m, "matches1": m,
            "matching_scores0": scores, "matching_scores1": scores,
            "coarse_confidence": conf,
            "coarse_shapes": torch.tensor([hc0, wc0, hc1, wc1], device=conf.device),
        }

    def loss(self, pred: dict, data: dict) -> tuple[dict, dict]:
        """The focal loss of the coarse confidence at each view-0 cell's
        ground-truth cell (its centre warped by ``H_0to1``, rounded, inside
        view 1) plus ``fine_weight`` times the mean distance / 8 between the
        refined keypoints and the warp of view 0's, over the valid matches
        within 8 pixels."""
        conf = pred["coarse_confidence"]
        b = conf.shape[0]
        h0, w0 = data["view0"]["image"].shape[1:3]
        h1, w1 = data["view1"]["image"].shape[1:3]
        hc0, wc0 = -(-h0 // 8), -(-w0 // 8)
        hc1, wc1 = -(-h1 // 8), -(-w1 // 8)
        H = data["H_0to1"]
        ys, xs = torch.meshgrid(torch.arange(hc0, device=conf.device) * 8.0 + 4.0,
                                torch.arange(wc0, device=conf.device) * 8.0 + 4.0,
                                indexing="ij")
        pts0 = torch.stack([xs.reshape(-1), ys.reshape(-1)], -1)[None].expand(b, -1, -1)
        pts0_w = warp_points(pts0, H)
        c1x = torch.round((pts0_w[..., 0] - 4.0) / 8.0).long()
        c1y = torch.round((pts0_w[..., 1] - 4.0) / 8.0).long()
        inb = (c1x >= 0) & (c1x < wc1) & (c1y >= 0) & (c1y < hc1)
        tgt = c1y.clamp(0, hc1 - 1) * wc1 + c1x.clamp(0, wc1 - 1)

        lc = self.conf["loss"]
        alpha, gamma = float(lc["focal_alpha"]), float(lc["focal_gamma"])
        cc = conf.gather(2, tgt[..., None])[..., 0].clamp(1e-6, 1.0 - 1e-6)
        loss_pos = -alpha * (1.0 - cc) ** gamma * torch.log(cc)
        n_pos = inb.sum(1).float().clamp_min(1.0)
        coarse = torch.where(inb, loss_pos, 0.0).sum(1) / n_pos

        kp0, kp1 = pred["keypoints0"], pred["keypoints1"]
        valid = pred["keypoint_valid0"]
        dist = torch.linalg.vector_norm(kp1 - warp_points(kp0, H), dim=-1)
        inlier = valid & (dist < 8.0)
        nf = inlier.sum(-1).float().clamp_min(1.0)
        fine = torch.where(inlier, dist, 0.0).sum(-1) / nf / 8.0
        total = coarse + float(lc["fine_weight"]) * fine
        return ({"total": total, "coarse_focal": coarse, "fine_l2": fine},
                {"num_matches": valid.sum(-1).float()})

    def metrics(self, pred: dict, data: dict) -> dict:
        return {}


__main_model__ = LoFTR
