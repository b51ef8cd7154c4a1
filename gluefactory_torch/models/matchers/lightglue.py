"""LightGlue attention matcher (gluefactory_tpu/models/matchers/lightglue.py)
with a fixed depth, and its deep-supervision training loss.

Parameter names and the Wqkv layout follow the official PyTorch LightGlue
(Wqkv unflattens as (heads, head_dim, 3)); the numerics follow the JAX
package, whose weights these are: LayerNorm eps 1e-6 and the tanh GELU.
Self-attention goes through kernel K1 (rotary fused) and cross-attention
through kernel K2 (``ops/attention``) unless ``attention='xla'`` asks for
the plain versions. Every dense layer starts as flax initialises it
(models/utils/init.py).

Adaptive inference (``depth_confidence``/``width_confidence`` > 0, the
JAX package's ``_adaptive_layer``): after each layer but the last the
token-confidence head of that layer scores every token. Width pruning masks
the tokens that are confident and unmatchable out of the later layers'
key/value sets (shapes stay fixed; the tokens are not compacted). Depth
pruning stops once the share of confident tokens exceeds
``depth_confidence`` for every pair of the batch: JAX's batch-wide
``lax.cond`` is a Python branch here on a flag read from the device, one
host read after each layer but the last. The exit layer's assignment head
scores the matches, with the original validity masks; ``exit_layer`` and,
with width pruning, the ``prune0``/``prune1`` counters are returned.

``dtype: bf16`` runs the transformer in bfloat16 with float32 parameters,
rounding where flax does (not where ``torch.autocast`` would): each dense
layer casts its input and weight to bf16, rounds the product to bf16 and
adds the bias in bf16; LayerNorm computes in float32 and returns bf16; the
tanh GELU runs op by op in bf16 (``GELU``) and the residual stream is bf16;
descriptors and the rotary cos/sin are cast to bf16 before layer 0, and back
to float32 after the last layer, before the assignment head, as are
``desc_layers*``. The attention kernels (and their plain versions) compute
in float32 from the bf16 inputs and round their output once, as the JAX
package's Pallas kernels do; k arrives rotated in bf16, op by op, as JAX's
``apply_rotary`` rounds it."""

from __future__ import annotations

import math
from typing import ClassVar

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ...ops.assignment import filter_matches, sigmoid_log_double_softmax
from ...ops.attention import attention, self_attention_rotary
from ..base_model import BaseModel
from ..utils.init import flax_reset_
from ..utils.losses import nll_loss_no_bins
from ..utils.metrics import matcher_metrics


def normalize_keypoints(kpts: torch.Tensor, size: torch.Tensor) -> torch.Tensor:
    """Center and scale keypoints (B, N, 2) by the image extent (B, 2)."""
    size = size[..., None, :]
    scale = size.amax(dim=-1, keepdim=True) / 2.0
    return (kpts - size / 2.0) / (scale + 1e-8)


COMPUTE_DTYPES = {"float32": torch.float32, "bf16": torch.bfloat16}


class Dense(nn.Linear):
    """flax's ``nn.Dense(dtype=...)``: in bf16 the input and the float32
    weight are cast to bf16, the product is rounded to bf16 and the bias is
    added in bf16."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def reset_parameters(self) -> None:
        flax_reset_(self)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.compute_dtype == torch.float32:
            return super().forward(x)
        y = F.linear(x.to(self.compute_dtype), self.weight.to(self.compute_dtype))
        return y if self.bias is None else y + self.bias.to(self.compute_dtype)


class LayerNorm(nn.LayerNorm):
    """flax's ``nn.LayerNorm(dtype=...)``: statistics and normalisation in
    float32, the result in the compute dtype."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__(dim, eps=1e-6)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.float()).to(self.compute_dtype)


class GELU(nn.Module):
    """flax's ``nn.gelu``, the tanh form. On a bf16 array JAX runs its
    operations one by one, each rounded to bf16, with its constants rounded to
    bf16; so does this (torch's own bf16 GELU rounds once, which lands on
    another bf16 value for ~40% of inputs)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == torch.float32:
            return F.gelu(x, approximate="tanh")
        c, k = x.new_tensor(math.sqrt(2 / math.pi)), x.new_tensor(0.044715)
        return x * (0.5 * (1.0 + torch.tanh(c * (x + k * (x * x * x)))))


def _ffn(dim: int, dtype: torch.dtype) -> nn.Sequential:
    return nn.Sequential(Dense(2 * dim, 2 * dim, dtype=dtype), LayerNorm(2 * dim, dtype),
                         GELU(), Dense(2 * dim, dim, dtype=dtype))


class LearnableFourierPositionalEncoding(nn.Module):
    """Rotary frequencies from 2D positions: (cos, sin), each (B, N, head_dim)."""

    def __init__(self, in_dim: int, head_dim: int):
        super().__init__()
        self.Wr = Dense(in_dim, head_dim // 2, bias=False)

    def forward(self, kpts: torch.Tensor):
        proj = self.Wr(kpts)
        return (torch.cos(proj).repeat_interleave(2, dim=-1),
                torch.sin(proj).repeat_interleave(2, dim=-1))


class SelfBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, attn_impl: str, dtype: torch.dtype):
        super().__init__()
        self.num_heads, self.attn_impl = num_heads, attn_impl
        self.Wqkv = Dense(dim, 3 * dim, dtype=dtype)
        self.out_proj = Dense(dim, dim, dtype=dtype)
        self.ffn = _ffn(dim, dtype)

    def forward(self, x, rot, mask=None):
        b, n, d = x.shape
        qkv = self.Wqkv(x).unflatten(-1, (self.num_heads, -1, 3)).transpose(1, 2)
        q, k, v = qkv[..., 0], qkv[..., 1], qkv[..., 2]
        msg = self_attention_rotary(q, k, v, *rot, kv_mask=mask,
                                    implementation=self.attn_impl)
        msg = self.out_proj(msg.transpose(1, 2).reshape(b, n, d))
        return x + self.ffn(torch.cat([x, msg], dim=-1))


class CrossBlock(nn.Module):
    """Bidirectional cross-attention through one shared q/k projection."""

    def __init__(self, dim: int, num_heads: int, attn_impl: str, dtype: torch.dtype):
        super().__init__()
        self.num_heads, self.attn_impl = num_heads, attn_impl
        self.to_qk = Dense(dim, dim, dtype=dtype)
        self.to_v = Dense(dim, dim, dtype=dtype)
        self.to_out = Dense(dim, dim, dtype=dtype)
        self.ffn = _ffn(dim, dtype)

    def forward(self, x0, x1, mask0=None, mask1=None):
        b, _, d = x0.shape

        def heads(t):
            return t.unflatten(-1, (self.num_heads, -1)).transpose(1, 2)

        def merge(t):
            return t.transpose(1, 2).reshape(b, -1, d)

        qk0, qk1 = heads(self.to_qk(x0)), heads(self.to_qk(x1))
        v0, v1 = heads(self.to_v(x0)), heads(self.to_v(x1))
        m0 = attention(qk0, qk1, v1, kv_mask=mask1, implementation=self.attn_impl)
        m1 = attention(qk1, qk0, v0, kv_mask=mask0, implementation=self.attn_impl)
        m0, m1 = self.to_out(merge(m0)), self.to_out(merge(m1))
        return (x0 + self.ffn(torch.cat([x0, m0], dim=-1)),
                x1 + self.ffn(torch.cat([x1, m1], dim=-1)))


class TransformerLayer(nn.Module):
    def __init__(self, dim: int, num_heads: int, attn_impl: str, dtype: torch.dtype):
        super().__init__()
        self.self_attn = SelfBlock(dim, num_heads, attn_impl, dtype)
        self.cross_attn = CrossBlock(dim, num_heads, attn_impl, dtype)

    def forward(self, desc0, desc1, rot0, rot1, mask0=None, mask1=None):
        desc0 = self.self_attn(desc0, rot0, mask0)
        desc1 = self.self_attn(desc1, rot1, mask1)
        return self.cross_attn(desc0, desc1, mask0, mask1)


class MatchAssignment(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim
        self.final_proj = Dense(dim, dim)
        self.matchability = Dense(dim, 1)

    def forward(self, desc0, desc1, mask0=None, mask1=None):
        mdesc0 = self.final_proj(desc0) / self.dim**0.25
        mdesc1 = self.final_proj(desc1) / self.dim**0.25
        sim = torch.einsum("bnd,bmd->bnm", mdesc0, mdesc1)
        z0 = self.matchability(desc0)[..., 0]
        z1 = self.matchability(desc1)[..., 0]
        return sigmoid_log_double_softmax(sim, z0, z1, mask0, mask1), z0, z1

    def get_matchability(self, desc: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(self.matchability(desc)[..., 0])


class TokenConfidence(nn.Module):
    """Per-layer confidence that a token's assignment is final; trained by the
    loss, read by adaptive depth and width."""

    def __init__(self, dim: int):
        super().__init__()
        self.token = nn.Sequential(Dense(dim, 1), nn.Sigmoid())

    def forward(self, desc0, desc1):
        return self.token(desc0)[..., 0], self.token(desc1)[..., 0]


def confidence_targets(scores: torch.Tensor, final_scores: torch.Tensor):
    """The targets of the token-confidence loss of one layer: whether each
    token's best match (argmax of its row, side 0, or column, side 1) under
    the layer's assignment ``scores`` is the one under the final layer's.
    Returns two bool tensors, (B, M) and (B, N). A near-tie in either
    argmax flips a target under any change in the last bits."""
    return (scores.argmax(dim=2) == final_scores.argmax(dim=2),
            scores.argmax(dim=1) == final_scores.argmax(dim=1))


class LightGlue(BaseModel):
    default_conf: ClassVar[dict] = {
        "input_dim": 256,
        "descriptor_dim": 256,
        "add_scale_ori": False,
        "n_layers": 9,
        "num_heads": 4,
        "flash": True,
        "attention": None,  # 'xla' = plain PyTorch; 'auto'/'pallas' = kernels
        "filter_threshold": 0.1,
        "depth_confidence": -1,
        "width_confidence": -1,
        "checkpointed": True,  # recompute each layer in the backward pass
        "save_layer_outputs": True,  # per-layer descriptors for the loss
        "dtype": "float32",  # 'bf16' runs the transformer in bfloat16
        "weights": None,
        "loss": {
            "gamma": 1.0,  # weight gamma^(L-1-i) of layer i's NLL
            "fn": "nll",
            "nll_balancing": 0.5,
        },
    }
    # the weights come from utils/weights.py, not from a conf key
    unported_conf: ClassVar[frozenset] = frozenset({"weights", "loss.fn", "loss.nll_balancing"})
    required_data_keys: ClassVar[list] = [
        "keypoints0", "keypoints1", "descriptors0", "descriptors1"]

    def __init__(self, conf: dict | None = None):
        super().__init__(conf)
        conf = self.conf
        if conf["dtype"] not in COMPUTE_DTYPES:
            raise NotImplementedError(f"LightGlue does not implement dtype={conf['dtype']!r} "
                                      f"(ported: {sorted(COMPUTE_DTYPES)})")
        self.compute_dtype = COMPUTE_DTYPES[conf["dtype"]]
        d, h, n = conf["descriptor_dim"], conf["num_heads"], conf["n_layers"]
        attn_impl = conf["attention"] or ("auto" if conf["flash"] else "xla")
        self.input_proj = Dense(conf["input_dim"], d)
        self.posenc = LearnableFourierPositionalEncoding(4 if conf["add_scale_ori"] else 2, d // h)
        self.transformers = nn.ModuleList(
            TransformerLayer(d, h, attn_impl, self.compute_dtype) for _ in range(n))
        self.log_assignment = nn.ModuleList(MatchAssignment(d) for _ in range(n))
        self.token_confidence = nn.ModuleList(TokenConfidence(d) for _ in range(n - 1))

    def _forward(self, data: dict) -> dict:
        mask0 = data.get("keypoint_valid0")
        mask1 = data.get("keypoint_valid1")
        size0 = data.get("view0", {}).get("image_size", data.get("image_size0"))
        size1 = data.get("view1", {}).get("image_size", data.get("image_size1"))
        desc0 = self.input_proj(data["descriptors0"])
        desc1 = self.input_proj(data["descriptors1"])
        rot0 = self.posenc(self._positions(data, "0", size0))
        rot1 = self.posenc(self._positions(data, "1", size1))
        cdt = self.compute_dtype
        desc0, desc1 = desc0.to(cdt), desc1.to(cdt)
        rot0, rot1 = tuple(r.to(cdt) for r in rot0), tuple(r.to(cdt) for r in rot1)
        if self.conf["depth_confidence"] > 0 or self.conf["width_confidence"] > 0:
            pred = self._adaptive(desc0, desc1, rot0, rot1, mask0, mask1)
        else:
            pred = self._fixed_depth(desc0, desc1, rot0, rot1, mask0, mask1)
        # invalid slots are unmatched by construction
        if mask0 is not None:
            pred["matches0"] = pred["matches0"].masked_fill(~mask0, -1)
        if mask1 is not None:
            pred["matches1"] = pred["matches1"].masked_fill(~mask1, -1)
        return pred

    def _positions(self, data: dict, i: str, size: torch.Tensor) -> torch.Tensor:
        """The posenc input of view ``i``: normalised keypoints and, with
        ``add_scale_ori``, the keypoints' scales and orientations, zeros
        where the data carry none (the cached engine's batches)."""
        kpts = normalize_keypoints(data[f"keypoints{i}"], size)
        if not self.conf["add_scale_ori"]:
            return kpts
        zeros = kpts.new_zeros(kpts.shape[:-1])
        extra = [data.get(f"{k}{i}") for k in ("scales", "oris")]
        return torch.cat([kpts, *(zeros[..., None] if e is None else e[..., None]
                                  for e in extra)], dim=-1)

    def _run_layer(self, i: int, desc0, desc1, rot0, rot1, mask0, mask1):
        layer = self.transformers[i]
        if self.conf["checkpointed"] and torch.is_grad_enabled():
            return checkpoint(layer, desc0, desc1, rot0, rot1, mask0, mask1,
                              use_reentrant=False)
        return layer(desc0, desc1, rot0, rot1, mask0, mask1)

    def _head(self, i: int, desc0, desc1, mask0, mask1) -> dict:
        """Layer ``i``'s assignment head on float32 descriptors: the
        log-assignment, the filtered matches and the matchabilities."""
        scores, z0, z1 = self.log_assignment[i](desc0, desc1, mask0, mask1)
        return {"log_assignment": scores,
                **filter_matches(scores, self.conf["filter_threshold"]),
                "matchability0": torch.sigmoid(z0),
                "matchability1": torch.sigmoid(z1)}

    def _fixed_depth(self, desc0, desc1, rot0, rot1, mask0, mask1) -> dict:
        layers0, layers1 = [], []
        for i in range(self.conf["n_layers"]):
            desc0, desc1 = self._run_layer(i, desc0, desc1, rot0, rot1, mask0, mask1)
            layers0.append(desc0)
            layers1.append(desc1)
        pred = self._head(-1, desc0.float(), desc1.float(), mask0, mask1)
        if self.conf["save_layer_outputs"]:
            pred["desc_layers0"] = torch.stack(layers0).float()
            pred["desc_layers1"] = torch.stack(layers1).float()
        return pred

    def confidence_threshold(self, layer_index: int) -> float:
        """The early-exit threshold of a layer, 0.8 + 0.1 exp(-4 i / L),
        computed in float32 as the JAX package does (on the host, so that
        the card and the CPU compare against the same value)."""
        x = torch.tensor(-4.0 * layer_index / self.conf["n_layers"], dtype=torch.float32)
        return float((0.8 + 0.1 * torch.exp(x)).clamp(0.0, 1.0))

    def _adaptive(self, desc0, desc1, rot0, rot1, mask0, mask1) -> dict:
        """Adaptive depth and width (see the module's docstring)."""
        conf = self.conf
        n_layers = conf["n_layers"]
        b, n0, n1 = desc0.shape[0], desc0.shape[1], desc1.shape[1]
        act0 = mask0 if mask0 is not None else desc0.new_ones((b, n0), dtype=torch.bool)
        act1 = mask1 if mask1 is not None else desc1.new_ones((b, n1), dtype=torch.bool)
        prune0 = torch.ones((b, n0), dtype=torch.int32, device=desc0.device)
        prune1 = torch.ones((b, n1), dtype=torch.int32, device=desc1.device)
        for i in range(n_layers):
            desc0, desc1 = self._run_layer(i, desc0, desc1, rot0, rot1, act0, act1)
            f0, f1 = desc0.float(), desc1.float()
            done = i == n_layers - 1
            if not done:
                c0, c1 = self.token_confidence[i](f0, f1)
                th = self.confidence_threshold(i)
                if conf["depth_confidence"] > 0:
                    confident = torch.cat([torch.where(act0, c0 > th, True),
                                           torch.where(act1, c1 > th, True)], dim=1)
                    ratio = confident.float().mean(dim=1)
                    exit_now = (ratio > conf["depth_confidence"]).all()
                if conf["width_confidence"] > 0:
                    keep = 1.0 - conf["width_confidence"]
                    drop0 = (c0 > th) & (self.log_assignment[i].get_matchability(f0) < keep)
                    drop1 = (c1 > th) & (self.log_assignment[i].get_matchability(f1) < keep)
                    act0, act1 = act0 & ~drop0, act1 & ~drop1
                    prune0 = prune0 + (~drop0).int()
                    prune1 = prune1 + (~drop1).int()
                done = conf["depth_confidence"] > 0 and bool(exit_now)  # the host read
            if done:
                break
        pred = self._head(i, f0, f1, mask0, mask1)
        # a fill, not a copy from the host (which would wait for the device)
        pred["exit_layer"] = torch.full((), i, dtype=torch.int32, device=desc0.device)
        if conf["width_confidence"] > 0:
            pred.update(prune0=prune0, prune1=prune1)
        return pred

    def loss(self, pred: dict, data: dict):
        """Deep supervision: the NLL of every layer's assignment head, weighted
        by gamma^(L-1-i) and averaged, plus the token-confidence BCE on
        detached descriptors (target: the layer's argmax agrees with the
        final one's). Returns (losses, metrics), (B,) each."""
        gt_m0, gt_m1 = data["gt_matches0"], data["gt_matches1"]
        mask0, mask1 = data.get("keypoint_valid0"), data.get("keypoint_valid1")
        n_layers, gamma = self.conf["n_layers"], self.conf["loss"]["gamma"]
        final_scores = pred["log_assignment"]
        losses = {}
        total, sum_weight = 0.0, 0.0
        conf_loss = torch.zeros(gt_m0.shape[0], device=gt_m0.device)
        for i in range(n_layers):
            desc0, desc1 = pred["desc_layers0"][i], pred["desc_layers1"][i]
            scores, z0, z1 = self.log_assignment[i](desc0, desc1, mask0, mask1)
            nll, nll_pos, nll_neg = nll_loss_no_bins(
                torch.where(torch.isfinite(scores), scores, -1e9), z0, z1, gt_m0, gt_m1)
            weight = 1.0 if i == n_layers - 1 else gamma ** (n_layers - 1 - i)
            total = total + weight * nll
            sum_weight += weight
            if i == n_layers - 1:
                losses.update(nll_pos=nll_pos, nll_neg=nll_neg, assignment_nll=nll)
                continue
            c0, c1 = self.token_confidence[i](desc0.detach(), desc1.detach())
            correct0, correct1 = (t.float() for t in confidence_targets(scores, final_scores))
            for c, correct, mask in ((c0, correct0, mask0), (c1, correct1, mask1)):
                bce = -(correct * torch.log(c + 1e-8)
                        + (1 - correct) * torch.log(1 - c + 1e-8))
                if mask is None:
                    conf_loss = conf_loss + bce.sum(-1) / bce.shape[-1]
                else:
                    conf_loss = conf_loss + (torch.where(mask, bce, 0.0).sum(-1)
                                             / mask.sum(-1).clamp_min(1))
        losses["confidence"] = conf_loss / max(n_layers - 1, 1)
        losses["total"] = total / sum_weight + losses["confidence"]
        return losses, matcher_metrics(pred, data)

    @torch.no_grad()
    def layer_confidence_targets(self, pred: dict, data: dict) -> list[torch.Tensor]:
        """The token-confidence targets that ``loss`` reads, for every layer
        but the last and both sides (a list of (B, N) bool, False on invalid
        keypoints): [layer 0 side 0, layer 0 side 1, layer 1 side 0, ...]."""
        mask0, mask1 = data.get("keypoint_valid0"), data.get("keypoint_valid1")
        out = []
        for i in range(self.conf["n_layers"] - 1):
            scores = self.log_assignment[i](pred["desc_layers0"][i], pred["desc_layers1"][i],
                                            mask0, mask1)[0]
            for target, mask in zip(confidence_targets(scores, pred["log_assignment"]),
                                    (mask0, mask1)):
                out.append(target if mask is None else target & mask)
        return out


def head_counts(model: torch.nn.Module) -> dict[str, int]:
    """The head count of each LightGlue inside ``model``, by module name (what
    utils/weights needs to order Wqkv's rows)."""
    return {name: m.conf["num_heads"] for name, m in model.named_modules()
            if isinstance(m, LightGlue)}


__main_model__ = LightGlue
