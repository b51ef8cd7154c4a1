"""LightGlue attention matcher (gluefactory_tpu/models/matchers/lightglue.py)
with a fixed depth, and its deep-supervision training loss.

Parameter names and the Wqkv layout follow the official PyTorch LightGlue
(Wqkv unflattens as (heads, head_dim, 3)); the numerics follow the JAX
package, whose weights these are: LayerNorm eps 1e-6 and the tanh GELU.
Self-attention goes through kernel K1 (rotary fused) and cross-attention
through kernel K2 (``ops/attention``) unless ``attention='xla'`` asks for
the plain versions. Adaptive depth and width are not ported yet."""

from __future__ import annotations

from typing import ClassVar

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ...ops.assignment import filter_matches, sigmoid_log_double_softmax
from ...ops.attention import attention, self_attention_rotary
from ..base_model import BaseModel
from ..utils.losses import nll_loss_no_bins
from ..utils.metrics import matcher_metrics


def normalize_keypoints(kpts: torch.Tensor, size: torch.Tensor) -> torch.Tensor:
    """Center and scale keypoints (B, N, 2) by the image extent (B, 2)."""
    size = size[..., None, :]
    scale = size.amax(dim=-1, keepdim=True) / 2.0
    return (kpts - size / 2.0) / (scale + 1e-8)


def _ffn(dim: int) -> nn.Sequential:
    return nn.Sequential(nn.Linear(2 * dim, 2 * dim), nn.LayerNorm(2 * dim, eps=1e-6),
                         nn.GELU(approximate="tanh"), nn.Linear(2 * dim, dim))


class LearnableFourierPositionalEncoding(nn.Module):
    """Rotary frequencies from 2D positions: (cos, sin), each (B, N, head_dim)."""

    def __init__(self, in_dim: int, head_dim: int):
        super().__init__()
        self.Wr = nn.Linear(in_dim, head_dim // 2, bias=False)

    def forward(self, kpts: torch.Tensor):
        proj = self.Wr(kpts)
        return (torch.cos(proj).repeat_interleave(2, dim=-1),
                torch.sin(proj).repeat_interleave(2, dim=-1))


class SelfBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, attn_impl: str):
        super().__init__()
        self.num_heads, self.attn_impl = num_heads, attn_impl
        self.Wqkv = nn.Linear(dim, 3 * dim)
        self.out_proj = nn.Linear(dim, dim)
        self.ffn = _ffn(dim)

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

    def __init__(self, dim: int, num_heads: int, attn_impl: str):
        super().__init__()
        self.num_heads, self.attn_impl = num_heads, attn_impl
        self.to_qk = nn.Linear(dim, dim)
        self.to_v = nn.Linear(dim, dim)
        self.to_out = nn.Linear(dim, dim)
        self.ffn = _ffn(dim)

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
    def __init__(self, dim: int, num_heads: int, attn_impl: str):
        super().__init__()
        self.self_attn = SelfBlock(dim, num_heads, attn_impl)
        self.cross_attn = CrossBlock(dim, num_heads, attn_impl)

    def forward(self, desc0, desc1, rot0, rot1, mask0=None, mask1=None):
        desc0 = self.self_attn(desc0, rot0, mask0)
        desc1 = self.self_attn(desc1, rot1, mask1)
        return self.cross_attn(desc0, desc1, mask0, mask1)


class MatchAssignment(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim
        self.final_proj = nn.Linear(dim, dim)
        self.matchability = nn.Linear(dim, 1)

    def forward(self, desc0, desc1, mask0=None, mask1=None):
        mdesc0 = self.final_proj(desc0) / self.dim**0.25
        mdesc1 = self.final_proj(desc1) / self.dim**0.25
        sim = torch.einsum("bnd,bmd->bnm", mdesc0, mdesc1)
        z0 = self.matchability(desc0)[..., 0]
        z1 = self.matchability(desc1)[..., 0]
        return sigmoid_log_double_softmax(sim, z0, z1, mask0, mask1), z0, z1


class TokenConfidence(nn.Module):
    """Per-layer confidence that a token's assignment is final; trained by the
    loss, read by adaptive depth (not ported yet)."""

    def __init__(self, dim: int):
        super().__init__()
        self.token = nn.Sequential(nn.Linear(dim, 1), nn.Sigmoid())

    def forward(self, desc0, desc1):
        return self.token(desc0)[..., 0], self.token(desc1)[..., 0]


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
        "dtype": "float32",
        "weights": None,
        "loss": {
            "gamma": 1.0,  # weight gamma^(L-1-i) of layer i's NLL
            "fn": "nll",
            "nll_balancing": 0.5,
        },
    }
    # float32 is what is ported (bf16: ROADMAP queue 1, item 2); the weights
    # come from utils/weights.py, not from a conf key
    unported_conf: ClassVar[frozenset] = frozenset({
        "dtype", "weights", "loss.fn", "loss.nll_balancing"})
    required_data_keys: ClassVar[list] = [
        "keypoints0", "keypoints1", "descriptors0", "descriptors1"]

    def __init__(self, conf: dict | None = None):
        super().__init__(conf)
        conf = self.conf
        if conf["add_scale_ori"]:
            raise NotImplementedError("add_scale_ori is not ported")
        if conf["depth_confidence"] > 0 or conf["width_confidence"] > 0:
            raise NotImplementedError("adaptive depth and width are not ported")
        d, h, n = conf["descriptor_dim"], conf["num_heads"], conf["n_layers"]
        attn_impl = conf["attention"] or ("auto" if conf["flash"] else "xla")
        self.input_proj = nn.Linear(conf["input_dim"], d)
        self.posenc = LearnableFourierPositionalEncoding(2, d // h)
        self.transformers = nn.ModuleList(
            TransformerLayer(d, h, attn_impl) for _ in range(n))
        self.log_assignment = nn.ModuleList(MatchAssignment(d) for _ in range(n))
        self.token_confidence = nn.ModuleList(TokenConfidence(d) for _ in range(n - 1))

    def _forward(self, data: dict) -> dict:
        mask0 = data.get("keypoint_valid0")
        mask1 = data.get("keypoint_valid1")
        size0 = data.get("view0", {}).get("image_size", data.get("image_size0"))
        size1 = data.get("view1", {}).get("image_size", data.get("image_size1"))
        desc0 = self.input_proj(data["descriptors0"])
        desc1 = self.input_proj(data["descriptors1"])
        rot0 = self.posenc(normalize_keypoints(data["keypoints0"], size0))
        rot1 = self.posenc(normalize_keypoints(data["keypoints1"], size1))
        layers0, layers1 = [], []
        for layer in self.transformers:
            if self.conf["checkpointed"] and torch.is_grad_enabled():
                desc0, desc1 = checkpoint(layer, desc0, desc1, rot0, rot1, mask0, mask1,
                                          use_reentrant=False)
            else:
                desc0, desc1 = layer(desc0, desc1, rot0, rot1, mask0, mask1)
            layers0.append(desc0)
            layers1.append(desc1)
        scores, z0, z1 = self.log_assignment[-1](desc0, desc1, mask0, mask1)
        pred = {"log_assignment": scores,
                **filter_matches(scores, self.conf["filter_threshold"]),
                "matchability0": torch.sigmoid(z0),
                "matchability1": torch.sigmoid(z1)}
        if self.conf["save_layer_outputs"]:
            pred["desc_layers0"] = torch.stack(layers0)
            pred["desc_layers1"] = torch.stack(layers1)
        # invalid slots are unmatched by construction
        if mask0 is not None:
            pred["matches0"] = pred["matches0"].masked_fill(~mask0, -1)
        if mask1 is not None:
            pred["matches1"] = pred["matches1"].masked_fill(~mask1, -1)
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
            correct0 = (scores.argmax(dim=2) == final_scores.argmax(dim=2)).float()
            correct1 = (scores.argmax(dim=1) == final_scores.argmax(dim=1)).float()
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


__main_model__ = LightGlue
