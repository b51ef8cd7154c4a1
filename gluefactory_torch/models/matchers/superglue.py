"""SuperGlue (gluefactory_tpu/models/matchers/superglue.py): keypoint
encoder, alternating self- and cross-attention message passing, and the
Sinkhorn assignment with dustbins.

Every attention runs through ``ops.attention.attention``: kernel K2 on the
card unless ``attention: 'xla'`` asks for the plain version, four calls a
layer. Module and parameter names are the flax ones (``gnn_{i}_{self,cross}``
with ``q``/``k``/``v``/``out`` and ``mlp.dense_*``/``norm_*``,
``kenc.encoder``, ``input_proj``, ``final_proj``, ``bin_score``), so
``utils/weights`` loads a committed blob by name. Dense layers start as flax
initialises them and ``bin_score`` at 1. ``torch_weight_converter`` (the
official MagicLeap checkpoints) is not ported. ``loss.nll_balancing`` is
read by neither package: the NLL balances positives and negatives 1:1."""

from __future__ import annotations

from typing import ClassVar

import torch
from torch import nn

from ...ops.assignment import filter_matches, log_optimal_transport
from ...ops.attention import attention
from ..base_model import BaseModel
from ..utils.losses import nll_loss
from ..utils.metrics import matcher_metrics
from .lightglue import Dense, LayerNorm


class MLP(nn.Module):
    """Dense layers ``dense_{i}``, each but the last followed by a LayerNorm
    ``norm_{i}`` (``norm: 'layer'``; none with ``'none'``) and a ReLU."""

    def __init__(self, dims: tuple, norm: str = "layer"):
        super().__init__()
        self.n = len(dims) - 1
        self.norm = norm
        for i in range(self.n):
            setattr(self, f"dense_{i}", Dense(dims[i], dims[i + 1]))
            if i < self.n - 1 and norm == "layer":
                setattr(self, f"norm_{i}", LayerNorm(dims[i + 1]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n):
            x = getattr(self, f"dense_{i}")(x)
            if i < self.n - 1:
                if self.norm == "layer":
                    x = getattr(self, f"norm_{i}")(x)
                x = torch.relu(x)
        return x


class KeypointEncoder(nn.Module):
    """An MLP over (x, y, score), keypoints centred and scaled by 0.7 of the
    image's longer side, added to the visual descriptor."""

    def __init__(self, dim: int, layers: tuple = (32, 64, 128, 256), norm: str = "layer"):
        super().__init__()
        self.encoder = MLP((3, *layers, dim), norm)

    def forward(self, kpts, scores, image_size):
        size = image_size[:, None, :]
        scale = size.amax(dim=-1, keepdim=True) * 0.7
        normed = (kpts - size / 2.0) / (scale + 1e-8)
        return self.encoder(torch.cat([normed, scores[..., None]], dim=-1))


class AttentionalPropagation(nn.Module):
    """Multi-head attention from ``x`` to ``source``, then an MLP on
    [x, message], added to x."""

    def __init__(self, dim: int, num_heads: int, norm: str, attn_impl: str):
        super().__init__()
        self.num_heads, self.attn_impl = num_heads, attn_impl
        self.q, self.k, self.v, self.out = (Dense(dim, dim) for _ in range(4))
        self.mlp = MLP((2 * dim, 2 * dim, dim), norm)

    def forward(self, x, source, source_mask=None):
        b, n, d = x.shape

        def heads(t):
            return t.unflatten(-1, (self.num_heads, -1)).transpose(1, 2)

        msg = attention(heads(self.q(x)), heads(self.k(source)), heads(self.v(source)),
                        kv_mask=source_mask, implementation=self.attn_impl)
        msg = self.out(msg.transpose(1, 2).reshape(b, n, d))
        return x + self.mlp(torch.cat([x, msg], dim=-1))


class SuperGlue(BaseModel):
    default_conf: ClassVar[dict] = {
        "input_dim": 256,
        "descriptor_dim": 256,
        "num_heads": 4,
        "n_layers": 9,
        "sinkhorn_iterations": 50,
        "filter_threshold": 0.2,
        "norm": "layer",  # 'none' for imported official checkpoints
        "attention": None,  # 'xla' = plain PyTorch; None/'auto'/'pallas' = kernel K2
        "loss": {"nll_balancing": 0.5},
    }
    required_data_keys: ClassVar[list] = [
        "keypoints0", "keypoints1", "descriptors0", "descriptors1"]

    def __init__(self, conf: dict | None = None):
        super().__init__(conf)
        conf = self.conf
        if conf["norm"] not in ("layer", "none"):
            raise NotImplementedError(f"SuperGlue does not implement norm={conf['norm']!r}")
        d, norm = conf["descriptor_dim"], conf["norm"]
        attn_impl = conf["attention"] or "auto"
        self.input_proj = Dense(conf["input_dim"], d)
        self.kenc = KeypointEncoder(d, norm=norm)
        for i in range(conf["n_layers"]):
            for kind in ("self", "cross"):
                setattr(self, f"gnn_{i}_{kind}",
                        AttentionalPropagation(d, conf["num_heads"], norm, attn_impl))
        self.final_proj = Dense(d, d)
        self.bin_score = nn.Parameter(torch.tensor(1.0))

    def _forward(self, data: dict) -> dict:
        conf = self.conf
        mask0 = data.get("keypoint_valid0")
        mask1 = data.get("keypoint_valid1")
        size0 = data.get("view0", {}).get("image_size", data.get("image_size0"))
        size1 = data.get("view1", {}).get("image_size", data.get("image_size1"))
        desc0 = self.input_proj(data["descriptors0"])
        desc1 = self.input_proj(data["descriptors1"])
        desc0 = desc0 + self.kenc(data["keypoints0"], data["keypoint_scores0"], size0)
        desc1 = desc1 + self.kenc(data["keypoints1"], data["keypoint_scores1"], size1)
        for i in range(conf["n_layers"]):
            self_layer = getattr(self, f"gnn_{i}_self")
            cross_layer = getattr(self, f"gnn_{i}_cross")
            desc0 = self_layer(desc0, desc0, mask0)
            desc1 = self_layer(desc1, desc1, mask1)
            desc0, desc1 = cross_layer(desc0, desc1, mask1), cross_layer(desc1, desc0, mask0)
        mdesc0, mdesc1 = self.final_proj(desc0), self.final_proj(desc1)
        sim = torch.einsum("bnd,bmd->bnm", mdesc0, mdesc1) / conf["descriptor_dim"] ** 0.5
        scores = log_optimal_transport(sim, self.bin_score, iters=int(conf["sinkhorn_iterations"]),
                                       mask0=mask0, mask1=mask1)
        pred = {"log_assignment": scores,
                **filter_matches(scores[:, :-1, :-1], conf["filter_threshold"])}
        if mask0 is not None:
            pred["matches0"] = pred["matches0"].masked_fill(~mask0, -1)
        if mask1 is not None:
            pred["matches1"] = pred["matches1"].masked_fill(~mask1, -1)
        return pred

    def loss(self, pred: dict, data: dict):
        total, nll_pos, nll_neg = nll_loss(pred["log_assignment"], data["gt_matches0"],
                                           data["gt_matches1"], balance=True)
        losses = {"total": total, "assignment_nll": total, "nll_pos": nll_pos,
                  "nll_neg": nll_neg}
        return losses, matcher_metrics(pred, data)


__main_model__ = SuperGlue
