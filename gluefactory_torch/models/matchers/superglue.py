"""SuperGlue (gluefactory_tpu/models/matchers/superglue.py): keypoint
encoder, alternating self- and cross-attention message passing, and the
Sinkhorn assignment with dustbins.

Every attention runs through ``ops.attention.attention``: kernel K2 on the
card unless ``attention: 'xla'`` asks for the plain version, four calls a
layer. Module and parameter names are the flax ones (``gnn_{i}_{self,cross}``
with ``q``/``k``/``v``/``out`` and ``mlp.dense_*``/``norm_*``,
``kenc.encoder``, ``input_proj``, ``final_proj``, ``bin_score``), so
``utils/weights`` loads a committed blob by name. Dense layers start as flax
initialises them and ``bin_score`` at 1. ``torch_weight_converter`` maps an
official MagicLeap checkpoint onto this module (``norm: 'none'``). Under
autograd (training) the attention runs K2 forward with the PyTorch
recompute backward (``ops.attention.AttentionFn``) and the Sinkhorn
iterations are differentiated as they run, without checkpointing, as in
the JAX package. ``loss.nll_balancing`` is read by neither package: the NLL
balances positives and negatives 1:1."""

from __future__ import annotations

from typing import ClassVar

import numpy as np
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


def torch_weight_converter(state_dict: dict, conf: dict | None = None) -> dict:
    """The state_dict of a ``SuperGlue`` with ``norm: 'none'`` (load it
    strictly) from the official MagicLeap ``superglue_{indoor,outdoor}.pth``
    state dict, as the JAX package's converter maps it
    (gluefactory_tpu/models/matchers/superglue.py ``torch_weight_converter``):

      - the k=1 Conv1d layers become Dense layers;
      - each BatchNorm of the MLPs folds into the conv before it, in float64:
        W' = a W, b' = a (b - mean) + beta with a = gamma / sqrt(var + eps);
      - the official attention views the channels as (head_dim, heads), this
        module as (heads, head_dim): the rows of q, k and v and the columns
        of the merge are permuted;
      - the official model has no input projection: ``input_proj`` is the
        identity."""
    from ...core.config import merge

    cfg = merge(SuperGlue.default_conf, conf or {})
    d, h, n_layers = int(cfg["descriptor_dim"]), int(cfg["num_heads"]), int(cfg["n_layers"])
    eps = 1e-5  # torch's BatchNorm1d default

    def array(key, dtype=np.float32):
        value = state_dict[key]
        value = value.detach().cpu().numpy() if isinstance(value, torch.Tensor) else value
        return np.asarray(value, dtype)

    def conv(prefix):
        w = array(f"{prefix}.weight")
        return {"weight": w[..., 0] if w.ndim == 3 else w, "bias": array(f"{prefix}.bias")}

    def folded(conv_prefix, bn_prefix):
        w = array(f"{conv_prefix}.weight", np.float64)[..., 0]
        b = array(f"{conv_prefix}.bias", np.float64)
        gamma, beta, mean, var = (array(f"{bn_prefix}.{k}", np.float64) for k in
                                  ("weight", "bias", "running_mean", "running_var"))
        a = gamma / np.sqrt(var + eps)
        return {"weight": (a[:, None] * w).astype(np.float32),
                "bias": (a * (b - mean) + beta).astype(np.float32)}

    # this module's channel c = head * hd + i is the official channel i * heads + head
    hd = d // h
    perm = np.asarray([i * h + head for head in range(h) for i in range(hd)])
    layers = {"input_proj": {"weight": np.eye(d, dtype=np.float32),
                             "bias": np.zeros(d, np.float32)},
              "final_proj": conv("final_proj")}
    for i in range(5):  # the keypoint encoder: 3 -> 32 -> 64 -> 128 -> 256 -> d
        official = f"kenc.encoder.{3 * i}"
        layers[f"kenc.encoder.dense_{i}"] = (
            conv(official) if i == 4 else folded(official, f"kenc.encoder.{3 * i + 1}"))
    for i in range(n_layers):
        for kind, j in (("self", 2 * i), ("cross", 2 * i + 1)):
            ours, theirs = f"gnn_{i}_{kind}", f"gnn.layers.{j}"
            for name, k in (("q", 0), ("k", 1), ("v", 2)):
                p = conv(f"{theirs}.attn.proj.{k}")
                layers[f"{ours}.{name}"] = {"weight": p["weight"][perm], "bias": p["bias"][perm]}
            p = conv(f"{theirs}.attn.merge")
            layers[f"{ours}.out"] = {"weight": p["weight"][:, perm], "bias": p["bias"]}
            layers[f"{ours}.mlp.dense_0"] = folded(f"{theirs}.mlp.0", f"{theirs}.mlp.1")
            layers[f"{ours}.mlp.dense_1"] = conv(f"{theirs}.mlp.3")
    state = {f"{name}.{k}": torch.from_numpy(np.ascontiguousarray(v))
             for name, p in layers.items() for k, v in p.items()}
    state["bin_score"] = torch.from_numpy(array("bin_score").reshape(()))
    return state


__main_model__ = SuperGlue
