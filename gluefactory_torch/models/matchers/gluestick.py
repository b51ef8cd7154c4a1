"""GlueStick, the joint point and line matcher
(gluefactory_tpu/models/matchers/gluestick.py).

The node set of each view is the wireframe's: junctions, then keypoints.
Keypoints and line endpoints are encoded by MLPs; then each layer runs
self-attention, a line message along each segment (the MLP of an endpoint's
descriptor, its partner's and its line encoding, scatter-averaged back onto
the junctions), and cross-attention. Points are assigned by the dustbin
double softmax; lines by the point log-assignment gathered at their
junctions, the better of the two endpoint orderings, then a double softmax
of their own. ``inter_supervision`` layers add line log-assignments of their
own heads (``line_{i}_log_assignment``) unless ``inference_only``.

Every attention runs through ``ops.attention.attention`` with the key
padding mask: kernel K2 on the card (four launches a layer) unless
``attention: 'xla'`` asks for the plain version. Module and parameter names
are the flax ones (``self_{i}``/``cross_{i}`` with ``q``/``k``/``v``/``out``
and ``mlp.dense_*``/``norm_*``, ``line_{i}.mlp``, ``kenc``, ``lenc``,
``input_proj``, ``final_proj``, ``final_line_proj``,
``inter_line_proj_{i}``, ``bin_score``, ``line_bin_score``), so
``utils/weights`` loads a committed blob by name.

The loss is JAX's: the point NLL of the log-assignment (weighted by
``loss.nll_weight``) and, with line ground truth in the data, the line NLL
of ``line_log_assignment`` (``line_nll_weight``) and of each
inter-supervision head (``line_nll_{i}``, ``inter_weight``).
``checkpointed`` recomputes each attention and line layer in the backward
pass (``torch.utils.checkpoint``, JAX's ``nn.remat``): the kernel's
autograd function then runs each layer's four K2 launches again."""

from __future__ import annotations

from functools import partial
from typing import ClassVar

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ...ops.assignment import NEG_INF, filter_matches, log_double_softmax
from ...ops.attention import attention
from ..base_model import BaseModel
from ..utils.losses import nll_loss
from ..utils.metrics import matcher_metrics
from .lightglue import Dense
from .superglue import MLP

ETH_EPS = 1e-8


def normalize_points(pts: torch.Tensor, image_size: torch.Tensor) -> torch.Tensor:
    """Points centred on the image and scaled by 0.7 of its longer side."""
    size = image_size[:, None, :]
    scale = size.amax(dim=-1, keepdim=True) * 0.7
    return (pts - size / 2.0) / (scale + ETH_EPS)


def _swap_endpoints(x: torch.Tensor) -> torch.Tensor:
    """(B, 2L, ...) endpoint rows -> each endpoint's partner's row."""
    b, n = x.shape[:2]
    return x.reshape(b, n // 2, 2, *x.shape[2:]).flip(2).reshape(x.shape)


class AttnLayer(nn.Module):
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


class LineMessage(nn.Module):
    """The message along each segment: an MLP of [endpoint descriptor,
    partner descriptor, line encoding], averaged over the valid endpoints
    of each junction and added to its descriptor."""

    def __init__(self, dim: int, norm: str):
        super().__init__()
        self.mlp = MLP((3 * dim, 2 * dim, dim), norm)

    def forward(self, desc, line_enc, lines_junc_idx, valid_lines):
        b, n, d = desc.shape
        idx = lines_junc_idx.long()  # (B, 2L) junction slots
        ep_desc = desc.gather(1, idx[..., None].expand(-1, -1, d))
        msg = self.mlp(torch.cat([ep_desc, _swap_endpoints(ep_desc), line_enc], dim=-1))
        ep_valid = valid_lines.repeat_interleave(2, dim=-1).to(desc.dtype)
        # scatter-mean onto the node set (only junction slots are hit)
        flat = (idx + torch.arange(b, device=desc.device)[:, None] * n).reshape(-1)
        agg = desc.new_zeros((b * n, d)).index_add_(
            0, flat, (msg * ep_valid[..., None]).reshape(-1, d))
        count = desc.new_zeros(b * n).index_add_(0, flat, ep_valid.reshape(-1))
        agg = agg / count.clamp_min(1.0)[:, None]
        return desc + agg.reshape(b, n, d)


class GlueStick(BaseModel):
    default_conf: ClassVar[dict] = {
        "input_dim": 256,
        "descriptor_dim": 256,
        "num_heads": 4,
        "n_layers": 9,
        "filter_threshold": 0.2,
        "line_filter_threshold": 0.2,
        "checkpointed": False,
        "norm": "layer",  # 'none' for imported official checkpoints
        "line_score_source": "point_assignment",  # | 'line_proj'
        "compat_score_tiling": False,  # the official EndPtEncoder's tiled line scores
        "inference_only": False,  # skip the inter-supervision heads
        "inter_supervision": None,  # layer indices with line supervision heads
        "attention": None,  # 'xla' = plain PyTorch; None/'auto'/'pallas' = kernel K2
        "loss": {"nll_weight": 1.0, "line_nll_weight": 1.0, "inter_weight": 0.5},
    }
    required_data_keys: ClassVar[list] = [
        "keypoints0", "keypoints1", "descriptors0", "descriptors1",
        "lines0", "lines1", "lines_junc_idx0", "lines_junc_idx1"]

    def __init__(self, conf: dict | None = None):
        super().__init__(conf)
        conf = self.conf
        if conf["norm"] not in ("layer", "none"):
            raise NotImplementedError(f"GlueStick does not implement norm={conf['norm']!r}")
        if conf["line_score_source"] not in ("point_assignment", "line_proj"):
            raise NotImplementedError("GlueStick does not implement line_score_source="
                                      f"{conf['line_score_source']!r}")
        d, norm = conf["descriptor_dim"], conf["norm"]
        attn_impl = conf["attention"] or "auto"
        self.input_proj = Dense(conf["input_dim"], d)
        self.kenc = MLP((3, 32, 64, 128, 256, d), norm)
        self.lenc = MLP((5, 32, 64, 128, 256, d), norm)
        for i in range(conf["n_layers"]):
            setattr(self, f"self_{i}", AttnLayer(d, conf["num_heads"], norm, attn_impl))
            setattr(self, f"cross_{i}", AttnLayer(d, conf["num_heads"], norm, attn_impl))
            setattr(self, f"line_{i}", LineMessage(d, norm))
        if conf["line_score_source"] == "line_proj":
            self.final_line_proj = Dense(d, d)
        self.inter_layers = [int(i) for i in conf["inter_supervision"] or []]
        for i in self.inter_layers:
            setattr(self, f"inter_line_proj_{i}", Dense(d, d))
        self.final_proj = Dense(d, d)
        self.bin_score = nn.Parameter(torch.tensor(1.0))
        self.line_bin_score = nn.Parameter(torch.tensor(1.0))

    def _encode_view(self, data: dict, i: str):
        size = data.get(f"view{i}", {}).get("image_size", data.get(f"image_size{i}"))
        kpts = data[f"keypoints{i}"]
        desc = self.input_proj(data[f"descriptors{i}"])
        desc = desc + self.kenc(torch.cat([normalize_points(kpts, size),
                                           data[f"keypoint_scores{i}"][..., None]], dim=-1))
        lines = data[f"lines{i}"]  # (B, L, 2, 2)
        b, n_lines = lines.shape[:2]
        eps_n = normalize_points(lines.reshape(b, 2 * n_lines, 2), size)
        lscore = data.get(f"line_scores{i}")
        if lscore is None:
            lscore = lines.new_ones((b, n_lines))
        if self.conf["compat_score_tiling"]:
            # the official encoder's quirk: scores tiled over the interleaved
            # endpoints, and not normalised
            lscore = lscore.repeat(1, 2)
        else:
            lscore = lscore.repeat_interleave(2, dim=-1)
            lscore = lscore / (lscore.amax(dim=-1, keepdim=True) + ETH_EPS)
        line_enc = self.lenc(torch.cat([eps_n, _swap_endpoints(eps_n) - eps_n,
                                        lscore[..., None]], dim=-1))
        return desc, line_enc

    def _forward(self, data: dict) -> dict:
        conf = self.conf
        mask0, mask1 = data.get("keypoint_valid0"), data.get("keypoint_valid1")
        desc0, lenc0 = self._encode_view(data, "0")
        desc1, lenc1 = self._encode_view(data, "1")
        idx0, idx1 = data["lines_junc_idx0"], data["lines_junc_idx1"]
        vl0 = data.get("valid_lines0")
        vl1 = data.get("valid_lines1")
        vl0 = vl0 if vl0 is not None else data["lines0"].new_ones(
            data["lines0"].shape[:2], dtype=torch.bool)
        vl1 = vl1 if vl1 is not None else data["lines1"].new_ones(
            data["lines1"].shape[:2], dtype=torch.bool)
        scale = conf["descriptor_dim"] ** 0.5
        inter_preds = {}
        remat = conf["checkpointed"] and torch.is_grad_enabled()

        def run(layer, *args):
            return checkpoint(layer, *args, use_reentrant=False) if remat else layer(*args)

        for i in range(conf["n_layers"]):
            self_layer, line_layer, cross_layer = (partial(run, getattr(self, f"{kind}_{i}"))
                                                   for kind in ("self", "line", "cross"))
            desc0 = self_layer(desc0, desc0, mask0)
            desc1 = self_layer(desc1, desc1, mask1)
            desc0 = line_layer(desc0, lenc0, idx0, vl0)
            desc1 = line_layer(desc1, lenc1, idx1, vl1)
            desc0, desc1 = cross_layer(desc0, desc1, mask1), cross_layer(desc1, desc0, mask0)
            if i in self.inter_layers and not conf["inference_only"]:
                proj = getattr(self, f"inter_line_proj_{i}")
                sim_i = torch.einsum("bnd,bmd->bnm", proj(desc0), proj(desc1)) / scale
                scores_i = log_double_softmax(sim_i, self.bin_score, mask0, mask1)
                _, lm = self._line_matches(scores_i[:, :-1, :-1], idx0, idx1, vl0, vl1,
                                           conf["line_filter_threshold"])
                inter_preds[f"line_{i}_log_assignment"] = lm["line_log_assignment"]
        sim = torch.einsum("bnd,bmd->bnm", self.final_proj(desc0), self.final_proj(desc1)) / scale
        scores = log_double_softmax(sim, self.bin_score, mask0, mask1)
        pred = {"log_assignment": scores,
                **filter_matches(scores[:, :-1, :-1], conf["filter_threshold"])}
        if mask0 is not None:
            pred["matches0"] = pred["matches0"].masked_fill(~mask0, -1)
        if mask1 is not None:
            pred["matches1"] = pred["matches1"].masked_fill(~mask1, -1)
        if conf["line_score_source"] == "line_proj":
            line_src = torch.einsum("bnd,bmd->bnm", self.final_line_proj(desc0),
                                    self.final_line_proj(desc1)) / scale
        else:
            line_src = scores[:, :-1, :-1]
        line_scores, line_matches = self._line_matches(line_src, idx0, idx1, vl0, vl1,
                                                       conf["line_filter_threshold"])
        pred.update(line_matches)
        pred.update(inter_preds)
        pred["raw_line_scores"] = line_scores
        return pred

    def _line_matches(self, scores, idx0, idx1, vl0, vl1, threshold):
        """Line scores (B, L0, L1) from the node scores (B, N, M) at the
        lines' junctions, the better of the two endpoint orderings, and the
        line assignment and matches of their double softmax."""
        b, n_nodes1 = scores.shape[0], scores.shape[2]
        l0, l1 = idx0.shape[1] // 2, idx1.shape[1] // 2
        s = scores.gather(1, idx0.long()[..., None].expand(-1, -1, n_nodes1))
        s = s.gather(2, idx1.long()[:, None, :].expand(-1, s.shape[1], -1))
        s = s.reshape(b, l0, 2, l1, 2)
        straight = 0.5 * (s[:, :, 0, :, 0] + s[:, :, 1, :, 1])
        flipped = 0.5 * (s[:, :, 0, :, 1] + s[:, :, 1, :, 0])
        line_scores = torch.maximum(straight, flipped)
        line_scores = line_scores.masked_fill(~(vl0[:, :, None] & vl1[:, None, :]), NEG_INF)
        ls = log_double_softmax(line_scores, self.line_bin_score, vl0, vl1)
        matches = filter_matches(ls[:, :-1, :-1], threshold)
        return line_scores, {
            "line_matches0": matches["matches0"].masked_fill(~vl0, -1),
            "line_matches1": matches["matches1"].masked_fill(~vl1, -1),
            "line_matching_scores0": matches["matching_scores0"],
            "line_matching_scores1": matches["matching_scores1"],
            "line_log_assignment": ls,
        }

    def loss(self, pred: dict, data: dict):
        """(losses, metrics): ``assignment_nll``, ``nll_pos``, ``nll_neg``,
        with line ground truth ``line_nll`` and ``line_nll_{i}``, and their
        weighted sum ``total``, each (B,); the point matches' metrics."""
        conf = self.conf["loss"]
        total_pt, nll_pos, nll_neg = nll_loss(pred["log_assignment"], data["gt_matches0"],
                                              data["gt_matches1"])
        losses = {"assignment_nll": total_pt, "nll_pos": nll_pos, "nll_neg": nll_neg}
        total = conf["nll_weight"] * total_pt
        if "gt_line_matches0" in data:
            gt0, gt1 = data["gt_line_matches0"], data["gt_line_matches1"]
            losses["line_nll"] = nll_loss(pred["line_log_assignment"], gt0, gt1)[0]
            total = total + conf["line_nll_weight"] * losses["line_nll"]
            for i in self.inter_layers:
                key = f"line_{i}_log_assignment"
                if key in pred:
                    losses[f"line_nll_{i}"] = nll_loss(pred[key], gt0, gt1)[0]
                    total = total + conf["inter_weight"] * losses[f"line_nll_{i}"]
        losses["total"] = total
        return losses, matcher_metrics(pred, data)


__main_model__ = GlueStick


def torch_weight_converter(state_dict: dict, conf: dict | None = None) -> dict:
    """The state_dict of a ``GlueStick`` with ``norm: 'none', line_score_source:
    'line_proj', compat_score_tiling: true`` (load it strictly) from the
    official cvg/GlueStick checkpoint's state dict, as the JAX package's
    converter maps it (gluefactory_tpu/models/matchers/gluestick.py
    ``torch_weight_converter``):

      - the k=1 Conv1d layers become Dense layers;
      - each BatchNorm folds into the conv before it, in float64: W' = a W,
        b' = a (b - mean) + beta with a = gamma / sqrt(var + eps);
      - the official attention views the channels as (head_dim, heads), this
        module as (heads, head_dim): the rows of q, k and v and the columns
        of the merge are permuted;
      - the official model has no input projection: ``input_proj`` is the
        identity;
      - no inter-supervision heads (the official checkpoint has none)."""
    from ...core.config import merge

    cfg = merge(GlueStick.default_conf, conf or {})
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
              "final_proj": conv("final_proj"), "final_line_proj": conv("final_line_proj")}
    for enc in ("kenc", "lenc"):  # in -> 32 -> 64 -> 128 -> 256 -> d, BatchNorm between
        for i in range(5):
            official = f"{enc}.encoder.{3 * i}"
            layers[f"{enc}.dense_{i}"] = (
                conv(official) if i == 4 else folded(official, f"{enc}.encoder.{3 * i + 1}"))
    for i in range(n_layers):
        for kind, j in (("self", 2 * i), ("cross", 2 * i + 1)):
            ours, theirs = f"{kind}_{i}", f"gnn.layers.{j}.update"
            for name, k in (("q", 0), ("k", 1), ("v", 2)):
                p = conv(f"{theirs}.attn.proj.{k}")
                layers[f"{ours}.{name}"] = {"weight": p["weight"][perm], "bias": p["bias"][perm]}
            p = conv(f"{theirs}.attn.merge")
            layers[f"{ours}.out"] = {"weight": p["weight"][:, perm], "bias": p["bias"]}
            layers[f"{ours}.mlp.dense_0"] = folded(f"{theirs}.mlp.0", f"{theirs}.mlp.1")
            layers[f"{ours}.mlp.dense_1"] = conv(f"{theirs}.mlp.3")
        theirs = f"gnn.line_layers.{i}"
        layers[f"line_{i}.mlp.dense_0"] = folded(f"{theirs}.mlp.0", f"{theirs}.mlp.1")
        layers[f"line_{i}.mlp.dense_1"] = conv(f"{theirs}.mlp.3")
    state = {f"{name}.{k}": torch.from_numpy(np.ascontiguousarray(v))
             for name, p in layers.items() for k, v in p.items()}
    for key in ("bin_score", "line_bin_score"):
        state[key] = torch.from_numpy(array(key).reshape(()))
    return state
