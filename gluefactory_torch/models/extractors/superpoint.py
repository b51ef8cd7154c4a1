"""SuperPoint keypoint detector and descriptor
(gluefactory_tpu/models/extractors/superpoint.py), and its training loss.

The network runs NCHW inside. Inputs and outputs keep the JAX package's
layout and keys: ``image`` (B, H, W, C) in, ``keypoints`` (B, K, 2) with the
+0.5 pixel-center convention, ``keypoint_scores``, ``keypoint_valid`` and
``descriptors`` (B, K, D) out, K = ``max_num_keypoints`` slots.

``dtype: bf16`` convolves in bfloat16 with float32 parameters, as flax's
``nn.Conv(dtype=bf16)`` does: the input and the kernel are cast to bf16, the
convolution is rounded to bf16 and the bias added in bf16. Where a float32
parameter meets a bf16 array (the ``post_relu_affine`` affines) the result is
float32, by the type promotion both libraries share, and the next convolution
casts back; the grey conversion reads the float32 image. The detector logits
and the dense descriptors become float32 before NMS, top-k, the sub-pixel readout
and the normalisation.

``has_detector``/``has_descriptor`` choose the heads. ``dense_outputs`` adds
the post-NMS ``heatmap`` and ``descriptors_dense`` (B, H/8, W/8, D);
``training_outputs`` adds the float32 ``cell_logits`` (B, H/8, W/8, 65) and
``descriptors_dense``, which ``loss`` reads. Parameters start as flax
initialises them (models/utils/init.py)."""

from __future__ import annotations

from typing import ClassVar

import torch
import torch.nn.functional as F
from torch import nn

from ...geometry.homography import warp_points
from ...geometry.kp_losses import gt_anchored_loc_loss, peaky_loss, soft_argmax_loc_loss
from ...ops.interpolate import cell_logits_to_heatmap, sample_descriptors
from ...ops.nms import (
    com_refinement,
    select_top_k_keypoints,
    simple_nms,
    soft_argmax_refinement,
)
from ..base_model import BaseModel
from ..utils.desc_losses import caps_window_loss, mutual_detected_matches, nll_desc_loss
from ..utils.init import flax_reset_

_GRAY = (0.299, 0.587, 0.114)  # cv2 / ITU-R 601 weights
COMPUTE_DTYPES = {"float32": torch.float32, "bf16": torch.bfloat16}


class Conv2d(nn.Conv2d):
    """flax's ``nn.Conv(dtype=...)`` in NCHW: in bf16 the input and the
    float32 kernel are cast to bf16, the convolution rounded to bf16 and the
    bias added in bf16."""

    def __init__(self, c_in: int, c_out: int, kernel_size: int, padding: int = 0,
                 dtype: torch.dtype = torch.float32):
        super().__init__(c_in, c_out, kernel_size, padding=padding)
        self.compute_dtype = dtype

    def reset_parameters(self) -> None:
        flax_reset_(self)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.compute_dtype == torch.float32:
            return super().forward(x)
        cdt = self.compute_dtype
        y = self._conv_forward(x.to(cdt), self.weight.to(cdt), None)
        return y + self.bias.to(cdt)[:, None, None]


class ChannelAffine(nn.Module):
    """Per-channel scale and bias (an inference-mode BatchNorm)."""

    def __init__(self, features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.scale[:, None, None] + self.bias[:, None, None]


class VGGBackbone(nn.Module):
    """Four-stage VGG encoder of stride 8."""

    pool_after = (1, 3, 5)

    def __init__(self, channels: list[int], post_relu_affine: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.post_relu_affine = post_relu_affine
        c_in = 1
        for i, ch in enumerate(channels):
            self.add_module(f"conv{i}", Conv2d(c_in, ch, 3, padding=1, dtype=dtype))
            if post_relu_affine:
                self.add_module(f"affine{i}", ChannelAffine(ch))
            c_in = ch
        self.n_convs = len(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_convs):
            x = F.relu(getattr(self, f"conv{i}")(x))
            if self.post_relu_affine:
                x = getattr(self, f"affine{i}")(x)
            if i in self.pool_after:
                x = F.max_pool2d(x, 2, 2)
        return x


class SuperPoint(BaseModel):
    default_conf: ClassVar[dict] = {
        "has_detector": True,
        "has_descriptor": True,
        "descriptor_dim": 256,
        "max_num_keypoints": 1024,
        "nms_radius": 4,
        "detection_threshold": 0.005,
        "remove_borders": 4,
        "refinement_radius": 0,
        "refinement_mode": "softargmax",
        "dense_outputs": False,
        "training_outputs": False,
        "desc_sampling": "center",
        "post_relu_affine": False,
        "channels": [64, 64, 64, 64, 128, 128, 128, 128],
        "head_channels": 256,
        "dtype": "float32",  # 'bf16' runs the CNN in bfloat16 (parameters stay float32)
        "weights": None,
        "loss": {  # the detector and descriptor losses of SuperPoint training
            "cell_pos_weight": 32.0,
            "cell_labels": "hard",
            "desc_weight": 1.0,
            "desc_lambda_d": 250.0,
            "desc_margin_pos": 1.0,
            "desc_margin_neg": 0.2,
            "desc_cell_dist": 8.0,
            "desc_nll_weight": 0.0,
            "desc_nll_temp": 0.1,
            "desc_match_th": 3.0,
            "desc_caps_weight": 0.0,
            "desc_caps_window": 24.0,
            "desc_caps_temp": 0.07,
            "loc_weight": 0.0,
            "loc_radius": 2,
            "loc_max_dist": 4.0,
            "loc_anchor": "gt",
            "peaky_weight": 0.0,
            "peaky_radius": 2,
        },
    }
    # the weights come from utils/weights.py, not from a conf key
    unported_conf: ClassVar[frozenset] = frozenset({"weights"})
    required_data_keys: ClassVar[list] = ["image"]

    def __init__(self, conf: dict | None = None):
        super().__init__(conf)
        conf = self.conf
        if conf["dtype"] not in COMPUTE_DTYPES:
            raise NotImplementedError(f"SuperPoint does not implement dtype={conf['dtype']!r} "
                                      f"(ported: {sorted(COMPUTE_DTYPES)})")
        cdt = COMPUTE_DTYPES[conf["dtype"]]
        c_feat = conf["channels"][-1]
        head = conf["head_channels"]
        affine = conf["post_relu_affine"]
        self.backbone = VGGBackbone(conf["channels"], affine, cdt)
        if conf["has_detector"]:
            self.convPa = Conv2d(c_feat, head, 3, padding=1, dtype=cdt)
            self.convPb = Conv2d(head, 65, 1, dtype=cdt)
            if affine:
                self.affinePa = ChannelAffine(head)
        if conf["has_descriptor"]:
            self.convDa = Conv2d(c_feat, head, 3, padding=1, dtype=cdt)
            self.convDb = Conv2d(head, conf["descriptor_dim"], 1, dtype=cdt)
            if affine:
                self.affineDa = ChannelAffine(head)

    def _forward(self, data: dict) -> dict:
        conf = self.conf
        image = data["image"]
        if image.shape[-1] == 3:
            image = (image * image.new_tensor(_GRAY)).sum(dim=-1, keepdim=True)
        features = self.backbone(image.permute(0, 3, 1, 2))
        pred = {}

        if conf["has_detector"]:
            pa = F.relu(self.convPa(features))
            if conf["post_relu_affine"]:
                pa = self.affinePa(pa)
            logits = self.convPb(pa).permute(0, 2, 3, 1).float()  # (B, Hc, Wc, 65)
            heat_raw = cell_logits_to_heatmap(logits)
            heat = simple_nms(heat_raw, conf["nms_radius"])
            keypoints, scores, valid = select_top_k_keypoints(
                heat,
                k=conf["max_num_keypoints"],
                threshold=conf["detection_threshold"],
                border=conf["remove_borders"],
                image_size=data.get("image_size"),
            )
            if conf["refinement_radius"] > 0:
                # on the pre-NMS heatmap: NMS zeroes the window the refinement reads
                refine = (com_refinement if conf["refinement_mode"] == "com"
                          else soft_argmax_refinement)
                keypoints = refine(keypoints, heat_raw, conf["refinement_radius"])
            pred.update(keypoints=keypoints + 0.5,  # pixel-center convention
                        keypoint_scores=scores, keypoint_valid=valid)
            if conf["dense_outputs"]:
                pred["heatmap"] = heat
            if conf["training_outputs"]:
                pred["cell_logits"] = logits

        if conf["has_descriptor"]:
            da = F.relu(self.convDa(features))
            if conf["post_relu_affine"]:
                da = self.affineDa(da)
            dense = self.convDb(da).float()
            dense = dense / (torch.linalg.vector_norm(dense, dim=1, keepdim=True) + 1e-8)
            dense = dense.permute(0, 2, 3, 1)  # (B, Hc, Wc, D)
            if conf["has_detector"]:
                pred["descriptors"] = sample_descriptors(
                    dense, pred["keypoints"] - 0.5, stride=8, mode=conf["desc_sampling"])
            if conf["dense_outputs"] or conf["training_outputs"] or not conf["has_detector"]:
                pred["descriptors_dense"] = dense
        return pred

    def loss(self, pred: dict, data: dict) -> tuple[dict, dict]:
        """The detector and descriptor losses against the exact corner
        ground truth (``gt_keypoints*``, ``gt_keypoint_valid*``) and the
        pair's ``H_0to1`` of the on-device engine: per view the 65-way cell
        cross-entropy (hard or soft labels, corner cells weighted by
        ``cell_pos_weight``), the localisation and peakiness losses; then
        the keypoint InfoNCE and CAPS over H-warped detections and the dense
        cell-pair hinge. Needs ``training_outputs``; returns (losses,
        metrics), (B,) each."""
        conf = self.conf["loss"]
        losses, metrics = {}, {}
        total = 0.0
        pos_weight = float(conf["cell_pos_weight"])
        for i in "01":
            logits = pred.get(f"cell_logits{i}", pred.get("cell_logits"))
            if logits is None:
                raise NotImplementedError("SuperPoint.loss needs conf.training_outputs=true")
            b, hc, wc, _ = logits.shape
            kp, valid = data[f"gt_keypoints{i}"], data[f"gt_keypoint_valid{i}"]
            flat = logits.reshape(b, -1, 65)
            if conf["cell_labels"] == "soft":
                target = cell_labels_soft(kp, valid, hc, wc)
                ce = -(target * torch.log_softmax(flat, dim=-1)).sum(-1)
                w = 1.0 + (pos_weight - 1.0) * (1.0 - target[..., 64])
            else:
                labels = cell_labels(kp, valid, hc, wc).reshape(b, -1)
                ce = F.cross_entropy(flat.transpose(1, 2), labels, reduction="none")
                w = torch.where(labels < 64, pos_weight, 1.0)
            det = (ce * w).sum(-1) / w.sum(-1)
            losses[f"det_ce{i}"] = det
            total = total + det / 2.0

            # detections within 3 px of a GT corner, and GT corners recovered
            pk, pv = pred[f"keypoints{i}"], pred[f"keypoint_valid{i}"]
            d2 = ((pk[:, :, None, :] - kp[:, None, :, :]) ** 2).sum(-1)
            d2 = torch.where(valid[:, None, :], d2, 1e12)
            near_gt = (d2.amin(dim=2) < 9.0) & pv
            metrics[f"kp_precision{i}"] = near_gt.sum(-1) / pv.sum(-1).clamp_min(1)
            d2p = torch.where(pv[:, :, None], d2, 1e12)
            metrics[f"kp_recall{i}"] = (((d2p.amin(dim=1) < 9.0) & valid).sum(-1)
                                        / valid.sum(-1).clamp_min(1))

            if float(conf["loc_weight"]) > 0 or float(conf["peaky_weight"]) > 0:
                heat_raw = cell_logits_to_heatmap(logits)
                if float(conf["loc_weight"]) > 0:
                    if conf["loc_anchor"] == "gt":
                        # the heatmap frame is the GT's minus 0.5 (forward adds
                        # +0.5 to its keypoints)
                        loc = gt_anchored_loc_loss(heat_raw, kp - 0.5, valid,
                                                   radius=int(conf["loc_radius"]),
                                                   mode=self.conf["refinement_mode"])
                    else:  # anchored at the detections, toward the nearest GT corner
                        nearest = d2.argmin(dim=2)
                        gt_near = torch.take_along_dim(kp, nearest[..., None], dim=1)
                        gt_ok = torch.take_along_dim(valid, nearest, dim=1) & pv
                        loc = soft_argmax_loc_loss(heat_raw, pk - 0.5, gt_near - 0.5, gt_ok,
                                                   radius=int(conf["loc_radius"]),
                                                   max_dist=float(conf["loc_max_dist"]))
                    losses[f"kp_loc{i}"] = loc
                    total = total + float(conf["loc_weight"]) * loc / 2.0
                if float(conf["peaky_weight"]) > 0:
                    peaky = peaky_loss(heat_raw, kp - 0.5, valid,
                                       radius=int(conf["peaky_radius"]))
                    losses[f"kp_peaky{i}"] = peaky
                    total = total + float(conf["peaky_weight"]) * peaky / 2.0

        nll_w, caps_w = float(conf["desc_nll_weight"]), float(conf["desc_caps_weight"])
        both_heads = self.conf["has_descriptor"] and self.conf["has_detector"]
        if both_heads and (nll_w > 0 or caps_w > 0):
            H = data["H_0to1"]
            # index-coordinate detections (without the +0.5 pixel-center shift)
            kp0, kp1 = pred["keypoints0"] - 0.5, pred["keypoints1"] - 0.5
            v0, v1 = pred["keypoint_valid0"], pred["keypoint_valid1"]
            d0s, d1s = pred["descriptors0"], pred["descriptors1"]
            wkp0, wkp1 = warp_points(kp0, H), warp_points(kp1, torch.linalg.inv(H))

            def inside(points, dense):
                hc_, wc_ = dense.shape[1:3]
                size = points.new_tensor([wc_ * 8.0, hc_ * 8.0])
                return ((points >= 0.0) & (points <= size - 1.0)).all(-1)

            in1 = inside(wkp0, pred["descriptors_dense1"])
            in0 = inside(wkp1, pred["descriptors_dense0"])
            if nll_w > 0:
                m0, m1 = mutual_detected_matches(kp0, kp1, v0, v1, H,
                                                 th=float(conf["desc_match_th"]))
                t = float(conf["desc_nll_temp"])
                nll = 0.5 * (nll_desc_loss(d0s, d1s, m0, temperature=t, valid0=v0)
                             + nll_desc_loss(d1s, d0s, m1, temperature=t, valid0=v1))
                losses["desc_nll"] = nll
                total = total + nll_w * nll
                metrics["desc_nll_pairs"] = (m0 >= 0).sum(-1).float()
            if caps_w > 0:
                # dense maps are stride 8 with cell centres at 3.5 + 8i
                window = float(conf["desc_caps_window"]) / 8.0
                t = float(conf["desc_caps_temp"])
                caps = 0.5 * (
                    caps_window_loss(d0s, (wkp0 - 3.5) / 8.0, pred["descriptors_dense1"],
                                     window=window, temperature=t, valid0=v0 & in1)
                    + caps_window_loss(d1s, (wkp1 - 3.5) / 8.0, pred["descriptors_dense0"],
                                       window=window, temperature=t, valid0=v1 & in0))
                losses["desc_caps"] = caps
                total = total + caps_w * caps

        if self.conf["has_descriptor"] and float(conf["desc_weight"]) > 0:
            hinge, pos, in1, dot = self._cell_hinge(pred, data)
            losses["desc_hinge"] = hinge
            total = total + float(conf["desc_weight"]) * hinge
            # descriptor health: mean similarity of positive and negative cell pairs
            with torch.no_grad():
                for name, sel in (("desc_pos_sim", pos), ("desc_neg_sim", ~pos)):
                    sel = sel & in1[:, :, None]
                    metrics[name] = (dot * sel).sum((1, 2)) / sel.sum((1, 2)).clamp_min(1)
        losses["total"] = total
        return losses, metrics

    def _cell_hinge(self, pred: dict, data: dict):
        """The dense descriptor hinge over every pair of 8x8 cells under
        ``H_0to1`` (SuperPoint's eq. 4-6): a pair is positive when the
        warped centre of the view-0 cell lies within ``desc_cell_dist`` px of
        the view-1 cell's; view-0 cells warped out of view 1 do not count.
        The (B, N, N) similarities are one batched matmul. Returns (the
        loss (B,), positives, in-view mask (B, N), similarities)."""
        conf = self.conf["loss"]
        d0, d1 = pred["descriptors_dense0"], pred["descriptors_dense1"]
        b, hc, wc, c = d0.shape
        ys, xs = torch.meshgrid(torch.arange(hc, device=d0.device),
                                torch.arange(wc, device=d0.device), indexing="ij")
        centers = torch.stack([xs, ys], -1).reshape(1, -1, 2).float() * 8.0 + 3.5
        warped = warp_points(centers.expand(b, -1, -1), data["H_0to1"])
        if "view1" in data:
            size = data["view1"]["image_size"].float()
        else:
            size = warped.new_tensor([wc * 8, hc * 8])
        if size.ndim == 2:
            size = size[:, None, :]
        in1 = ((warped >= 0.0) & (warped <= size - 1.0)).all(-1)
        dist2 = ((warped[:, :, None, :] - centers[:, None, :, :]) ** 2).sum(-1)
        pos = dist2 <= float(conf["desc_cell_dist"]) ** 2
        dot = torch.bmm(d0.reshape(b, -1, c), d1.reshape(b, -1, c).transpose(1, 2))
        positive = float(conf["desc_lambda_d"]) * (float(conf["desc_margin_pos"]) - dot)
        hinge = torch.where(pos, positive.clamp_min(0.0),
                            (dot - float(conf["desc_margin_neg"])).clamp_min(0.0))
        return (hinge * in1[:, :, None]).mean((1, 2)), pos, in1, dot


def cell_labels(kp: torch.Tensor, valid: torch.Tensor, hc: int, wc: int) -> torch.Tensor:
    """Exact keypoints (B, K, 2) and their validity -> 65-way labels
    (B, hc, wc): the within-cell position (row * 8 + col) of the corner in
    each cell, 64 (the dustbin) where none lands. Where several corners land
    in one cell the last slot wins, as the JAX package's serial scatter
    writes them; ``amax`` of the slot index does not depend on the order of
    the card's atomics."""
    b, k = kp.shape[:2]
    px, py = kp[..., 0].floor().long(), kp[..., 1].floor().long()
    inb = valid & (px >= 0) & (py >= 0) & (px < wc * 8) & (py < hc * 8)
    cell = torch.where(inb, (py // 8) * wc + px // 8, hc * wc)  # out of range -> a spare slot
    within = (py % 8) * 8 + px % 8
    slot = torch.arange(k, device=kp.device).expand(b, k)
    winner = torch.full((b, hc * wc + 1), -1, dtype=torch.long, device=kp.device)
    winner = winner.scatter_reduce(1, cell, slot, "amax")[:, :-1]
    labels = torch.where(winner >= 0, torch.take_along_dim(within, winner.clamp_min(0), dim=1),
                         64)
    return labels.reshape(b, hc, wc)


def cell_labels_soft(kp: torch.Tensor, valid: torch.Tensor, hc: int, wc: int) -> torch.Tensor:
    """Exact keypoints (B, K, 2) and their validity -> soft 65-way targets
    (B, hc*wc, 65): each corner's heatmap-frame position (kp - 0.5) splats
    bilinear mass over its up-to-4 neighbouring pixels (across cell borders
    where they straddle one), summed over corners and clipped to 1; a cell's
    remaining mass goes to the dustbin, and each row is normalised.

    The sum over corners is deterministic on the card: the contributions
    are sorted by pixel (stably, so in the JAX package's tap-then-slot
    order) and each pixel's total is the difference of a float64 running
    sum at its run's ends, read by order-free ``amax``/``amin`` scatters
    (the weights are non-negative, so the running sum is monotone). No
    atomic addition decides a value."""
    b = kp.shape[0]
    h, w = hc * 8, wc * 8
    q = kp - 0.5
    x0, y0 = q[..., 0].floor(), q[..., 1].floor()
    fx, fy = q[..., 0] - x0, q[..., 1] - y0
    index, weight = [], []
    for dx, dy, wt in ((0, 0, (1 - fx) * (1 - fy)), (1, 0, fx * (1 - fy)),
                       (0, 1, (1 - fx) * fy), (1, 1, fx * fy)):
        px, py = x0.long() + dx, y0.long() + dy
        inb = valid & (px >= 0) & (py >= 0) & (px < w) & (py < h)
        index.append(torch.where(inb, py * w + px, h * w))  # h * w: a spare slot
        weight.append(wt)
    slots = h * w + 1
    key = (torch.cat(index, 1) + torch.arange(b, device=kp.device)[:, None] * slots).reshape(-1)
    key, order = torch.sort(key, stable=True)
    values = torch.cat(weight, 1).reshape(-1)[order].double()
    running = values.cumsum(0)
    flat = torch.zeros(b * slots, dtype=torch.float64, device=kp.device)
    end = flat.scatter_reduce(0, key, running, "amax", include_self=False)
    start = flat.scatter_reduce(0, key, running - values, "amin", include_self=False)
    heat = (end - start).float().reshape(b, slots)[:, :-1].clamp(0.0, 1.0)
    cells = heat.reshape(b, hc, 8, wc, 8).permute(0, 1, 3, 2, 4).reshape(b, hc * wc, 64)
    dustbin = (1.0 - cells.sum(-1)).clamp(0.0, 1.0)
    target = torch.cat([cells, dustbin[..., None]], dim=-1)
    return target / target.sum(-1, keepdim=True).clamp_min(1e-8)


__main_model__ = SuperPoint
