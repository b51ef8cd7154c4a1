"""JPLDD, the joint point and line detector-descriptor
(gluefactory_tpu/models/extractors/joint_point_line_extractor.py).

An ALIKED-style trunk (two conv blocks, the second at stride 2, then two
deformable residual blocks after 2x2 average pools) is aggregated at full
resolution: each stage through a 1x1 convolution to dim/4 channels, the
deeper three upsampled bilinearly (half-pixel centres, as
``jax.image.resize``), concatenated, SELU. Three heads read it: the keypoint
heatmap (sigmoid), the normalised distance field (DF, sigmoid; 1 on a line,
denormalised to pixels within ``line_neighborhood``) and the angle field
(sin 2a, cos 2a), whose angle is 0.5 atan2 mod pi. Keypoints are the top
``max_num_keypoints`` of the NMS'd heatmap, refined by soft-argmax, with the
+0.5 pixel-centre convention; SDDH describes them. With ``extract_lines``
the POLD2 extractor (``models/lines/pold2_extractor.py``) makes lines from
the keypoints and the DF (and AF), and ``line_desc_samples`` > 0 adds SDDH's
descriptors at that many points along each line, which the Wunsch matcher
reads.

Inputs and outputs keep the JAX layout: ``image`` (B, H, W, C) in, maps
(B, H, W) and ``backbone_features`` (B, H, W, dim) out. ``input_channels``
tiles a grey image or averages a colour one to that many channels. Only the
``inline`` trunk is ported: another ``backbone`` is refused.

``loss`` is JAX's: the weighted BCE or focal heatmap loss, the DF's L1 on
the normalised field, the AF's L1 on (sin 2a, cos 2a) near lines, the
descriptor distillation against ``ref_descriptors``, and inside a two-view
pipeline the keypoint InfoNCE over mutual detections under ``H_0to1``."""

from __future__ import annotations

import math
from typing import ClassVar

import torch
import torch.nn.functional as F

from ...ops.nms import select_top_k_keypoints, simple_nms, soft_argmax_refinement
from ..base_model import BaseModel, make_submodel
from ..utils.desc_losses import mutual_detected_matches, nll_desc_loss
from .aliked import SDDH, ALIKEDTrunk, Conv


def optax_sigmoid_bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """optax's ``sigmoid_binary_cross_entropy`` as the JAX package writes it."""
    return logits.clamp_min(0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))


class JPLDD(BaseModel, ALIKEDTrunk):
    default_conf: ClassVar[dict] = {
        "channels": [16, 32, 64, 128],
        "dim": 128,
        "backbone": {"name": "inline"},
        "input_channels": None,
        "max_num_keypoints": 1024,
        "detection_threshold": 0.01,
        "nms_radius": 2,
        "refinement_radius": 2,
        "line_neighborhood": 5.0,
        "use_angle_field": True,
        "extract_lines": False,
        "line_extractor": {"name": "lines.pold2_extractor"},
        "line_desc_samples": 0,
        "timeit": False,
        "loss": {
            "heatmap": "weighted_bce",
            "focal_gamma": 2.0,
            "kp_weight": 1.0,
            "df_weight": 1.0,
            "af_weight": 1.0,
            "desc_weight": 1.0,
            "pos_weight": 200.0,
            "desc_nll_weight": 0.0,
            "desc_nll_temp": 0.1,
            "desc_match_th": 3.0,
        },
    }
    unported_conf: ClassVar[frozenset] = frozenset({"backbone"})
    unported_note: ClassVar[str] = ("only the inline trunk is ported; the backbone_encoder "
                                    "trunks (vgg_unet, dinov2) are a later slice")
    required_data_keys: ClassVar[list] = ["image"]

    def __init__(self, conf: dict | None = None):
        super().__init__(conf)
        conf = self.conf
        if conf["loss"]["heatmap"] not in ("weighted_bce", "focal"):
            raise ValueError(f"unknown heatmap loss {conf['loss']['heatmap']!r}")
        c1, c2, c3, c4 = conf["channels"]
        dim = int(conf["dim"])
        # the JAX trunk infers its input width at init; a blob fixes it at 3
        self._trunk(int(conf["input_channels"] or 3), c1, c2, c3, c4, dim)
        feat = 4 * (dim // 4)
        self.kp1, self.kp2, self.kp3 = Conv(feat, 8, 1), Conv(8, 4, 3), Conv(4, 1, 3)
        self.df1, self.df2, self.df3 = Conv(feat, 16, 3), Conv(16, 8, 3), Conv(8, 1, 3)
        if conf["use_angle_field"]:
            self.af1, self.af3 = Conv(feat, 16, 3), Conv(16, 2, 3)
        self.desc_head = SDDH(feat, dim, k=3, M=16)
        self.line_extractor = (make_submodel(conf["line_extractor"]) if conf["extract_lines"]
                               else None)

    def backbone(self, image: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) image -> (B, dim, H, W) features."""
        ic = self.conf["input_channels"]
        if ic and image.shape[-1] != ic:
            if image.shape[-1] != 1:
                image = image.mean(dim=-1, keepdim=True)
            image = image.expand(*image.shape[:-1], int(ic))
        return self.features(image)

    def denormalize_df(self, df_norm: torch.Tensor) -> torch.Tensor:
        """Normalised [0, 1] (1 on a line) -> pixel distances."""
        return (1.0 - df_norm.clamp(0.0, 1.0)) * float(self.conf["line_neighborhood"])

    def normalize_df(self, df: torch.Tensor) -> torch.Tensor:
        r = float(self.conf["line_neighborhood"])
        return 1.0 - df.clamp(0.0, r) / r

    def _forward(self, data: dict) -> dict:
        conf = self.conf
        features = self.backbone(data["image"])
        heat_logits = self.kp3(F.selu(self.kp2(F.selu(self.kp1(features)))))[:, 0]
        heatmap = torch.sigmoid(heat_logits)
        df_norm = torch.sigmoid(self.df3(F.selu(self.df2(F.selu(self.df1(features))))))[:, 0]
        fmap = features.permute(0, 2, 3, 1)
        pred = {"heatmap": heatmap, "heatmap_logits": heat_logits,
                "distance_field_norm": df_norm, "distance_field": self.denormalize_df(df_norm),
                "backbone_features": fmap}
        if conf["use_angle_field"]:
            sc = self.af3(F.selu(self.af1(features))).permute(0, 2, 3, 1)
            angle = 0.5 * torch.atan2(sc[..., 0], sc[..., 1])
            pred["angle_field"] = torch.remainder(angle, math.pi)
            pred["angle_field_sincos"] = sc
        keypoints, scores, valid = select_top_k_keypoints(
            simple_nms(heatmap, int(conf["nms_radius"])), k=int(conf["max_num_keypoints"]),
            threshold=float(conf["detection_threshold"]), border=2,
            image_size=data.get("image_size"))
        if conf["refinement_radius"] > 0:
            keypoints = soft_argmax_refinement(keypoints, heatmap, int(conf["refinement_radius"]))
        pred.update(keypoints=keypoints + 0.5, keypoint_scores=scores, keypoint_valid=valid,
                    descriptors=self.desc_head(fmap, keypoints))
        if self.line_extractor is not None:
            line_data = {"keypoints": pred["keypoints"], "keypoint_valid": valid,
                         "distance_field": pred["distance_field"]}
            if conf["use_angle_field"]:
                line_data["angle_field"] = pred["angle_field"]
            pred.update(self.line_extractor(line_data))
            s = int(conf["line_desc_samples"])
            if s > 0:
                lines = pred["lines"]
                b, nl = lines.shape[:2]
                t = torch.linspace(0.0, 1.0, s, dtype=lines.dtype,
                                   device=lines.device)[None, None, :, None]
                pts = lines[:, :, None, 0] + (lines[:, :, 1] - lines[:, :, 0])[:, :, None] * t
                d = self.desc_head(fmap, pts.reshape(b, nl * s, 2))
                pred["line_desc_samples"] = d.reshape(b, nl, s, -1)
        return pred

    def loss(self, pred: dict, data: dict):
        conf = self.conf["loss"]
        losses = {}
        heat = pred.get("heatmap", pred.get("heatmap0"))
        total = torch.zeros(heat.shape[0], device=heat.device)
        if (float(conf.get("desc_nll_weight", 0.0)) > 0 and "H_0to1" in data
                and "keypoints0" in pred):
            v0, v1 = pred["keypoint_valid0"], pred["keypoint_valid1"]
            m0, m1 = mutual_detected_matches(pred["keypoints0"] - 0.5, pred["keypoints1"] - 0.5,
                                             v0, v1, data["H_0to1"],
                                             th=float(conf["desc_match_th"]))
            t = float(conf["desc_nll_temp"])
            nll = 0.5 * (nll_desc_loss(pred["descriptors0"], pred["descriptors1"], m0,
                                       temperature=t, valid0=v0)
                         + nll_desc_loss(pred["descriptors1"], pred["descriptors0"], m1,
                                         temperature=t, valid0=v1))
            losses["desc_nll"] = nll
            total = total + float(conf["desc_nll_weight"]) * nll
        if "gt_heatmap" in data:
            gt = data["gt_heatmap"]
            logits = pred["heatmap_logits"]
            bce = optax_sigmoid_bce(logits, gt)
            if conf["heatmap"] == "focal":
                p = torch.sigmoid(logits)
                pt = torch.where(gt > 0.5, p, 1 - p)
                bce = bce * (1 - pt) ** float(conf["focal_gamma"])
            w = torch.where(gt > 0.5, float(conf["pos_weight"]), 1.0)
            kp_loss = (bce * w).sum(dim=(1, 2)) / w.sum(dim=(1, 2))
            losses["heatmap"] = kp_loss
            total = total + float(conf["kp_weight"]) * kp_loss
        if "gt_distance_field" in data:
            gt_norm = self.normalize_df(data["gt_distance_field"])
            df_loss = (pred["distance_field_norm"] - gt_norm).abs().mean(dim=(1, 2))
            losses["df"] = df_loss
            total = total + float(conf["df_weight"]) * df_loss
        if self.conf["use_angle_field"] and "gt_angle_field" in data:
            near = (data["gt_distance_field"] < float(self.conf["line_neighborhood"])).to(heat.dtype)
            gt_a = data["gt_angle_field"]
            target = torch.stack([torch.sin(2 * gt_a), torch.cos(2 * gt_a)], dim=-1)
            af_err = (pred["angle_field_sincos"] - target).abs().sum(-1)
            af_loss = (af_err * near).sum(dim=(1, 2)) / near.sum(dim=(1, 2)).clamp_min(1.0)
            losses["af"] = af_loss
            total = total + float(conf["af_weight"]) * af_loss
        if "ref_descriptors" in data:
            sim = (pred["descriptors"] * data["ref_descriptors"]).sum(-1)
            mask = pred["keypoint_valid"].to(sim.dtype)
            d_loss = ((1.0 - sim) * mask).sum(-1) / mask.sum(-1).clamp_min(1.0)
            losses["desc_distill"] = d_loss
            total = total + float(conf["desc_weight"]) * d_loss
        losses["total"] = total
        return losses, {}


__main_model__ = JPLDD
