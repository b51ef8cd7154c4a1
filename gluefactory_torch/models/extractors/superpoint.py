"""SuperPoint keypoint detector and descriptor
(gluefactory_tpu/models/extractors/superpoint.py), inference only.

The network runs NCHW inside. Inputs and outputs keep the JAX package's
layout and keys: ``image`` (B, H, W, C) in, ``keypoints`` (B, K, 2) with the
+0.5 pixel-center convention, ``keypoint_scores``, ``keypoint_valid`` and
``descriptors`` (B, K, D) out, K = ``max_num_keypoints`` slots."""

from __future__ import annotations

from typing import ClassVar

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.interpolate import cell_logits_to_heatmap, sample_descriptors
from ...ops.nms import com_refinement, select_top_k_keypoints, simple_nms
from ..base_model import BaseModel

_GRAY = (0.299, 0.587, 0.114)  # cv2 / ITU-R 601 weights


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

    def __init__(self, channels: list[int], post_relu_affine: bool = False):
        super().__init__()
        self.post_relu_affine = post_relu_affine
        c_in = 1
        for i, ch in enumerate(channels):
            self.add_module(f"conv{i}", nn.Conv2d(c_in, ch, 3, padding=1))
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
        "descriptor_dim": 256,
        "max_num_keypoints": 1024,
        "nms_radius": 4,
        "detection_threshold": 0.005,
        "remove_borders": 4,
        "refinement_radius": 0,
        "refinement_mode": "softargmax",
        "desc_sampling": "center",
        "post_relu_affine": False,
        "channels": [64, 64, 64, 64, 128, 128, 128, 128],
        "head_channels": 256,
    }
    required_data_keys: ClassVar[list] = ["image"]

    def __init__(self, conf: dict | None = None):
        super().__init__(conf)
        conf = self.conf
        if conf["refinement_radius"] > 0 and conf["refinement_mode"] != "com":
            raise NotImplementedError("only refinement_mode='com' is ported")
        c_feat = conf["channels"][-1]
        head = conf["head_channels"]
        self.backbone = VGGBackbone(conf["channels"], conf["post_relu_affine"])
        self.convPa = nn.Conv2d(c_feat, head, 3, padding=1)
        self.convPb = nn.Conv2d(head, 65, 1)
        self.convDa = nn.Conv2d(c_feat, head, 3, padding=1)
        self.convDb = nn.Conv2d(head, conf["descriptor_dim"], 1)
        if conf["post_relu_affine"]:
            self.affinePa = ChannelAffine(head)
            self.affineDa = ChannelAffine(head)

    def _forward(self, data: dict) -> dict:
        conf = self.conf
        image = data["image"]
        if image.shape[-1] == 3:
            image = (image * image.new_tensor(_GRAY)).sum(dim=-1, keepdim=True)
        features = self.backbone(image.permute(0, 3, 1, 2))

        pa = F.relu(self.convPa(features))
        if conf["post_relu_affine"]:
            pa = self.affinePa(pa)
        logits = self.convPb(pa).permute(0, 2, 3, 1).float()  # (B, Hc, Wc, 65)
        heat_raw = cell_logits_to_heatmap(logits)
        keypoints, scores, valid = select_top_k_keypoints(
            simple_nms(heat_raw, conf["nms_radius"]),
            k=conf["max_num_keypoints"],
            threshold=conf["detection_threshold"],
            border=conf["remove_borders"],
            image_size=data.get("image_size"),
        )
        if conf["refinement_radius"] > 0:
            # on the pre-NMS heatmap: NMS zeroes the window the refinement reads
            keypoints = com_refinement(keypoints, heat_raw, conf["refinement_radius"])

        da = F.relu(self.convDa(features))
        if conf["post_relu_affine"]:
            da = self.affineDa(da)
        dense = self.convDb(da).float()
        dense = dense / (torch.linalg.vector_norm(dense, dim=1, keepdim=True) + 1e-8)
        keypoints = keypoints + 0.5  # pixel-center convention
        descriptors = sample_descriptors(dense.permute(0, 2, 3, 1), keypoints - 0.5,
                                         stride=8, mode=conf["desc_sampling"])
        return {
            "keypoints": keypoints,
            "keypoint_scores": scores,
            "keypoint_valid": valid,
            "descriptors": descriptors,
        }


__main_model__ = SuperPoint
