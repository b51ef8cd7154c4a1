"""SuperPoint keypoint detector and descriptor
(gluefactory_tpu/models/extractors/superpoint.py), inference only.

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
and the normalisation."""

from __future__ import annotations

from typing import ClassVar

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.interpolate import cell_logits_to_heatmap, sample_descriptors
from ...ops.nms import (
    com_refinement,
    select_top_k_keypoints,
    simple_nms,
    soft_argmax_refinement,
)
from ..base_model import BaseModel

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
    # inference with both heads is what is ported; the weights come from
    # utils/weights.py, not from a conf key
    unported_conf: ClassVar[frozenset] = frozenset({
        "has_detector", "has_descriptor", "dense_outputs", "training_outputs", "weights",
        "loss"})
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
        self.backbone = VGGBackbone(conf["channels"], conf["post_relu_affine"], cdt)
        self.convPa = Conv2d(c_feat, head, 3, padding=1, dtype=cdt)
        self.convPb = Conv2d(head, 65, 1, dtype=cdt)
        self.convDa = Conv2d(c_feat, head, 3, padding=1, dtype=cdt)
        self.convDb = Conv2d(head, conf["descriptor_dim"], 1, dtype=cdt)
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
            refine = (com_refinement if conf["refinement_mode"] == "com"
                      else soft_argmax_refinement)
            keypoints = refine(keypoints, heat_raw, conf["refinement_radius"])

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
