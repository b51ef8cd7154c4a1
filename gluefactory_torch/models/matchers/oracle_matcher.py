"""Oracle matcher (gluefactory_tpu/models/matchers/oracle_matcher.py): the
ground-truth matches of a homography (``source: homography``) or of depth
and pose (``source: depth``) as predictions, with unit scores: an upper
bound for the later slots of a benchmark. The ignore code -2 becomes -1."""

from __future__ import annotations

from typing import ClassVar

import torch

from ...geometry.gt_generation import gt_matches_from_homography, gt_matches_from_pose_depth
from ..base_model import BaseModel


class OracleMatcher(BaseModel):
    default_conf: ClassVar[dict] = {
        "source": "homography",  # homography | depth
        "th_positive": 3.0,
        "trainable": False,
    }
    required_data_keys: ClassVar[list] = ["keypoints0", "keypoints1"]

    def _forward(self, data: dict) -> dict:
        valid = {"valid0": data.get("keypoint_valid0"), "valid1": data.get("keypoint_valid1")}
        if self.conf["source"] == "homography":
            out = gt_matches_from_homography(data["keypoints0"], data["keypoints1"],
                                             data["H_0to1"], pos_th=self.conf["th_positive"],
                                             **valid)
        else:
            v0, v1 = data["view0"], data["view1"]
            out = gt_matches_from_pose_depth(
                data["keypoints0"], data["keypoints1"], v0["depth"], v1["depth"],
                v0["camera"], v1["camera"], data["T_0to1"], pos_th=self.conf["th_positive"],
                **valid)
        m0 = torch.where(out["matches0"] >= 0, out["matches0"], -1)
        m1 = torch.where(out["matches1"] >= 0, out["matches1"], -1)
        return {"matches0": m0, "matches1": m1,
                "matching_scores0": (m0 >= 0).float(), "matching_scores1": (m1 >= 0).float()}

    def loss(self, pred, data):
        raise NotImplementedError


__main_model__ = OracleMatcher
