"""Ground-truth matcher from depth maps and a relative pose, points only
(gluefactory_tpu/models/matchers/depth_matcher.py). ``th_epi`` is held and
not read, as in the JAX package; line ground truth waits for the line
geometry."""

from __future__ import annotations

from typing import ClassVar

from ...geometry.gt_generation import gt_matches_from_pose_depth
from ..base_model import BaseModel


class DepthMatcher(BaseModel):
    default_conf: ClassVar[dict] = {
        "use_points": True,
        "use_lines": False,  # depth-reprojection ground truth of lines
        "th_positive": 3.0,
        "th_negative": 5.0,
        "th_epi": None,
        "line_dist_th": 5.0,
        "line_overlap_th": 0.2,
    }
    unported_conf: ClassVar[frozenset] = frozenset(
        {"use_lines", "line_dist_th", "line_overlap_th"})
    required_data_keys: ClassVar[list] = ["view0", "view1", "T_0to1"]

    def _forward(self, data: dict) -> dict:
        if not self.conf["use_points"]:
            return {}
        v0, v1 = data["view0"], data["view1"]
        result = gt_matches_from_pose_depth(
            data["keypoints0"], data["keypoints1"], v0["depth"], v1["depth"],
            v0["camera"], v1["camera"], data["T_0to1"],
            valid0=data.get("keypoint_valid0"), valid1=data.get("keypoint_valid1"),
            pos_th=self.conf["th_positive"], neg_th=self.conf["th_negative"])
        return {"gt_" + k: v for k, v in result.items()}

    def loss(self, pred: dict, data: dict):
        raise NotImplementedError


__main_model__ = DepthMatcher
