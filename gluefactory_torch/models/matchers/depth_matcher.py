"""Ground-truth matcher from depth maps and a relative pose
(gluefactory_tpu/models/matchers/depth_matcher.py): point matches and, with
``use_lines`` and lines in the data, line matches
(geometry/lines.gt_line_matches_from_pose_depth). ``th_epi`` is held and
not read, as in the JAX package."""

from __future__ import annotations

from typing import ClassVar

from ...geometry.gt_generation import gt_matches_from_pose_depth
from ...geometry.lines import gt_line_matches_from_pose_depth
from ..base_model import BaseModel
from .homography_matcher import valid_lines


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
    required_data_keys: ClassVar[list] = ["view0", "view1", "T_0to1"]

    def _forward(self, data: dict) -> dict:
        pred = {}
        v0, v1 = data["view0"], data["view1"]
        if self.conf["use_lines"] and "lines0" in data:
            result = gt_line_matches_from_pose_depth(
                data["lines0"], data["lines1"], valid_lines(data, 0), valid_lines(data, 1),
                v0["depth"], v1["depth"], v0["camera"], v1["camera"], data["T_0to1"],
                dist_th=float(self.conf["line_dist_th"]),
                overlap_th=float(self.conf["line_overlap_th"]))
            pred.update({"gt_" + k: v for k, v in result.items()})
        if self.conf["use_points"]:
            result = gt_matches_from_pose_depth(
                data["keypoints0"], data["keypoints1"], v0["depth"], v1["depth"],
                v0["camera"], v1["camera"], data["T_0to1"],
                valid0=data.get("keypoint_valid0"), valid1=data.get("keypoint_valid1"),
                pos_th=self.conf["th_positive"], neg_th=self.conf["th_negative"])
            pred.update({"gt_" + k: v for k, v in result.items()})
        return pred

    def loss(self, pred: dict, data: dict):
        raise NotImplementedError


__main_model__ = DepthMatcher
