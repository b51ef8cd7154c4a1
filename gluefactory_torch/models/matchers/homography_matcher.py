"""Ground-truth matcher from a known homography, the ``ground_truth`` slot of
the two-view pipeline (gluefactory_tpu/models/matchers/homography_matcher.py).
Points only: line ground truth waits for the line slice of the port."""

from __future__ import annotations

from typing import ClassVar

from ...geometry.gt_generation import gt_matches_from_homography
from ..base_model import BaseModel


class HomographyMatcher(BaseModel):
    default_conf: ClassVar[dict] = {
        "use_points": True,
        "use_lines": False,
        "th_positive": 3.0,
        "th_negative": 6.0,
        "line_dist_th": 5.0,
        "line_overlap_th": 0.2,
    }
    unported_conf: ClassVar[frozenset] = frozenset({"line_dist_th", "line_overlap_th"})
    required_data_keys: ClassVar[list] = ["H_0to1", "keypoints0", "keypoints1"]

    def __init__(self, conf: dict | None = None):
        super().__init__(conf)
        if self.conf["use_lines"]:
            raise NotImplementedError("line ground truth is not ported")

    def _forward(self, data: dict) -> dict:
        if not self.conf["use_points"]:
            return {}
        result = gt_matches_from_homography(
            data["keypoints0"], data["keypoints1"], data["H_0to1"],
            image_size0=data.get("view0", {}).get("image_size"),
            image_size1=data.get("view1", {}).get("image_size"),
            valid0=data.get("keypoint_valid0"), valid1=data.get("keypoint_valid1"),
            pos_th=self.conf["th_positive"], neg_th=self.conf["th_negative"])
        return {"gt_" + k: v for k, v in result.items()}


__main_model__ = HomographyMatcher
