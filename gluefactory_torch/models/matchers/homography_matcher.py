"""Ground-truth matcher from a known homography, the ``ground_truth`` slot of
the two-view pipeline (gluefactory_tpu/models/matchers/homography_matcher.py):
point matches (``gt_matches*``) and, with ``use_lines`` and lines in the
data, line matches (``gt_line_matches*``, ``gt_line_assignment``:
geometry/lines.gt_line_matches_from_homography)."""

from __future__ import annotations

from typing import ClassVar

import torch

from ...geometry.gt_generation import gt_matches_from_homography
from ...geometry.lines import gt_line_matches_from_homography
from ..base_model import BaseModel


def valid_lines(data: dict, i: int) -> torch.Tensor:
    """``valid_lines{i}``, or every line of view i where the data has none."""
    valid = data.get(f"valid_lines{i}")
    if valid is None:
        lines = data[f"lines{i}"]
        valid = torch.ones(lines.shape[:2], dtype=torch.bool, device=lines.device)
    return valid


class HomographyMatcher(BaseModel):
    default_conf: ClassVar[dict] = {
        "use_points": True,
        "use_lines": False,
        "th_positive": 3.0,
        "th_negative": 6.0,
        "line_dist_th": 5.0,
        "line_overlap_th": 0.2,
    }
    required_data_keys: ClassVar[list] = ["H_0to1", "keypoints0", "keypoints1"]

    def _forward(self, data: dict) -> dict:
        pred = {}
        if self.conf["use_points"]:
            result = gt_matches_from_homography(
                data["keypoints0"], data["keypoints1"], data["H_0to1"],
                image_size0=data.get("view0", {}).get("image_size"),
                image_size1=data.get("view1", {}).get("image_size"),
                valid0=data.get("keypoint_valid0"), valid1=data.get("keypoint_valid1"),
                pos_th=self.conf["th_positive"], neg_th=self.conf["th_negative"])
            pred.update({"gt_" + k: v for k, v in result.items()})
        if self.conf["use_lines"] and "lines0" in data:
            result = gt_line_matches_from_homography(
                data["lines0"], data["lines1"], valid_lines(data, 0), valid_lines(data, 1),
                data["H_0to1"], dist_th=float(self.conf["line_dist_th"]),
                overlap_th=float(self.conf["line_overlap_th"]))
            pred.update({"gt_" + k: v for k, v in result.items()})
        return pred


__main_model__ = HomographyMatcher
