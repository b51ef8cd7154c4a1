"""The ground-truth line matcher of a homography
(gluefactory_tpu/models/matchers/line_matcher.py): the segments of view 0
sampled, warped by ``H_0to1`` and matched to view 1's by
``geometry.lines.gt_line_matches_from_homography``; every key takes the
``gt_`` prefix, for the ground-truth slot of a pipeline."""

from __future__ import annotations

from typing import ClassVar

import torch

from ...geometry.lines import gt_line_matches_from_homography
from ..base_model import BaseModel


class LineMatcher(BaseModel):
    default_conf: ClassVar[dict] = {"dist_th": 5.0, "overlap_th": 0.2, "n_samples": 16,
                                    "trainable": False}
    required_data_keys: ClassVar[list] = ["lines0", "lines1", "H_0to1"]

    def _forward(self, data: dict) -> dict:
        lines0, lines1 = data["lines0"], data["lines1"]

        def valid(i, lines):
            v = data.get(f"valid_lines{i}")
            return (torch.ones(lines.shape[:2], dtype=torch.bool, device=lines.device)
                    if v is None else v)

        out = gt_line_matches_from_homography(
            lines0, lines1, valid(0, lines0), valid(1, lines1), data["H_0to1"],
            n_samples=int(self.conf["n_samples"]), dist_th=float(self.conf["dist_th"]),
            overlap_th=float(self.conf["overlap_th"]))
        return {k if k.startswith("gt_") else f"gt_{k}": v for k, v in out.items()}


__main_model__ = LineMatcher
