"""The POLD2 line extractor (gluefactory_tpu/models/lines/pold2_extractor.py):
lines from keypoints and a distance field.

Every pair of the first ``max_num_points`` valid keypoints at least
``min_length`` apart is a candidate (C = N (N - 1) / 2, in row-major pair
order). A candidate survives when the distance field (DF), sampled
bilinearly at ``coarse_samples`` points along it, is below ``df_inlier_th``
on at least ``coarse_inlier_ratio`` of them with a mean at most
``mean_df_th``, the same holds for ``fine_inlier_ratio`` of
``fine_samples`` points, and, with ``use_angle_field``, the angle field
along it stays within ``af_th`` of the segment's direction on average. The
``max_num_lines`` best survivors by length (or by DF quality,
``selection_score: inlier``) take the line slots: a stable descending sort,
so that candidates of equal score keep their pair order, as JAX's stable
``argsort`` does. With ``collinear_nms`` a line is dropped where a longer
valid line (the lower slot among equal lengths) lies on the same infinite
line (orthogonal distance under ``nms_orth_tol``) and overlaps it (more
than ``nms_overlap``)."""

from __future__ import annotations

import math
from typing import ClassVar

import torch

from ...geometry.lines import orth_line_dist, overlap_fraction
from ...ops.interpolate import bilinear_sample
from ..base_model import BaseModel
from .sold2 import pair_indices

__all__ = ["POLD2Extractor", "pair_indices", "sample_field_along_segments"]


def sample_field_along_segments(field: torch.Tensor, p0: torch.Tensor, p1: torch.Tensor,
                                n_samples: int) -> torch.Tensor:
    """A scalar field (B, H, W) sampled at ``n_samples`` points along each
    segment p0 -> p1 (B, C, 2): (B, C, S)."""
    t = torch.linspace(0.0, 1.0, n_samples, dtype=p0.dtype, device=p0.device)
    pts = p0[:, :, None, :] + t[None, None, :, None] * (p1 - p0)[:, :, None, :]
    b, c, s, _ = pts.shape
    return bilinear_sample(field[..., None], pts.reshape(b, c * s, 2))[..., 0].reshape(b, c, s)


class POLD2Extractor(BaseModel):
    default_conf: ClassVar[dict] = {
        "max_num_points": 250,
        "max_num_lines": 512,
        "coarse_samples": 24,
        "fine_samples": 64,
        "df_inlier_th": 2.0,
        "coarse_inlier_ratio": 0.9,
        "fine_inlier_ratio": 0.95,
        "mean_df_th": 1.5,
        "use_angle_field": False,
        "af_th": 0.3,
        "min_length": 8.0,
        "selection_score": "length",
        "collinear_nms": True,
        "nms_orth_tol": 2.0,
        "nms_overlap": 0.2,
        "trainable": False,
    }
    required_data_keys: ClassVar[list] = ["keypoints", "distance_field"]

    def _forward(self, data: dict) -> dict:
        conf = self.conf
        n_max = int(conf["max_num_points"])
        kpts = data["keypoints"][:, :n_max]
        kp_valid = data.get("keypoint_valid")
        kp_valid = (torch.ones(kpts.shape[:-1], dtype=torch.bool, device=kpts.device)
                    if kp_valid is None else kp_valid[:, :n_max])
        df = data["distance_field"]
        pairs = torch.from_numpy(pair_indices(kpts.shape[1])).long().to(kpts.device)
        p0, p1 = kpts[:, pairs[:, 0]], kpts[:, pairs[:, 1]]
        length = torch.linalg.vector_norm(p1 - p0, dim=-1)
        keep = (kp_valid[:, pairs[:, 0]] & kp_valid[:, pairs[:, 1]]
                & (length >= float(conf["min_length"])))
        th = float(conf["df_inlier_th"])
        vals = sample_field_along_segments(df, p0, p1, int(conf["coarse_samples"]))
        mean_df = vals.mean(-1)
        keep = (keep & ((vals < th).float().mean(-1) >= float(conf["coarse_inlier_ratio"]))
                & (mean_df <= float(conf["mean_df_th"])))
        inlier_f = (sample_field_along_segments(df, p0, p1, int(conf["fine_samples"])) < th
                    ).float().mean(-1)
        keep = keep & (inlier_f >= float(conf["fine_inlier_ratio"]))
        if conf["use_angle_field"] and "angle_field" in data:
            ang = sample_field_along_segments(data["angle_field"], p0, p1,
                                              int(conf["coarse_samples"]))
            d = p1 - p0
            seg_ang = torch.remainder(torch.atan2(d[..., 1], d[..., 0]), math.pi)[..., None]
            diff = (torch.remainder(ang, math.pi) - seg_ang).abs()
            diff = torch.minimum(diff, math.pi - diff)
            keep = keep & (diff.mean(-1) < float(conf["af_th"]))
        if conf["selection_score"] == "length":
            score = torch.where(keep, length, -1.0)
        else:
            score = torch.where(keep, inlier_f * (1.0 / (1.0 + mean_df)), -1.0)
        n_lines = int(conf["max_num_lines"])
        idx = torch.sort(-score, dim=-1, stable=True).indices[:, :n_lines]
        top = score.gather(1, idx)
        lines = torch.stack([p0.gather(1, idx[..., None].expand(-1, -1, 2)),
                             p1.gather(1, idx[..., None].expand(-1, -1, 2))], dim=-2)
        valid = top > 0
        if conf["collinear_nms"]:
            valid = valid & ~self._collinear_dominated(lines, valid)
        return {"lines": torch.where(valid[..., None, None], lines, 0.0),
                "line_scores": torch.where(valid, top, 0.0), "valid_lines": valid}

    def _collinear_dominated(self, lines: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        """(B, L) mask of the lines that a longer valid line (the lower slot
        among equal lengths) on the same infinite line overlaps."""
        conf = self.conf
        length = torch.linalg.vector_norm(lines[..., 1, :] - lines[..., 0, :], dim=-1)
        ov = overlap_fraction(lines, lines)
        same = ((orth_line_dist(lines, lines) < float(conf["nms_orth_tol"]))
                & (torch.maximum(ov, ov.transpose(-1, -2)) > float(conf["nms_overlap"])))
        idx = torch.arange(length.shape[-1], device=lines.device)
        longer = (length[..., None, :] > length[..., :, None]) | (
            (length[..., None, :] == length[..., :, None]) & (idx[None, :] < idx[:, None]))
        return (same & longer & valid[..., None, :]).any(dim=-1)

    def loss(self, pred: dict, data: dict):
        raise NotImplementedError


__main_model__ = POLD2Extractor
