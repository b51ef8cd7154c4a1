"""One-to-one segment matching and its metrics (gluefactory_tpu/eval/line_metrics.py):
the distance matrices of two segment sets (orthogonal with a mutual-overlap
gate, structural, area), their exact one-to-one assignment (``ops.lap``),
repeatability and localisation error. The distance matrices are torch on the
segments' device; the assignment and the metrics are numpy in float64, as the
JAX package computes them."""

from __future__ import annotations

import numpy as np
import torch

from ..geometry.lines import (
    area_line_dist,
    host_array,
    orth_line_dist,
    overlap_fraction,
    struct_line_dist,
)
from ..ops.lap import batch_linear_assignment

BIG = 1e9


def segment_distance_matrix(segs0: torch.Tensor, segs1: torch.Tensor, kind: str = "orth",
                            min_overlap: float = 0.5) -> torch.Tensor:
    """(B, L0, 2, 2) x (B, L1, 2, 2) -> (B, L0, L1) distances: 'struct' the
    structural distance, 'area' the area distance, 'orth' the orthogonal
    distance where the smaller of the two overlaps (each segment projected
    onto the other's line) reaches ``min_overlap``, else ``BIG``."""
    if kind == "struct":
        return struct_line_dist(segs0, segs1)
    if kind == "area":
        return area_line_dist(segs0, segs1)
    d = orth_line_dist(segs0, segs1)
    ov = torch.minimum(overlap_fraction(segs0, segs1),
                       overlap_fraction(segs1, segs0).transpose(-1, -2))
    return torch.where(ov >= min_overlap, d, BIG)


def match_segments_one_to_one(dist, valid0, valid1) -> tuple[np.ndarray, np.ndarray]:
    """The one-to-one assignment of least total distance (rows <= columns).
    dist (B, L0, L1) -> (assign (B, L0): the column or -1, match_dist (B,
    L0): its distance or inf). Pairs with an invalid segment cost ``BIG``; a
    row assigned at ``BIG / 2`` or more is unmatched."""
    dist = host_array(dist).astype(np.float64)
    valid0, valid1 = host_array(valid0).astype(bool), host_array(valid1).astype(bool)
    dist[~valid0[:, :, None] | ~valid1[:, None, :]] = BIG
    assign = batch_linear_assignment(dist)
    b_idx = np.arange(dist.shape[0])[:, None]
    match_dist = dist[b_idx, np.arange(dist.shape[1])[None], np.clip(assign, 0, None)]
    bad = (assign < 0) | ~valid0 | (match_dist >= BIG / 2)
    return np.where(bad, -1, assign), np.where(bad, np.inf, match_dist)


def segment_repeatability(match_dist: np.ndarray, n0: np.ndarray, n1: np.ndarray,
                          thresholds: list[float]) -> dict[str, np.ndarray]:
    """The share of matched segments within each threshold, over
    min(n0, n1) of each image: ``rep@<t>``."""
    denom = np.maximum(np.minimum(n0, n1), 1)
    return {f"rep@{t}": (np.asarray(match_dist) <= t).sum(-1) / denom for t in thresholds}


def segment_localization_error(match_dist: np.ndarray, thresholds: list[float]
                               ) -> dict[str, np.ndarray]:
    """The mean distance of the matches below each threshold, NaN where
    there is none: ``loc@<t>``."""
    md = np.asarray(match_dist)
    out = {}
    for t in thresholds:
        sel = md < t
        vals = np.where(sel, md, 0.0)  # inf * False would poison the sum
        out[f"loc@{t}"] = np.where(sel.any(-1), vals.sum(-1) / np.maximum(sel.sum(-1), 1),
                                   np.nan)
    return out
