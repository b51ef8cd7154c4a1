"""Batched distances between line segments (gluefactory_tpu/geometry/lines.py,
its distance half): point-to-segment and point-to-line distances, the
orthogonal and structural segment distances, the overlap of a segment with
another's line and points sampled along segments. Segments are (..., L, 2,
2) endpoints; pairwise results are (..., L0, L1)."""

from __future__ import annotations

import torch


def point_to_seg_dist(points: torch.Tensor, segs: torch.Tensor) -> torch.Tensor:
    """Distance of points (..., N, 2) to segments (..., M, 2, 2) -> (..., N, M)."""
    a = segs[..., None, :, 0, :]
    b = segs[..., None, :, 1, :]
    p = points[..., :, None, :]
    ab = b - a
    t = (((p - a) * ab).sum(-1) / ((ab * ab).sum(-1) + 1e-8)).clamp(0.0, 1.0)
    return torch.linalg.vector_norm(p - (a + t[..., None] * ab), dim=-1)


def project_point_to_line(points: torch.Tensor, segs: torch.Tensor):
    """(distance of each point to each segment's infinite line, the
    position t of its projection along the segment: 0 at the first
    endpoint, 1 at the second)."""
    a = segs[..., None, :, 0, :]
    b = segs[..., None, :, 1, :]
    p = points[..., :, None, :]
    ab = b - a
    t = ((p - a) * ab).sum(-1) / ((ab * ab).sum(-1) + 1e-8)
    return torch.linalg.vector_norm(p - (a + t[..., None] * ab), dim=-1), t


def _endpoints(segs: torch.Tensor) -> torch.Tensor:
    return segs.reshape(*segs.shape[:-3], -1, 2)


def orth_line_dist(segs0: torch.Tensor, segs1: torch.Tensor) -> torch.Tensor:
    """The mean distance of a segment's endpoints to the other's line, both
    ways and averaged."""
    d01, _ = project_point_to_line(_endpoints(segs0), segs1)
    d01 = 0.5 * (d01[..., 0::2, :] + d01[..., 1::2, :])
    d10, _ = project_point_to_line(_endpoints(segs1), segs0)
    d10 = 0.5 * (d10[..., 0::2, :] + d10[..., 1::2, :])
    return 0.5 * (d01 + d10.transpose(-1, -2))


def struct_line_dist(segs0: torch.Tensor, segs1: torch.Tensor) -> torch.Tensor:
    """Half the summed endpoint distances, the better of the two endpoint
    orderings."""
    a0, b0 = segs0[..., :, None, 0, :], segs0[..., :, None, 1, :]
    a1, b1 = segs1[..., None, :, 0, :], segs1[..., None, :, 1, :]
    norm = torch.linalg.vector_norm
    d_s = norm(a0 - a1, dim=-1) + norm(b0 - b1, dim=-1)
    d_f = norm(a0 - b1, dim=-1) + norm(b0 - a1, dim=-1)
    return 0.5 * torch.minimum(d_s, d_f)


def overlap_fraction(segs0: torch.Tensor, segs1: torch.Tensor) -> torch.Tensor:
    """The share of each segment of segs0, projected onto a segment of
    segs1's line, that falls inside that segment."""
    _, t = project_point_to_line(_endpoints(segs0), segs1)
    t0, t1 = t[..., 0::2, :], t[..., 1::2, :]
    lo, hi = torch.minimum(t0, t1), torch.maximum(t0, t1)
    inter = (torch.minimum(hi, torch.ones_like(hi)) - lo.clamp_min(0.0)).clamp_min(0.0)
    return inter / (hi - lo).clamp_min(1e-8)


def sample_points_on_lines(lines: torch.Tensor, n_samples: int) -> torch.Tensor:
    """(..., L, 2, 2) -> (..., L, n_samples, 2) evenly spaced from the first
    endpoint to the second."""
    t = torch.linspace(0.0, 1.0, n_samples, dtype=lines.dtype, device=lines.device)
    a = lines[..., 0, :][..., None, :]
    b = lines[..., 1, :][..., None, :]
    return a + t[:, None] * (b - a)
