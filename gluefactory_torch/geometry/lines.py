"""Batched distances between line segments and the ground-truth line matches
(gluefactory_tpu/geometry/lines.py): point-to-segment and point-to-line
distances, the orthogonal and structural segment distances, the overlap of a
segment with another's line, points sampled along segments, and the line
ground truth of a homography or of depth maps and a relative pose. Segments
are (..., L, 2, 2) endpoints; pairwise results are (..., L0, L1).

The ground truth samples points along each segment of view 0, carries them
into view 1, and matches segments by the mean distance of those points to
each segment of view 1, gated by the overlap of the carried segment with it;
a pair is matched where each is the other's cheapest (the first index on
ties, as JAX's ``argmin``) and the cost is below ``dist_th``. Codes: the
matched index, ``UNMATCHED`` (-1) or ``IGNORE`` (-2) for an invalid segment
(with depth, also one whose samples are mostly not seen in view 1).

Beside them: the exact one-to-one assignment of a cost matrix on the host
(``gt_line_matches_exact``, through ``ops.lap``), the merge of overlapping
near-collinear segments (``merge_lines``) and the area distance of segments
(``area_line_dist``)."""

from __future__ import annotations

import numpy as np
import torch

from .homography import warp_points

UNMATCHED = -1
IGNORE = -2


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


def _greedy_mutual_assignment(cost: torch.Tensor, valid_pair: torch.Tensor, th: float):
    """Mutual-min assignment of (..., L0, L1) costs over the valid pairs:
    (pos0, pos1, arg0, arg1), where arg0 (arg1) is each row's (column's)
    cheapest column (row), the first on ties and 0 on a row without a valid
    pair, and pos0 (pos1) holds where that choice is mutual and cheaper than
    ``th``."""
    c = cost.masked_fill(~valid_pair, float("inf"))
    l0, l1 = c.shape[-2], c.shape[-1]
    min0, arg0 = c.min(dim=-1)
    min1, arg1 = c.min(dim=-2)
    mutual0 = arg1.gather(-1, arg0) == torch.arange(l0, device=c.device)
    mutual1 = arg0.gather(-1, arg1) == torch.arange(l1, device=c.device)
    return mutual0 & (min0 < th), mutual1 & (min1 < th), arg0, arg1


def _codes(pos0, pos1, arg0, arg1, known0, valid1) -> dict:
    """The match codes of both views and the (..., L0, L1) assignment."""
    l1 = pos1.shape[-1]
    unmatched = torch.tensor(UNMATCHED, device=arg0.device)
    ignore = torch.tensor(IGNORE, device=arg0.device)
    m0 = torch.where(pos0, arg0, torch.where(known0, unmatched, ignore))
    m1 = torch.where(pos1, arg1, torch.where(valid1, unmatched, ignore))
    assignment = (pos0[..., :, None] & (torch.arange(l1, device=arg0.device) == arg0[..., :, None])
                  & pos1[..., None, :])
    return {"line_matches0": m0.to(torch.int32), "line_matches1": m1.to(torch.int32),
            "line_assignment": assignment}


def gt_line_matches_from_pose_depth(lines0, lines1, valid0, valid1, depth0, depth1, camera0,
                                    camera1, T_0to1, n_samples: int = 16, dist_th: float = 5.0,
                                    overlap_th: float = 0.2, min_visible: float = 0.5) -> dict:
    """Line ground truth from depth maps and a relative pose: ``n_samples``
    points along each segment of view 0 lifted by ``depth0`` and projected
    into view 1 (kept where ``depth1`` agrees within 5%); a segment with
    fewer than ``min_visible`` of its samples kept is IGNORE. The cost is
    the mean distance of the kept samples to a segment of view 1; the
    overlap gate takes the span from the first kept sample to the last."""
    from .depth import project, sample_depth

    b, l0 = lines0.shape[:2]
    l1 = lines1.shape[1]
    pts0 = sample_points_on_lines(lines0, n_samples).reshape(b, l0 * n_samples, 2)
    d0, dvalid = sample_depth(pts0, depth0)
    pts0_in1, pvalid = project(pts0, d0, depth1, camera0, camera1, T_0to1, dvalid, ccth=0.05)
    pvalid = pvalid.reshape(b, l0, n_samples)
    pts0_in1 = pts0_in1.reshape(b, l0, n_samples, 2)
    visible0 = (pvalid.float().mean(dim=-1) >= min_visible) & valid0
    d = point_to_seg_dist(pts0_in1.reshape(b, l0 * n_samples, 2), lines1)
    d = d.reshape(b, l0, n_samples, l1)
    w = pvalid[..., None].to(d.dtype)
    mean_d = (d * w).sum(dim=2) / w.sum(dim=2).clamp_min(1.0)
    # the first and last kept sample (argmax takes the first maximum, 0 if none)
    kept = pvalid.to(torch.uint8)
    first = kept.argmax(dim=-1)
    last = n_samples - 1 - kept.flip(-1).argmax(dim=-1)

    def at(idx):
        return pts0_in1.gather(2, idx[..., None, None].expand(-1, -1, 1, 2))[:, :, 0]

    ov = overlap_fraction(torch.stack([at(first), at(last)], dim=-2), lines1)
    valid_pair = visible0[..., :, None] & valid1[..., None, :] & (ov > overlap_th)
    return _codes(*_greedy_mutual_assignment(mean_d, valid_pair, dist_th), visible0, valid1)


def gt_line_matches_from_homography(lines0, lines1, valid0, valid1, H_0to1,
                                    n_samples: int = 16, dist_th: float = 5.0,
                                    overlap_th: float = 0.2) -> dict:
    """Line ground truth from a homography: ``n_samples`` points along each
    segment of view 0 warped into view 1; the cost is their mean distance to
    a segment of view 1, the overlap gate that of the warped segment."""
    b, l0 = lines0.shape[:2]
    l1 = lines1.shape[1]
    pts0 = sample_points_on_lines(lines0, n_samples)
    pts0_in1 = warp_points(pts0.reshape(b, -1, 2), H_0to1).reshape(b, l0, n_samples, 2)
    d = point_to_seg_dist(pts0_in1.reshape(b, l0 * n_samples, 2), lines1)
    cost = d.reshape(b, l0, n_samples, l1).mean(dim=2)
    warped = torch.stack([pts0_in1[..., 0, :], pts0_in1[..., -1, :]], dim=-2)
    ov = overlap_fraction(warped, lines1)
    valid_pair = valid0[..., :, None] & valid1[..., None, :] & (ov > overlap_th)
    return _codes(*_greedy_mutual_assignment(cost, valid_pair, dist_th), valid0, valid1)


def host_array(x) -> np.ndarray:
    """A tensor (on any device) or an array as a numpy array."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def gt_line_matches_exact(cost, valid_pair, th: float) -> np.ndarray:
    """The exact one-to-one assignment of (B, L0, L1) costs on the host
    (``ops.lap``, L0 <= L1): invalid pairs cost ``BIG`` = 1e6, and a row
    keeps its column where that cost is below ``th``, else UNMATCHED.
    Returns m0 (B, L0) int32."""
    from ..ops.lap import batch_linear_assignment

    BIG = 1e6
    c = np.where(host_array(valid_pair), host_array(cost), BIG).astype(np.float32)
    m0 = batch_linear_assignment(c)
    b_idx = np.arange(c.shape[0])[:, None]
    chosen = c[b_idx, np.arange(c.shape[1])[None], np.clip(m0, 0, None)]
    return np.where((m0 >= 0) & (chosen < th), m0, UNMATCHED).astype(np.int32)


def merge_lines(segs: torch.Tensor, valid: torch.Tensor, thresh: float = 5.0,
                n_iters: int = 8) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge overlapping near-collinear segments. Two valid segments are
    joined where they overlap (either onto the other's line) and their
    orthogonal distance is below ``thresh``; clusters are the components of
    that graph, found by ``n_iters`` steps of min-label propagation (chains
    up to 2^8 segments). Each cluster becomes one segment along its members'
    length-weighted mean direction (each sign-aligned to the longest
    member's), through their length-weighted mean midpoint, spanning the
    projections of all their endpoints; it lives in the cluster's
    lowest-index slot. segs (B, L, 2, 2), valid (B, L) -> (merged (B, L, 2,
    2), merged_valid (B, L))."""
    b, n = segs.shape[:2]
    dev = segs.device
    orth = orth_line_dist(segs, segs)
    ov01 = overlap_fraction(segs, segs)
    ov = torch.maximum(ov01, ov01.transpose(-1, -2))
    pair_valid = valid[:, :, None] & valid[:, None, :]
    adj = (ov > 0.0) & (orth < thresh) & pair_valid
    adj = adj | (torch.eye(n, dtype=torch.bool, device=dev)[None] & valid[:, :, None])
    idx = torch.arange(n, device=dev)
    labels = torch.where(valid, idx[None], n)
    for _ in range(n_iters):
        neigh = torch.where(adj, labels[:, None, :], n)
        labels = torch.minimum(labels, neigh.min(dim=-1).values)
    onehot = (labels[:, :, None] == idx[None, None]) & valid[:, :, None]
    onehot_f = onehot.to(segs.dtype)  # (B, L members, L clusters)
    d = segs[:, :, 1] - segs[:, :, 0]
    length = torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    u = d / length.clamp_min(1e-8)
    w = onehot_f * length[:, :, 0][:, :, None]  # length-weighted membership
    seed_idx = w.argmax(dim=1)  # the longest member of each cluster (the first on ties)
    seed_u = u.gather(1, seed_idx[..., None].expand(-1, -1, 2))
    sign = torch.sign(torch.einsum("bld,bcd->blc", u, seed_u) + 1e-12)
    mean_u = torch.einsum("blc,bld->bcd", w * sign, u)
    mean_u = mean_u / torch.linalg.vector_norm(mean_u, dim=-1, keepdim=True).clamp_min(1e-8)
    center = torch.einsum("blc,bld->bcd", w, 0.5 * (segs[:, :, 0] + segs[:, :, 1]))
    center = center / w.sum(dim=1)[..., None].clamp_min(1e-8)
    eps = segs.reshape(b, 2 * n, 2)
    t = torch.einsum("becd,bcd->bec", eps[:, :, None, :] - center[:, None, :, :], mean_u)
    member = onehot_f.repeat_interleave(2, dim=1) > 0  # (B, 2L, C)
    t_min = torch.where(member, t, float("inf")).min(dim=1).values
    t_max = torch.where(member, t, float("-inf")).max(dim=1).values
    merged = torch.stack([center + t_min[..., None] * mean_u,
                          center + t_max[..., None] * mean_u], dim=2)
    merged_valid = (labels == idx[None]) & valid
    merged = torch.where(merged_valid[..., None, None], merged, 0.0)
    return torch.where(torch.isfinite(merged), merged, 0.0), merged_valid


def area_line_dist(segs0: torch.Tensor, segs1: torch.Tensor, lbd: float = 1.0 / 24.0
                   ) -> torch.Tensor:
    """The length-unbiased area distance of segments, symmetrised over both
    directions: asym(a, b) takes the heights h0, h1 of b's endpoints over
    a's infinite line and the angle theta between the two (as ``arctan2``
    of the sine and cosine, exact at theta = 0); where the segments cross,
    the two enclosed triangles (h0^2 + h1^2) / (2 tan(theta) len(b)^2) (0
    for parallel segments), else lbd * min(h0, h1) + sin(2 theta) / 4.
    (..., L0, L1)."""

    def orient(p, q, r):
        return torch.sign((q[..., 0] - p[..., 0]) * (r[..., 1] - p[..., 1])
                          - (q[..., 1] - p[..., 1]) * (r[..., 0] - p[..., 0]))

    def unit(d):
        return d / torch.linalg.vector_norm(d, dim=-1, keepdim=True).clamp_min(1e-8)

    def asym(a, b):
        a0, a1 = a[..., :, None, 0, :], a[..., :, None, 1, :]
        b0, b1 = b[..., None, :, 0, :], b[..., None, :, 1, :]
        ua = unit(a[..., 1, :] - a[..., 0, :])[..., :, None, :]
        ub = unit(b[..., 1, :] - b[..., 0, :])[..., None, :, :]
        len_b = torch.linalg.vector_norm(b1 - b0, dim=-1)
        h0 = ((b0 - a0)[..., 0] * ua[..., 1] - (b0 - a0)[..., 1] * ua[..., 0]).abs()
        h1 = ((b1 - a0)[..., 0] * ua[..., 1] - (b1 - a0)[..., 1] * ua[..., 0]).abs()
        cos_t = (ua * ub).sum(-1).abs()
        sin_t = (ua[..., 0] * ub[..., 1] - ua[..., 1] * ub[..., 0]).abs()
        theta = torch.atan2(sin_t, cos_t)
        parallel = theta.abs() < 1e-8
        tan_t = torch.where(parallel, 1.0, torch.tan(theta))
        area = ((h0 ** 2 + h1 ** 2) / (2.0 * tan_t * len_b.clamp_min(1e-8) ** 2)
                * (1.0 - parallel.to(theta.dtype)))
        crossing = ((orient(a0, a1, b0) != orient(a0, a1, b1))
                    & (orient(b0, b1, a0) != orient(b0, b1, a1)))
        non_int = lbd * torch.minimum(h0, h1) + 0.25 * torch.sin(2.0 * theta)
        return torch.where(crossing, area, non_int)

    return 0.5 * (asym(segs0, segs1) + asym(segs1, segs0).transpose(-1, -2))
