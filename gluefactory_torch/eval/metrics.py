"""Detector- and descriptor-level metrics under a known homography
(gluefactory_tpu/eval/metrics.py): keypoint and line repeatability and
localisation error, matching scores, and the homography correctness of
mutual nearest-neighbour descriptor matches. Batched tensors with validity
masks; ``descriptor_homography_correctness`` takes one image pair."""

from __future__ import annotations

import torch

from ..geometry.homography import homography_corner_error, warp_lines, warp_points
from ..geometry.lines import orth_line_dist, struct_line_dist


def _inside(points: torch.Tensor, image_size: torch.Tensor) -> torch.Tensor:
    """(..., N) whether (..., N, 2) points lie in images of (..., 2) (w, h)."""
    return ((points >= 0) & (points <= image_size[..., None, :] - 1)).all(dim=-1)


def keypoint_repeatability(kpts0, kpts1, valid0, valid1, H_0to1, image_size1,
                           th: float = 3.0):
    """The share of view-0 keypoints that warp into view 1 and have a view-1
    keypoint within ``th``, and the mean distance of those. Returns (rep (B,),
    loc_error (B,))."""
    w0 = warp_points(kpts0, H_0to1)
    val = valid0 & _inside(w0, image_size1)
    d = torch.linalg.vector_norm(w0[:, :, None, :] - kpts1[:, None, :, :], dim=-1)
    dmin = torch.where(valid1[:, None, :], d, torch.inf).amin(dim=-1)
    repeated = (dmin < th) & val
    rep = repeated.sum(-1) / val.sum(-1).clamp_min(1)
    loc = torch.where(repeated, dmin, 0.0).sum(-1) / repeated.sum(-1).clamp_min(1)
    return rep, loc


def line_repeatability(lines0, lines1, valid0, valid1, H_0to1, image_size1,
                       th: float = 5.0, distance: str = "orth"):
    """The share of view-0 lines (warped into view 1 and clipped to it)
    whose mutual nearest view-1 line, by the ``'orth'`` or ``'struct'``
    distance, lies within ``th``, and the mean distance of those. Returns
    (rep (B,), loc_error (B,))."""
    warped0, wvalid = warp_lines(lines0, H_0to1, image_size1)
    val0 = valid0 & wvalid
    dist_fn = orth_line_dist if distance == "orth" else struct_line_dist
    D = torch.where(val0[:, :, None] & valid1[:, None, :], dist_fn(warped0, lines1), torch.inf)
    arg0, arg1 = D.argmin(dim=-1), D.argmin(dim=-2)
    mutual = arg1.gather(1, arg0) == torch.arange(lines0.shape[1], device=D.device)
    dmin = D.amin(dim=-1)
    repeated = mutual & (dmin < th) & val0
    rep = repeated.sum(-1) / val0.sum(-1).clamp_min(1)
    loc = torch.where(repeated, dmin, 0.0).sum(-1) / repeated.sum(-1).clamp_min(1)
    return rep, loc


def matching_score(m0, gt_m0, valid0):
    """The share of valid keypoints with a ground-truth match that are
    matched to it."""
    has_gt = gt_m0 >= 0
    correct = (m0 == gt_m0) & has_gt & valid0
    return correct.sum(-1) / (has_gt & valid0).sum(-1).clamp_min(1)


def _top_k_mask(scores, valid, k: int):
    """The ``k`` highest-scoring valid entries of each row (ties in order)."""
    s = torch.where(valid, scores, -torch.inf)
    order = torch.argsort(-s, dim=-1, stable=True)
    rank = torch.argsort(order, dim=-1, stable=True)
    return valid & (rank < k)


def symmetric_rep_loc_H(kpts0, kpts1, scores0, scores1, valid0, valid1, H_0to1,
                        image_size0, image_size1, k: int = 300, th: float = 3.0):
    """Symmetric repeatability and localisation error: keep the keypoints
    that warp into the other view, the ``k`` best of each side, and count
    re-detections both ways in view 0's frame; rep = (count0 + count1) /
    (N0 + N1), loc the mean distance of the counted ones; -1 where nothing
    was kept or counted. Returns (rep (B,), loc (B,))."""
    kp0_keep = _top_k_mask(scores0, valid0 & _inside(warp_points(kpts0, H_0to1), image_size1), k)
    w1 = warp_points(kpts1, torch.linalg.inv(H_0to1))
    kp1_keep = _top_k_mask(scores1, valid1 & _inside(w1, image_size0), k)
    d = torch.linalg.vector_norm(kpts0[:, :, None, :] - w1[:, None, :, :], dim=-1)
    d = torch.where(kp0_keep[:, :, None] & kp1_keep[:, None, :], d, torch.inf)
    min0, min1 = d.amin(dim=-1), d.amin(dim=-2)
    corr0 = (min0 <= th) & kp0_keep
    corr1 = (min1 <= th) & kp1_keep
    n = kp0_keep.sum(-1) + kp1_keep.sum(-1)
    counts = corr0.sum(-1) + corr1.sum(-1)
    rep = counts / n.clamp_min(1)
    le = torch.where(corr0, min0, 0.0).sum(-1) + torch.where(corr1, min1, 0.0).sum(-1)
    loc = le / counts.clamp_min(1)
    return torch.where(n > 0, rep, -1.0), torch.where(counts > 0, loc, -1.0)


def descriptor_matching_score_H(kpts0, kpts1, m0, valid0, H_0to1, image_size0,
                                thresholds=(1.0, 3.0, 5.0)):
    """{th: the share (B,) of matches whose view-1 point, warped back into
    view 0 and inside it, lies within ``th`` of its view-0 partner}."""
    matched = (m0 >= 0) & valid0
    m_kp1 = torch.take_along_dim(kpts1, m0.long().clamp_min(0)[..., None], dim=1)
    w1 = warp_points(m_kp1, torch.linalg.inv(H_0to1))
    ok = matched & _inside(w1, image_size0)
    dist = torch.linalg.vector_norm(w1 - kpts0, dim=-1)
    denom = ok.sum(-1).clamp_min(1)
    return {float(t): ((dist < t) & ok).sum(-1) / denom for t in thresholds}


def descriptor_homography_correctness(kpts0, desc0, valid0, kpts1, desc1, valid1, H_gt,
                                      image_size, thresholds=(1.0, 3.0, 5.0),
                                      ransac_th: float = 3.0):
    """One pair's descriptors: mutual nearest neighbours among the keypoints
    that warp into the other view, a homography by the port's LO-RANSAC
    (``load_estimator``), and its corner error against ``H_gt``. Returns
    ({th: 0.0 or 1.0}, the corner error; inf without 4 matches or a fit)."""
    from ..robust_estimators import load_estimator

    keep0 = valid0 & _inside(warp_points(kpts0, H_gt), image_size)
    keep1 = valid1 & _inside(warp_points(kpts1, H_gt, inverse=True), image_size)
    d = torch.linalg.vector_norm(desc0[:, None, :] - desc1[None, :, :], dim=-1)
    d = torch.where(keep0[:, None] & keep1[None, :], d, torch.inf)
    n0, n1 = d.argmin(dim=1), d.argmin(dim=0)
    mutual = (n1[n0] == torch.arange(kpts0.shape[0], device=kpts0.device)) & keep0
    failed = ({float(t): 0.0 for t in thresholds}, float("inf"))
    if int(mutual.sum()) < 4:
        return failed
    est = load_estimator("homography", "ransac")({"ransac_th": ransac_th})
    result = est({"m_kpts0": kpts0, "m_kpts1": kpts1[n0], "valid": mutual})
    if not result["success"]:
        return failed
    err = float(homography_corner_error(result["M_0to1"], H_gt, image_size))
    return {float(t): float(err <= t) for t in thresholds}, err
