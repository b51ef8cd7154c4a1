"""Ground-truth matches for matcher supervision
(gluefactory_tpu/geometry/gt_generation.py), batched with static shapes.

Match codes: ``m0[i] = j`` means keypoint i of view 0 matches keypoint j of
view 1; -1 is a confident non-match (negative), -2 is ignored. Padded slots
(``valid`` False) end up ignored. The supervision comes from a homography or
from depth maps, cameras and a relative pose."""

from __future__ import annotations

import torch

from .depth import project, sample_depth
from .homography import warp_points
from .wrappers import Camera, Pose

UNMATCHED = -1
IGNORE = -2


def _gt_from_dist(D: torch.Tensor, reproj_valid0: torch.Tensor, reproj_valid1: torch.Tensor,
                  valid0: torch.Tensor, valid1: torch.Tensor, pos_th: float,
                  neg_th: float) -> dict:
    """Assignment from a pairwise distance matrix D (..., N, M): positives are
    mutual nearest neighbours closer than ``pos_th``; negatives have a valid
    reprojection and no neighbour within ``neg_th``; the rest is ignored."""
    pair_valid = (valid0[..., :, None] & valid1[..., None, :]
                  & (reproj_valid0[..., :, None] | reproj_valid1[..., None, :]))
    Dm = torch.where(pair_valid, D, torch.inf)
    n, m = D.shape[-2], D.shape[-1]
    min0, arg0 = Dm.min(dim=-1)
    min1, arg1 = Dm.min(dim=-2)
    mutual0 = arg1.gather(-1, arg0) == torch.arange(n, device=D.device)
    mutual1 = arg0.gather(-1, arg1) == torch.arange(m, device=D.device)
    pos0 = mutual0 & (min0 < pos_th) & valid0
    pos1 = mutual1 & (min1 < pos_th) & valid1
    neg0 = (min0 > neg_th) & reproj_valid0 & valid0
    neg1 = (min1 > neg_th) & reproj_valid1 & valid1
    unmatched = torch.tensor(UNMATCHED, device=D.device)
    ignore = torch.tensor(IGNORE, device=D.device)
    m0 = torch.where(pos0, arg0, torch.where(neg0, unmatched, ignore))
    m1 = torch.where(pos1, arg1, torch.where(neg1, unmatched, ignore))
    assignment = (pos0[..., :, None] & pos1[..., None, :]
                  & (torch.arange(m, device=D.device) == arg0[..., :, None]))
    return {
        "assignment": assignment,
        "matches0": m0.int(),
        "matches1": m1.int(),
        "matching_scores0": pos0.to(D.dtype),
        "matching_scores1": pos1.to(D.dtype),
    }


def gt_matches_from_homography(kpts0: torch.Tensor, kpts1: torch.Tensor,
                               H_0to1: torch.Tensor, image_size0=None, image_size1=None,
                               valid0: torch.Tensor | None = None,
                               valid1: torch.Tensor | None = None,
                               pos_th: float = 3.0, neg_th: float = 6.0) -> dict:
    """Supervision from a known homography: the larger of the two one-way
    reprojection distances, then ``_gt_from_dist``. A keypoint whose
    reprojection leaves the other image cannot be a negative."""
    if valid0 is None:
        valid0 = torch.ones(kpts0.shape[:-1], dtype=torch.bool, device=kpts0.device)
    if valid1 is None:
        valid1 = torch.ones(kpts1.shape[:-1], dtype=torch.bool, device=kpts1.device)
    kpts0_in1 = warp_points(kpts0, H_0to1)
    kpts1_in0 = warp_points(kpts1, H_0to1, inverse=True)
    dist0 = torch.linalg.vector_norm(kpts0_in1[..., :, None, :] - kpts1[..., None, :, :], dim=-1)
    dist1 = torch.linalg.vector_norm(kpts0[..., :, None, :] - kpts1_in0[..., None, :, :], dim=-1)
    dist = torch.maximum(dist0, dist1)
    rv0, rv1 = valid0, valid1
    if image_size1 is not None:
        sz1 = image_size1[..., None, :]
        rv0 = rv0 & ((kpts0_in1 >= 0) & (kpts0_in1 <= sz1 - 1)).all(dim=-1)
    if image_size0 is not None:
        sz0 = image_size0[..., None, :]
        rv1 = rv1 & ((kpts1_in0 >= 0) & (kpts1_in0 <= sz0 - 1)).all(dim=-1)
    out = _gt_from_dist(dist, rv0, rv1, valid0, valid1, pos_th, neg_th)
    out.update(reproj_0to1=kpts0_in1, reproj_1to0=kpts1_in0, visible0=rv0, visible1=rv1)
    return out


def gt_matches_from_pose_depth(kpts0: torch.Tensor, kpts1: torch.Tensor, depth0: torch.Tensor,
                               depth1: torch.Tensor, camera0: Camera, camera1: Camera,
                               T_0to1: Pose, valid0: torch.Tensor | None = None,
                               valid1: torch.Tensor | None = None, pos_th: float = 3.0,
                               neg_th: float = 5.0, ccth: float = 0.05) -> dict:
    """Supervision from depth and pose: each keypoint set is reprojected into
    the other view at its sampled depth, kept where the other view's depth
    agrees (``ccth``); a pair's distance is the larger of its two one-way
    distances where both reprojections hold, else the one that does; then
    ``_gt_from_dist``."""
    if valid0 is None:
        valid0 = torch.ones(kpts0.shape[:-1], dtype=torch.bool, device=kpts0.device)
    if valid1 is None:
        valid1 = torch.ones(kpts1.shape[:-1], dtype=torch.bool, device=kpts1.device)
    d0, dvalid0 = sample_depth(kpts0, depth0)
    d1, dvalid1 = sample_depth(kpts1, depth1)
    kpts0_in1, rv0 = project(kpts0, d0, depth1, camera0, camera1, T_0to1, dvalid0, ccth)
    kpts1_in0, rv1 = project(kpts1, d1, depth0, camera1, camera0, T_0to1.inv(), dvalid1, ccth)
    dist0 = torch.linalg.vector_norm(kpts0_in1[..., :, None, :] - kpts1[..., None, :, :], dim=-1)
    dist1 = torch.linalg.vector_norm(kpts0[..., :, None, :] - kpts1_in0[..., None, :, :], dim=-1)
    both = rv0[..., :, None] & rv1[..., None, :]
    one_sided = torch.minimum(torch.where(rv0[..., :, None], dist0, torch.inf),
                              torch.where(rv1[..., None, :], dist1, torch.inf))
    dist = torch.where(both, torch.maximum(dist0, dist1), one_sided)
    out = _gt_from_dist(dist, rv0, rv1, valid0, valid1, pos_th, neg_th)
    out.update(reproj_0to1=kpts0_in1, reproj_1to0=kpts1_in0, visible0=rv0, visible1=rv1)
    return out
