"""The wireframe: a point extractor and a line extractor composed into
GlueStick's junction graph (gluefactory_tpu/models/lines/wireframe.py).

Line endpoints within ``nms_radius`` of each other are clustered into
junctions (``ops.cluster``: 16 rounds of min-label propagation), each
junction at the score-weighted mean of its endpoints, and every line is
snapped to its two junctions. Keypoints within ``nms_radius`` of a junction
are masked. The node set is the junction block (2 x max lines slots, a slot
valid where it is a cluster's label) then the keypoint block, with
``lines_junc_idx`` (the junction slot of each endpoint) and
``n_junctions``; descriptors are sampled from the point extractor's dense
map at stride 8 at every node. A junction's score is the mean of its lines'
scores, as in the JAX package."""

from __future__ import annotations

from typing import ClassVar

import torch

from ...ops.cluster import cluster_means, fixed_radius_clusters
from ...ops.interpolate import sample_descriptors
from ..base_model import BaseModel, make_submodel


class WireframeExtractor(BaseModel):
    default_conf: ClassVar[dict] = {
        "point_extractor": {"name": "extractors.superpoint", "trainable": False},
        "line_extractor": {"name": "lines.lsd", "trainable": False},
        "nms_radius": 3.0,
        "trainable": False,
    }
    required_data_keys: ClassVar[list] = ["image"]

    def __init__(self, conf: dict | None = None):
        super().__init__(conf)
        self.point_extractor = make_submodel(self.conf["point_extractor"])
        self.line_extractor = make_submodel(self.conf["line_extractor"])

    def _forward(self, data: dict) -> dict:
        pred_pts = self.point_extractor(data)
        pred_lines = self.line_extractor(data)
        lines = pred_lines["lines"]  # (B, L, 2, 2)
        line_scores, valid_lines = pred_lines["line_scores"], pred_lines["valid_lines"]
        kpts, kp_scores = pred_pts["keypoints"], pred_pts["keypoint_scores"]
        kp_valid = pred_pts.get("keypoint_valid")
        if kp_valid is None:
            kp_valid = torch.ones(kpts.shape[:-1], dtype=torch.bool, device=kpts.device)
        b, n_lines = lines.shape[:2]
        radius = float(self.conf["nms_radius"])

        # 1. endpoints clustered into junctions (B, 2L); lines snapped to them
        endpoints = lines.reshape(b, 2 * n_lines, 2)
        ep_valid = valid_lines.repeat_interleave(2, dim=-1)
        labels = fixed_radius_clusters(endpoints, ep_valid, eps=radius)
        ep_w = line_scores.repeat_interleave(2, dim=-1)
        junctions, counts = cluster_means(endpoints, ep_w * ep_valid, labels)
        junc_valid = counts > 0  # slot i is used where it is some cluster's label
        junc_scores, _ = cluster_means(ep_w[..., None], ep_valid.to(ep_w.dtype), labels)
        lines_junc_idx = labels.to(torch.int32)
        lines = junctions.gather(1, labels.long()[..., None].expand(-1, -1, 2)).reshape(
            b, n_lines, 2, 2)

        # 2. keypoints near a junction masked
        d2 = ((kpts[:, :, None, :] - junctions[:, None, :, :]) ** 2).sum(-1)
        near = ((d2 <= radius * radius) & junc_valid[:, None, :]).any(dim=-1)

        # 3. the node set: junctions, then keypoints
        all_pts = torch.cat([junctions, kpts], dim=1)
        pred = {
            "keypoints": all_pts,
            "keypoint_scores": torch.cat([junc_scores[..., 0], kp_scores], dim=1),
            "keypoint_valid": torch.cat([junc_valid, kp_valid & ~near], dim=1),
            "lines": lines,
            "line_scores": line_scores,
            "valid_lines": valid_lines,
            "lines_junc_idx": lines_junc_idx,
            "n_junctions": torch.full((b,), 2 * n_lines, dtype=torch.int32, device=kpts.device),
        }
        # 4. descriptors from the dense map at every node
        if "descriptors_dense" in pred_pts:
            pred["descriptors"] = sample_descriptors(pred_pts["descriptors_dense"], all_pts,
                                                     stride=8)
        elif "descriptors" in pred_pts:
            kdesc = pred_pts["descriptors"]
            jdesc = kdesc.new_zeros((b, 2 * n_lines, kdesc.shape[-1]))
            pred["descriptors"] = torch.cat([jdesc, kdesc], dim=1)
        return pred


__main_model__ = WireframeExtractor
