"""Nearest-neighbour descriptor matcher
(gluefactory_tpu/models/matchers/nearest_neighbor_matcher.py): one
similarity matrix, the ratio and distance tests on the cosine distance, and
the mutual check; batched and mask-aware, with the JAX package's ``-1``
codes and ``similarity`` output."""

from __future__ import annotations

from typing import ClassVar

import torch

from ..base_model import BaseModel
from ..utils.metrics import matcher_metrics

NEG_INF = -1e30


def find_nn(sim: torch.Tensor, ratio_thresh: float | None, distance_thresh: float | None):
    """Each row's best column of ``sim`` (B, N, M) and its similarity, -1 and
    0 where the ratio test (squared distance 2 (1 - s) of the best against
    ``ratio_thresh``^2 of the second best) or the distance test fails."""
    sim_nn, matches = sim.max(dim=-1)
    mask = torch.ones_like(sim_nn, dtype=torch.bool)
    if ratio_thresh is not None:
        best = torch.arange(sim.shape[-1], device=sim.device) == matches[..., None]
        second = sim.masked_fill(best, NEG_INF).amax(dim=-1)
        mask = mask & (2.0 * (1.0 - sim_nn) <= ratio_thresh**2 * (2.0 * (1.0 - second)))
    if distance_thresh is not None:
        mask = mask & (2.0 * (1.0 - sim_nn) <= distance_thresh**2)
    return torch.where(mask, matches, -1), torch.where(mask, sim_nn, 0.0)


def mutual_check(m0: torch.Tensor, m1: torch.Tensor) -> torch.Tensor:
    """``m0`` where its match matches back, else -1."""
    idx0 = torch.arange(m0.shape[-1], device=m0.device)[None]
    loop = m1.gather(-1, m0.clamp(0, m1.shape[-1] - 1))
    return torch.where((m0 > -1) & (loop == idx0), m0, -1)


class NearestNeighborMatcher(BaseModel):
    default_conf: ClassVar[dict] = {
        "ratio_thresh": None,
        "distance_thresh": None,
        "mutual_check": True,
        "loss": None,
    }
    required_data_keys: ClassVar[list] = ["descriptors0", "descriptors1"]

    def _forward(self, data: dict) -> dict:
        conf = self.conf
        sim = torch.einsum("bnd,bmd->bnm", data["descriptors0"], data["descriptors1"])
        mask0, mask1 = data.get("keypoint_valid0"), data.get("keypoint_valid1")
        if mask0 is not None:
            sim = sim.masked_fill(~mask0[:, :, None], NEG_INF)
        if mask1 is not None:
            sim = sim.masked_fill(~mask1[:, None, :], NEG_INF)
        m0, ms0 = find_nn(sim, conf["ratio_thresh"], conf["distance_thresh"])
        m1, ms1 = find_nn(sim.transpose(-1, -2), conf["ratio_thresh"], conf["distance_thresh"])
        if conf["mutual_check"]:
            m0, m1 = mutual_check(m0, m1), mutual_check(m1, m0)
        if mask0 is not None:
            m0, ms0 = m0.masked_fill(~mask0, -1), ms0.masked_fill(~mask0, 0.0)
        if mask1 is not None:
            m1, ms1 = m1.masked_fill(~mask1, -1), ms1.masked_fill(~mask1, 0.0)
        return {"matches0": m0, "matches1": m1, "matching_scores0": ms0,
                "matching_scores1": ms1, "similarity": sim}

    def loss(self, pred: dict, data: dict):
        losses = {"total": torch.zeros(pred["matches0"].shape[0],
                                       device=pred["matches0"].device)}
        return losses, matcher_metrics(pred, data)


__main_model__ = NearestNeighborMatcher
