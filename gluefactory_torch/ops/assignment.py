"""LightGlue's match assignment: the sigmoid-matchability double softmax and
mutual-argmax filtering (gluefactory_tpu/ops/assignment.py). Batched,
static-shape and mask-aware."""

from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def masked_log_softmax(x: torch.Tensor, mask: torch.Tensor | None, dim: int) -> torch.Tensor:
    if mask is not None:
        x = x.masked_fill(~mask, NEG_INF)
    shifted = x - x.amax(dim=dim, keepdim=True)
    e = torch.exp(shifted)
    if mask is not None:
        e = e.masked_fill(~mask, 0.0)
    out = shifted - torch.log(e.sum(dim=dim, keepdim=True).clamp_min(1e-30))
    if mask is not None:
        out = out.masked_fill(~mask, NEG_INF)
    return out


def sigmoid_log_double_softmax(sim: torch.Tensor, z0: torch.Tensor, z1: torch.Tensor,
                               mask0: torch.Tensor | None = None,
                               mask1: torch.Tensor | None = None) -> torch.Tensor:
    """log P(i, j) = log sigma(z0_i) + log sigma(z1_j) + log softmax_row(S)_ij
    + log softmax_col(S)_ij. sim (B, N, M); z0 (B, N); z1 (B, M). Padded
    slots are NEG_INF."""
    pair = None
    if mask0 is not None or mask1 is not None:
        b, n, m = sim.shape
        m0 = mask0 if mask0 is not None else sim.new_ones((b, n), dtype=torch.bool)
        m1 = mask1 if mask1 is not None else sim.new_ones((b, m), dtype=torch.bool)
        pair = m0[:, :, None] & m1[:, None, :]
    certainties = F.logsigmoid(z0)[..., None] + F.logsigmoid(z1)[:, None]
    scores = (masked_log_softmax(sim, pair, dim=2) + masked_log_softmax(sim, pair, dim=1)
              + certainties)
    if pair is not None:
        scores = scores.masked_fill(~pair, NEG_INF)
    return scores


def filter_matches(scores: torch.Tensor, threshold: float) -> dict:
    """Mutual argmax of a log-assignment (B, N, M), kept above ``threshold``.
    matches0 (B, N) / matches1 (B, M) hold the index of the match or -1;
    matching_scores0/1 the matched probability (0 where not mutual)."""
    n, m = scores.shape[1:]
    max0, m0 = scores.max(dim=2)
    max1, m1 = scores.max(dim=1)
    idx0 = torch.arange(n, device=scores.device)[None]
    idx1 = torch.arange(m, device=scores.device)[None]
    mutual0 = idx0 == m1.gather(1, m0)
    mutual1 = idx1 == m0.gather(1, m1)
    mscores0 = torch.where(mutual0, max0.exp(), 0.0)
    mscores1 = torch.where(mutual1, mscores0.gather(1, m1), 0.0)
    valid0 = mutual0 & (mscores0 > threshold)
    valid1 = mutual1 & valid0.gather(1, m1)
    return {
        "matches0": torch.where(valid0, m0, -1),
        "matches1": torch.where(valid1, m1, -1),
        "matching_scores0": mscores0,
        "matching_scores1": mscores1,
    }
