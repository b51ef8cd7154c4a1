"""Matcher losses (gluefactory_tpu/models/utils/losses.py): negative
log-likelihood of the ground-truth assignment with positive/negative
balancing. Match codes: >= 0 index, -1 unmatched, -2 ignore."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _masked_sum(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.where(mask, x, 0.0).sum(dim=1)


def nll_loss(log_assignment: torch.Tensor, gt_matches0: torch.Tensor,
             gt_matches1: torch.Tensor, balance: bool = True):
    """NLL over a log-assignment with dustbins (B, N+1, M+1).
    Returns (total, nll_pos, nll_neg), each (B,)."""
    n, m = log_assignment.shape[1] - 1, log_assignment.shape[2] - 1
    pos0 = gt_matches0 >= 0
    neg0, neg1 = gt_matches0 == -1, gt_matches1 == -1
    idx0 = gt_matches0.clamp(0, m - 1).long()
    ll_pos0 = log_assignment[:, :n, :m].gather(2, idx0[..., None])[..., 0]
    num_pos = pos0.sum(dim=1).float().clamp_min(1.0)
    nll_pos = -_masked_sum(ll_pos0, pos0) / num_pos
    num_neg = (neg0.sum(dim=1) + neg1.sum(dim=1)).float().clamp_min(1.0)
    nll_neg = -(_masked_sum(log_assignment[:, :n, m], neg0)
                + _masked_sum(log_assignment[:, n, :m], neg1)) / num_neg
    if balance:
        total = 0.5 * (nll_pos + nll_neg)
    else:
        total = (nll_pos * num_pos + nll_neg * num_neg) / (num_pos + num_neg).clamp_min(1.0)
    return total, nll_pos, nll_neg


def nll_loss_no_bins(scores: torch.Tensor, matchability0: torch.Tensor,
                     matchability1: torch.Tensor, gt_matches0: torch.Tensor,
                     gt_matches1: torch.Tensor):
    """LightGlue's deep-supervision NLL: positives through the (B, N, M)
    log-assignment, negatives through log(1 - sigmoid(z)) of the matchability
    logits. Returns (total, nll_pos, nll_neg), each (B,)."""
    m = scores.shape[2]
    pos0 = gt_matches0 >= 0
    neg0, neg1 = gt_matches0 == -1, gt_matches1 == -1
    idx0 = gt_matches0.clamp(0, m - 1).long()
    ll_pos = scores.gather(2, idx0[..., None])[..., 0]
    num_pos = pos0.sum(dim=1).float().clamp_min(1.0)
    nll_pos = -_masked_sum(ll_pos, pos0) / num_pos
    num_neg = (neg0.sum(dim=1) + neg1.sum(dim=1)).float().clamp_min(1.0)
    # log(1 - sigmoid(z)) = -softplus(z)
    nll_neg = (_masked_sum(F.softplus(matchability0), neg0)
               + _masked_sum(F.softplus(matchability1), neg1)) / num_neg
    return 0.5 * (nll_pos + nll_neg), nll_pos, nll_neg
