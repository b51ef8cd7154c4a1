"""Matcher training metrics (gluefactory_tpu/models/utils/metrics.py), per
batch item. Ground-truth codes: >= 0 index, -1 unmatched, -2 ignore."""

from __future__ import annotations

import torch


def _ratio(hits: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    mask = mask.float()
    return (hits * mask).sum(dim=1) / mask.sum(dim=1).clamp_min(1.0)


def _ranking_ap(m, gt_m, scores):
    p_mask = ((m > -1) & (gt_m >= -1)).float()
    r_mask = (gt_m > -1).float()
    order = torch.argsort(-scores, dim=1, stable=True)
    sorted_p = p_mask.gather(1, order)
    correct = (m == gt_m).float().gather(1, order)
    tp = correct * sorted_p
    p_at_k = tp.cumsum(dim=1) / sorted_p.cumsum(dim=1).clamp_min(1e-8)
    return (p_at_k * tp).sum(dim=1) / r_mask.sum(dim=1).clamp_min(1.0)


def matcher_metrics(pred: dict, data: dict, prefix: str = "",
                    prefix_gt: str | None = None) -> dict:
    """match_recall, match_precision, accuracy and average_precision, (B,) each."""
    gt_pref = prefix_gt if prefix_gt is not None else prefix
    m0 = pred[f"{prefix}matches0"]
    gt_m0 = data[f"gt_{gt_pref}matches0"]
    scores0 = pred.get(f"{prefix}matching_scores0")
    if scores0 is None:
        scores0 = torch.zeros_like(m0, dtype=torch.float32)
    hits = (m0 == gt_m0).float()
    return {
        f"{prefix}match_recall": _ratio(hits, gt_m0 > -1),
        f"{prefix}match_precision": _ratio(hits, (m0 > -1) & (gt_m0 >= -1)),
        f"{prefix}accuracy": _ratio(hits, gt_m0 > -2),
        f"{prefix}average_precision": _ranking_ap(m0, gt_m0, scores0),
    }
