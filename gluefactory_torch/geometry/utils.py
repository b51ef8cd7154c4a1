"""Homogeneous coordinates (gluefactory_tpu/geometry/utils.py)."""

from __future__ import annotations

import torch


def to_homogeneous(points: torch.Tensor) -> torch.Tensor:
    """(..., N, D) -> (..., N, D+1) with a trailing 1."""
    return torch.cat([points, torch.ones_like(points[..., :1])], dim=-1)


def from_homogeneous(points: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """(..., N, D+1) -> (..., N, D), dividing by the last coordinate."""
    return points[..., :-1] / (points[..., -1:] + eps)
