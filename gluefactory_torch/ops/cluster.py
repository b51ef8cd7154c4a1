"""Fixed-radius clustering of points (gluefactory_tpu/ops/cluster.py): the
wireframe's junction merging. Labels spread through the eps-ball graph by
``num_iters`` rounds of min-label propagation, so a chain of more hops than
that stays split, as in the JAX package; plain PyTorch on the device."""

from __future__ import annotations

import torch


def fixed_radius_clusters(points: torch.Tensor, valid: torch.Tensor, eps: float,
                          num_iters: int = 16) -> torch.Tensor:
    """points (..., N, 2), valid (..., N) -> labels (..., N) int32. A label is
    the smallest index that reached a point within ``num_iters`` rounds
    (the component's smallest index where the component is shallower); an
    invalid point is its own label."""
    n = points.shape[-2]
    d2 = ((points[..., :, None, :] - points[..., None, :, :]) ** 2).sum(-1)
    adj = (d2 <= eps * eps) & valid[..., :, None] & valid[..., None, :]
    adj = adj | torch.eye(n, dtype=torch.bool, device=points.device)
    labels = torch.arange(n, dtype=torch.int32, device=points.device).expand(
        points.shape[:-1]).contiguous()
    for _ in range(num_iters):
        labels = torch.where(adj, labels[..., None, :], n).amin(dim=-1).to(torch.int32)
    return labels


def cluster_means(points: torch.Tensor, weights: torch.Tensor, labels: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """The weighted mean of the members of each label slot: (means (..., N,
    2), counts (..., N)); slot i means something only where some point has
    label i (count > 0)."""
    n = points.shape[-2]
    onehot = (labels[..., None, :] == torch.arange(n, device=points.device)[:, None]).to(
        points.dtype)
    w = onehot * weights[..., None, :]
    counts = w.sum(-1)
    sums = torch.einsum("...kn,...nd->...kd", w, points)
    return sums / counts[..., None].clamp_min(1e-8), counts
