"""Match assignment (gluefactory_tpu/ops/assignment.py): LightGlue's
sigmoid-matchability double softmax, GlueStick's dustbin double softmax,
SuperGlue's Sinkhorn optimal transport with dustbins, and mutual-argmax
filtering. Batched, static-shape and
mask-aware; plain PyTorch on the device (JAX runs them as plain XLA)."""

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


def log_double_softmax(sim: torch.Tensor, bin_score: torch.Tensor,
                       mask0: torch.Tensor | None = None,
                       mask1: torch.Tensor | None = None) -> torch.Tensor:
    """GlueStick's dustbin double softmax: sim (B, N, M) with a bin column
    (row) of ``bin_score`` is log-softmaxed over each row (column), and the
    two are averaged -> log-assignment (B, N + 1, M + 1). The bin column
    holds the rows' bin scores, the bin row the columns'; the corner is 0.
    Padded slots are NEG_INF."""
    b, n, m = sim.shape
    bin_ = bin_score.to(sim.dtype).expand(b, 1, 1)
    row_aug = torch.cat([sim, bin_.expand(b, n, 1)], dim=2)
    col_aug = torch.cat([sim, bin_.expand(b, 1, m)], dim=1)
    rmask = cmask = None
    if mask0 is not None or mask1 is not None:
        m0 = mask0 if mask0 is not None else sim.new_ones((b, n), dtype=torch.bool)
        m1 = mask1 if mask1 is not None else sim.new_ones((b, m), dtype=torch.bool)
        pair = m0[:, :, None] & m1[:, None, :]
        rmask = torch.cat([pair, m0[:, :, None]], dim=2)
        cmask = torch.cat([pair, m1[:, None, :]], dim=1)
    scores0 = masked_log_softmax(row_aug, rmask, dim=2)  # (B, N, M + 1)
    scores1 = masked_log_softmax(col_aug, cmask, dim=1)  # (B, N + 1, M)
    inner = 0.5 * (scores0[:, :, :m] + scores1[:, :n, :])
    top = torch.cat([inner, scores0[:, :, m:]], dim=2)
    bottom = torch.cat([scores1[:, n:, :], sim.new_zeros((b, 1, 1))], dim=2)
    return torch.cat([top, bottom], dim=1)


def log_sinkhorn_iterations(Z: torch.Tensor, log_mu: torch.Tensor, log_nu: torch.Tensor,
                            iters: int) -> torch.Tensor:
    """``iters`` Sinkhorn steps in log space on Z (B, N, M) towards the
    marginals log_mu (B, N) and log_nu (B, M); returns the scaled Z."""
    u, v = torch.zeros_like(log_mu), torch.zeros_like(log_nu)
    for _ in range(iters):
        u = log_mu - torch.logsumexp(Z + v[:, None, :], dim=2)
        v = log_nu - torch.logsumexp(Z + u[:, :, None], dim=1)
    return Z + u[:, :, None] + v[:, None, :]


def log_optimal_transport(sim: torch.Tensor, bin_score: torch.Tensor, iters: int = 50,
                          mask0: torch.Tensor | None = None,
                          mask1: torch.Tensor | None = None) -> torch.Tensor:
    """SuperGlue's entropic optimal transport with a dustbin row and column:
    sim (B, N, M) -> log-assignment (B, N + 1, M + 1), scaled by N + M. Padded
    slots get similarity NEG_INF and no marginal; each dustbin's marginal is
    the valid count of the other side."""
    b, n, m = sim.shape
    if mask0 is None:
        mask0 = sim.new_ones((b, n), dtype=torch.bool)
    if mask1 is None:
        mask1 = sim.new_ones((b, m), dtype=torch.bool)
    sim = sim.masked_fill(~(mask0[:, :, None] & mask1[:, None, :]), NEG_INF)
    bins = bin_score.to(sim.dtype)
    Z = torch.cat([torch.cat([sim, bins.expand(b, n, 1)], 2),
                   torch.cat([bins.expand(b, 1, m), bins.expand(b, 1, 1)], 2)], 1)
    n_valid = mask0.sum(1).to(sim.dtype)
    m_valid = mask1.sum(1).to(sim.dtype)
    log_num = torch.log((n_valid + m_valid).clamp_min(1.0))
    log_mu = torch.cat([torch.where(mask0, 0.0, NEG_INF) - log_num[:, None],
                        (torch.log(m_valid.clamp_min(1e-30)) - log_num)[:, None]], 1)
    log_nu = torch.cat([torch.where(mask1, 0.0, NEG_INF) - log_num[:, None],
                        (torch.log(n_valid.clamp_min(1e-30)) - log_num)[:, None]], 1)
    Z = log_sinkhorn_iterations(Z, log_mu, log_nu, iters)
    return Z + log_num[:, None, None]


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
