"""AdaLAM-style adaptive locally-affine match filtering in the ``filter``
slot (gluefactory_tpu/models/matchers/adalam.py; the algorithm of Cavalli
et al., ECCV 2020), batched over (B, S, T, K) with static shapes.

  1. seeds: the matches that are score maxima within r1 of their kp0 (radius
     NMS), the ``num_seeds`` best kept;
  2. neighbourhoods: for each seed, the ``neighbors`` nearest matches whose
     kp0 lies within r1 of the seed's kp0 and whose kp1 within r2 of the
     seed's kp1;
  3. local affine RANSAC: ``hypotheses`` affine fits to 3 neighbours drawn
     at random, each scored on the whole neighbourhood under a threshold
     tied to r2;
  4. verdict: a match survives if it is an inlier of the best hypothesis of
     any seed that reaches ``min_inliers``.

The hypotheses' neighbour slots (B, S, T, 3) are drawn uniformly among each
neighbourhood's valid slots from a ``torch.Generator`` seeded with ``seed``
at every call (on the host, so every device draws the same); a ``draws``
input of that shape replaces them (the JAX package draws with
``jax.random.categorical``, whose stream differs)."""

from __future__ import annotations

from typing import ClassVar

import torch

from ..base_model import BaseModel


def _pairwise_d2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(B, N, 2), (B, M, 2) -> (B, N, M) squared distances."""
    return ((a[:, :, None, :] - b[:, None, :, :]) ** 2).sum(dim=-1)


def _solve_affine(p0: torch.Tensor, p1: torch.Tensor) -> torch.Tensor:
    """The affine map of 3 correspondences: (..., 3, 2) x2 -> (..., 2, 3)
    mapping [x, y, 1] to (x', y'). The normal equations are regularised so
    that collinear draws stay finite (their hypotheses score few inliers)."""
    A = torch.cat([p0, torch.ones_like(p0[..., :1])], dim=-1)  # (..., 3, 3)
    At = A.transpose(-1, -2)
    AtA = At @ A + torch.eye(3, dtype=p0.dtype, device=p0.device) * 1e-4
    return torch.linalg.solve(AtA, At @ p1).transpose(-1, -2)


def draw_hypotheses(nb_ok: torch.Tensor, hypotheses: int, seed: int) -> torch.Tensor:
    """(B, S, T, 3) neighbour slots, each uniform over the valid slots of its
    neighbourhood (over all of them where none is valid): the argmax of the
    masked logits plus Gumbel noise from a host generator seeded with
    ``seed``."""
    b, s, k = nb_ok.shape
    gen = torch.Generator().manual_seed(int(seed))
    u = torch.rand((b, s, hypotheses, 3, k), generator=gen).clamp_min(1e-20)
    gumbel = -torch.log(-torch.log(u)).to(nb_ok.device)
    logits = torch.where(nb_ok, 0.0, -1e9)[:, :, None, None, :]
    return (logits + gumbel).argmax(dim=-1)


class AdaLAM(BaseModel):
    default_conf: ClassVar[dict] = {
        "num_seeds": 64,
        "neighbors": 48,
        "hypotheses": 16,
        # radii as fractions of the image diagonal (r1 on the anchor image,
        # r2 on the target image)
        "r1": 0.15,
        "r2": 0.15,
        "inlier_th": 0.15,  # fraction of r2 * diagonal: the residual threshold
        "min_inliers": 6,
        "seed": 0,
    }
    required_data_keys: ClassVar[list] = [
        "keypoints0", "keypoints1", "matches0", "matching_scores0",
    ]

    def _forward(self, data: dict) -> dict:
        conf = self.conf
        kp0, kp1 = data["keypoints0"].float(), data["keypoints1"].float()
        m0 = data["matches0"].long()
        ms0 = data["matching_scores0"]
        b, n = m0.shape
        dev = kp0.device
        valid = m0 > -1
        tgt = torch.take_along_dim(kp1, m0.clamp_min(0)[..., None], dim=1)

        size = data.get("view0", {}).get("image_size")
        if size is None:
            size = kp0.amax(dim=1) - kp0.amin(dim=1)
        diag = torch.linalg.vector_norm(size.float(), dim=-1)[:, None]  # (B, 1)
        r1 = float(conf["r1"]) * diag
        r2 = float(conf["r2"]) * diag
        score = torch.where(valid, ms0, -torch.inf)

        # 1. seeds: radius-NMS maxima of the match score
        near = _pairwise_d2(kp0, kp0) < r1[..., None] ** 2  # (B, N, N)
        idx = torch.arange(n, device=dev)
        stronger = (score[:, None, :] > score[:, :, None]) | (
            (score[:, None, :] == score[:, :, None]) & (idx[None, :] < idx[:, None])[None])
        dominated = (near & stronger & valid[:, None, :]).any(dim=-1)
        seed_score = torch.where(valid & ~dominated, score, -torch.inf)
        S = int(conf["num_seeds"])
        seed_idx = torch.argsort(-seed_score, dim=-1, stable=True)[:, :S]  # (B, S)
        seed_ok = torch.take_along_dim(seed_score, seed_idx, dim=1) > -torch.inf
        S = seed_idx.shape[1]

        # 2. neighbourhoods: local on both sides of each seed
        s_kp0 = torch.take_along_dim(kp0, seed_idx[..., None], dim=1)
        s_tgt = torch.take_along_dim(tgt, seed_idx[..., None], dim=1)
        d2_s0 = _pairwise_d2(s_kp0, kp0)  # (B, S, N)
        compat = (valid[:, None, :] & (d2_s0 < r1[..., None] ** 2)
                  & (_pairwise_d2(s_tgt, tgt) < r2[..., None] ** 2))
        K = int(conf["neighbors"])
        nb_rank = torch.where(compat, d2_s0, torch.inf)
        nb_idx = torch.argsort(nb_rank, dim=-1, stable=True)[..., :K]  # (B, S, K)
        K = nb_idx.shape[-1]
        nb_ok = torch.take_along_dim(compat, nb_idx, dim=-1)
        nb_p0 = torch.take_along_dim(kp0[:, None], nb_idx[..., None], dim=2)  # (B, S, K, 2)
        nb_p1 = torch.take_along_dim(tgt[:, None], nb_idx[..., None], dim=2)

        # 3. batched local affine RANSAC
        T = int(conf["hypotheses"])
        draws = data.get("draws")
        if draws is None:
            draws = draw_hypotheses(nb_ok, T, conf["seed"])
        draws = draws.long().to(dev)  # (B, S, T, 3)
        tri_p0 = torch.take_along_dim(nb_p0[:, :, None], draws[..., None], dim=3)
        tri_p1 = torch.take_along_dim(nb_p1[:, :, None], draws[..., None], dim=3)
        A = _solve_affine(tri_p0, tri_p1)  # (B, S, T, 2, 3)
        hom0 = torch.cat([nb_p0, torch.ones_like(nb_p0[..., :1])], dim=-1)  # (B, S, K, 3)
        proj = torch.einsum("bstij,bskj->bstki", A, hom0)  # (B, S, T, K, 2)
        res = torch.linalg.vector_norm(proj - nb_p1[:, :, None], dim=-1)
        tau = float(conf["inlier_th"]) * r2[..., None, None]  # (B, 1, 1, 1)
        inl = (res < tau) & nb_ok[:, :, None, :]  # (B, S, T, K)
        n_inl = inl.sum(dim=-1)  # (B, S, T)
        best_t = n_inl.argmax(dim=-1)  # (B, S), the first of ties
        best_n = torch.take_along_dim(n_inl, best_t[..., None], dim=-1)[..., 0]
        best_inl = torch.take_along_dim(inl, best_t[..., None, None], dim=2)[:, :, 0]

        # 4. verdict: an inlier of any confident seed
        seed_conf = seed_ok & (best_n >= int(conf["min_inliers"]))  # (B, S)
        keep_vote = best_inl & seed_conf[..., None]  # (B, S, K)
        votes = torch.zeros(b, n, dtype=torch.int32, device=dev).scatter_add(
            1, nb_idx.reshape(b, -1), keep_vote.reshape(b, -1).int())
        keep = (votes > 0) & valid

        out = {
            "matches0": torch.where(keep, m0, -1).to(data["matches0"].dtype),
            "matching_scores0": torch.where(keep, ms0, 0.0),
            "adalam_seeds": seed_idx,
            "adalam_kept": keep.sum(dim=-1),
        }
        m1 = data.get("matches1")
        if m1 is not None:
            # rebuild matches1 from the surviving forward assignment: removed
            # matches write to a sentinel column that is cut off
            m = m1.shape[1]
            m1_new = torch.full((b, m + 1), -1, dtype=m1.dtype, device=dev).scatter(
                1, torch.where(keep, m0, m), idx.expand(b, n).to(m1.dtype))[:, :m]
            out["matches1"] = m1_new
            ms1 = data.get("matching_scores1")
            out["matching_scores1"] = (torch.where(m1_new > -1, ms1, 0.0) if ms1 is not None
                                       else torch.zeros_like(m1_new, dtype=ms0.dtype))
        return out

    def loss(self, pred, data):
        raise NotImplementedError


__main_model__ = AdaLAM
