"""Point and line homography LO-RANSAC on the device
(gluefactory_tpu/robust_estimators/homography/hybrid_ransac.py).

Minimal sets of 4 units are drawn from the union of the point and line
correspondences (each unit gives two DLT rows), so line-only and mixed sets
work. Every hypothesis is solved by one batched joint DLT: point rows, and
for each line two rows saying that the view-0 endpoints, warped by H, lie
on the view-1 line, both views Hartley-normalised over points and endpoints.
Hypotheses are MSAC-scored on the point reprojection errors and the mean
endpoint-to-line distances; the best one is refit on its inliers with a
threshold shrinking geometrically from 4 th to th, each step kept when it
has more than 8 rows and does not lower the score."""

from __future__ import annotations

import numpy as np
import torch

from ...geometry.homography import _inv, _normalize_pts, sym_homography_error
from ...geometry.utils import to_homogeneous
from ..base_estimator import BaseEstimator
from .ransac import sample_minimal_sets


def line_coeffs(segs: torch.Tensor) -> torch.Tensor:
    """(..., L, 2, 2) segments -> their homogeneous lines (..., L, 3), scaled
    so that (a, b) has unit norm."""
    line = torch.linalg.cross(to_homogeneous(segs[..., 0, :]), to_homogeneous(segs[..., 1, :]))
    return line / torch.linalg.vector_norm(line[..., :2], dim=-1, keepdim=True).clamp_min(1e-8)


def point_on_line_residual(segs0: torch.Tensor, l1: torch.Tensor, H: torch.Tensor
                           ) -> torch.Tensor:
    """The mean distance (px) of the two view-0 endpoints, warped by H, to
    the view-1 line: (..., L)."""
    e = to_homogeneous(segs0.reshape(*segs0.shape[:-3], -1, 2))  # (..., 2L, 3)
    He = e @ H.transpose(-1, -2)
    He = He / He[..., 2:3].abs().clamp_min(1e-8)
    d = (He * l1.repeat_interleave(2, dim=-2)).sum(-1).abs()
    return d.reshape(*d.shape[:-1], segs0.shape[-3], 2).mean(-1)


def joint_dlt(pts0, pts1, w_pts, segs0, segs1, l1, w_lines) -> torch.Tensor:
    """The weighted DLT over point correspondences (..., N, 2) and line
    correspondences (segments (..., L, 2, 2), view-1 lines (..., L, 3)) ->
    H (..., 3, 3). Both views are Hartley-normalised over the weighted points
    and line endpoints together (view 1 over its endpoints too, or a
    line-only fit loses the solution in float32); the line rows are
    kron(l1', e0') in the normalised frames, l1' = T1^-T l1."""
    ends0 = segs0.reshape(*segs0.shape[:-3], -1, 2)
    ends1 = segs1.reshape(*segs1.shape[:-3], -1, 2)
    w_pts, w_lines = w_pts.to(pts0.dtype), w_lines.to(pts0.dtype)
    wl2 = w_lines.repeat_interleave(2, dim=-1)
    _, T0 = _normalize_pts(torch.cat([pts0, ends0], dim=-2), torch.cat([w_pts, wl2], dim=-1))
    _, T1 = _normalize_pts(torch.cat([pts1, ends1], dim=-2), torch.cat([w_pts, wl2], dim=-1))
    p0n = (to_homogeneous(pts0) @ T0.transpose(-1, -2))[..., :2]
    p1n = (to_homogeneous(pts1) @ T1.transpose(-1, -2))[..., :2]
    x0, y0 = p0n[..., 0], p0n[..., 1]
    x1, y1 = p1n[..., 0], p1n[..., 1]
    z, o = torch.zeros_like(x0), torch.ones_like(x0)
    r1 = torch.stack([-x0, -y0, -o, z, z, z, x1 * x0, x1 * y0, x1], dim=-1)
    r2 = torch.stack([z, z, z, -x0, -y0, -o, y1 * x0, y1 * y0, y1], dim=-1)
    A = torch.cat([r1, r2], dim=-2)
    AtA = torch.einsum("...ni,...n,...nj->...ij", A, torch.cat([w_pts, w_pts], dim=-1), A)
    e0n = to_homogeneous(ends0) @ T0.transpose(-1, -2)
    T1_inv = _inv(T1)
    l1n = l1 @ T1_inv  # (T1^-T l1) for each row
    l1n = l1n / torch.linalg.vector_norm(l1n[..., :2], dim=-1, keepdim=True).clamp_min(1e-8)
    rows = l1n.repeat_interleave(2, dim=-2)[..., :, None] * e0n[..., None, :]
    rows = rows.reshape(*rows.shape[:-2], 9)  # l1 . H e0 with vec(H) row-major
    AtA = AtA + torch.einsum("...ni,...n,...nj->...ij", rows, wl2, rows)
    Hn = torch.linalg.eigh(AtA).eigenvectors[..., :, 0].reshape(*AtA.shape[:-2], 3, 3)
    H = T1_inv @ Hn @ T0
    return H / (H[..., 2:3, 2:3] + 1e-12)


def _finite(x: torch.Tensor) -> torch.Tensor:
    return torch.nan_to_num(x, nan=float("inf"), posinf=float("inf"))


def hybrid_ransac_homography(
    kpts0: torch.Tensor, kpts1: torch.Tensor, valid_pts: torch.Tensor,
    segs0: torch.Tensor, segs1: torch.Tensor, valid_lines: torch.Tensor,
    th: float, line_th: float, num_hypotheses: int = 1024, lo_iters: int = 4,
    generator: torch.Generator | None = None, sample_idx: torch.Tensor | None = None,
):
    """Points (N, 2) x2 with valid (N,), segments (M, 2, 2) x2 with valid
    (M,) -> (H (3, 3), point inliers (N,), line inliers (M,)).
    ``sample_idx`` (S, 4), indices into points then lines, replaces the
    random minimal sets."""
    l1 = line_coeffs(segs1)
    n, m = kpts0.shape[0], segs0.shape[0]
    if sample_idx is None:
        sample_idx = sample_minimal_sets(torch.cat([valid_pts, valid_lines]), num_hypotheses,
                                         generator)
    k = sample_idx.shape[0]
    counts = kpts0.new_zeros((k, n + m)).scatter_add_(
        1, sample_idx.long(), kpts0.new_ones(sample_idx.shape))
    H = joint_dlt(kpts0.expand(k, n, 2), kpts1.expand(k, n, 2), counts[:, :n],
                  segs0.expand(k, m, 2, 2), segs1.expand(k, m, 2, 2), l1.expand(k, m, 3),
                  counts[:, n:])
    p_err = _finite(sym_homography_error(kpts0[None], kpts1[None], H).masked_fill(
        ~valid_pts[None], float("inf")))
    l_err = _finite(point_on_line_residual(segs0[None], l1[None], H).masked_fill(
        ~valid_lines[None], float("inf")))
    score = ((1.0 - (p_err / th) ** 2).clamp_min(0.0).sum(-1)
             + (1.0 - (l_err / line_th) ** 2).clamp_min(0.0).sum(-1))
    H_cur = H[score.argmax()]

    def errors(Hm):
        pe = _finite(sym_homography_error(kpts0[None], kpts1[None], Hm[None])[0])
        le = _finite(point_on_line_residual(segs0[None], l1[None], Hm[None])[0])
        return pe, le

    def msac(pe, le):
        point = torch.where(valid_pts, (1.0 - (pe / th) ** 2).clamp_min(0.0), 0.0)
        line = torch.where(valid_lines, (1.0 - (le / line_th) ** 2).clamp_min(0.0), 0.0)
        return point.sum() + line.sum()

    # each step's errors and score are kept with the model they belong to
    pe, le = errors(H_cur)
    score_cur = msac(pe, le)
    f32 = np.float32
    for th_i in np.geomspace(4.0 * th, th, max(lo_iters, 1)).astype(f32):
        wp = (valid_pts & (pe < float(th_i))).to(kpts0.dtype)
        line_th_i = float(f32(f32(th_i * f32(line_th)) / f32(th)))  # in float32, as JAX
        wl = (valid_lines & (le < line_th_i)).to(kpts0.dtype)
        H_new = joint_dlt(kpts0[None], kpts1[None], wp[None], segs0[None], segs1[None],
                          l1[None], wl[None])[0]
        pe_new, le_new = errors(H_new)
        score_new = msac(pe_new, le_new)
        ok = (torch.isfinite(H_new).all() & (wp.sum() + 2 * wl.sum() > 8.0)
              & (score_new >= score_cur))
        H_cur = torch.where(ok, H_new, H_cur)
        pe, le = torch.where(ok, pe_new, pe), torch.where(ok, le_new, le)
        score_cur = torch.where(ok, score_new, score_cur)
    return H_cur, valid_pts & (pe < th), valid_lines & (le < line_th)


class HybridHomographyEstimator(BaseEstimator):
    """conf: ransac_th and line_th (px), num_hypotheses, lo_iters, seed.
    ``data``: m_kpts0/1 (N, 2), valid (N,), and optionally m_lines0/1
    (M, 2, 2) with valid_lines (M,), and sample_idx (S, 4) to fix the
    minimal sets (indices into points then lines; without lines, one
    invalid placeholder line follows the points)."""

    default_conf = {"ransac_th": 3.0, "line_th": 3.0, "num_hypotheses": 1024, "lo_iters": 4,
                    "seed": 0}

    def _forward(self, data: dict) -> dict:
        kpts0, kpts1 = data["m_kpts0"].float(), data["m_kpts1"].float()
        device = kpts0.device
        valid = data.get("valid")
        valid = (torch.ones(kpts0.shape[0], dtype=torch.bool, device=device) if valid is None
                 else valid.bool())
        segs0 = data.get("m_lines0")
        if segs0 is None:
            segs0 = segs1 = torch.zeros((1, 2, 2), device=device)
            vlines = torch.zeros(1, dtype=torch.bool, device=device)
        else:
            segs0, segs1 = segs0.float(), data["m_lines1"].float()
            vlines = data.get("valid_lines")
            vlines = (torch.ones(segs0.shape[0], dtype=torch.bool, device=device)
                      if vlines is None else vlines.bool())
        generator = torch.Generator(device=device).manual_seed(int(self.conf["seed"]))
        H, inl_p, inl_l = hybrid_ransac_homography(
            kpts0, kpts1, valid, segs0, segs1, vlines, th=float(self.conf["ransac_th"]),
            line_th=float(self.conf["line_th"]),
            num_hypotheses=int(self.conf["num_hypotheses"]),
            lo_iters=int(self.conf["lo_iters"]), generator=generator,
            sample_idx=data.get("sample_idx"))
        n_inliers = int(inl_p.sum()) + int(inl_l.sum())
        return {"success": n_inliers >= 4 and bool(torch.isfinite(H).all()),
                "M_0to1": H, "inliers": inl_p, "line_inliers": inl_l}


__main_estimator__ = HybridHomographyEstimator
