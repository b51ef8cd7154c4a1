"""Sub-pixel match refinement in the ``filter`` slot
(gluefactory_tpu/models/matchers/match_refiner.py), window-sampling mode.

Per round: fit a Cauchy-IRLS weighted homography to the current matches,
used only to shape each template by its local 2x2 Jacobian; read one integer
window of image 1 around each matched ``kp1``; score a displacement grid
against the template of image 0 with ZNCC; move ``kp1`` to the sub-pixel
peak where the ZNCC and the template's texture are high enough. Refined
positions are written back into ``keypoints1``."""

from __future__ import annotations

import math
from typing import ClassVar

import torch

from ...geometry.homography import compute_homography, warp_points
from ...ops.interpolate import bilinear_sample
from ..base_model import BaseModel


def _to_gray(image: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, H, W, 1) float32, the channel mean."""
    img = image.float()
    return img.mean(dim=-1, keepdim=True) if img.shape[-1] > 1 else img


def _fit_homography_irls(p0, p1, w, iters: int, scale: float) -> torch.Tensor:
    """Batched weighted DLT + Cauchy IRLS: (B, N, 2) x2, (B, N) -> (B, 3, 3)."""
    H = compute_homography(p0, p1, w)
    for _ in range(iters):
        r = torch.sqrt(((warp_points(p0, H) - p1) ** 2).sum(dim=-1) + 1e-12)
        H = compute_homography(p0, p1, w / (1.0 + (r / scale) ** 2))
    return H


def _homography_jacobian(H: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """d(H x)/dx at pts: (B, 3, 3), (B, N, 2) -> (B, N, 2, 2)."""
    h = H[:, None]
    x, y = pts[..., 0], pts[..., 1]
    u = h[..., 0, 0] * x + h[..., 0, 1] * y + h[..., 0, 2]
    v = h[..., 1, 0] * x + h[..., 1, 1] * y + h[..., 1, 2]
    w = h[..., 2, 0] * x + h[..., 2, 1] * y + h[..., 2, 2]
    iw = 1.0 / torch.where(w.abs() < 1e-8, torch.where(w < 0, -1e-8, 1e-8), w)
    j00 = (h[..., 0, 0] - u * iw * h[..., 2, 0]) * iw
    j01 = (h[..., 0, 1] - u * iw * h[..., 2, 1]) * iw
    j10 = (h[..., 1, 0] - v * iw * h[..., 2, 0]) * iw
    j11 = (h[..., 1, 1] - v * iw * h[..., 2, 1]) * iw
    return torch.stack([torch.stack([j00, j01], -1), torch.stack([j10, j11], -1)], -2)


def _quadratic_peak(score: torch.Tensor, side: int):
    """Sub-pixel argmax of a (B, N, side*side) surface: (displacement (B, N, 2)
    in grid units from the grid center, peak value (B, N)). The argmax is
    clamped one cell inside so the 3x3 fit always has support."""
    flat_idx = score.argmax(dim=-1)
    iy = (flat_idx // side).clamp(1, side - 2)
    ix = (flat_idx % side).clamp(1, side - 2)

    def at(dy, dx):
        idx = (iy + dy) * side + (ix + dx)
        return torch.take_along_dim(score, idx[..., None], dim=-1)[..., 0]

    c = at(0, 0)

    def sub(lo, hi):
        denom = lo + hi - 2.0 * c
        off = torch.where(denom < -1e-9, 0.5 * (lo - hi) / denom, 0.0)
        return off.clamp(-0.5, 0.5)

    half = (side - 1) / 2.0
    disp = torch.stack([ix.float() + sub(at(0, -1), at(0, 1)) - half,
                        iy.float() + sub(at(-1, 0), at(1, 0)) - half], dim=-1)
    return disp, c


def _zncc_normalize(x: torch.Tensor) -> torch.Tensor:
    mean = x.mean(dim=-1, keepdim=True)
    std = torch.sqrt(((x - mean) ** 2).mean(dim=-1) + 1e-12)
    return (x - mean) / (std[..., None] + 1e-6)


class MatchRefiner(BaseModel):
    default_conf: ClassVar[dict] = {
        "patch_radius": 4,      # template half-size -> (2r+1)^2 pixels
        "search_radius": 3,     # displacement grid half-size (px)
        "search_step": 1.0,     # displacement grid spacing (px)
        "rounds": 2,            # refine -> refit H -> refine
        "irls_iters": 3,        # Cauchy IRLS passes for the shape-only H
        "irls_scale": 2.0,      # Cauchy scale (px)
        "zncc_min": 0.4,        # keep the original position below this
        "min_texture": 0.01,    # min template std (images in [0, 1])
        "affine_compensation": True,
        # 'auto' is the window mode off the TPU; 'static' and the legacy
        # direct taps (False) are not ported
        "window_sampling": "auto",
        "max_patch_stretch": 1.5,  # bounds the warped patch and the window
        "trainable": False,
    }
    required_data_keys: ClassVar[list] = ["view0", "view1"]

    def __init__(self, conf: dict | None = None):
        super().__init__(conf)
        if self.conf["window_sampling"] not in ("auto", True):
            raise NotImplementedError("only window_sampling=True ('auto') is ported")

    def _forward(self, data: dict) -> dict:
        conf = self.conf
        kp0 = data["keypoints0"].float()
        kp1 = data["keypoints1"].float()
        matches0 = data["matches0"]
        mscores0 = data.get("matching_scores0")
        if mscores0 is None:
            mscores0 = torch.ones_like(kp0[..., 0])
        img0 = _to_gray(data["view0"]["image"])
        img1 = _to_gray(data["view1"]["image"])
        b, n = matches0.shape
        m = kp1.shape[1]
        dev = kp0.device

        valid = matches0 >= 0
        if "keypoint_valid0" in data:
            valid = valid & data["keypoint_valid0"].bool()
        idx1 = matches0.long().clamp(0, m - 1)
        p0 = kp0
        p1 = torch.take_along_dim(kp1, idx1[..., None], dim=1)
        w_match = (mscores0 * valid).float()

        r = int(conf["patch_radius"])
        s = int(conf["search_radius"])
        step = float(conf["search_step"])
        side = 2 * s + 1
        ax_p = torch.arange(-r, r + 1, dtype=torch.float32, device=dev)
        gy, gx = torch.meshgrid(ax_p, ax_p, indexing="ij")
        patch = torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1)  # (P, 2)
        ax_d = torch.arange(-s, s + 1, dtype=torch.float32, device=dev) * step
        dy, dx = torch.meshgrid(ax_d, ax_d, indexing="ij")
        disp = torch.stack([dx.reshape(-1), dy.reshape(-1)], dim=-1)  # (D, 2)
        p, d = patch.shape[0], disp.shape[0]

        # the template never changes across rounds: sample it once
        t_pts = (p0[:, :, None, :] + patch).reshape(b, n * p, 2)
        tpl = bilinear_sample(img0, t_pts).reshape(b, n, p)
        t_std = torch.sqrt(((tpl - tpl.mean(-1, keepdim=True)) ** 2).mean(-1) + 1e-12)
        tpl_n = _zncc_normalize(tpl)
        textured = t_std > float(conf["min_texture"])

        amax = float(conf["max_patch_stretch"])
        # window radius: the search, the clamped warped patch and one bilinear tap
        rad = int(math.ceil(s * step + r * amax)) + 1
        wside = 2 * rad + 1
        wgrid = torch.arange(-rad, rad + 1, device=dev)
        img_h, img_w = img1.shape[1:3]
        flat1 = img1.reshape(b, img_h * img_w)

        for _ in range(int(conf["rounds"])):
            if conf["affine_compensation"]:
                H = _fit_homography_irls(p0, p1, w_match, int(conf["irls_iters"]),
                                         float(conf["irls_scale"]))
                A = _homography_jacobian(H, p0)  # (B, N, 2, 2)
                warped_patch = torch.einsum("bnij,pj->bnpi", A, patch)
            else:
                warped_patch = patch.expand(b, n, p, 2)
            warped_patch = warped_patch.clamp(-r * amax, r * amax)
            base = p1.floor().long()
            frac = p1 - base.float()
            # one dense integer window per match: (B, N, wside, wside)
            wy = (base[..., 1:2] + wgrid).clamp(0, img_h - 1)
            wx = (base[..., 0:1] + wgrid).clamp(0, img_w - 1)
            widx = wy[:, :, :, None] * img_w + wx[:, :, None, :]
            win = torch.take_along_dim(flat1, widx.reshape(b, -1), dim=1).reshape(
                b, n, wside * wside)
            # candidate positions relative to the window origin: (B, N, D, P, 2)
            q = (frac[:, :, None, None, :] + disp[:, None, :]
                 + warped_patch[:, :, None, :, :] + float(rad))
            qx = q[..., 0].clamp(0.0, wside - 1.0)
            qy = q[..., 1].clamp(0.0, wside - 1.0)
            x0 = qx.floor().long().clamp(0, wside - 2)
            y0 = qy.floor().long().clamp(0, wside - 2)
            fx = qx - x0.float()
            fy = qy - y0.float()

            def at_win(yy, xx):
                idx = (yy * wside + xx).reshape(b, n, d * p)
                return torch.take_along_dim(win, idx, dim=2).reshape(b, n, d, p)

            cand = ((at_win(y0, x0) * (1 - fx) + at_win(y0, x0 + 1) * fx) * (1 - fy)
                    + (at_win(y0 + 1, x0) * (1 - fx) + at_win(y0 + 1, x0 + 1) * fx) * fy)
            zncc = (tpl_n[:, :, None, :] * _zncc_normalize(cand)).mean(dim=-1)  # (B, N, D)
            delta, peak = _quadratic_peak(zncc, side)
            ok = valid & textured & (peak > float(conf["zncc_min"]))
            p1 = torch.where(ok[..., None], p1 + delta * step, p1)

        # write back: 1-1 matches give each kp1 index at most one nonzero
        # delta; unmatched rows (clipped to index 0) add exactly zero
        final_delta = torch.where(
            valid[..., None], p1 - torch.take_along_dim(kp1, idx1[..., None], dim=1), 0.0)
        kp1_new = kp1 + torch.zeros_like(kp1).scatter_add(
            1, idx1[..., None].expand(-1, -1, 2), final_delta)
        return {"keypoints1": kp1_new, "refined1": valid}


__main_model__ = MatchRefiner
