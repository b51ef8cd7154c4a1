"""LBD line band descriptors and their matcher (gluefactory_tpu/models/lines/lbd.py).

The descriptor of a segment: ``n_samples`` points along it, each offset
across it onto ``n_bands`` parallel bands spread over 2 x ``band_width``
pixels; at every point the image's central-difference gradient (bilinear;
the border rows and columns stay 0) is projected onto the segment's
direction and its normal; for each band and each projection the mean and
the population standard deviation of its positive and of its negative part
along the segment: 8 x ``n_bands`` numbers, L2-normalised, 0 for an invalid
segment. The matcher takes each segment's nearest neighbour by the dot
product, both ways, with the mutual check; view 0's matches are gated by
``score_th``, view 1's are not, as in the JAX package."""

from __future__ import annotations

from typing import ClassVar

import torch

from ...ops.interpolate import bilinear_sample
from ..base_model import BaseModel
from ..matchers.nearest_neighbor_matcher import NEG_INF, find_nn, mutual_check
from .lsd import grey_float


def image_gradients(gray: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Central differences of (B, H, W) images -> (gx, gy), 0 on the border."""
    gx, gy = torch.zeros_like(gray), torch.zeros_like(gray)
    gx[:, :, 1:-1] = 0.5 * (gray[:, :, 2:] - gray[:, :, :-2])
    gy[:, 1:-1, :] = 0.5 * (gray[:, 2:, :] - gray[:, :-2, :])
    return gx, gy


def lbd_describe(gray: torch.Tensor, lines: torch.Tensor, valid: torch.Tensor,
                 n_bands: int = 9, band_width: float = 7.0, n_samples: int = 32
                 ) -> torch.Tensor:
    """gray (B, H, W), lines (B, L, 2, 2), valid (B, L) -> descriptors
    (B, L, 8 * n_bands)."""
    b, n_lines = lines.shape[:2]
    gx, gy = image_gradients(gray)
    d = lines[..., 1, :] - lines[..., 0, :]
    dn = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True).clamp_min(1e-6)
    nrm = torch.stack([-dn[..., 1], dn[..., 0]], dim=-1)
    t = torch.linspace(0.0, 1.0, n_samples, dtype=lines.dtype, device=lines.device)
    offsets = ((torch.arange(n_bands, dtype=lines.dtype, device=lines.device)
                - (n_bands - 1) / 2.0) * band_width / max(n_bands - 1, 1) * 2.0)
    base = lines[..., None, 0, :] + t[:, None] * d[..., None, :]  # (B, L, S, 2)
    pts = base[..., None, :] + offsets[:, None] * nrm[..., None, None, :]  # (B, L, S, nb, 2)
    flat = pts.reshape(b, n_lines * n_samples * n_bands, 2)
    gxs = bilinear_sample(gx[..., None], flat)[..., 0].reshape(b, n_lines, n_samples, n_bands)
    gys = bilinear_sample(gy[..., None], flat)[..., 0].reshape(b, n_lines, n_samples, n_bands)
    g_d = gxs * dn[..., None, None, 0] + gys * dn[..., None, None, 1]
    g_n = gxs * nrm[..., None, None, 0] + gys * nrm[..., None, None, 1]
    feats = []
    for g in (g_d, g_n):
        for part in (g.clamp_min(0.0), (-g).clamp_min(0.0)):
            feats += [part.mean(dim=2), part.std(dim=2, correction=0)]
    desc = torch.cat(feats, dim=-1)
    desc = desc / torch.linalg.vector_norm(desc, dim=-1, keepdim=True).clamp_min(1e-8)
    return torch.where(valid[..., None], desc, 0.0)


class LBDDescriptor(BaseModel):
    """Adds ``line_descriptors`` to data that carries ``lines``."""

    default_conf: ClassVar[dict] = {"n_bands": 9, "band_width": 7.0, "n_samples": 32,
                                    "trainable": False}
    required_data_keys: ClassVar[list] = ["image", "lines"]

    def _forward(self, data: dict) -> dict:
        lines = data["lines"]
        valid = data.get("valid_lines")
        if valid is None:
            valid = torch.ones(lines.shape[:2], dtype=torch.bool, device=lines.device)
        desc = lbd_describe(grey_float(data["image"]), lines, valid,
                            n_bands=int(self.conf["n_bands"]),
                            band_width=float(self.conf["band_width"]),
                            n_samples=int(self.conf["n_samples"]))
        return {"line_descriptors": desc}


class LineMatcherLBD(BaseModel):
    """Mutual nearest neighbours of LBD descriptors by the dot product."""

    default_conf: ClassVar[dict] = {"score_th": 0.1, "trainable": False}
    required_data_keys: ClassVar[list] = ["line_descriptors0", "line_descriptors1"]

    def _forward(self, data: dict) -> dict:
        sim = torch.einsum("bld,bmd->blm", data["line_descriptors0"],
                           data["line_descriptors1"])
        vl0, vl1 = data.get("valid_lines0"), data.get("valid_lines1")
        if vl0 is not None:
            sim = sim.masked_fill(~vl0[:, :, None], NEG_INF)
        if vl1 is not None:
            sim = sim.masked_fill(~vl1[:, None, :], NEG_INF)
        m0, ms0 = find_nn(sim, None, None)
        m1, ms1 = find_nn(sim.transpose(-1, -2), None, None)
        ok = ms0 > float(self.conf["score_th"])
        return {
            "line_matches0": torch.where(ok, mutual_check(m0, m1), -1).to(torch.int32),
            "line_matches1": mutual_check(m1, m0).to(torch.int32),
            "line_matching_scores0": torch.where(ok, ms0, 0.0),
            "line_matching_scores1": ms1,
        }


__main_model__ = LBDDescriptor
