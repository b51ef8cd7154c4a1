"""The nearest-neighbour point and line matcher
(gluefactory_tpu/models/matchers/nn_point_line.py).

Points match by mutual nearest neighbour on descriptor similarity. Where
the views carry ``lines`` and a dense descriptor map
(``descriptors_dense``), lines match too: ``n_line_samples`` points along
each line are described bilinearly from the map (L2-normalised), two lines
score the better of the mean sample similarity in the straight and the
reversed order, and mutual best pairs above ``line_score_th`` match."""

from __future__ import annotations

from typing import ClassVar

import torch

from ...ops.interpolate import bilinear_sample
from ..base_model import BaseModel
from .nearest_neighbor_matcher import NEG_INF, find_nn, mutual_check


class NNPointLine(BaseModel):
    default_conf: ClassVar[dict] = {
        "n_line_samples": 8,
        "line_score_th": 0.2,
        "trainable": False,
    }
    required_data_keys: ClassVar[list] = ["descriptors0", "descriptors1"]

    @staticmethod
    def _mutual_nn(sim: torch.Tensor, valid0, valid1):
        if valid0 is not None:
            sim = sim.masked_fill(~valid0[:, :, None], NEG_INF)
        if valid1 is not None:
            sim = sim.masked_fill(~valid1[:, None, :], NEG_INF)
        m0, ms0 = find_nn(sim, None, None)
        m1, ms1 = find_nn(sim.transpose(-1, -2), None, None)
        return mutual_check(m0, m1), mutual_check(m1, m0), ms0, ms1

    def _point_matches(self, data: dict) -> dict:
        sim = torch.einsum("bnd,bmd->bnm", data["descriptors0"], data["descriptors1"])
        m0, m1, ms0, ms1 = self._mutual_nn(sim, data.get("keypoint_valid0"),
                                           data.get("keypoint_valid1"))
        return {"matches0": m0, "matches1": m1, "matching_scores0": ms0,
                "matching_scores1": ms1}

    def _line_matches(self, data: dict) -> dict:
        if "lines0" not in data or "descriptors_dense0" not in data:
            return {}
        s = int(self.conf["n_line_samples"])
        descs = []
        for i in "01":
            lines = data[f"lines{i}"]
            b, n_lines = lines.shape[:2]
            t = torch.linspace(0.0, 1.0, s, dtype=lines.dtype, device=lines.device)
            pts = lines[:, :, None, 0, :] + t[None, None, :, None] * (
                lines[:, :, 1, :] - lines[:, :, 0, :])[:, :, None, :]
            d = bilinear_sample(data[f"descriptors_dense{i}"], pts.reshape(b, n_lines * s, 2))
            d = d / (torch.linalg.vector_norm(d, dim=-1, keepdim=True) + 1e-8)
            descs.append(d.reshape(b, n_lines, s, -1))
        d0, d1 = descs
        sim = torch.maximum(torch.einsum("blsd,bmsd->blm", d0, d1) / s,
                            torch.einsum("blsd,bmsd->blm", d0, d1.flip(2)) / s)
        m0, m1, ms0, ms1 = self._mutual_nn(sim, data.get("valid_lines0"),
                                           data.get("valid_lines1"))
        ok = ms0 > float(self.conf["line_score_th"])
        return {"line_matches0": torch.where(ok, m0, -1),
                "line_matching_scores0": torch.where(ok, ms0, 0.0),
                "line_matches1": m1, "line_matching_scores1": ms1}

    def _forward(self, data: dict) -> dict:
        return {**self._point_matches(data), **self._line_matches(data)}

    def loss(self, pred: dict, data: dict):
        raise NotImplementedError


__main_model__ = NNPointLine
