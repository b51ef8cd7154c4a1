"""The Needleman-Wunsch line matcher (gluefactory_tpu/models/matchers/wunsch_line_matcher.py).

Each segment is sampled at ``num_samples`` points and described by the
L2-normalised descriptors there (bilinear from ``descriptors_dense``, a map
at ``desc_stride``, or the given ``line_desc_samples``). Two segments score
the better of two Needleman-Wunsch alignments of their sample sequences
(view 1's as it is and reversed; gap score ``gap_score``) over the sample
count; mutual best pairs above ``min_score`` match.

The alignment of all B x L0 x L1 pairs runs as one batched dynamic
programme: the recurrence's in-row term D[i, j-1] + gap is a running maximum
of D[i, j] - gap * j, so each of the ``num_samples`` rows is one
``torch.cummax`` over the pairs. At 512 x 512 lines and 8 x 8 samples the
similarities are 16.8 M floats (67 MB) a pair of images, and each of the two
passes makes 8 rows of 2.4 M x 9 floats."""

from __future__ import annotations

from typing import ClassVar

import torch

from ...ops.interpolate import sample_descriptors
from ..base_model import BaseModel


def nw_scores(sim: torch.Tensor, gap: float) -> torch.Tensor:
    """The Needleman-Wunsch terminal scores of similarity matrices (..., n,
    m) -> (...,), with D[0, j] = gap * j and D[i, 0] = gap * i."""
    n, m = sim.shape[-2:]
    batch = sim.shape[:-2]
    M = sim.reshape(-1, n, m)
    js = torch.arange(m + 1, dtype=sim.dtype, device=sim.device) * gap
    row = js.expand(M.shape[0], m + 1)
    for i in range(n):
        a = torch.maximum(row[:, :-1] + M[:, i], row[:, 1:] + gap)
        b = torch.cat([row[:, :1] + gap, a - js[None, 1:]], dim=1)
        row = torch.cummax(b, dim=1).values + js[None]
    return row[:, -1].reshape(batch)


def _normalise(d: torch.Tensor) -> torch.Tensor:
    return d / torch.linalg.vector_norm(d, dim=-1, keepdim=True).clamp_min(1e-8)


class WunschLineMatcher(BaseModel):
    default_conf: ClassVar[dict] = {
        "num_samples": 8,
        "gap_score": 0.1,
        "desc_stride": 4,  # stride of descriptors_dense with respect to the image
        "min_score": 0.2,
        "cross_check": True,
    }
    # the descriptors come from descriptors_dense{0,1} (sampled here) or from
    # line_desc_samples{0,1}
    required_data_keys: ClassVar[list] = ["lines0", "lines1"]

    def _sample(self, desc_map: torch.Tensor, lines: torch.Tensor) -> torch.Tensor:
        b, n_lines = lines.shape[:2]
        n = int(self.conf["num_samples"])
        t = torch.linspace(0.0, 1.0, n, dtype=lines.dtype, device=lines.device)[None, None, :, None]
        pts = lines[:, :, None, 0] + (lines[:, :, 1] - lines[:, :, 0])[:, :, None] * t
        d = sample_descriptors(desc_map, pts.reshape(b, n_lines * n, 2),
                               stride=int(self.conf["desc_stride"]))
        return _normalise(d).reshape(b, n_lines, n, -1)

    def scores(self, data: dict) -> torch.Tensor:
        """(B, L0, L1) alignment scores over the sample count, -inf where a
        segment is invalid."""
        lines0, lines1 = data["lines0"], data["lines1"]
        b, l0 = lines0.shape[:2]
        l1 = lines1.shape[1]
        v0, v1 = self._valid(data, 0, (b, l0)), self._valid(data, 1, (b, l1))
        if "line_desc_samples0" in data:
            d0 = _normalise(data["line_desc_samples0"])
            d1 = _normalise(data["line_desc_samples1"])
        elif "descriptors_dense0" in data:
            d0 = self._sample(data["descriptors_dense0"], lines0)
            d1 = self._sample(data["descriptors_dense1"], lines1)
        else:
            raise KeyError("WunschLineMatcher requires descriptors_dense0/1 or "
                           f"line_desc_samples0/1; got {list(data)}")
        sim = torch.einsum("bind,bjmd->bijnm", d0, d1)
        gap = float(self.conf["gap_score"])
        scores = torch.maximum(nw_scores(sim, gap), nw_scores(sim.flip(-1), gap)) / d0.shape[-2]
        return scores.masked_fill(~(v0[:, :, None] & v1[:, None, :]), float("-inf"))

    @staticmethod
    def _valid(data: dict, i: int, shape: tuple) -> torch.Tensor:
        v = data.get(f"valid_lines{i}")
        return torch.ones(shape, dtype=torch.bool, device=data["lines0"].device) if v is None else v

    def _forward(self, data: dict) -> dict:
        scores = self.scores(data)
        b, l0, l1 = scores.shape
        dev = scores.device
        v0, v1 = self._valid(data, 0, (b, l0)), self._valid(data, 1, (b, l1))
        min_score = float(self.conf["min_score"])
        sc0, best0 = scores.max(dim=2)
        sc1, best1 = scores.max(dim=1)
        ok = sc0 > min_score
        if self.conf["cross_check"]:
            ok = ok & (best1.gather(1, best0) == torch.arange(l0, device=dev))
        ok = ok & v0
        ok1 = (scores > min_score).gather(1, best1[:, None, :])[:, 0] & v1
        if self.conf["cross_check"]:
            ok1 = ok1 & (best0.gather(1, best1) == torch.arange(l1, device=dev))
        m1 = torch.where(ok1, best1, -1)
        return {
            "line_matches0": torch.where(ok, best0, -1),
            "line_matches1": m1,
            "line_matching_scores0": torch.where(ok, sc0, 0.0),
            "line_matching_scores1": torch.where(m1 >= 0, sc1, 0.0),
        }


__main_model__ = WunschLineMatcher
