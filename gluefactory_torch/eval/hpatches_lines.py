"""The HPatches line benchmark: detection and matching of segments under the
ground-truth homography (gluefactory_tpu/eval/hpatches_lines.py).

Per pair, the view-0 segments are warped by H (and clipped to view 1) and
matched one to one to the view-1 segments (``eval.line_metrics``: the exact
assignment of least total distance) under the orthogonal distance with the
mutual-overlap gate and under the structural distance; each gives
repeatability at ``rep_thresholds`` and localisation error at
``loc_thresholds``. Where the model matched lines: their precision and
recall against the orthogonal assignment, their count, and the homography
of the line-only hybrid RANSAC over them (no points; a new estimator a pair,
seed 0), scored by its corner error (AUC at 1, 3 and 5 px). Summaries are
means over pairs (``np.nanmean``, which keeps an ``inf``), rounded to 4
places.

    python -m gluefactory_torch.eval.hpatches_lines [--tag T] [--conf NAME]
        [--checkpoint C] [--device cuda|cpu] [--overwrite] [--overwrite_eval]
        [dot.key=value ...]

``--conf`` takes a recipe of this benchmark by name (``recipes.LINE_CONFS``:
``lsd_lines``, ``lsd_lbd``, ``elsed_lines``, ``sold2_wunsch``,
``gluestick_stage0``; the default is ``lsd_lbd``), a config name under
``gluefactory_tpu/configs`` (``lsd+lbd``) or a file. Results go to
``outputs/results/hpatches_lines/<tag>``."""

from __future__ import annotations

import pprint
import time
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from ..geometry.homography import homography_corner_error, warp_lines
from ..models.cache_loader import CacheLoader
from ..robust_estimators import load_estimator
from ..settings import EVAL_PATH
from ..utils.tools import AUCMetric
from .eval_pipeline import EvalPipeline, synchronize, unbatch
from .io import get_eval_parser, parse_eval_args
from .line_metrics import (
    match_segments_one_to_one,
    segment_distance_matrix,
    segment_localization_error,
    segment_repeatability,
)


class HPatchesLinesPipeline(EvalPipeline):
    default_conf = {
        "data": {"name": "hpatches", "preprocessing": {"resize": 480, "side": "short"}},
        "model": {"name": "two_view_pipeline",
                  "extractor": {"name": "lines.lsd", "max_num_lines": 256}},
        "eval": {"rep_thresholds": [1.0, 3.0, 5.0], "loc_thresholds": [3.0, 5.0],
                 "min_overlap": 0.5, "ransac_th": 3.0},
        "checkpoint": None,
    }
    export_keys = ["lines0", "lines1", "valid_lines0", "valid_lines1"]
    optional_export_keys = ["line_scores0", "line_scores1", "line_matches0", "line_matches1",
                            "line_matching_scores0", "line_matching_scores1"]

    def __init__(self, conf: dict | None = None, device="cuda"):
        super().__init__(conf, device)
        self.timings.update(metrics_ms=[], line_ransac_ms=[])

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=self.device)[None]

    def _timed(self, key: str, fn, *args):
        """``fn(*args)``, its milliseconds (synchronised) added to
        ``timings[key]``."""
        synchronize(self.device)
        t = time.perf_counter()
        out = fn(*args)
        synchronize(self.device)
        self.timings[key].append((time.perf_counter() - t) * 1e3)
        return out

    def _line_metrics(self, segs0, segs1, vl0, vl1, H, size1, results) -> np.ndarray:
        """Repeatability and localisation of both distances into
        ``results``; returns the orthogonal assignment of view 0 (L0,)."""
        conf = self.conf["eval"]
        warped0, w_valid = warp_lines(segs0, H, size1)
        vl0w = vl0 & w_valid.cpu().numpy()
        n0, n1 = vl0w.sum(-1), vl1.sum(-1)
        results["num_lines0"].append(int(n0[0]))
        results["num_lines1"].append(int(n1[0]))
        dists = [segment_distance_matrix(warped0, segs1, kind=kind,
                                         min_overlap=float(conf["min_overlap"]))
                 for kind in ("orth", "struct")]
        # the two host assignments at once (the C++ call releases the GIL)
        with ThreadPoolExecutor(2) as pool:
            matched = list(pool.map(lambda d: match_segments_one_to_one(d, vl0w, vl1), dists))
        assigns = {}
        for kind, (assign, mdist) in zip(("orth", "struct"), matched):
            assigns[kind] = assign
            for k, v in segment_repeatability(mdist, n0, n1,
                                              list(conf["rep_thresholds"])).items():
                results[f"{kind}_{k}"].append(float(v[0]))
            for k, v in segment_localization_error(mdist,
                                                   list(conf["loc_thresholds"])).items():
                results[f"{kind}_{k}"].append(float(v[0]))
        return assigns["orth"][0]

    def _line_homography(self, segs0, segs1, lm0, matched) -> dict:
        """The line-only hybrid RANSAC over the matched segments, a new
        estimator (seed 0) each pair, as the JAX package builds one."""
        est = load_estimator("homography", "hybrid_ransac")(
            {"ransac_th": float(self.conf["eval"]["ransac_th"])})
        sel = torch.from_numpy(matched).to(self.device)
        cols = torch.from_numpy(np.clip(lm0, 0, None)[matched]).long().to(self.device)
        empty = torch.zeros((0, 2), dtype=torch.float32, device=self.device)
        return est({"m_kpts0": empty, "m_kpts1": empty, "m_lines0": segs0[0][sel],
                    "m_lines1": segs1[0][cols]})

    def run_eval(self, loader, pred_file: Path):
        cache_loader = CacheLoader({"path": str(pred_file), "collate": False})
        results = defaultdict(list)
        auc_line_h = AUCMetric([1, 3, 5])
        for batch in loader:
            data, pred = unbatch(batch), cache_loader(batch)
            H = self._tensor(data["H_0to1"])
            size1 = self._tensor(data["view1"]["image_size"])
            segs0, segs1 = self._tensor(pred["lines0"]), self._tensor(pred["lines1"])
            vl0 = np.asarray(pred.get("valid_lines0", np.ones(segs0.shape[1], bool)))[None]
            vl1 = np.asarray(pred.get("valid_lines1", np.ones(segs1.shape[1], bool)))[None]
            gt = self._timed("metrics_ms", self._line_metrics, segs0, segs1, vl0, vl1, H,
                             size1, results)
            if "line_matches0" not in pred:
                continue
            lm0 = np.asarray(pred["line_matches0"])
            matched = lm0 > -1
            if not matched.any():
                continue
            correct = matched & (lm0 == gt)
            results["line_match_precision"].append(
                float(correct.sum() / max(matched.sum(), 1)))
            results["line_match_recall"].append(float(correct.sum() / max((gt >= 0).sum(), 1)))
            results["num_line_matches"].append(int(matched.sum()))
            out = self._timed("line_ransac_ms", self._line_homography, segs0, segs1, lm0,
                              matched)
            if out["success"]:
                err = float(homography_corner_error(out["M_0to1"], H[0], size1[0]))
                results["H_error_lines"].append(err)
                auc_line_h.update([err])
        summaries = {f"m{k}": round(float(np.nanmean(v)), 4) for k, v in results.items() if v}
        if results.get("H_error_lines"):
            for t, a in zip([1, 3, 5], auc_line_h.compute()):
                summaries[f"H_error_lines@{t}px"] = round(float(a), 4)
        return summaries, dict(results)


def run_lines(pipeline_cls, benchmark: str, default_name: str,
              argv: list[str] | None = None) -> dict:
    """The CLI of a line benchmark: ``--conf`` names a recipe of
    ``recipes.LINE_CONFS[benchmark]`` (``default_name`` when none is given),
    a config under ``gluefactory_tpu/configs`` or a file; run and print the
    summaries."""
    from ..recipes import line_conf

    args = get_eval_parser().parse_intermixed_args(argv)
    named = line_conf(benchmark, args.conf or default_name)
    if named is not None:
        args.conf = None
    conf = parse_eval_args(benchmark, args, pipeline_cls.default_conf, named or {})
    pipeline = pipeline_cls(conf, device=args.device)
    summaries, _ = pipeline.run(EVAL_PATH / benchmark / args.tag, overwrite=args.overwrite,
                                overwrite_eval=args.overwrite_eval)
    pprint.pprint(summaries)
    return summaries


def main(argv: list[str] | None = None):
    return run_lines(HPatchesLinesPipeline, "hpatches_lines", "lsd_lbd", argv)


if __name__ == "__main__":
    main()
