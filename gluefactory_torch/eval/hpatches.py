"""HPatches homography benchmark (gluefactory_tpu/eval/hpatches.py).

Per pair: match precision under the ground-truth homography, the corner
error of a weighted DLT with IRLS, and the corner error of RANSAC at each
threshold of a sweep; the summary is the AUC at 1/3/5 px of the DLT and of
the threshold with the best mAA, and with both HPatches splits present, the
mAA and precision of each.

    python -m gluefactory_torch.eval.hpatches [--tag T] [--conf conf.json]
        [--device cuda|cpu] [--overwrite] [--overwrite_eval] [dot.key=value ...]

Without ``--conf`` it runs the flagship at 1024 keypoints
(``recipes.hpatches_flagship_conf``); results go to
``outputs/results/hpatches/<tag>``."""

from __future__ import annotations

import pprint
from collections import defaultdict
from pathlib import Path

import numpy as np

from ..models.cache_loader import CacheLoader
from ..recipes import hpatches_flagship_conf
from ..settings import EVAL_PATH
from ..utils.tools import AUCMetric
from .eval_pipeline import EvalPipeline, unbatch
from .io import get_eval_parser, parse_eval_args
from .utils import (
    eval_homography_dlt,
    eval_homography_robust,
    eval_matches_homography,
    eval_poses,
)

class HPatchesPipeline(EvalPipeline):
    default_conf = {
        "data": {
            "name": "hpatches",
            "test_batch_size": 1,
            "num_workers": 2,
            "preprocessing": {"resize": 480, "side": "long", "square_pad": True},
        },
        "model": {"name": None},
        "eval": {
            "estimator": "ransac",
            "ransac_th": -1.0,  # -1 sweeps SWEEP
            "num_hypotheses": 1024,
        },
        "checkpoint": None,
    }

    def run_eval(self, loader, pred_file: Path):
        cache_loader = CacheLoader({"path": str(pred_file), "collate": False})
        results = defaultdict(list)
        pose_results = defaultdict(list)
        for batch in loader:
            name = batch["name"][0]
            data, pred = unbatch(batch), cache_loader(batch)
            results_i = eval_matches_homography(data, pred, device=self.device)
            results_i.update(eval_homography_dlt(data, pred, device=self.device))
            for th, r in self.sweep(data, pred, eval_homography_robust).items():
                pose_results[th].append(r)
            results["names"].append(name)
            for k, v in results_i.items():
                results[k].append(v)
        summaries = {}
        for k, v in results.items():
            if k != "names":
                summaries[f"m{k}"] = round(float(np.nanmean(np.array(v, np.float64))), 3)
        dlt_errs = [e if np.isfinite(e) else 1e6 for e in results["H_error_dlt"]]
        for th, auc in zip([1, 3, 5], AUCMetric([1, 3, 5], dlt_errs).compute()):
            summaries[f"H_error_dlt@{th}px"] = round(auc * 100, 3)
        summaries.update(eval_poses(pose_results, auc_ths=[1, 3, 5], key="H_error_ransac",
                                    unit="px"))
        best_th = summaries["best_ransac_th"]
        results["H_error_ransac"] = [r["H_error_ransac"] for r in pose_results[best_th]]
        names = results["names"]
        for prefix in ("i_", "v_"):  # per split, when both are present
            sel = [i for i, n in enumerate(names) if str(n).startswith(prefix)]
            if not sel or len(sel) == len(names):
                continue
            errs = [results["H_error_ransac"][i] for i in sel]
            errs = [e if np.isfinite(e) else 1e6 for e in errs]
            split = prefix.rstrip("_")
            summaries[f"H_error_ransac_mAA_{split}"] = round(
                float(np.mean(AUCMetric([1, 3, 5], errs).compute())) * 100, 3)
            summaries[f"mprec@1px_{split}"] = round(
                float(np.nanmean([results["prec@1px"][i] for i in sel])), 3)
        return summaries, dict(results)


def main(argv: list[str] | None = None):
    args = get_eval_parser().parse_intermixed_args(argv)
    conf = parse_eval_args("hpatches", args, HPatchesPipeline.default_conf,
                           hpatches_flagship_conf())
    pipeline = HPatchesPipeline(conf, device=args.device)
    summaries, _ = pipeline.run(EVAL_PATH / "hpatches" / args.tag, overwrite=args.overwrite,
                                overwrite_eval=args.overwrite_eval)
    pprint.pprint(summaries)


if __name__ == "__main__":
    main()
