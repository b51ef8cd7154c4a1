"""MegaDepth-1500 relative-pose benchmark (gluefactory_tpu/eval/megadepth1500.py).

Per pair: the share of matches within 1e-4, 5e-4 and 1e-3 of their epipolar
lines under the ground-truth pose, and the pose error (the larger of the
rotation and translation angles) of 5-point LO-RANSAC at each threshold of a
sweep; the summary is the pose AUC at 5/10/20 degrees of the threshold with
the best mAA. The pairs are calibrated image pairs
(``datasets/image_pairs.py``): the real MegaDepth-1500 list, or the rendered
set of ``scripts/generate_pose_eval_set.py``.

    python -m gluefactory_torch.eval.megadepth1500 [--tag T] [--conf conf.json]
        [--device cuda|cpu] [--overwrite] [--overwrite_eval] [dot.key=value ...]

Without ``--conf`` it runs the flagship at 1024 keypoints on a 1600-pixel
canvas (``recipes.pose_flagship_conf``, pairs under ``data/pose-eval``);
results go to ``outputs/results/megadepth1500/<tag>``."""

from __future__ import annotations

import pprint
from collections import defaultdict
from pathlib import Path

import numpy as np

from ..models.cache_loader import CacheLoader
from ..recipes import pose_flagship_conf
from ..settings import EVAL_PATH
from .eval_pipeline import EvalPipeline, unbatch
from .io import get_eval_parser, parse_eval_args
from .utils import eval_matches_epipolar, eval_poses, eval_relative_pose_robust_sweep

class MegaDepth1500Pipeline(EvalPipeline):
    default_conf = {
        "data": {
            "name": "image_pairs",
            "pairs": "megadepth1500/pairs_calibrated.txt",
            "root": "megadepth1500/images",
            "preprocessing": {"resize": 1600, "side": "long", "square_pad": True},
            "test_batch_size": 1,
            "num_workers": 2,
        },
        "model": {"name": None},
        "eval": {
            "estimator": "ransac",
            "ransac_th": -1.0,  # -1 sweeps SWEEP
            "num_hypotheses": 2048,
            "lo_iters": 6,
        },
        "checkpoint": None,
    }

    def run_eval(self, loader, pred_file: Path):
        cache_loader = CacheLoader({"path": str(pred_file), "collate": False})
        results = defaultdict(list)
        pose_results = defaultdict(list)
        for batch in loader:
            data, pred = unbatch(batch), cache_loader(batch)
            results_i = eval_matches_epipolar(data, pred, device=self.device)
            for th, r in self.sweep(data, pred, eval_relative_pose_robust_sweep).items():
                pose_results[th].append(r)
            results["names"].append(batch["name"][0])
            for k, v in results_i.items():
                results[k].append(v)
        summaries = {f"m{k}": round(float(np.nanmean(np.array(v, np.float64))), 3)
                     for k, v in results.items() if k != "names"}
        summaries.update(eval_poses(pose_results, auc_ths=[5, 10, 20], key="rel_pose_error",
                                    unit="°"))
        results["rel_pose_error"] = [
            r["rel_pose_error"] for r in pose_results[summaries["best_ransac_th"]]]
        return summaries, dict(results)


def run(pipeline_cls, benchmark: str, named_conf: dict, argv: list[str] | None = None) -> dict:
    """The CLI of a relative-pose benchmark: parse (``named_conf`` when no
    ``--conf`` is given), run, print the summaries."""
    args = get_eval_parser().parse_intermixed_args(argv)
    conf = parse_eval_args(benchmark, args, pipeline_cls.default_conf, named_conf)
    pipeline = pipeline_cls(conf, device=args.device)
    summaries, _ = pipeline.run(EVAL_PATH / benchmark / args.tag, overwrite=args.overwrite,
                                overwrite_eval=args.overwrite_eval)
    pprint.pprint(summaries)
    return summaries


def main(argv: list[str] | None = None):
    run(MegaDepth1500Pipeline, "megadepth1500", pose_flagship_conf(), argv)


if __name__ == "__main__":
    main()
