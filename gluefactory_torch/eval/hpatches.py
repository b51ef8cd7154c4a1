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
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

from ..core.config import merge
from ..datasets import get_dataset
from ..recipes import hpatches_flagship_conf
from ..settings import EVAL_PATH
from ..utils.device import resolve_device
from ..utils.tools import AUCMetric
from .eval_pipeline import EvalPipeline
from .io import get_eval_parser, load_model, parse_eval_args
from .utils import (
    eval_homography_dlt,
    eval_homography_robust,
    eval_matches_homography,
    eval_poses,
)

SWEEP = [0.5, 1.0, 1.5, 2.0, 2.5, 3.0]  # RANSAC thresholds (px) when ransac_th is -1


def to_model_input(batch: dict, device: torch.device) -> dict:
    """The arrays of a collated batch as tensors on ``device``; names and
    other non-arrays are dropped."""
    out = {}
    for key, value in batch.items():
        if isinstance(value, dict):
            out[key] = to_model_input(value, device)
        elif isinstance(value, np.ndarray):
            out[key] = torch.from_numpy(value).to(device)
    return out


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


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
    export_keys = [
        "keypoints0", "keypoints1", "keypoint_scores0", "keypoint_scores1",
        "keypoint_valid0", "keypoint_valid1",
        "matches0", "matches1", "matching_scores0", "matching_scores1",
    ]

    def _init(self, conf):
        self.device = resolve_device(self.device)
        self.dataset = get_dataset(conf["data"]["name"])(conf["data"])
        # host-clock milliseconds a pair, each ended by a device synchronise
        self.timings = {"forward_ms": [], "ransac_sweep_ms": []}

    def get_dataloader(self):
        return self.dataset.get_data_loader("test")

    def get_predictions(self, experiment_dir: Path, model=None) -> Path:
        """Run the model over the benchmark and cache what ``export_keys``
        names, as the JAX export does: keypoints in original-image pixels,
        float32 stored as float16."""
        pred_file = Path(experiment_dir) / "predictions.npz"
        if model is None:
            model = load_model(self.conf["model"], self.conf.get("checkpoint"), self.device)
        cache = defaultdict(list)
        for batch in self.get_dataloader():
            data = to_model_input(batch, self.device)
            _synchronize(self.device)
            t = time.perf_counter()
            with torch.inference_mode():
                pred = model(data)
            _synchronize(self.device)
            self.timings["forward_ms"].append((time.perf_counter() - t) * 1e3)
            pred = {k: v.cpu().numpy() for k, v in pred.items() if k in self.export_keys}
            for i, name in enumerate(batch["name"]):
                cache["names"].append(name)
                for key, value in pred.items():
                    value = value[i]
                    view = batch.get(f"view{key[-1]}", {})
                    if key.startswith("keypoints") and "scales" in view:
                        value = value / view["scales"][i]
                    if value.dtype == np.float32:
                        value = value.astype(np.float16)
                    cache[key].append(value)
        np.savez(pred_file, **{k: np.stack(v) if k != "names" else np.array(v)
                               for k, v in cache.items()})
        return pred_file

    def run_eval(self, loader, pred_file: Path):
        conf = self.conf["eval"]
        thresholds = SWEEP if conf["ransac_th"] == -1.0 else [conf["ransac_th"]]
        with np.load(pred_file) as f:
            cache = {k: f[k] for k in f.files}
        row = {str(n): i for i, n in enumerate(cache.pop("names"))}
        results = defaultdict(list)
        pose_results = defaultdict(list)
        for batch in loader:
            name = batch["name"][0]
            data = {k: ({kk: vv[0] for kk, vv in v.items()} if isinstance(v, dict) else v[0])
                    for k, v in batch.items() if k != "name"}
            pred = {k: v[row[name]] for k, v in cache.items()}
            pred = {k: v.astype(np.float32) if v.dtype == np.float16 else v
                    for k, v in pred.items()}
            for vid in ("0", "1"):  # back to the canvas of this view
                pred[f"keypoints{vid}"] = pred[f"keypoints{vid}"] * data[f"view{vid}"]["scales"]
            results_i = eval_matches_homography(data, pred, device=self.device)
            results_i.update(eval_homography_dlt(data, pred, device=self.device))
            _synchronize(self.device)
            t = time.perf_counter()
            for th in thresholds:
                pose_results[th].append(eval_homography_robust(
                    data, pred, merge(conf, {"ransac_th": th}), device=self.device))
            _synchronize(self.device)
            self.timings["ransac_sweep_ms"].append((time.perf_counter() - t) * 1e3)
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
