"""Two-phase benchmark pipeline (gluefactory_tpu/eval/eval_pipeline.py).

Phase 1 (``get_predictions``) runs the model over the benchmark once and
caches its predictions; phase 2 (``run_eval``) scores the cache, so a sweep
of estimators or thresholds reuses one export. The JAX package writes HDF5
and YAML; the GPU machine has neither library, so here predictions and
per-pair results are ``.npz`` files, the conf is ``conf.json`` and the
summaries ``summaries.json``. The conf check is the JAX one: a changed model
needs ``overwrite``, a changed evaluation ``overwrite_eval``."""

from __future__ import annotations

import json
import logging
import time
from pathlib import Path

import numpy as np
import torch

from ..core.config import collect_defaults, merge
from ..datasets import get_dataset
from ..utils.device import resolve_device
from ..utils.export_predictions import export_predictions
from .io import load_model

logger = logging.getLogger(__name__)

SWEEP = [0.5, 1.0, 1.5, 2.0, 2.5, 3.0]  # RANSAC thresholds (px) when eval.ransac_th is -1


def load_eval(dir_: Path) -> tuple[dict, dict]:
    """(summaries, per-pair results) of an evaluation directory."""
    dir_ = Path(dir_)
    summaries = json.loads((dir_ / "summaries.json").read_text())
    with np.load(dir_ / "results.npz") as f:
        results = {k: f[k] for k in f.files if f[k].ndim < 3}
    return summaries, results


def save_eval(dir_: Path, summaries: dict, results: dict) -> None:
    dir_ = Path(dir_)
    dir_.mkdir(parents=True, exist_ok=True)
    np.savez(dir_ / "results.npz", **{k: np.asarray(v) for k, v in results.items()})
    s = {k: (float(v) if np.isscalar(v) and np.isfinite(np.float64(v)) else str(v))
         for k, v in summaries.items()}
    (dir_ / "summaries.json").write_text(json.dumps(s, indent=4))


def exists_eval(dir_: Path) -> bool:
    dir_ = Path(dir_)
    return (dir_ / "results.npz").exists() and (dir_ / "summaries.json").exists()


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


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def unbatch(batch: dict) -> dict:
    """Item 0 of a collated batch of one; names are dropped."""
    return {k: ({kk: vv[0] for kk, vv in v.items()} if isinstance(v, dict) else v[0])
            for k, v in batch.items() if k != "name"}


class EvalPipeline:
    """A benchmark over the dataset named by ``conf['data']``: ``run`` caches
    the model's predictions (``export_keys``, and ``optional_export_keys``
    where the model makes them), then scores them
    (``run_eval``). ``timings`` holds host-clock milliseconds a pair, each
    ended by a device synchronise: ``forward_ms`` and ``ransac_sweep_ms``."""

    default_conf: dict = {}
    export_keys: list = [
        "keypoints0", "keypoints1", "keypoint_scores0", "keypoint_scores1",
        "keypoint_valid0", "keypoint_valid1",
        "matches0", "matches1", "matching_scores0", "matching_scores1",
    ]
    optional_export_keys: list = []

    def __init__(self, conf: dict | None = None, device="cuda"):
        """``conf`` is merged over the ``default_conf`` of the class and its
        bases; the model and the geometry run on ``device``."""
        self.conf = merge(collect_defaults(type(self)), conf)
        self.device = resolve_device(device)
        self.dataset = get_dataset(self.conf["data"]["name"])(self.conf["data"])
        self.timings = {"forward_ms": [], "ransac_sweep_ms": []}

    def get_dataloader(self):
        return self.dataset.get_data_loader("test")

    def get_predictions(self, experiment_dir: Path, model=None) -> Path:
        """Run the model over the benchmark and cache what ``export_keys``
        names, as the JAX export does: keypoints in original-image pixels,
        float32 stored as float16 (``utils.export_predictions``)."""
        if model is None:
            model = load_model(self.conf["model"], self.conf.get("checkpoint"), self.device)

        def predict(batch):
            data = to_model_input(batch, self.device)
            synchronize(self.device)
            t = time.perf_counter()
            with torch.inference_mode():
                pred = model(data)
            synchronize(self.device)
            self.timings["forward_ms"].append((time.perf_counter() - t) * 1e3)
            return pred

        return export_predictions(
            self.get_dataloader(), predict, Path(experiment_dir) / "predictions.npz",
            keys=self.export_keys,
            optional_keys=("keypoint_valid0", "keypoint_valid1", *self.optional_export_keys))

    def sweep(self, data: dict, pred: dict, estimate_sweep) -> dict:
        """{threshold: result} of ``estimate_sweep(data, pred, conf,
        thresholds, device=...)`` over the RANSAC thresholds (``SWEEP`` when
        ``eval.ransac_th`` is -1, else that one); the whole sweep's time goes
        to ``ransac_sweep_ms``."""
        conf = self.conf["eval"]
        thresholds = SWEEP if conf["ransac_th"] == -1.0 else [conf["ransac_th"]]
        synchronize(self.device)
        t = time.perf_counter()
        out = estimate_sweep(data, pred, conf, thresholds, device=self.device)
        synchronize(self.device)
        self.timings["ransac_sweep_ms"].append((time.perf_counter() - t) * 1e3)
        return out

    def run_eval(self, loader, pred_file: Path) -> tuple[dict, dict]:
        """(summaries, per-pair results) of the cached predictions."""
        raise NotImplementedError

    def save_conf(self, experiment_dir: Path, overwrite=False, overwrite_eval=False):
        """Refuse to mix a cache with another conf unless asked to overwrite."""
        path = Path(experiment_dir) / "conf.json"
        if path.exists():
            saved = json.loads(path.read_text())
            if saved.get("model", {}) != self.conf.get("model", {}) and not overwrite:
                raise RuntimeError("the model conf differs from the cached predictions' "
                                   "conf; pass overwrite=True")
            if saved != self.conf and not (overwrite or overwrite_eval):
                raise RuntimeError("the evaluation conf differs from the cached one; "
                                   "pass overwrite_eval=True")
        Path(experiment_dir).mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.conf, indent=2))

    def run(self, experiment_dir: Path, model=None, overwrite=False, overwrite_eval=False):
        """Predict (unless cached), score (unless cached), return (summaries,
        results)."""
        experiment_dir = Path(experiment_dir)
        experiment_dir.mkdir(parents=True, exist_ok=True)
        self.save_conf(experiment_dir, overwrite=overwrite, overwrite_eval=overwrite_eval)
        pred_file = experiment_dir / "predictions.npz"
        if not pred_file.exists() or overwrite:
            pred_file = self.get_predictions(experiment_dir, model=model)
        if not exists_eval(experiment_dir) or overwrite or overwrite_eval:
            save_eval(experiment_dir, *self.run_eval(self.get_dataloader(), pred_file))
        summaries, results = load_eval(experiment_dir)
        logger.info("Eval summaries: %s", summaries)
        return summaries, results
