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
from pathlib import Path

import numpy as np

from ..core.config import collect_defaults, merge

logger = logging.getLogger(__name__)


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


class EvalPipeline:
    default_conf: dict = {}
    export_keys: list = []

    def __init__(self, conf: dict | None = None, device="cuda"):
        """``conf`` is merged over the ``default_conf`` of the class and its
        bases; the model and the geometry run on ``device``."""
        self.conf = merge(collect_defaults(type(self)), conf)
        self.device = device
        self._init(self.conf)

    def _init(self, conf: dict):
        pass

    def get_dataloader(self):
        raise NotImplementedError

    def get_predictions(self, experiment_dir: Path, model=None) -> Path:
        raise NotImplementedError

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
