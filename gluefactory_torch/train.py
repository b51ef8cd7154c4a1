"""Training (gluefactory_tpu/train.py) on one GPU: each step takes its
batch, runs the pipeline and its loss, backpropagates and updates the
trainable parameters. A dataset with ``device_engine`` (the on-device
engines) makes each batch on the card from one seed; any other dataset's
batches come from its host loader (``base_dataset.DataLoader``: read ahead
in worker processes), their strings dropped, copied to the card from pinned memory
without blocking (inside the step); each step's scalars then hold
``data_ms``, the host's wait for the loader's next batch, beside the
step's ``ms``.

As in the JAX trainer:
  - gradients are computed for every parameter, frozen ones included
    (``trainable: False`` components keep ``requires_grad``), so the logged
    ``grad_norm`` and the skip test cover them; the optimizer holds only the
    trainable parameters, and the gradient clip sees only those;
  - the clip is optax's ``clip_by_global_norm``: g * max / norm when
    norm >= max, else g unchanged;
  - ``lr_scaling: [[scale, [substring, ...]], ...]`` scales the updates of the
    parameters whose flax path (``params/matcher/transformers_0/...``) holds
    one of the substrings; the plateau controller (``lr_schedule.type:
    plateau``) scales every update after ``patience`` evaluations without a
    better ``best_key``;
  - a step whose loss or gradient norm is not finite changes nothing, not
    even the optimizer's step count, which the learning-rate schedule reads
    (0 for the first update);
  - ``training`` runs the loop: ``load_experiment`` (a run, a ``.ckpt`` or a
    committed ``.msgpack`` blob, or several separated by commas, restored a
    whole component at a time: ``utils/experiments.restore_components``,
    which drops a full pipeline's ``['extractor']`` half for a matcher-only
    model and refuses a component held in part) or ``--restore``
    (parameters, Adam state, epoch and iteration of the run's last
    checkpoint); with
    ``overfit`` each epoch is the dataset's overfit loader (the seed of step
    0, or the first item); scalars averaged every ``log_every_iter`` steps
    into ``metrics.jsonl``; every ``eval_every_iter`` steps an evaluation on
    the val split (``val/*``, ``match_AP``) and a checkpoint; at each epoch
    end the
    benchmarks of ``run_benchmarks`` (every ``benchmark_every_epoch``
    epochs), on a model overlay each that shares the live parameters, whose
    summaries (``bench/<name>/<key>``) can pick ``checkpoint_best``
    (``best_key``, ``best_mode``), then an evaluation and a checkpoint;
    SIGINT stops after the step, with an evaluation and an ``_interrupted``
    checkpoint. Checkpoints are the JAX package's (utils/experiments.py).

Not ported: several GPUs, the code snapshot and the profiler. The keys that
the JAX trainer ignores (``save_every_iter``, ``log_grad_every_iter``,
``opt_regexp``, ``mixed_precision``, ``log_dir``, ``dataset_callback_*``,
``lr_schedule.on_epoch``) are ignored here too.

CLI: ``python -m gluefactory_torch.train <experiment> [--conf c.json|c.yaml]
[--restore] [--steps N] [--device cuda] [--weights blob] [dot.key=value ...]``
writes under ``outputs/training/<experiment>``. ``--conf`` reads JSON with
the standard library and YAML where the ``yaml`` package is installed (the
GPU machine has none: give it JSON, or no ``--conf`` and the recipe as
dot.keys). ``--steps`` stops after N steps, without evaluation or checkpoint;
``--weights`` loads a committed blob strictly in place of ``load_experiment``.
"""

from __future__ import annotations

import argparse
import json
import logging
import math
import signal
import time
from collections import defaultdict
from collections.abc import Callable
from pathlib import Path

import numpy as np
import torch

from .core.config import dotlist_to_dict, load_conf, merge
from .datasets import get_dataset
from .datasets.homographies_ondevice import upload_pool
from .eval import get_benchmark, run_benchmark
from .flagship import load_weights
from .models import build_model
from .models.matchers.lightglue import head_counts
from .settings import TRAINING_PATH
from .utils.device import resolve_device
from .utils.experiments import (
    load_experiment,
    restore_components,
    restore_from_flat_dict,
    save_conf,
    save_experiment,
)
from .utils.tools import AverageMetric
from .utils.weights import _flax_path, flat_from_params, flax_key, params_from_flat

logger = logging.getLogger(__name__)

default_train_conf = {
    "seed": 0,  # of the model's initialisation
    "epochs": 1,
    "optimizer": "adam",  # adam | adamw
    "opt_regexp": None,  # ignored, as in JAX
    "optimizer_options": {},  # optax names: b1, b2, eps (, weight_decay for adamw)
    "lr": 1e-4,
    "lr_schedule": {"type": None, "start": 0, "exp_div_10": 0, "on_epoch": False,
                    "factor": 1.0},  # type: None | exp | factor | plateau
    "lr_scaling": [],  # [[scale, [substring, ...]], ...]
    "eval_every_iter": 1000,
    "save_every_iter": 5000,  # ignored, as in JAX
    "log_every_iter": 200,
    "log_grad_every_iter": None,  # ignored, as in JAX
    "keep_last_checkpoints": 5,
    "load_experiment": None,  # a run, a .ckpt or a weights/*.msgpack blob (or several, a,b)
    "clip_grad": 1.0,
    "best_key": "loss/total",
    "best_mode": "min",  # 'max' for benchmark metrics such as bench/<name>/<key>_mAA
    "dataset_callback_fn": None,  # ignored, as in JAX
    "dataset_callback_on_val": False,
    "overfit": False,  # every epoch the dataset's overfit loader
    "num_steps_per_epoch": None,  # cap on the steps of an epoch
    "mixed_precision": None,  # ignored, as in JAX (the models' dtype keys cast)
    "log_dir": None,  # ignored, as in JAX
    "run_benchmarks": [],  # [{name, conf, model (an overlay of the model conf)}, ...]
    "benchmark_every_epoch": 1,
}

default_conf = {"data": {"name": None}, "model": {"name": None}, "train": default_train_conf}


def make_lr_schedule(conf: dict) -> Callable[[int], float]:
    """The learning rate of update ``step`` (0-based): constant, or from
    ``start`` on divided by 10 every ``exp_div_10`` steps ('exp'), or times
    ``factor`` ('factor'). 'plateau' is constant here: its scale is the
    PlateauController's."""
    base_lr = float(conf["lr"])
    sched = conf["lr_schedule"]
    kind = sched.get("type")
    if kind not in (None, "exp", "factor", "plateau"):
        raise NotImplementedError(f"lr schedule {kind!r} is not ported")

    def schedule(step: int) -> float:
        start = float(sched.get("start", 0))
        if kind not in ("exp", "factor") or step < start:
            return base_lr
        if kind == "exp":
            return base_lr * 10 ** (-(step - start) / max(float(sched.get("exp_div_10", 1e9)),
                                                          1.0))
        return base_lr * float(sched.get("factor", 1.0))

    return schedule


class PlateauController:
    """ReduceLROnPlateau: watches the validation ``best_key`` (lower is
    better) and multiplies the scale of every update by ``factor`` after
    ``patience`` evaluations without a better value, down to ``min_scale``."""

    def __init__(self, sched: dict):
        self.enabled = sched.get("type") == "plateau"
        self.factor = float(sched.get("factor", 0.5))
        self.patience = int(sched.get("patience", 3))
        self.min_scale = float(sched.get("min_scale", 1e-3))
        self.best = None
        self.bad = 0
        self.scale = 1.0

    def update(self, metric: float) -> bool:
        """Returns True when the scale changed."""
        if not self.enabled or not np.isfinite(metric):
            return False
        if self.best is None or metric < self.best - 1e-12:
            self.best = metric
            self.bad = 0
            return False
        self.bad += 1
        if self.bad >= self.patience and self.scale > self.min_scale:
            self.scale = max(self.scale * self.factor, self.min_scale)
            self.bad = 0
            logger.info("Plateau: scaling LR by %.3g -> x%.3g", self.factor, self.scale)
            return True
        return False


def frozen_components(model_conf: dict) -> set[str]:
    """The components whose conf sets ``trainable: False``."""
    return {comp for comp, sub in model_conf.items()
            if isinstance(sub, dict) and sub.get("trainable") is False}


def flax_path(name: str) -> str:
    """The '/'-joined flax path of a parameter, as ``lr_scaling`` matches it
    (``params/matcher/transformers_0/self_attn/Wqkv/kernel``)."""
    return "/".join(_flax_path(flax_key(name)))


def lr_scales(names: list[str], lr_scaling) -> tuple[list[float], int]:
    """The update scale of each named parameter under ``lr_scaling`` (the
    product of the scales of the entries whose substrings its flax path
    holds), and the number of entries that match any of ``names``."""
    scales = [1.0] * len(names)
    used = 0
    for entry in list(lr_scaling or []):
        scale, patterns = float(entry[0]), [str(p) for p in entry[1]]
        hits = [i for i, n in enumerate(names) if any(p in flax_path(n) for p in patterns)]
        if hits:
            used += 1
            logger.info("LR scaling x%.3g for %d params matching %s", scale, len(hits), patterns)
        for i in hits:
            scales[i] *= scale
    return scales, used


def global_norm(tensors: list[torch.Tensor]) -> torch.Tensor:
    return torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(t.float())
                                                 for t in tensors]))


class Optimizer:
    """optax's ``chain(clip_by_global_norm(clip_grad), adam(schedule),
    [masked(scale(s)) for each lr_scaling entry], inject_hyperparams(scale)
    (lr_scale))`` (or adamw), wrapped in ``multi_transform`` when some
    parameters are frozen, over the trainable ``named_params`` of a model
    whose parameters are ``all_names``, stepped from their ``.grad``.
    ``flat_state``/``load_flat_state`` read and write its state under the
    keys that the JAX package's ``state_to_flat_dict`` gives that optax
    state; ``num_heads`` (utils/weights) orders the moments of Wqkv."""

    def __init__(self, named_params: list[tuple[str, torch.nn.Parameter]], conf: dict,
                 all_names: list[str], num_heads: dict[str, int]):
        self.names = [n for n, _ in named_params]
        self.params = [p for _, p in named_params]
        self.num_heads = num_heads
        self.schedule = make_lr_schedule(conf)
        self.clip = float(conf["clip_grad"] or 0.0)
        self.multi = len(all_names) > len(self.names)  # optax's multi_transform
        # lr_scaling masks the whole tree in JAX: an entry counts (it adds a
        # state to the chain) if it matches any parameter, frozen ones included
        scales, self.n_scaling = lr_scales(all_names, conf.get("lr_scaling"))
        scales = dict(zip(all_names, scales))
        self.lr_scale = 1.0  # the plateau controller's
        options = dict(conf["optimizer_options"])
        kwargs = {"betas": (float(options.pop("b1", 0.9)), float(options.pop("b2", 0.999))),
                  "eps": float(options.pop("eps", 1e-8))}
        self.kind = conf["optimizer"]
        if self.kind == "adamw":
            kwargs["weight_decay"] = float(options.pop("weight_decay", 1e-4))  # optax's
            cls = torch.optim.AdamW
        elif self.kind == "adam":
            cls = torch.optim.Adam
        else:
            raise NotImplementedError(f"optimizer {conf['optimizer']!r} is not ported")
        if options:
            raise ValueError(f"unknown optimizer options {sorted(options)}")
        groups = defaultdict(list)
        for name, p in zip(self.names, self.params):
            groups[scales[name]].append(p)
        self.inner = cls([{"params": ps, "scale": s} for s, ps in groups.items()],
                         lr=self.schedule(0), **kwargs)
        self.count = 0  # updates applied, as optax counts them

    def step(self) -> None:
        for p in self.params:
            if p.grad is None:  # not reached by the loss: a zero gradient
                p.grad = torch.zeros_like(p)
        if self.clip:
            grads = [p.grad for p in self.params]
            norm = global_norm(grads)
            keep = norm < self.clip
            for g in grads:
                g.copy_(torch.where(keep, g, g / norm * self.clip))
        for group in self.inner.param_groups:
            group["lr"] = self.schedule(self.count) * group["scale"] * self.lr_scale
        self.inner.step()
        self.count += 1

    # --- optax's state layout ----------------------------------------------

    def _keys(self) -> dict:
        """The flat keys of optax's state for this conf: the prefix of Adam's
        state, and the keys of the schedule's and the injected scale's."""
        outer = ".inner_states['train'].inner_state" if self.multi else ""
        adam = 1 if self.clip else 0  # clip_by_global_norm's state has no leaves
        sched = 2 if self.kind == "adamw" else 1  # adamw: add_decayed_weights between
        inject = adam + 1 + self.n_scaling
        return {"adam": f"{outer}[{adam}][0]", "schedule": f"{outer}[{adam}][{sched}].count",
                "inject": f"{outer}[{inject}]"}

    def flat_state(self) -> dict:
        keys = self._keys()
        count = np.asarray(self.count, np.int32)
        moments = {"mu": {}, "nu": {}}
        for name, p in zip(self.names, self.params):
            state = self.inner.state.get(p, {})
            moments["mu"][name] = state.get("exp_avg", torch.zeros_like(p))
            moments["nu"][name] = state.get("exp_avg_sq", torch.zeros_like(p))
        flat = {f"{keys['adam']}.count": count, keys["schedule"]: count,
                f"{keys['inject']}.count": count,
                f"{keys['inject']}.hyperparams['lr_scale']": np.asarray(self.lr_scale,
                                                                         np.float32)}
        for which, state in moments.items():
            for key, value in flat_from_params(state, self.num_heads).items():
                flat[f"{keys['adam']}.{which}{key}"] = value
        return flat

    def load_flat_state(self, flat: dict) -> None:
        keys = self._keys()
        expected = set(self.flat_state())
        missing = sorted(expected - set(flat))
        if missing:
            raise KeyError(f"optimizer state missing {missing[:4]} ({len(missing)} keys)")
        self.count = int(flat[f"{keys['adam']}.count"])
        self.lr_scale = float(flat[f"{keys['inject']}.hyperparams['lr_scale']"])
        moments = {}
        for which in ("mu", "nu"):
            prefix = f"{keys['adam']}.{which}"
            moments[which] = params_from_flat(
                {k[len(prefix):]: v for k, v in flat.items() if k.startswith(prefix)},
                self.num_heads)
        for name, p in zip(self.names, self.params):
            self.inner.state[p] = {
                "step": torch.tensor(float(self.count), dtype=torch.float32),
                "exp_avg": moments["mu"][name].to(p.device, p.dtype),
                "exp_avg_sq": moments["nu"][name].to(p.device, p.dtype)}


def make_optimizer(conf: dict, model: torch.nn.Module, model_conf: dict) -> Optimizer:
    """The optimizer over every parameter outside the frozen components."""
    frozen = frozen_components(model_conf)
    named = list(model.named_parameters())
    trainable = [(n, p) for n, p in named if n.split(".")[0] not in frozen]
    return Optimizer(trainable, conf, [n for n, _ in named], head_counts(model))


def train_step(model: torch.nn.Module, optimizer: Optimizer, data: dict) -> dict:
    """One step: forward, loss, backward, and the update unless the loss or
    the gradient norm is not finite. Returns the step's scalars as floats:
    ``loss/*``, ``metric/*`` (batch means), ``grad_norm``,
    ``grad_norm/<component>`` and ``skipped``."""
    model.zero_grad(set_to_none=True)
    pred = model(data)
    losses, metrics = model.loss(pred, data)
    loss = losses["total"].mean()
    loss.backward()
    scalars = {f"loss/{k}": v.detach().mean() for k, v in losses.items()}
    scalars.update({f"metric/{k}": v.detach().float().mean() for k, v in metrics.items()})
    by_component = {}
    for comp, module in model.named_children():
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in module.parameters()]
        if grads:
            by_component[comp] = global_norm(grads)
            scalars[f"grad_norm/{comp}"] = by_component[comp]
    scalars["grad_norm"] = global_norm(list(by_component.values()))
    values = dict(zip(scalars, torch.stack(list(scalars.values())).tolist()))
    finite = math.isfinite(values["loss/total"]) and math.isfinite(values["grad_norm"])
    if finite:
        optimizer.step()
    values["skipped"] = 0.0 if finite else 1.0
    return values


# --- validation ---------------------------------------------------------------

PR_BINS = 32


def _pr_counts(pred: dict, data: dict) -> dict | None:
    """Matcher confidence histogrammed by correctness, for PR curves:
    {correct, incorrect: (PR_BINS,), num_pos: ()} or None."""
    scores = pred.get("matching_scores0")
    m0 = pred.get("matches0")
    gt = pred.get("gt_matches0", data.get("gt_matches0"))
    if scores is None or m0 is None or gt is None:
        return None
    matched = m0 >= 0
    correct = matched & (m0 == gt)
    incorrect = matched & ~correct & (gt > -2)
    edges = torch.linspace(0.0, 1.0, PR_BINS + 1, device=scores.device)
    sc = scores.clamp(0.0, 1.0).reshape(-1)
    # numpy's bins: [e_i, e_i+1), the last one closed
    index = torch.searchsorted(edges, sc, right=True)
    index = torch.where(sc == edges[-1], PR_BINS, index) - 1

    def hist(mask):
        w = mask.reshape(-1).float()
        return torch.zeros(PR_BINS, device=sc.device).index_add_(0, index, w)

    return {"correct": hist(correct), "incorrect": hist(incorrect),
            "num_pos": (gt >= 0).sum()}


def to_device(batch, device: torch.device):
    """A host batch on ``device``: numpy arrays as tensors (from pinned memory,
    without blocking, onto a card), nested dicts alike; strings and other
    values dropped."""
    if isinstance(batch, dict):
        out = {k: to_device(v, device) for k, v in batch.items()}
        return {k: v for k, v in out.items() if v is not None}
    if isinstance(batch, (np.ndarray, np.generic)) and batch.dtype.kind in "biuf":
        tensor = torch.from_numpy(np.ascontiguousarray(batch))
        if device.type == "cuda":
            return tensor.pin_memory().to(device, non_blocking=True)
        return tensor.to(device)
    return None


def make_eval_forward(model: torch.nn.Module, batch_of: Callable) -> Callable:
    """The validation forward of one loader item: (pool, item) -> (losses,
    metrics, PR counts); ``batch_of(pool, item)`` makes the batch."""

    def forward(pool: dict, item):
        data = batch_of(pool, item)
        pred = model(data)
        losses, metrics = model.loss(pred, data)
        return losses, metrics, _pr_counts(pred, data)

    return forward


def do_evaluation(model: torch.nn.Module, loader, eval_forward: Callable, pool: dict,
                  writer=None, step: int = 0) -> dict:
    """Mean losses and metrics over the val loader's items (seeds of the
    engine's ``pool``, or host batches; no gradients, the model in eval
    mode), and ``match_AP``, the average precision of the matches over
    confidence thresholds from the binned counts."""
    results: dict[str, AverageMetric] = defaultdict(AverageMetric)
    pr = None
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            for seed in loader:
                losses, metrics, pr_i = eval_forward(pool, seed)
                for k, v in losses.items():
                    results[f"loss/{k}"].update(v.float().cpu().numpy())
                for k, v in metrics.items():
                    results[f"metric/{k}"].update(v.float().cpu().numpy())
                if pr_i is not None:
                    pr_i = {k: v.cpu().numpy() for k, v in pr_i.items()}
                    pr = pr_i if pr is None else {k: pr[k] + pr_i[k] for k in pr}
    finally:
        model.train(was_training)
    out = {k: m.compute() for k, m in results.items()}
    if pr is not None and pr["num_pos"] > 0:
        # precision and recall over descending confidence thresholds
        tp = np.cumsum(pr["correct"][::-1])[::-1]
        fp = np.cumsum(pr["incorrect"][::-1])[::-1]
        prec = tp / np.maximum(tp + fp, 1)
        rec = tp / max(float(pr["num_pos"]), 1.0)
        order = np.argsort(rec)  # AP: trapezoid over recall
        trapz = getattr(np, "trapezoid", None) or np.trapz
        out["match_AP"] = float(trapz(prec[order], rec[order]))
        if writer is not None and writer.tb is not None:
            writer.tb.add_pr_curve_raw(
                "val/matches", true_positive_counts=tp, false_positive_counts=fp,
                true_negative_counts=np.zeros_like(tp),
                false_negative_counts=np.maximum(float(pr["num_pos"]) - tp, 0),
                precision=prec, recall=np.clip(rec, 0, 1), global_step=step,
                num_thresholds=len(tp))
    return out


class JSONLWriter:
    """Scalars to ``metrics.jsonl`` (one JSON object a write), and to
    TensorBoard where ``torch.utils.tensorboard`` imports."""

    def __init__(self, log_dir: Path):
        log_dir.mkdir(parents=True, exist_ok=True)
        self.f = open(log_dir / "metrics.jsonl", "a")
        self.tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter

            self.tb = SummaryWriter(str(log_dir))
        except ImportError:
            pass

    def write(self, tag_values: dict, step: int) -> None:
        rec = {"step": step, **{k: float(v) for k, v in tag_values.items()}}
        self.f.write(json.dumps(rec) + "\n")
        self.f.flush()
        if self.tb is not None:
            for k, v in tag_values.items():
                self.tb.add_scalar(k, float(v), step)

    def close(self) -> None:
        self.f.close()
        if self.tb is not None:
            self.tb.close()


# --- the trainer and the loop ---------------------------------------------------

def bench_overlay(model: torch.nn.Module, model_conf: dict, name: str, overlay: dict | None,
                  device: torch.device) -> torch.nn.Module:
    """The model of ``model_conf`` with a benchmark's ``overlay`` merged in,
    in inference mode, holding ``model``'s parameters themselves (no copy),
    so that it runs the live weights whenever it runs. An overlay that
    changes a parameter's shape is refused."""
    if not overlay:
        return model
    conf = merge(model_conf, overlay)
    bmodel = build_model(conf["name"], conf, device=device)
    live = dict(model.named_parameters())
    for pname, param in list(bmodel.named_parameters()):
        held = live.get(pname)
        if held is None or tuple(held.shape) != tuple(param.shape):
            raise ValueError(
                f"run_benchmarks[{name}].model overlay changes the param tree at "
                f"{flax_key(pname)}: live {None if held is None else tuple(held.shape)} vs "
                f"overlay {tuple(param.shape)}. Overlays must keep params compatible "
                "(kp counts, thresholds, gt off — not layer shapes).")
        owner, _, leaf = pname.rpartition(".")
        setattr(bmodel.get_submodule(owner), leaf, held)
    return bmodel


class Trainer:
    """A model, its optimizer, the data (the on-device engine's pool, or the
    host dataset) and the benchmark overlays, built from a training conf
    (``data``, ``model``, ``train``), on ``device`` (CUDA unless asked).
    ``weights`` is a committed blob loaded strictly into the model in place
    of ``train.load_experiment``; ``pool`` an uploaded pool to share (else
    the engine's is built on ``device``)."""

    def __init__(self, conf: dict, device: str | torch.device = "cuda", weights=None,
                 pool: dict | None = None):
        self.device = resolve_device(device)
        self.conf = merge(default_conf, conf)
        tconf = self.conf["train"]
        self.benchmarks = list(tconf["run_benchmarks"])
        for bench in self.benchmarks:
            get_benchmark(bench["name"])  # refuses what is not ported, before any step
        self.dataset = get_dataset(self.conf["data"]["name"])(self.conf["data"])
        self.engine = self.dataset.device_engine
        self.pool = None
        if self.engine:
            self.pool = pool if pool is not None else upload_pool(
                self.dataset.build_pool("train", self.device), self.device)
        with torch.random.fork_rng(devices=[]):  # initialisation leaves no trace
            torch.manual_seed(int(tconf["seed"]))
            self.model = build_model(self.conf["model"]["name"], self.conf["model"],
                                     device=self.device, train=True)
        if weights is not None:
            load_weights(self.model, weights)
        elif tconf["load_experiment"]:
            restore_components(self.model, tconf["load_experiment"])
            logger.info("Loaded params from experiment %s", tconf["load_experiment"])
        self.optimizer = make_optimizer(tconf, self.model, self.conf["model"])
        # built once, before any step: an overlay that does not fit fails here
        self.bench_models = {b["name"]: bench_overlay(self.model, self.conf["model"], b["name"],
                                                      b.get("model"), self.device)
                             for b in self.benchmarks}

    def batch(self, pool: dict | None, item, split: str = "train") -> dict:
        """The device batch of a loader item: the engine's batch of seed
        ``item`` from ``pool``, or the host batch ``item`` on the device."""
        if self.engine:
            return self.dataset.make_batch(pool, item, split)
        return to_device(item, self.device)

    def loader(self, split: str):
        """The loader of ``split``: the overfit loader with ``train.overfit``."""
        if self.conf["train"]["overfit"]:
            return self.dataset.get_overfit_loader(split)
        return self.dataset.get_data_loader(split)

    def step(self, item) -> dict:
        """One training step on the batch of loader item ``item``."""
        return train_step(self.model, self.optimizer, self.batch(self.pool, item))

    def state(self) -> dict:
        return {"params": self.model, "opt_state": self.optimizer}


def training(conf: dict, output_dir: str | Path, args=None, *, steps: int | None = None,
             device: str | torch.device = "cuda", weights=None, pool: dict | None = None,
             log: Callable[[dict], None] | None = None):
    """Train for ``train.epochs`` epochs of the loader's items into
    ``output_dir`` (``args.restore``: resume from its last checkpoint), or
    stop after ``steps`` steps. ``weights`` and ``pool`` go to ``Trainer``;
    ``log`` receives each step's scalars. Returns (trainer, the scalars of
    every step, with its host ``ms``, and on a host dataset the ``data_ms``
    that the step waited for its batch)."""
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    trainer = Trainer(conf, device, weights, pool)
    conf, tconf = trainer.conf, trainer.conf["train"]
    save_conf(output_dir, conf)
    dataset, model, optimizer = trainer.dataset, trainer.model, trainer.optimizer

    epoch0, iteration = 0, 0
    best_eval = None
    if args is not None and getattr(args, "restore", False):
        blob, _ = load_experiment(str(output_dir.resolve()), best=False)
        restore_from_flat_dict(model, blob["state"]["params"])
        restore_from_flat_dict(optimizer, blob["state"]["opt_state"])
        epoch0, iteration = int(blob["epoch"]) + 1, int(blob["iteration"])
        logger.info("Restored at epoch %d iter %d", epoch0, iteration)

    plateau = PlateauController(tconf["lr_schedule"])
    if tconf["lr_schedule"].get("type") == "plateau" and str(tconf["best_key"]).startswith(
            "bench/"):
        logger.warning("lr_schedule.type=plateau with a bench best_key (%s): the plateau "
                       "controller watches the per-iteration val metrics and will be a no-op "
                       "for bench/* keys; use a factor/exp schedule instead.",
                       tconf["best_key"])
    train_loader = trainer.loader("train")
    val_loader = dataset.get_data_loader("val")
    eval_forward = make_eval_forward(model, lambda pool, item: trainer.batch(pool, item, "val"))
    val_pool = {}  # the engine's, uploaded at the first evaluation
    writer = JSONLWriter(output_dir)

    def evaluate() -> dict:
        if trainer.engine and not val_pool:
            val_pool.update(upload_pool(dataset.build_pool("val", trainer.device),
                                        trainer.device))
        return do_evaluation(model, val_loader, eval_forward, val_pool, writer, iteration)

    stop = {"flag": False}

    def sigint_handler(signum, frame):
        if stop["flag"]:
            raise KeyboardInterrupt
        logger.info("SIGINT: will stop after this iteration (^C again to kill).")
        stop["flag"] = True

    old_handler = signal.signal(signal.SIGINT, sigint_handler)
    running: dict[str, AverageMetric] = defaultdict(AverageMetric)
    history = []
    t_last = time.perf_counter()
    samples_since = 0
    try:
        for epoch in range(epoch0, int(tconf["epochs"])):
            train_loader.set_epoch(epoch)
            steps_in_epoch = 0
            items = iter(train_loader)
            while True:
                if steps is not None and len(history) >= steps:
                    return trainer, history
                t = time.perf_counter()
                item = next(items, None)
                if item is None:
                    break
                data_ms = (time.perf_counter() - t) * 1e3
                t = time.perf_counter()
                scalars = trainer.step(item)
                history.append({**scalars, "ms": (time.perf_counter() - t) * 1e3,
                                **({} if trainer.engine else {"data_ms": data_ms})})
                iteration += 1
                samples_since += dataset.batch_size("train")
                if log is not None:
                    log({"step": iteration, **scalars})
                for k, v in scalars.items():
                    running[k].update(v)
                if iteration % int(tconf["log_every_iter"]) == 0:
                    vals = {k: m.compute() for k, m in running.items()}
                    vals["lr"] = optimizer.schedule(iteration)
                    vals["samples_per_sec"] = samples_since / max(time.perf_counter() - t_last,
                                                                  1e-6)
                    writer.write(vals, iteration)
                    logger.info("[E %d | it %d] loss %.4f | %.1f samples/s", epoch, iteration,
                                vals.get("loss/total", float("nan")), vals["samples_per_sec"])
                    running.clear()
                    t_last = time.perf_counter()
                    samples_since = 0
                if iteration % int(tconf["eval_every_iter"]) == 0 or stop["flag"]:
                    eval_results = evaluate()
                    if plateau.update(float(eval_results.get(tconf["best_key"], np.nan))):
                        optimizer.lr_scale = plateau.scale
                    writer.write({f"val/{k}": v for k, v in eval_results.items()}, iteration)
                    logger.info("[Validation] %s",
                                {k: round(float(v), 4) for k, v in eval_results.items()})
                    best_eval = save_experiment(
                        output_dir, trainer.state(), conf, epoch, iteration,
                        eval_results=eval_results, best_eval=best_eval,
                        cp_name=f"checkpoint_{epoch}_{iteration}"
                        + ("_interrupted" if stop["flag"] else "") + ".ckpt",
                        keep_last=int(tconf["keep_last_checkpoints"]))
                if stop["flag"]:
                    logger.info("Stopped by SIGINT at iter %d", iteration)
                    return trainer, history
                steps_in_epoch += 1
                cap = tconf["num_steps_per_epoch"]
                if cap is not None and steps_in_epoch >= int(cap):
                    break
            # the epoch-end benchmarks, on the live parameters through their
            # overlays; their summaries can pick checkpoint_best
            bench_results = {}
            bench_due = (epoch + 1) % max(int(tconf["benchmark_every_epoch"]), 1) == 0
            for bench in trainer.benchmarks if bench_due else []:
                name = bench["name"]
                t = time.perf_counter()
                try:
                    summaries, _ = run_benchmark(
                        name, bench.get("conf", {}), output_dir / "benchmarks" / name /
                        f"e{epoch}", model=trainer.bench_models[name], device=trainer.device)
                except FileNotFoundError as e:  # benchmark data absent
                    logger.warning("benchmark %s skipped (no data): %s", name, e)
                    continue
                bench_results.update({f"bench/{name}/{k}": v for k, v in summaries.items()
                                      if isinstance(v, (int, float))})
                writer.write(bench_results, iteration)
                writer.write({f"bench/{name}/seconds": time.perf_counter() - t}, iteration)
            eval_results = evaluate()
            eval_results.update(bench_results)
            best_eval = save_experiment(
                output_dir, trainer.state(), conf, epoch, iteration,
                eval_results=eval_results, best_eval=best_eval,
                keep_last=int(tconf["keep_last_checkpoints"]))
    finally:
        signal.signal(signal.SIGINT, old_handler)
        writer.close()
    logger.info("Finished training at epoch %d iter %d", int(tconf["epochs"]), iteration)
    return trainer, history


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("experiment", help="the run's folder under outputs/training")
    parser.add_argument("--conf", default=None, help="a training conf (data, model, train): "
                        ".json, or .yaml where yaml is installed")
    parser.add_argument("--restore", action="store_true", help="resume the run's last checkpoint")
    parser.add_argument("--steps", type=int, default=None)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--weights", default=None, help="a weights/*.msgpack blob to start from")
    parser.add_argument("dotlist", nargs="*", help="dot.key=value")
    args = parser.parse_args(argv)
    conf = load_conf(args.conf) if args.conf else {}
    conf = merge(conf, dotlist_to_dict(args.dotlist))
    logging.basicConfig(level=logging.INFO, format="[%(asctime)s %(name)s %(levelname)s] "
                        "%(message)s")
    t0 = time.perf_counter()

    def log(scalars):
        print(json.dumps({"seconds": round(time.perf_counter() - t0, 3), **scalars}),
              flush=True)

    training(conf, TRAINING_PATH / args.experiment, args, steps=args.steps, device=args.device,
             weights=args.weights, log=log)


if __name__ == "__main__":
    main()
