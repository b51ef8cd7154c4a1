"""Training (gluefactory_tpu/train.py) on one GPU with the on-device data
engine: each step makes its batch on the card from one seed, runs the
pipeline and its loss, backpropagates and updates the trainable parameters.

As in the JAX trainer:
  - gradients are computed for every parameter, frozen ones included
    (``trainable: False`` components keep ``requires_grad``), so the logged
    ``grad_norm`` and the skip test cover them; the optimizer holds only the
    trainable parameters, and the gradient clip sees only those;
  - the clip is optax's ``clip_by_global_norm``: g * max / norm when
    norm >= max, else g unchanged;
  - a step whose loss or gradient norm is not finite changes nothing, not
    even the optimizer's step count, which the learning-rate schedule reads
    (0 for the first update).

Not ported yet: the plateau controller, ``lr_scaling``, evaluation,
checkpoints, several GPUs, datasets other than the on-device engine. So the
cadence keys of a recipe (``eval_every_iter``, ``save_every_iter``,
``log_every_iter``, ``keep_last_checkpoints``) and the checkpoint choice
(``best_key``, ``best_mode``) are ignored until evaluation and checkpoints
land; every step logs. ``run_benchmarks``, which would change what a run
selects, raises unless empty.

CLI: ``python -m gluefactory_torch.train --conf path.yaml [--steps N]
[--device cuda] [--weights blob] [dot.key=value ...]``
"""

from __future__ import annotations

import argparse
import json
import math
import time
from collections.abc import Callable

import torch

from .core.config import merge
from .datasets import get_dataset
from .datasets.homographies_ondevice import upload_pool
from .flagship import load_weights
from .models import build_model
from .utils.device import resolve_device

default_train_conf = {
    "seed": 0,  # of the model's initialisation
    "epochs": 1,
    "optimizer": "adam",  # adam | adamw
    "optimizer_options": {},  # optax names: b1, b2, eps (, weight_decay for adamw)
    "lr": 1e-4,
    "lr_schedule": {"type": None, "start": 0, "exp_div_10": 0, "factor": 1.0},
    "lr_scaling": [],  # not ported: must stay empty
    "load_experiment": None,  # not ported: pass a weight blob to Trainer
    "clip_grad": 1.0,
    "run_benchmarks": [],  # not ported: must stay empty
}

default_conf = {"data": {"name": None}, "model": {"name": None}, "train": default_train_conf}


def make_lr_schedule(conf: dict) -> Callable[[int], float]:
    """The learning rate of update ``step`` (0-based): constant, or from
    ``start`` on divided by 10 every ``exp_div_10`` steps ('exp'), or times
    ``factor`` ('factor')."""
    base_lr = float(conf["lr"])
    sched = conf["lr_schedule"]
    kind = sched.get("type")
    if kind not in (None, "exp", "factor"):
        raise NotImplementedError(f"lr schedule {kind!r} is not ported")

    def schedule(step: int) -> float:
        start = float(sched.get("start", 0))
        if kind is None or step < start:
            return base_lr
        if kind == "exp":
            return base_lr * 10 ** (-(step - start) / max(float(sched.get("exp_div_10", 1e9)),
                                                          1.0))
        return base_lr * float(sched.get("factor", 1.0))

    return schedule


def frozen_components(model_conf: dict) -> set[str]:
    """The components whose conf sets ``trainable: False``."""
    return {comp for comp, sub in model_conf.items()
            if isinstance(sub, dict) and sub.get("trainable") is False}


def global_norm(tensors: list[torch.Tensor]) -> torch.Tensor:
    return torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(t.float())
                                                 for t in tensors]))


class Optimizer:
    """optax's ``chain(clip_by_global_norm(clip_grad), adam(schedule))``
    (or adamw) over ``params``, stepped from their ``.grad``."""

    def __init__(self, params: list[torch.nn.Parameter], conf: dict):
        self.params = list(params)
        self.schedule = make_lr_schedule(conf)
        self.clip = float(conf["clip_grad"] or 0.0)
        options = dict(conf["optimizer_options"])
        kwargs = {"betas": (float(options.pop("b1", 0.9)), float(options.pop("b2", 0.999))),
                  "eps": float(options.pop("eps", 1e-8))}
        if conf["optimizer"] == "adamw":
            kwargs["weight_decay"] = float(options.pop("weight_decay", 1e-4))  # optax's
            cls = torch.optim.AdamW
        elif conf["optimizer"] == "adam":
            cls = torch.optim.Adam
        else:
            raise NotImplementedError(f"optimizer {conf['optimizer']!r} is not ported")
        if options:
            raise ValueError(f"unknown optimizer options {sorted(options)}")
        self.inner = cls(self.params, lr=self.schedule(0), **kwargs)
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
            group["lr"] = self.schedule(self.count)
        self.inner.step()
        self.count += 1


def make_optimizer(conf: dict, model: torch.nn.Module, model_conf: dict) -> Optimizer:
    """The optimizer over every parameter outside the frozen components."""
    if conf.get("lr_scaling"):
        raise NotImplementedError("lr_scaling is not ported")
    frozen = frozen_components(model_conf)
    params = [p for name, p in model.named_parameters() if name.split(".")[0] not in frozen]
    return Optimizer(params, conf)


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


class Trainer:
    """A model, its optimizer and the on-device engine's pool, built from a
    training conf (``data``, ``model``, ``train``), on ``device`` (CUDA unless
    asked). ``weights`` is a committed blob loaded strictly into the model;
    ``pool`` an uploaded pool to share (else the engine's is built)."""

    def __init__(self, conf: dict, device: str | torch.device = "cuda", weights=None,
                 pool: dict | None = None):
        self.device = resolve_device(device)
        self.conf = merge(default_conf, conf)
        tconf = self.conf["train"]
        if tconf["run_benchmarks"]:
            raise NotImplementedError(
                f"run_benchmarks {tconf['run_benchmarks']!r} is not ported: the benchmarks "
                "after each epoch and the checkpoint they select need evaluation")
        self.dataset = get_dataset(self.conf["data"]["name"])(self.conf["data"])
        self.pool = pool if pool is not None else upload_pool(
            self.dataset.build_pool("train"), self.device)
        with torch.random.fork_rng(devices=[]):  # initialisation leaves no trace
            torch.manual_seed(int(tconf["seed"]))
            self.model = build_model(self.conf["model"]["name"], self.conf["model"],
                                     device=self.device, train=True)
        if weights is not None:
            load_weights(self.model, weights)
        elif tconf["load_experiment"]:
            raise NotImplementedError(
                f"experiment checkpoints ({tconf['load_experiment']!r}) are not ported: "
                "pass a committed weight blob")
        self.optimizer = make_optimizer(tconf, self.model, self.conf["model"])

    def step(self, seed: int) -> dict:
        """One training step on the batch of ``seed``."""
        return train_step(self.model, self.optimizer, self.dataset.make_batch(self.pool, seed))


def training(conf: dict, steps: int | None = None, device: str | torch.device = "cuda",
             weights=None, log: Callable[[dict], None] | None = None):
    """Train for ``train.epochs`` epochs of the engine's seeds, or ``steps``
    steps if fewer. Returns (trainer, the scalars of every step)."""
    trainer = Trainer(conf, device, weights)
    loader = trainer.dataset.get_data_loader("train")
    history = []
    for epoch in range(int(trainer.conf["train"]["epochs"])):
        loader.set_epoch(epoch)
        for seed in loader:
            if steps is not None and len(history) >= steps:
                return trainer, history
            scalars = trainer.step(seed)
            history.append(scalars)
            if log is not None:
                log({"step": len(history) - 1, **scalars})
    return trainer, history


def main(argv: list[str] | None = None) -> None:
    import yaml

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--conf", required=True, help="a training YAML (data, model, train)")
    parser.add_argument("--steps", type=int, default=None)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--weights", default=None, help="a weights/*.msgpack blob to start from")
    parser.add_argument("overrides", nargs="*", help="dot.key=value")
    args = parser.parse_args(argv)
    with open(args.conf) as f:
        conf = yaml.safe_load(f)
    for dotted in args.overrides:
        key, _, value = dotted.partition("=")
        *parents, leaf = key.split(".")
        node = conf
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = yaml.safe_load(value)
    t0 = time.perf_counter()

    def log(scalars):
        print(json.dumps({"seconds": round(time.perf_counter() - t0, 3), **scalars}),
              flush=True)

    training(conf, args.steps, args.device, args.weights, log)


if __name__ == "__main__":
    main()
