"""Pair throughput and latency of a pipeline conf
(gluefactory_tpu/eval/timing_measurement.py), on synthetic pairs of random
images at a batch and a square size, on the device.

The inputs of every timed call are made on the device before the clock
starts; ``warmup`` calls (3, as in JAX's harness) first build the kernels
and fill the caches and are not timed; the ``iters`` timed calls run back
to back and end in a device synchronise. The CLI prints one JSON line with
the device's name and power limit beside the numbers.

    python -m gluefactory_torch.eval.timing_measurement --conf C [--batch 8]
        [--size 512] [--iters 10] [--checkpoint K]
        [--device cuda|cpu] [model.key=value ...]

``--conf`` is a recipe of ``gluefactory_torch.recipes`` (e.g.
``eth3d_flagship_conf``), a config name under ``gluefactory_tpu/configs``
or a YAML/JSON file; the model is its ``model`` section, restored from
``--checkpoint`` (else the conf's) when one is given."""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .. import recipes
from ..core.config import dotlist_to_dict, load_conf, merge
from ..utils.device import describe_device, resolve_device
from .eval_pipeline import synchronize
from .io import load_model, parse_config_path

SUMMED = ("matching_scores0", "keypoints0", "keypoint_scores0", "heatmap")


def synthetic_pair(batch: int, size: int, seed: int, device) -> dict:
    """A batch of pairs of uniform random (size, size) RGB images."""
    g = np.random.default_rng(seed)

    def view():
        image = g.uniform(0, 1, (batch, size, size, 3)).astype(np.float32)
        return {"image": torch.from_numpy(image).to(device),
                "image_size": torch.full((batch, 2), float(size), device=device)}

    return {"view0": view(), "view1": view()}


def measure_pipeline(model: torch.nn.Module, batch: int, size: int, iters: int = 10,
                     warmup: int = 3, device="cuda") -> dict:
    """``pairs_per_s`` and ``ms_per_pair`` of ``model`` over ``iters`` calls on
    batches of ``batch`` synthetic pairs at ``size``, after ``warmup`` calls;
    a checksum of the outputs keeps every call's work."""
    device = resolve_device(device)
    model = model.to(device).eval()
    datas = [synthetic_pair(batch, size, i + 1, device) for i in range(warmup + iters)]

    def forward(data):
        pred = model(data)
        return sum(pred[k].float().sum() for k in SUMMED if k in pred)

    with torch.inference_mode():
        for data in datas[:warmup]:
            float(forward(data))
        synchronize(device)
        t0 = time.perf_counter()
        sums = [forward(data) for data in datas[warmup:]]
        synchronize(device)
        dt = time.perf_counter() - t0
    if not all(torch.isfinite(torch.stack(sums)).tolist()):
        raise RuntimeError("a timed call's outputs are not finite")
    return {"pairs_per_s": batch * iters / dt, "ms_per_pair": dt / (batch * iters) * 1e3,
            "batch": batch, "size": size, "iters": iters, "device": device.type}


def named_conf(name: str) -> dict:
    """A recipe of ``gluefactory_torch.recipes`` by function name, else a conf
    file (``eval.io.parse_config_path``)."""
    recipe = getattr(recipes, name, None)
    if callable(recipe):
        return recipe()
    return load_conf(parse_config_path(name))


def main(argv: list[str] | None = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--conf", type=str, required=True)
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--size", type=int, default=512)
    parser.add_argument("--iters", type=int, default=10)
    parser.add_argument("--checkpoint", type=str, default=None)
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("dotlist", nargs="*")
    args = parser.parse_intermixed_args(argv)
    device = resolve_device(args.device)
    conf = merge(named_conf(args.conf), dotlist_to_dict(args.dotlist))
    model = load_model(conf["model"], args.checkpoint or conf.get("checkpoint"), device)
    out = measure_pipeline(model, args.batch, args.size, args.iters, device=device)
    out.update(conf=args.conf, **describe_device(device))
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
