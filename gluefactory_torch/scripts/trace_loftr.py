"""Where the device time of a LoFTR pair goes: LoFTR from the committed
``loftr_tpu_stage0b`` blob at full width (1024 slots) on a pair of square
views (a structured scene and its shifted crop), float32 without TF32. Prints
the ms of the backbone on both views, and of its forward and backward on a
training step's 16 views, under each setting of cuDNN's deterministic and
benchmark flags, each in a process of its own (cuDNN keeps the first plan it
finds for a shape, under either flag, for the rest of the process); the ms of
each stage of the model's forward under ``chip_smoke.py``'s settings
(deterministic; CUDA events around each, after warm-up), and the kernels that took
the most device time in ``torch.profiler`` over a few forwards. One JSON line
at the end, with the card's name and power limit. Needs a CUDA device.

    python -m gluefactory_torch.scripts.trace_loftr [--size 480] [--iters 10]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from ..datasets.homographies_ondevice import generate_structured_scene
from ..eval.io import load_model
from ..recipes import hpatches_loftr_conf
from ..settings import ROOT_PATH
from ..utils.device import resolve_device

STAGES = ("_backbone", "_coarse_transformer", "_confidence", "_select", "_fine_refine")


def pair(size: int, device) -> dict:
    scene = generate_structured_scene(np.random.default_rng(0), (size + 16, size + 16),
                                      max_points=4)[0].astype(np.float32)
    views = [scene[None, :size, :size], scene[None, 9:9 + size, 5:5 + size]]
    return {f"view{i}": {"image": torch.from_numpy(np.repeat(v, 3, -1)).to(device)}
            for i, v in enumerate(views)}


def event_ms(fn, iters: int) -> float:
    """Mean ms of ``fn()`` over ``iters`` runs after two warm-up runs."""
    for _ in range(2):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def backbone_ms(model, size: int, train_size: int, iters: int, device) -> dict:
    """The backbone's ms on a pair of ``size`` views (inference) and forward
    and backward on 16 views of ``train_size``, under the current flags."""
    x = torch.rand(2, 1, size, size, device=device)
    train_x = torch.rand(16, 1, train_size, train_size, device=device)

    def train_backbone():
        coarse, fine = model.backbone(train_x)
        (coarse.square().mean() + fine.square().mean()).backward()

    with torch.inference_mode():
        inference = event_ms(lambda: model.backbone(x), iters)
    return {"inference_ms": inference, "train_ms": event_ms(train_backbone, iters)}


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--size", type=int, default=480)
    parser.add_argument("--train_size", type=int, default=320)
    parser.add_argument("--iters", type=int, default=10)
    parser.add_argument("--rows", type=int, default=15)
    parser.add_argument("--flags", default=None,
                        help="'deterministic,benchmark' as 0/1: the backbone alone, one JSON line")
    args = parser.parse_args(argv)
    device = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    conf = hpatches_loftr_conf("loftr_stage0b")
    model = load_model(conf["model"], str(ROOT_PATH / conf["checkpoint"]), device)
    if args.flags is not None:
        deterministic, benchmark = (bool(int(f)) for f in args.flags.split(","))
        torch.backends.cudnn.deterministic = deterministic
        torch.backends.cudnn.benchmark = benchmark
        print(json.dumps(backbone_ms(model, args.size, args.train_size, args.iters, device)))
        return
    report = {"size": args.size, "backbone": {}}
    for flags in ("1,0", "1,1", "0,0", "0,1"):
        out = subprocess.run([sys.executable, "-m", "gluefactory_torch.scripts.trace_loftr",
                              "--flags", flags, "--size", str(args.size), "--train_size",
                              str(args.train_size), "--iters", str(args.iters)],
                             capture_output=True, text=True, timeout=600, check=True)
        ms = json.loads(out.stdout.strip().splitlines()[-1])
        mode = "deterministic={}, benchmark={}".format(*(f == "1" for f in flags.split(",")))
        report["backbone"][mode] = ms
        print(f"cuDNN {mode}: the backbone on a pair of {args.size}-pixel views "
              f"{ms['inference_ms']:.2f} ms, forward and backward on 16 views of "
              f"{args.train_size} pixels {ms['train_ms']:.2f} ms", flush=True)
    # the model's own path under chip_smoke.py's settings
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    data = pair(args.size, device)
    totals = dict.fromkeys(STAGES, 0.0)
    originals = {name: getattr(model, name) for name in STAGES}

    def timed(name):
        def run(*a, **k):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = originals[name](*a, **k)
            end.record()
            torch.cuda.synchronize()
            totals[name] += start.elapsed_time(end)
            return out
        return run

    with torch.inference_mode():
        forward_ms = event_ms(lambda: model(data), args.iters)
        for name in STAGES:
            setattr(model, name, timed(name))
        for _ in range(args.iters):
            model(data)
        for name in STAGES:
            delattr(model, name)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                model(data)
            torch.cuda.synchronize()
    report["forward_ms"] = forward_ms
    report["stages_ms"] = {name.strip("_"): v / args.iters for name, v in totals.items()}
    print(f"forward {forward_ms:.2f} ms; by stage (events around each): "
          + ", ".join(f"{k} {v:.2f}" for k, v in report["stages_ms"].items()), flush=True)
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=args.rows), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=10).stdout.strip()
    report["device"] = smi
    print(json.dumps(report), flush=True)


if __name__ == "__main__":
    main()
