#!/usr/bin/env python3
"""Variants of the float32 attention kernels K1/K2
(gluefactory_torch/csrc/attention.cu) on one NVIDIA GPU, and how often each
trips the stage-2 training gate of chip_smoke.py (phase 7).

    python3 attention_variants.py [--seeds N] [--only NAME ...]

A variant is the shipped source with a few lines replaced (VARIANTS), compiled
by its own nvcc, all in parallel, under gluefactory_torch/_build/variants/.
For each it prints one JSON line with:
  - ptxas registers and spills of the f32 kernels;
  - the error of K1 and K2 at 32x4x512x64 against an exact float64 reference:
    max, rms, and the mean of err * sign(ref) (negative: a bias toward 0);
  - their times at 1x4x512, 32x4x512 and 8x4x1024 (CUDA graphs);
  - phase 7's step-0 comparison over the first N batches of the stage-2
    recipe: the worst LightGlue gradient difference from the plain path,
    relative to that parameter's largest gradient (the gate is
    TRAIN_GRAD_RTOL), and the confidence targets (a layer's argmax equals the
    final layer's) that differ from the plain path's.
The plain path with its attention sums in another order (keys and head dims
reversed: the same function) goes through the same comparison. Last, the
shipped build is timed under other layouts than plan_attention's (PLANS).
Run from the root of the repository; needs nvcc and a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import itertools
import json
import re
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

import chip_smoke as C
from gluefactory_torch.ops import attention as A
from gluefactory_torch.ops import kernels

_RNA = "  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;"
VARIANTS = {  # name: (old, new) replacements in csrc/attention.cu, each old found once
    "shipped": (),
    "1 chunk per add": (("kChunksPerAdd = 2;", "kChunksPerAdd = 1;"),),
    "4 chunks per add": (("kChunksPerAdd = 2;", "kChunksPerAdd = 4;"),),
    "8 chunks per add": (("kChunksPerAdd = 2;", "kChunksPerAdd = 8;"),),
    "cvt.rna.tf32": ((_RNA, '  uint32_t r;\n  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));'
                            "\n  return r;"),),
    "min 3 blocks an SM": (("__launch_bounds__(kMaxWarps * 32, 1)",
                            "__launch_bounds__(kMaxWarps * 32, 3)"),),
}
SHAPES = ((1, 4, 512), (32, 4, 512), (8, 4, 1024))
PLANS = {  # batch of a shape in SHAPES: (rows, tiles per split, splits), plan_attention's first
    1: ((64, 1, 8), (64, 8, 1), (64, 2, 4), (32, 1, 8), (32, 2, 4), (16, 1, 8)),
    32: ((64, 8, 1), (64, 4, 2), (32, 8, 1), (16, 8, 1)),
}


def variant_source(replacements) -> str:
    src = (kernels.CSRC_DIR / A.SOURCE).read_text()
    for old, new in replacements:
        if src.count(old) != 1:
            raise ValueError(f"{old!r} is in {A.SOURCE} {src.count(old)} times, not once")
        src = src.replace(old, new)
    return src


def build_variant(name: str) -> tuple[Path, str]:
    """The variant's library and its nvcc output."""
    out_dir = kernels.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = out_dir / f"attention_{re.sub(r'\W+', '_', name)}.cu"
    cu.write_text(variant_source(VARIANTS[name]))
    lib = cu.with_suffix(".so")
    proc = subprocess.run([kernels.find_nvcc(), *kernels.NVCC_FLAGS, "-o", str(lib), str(cu)],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stdout}{proc.stderr}")
    return lib, proc.stdout + proc.stderr


@contextlib.contextmanager
def launching(lib: ctypes.CDLL):
    """The wrappers launch ``lib``'s kernels while the block runs: it stands
    in the loader's cache for the source."""
    saved = kernels._loaded.get(A.SOURCE)
    kernels._loaded[A.SOURCE] = lib
    try:
        yield
    finally:
        if saved is None:
            kernels._loaded.pop(A.SOURCE)
        else:
            kernels._loaded[A.SOURCE] = saved


@contextlib.contextmanager
def sums_reordered():
    """The plain attention with its sums in another order: keys reversed
    (softmax sums, PV) and head dims reversed in q and k (QK^T)."""
    plain = A.attention_plain

    def reordered(q, k, v, kv_mask=None):
        return plain(q.flip(-1), k.flip(-1).flip(-2), v.flip(-2),
                     None if kv_mask is None else kv_mask.flip(-1))

    A.attention_plain = reordered
    try:
        yield
    finally:
        A.attention_plain = plain


def exact(args, rotary: bool) -> torch.Tensor:
    """The attention of ``args`` in float64, with the kernels' mask rules."""
    q, k, v = (x.double() for x in args[:3])
    mask = args[-1][:, None, None, :]
    if rotary:
        q = A.apply_rotary(q, args[3].double(), args[4].double())
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * q.shape[-1] ** -0.5
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.exp(s - s.amax(-1, keepdim=True)).masked_fill(~mask, 0.0)
    return torch.einsum("bhqk,bhkd->bhqd", p / p.sum(-1, keepdim=True), v)


def errors(out: torch.Tensor, ref: torch.Tensor) -> dict:
    d = out.double() - ref
    return {"max": float(d.abs().max()), "rms": float(d.pow(2).mean().sqrt()),
            "bias": float((d * ref.sign()).mean())}


def step0(trainer, pool, seed: int):
    """Phase 7's step 0 without the update: (loss, LightGlue gradients,
    confidence targets of every layer but the last, False where invalid)."""
    model = trainer.model
    batch = trainer.dataset.make_batch(pool, seed)
    model.zero_grad(set_to_none=True)
    pred = model(batch)
    losses, _ = model.loss(pred, batch)
    loss = losses["total"].mean()
    loss.backward()
    grads = {n: p.grad.detach().clone() for n, p in model.matcher.named_parameters()}
    model.zero_grad(set_to_none=True)
    ctx = {**pred, **batch}
    valid0, valid1 = ctx["keypoint_valid0"], ctx["keypoint_valid1"]
    final = pred["log_assignment"]
    targets = []
    with torch.no_grad():
        for i, head in enumerate(model.matcher.log_assignment[:-1]):
            scores = head(pred["desc_layers0"][i], pred["desc_layers1"][i], valid0, valid1)[0]
            targets.append((scores.argmax(2) == final.argmax(2)) & valid0)
            targets.append((scores.argmax(1) == final.argmax(1)) & valid1)
    return float(loss.detach()), grads, targets


def against(ref, run) -> dict:
    """The gate's reading of ``run`` against the plain path's ``ref``."""
    errs = {n: float((run[1][n] - g).abs().max()) / max(float(g.abs().max()), 1e-30)
            for n, g in ref[1].items()}
    worst = max(errs, key=errs.get)
    return {"loss_rel": abs(run[0] - ref[0]) / abs(ref[0]), "worst": errs[worst],
            "worst_param": worst, "passes": errs[worst] <= C.TRAIN_GRAD_RTOL,
            "flips": sum(int((a != b).sum()) for a, b in zip(ref[2], run[2]))}


def gate_study(libs: dict, n_seeds: int, device) -> dict:
    """Phase 7's step-0 gate over ``n_seeds`` batches for each library in
    ``libs`` and for the reordered plain path. Returns name: per-seed readings."""
    from gluefactory_torch.datasets import get_dataset
    from gluefactory_torch.datasets.homographies_ondevice import upload_pool
    from gluefactory_torch.recipes import STAGE2_WEIGHTS, stage2_conf
    from gluefactory_torch.train import Trainer

    conf = stage2_conf()
    conf["data"]["pool_size"] = C.TRAIN_POOL
    dataset = get_dataset(conf["data"]["name"])(conf["data"])
    pool = upload_pool(dataset.build_pool("train"), device)
    trainers = {}
    for impl in ("auto", "xla"):
        conf["model"]["matcher"]["attention"] = impl
        trainers[impl] = Trainer(conf, device=device, weights=STAGE2_WEIGHTS, pool=pool)
    seeds = list(itertools.islice(dataset.get_data_loader("train"), n_seeds))
    readings = {name: [] for name in ("plain, sums reordered", *libs)}
    for seed in seeds:
        ref = step0(trainers["xla"], pool, seed)
        with sums_reordered():
            readings["plain, sums reordered"].append(against(ref, step0(trainers["xla"], pool,
                                                                        seed)))
        for name, lib in libs.items():
            with launching(lib):
                readings[name].append(against(ref, step0(trainers["auto"], pool, seed)))
        print(json.dumps({"seed": seed, **{n: {k: r[-1][k] for k in ("worst", "flips")}
                                           for n, r in readings.items()}}), flush=True)
    return readings


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seeds", type=int, default=24, help="batches for the gate study")
    parser.add_argument("--only", nargs="*", default=None, help="variant names")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("attention_variants: needs a CUDA device")
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    names = args.only or list(VARIANTS)
    with ThreadPoolExecutor(len(names)) as pool:  # one nvcc each, in parallel
        built = dict(zip(names, pool.map(build_variant, names)))
    libs = {name: ctypes.CDLL(str(path)) for name, (path, _) in built.items()}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=10).stdout.strip()
    print(f"# {smi}", flush=True)

    gen = torch.Generator(device=device).manual_seed(C.SEED + 7)
    cases = {}
    for rotary in (False, True):
        for b, h, n in SHAPES:
            inputs = C._attention_inputs(b, h, n, n, 64, torch.float32, rotary, gen, device)
            inputs[-1][:] |= inputs[-1].sum(-1, keepdim=True) == 0  # no fully-masked item
            cases[rotary, b] = inputs
    refs = {}
    for rotary in (False, True):
        inputs = cases[rotary, 32]
        plain = (A.attention_rotary_plain if rotary else A.attention_plain)(*inputs)
        refs[rotary] = (plain, exact(inputs, rotary))
        print(f"# plain {'K1' if rotary else 'K2'} 32x4x512 vs float64: "
              f"{json.dumps(errors(plain, refs[rotary][1]))}", flush=True)

    rows = {}
    for name in names:
        row = {"variant": name, "ptxas": {k: u for k, u in C.ptxas_usage(built[name][1])
                                          if k.startswith("attention_kernelIf")}}
        with launching(libs[name]):
            for rotary in (False, True):
                kern = A.attention_rotary_cuda if rotary else A.attention_cuda
                label = "K1" if rotary else "K2"
                out = kern(*cases[rotary, 32])
                plain, ref = refs[rotary]
                row[f"{label} vs float64"] = errors(out, ref)
                row[f"{label} vs plain max"] = float((out - plain).abs().max())
                for b, h, n in SHAPES:
                    ms = C.graph_ms(lambda: kern(*cases[rotary, b]), reps=20 if b == 1 else 5)
                    row[f"{label} {b}x{h}x{n} us"] = ms * 1e3
        rows[name] = row
        print(json.dumps(row), flush=True)

    readings = gate_study(libs, args.seeds, device)
    for name, runs in readings.items():
        summary = {"passes": sum(r["passes"] for r in runs), "seeds": len(runs),
                   "seeds_with_flips": sum(r["flips"] > 0 for r in runs),
                   "flips": [r["flips"] for r in runs],
                   "worst": [round(r["worst"], 6) for r in runs],
                   "median_worst": float(np.median([r["worst"] for r in runs])),
                   "max_loss_rel": max(r["loss_rel"] for r in runs)}
        rows.setdefault(name, {"variant": name})["gate"] = summary
        print(json.dumps({"variant": name, "gate": summary}), flush=True)

    plans = []
    with launching(libs[names[0]]):
        for b, layouts in PLANS.items():
            for rotary in (False, True):
                launch = A._launch_attention_rotary if rotary else A._launch_attention
                for plan in map(A.AttentionPlan._make, layouts):
                    ms = C.graph_ms(lambda: launch(*cases[rotary, b], plan),
                                    reps=20 if b == 1 else 5)
                    plans.append({"kernel": "K1" if rotary else "K2", "batch": b,
                                  "plan": list(plan), "us": ms * 1e3})
                    print(json.dumps(plans[-1]), flush=True)
    print(json.dumps({"device": smi, "variants": list(rows.values()), "plans": plans}),
          flush=True)


if __name__ == "__main__":
    main()
