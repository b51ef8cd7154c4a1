"""Probe that the port's CUDA kernels build and run on this machine
(gluefactory_tpu/scripts/pallas_probe.py).

Each worker runs in a subprocess under a hard timeout, so a hung build or
launch cannot hang the caller:
  tiny       kernel K3 (ops/elementwise) adds two (256, 256) float32 ones;
             the result must be exactly 2 everywhere (checksum 131072);
  attention  kernel K2 (ops/attention) at 8x4x1024x64 float32 against its
             plain version, max |err| < 1e-2; run only if tiny executed.
The verdict, one JSON object, is written to ``--out`` and printed: for each
worker its status (EXECUTED, hung, or rc=N when it exited without a result),
its seconds, and what it reported (``ok``, checksum, error, launches). The
workers run on ``--device`` (CUDA unless asked) and never fall back to the
CPU. The exit code is 0 only if both workers executed and are ok.

    python -m gluefactory_torch.scripts.kernel_probe [--out PATH] [--timeout 240]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

from ..ops.kernels import BUILD_DIR, PACKAGE_DIR
from ..utils.device import resolve_device

TINY_SHAPE = (256, 256)
ATTENTION_SHAPE = (8, 4, 1024, 64)


def _worker(which: str, device: str) -> int:
    import torch

    from ..ops import attention, elementwise

    dev = resolve_device(device)
    if which == "tiny":
        x = torch.ones(TINY_SHAPE, device=dev)
        out = elementwise.add_cuda(x, x)
        checksum = float(out.sum())
        rec = {"ok": bool((out == 2.0).all()) and checksum == 2.0 * x.numel(),
               "checksum": checksum, "launches": dict(elementwise.launches)}
    elif which == "attention":
        gen = torch.Generator(device=dev).manual_seed(0)
        q = torch.randn(ATTENTION_SHAPE, generator=gen, device=dev)
        out = attention.attention_cuda(q, q, q)
        err = float((out - attention.attention_plain(q, q, q)).abs().max())
        rec = {"ok": err < 1e-2, "max_abs_err": err, "checksum": float(out.sum()),
               "launches": dict(attention.launches)}
    else:
        raise ValueError(f"unknown worker {which!r}")
    rec["device"] = str(dev) if dev.type == "cpu" else torch.cuda.get_device_name(dev)
    print(json.dumps(rec), flush=True)
    return 0 if rec["ok"] else 1


def probe(which: str, timeout: float, device: str = "cuda") -> dict:
    """Run one worker in a subprocess; its verdict."""
    t0 = time.perf_counter()
    cmd = [sys.executable, "-m", __spec__.name, "--worker", which, "--device", device]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout,
                              cwd=PACKAGE_DIR.parent)
    except subprocess.TimeoutExpired:
        return {"which": which, "status": "hung", "seconds": round(timeout, 1)}
    seconds = round(time.perf_counter() - t0, 1)
    for line in reversed(proc.stdout.strip().splitlines()):
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            continue
        return {"which": which, "status": "EXECUTED", "seconds": seconds, **rec}
    return {"which": which, "status": f"rc={proc.returncode}", "seconds": seconds,
            "stderr": proc.stderr[-600:]}


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description="Probe the port's CUDA kernels.")
    parser.add_argument("--out", type=Path, default=BUILD_DIR / "kernel_probe.json")
    parser.add_argument("--timeout", type=float, default=240.0)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.worker:
        return _worker(args.worker, args.device)
    resolve_device(args.device)
    results = {"tiny": probe("tiny", args.timeout, args.device)}
    if results["tiny"]["status"] == "EXECUTED":
        results["attention"] = probe("attention", args.timeout * 2, args.device)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(results, indent=2))
    print(json.dumps(results, indent=2))
    passed = [r["status"] == "EXECUTED" and r["ok"] for r in results.values()]
    return 0 if len(passed) == 2 and all(passed) else 1


if __name__ == "__main__":
    sys.exit(main())
