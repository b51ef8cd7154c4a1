"""Where the time of the pose benchmark's RANSAC sweep goes: ``torch.profiler``
over the 6-threshold sweep of one pair of the rendered pose set (the first
pair of scene 0 of ``generate_pose_eval_set``'s defaults) at the flagship's operating
point (``recipes.pose_flagship_conf``: 1600-pixel canvas, 1024 keypoints,
2048 hypotheses of 5-point LO-RANSAC, 6 LO and 8 Gauss-Newton steps), after
a warm-up sweep. Prints the host-clock sweep time, the device's busy and
idle shares, the device time under each linear-algebra operator (children
included), the number of reads that wait for the device, and the kernels
that took the most device time; then, for one threshold, each line of the
port that synchronised the host with the device (PyTorch's sync debug
mode) and how often. Needs a CUDA device.

    python -m gluefactory_torch.scripts.trace_pose_ransac [--rows 20]
"""

from __future__ import annotations

import argparse
import linecache
import subprocess
import tempfile
import time
import warnings
from collections import Counter
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from ..core.config import merge
from ..eval.eval_pipeline import SWEEP, synchronize, unbatch
from ..eval.megadepth1500 import MegaDepth1500Pipeline
from ..eval.utils import eval_relative_pose_robust, eval_relative_pose_robust_sweep
from ..models.cache_loader import CacheLoader
from ..recipes import pose_flagship_conf
from ..scripts.generate_pose_eval_set import render_scene_job, write_pairs
from ..utils.device import resolve_device

GROUPS = {  # operator: what it is in the sweep
    "aten::linalg_det": "det: 5-point grid and bisection, constraint fit",
    "aten::linalg_svd": "svd: null spaces, root null vectors, 8-point, E decomposition",
    "aten::linalg_eigh": "eigh: weighted 8-point of each LO step",
    "aten::linalg_solve_ex": "solve: Gauss-Newton steps",
    "aten::multinomial": "minimal-set draws",
}
READS = ("aten::_local_scalar_dense", "cudaStreamSynchronize", "cudaDeviceSynchronize")


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--rows", type=int, default=20)
    args = parser.parse_args(argv)
    device = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    conf = pose_flagship_conf()
    with tempfile.TemporaryDirectory() as tmp:
        write_pairs(tmp, render_scene_job(tmp, 31415, 0, 2)[:1])
        conf = merge(conf, {"data": {"pairs": str(Path(tmp) / "pairs_calibrated.txt"),
                                     "root": str(Path(tmp) / "images")}})
        pipeline = MegaDepth1500Pipeline(conf, device=device)
        pred_file = pipeline.get_predictions(tmp)
        batch = next(iter(pipeline.get_dataloader()))
        data, pred = unbatch(batch), CacheLoader({"path": str(pred_file)})(batch)

    def sweep():
        pipeline.sweep(data, pred, eval_relative_pose_robust_sweep)

    sweep()  # warm-up: library handles, workspaces
    synchronize(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with record_function("sweep"):
            sweep()
        synchronize(device)
        host_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
               and e.key != "sweep"]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    n_matches = int((pred["matches0"] > -1).sum())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=10).stdout.strip()
    print(f"{smi or torch.cuda.get_device_name(device)}: one pair ({n_matches} matches), "
          f"{len(SWEEP)} thresholds x {conf['eval']['num_hypotheses']} hypotheses: sweep "
          f"{host_ms:.1f} ms on the host clock (profiled), device busy {busy_ms:.1f} ms "
          f"({100 * busy_ms / host_ms:.1f}%), idle {100 * (1 - busy_ms / host_ms):.1f}%; "
          f"{sum(e.count for e in kernels)} kernel launches")
    for key, what in GROUPS.items():
        found = [e for e in events if e.key == key]
        ms = sum(e.device_time_total for e in found) / 1e3
        print(f"  {ms:9.2f} ms device  {sum(e.count for e in found):5d} calls  {what}")
    for key in READS:
        print(f"  {sum(e.count for e in events if e.key == key):5d} x {key}")
    print(f"  the {args.rows} kernels with the most device time:")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:args.rows]:
        print(f"    {e.self_device_time_total / 1e3:9.2f} ms  {e.count:6d}x  {e.key[:110]}")

    # which lines wait for the device, in one RANSAC (the threshold of 1 px)
    synchronize(device)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            eval_relative_pose_robust(data, pred, merge(conf["eval"], {"ransac_th": 1.0}),
                                      device=device)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    lines = Counter((w.filename, w.lineno) for w in caught
                    if "synchronizing" in str(w.message))
    print(f"  {sum(lines.values())} synchronising calls in one RANSAC, by line:")
    for (filename, lineno), count in lines.most_common():
        where = filename.split("gluefactory_torch/")[-1]
        print(f"    {count:4d}x  {where}:{lineno}  {linecache.getline(filename, lineno).strip()}")


if __name__ == "__main__":
    main()
