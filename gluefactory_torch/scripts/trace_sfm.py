"""Where the time of a trajectory scene goes: one rendered scene of 8 views
through a trajectory run's card (``recipes.TRAJECTORY_CONFS``), then
``run_sfm`` by stage; the chain's RANSAC with its links in one batch against
one link at a time; and the bundle adjustment as run (on the card, a
replayed CUDA graph of one iteration) against an eager loop of its
iterations, the latter under ``torch.profiler`` (kernels an iteration,
device time by operation).

    python -m gluefactory_torch.scripts.trace_sfm [--conf sift_lg_stage2]
        [--device cuda] [--reps 3]

Prints one JSON line, with the card's name and power limit."""

from __future__ import annotations

import argparse
import json
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from ..eval.eval_pipeline import synchronize
from ..utils.device import describe_device, resolve_device


def _ms(fn, device, reps: int) -> list:
    out = []
    for _ in range(reps):
        synchronize(device)
        t = time.perf_counter()
        fn()
        synchronize(device)
        out.append((time.perf_counter() - t) * 1e3)
    return out


def trace(conf: str, device: torch.device, reps: int) -> dict:
    from ..robust_estimators.homography.ransac import sample_minimal_sets
    from ..sfm.ba import _observed_cameras, bundle_adjust, lm_step
    from ..sfm.pipeline import ransac_links
    from .sfm_trajectory import build_pipeline, match_scene, render_scene_job, score_scene

    report = {"device": describe_device(device), "conf": conf}
    with tempfile.TemporaryDirectory() as tmp:
        render_scene_job(Path(tmp), 0, 0, 8)
        model = build_pipeline(conf, None, device=device)
        scene = Path(tmp) / "scene_0"
        match_scene(scene, model, device)  # warm-up: graphs, kernels, handles
        report["forward_ms"] = _ms(lambda: match_scene(scene, model, device), device, reps)
        kpts, valid, matches, meta = match_scene(scene, model, device)
    stages, details = [], {}
    for seed in range(reps):
        stages.append({})
        score_scene(kpts, valid, matches, meta, device, seed, timings=stages[-1],
                    details=details)
    report["stage_ms"] = stages

    # the chain's RANSAC: every link in one batch, and one link at a time
    cams = details["cameras"].to(device)
    rays = cams.image2cam(torch.from_numpy(kpts).to(device))
    V, N = kpts.shape[:2]
    r0 = torch.zeros(V - 1, N, 3, device=device)
    r1 = torch.zeros(V - 1, N, 3, device=device)
    link_valid = torch.zeros(V - 1, N, dtype=torch.bool, device=device)
    for i in range(V - 1):
        m = torch.from_numpy(matches[(i, i + 1)]).to(device)
        sel = m >= 0
        r0[i][sel], r1[i][sel] = rays[i][sel], rays[i + 1][m[sel]]
        link_valid[i] = sel & torch.from_numpy(valid[i]).to(device)
    g = torch.Generator(device=device).manual_seed(0)
    idx = torch.stack([sample_minimal_sets(link_valid[i], 1024, g, 5) for i in range(V - 1)])
    th = [2.0 / float(cams.f[0].mean())] * (V - 1)
    report["chain_batched_ms"] = _ms(lambda: ransac_links(r0, r1, link_valid, th, idx),
                                     device, reps)
    report["chain_each_link_ms"] = _ms(lambda: [ransac_links(
        r0[i:i + 1], r1[i:i + 1], link_valid[i:i + 1], th[:1], idx[i:i + 1])
        for i in range(V - 1)], device, reps)

    # the bundle adjustment: as run_sfm runs it (on the card a replayed CUDA graph of
    # one iteration) and as an eager loop of lm_step, the latter profiled
    problem = details["sfm"]["problem"]
    report["ba"] = {"points": problem.num_points, "observations": len(problem.obs_cam)}
    report["ba"]["ms"] = _ms(lambda: bundle_adjust(problem, 40, 1.0, trim_th=20.0), device,
                             reps)
    cam_o = _observed_cameras(problem)

    def eager():
        poses, points = problem.poses, problem.points
        lam = torch.tensor(1e-3, device=device)
        for _ in range(40):
            poses, points, lam, _, _ = lm_step(problem, poses, points, lam, 1.0, 20.0, cam_o)

    report["ba"]["eager_ms"] = _ms(eager, device, reps)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        eager()
        synchronize(device)
    events = prof.key_averages()
    on_card = [e for e in events if str(getattr(e, "device_type", "")).endswith("CUDA")]

    def self_us(e):
        if device.type != "cuda":
            return e.self_cpu_time_total
        return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))

    top = sorted(on_card or events, key=self_us, reverse=True)[:12]
    report["ba"]["kernels_an_iteration"] = sum(e.count for e in on_card) / 40
    report["ba"]["device_ms"] = sum(self_us(e) for e in on_card) / 1e3
    report["ba"]["top"] = [(e.key, round(self_us(e) / 1e3, 3), e.count) for e in top]
    return report


def main(argv: list[str] | None = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--conf", default="sift_lg_stage2")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    print(json.dumps(trace(args.conf, resolve_device(args.device), args.reps),
                     default=lambda x: float(np.asarray(x))))


if __name__ == "__main__":
    main()
