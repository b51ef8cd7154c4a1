"""Time a benchmark's RANSAC sweep (6 thresholds) run threshold by threshold
against the same sweep in one batch (``BaseEstimator.sweep``), for the
homography LO-RANSAC, the point-and-line hybrid one and the 5-point
relative pose one, on synthetic pairs; and hold the batch to the thresholds
one by one and to the CPU.

    python -m gluefactory_torch.scripts.trace_ransac_sweep [--device cuda]
        [--reps 5]

Host-clock milliseconds, each call ended by a device synchronise, median of
``--reps`` after one warm-up."""

from __future__ import annotations

import argparse
import subprocess
import time

import numpy as np
import torch

from ..core.config import merge
from ..eval.eval_pipeline import SWEEP, synchronize
from ..geometry.wrappers import Camera
from ..robust_estimators import load_estimator
from ..utils.device import resolve_device


def homography_pair(rng, n: int, n_lines: int, outliers: float = 0.4) -> dict:
    """Matches (and matched segments) of a random homography at 640x480,
    1 px of noise, ``outliers`` of them replaced by uniform points."""
    H = np.eye(3) + rng.normal(0, 0.05, (3, 3))
    H[2, :2] *= 0.002

    def warp(p):
        q = np.c_[p, np.ones(len(p))] @ H.T
        return q[:, :2] / q[:, 2:]

    p0 = rng.uniform(0, 640, (n, 2))
    p1 = warp(p0) + rng.normal(0, 1.0, (n, 2))
    bad = rng.random(n) < outliers
    p1[bad] = rng.uniform(0, 640, (int(bad.sum()), 2))
    s0 = rng.uniform(0, 640, (n_lines, 2, 2))
    s1 = warp(s0.reshape(-1, 2)).reshape(n_lines, 2, 2) + rng.normal(0, 1.0, (n_lines, 2, 2))
    f = torch.float32
    return {"m_kpts0": torch.tensor(p0, dtype=f), "m_kpts1": torch.tensor(p1, dtype=f),
            "valid": torch.ones(n, dtype=torch.bool), "m_lines0": torch.tensor(s0, dtype=f),
            "m_lines1": torch.tensor(s1, dtype=f),
            "valid_lines": torch.ones(n_lines, dtype=torch.bool)}


def pose_pair(rng, n: int, outliers: float = 0.3) -> dict:
    """Matches of random 3D points seen by two cameras (f = 500 px)."""
    K = np.array([[500.0, 0, 320], [0, 500, 240], [0, 0, 1]])
    X = np.c_[rng.uniform(-2, 2, (n, 2)), rng.uniform(3, 8, n)]
    a = rng.normal(0, 0.1, 3)
    ax = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    R = np.eye(3) + ax + ax @ ax / 2  # near a rotation; the estimator does not care
    U, _, Vt = np.linalg.svd(R)
    R = U @ Vt
    t = rng.normal(0, 1, 3)

    def project(P):
        q = P @ K.T
        return q[:, :2] / q[:, 2:]

    p0, p1 = project(X), project(X @ R.T + t) + rng.normal(0, 1.0, (n, 2))
    bad = rng.random(n) < outliers
    p1[bad] = rng.uniform(0, 640, (int(bad.sum()), 2))
    cam = Camera.from_calibration_matrix(torch.tensor(K, dtype=torch.float32))
    f = torch.float32
    return {"m_kpts0": torch.tensor(p0, dtype=f), "m_kpts1": torch.tensor(p1, dtype=f),
            "camera0": cam, "camera1": cam, "valid": torch.ones(n, dtype=torch.bool)}


def to(data: dict, device) -> dict:
    return {k: (v.to(device) if isinstance(v, torch.Tensor) else v) for k, v in data.items()}


def timed(fn, device, reps: int) -> tuple[list, float]:
    """(fn()'s result, median host ms over ``reps`` synchronised calls)."""
    out = fn()
    ms = []
    for _ in range(reps):
        synchronize(device)
        t = time.perf_counter()
        out = fn()
        synchronize(device)
        ms.append((time.perf_counter() - t) * 1e3)
    return out, float(np.median(ms))


def matrix(est: dict) -> torch.Tensor:
    M = est["M_0to1"]
    return (M.R if hasattr(M, "R") else M).detach().double().cpu()


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=10).stdout.strip()
        print(smi or torch.cuda.get_device_name(device))
    rng = np.random.default_rng(args.seed)
    cases = [
        ("homography ransac", "homography", "ransac", {"num_hypotheses": 1024},
         homography_pair(rng, 900, 0)),
        ("homography hybrid_ransac", "homography", "hybrid_ransac",
         {"num_hypotheses": 1024}, homography_pair(rng, 500, 60)),
        ("relative_pose ransac (5-point)", "relative_pose", "ransac",
         {"num_hypotheses": 2048, "lo_iters": 6}, pose_pair(rng, 350)),
    ]
    for label, kind, name, conf, data in cases:
        cls = load_estimator(kind, name)
        on = to(data, device)
        one_by_one, ms_each = timed(
            lambda: [cls(merge(conf, {"ransac_th": th}))(on) for th in SWEEP], device, args.reps)
        batch, ms_batch = timed(lambda: cls(conf).sweep(on, SWEEP), device, args.reps)
        cpu = cls(conf).sweep(to(data, "cpu"), SWEEP)
        d_each = max(float((matrix(a) - matrix(b)).abs().max()) for a, b in zip(batch, one_by_one))
        d_cpu = max(float((matrix(a) - matrix(b)).abs().max()) for a, b in zip(batch, cpu))
        inl = [int((a["inliers"].cpu() != b["inliers"].cpu()).sum())
               for a, b in zip(batch, one_by_one)]
        print(f"{label}: {len(data['m_kpts0'])} matches, {len(SWEEP)} thresholds x "
              f"{conf['num_hypotheses']} hypotheses on {device.type}: one threshold a call "
              f"{ms_each:.1f} ms, the sweep in one batch {ms_batch:.1f} ms "
              f"({ms_each / ms_batch:.2f}x); batch against one by one: models within "
              f"{d_each:.2e}, inliers differ {inl}; against the CPU's batch: models within "
              f"{d_cpu:.2e}")


if __name__ == "__main__":
    main()
