#!/usr/bin/env python3
"""Check the PyTorch/CUDA port (gluefactory_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed with its elapsed seconds; any failure exits non-zero:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: the CUDA attention kernels (csrc/attention.cu, one nvcc call);
  3. kernels: K1 (rotary self-attention) and K2 (masked attention) against
     their plain PyTorch versions on the card, in float32, float16 and
     bfloat16, then timed at the flagship shapes beside the plain version,
     PyTorch's scaled_dot_product_attention and the card's bound;
  4. flagship: SuperPoint -> LightGlue -> ZNCC refiner -> LO-RANSAC with the
     committed lg_tpu_stage2 weights on 4 rendered 480x360 pairs of known
     homography; every LightGlue attention must go through the kernels
     (12 K1 and 12 K2 launches a pair), the plain path must agree, and the
     homographies must be recovered.
The last three lines: the kernels as JSON, the nvidia-smi line, and
{"ok": true, "device": {...}}. Without a CUDA device it exits 1 and prints
no result. Only torch and numpy are needed besides the repository.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

T0 = time.perf_counter()
H100_F32_FLOPS = 67e12  # dense float32 outside the tensor cores (data sheet)
H100_BYTES_PER_S = 3.35e12  # HBM3
SEED = 20260417


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - T0:7.2f} s] {msg}", flush=True)


# --- synthetic pairs (numpy only) ------------------------------------------

def _fill_polygon(img, pts, color):
    """Even-odd fill of a polygon (vertices (n, 2) as x, y) into img (h, w)."""
    h, w = img.shape
    x0, y0 = max(int(pts[:, 0].min()), 0), max(int(pts[:, 1].min()), 0)
    x1, y1 = min(int(pts[:, 0].max()) + 1, w), min(int(pts[:, 1].max()) + 1, h)
    if x0 >= x1 or y0 >= y1:
        return
    import numpy as np

    py, px = np.mgrid[y0:y1, x0:x1].astype(np.float64)
    inside = np.zeros(px.shape, bool)
    for (xa, ya), (xb, yb) in zip(pts, np.roll(pts, -1, axis=0)):
        crosses = (ya > py) != (yb > py)
        xcross = (xb - xa) * (py - ya) / np.where(yb == ya, 1e-12, yb - ya) + xa
        inside ^= crosses & (px < xcross)
    img[y0:y1, x0:x1][inside] = color


def render_scene(rng, w: int, h: int):
    """A grayscale scene in [0, 1] of the kind the flagship was trained on:
    a shaded background under filled polygons, rectangles, checkerboards and
    ellipses of random gray levels."""
    import numpy as np

    gx = np.linspace(0, 1, w)[None, :]
    gy = np.linspace(0, 1, h)[:, None]
    a, b, c = rng.uniform(0.1, 0.9, 3)
    img = (a * gx + b * gy + c) / (a + b + c) * rng.uniform(0.3, 0.9)
    for _ in range(int(rng.integers(14, 26))):
        color = rng.uniform(0, 1)
        kind = int(rng.integers(0, 4))
        if kind == 0:  # polygon around a center
            n = int(rng.integers(3, 7))
            cx, cy, r = rng.uniform(0, w), rng.uniform(0, h), rng.uniform(10, h / 4)
            ang = np.sort(rng.uniform(0, 2 * np.pi, n))
            pts = np.stack([cx + r * np.cos(ang), cy + r * np.sin(ang)], -1).astype(int)
            _fill_polygon(img, pts.astype(np.float64), color)
        elif kind == 1:  # rectangle
            x0, y0 = int(rng.uniform(0, w - 20)), int(rng.uniform(0, h - 20))
            x1, y1 = x0 + int(rng.uniform(10, w / 3)), y0 + int(rng.uniform(10, h / 3))
            img[y0:y1, x0:x1] = color
        elif kind == 2:  # checkerboard patch
            cell = int(rng.integers(8, 24))
            nx, ny = int(rng.integers(2, 6)), int(rng.integers(2, 6))
            x0 = int(rng.uniform(0, max(w - cell * nx, 1)))
            y0 = int(rng.uniform(0, max(h - cell * ny, 1)))
            other = rng.uniform(0, 1)
            for i in range(ny):
                for j in range(nx):
                    img[y0 + i * cell:y0 + (i + 1) * cell,
                        x0 + j * cell:x0 + (j + 1) * cell] = color if (i + j) % 2 else other
        else:  # ellipse
            cx, cy = rng.uniform(0, w), rng.uniform(0, h)
            rx, ry = rng.uniform(8, w / 6), rng.uniform(8, h / 6)
            yy, xx = np.mgrid[0:h, 0:w]
            img[((xx - cx) / rx) ** 2 + ((yy - cy) / ry) ** 2 <= 1.0] = color
    return np.clip(img, 0, 1).astype(np.float32)


def random_homography(rng, w: int, h: int, shift: float):
    """The homography that moves the image corners by up to ``shift`` px,
    in the pipeline's convention (pixel i covers [i, i+1))."""
    import numpy as np

    src = np.array([[0, 0], [w, 0], [w, h], [0, h]], np.float64)
    dst = src + rng.uniform(-shift, shift, (4, 2))
    A = []
    for (x, y), (u, v) in zip(src, dst):
        A.append([x, y, 1, 0, 0, 0, -u * x, -u * y])
        A.append([0, 0, 0, x, y, 1, -v * x, -v * y])
    hvec = np.linalg.solve(np.array(A), dst.reshape(-1))
    return np.append(hvec, 1.0).reshape(3, 3).astype(np.float32)


def warp_image(img, H, device):
    """image1(x) = image0(H^-1 x), bilinear, zeros outside (grid_sample)."""
    import torch
    import torch.nn.functional as F

    h, w = img.shape[:2]
    ys, xs = torch.meshgrid(torch.arange(h, device=device) + 0.5,
                            torch.arange(w, device=device) + 0.5, indexing="ij")
    pts = torch.stack([xs, ys, torch.ones_like(xs)], -1).reshape(-1, 3)
    src = pts @ torch.linalg.inv(torch.as_tensor(H, device=device)).T
    src = src[:, :2] / src[:, 2:]
    grid = torch.stack([src[:, 0] / w * 2 - 1, src[:, 1] / h * 2 - 1], -1)
    image = torch.as_tensor(img, device=device).permute(2, 0, 1)[None]
    out = F.grid_sample(image, grid.reshape(1, h, w, 2), mode="bilinear",
                        padding_mode="zeros", align_corners=False)
    return out[0].permute(1, 2, 0).contiguous()


def make_pairs(n: int, w: int, h: int, device, seed: int = SEED):
    """n (image0, image1, H_0to1) triples: images (H, W, 3) on ``device``."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    pairs = []
    for i in range(n):
        gray = render_scene(rng, w, h)
        img0 = np.repeat(gray[:, :, None], 3, axis=-1)
        H = random_homography(rng, w, h, shift=25.0 + 10.0 * i)
        pairs.append((torch.as_tensor(img0, device=device), warp_image(img0, H, device),
                      torch.as_tensor(H, device=device)))
    return pairs


def run_pair(model, estimator, img0, img1, H):
    """Predictions, RANSAC output and corner error of one pair."""
    import torch

    from gluefactory_torch.flagship import estimate_homography
    from gluefactory_torch.geometry.homography import homography_corner_error

    size = torch.tensor([[img0.shape[1], img0.shape[0]]], dtype=torch.float32,
                        device=img0.device)
    data = {"view0": {"image": img0[None], "image_size": size},
            "view1": {"image": img1[None], "image_size": size}}
    with torch.inference_mode():
        pred = model(data)
        out = estimate_homography(pred, estimator)
        err = float(homography_corner_error(out["M_0to1"], H, size[0]))
    return pred, out, err


# --- kernel checks -----------------------------------------------------------

TOLERANCES = {  # |kernel - plain| <= atol + rtol * |plain|
    "float32": (2e-5, 0.0),  # f32 sums in another order
    "float16": (1e-3, 1e-3),  # one rounding of the f32 result: ~1 ulp
    "bfloat16": (8e-3, 8e-3),
}


def _attention_inputs(b, h, nq, nk, d, dtype, rotary, gen, device):
    import torch

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=device).to(dtype)

    q, k, v = randn(b, h, nq, d), randn(b, h, nk, d), randn(b, h, nk, d)
    mask = torch.rand(b, nk, generator=gen, device=device) > 0.15
    if b > 1:
        mask[1] = False  # a fully-masked batch item: rows of zeros
    if not rotary:
        return (q, k, v, mask)
    theta = torch.randn(b, nq, d // 2, generator=gen, device=device) * 3
    cos = theta.cos().repeat_interleave(2, -1).to(dtype)
    sin = theta.sin().repeat_interleave(2, -1).to(dtype)
    from gluefactory_torch.ops.attention import apply_rotary

    return (q, apply_rotary(k.float(), cos.float(), sin.float()).to(dtype), v, cos, sin,
            mask)


def graph_ms(fn, reps: int = 20, iters: int = 10) -> float:
    """Device time of one ``fn()``: ``reps`` calls captured in a CUDA graph,
    replayed ``iters`` times between CUDA events (no host gaps)."""
    import torch

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * iters)


def check_kernels(device):
    """Parity of both kernels with their plain versions; timings at the
    flagship shapes. Returns one JSON-ready dict per kernel."""
    import torch
    import torch.nn.functional as F

    from gluefactory_torch.ops import attention as A

    kernels = {
        "attention_rotary": dict(kernel=A.attention_rotary_cuda, plain=A.attention_rotary_plain,
                                 rotary=True, replaces="gluefactory_tpu/ops/attention.py:166"),
        "attention": dict(kernel=A.attention_cuda, plain=A.attention_plain, rotary=False,
                          replaces="gluefactory_tpu/ops/attention.py:89"),
    }
    gen = torch.Generator(device=device).manual_seed(SEED)
    shapes = [(1, 4, n, n, 64) for n in (512, 1024, 2048)]
    shapes += [(1, 4, 1000, 777, 64), (2, 4, 300, 300, 64)]
    for name, kern in kernels.items():
        kern["max_abs_err"] = 0.0
        for dtype in (torch.float32, torch.float16, torch.bfloat16):
            atol, rtol = TOLERANCES[str(dtype).split(".")[1]]
            for b, h, nq, nk, d in shapes:
                if kern["rotary"] and nq != nk:
                    nq = nk = 1000  # self-attention: the unaligned case is square
                args = _attention_inputs(b, h, nq, nk, d, dtype, kern["rotary"], gen, device)
                out = kern["kernel"](*args)
                ref = kern["plain"](*args)
                torch.cuda.synchronize()
                err = (out.float() - ref.float()).abs()
                bound = atol + rtol * ref.float().abs()
                worst = float(err.max())
                if not bool((err <= bound).all()) or not bool(torch.isfinite(out).all()):
                    raise AssertionError(f"{name} {dtype} {(b, h, nq, nk, d)}: "
                                         f"max |err| {worst:.3g} over atol {atol} rtol {rtol}")
                if b > 1 and bool(out[1].float().abs().max() != 0):
                    raise AssertionError(f"{name}: a fully-masked row is not zero")
                if dtype == torch.float32:
                    kern["max_abs_err"] = max(kern["max_abs_err"], worst)
                log(f"  {name:17s} {str(dtype):14s} B,H,Nq,Nk,D={b},{h},{nq},{nk},{d}: "
                    f"max |err| {worst:.3g} (atol {atol}, rtol {rtol}) ok")

    # timings at the flagship shapes, float32, the key mask of the real path
    results = []
    for name, kern in kernels.items():
        b, h, n, d = 1, 4, 512, 64
        args = _attention_inputs(b, h, n, n, d, torch.float32, kern["rotary"], gen, device)
        q, k, v, mask = args[0], args[1], args[2], args[-1]
        if kern["rotary"]:
            q_lib = A.apply_rotary(q, args[3], args[4])  # SDPA has no rotary: q pre-rotated
        else:
            q_lib = q
        sdpa_mask = mask[:, None, None, :]
        ms = graph_ms(lambda: kern["kernel"](*args))
        plain_ms = graph_ms(lambda: kern["plain"](*args))
        library_ms = graph_ms(lambda: F.scaled_dot_product_attention(
            q_lib, k, v, attn_mask=sdpa_mask))
        flops = 4 * b * h * n * n * d
        nbytes = sum(t.numel() * t.element_size() for t in args) + q.numel() * 4  # + output
        t_ops, t_bytes = flops / H100_F32_FLOPS * 1e3, nbytes / H100_BYTES_PER_S * 1e3
        results.append({
            "name": name, "route": "cuda", "source": "gluefactory_torch/csrc/attention.cu",
            "replaces": kern["replaces"], "launches": 0,
            "max_abs_err": kern["max_abs_err"], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": library_ms,
        })
        log(f"  {name:17s} f32 B,H,N,D={b},{h},{n},{d}: kernel {ms * 1e3:.1f} us, plain "
            f"{plain_ms * 1e3:.1f} us, SDPA {library_ms * 1e3:.1f} us, bound "
            f"{max(t_ops, t_bytes) * 1e3:.2f} us ({flops / 1e6:.0f} MFLOP, "
            f"{nbytes / 1e6:.2f} MB)")
    return results


# --- main --------------------------------------------------------------------

def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script checks the port on an "
              "NVIDIA GPU", file=sys.stderr)
        return 1

    from gluefactory_torch.flagship import load_flagship, matched_keypoints
    from gluefactory_torch.ops import attention as A
    from gluefactory_torch.ops import kernels

    # float32 means float32: no TF32 in the matmuls or the convolutions, and
    # deterministic convolutions so two runs detect the same keypoints
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    device = torch.device("cuda", 0)

    log("phase 1: device")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=10, check=True).stdout.strip().splitlines()[0]
    log(f"  {kind}; nvidia-smi: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(smi, flush=True)

    log("phase 2: build")
    t = time.perf_counter()
    kernels.load(A.SOURCE)
    log(f"  {A.SOURCE}: {time.perf_counter() - t:.1f} s "
        f"(nvcc {kernels.build_seconds[A.SOURCE]:.1f} s)")
    ptxas = kernels.library_path(A.SOURCE).with_suffix(".log").read_text()
    for line in ptxas.splitlines():
        if "registers" in line or "spill" in line:
            log("  ptxas: " + line.strip())

    log("phase 3: kernels against their plain versions")
    results = check_kernels(device)

    log("phase 4: flagship pipeline")
    pairs = make_pairs(4, 480, 360, device)
    model, estimator = load_flagship(device=device, attention="auto")
    plain_model, _ = load_flagship(device=device, attention="xla")
    log("  weights loaded (193 keys, strict), 4 pairs rendered")
    run_pair(model, estimator, *pairs[0])  # warm-up: cuDNN and library handles
    run_pair(plain_model, estimator, *pairs[0])
    torch.cuda.synchronize()

    A.reset_launches()
    stats = {"matches": [], "h_err": [], "ms": [], "plain_ms": [], "agree": []}
    per_pair = []
    for i, (img0, img1, H) in enumerate(pairs):
        before = dict(A.launches)
        t = time.perf_counter()
        pred, out, err = run_pair(model, estimator, img0, img1, H)
        torch.cuda.synchronize()
        stats["ms"].append((time.perf_counter() - t) * 1e3)
        per_pair.append({k: A.launches[k] - before[k] for k in A.launches})
        t = time.perf_counter()
        ppred, _, perr = run_pair(plain_model, estimator, img0, img1, H)
        torch.cuda.synchronize()
        stats["plain_ms"].append((time.perf_counter() - t) * 1e3)

        m0, pm0 = pred["matches0"][0], ppred["matches0"][0]
        for key in ("keypoints0", "keypoint_valid0", "keypoint_valid1"):
            if not torch.equal(pred[key], ppred[key]):
                raise AssertionError(f"pair {i}: {key} differ between kernel and plain runs")
        unrefined = torch.ones_like(m0, dtype=torch.bool)
        unrefined[torch.cat([m0[m0 > -1], pm0[pm0 > -1]])] = False
        if not torch.equal(pred["keypoints1"][0][unrefined], ppred["keypoints1"][0][unrefined]):
            raise AssertionError(f"pair {i}: keypoints1 differ between kernel and plain runs")
        agree = float((m0 == pm0).float().mean())
        n_matches = int(matched_keypoints(pred)[0].shape[0])
        for key in ("keypoints1", "descriptors0", "log_assignment"):
            if not bool(torch.isfinite(pred[key].clamp_min(-1e30)).all()):
                raise AssertionError(f"pair {i}: non-finite {key}")
        stats["matches"].append(n_matches)
        stats["h_err"].append(err)
        stats["agree"].append(agree)
        log(f"  pair {i}: {n_matches} matches, corner error {err:.3f} px (plain path "
            f"{perr:.3f} px), matches0 agree {agree:.4f}, {stats['ms'][-1]:.1f} ms "
            f"(plain path {stats['plain_ms'][-1]:.1f} ms), launches {per_pair[-1]}")
    launches = dict(A.launches)

    for i, counts in enumerate(per_pair):
        if counts != {"attention_rotary": 12, "attention": 12}:
            raise AssertionError(f"pair {i}: kernel launches {counts}, expected 12 and 12")
    if min(stats["agree"]) < 0.99:
        raise AssertionError(f"matches0 agree below 99%: {stats['agree']}")
    med_matches, med_err = np.median(stats["matches"]), np.median(stats["h_err"])
    log(f"  median matches {med_matches}, median corner error {med_err:.3f} px, "
        f"median pair time {np.median(stats['ms']):.1f} ms (plain path "
        f"{np.median(stats['plain_ms']):.1f} ms), launches {launches}")
    if not (med_matches > 200 and med_err < 1.5):
        raise AssertionError(f"flagship quality gate: {stats}")

    for r in results:
        r["launches"] = launches[r["name"]]
    log(f"done in {time.perf_counter() - T0:.1f} s")
    print(json.dumps({"kernels": results}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
