#!/usr/bin/env python3
"""Check the PyTorch/CUDA port (gluefactory_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed with its elapsed seconds; any failure exits non-zero:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: the CUDA kernels (csrc/attention.cu and csrc/elementwise.cu, one
     nvcc call each, in parallel);
  3. kernels: K1 (rotary self-attention) and K2 (masked attention) against
     their plain PyTorch versions on the card, in float32, float16 and
     bfloat16, at the flagship and training shapes, ragged shapes and shapes
     that take the split-key plan; then timed in float32 at the flagship
     (1x4x512x64), training (32x4x512x64) and probe (8x4x1024x64) shapes
     beside the plain version, PyTorch's scaled_dot_product_attention and
     the card's bounds (3xTF32 on the tensor cores, f32 on the CUDA cores),
     with the plan (ops.attention.plan_attention) of each shape;
  4. flagship: SuperPoint -> LightGlue -> ZNCC refiner -> LO-RANSAC with the
     committed lg_tpu_stage2 weights on 4 rendered 480x360 pairs of known
     homography; every LightGlue attention must go through the kernels
     (12 K1 and 12 K2 launches a pair), the plain path must agree, and the
     homographies must be recovered;
  5. probe: the kernel probe entry point (scripts/kernel_probe.py) in a
     subprocess, both workers executed and ok; K3 (elementwise add) held
     bit-exact against x + y, timed beside torch.add;
  6. gradients: autograd through the kernels' Functions against autograd
     through the plain versions at the flagship shape, float32 and bfloat16;
  7. training: 5 steps of the stage-2 recipe at full width (batch 32,
     320x320, 512 keypoints, 6 layers) on the kernel path and on the plain
     path from the same weights, pool and seeds; losses, gradients and
     launches gated (see check_training).
The last three lines: the kernels as JSON, the nvidia-smi line, and
{"ok": true, "device": {...}}. Without a CUDA device it exits 1 and prints
no result. Only torch and numpy are needed besides the repository.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

T0 = time.perf_counter()
H100_F32_FLOPS = 67e12  # dense float32 outside the tensor cores (data sheet)
H100_TF32_FLOPS = 495e12  # dense TF32 on the tensor cores; 3xTF32 does 3 passes
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


def attention_bounds(b, h, nq, nk, d, nbytes):
    """(3xTF32 bound, f32 CUDA-core bound, bytes bound) in ms of one call:
    4*B*H*Nq*Nk*D FLOP (two products) done three times at the TF32 rate, or
    once at the f32 rate, and each input read once and the output written
    once at the HBM rate."""
    flops = 4 * b * h * nq * nk * d
    return (3 * flops / H100_TF32_FLOPS * 1e3, flops / H100_F32_FLOPS * 1e3,
            nbytes / H100_BYTES_PER_S * 1e3)


def check_kernels(device):
    """Parity of both kernels with their plain versions; timings at the
    flagship, training and probe shapes. Returns one JSON-ready dict per
    kernel, timed at the flagship shape, with every timed shape under
    ``times_by_shape``."""
    import torch
    import torch.nn.functional as F

    from gluefactory_torch.ops import attention as A

    kernels = {
        "attention_rotary": dict(kernel=A.attention_rotary_cuda, plain=A.attention_rotary_plain,
                                 rotary=True, replaces="gluefactory_tpu/ops/attention.py:166"),
        "attention": dict(kernel=A.attention_cuda, plain=A.attention_plain, rotary=False,
                          replaces="gluefactory_tpu/ops/attention.py:89"),
    }
    sms = torch.cuda.get_device_properties(device).multi_processor_count  # for the plans
    gen = torch.Generator(device=device).manual_seed(SEED)
    shapes = [(1, 4, n, n, 64) for n in (512, 1024, 2048)]
    shapes += [(1, 4, 1000, 777, 64), (2, 4, 300, 300, 64), (1, 4, 200, 3000, 64)]
    training = (32, 4, 512, 512, 64)  # float32 and bfloat16, the training path's types
    for name, kern in kernels.items():
        kern["max_abs_err"] = 0.0
        for dtype in (torch.float32, torch.float16, torch.bfloat16):
            atol, rtol = TOLERANCES[str(dtype).split(".")[1]]
            cases = shapes + ([training] if dtype != torch.float16 else [])
            for b, h, nq, nk, d in cases:
                if kern["rotary"] and nq != nk:
                    nq = nk  # self-attention: the unaligned cases are square
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
                plan = A.plan_attention(b, h, nq, nk, sms)
                log(f"  {name:17s} {str(dtype):14s} B,H,Nq,Nk,D={b},{h},{nq},{nk},{d}: "
                    f"max |err| {worst:.3g} (atol {atol}, rtol {rtol}) ok; plan rows "
                    f"{plan.rows}, {plan.splits} split(s) of {plan.tiles_per_split} tiles")

    # timings in float32 with a key mask and no fully-masked item
    results = []
    for name, kern in kernels.items():
        times = []
        for b, h, n, d in ((1, 4, 512, 64), (32, 4, 512, 64), (8, 4, 1024, 64)):
            args = _attention_inputs(b, h, n, n, d, torch.float32, kern["rotary"], gen, device)
            q, k, v, mask = args[0], args[1], args[2], args[-1]
            mask[:] |= mask.sum(-1, keepdim=True) == 0  # keep the work of every item
            # SDPA has no rotary: q pre-rotated
            q_lib = A.apply_rotary(q, args[3], args[4]) if kern["rotary"] else q
            sdpa_mask = mask[:, None, None, :]
            reps = 20 if b == 1 else 5
            ms = graph_ms(lambda: kern["kernel"](*args), reps=reps)
            plain_ms = graph_ms(lambda: kern["plain"](*args), reps=reps)
            library_ms = graph_ms(lambda: F.scaled_dot_product_attention(
                q_lib, k, v, attn_mask=sdpa_mask), reps=reps)
            nbytes = sum(t.numel() * t.element_size() for t in args) + q.numel() * 4  # + output
            t_tf32, t_f32, t_bytes = attention_bounds(b, h, n, n, d, nbytes)
            plan = A.plan_attention(b, h, n, n, sms)
            times.append({"shape": [b, h, n, n, d], "ms": ms, "plain_ms": plain_ms,
                          "library_ms": library_ms, "bound_ms": max(t_tf32, t_bytes),
                          "bound_by": "operations" if t_tf32 >= t_bytes else "bytes",
                          "bound_ms_cuda_cores": t_f32, "plan": list(plan)})
            log(f"  {name:17s} f32 B,H,N,D={b},{h},{n},{d}: kernel {ms * 1e3:.1f} us, plain "
                f"{plain_ms * 1e3:.1f} us, SDPA {library_ms * 1e3:.1f} us ({library_ms / ms:.2f}x "
                f"the kernel), bound {max(t_tf32, t_bytes) * 1e3:.2f} us 3xTF32 "
                f"({max(t_tf32, t_bytes) / ms:.1%}) / {t_f32 * 1e3:.2f} us f32 CUDA cores; "
                f"{nbytes / 1e6:.2f} MB; plan rows {plan.rows}, {plan.splits} split(s) of "
                f"{plan.tiles_per_split} tiles")
        main = times[0]
        results.append({
            "name": name, "route": "cuda", "source": "gluefactory_torch/csrc/attention.cu",
            "replaces": kern["replaces"], "launches": 0,
            "max_abs_err": kern["max_abs_err"], "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"], "times_by_shape": times,
        })
    return results


# --- phase 5: the kernel probe entry point and K3 ------------------------------

PROBE_TIMEOUT = 300  # seconds for the whole probe (its workers have their own)


def check_probe(device):
    """Run the probe entry point, hold K3 bit-exact against x + y, and time K3
    at the probe's shape (K2 at the probe's 8x4x1024x64 is timed in phase 3).
    Returns (K3's JSON-ready dict, the probe's verdict)."""
    import torch

    from gluefactory_torch.ops import elementwise as E

    root = Path(__file__).resolve().parent
    out_path = root / "gluefactory_torch/_build/kernel_probe.json"
    out_path.unlink(missing_ok=True)  # read only this run's verdict
    proc = subprocess.run(
        [sys.executable, "-m", "gluefactory_torch.scripts.kernel_probe", "--out", str(out_path),
         "--timeout", "120"], capture_output=True, text=True, timeout=PROBE_TIMEOUT, cwd=root)
    if not out_path.exists():
        raise AssertionError(f"kernel probe wrote no verdict (rc {proc.returncode}): "
                             f"{proc.stderr[-2000:]}")
    verdict = json.loads(out_path.read_text())
    for which in ("tiny", "attention"):
        rec = verdict.get(which, {})
        log(f"  probe {which:9s}: {json.dumps(rec)[:300]}")
        if rec.get("status") != "EXECUTED" or not rec.get("ok"):
            raise AssertionError(f"kernel probe {which}: {rec} (rc {proc.returncode}, "
                                 f"stderr {proc.stderr[-2000:]})")
    if proc.returncode != 0:
        raise AssertionError(f"kernel probe exited {proc.returncode}: {proc.stderr[-2000:]}")
    if verdict["tiny"]["launches"] != {"add": 1}:
        raise AssertionError(f"probe tiny launches {verdict['tiny']['launches']}")

    gen = torch.Generator(device=device).manual_seed(SEED)
    buf = torch.randn(2 * 65539 + 1, generator=gen, device=device)
    cases = {"256x256": (buf[:65536].view(256, 256), buf[65536:131072].view(256, 256)),
             "odd length 65539": (buf[:65539], buf[65539:131078]),
             "unaligned by 4 B": (buf[1:65540], buf[65540:131079])}
    for name, (x, y) in cases.items():
        out = E.add_cuda(x, y)
        torch.cuda.synchronize()
        if not torch.equal(out, E.add_plain(x, y)):
            raise AssertionError(f"add {name}: differs from x + y")
        log(f"  add {name}: bit-exact against x + y")
    x, y = cases["256x256"]
    ms = graph_ms(lambda: E.add_cuda(x, y))
    plain_ms = graph_ms(lambda: E.add_plain(x, y))
    library_ms = graph_ms(lambda: torch.add(x, y))
    nbytes = 3 * x.numel() * 4
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S * 1e3, x.numel() / H100_F32_FLOPS * 1e3
    log(f"  add f32 256x256: kernel {ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us, "
        f"torch.add {library_ms * 1e3:.2f} us, bound {max(t_bytes, t_ops) * 1e3:.3f} us "
        f"({nbytes / 1e3:.0f} KB)")

    k3 = {"name": "add", "route": "cuda", "source": "gluefactory_torch/csrc/elementwise.cu",
          "replaces": "gluefactory_tpu/scripts/pallas_probe.py:35", "launches": 0,
          "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
          "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops
          else "operations", "library_ms": library_ms}
    return k3, verdict


# --- phase 6: gradients through the kernels -------------------------------------

GRAD_TOLERANCES = {  # max |d_kernel - d_plain| <= atol + rtol * max |d_plain|, per tensor
    "float32": (1e-5, 1e-4),  # the same f32 recompute, sums in another order
    "bfloat16": (1e-2, 2e-2),  # the plain path rounds rotated q and k to bf16
}


def check_gradients(device):
    """Autograd through both kernels' Functions against autograd through the
    plain versions, same inputs and cotangent, at the flagship shape with a
    key mask. Returns the largest float32 error of each kernel."""
    import torch

    from gluefactory_torch.ops import attention as A

    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    b, h, n, d = 1, 4, 512, 64
    worst = {"attention_rotary": 0.0, "attention": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        atol, rtol = GRAD_TOLERANCES[str(dtype).split(".")[1]]

        def randn(*shape):
            return torch.randn(*shape, generator=gen, device=device).to(dtype)

        q, k, v, g = (randn(b, h, n, d) for _ in range(4))
        theta = torch.randn(b, n, d // 2, generator=gen, device=device) * 3
        cos = theta.cos().repeat_interleave(2, -1).to(dtype)
        sin = theta.sin().repeat_interleave(2, -1).to(dtype)
        mask = torch.rand(b, n, generator=gen, device=device) > 0.15
        cases = {"attention_rotary": (A.self_attention_rotary, (q, k, v, cos, sin)),
                 "attention": (A.attention, (q, k, v))}
        for name, (fn, inputs) in cases.items():
            grads = {}
            for impl in ("auto", "xla"):
                leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
                fn(*leaves, kv_mask=mask, implementation=impl).backward(g)
                grads[impl] = [t.grad for t in leaves]
            torch.cuda.synchronize()
            errs = []
            for label, dk, dp in zip(("q", "k", "v", "cos", "sin"), grads["auto"], grads["xla"]):
                err = float((dk.float() - dp.float()).abs().max())
                scale = float(dp.float().abs().max())
                if not (err <= atol + rtol * scale) or not bool(torch.isfinite(dk).all()):
                    raise AssertionError(f"{name} {dtype}: d{label} max |err| {err:.3g} over "
                                         f"atol {atol} + rtol {rtol} x {scale:.3g}")
                errs.append(f"d{label} {err:.2g}")
                if dtype == torch.float32:
                    worst[name] = max(worst[name], err)
            log(f"  {name:17s} {str(dtype):14s} B,H,N,D={b},{h},{n},{d} backward: "
                f"max |err| {', '.join(errs)} (atol {atol}, rtol {rtol} of max |grad|) ok")
    return worst


# --- phase 7: stage-2 training ---------------------------------------------------

TRAIN_STEPS = 5
TRAIN_POOL = 64  # the recipe's 768 procedural images cut to 64: a pool only feeds draws
TRAIN_GRAD_RTOL = 1e-2  # of each parameter's max |grad|; see check_training


def check_training(device):
    """The stage-2 recipe at its full widths (batch 32, 320x320, 512
    keypoints, 6 layers, 256-d, 4 heads) from the committed lg_tpu_stage2
    weights, 5 steps on the kernel path and on the plain path from the same
    pool and seeds. Returns the attention launches of the kernel path.

    Gates: step-0 losses within 1e-4 relative; step-0 LightGlue gradients
    within TRAIN_GRAD_RTOL of each parameter's largest gradient (the kernels
    differ from the plain path in the last bits, and a near-tie whose argmax
    flips changes the target of one token in the confidence loss); losses
    after 5 steps within 1e-3 relative; every loss and gradient norm finite,
    no step skipped; 12 + 12 attention launches per step."""
    import itertools

    import numpy as np
    import torch

    from gluefactory_torch.datasets import get_dataset
    from gluefactory_torch.datasets.homographies_ondevice import upload_pool
    from gluefactory_torch.ops import attention as A
    from gluefactory_torch.recipes import STAGE2_WEIGHTS, stage2_conf
    from gluefactory_torch.train import Trainer

    conf = stage2_conf()
    conf["data"]["pool_size"] = TRAIN_POOL
    dataset = get_dataset(conf["data"]["name"])(conf["data"])
    t = time.perf_counter()
    pool = upload_pool(dataset.build_pool("train"), device)
    log(f"  pool of {TRAIN_POOL} procedural {conf['data']['source_size']} images on the "
        f"card in {time.perf_counter() - t:.1f} s")
    trainers = {}
    for impl in ("auto", "xla"):
        conf["model"]["matcher"]["attention"] = impl
        trainers[impl] = Trainer(conf, device=device, weights=STAGE2_WEIGHTS, pool=pool)
    n_params = sum(p.numel() for p in trainers["auto"].model.parameters())
    n_train = sum(p.numel() for p in trainers["auto"].optimizer.params)
    log(f"  two pipelines loaded from {STAGE2_WEIGHTS.name} (strict): {n_params} parameters, "
        f"{n_train} trainable")
    seeds = list(itertools.islice(dataset.get_data_loader("train"), TRAIN_STEPS))
    history = {"auto": [], "xla": []}
    times = {"auto": [], "xla": []}
    peak = {"auto": 0, "xla": 0}
    launches = {"attention_rotary": 0, "attention": 0}
    for i, seed in enumerate(seeds):
        for impl, trainer in trainers.items():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            A.reset_launches()
            t = time.perf_counter()
            scalars = trainer.step(seed)
            torch.cuda.synchronize()
            times[impl].append((time.perf_counter() - t) * 1e3)
            peak[impl] = max(peak[impl], torch.cuda.max_memory_allocated())
            history[impl].append(scalars)
            if impl == "auto":
                step_launches = dict(A.launches)
                if step_launches != {"attention_rotary": 12, "attention": 12}:
                    raise AssertionError(f"step {i}: kernel launches {step_launches}, "
                                         "expected 12 and 12")
                for key in launches:
                    launches[key] += step_launches[key]
            elif A.launches != {"attention_rotary": 0, "attention": 0}:
                raise AssertionError(f"step {i}: the plain path launched {A.launches}")
            bad = [k for k, v in scalars.items() if not np.isfinite(v)]
            if bad or scalars["skipped"]:
                raise AssertionError(f"step {i} {impl}: non-finite {bad}, skipped "
                                     f"{scalars['skipped']}")
        ka, kx = history["auto"][-1], history["xla"][-1]
        log(f"  step {i} (seed {seed}): loss {ka['loss/total']:.6f} (plain path "
            f"{kx['loss/total']:.6f}), grad_norm {ka['grad_norm']:.4f} ({kx['grad_norm']:.4f}), "
            f"matcher {ka['grad_norm/matcher']:.4f}, extractor {ka['grad_norm/extractor']:.4f}, "
            f"recall {ka['metric/match_recall']:.3f}, {times['auto'][-1]:.0f} ms "
            f"(plain path {times['xla'][-1]:.0f} ms)")
        if i == 0:
            rel = abs(ka["loss/total"] - kx["loss/total"]) / abs(kx["loss/total"])
            if rel > 1e-4:
                raise AssertionError(f"step 0 losses differ by {rel:.3g} relative")
            plain = dict(trainers["xla"].model.matcher.named_parameters())
            errs = {}
            for name, p in trainers["auto"].model.matcher.named_parameters():
                gk, gp = p.grad, plain[name].grad
                errs[name] = float((gk - gp).abs().max()) / max(float(gp.abs().max()), 1e-30)
            worst = max(errs, key=errs.get)
            log(f"  step 0: loss differs by {rel:.2g} relative; LightGlue gradients differ by "
                f"{np.median(list(errs.values())):.2g} (median over {len(errs)} parameters), "
                f"worst {errs[worst]:.2g} in {worst} (of its max |grad|)")
            if errs[worst] > TRAIN_GRAD_RTOL:
                raise AssertionError(f"step 0 gradient of {worst} differs by {errs[worst]:.3g}")
    rel = abs(history["auto"][-1]["loss/total"] - history["xla"][-1]["loss/total"]) / abs(
        history["xla"][-1]["loss/total"])
    if rel > 1e-3:
        raise AssertionError(f"losses after {TRAIN_STEPS} steps differ by {rel:.3g} relative")
    log(f"  after {TRAIN_STEPS} steps: losses differ by {rel:.2g} relative; median step "
        f"{np.median(times['auto'][1:]):.1f} ms on the kernel path, "
        f"{np.median(times['xla'][1:]):.1f} ms on the plain path (steps 1-{TRAIN_STEPS - 1}); "
        f"peak memory {peak['auto'] / 2**30:.2f} GiB and {peak['xla'] / 2**30:.2f} GiB; "
        f"launches {launches}")
    return launches


# --- main --------------------------------------------------------------------

def ptxas_usage(log_text: str) -> list[tuple[str, str]]:
    """(kernel, "N registers, spill stores/loads") for each kernel in the
    output of nvcc -Xptxas=-v; the name is the mangled one cut after the
    template arguments (e.g. attention_kernelIfLb1E: float, rotary)."""
    import re

    out, name, spill = [], None, ""
    for line in log_text.splitlines():
        if "Function properties for" in line:
            mangled = line.split("for ")[-1].strip()
            match = re.search(r"\d+([a-z_]+_kernel(?:I.*?E)?)E?v", mangled)
            name, spill = (match.group(1) if match else mangled[:60]), ""
        elif name and "spill" in line:
            spill = line.split(",", 1)[1].strip()
        elif name and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line)
            out.append((name, f"{regs.group(1) if regs else '?'} registers, {spill}"))
            name = None
    return out


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script checks the port on an "
              "NVIDIA GPU", file=sys.stderr)
        return 1

    from gluefactory_torch.flagship import load_flagship, matched_keypoints
    from gluefactory_torch.ops import attention as A
    from gluefactory_torch.ops import elementwise as E
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
    kernels.build_all([A.SOURCE, E.SOURCE])  # one nvcc each, in parallel
    for source in (A.SOURCE, E.SOURCE):
        kernels.load(source)
        log(f"  {source}: nvcc {kernels.build_seconds[source]:.1f} s")
        ptxas = kernels.library_path(source).with_suffix(".log").read_text()
        for name, usage in ptxas_usage(ptxas):
            log(f"  ptxas {name}: {usage}")
    log(f"  built in {time.perf_counter() - t:.1f} s")

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


    log("phase 5: kernel probe entry point")
    k3, verdict = check_probe(device)
    results.append(k3)

    log("phase 6: gradients through the kernels")
    grad_errs = check_gradients(device)

    log("phase 7: stage-2 training")
    train_launches = check_training(device)

    by_path = {
        "attention_rotary": {"flagship": launches["attention_rotary"],
                             "training": train_launches["attention_rotary"]},
        "attention": {"flagship": launches["attention"],
                      "probe": verdict["attention"]["launches"]["attention"],
                      "training": train_launches["attention"]},
        "add": {"probe": verdict["tiny"]["launches"]["add"]},
    }
    for r in results:
        r["launches"] = sum(by_path[r["name"]].values())
        r["launches_by_path"] = by_path[r["name"]]
        if r["name"] in grad_errs:
            r["max_abs_err_backward"] = grad_errs[r["name"]]
    log(f"done in {time.perf_counter() - T0:.1f} s")
    print(json.dumps({"kernels": results}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
