#!/usr/bin/env python3
"""Check the PyTorch/CUDA port (gluefactory_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed with its elapsed seconds; any failure exits non-zero:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: the CUDA kernels (csrc/attention.cu and csrc/elementwise.cu, one
     nvcc call each) and the host libraries (csrc/lsd.cpp, csrc/lap.cpp,
     csrc/elsed.cpp, the host compiler), in parallel;
  3. kernels: K1 (rotary self-attention) and K2 (masked attention) against
     their plain PyTorch versions on the card, in float32, float16 and
     bfloat16, at the flagship and training shapes, ragged shapes and shapes
     that take the split-key plan; in float32 against float64 at the training
     shape (max and rms error no larger than the plain version's); then timed
     in float32 at the flagship (1x4x512x64 and 1x4x1024x64), training
     (32x4x512x64) and probe (8x4x1024x64) shapes beside the plain version,
     PyTorch's scaled_dot_product_attention and the card's bounds (3xTF32 on
     the tensor cores, f32 on the CUDA cores), with the plan
     (ops.attention.plan_attention) of each shape; and in bfloat16 at the
     stage-5 training (32x4x512x64) and benchmark (1x4x1024x64) shapes beside
     SDPA in bfloat16 and the bf16 bound (989 TFLOP/s, or bytes); and K2 at
     SuperGlue's HPatches shape (1x4x2048x64 f32, 331 of 2048 keys valid) and
     at GlueStick's (1x4x768x64 f32, 92 of 256 junction slots and 440 of 512
     keypoints valid), held to the plain version and timed beside it and SDPA;
  4. flagship: SuperPoint -> LightGlue -> ZNCC refiner -> LO-RANSAC with the
     committed lg_tpu_stage2 weights on the JAX gate's 6 pairs (480x360,
     rendered by the port's generate_eval_set); every LightGlue attention
     goes through the kernels (12 K1 and 12 K2 launches a pair), the plain
     path must agree, and the medians must pass the JAX gate's four bounds
     (flagship.GATE);
  5. probe: the kernel probe entry point (scripts/kernel_probe.py) in a
     subprocess started after phase 2, which runs beside phases 3-4, both
     workers executed and ok; K3 (elementwise add) held
     bit-exact against x + y, timed beside torch.add and an empty kernel;
  6. gradients: autograd through the kernels' Functions against autograd
     through the plain versions at the flagship shape, float32 and bfloat16;
  7. training: 5 steps of the stage-2 recipe at full width (batch 32,
     320x320, 512 keypoints, 6 layers) on the kernel path and on the plain
     path from the same weights, pool and seeds; losses, gradients,
     confidence targets and launches gated (see check_training);
  8. HPatches: famA (20 sequences) and famB (20 + 10 illumination
     sequences) rendered by the port, then the benchmark entry point
     (eval.hpatches.HPatchesPipeline) with the flagship at 1024 keypoints
     through the kernels; summaries held to the JAX package's on the same
     sets, pair latency, pairs per second and RANSAC sweep time printed;
  9. stage 5: the recipe superpoint+lightglue_stage5_r4 (recipes.stage5_conf,
     SuperPoint and LightGlue in bf16, from weights/lg5_init_spsoft): its
     benchmark overlay on famA's first 8 sequences held to the JAX package's
     bf16 numbers, then train.training cut to 2 epochs of 4 steps with an
     evaluation, a benchmark and a checkpoint at each epoch end, and a
     --restore (see check_stage5);
 10. pose: the relative-pose benchmark (eval.megadepth1500.MegaDepth1500Pipeline
     with recipes.pose_flagship_conf: 1600x1600 canvas, 1024 keypoints, 6 layers,
     the refiner, 5-point LO-RANSAC with 2048 hypotheses over 6 thresholds) on the
     20 pairs that the port renders (scripts/generate_pose_eval_set); 12 + 12 kernel
     launches a pair, summaries held to the JAX package's on the same set, pair 0's
     RANSAC on the card held to the CPU's; pair latency, sweep time, pairs per
     second and peak memory printed (see check_pose);
 11. SuperPoint training: the recipes superpoint_train_ondevice (stage 0, from the
     flax-style initialisation), superpoint_stage1_r3 (from weights/sp_tpu_stage0b)
     and superpoint_stage2_soft_r4 (soft labels, from the initialisation) at full
     resolution, every loss term and gradient on the card against the CPU; then
     train.training(stage 1) at batch 32 cut to 2 epochs of 4 steps with
     evaluations, checkpoint_best and a --restore, and stage 0 from scratch for 8
     steps (see check_sp_training);
 12. adaptive LightGlue (recipes.hpatches_adaptive_conf: depth 0.95, width 0.99) on
     the first 8 sequences of phase 8's sets: summaries (the mAA to the band of JAX's
     RANSAC seeds 0-2) and exit layers held to the JAX package's, K1/K2
     launched 2 (exit layer + 1) times a pair, host reads a pair counted (see
     check_adaptive);
 13. LightGlue stage 4 (recipes.stage4_conf) on the cached-feature engine at full
     width: the feature pool extracted on the card from weights/sp_tpu_stage0b
     (its first images held to the CPU's extraction, its cache file read back
     bit for bit), step 0 on the kernel path against the plain path, then
     train.training cut as phase 9 cuts stage 5, from weights/lg_tpu_stage2,
     with checkpoint_best and a --restore (see check_stage4);
 14. LightGlue stage 1 (recipes.lg_homography_conf) on the host homography
     dataset at full width (640x640 views, batch 32, 9 checkpointed layers, the
     lg photometrics, 8 loader processes): step 0 on the kernel path against the
     plain path, then 3 steps with the loader's wait, the step time and the
     device's idle share (see check_stage1);
 15. SIFT, SuperGlue and the nearest-neighbour matcher (see check_sift_superglue):
     (a) the port's SIFT on the card (a CUDA graph of its scale space) against
     the CPU on gate views; (b) the JAX gates for SIFT+SuperGlue
     (weights/sg_sift_stage1), SIFT+LightGlue (weights/lg_sift_stage2) and
     SuperPoint stage 0b + NN on their 6 pairs, kernel path against plain path;
     (c) SIFT+SuperGlue on the first 8 sequences of phase 8's famA and famB (2048
     slots, 9 layers, Sinkhorn 50, the RANSAC sweep) held to the JAX package's
     summaries (the mAA to the band of JAX's RANSAC seeds 0-2), 36 K2 launches
     and no K1 a pair, the time of SIFT, SuperGlue and Sinkhorn a pair; (d)
     SIFT+NN and SuperPoint+NN on famA's first 8 sequences against JAX's;
 16. SIFT-feature training (see check_sift_training): (a) the cached engine's SIFT
     pool (recipes.sift_sg_cached_conf: 768 + 64 images, 448x448, 512 slots,
     on_host) extracted on the card, against the CPU, its cache read back bit for
     bit; (b) SIFT+LightGlue stage 2 (from weights/lg_sift_stage1) and (c)
     SIFT+SuperGlue (9 layers, Sinkhorn 50, from the initialisation) at batch 32:
     step 0 on the kernel path against the plain path, train.training cut to 2
     epochs of 4 steps, a --restore, 12 + 12 and 36 + 0 launches a step, the
     Sinkhorn's share of a SuperGlue step; (d) sg_sift_stage1 and lg_sift_stage2
     validated on the port's val pool against the JAX package's on its own; (e)
     the JAX gates of lg_sift_stage1, lg_sift_stage2 out of distribution and
     SuperPoint stage 0 + NN, and the sift+lightglue model card (add_scale_ori);
 17. ETH3D and the rest of the filter slot (see check_eth3d): (a) the ETH3D set
     rendered by the port (6 scenes x 6 views, 1500 points), eval.eth3d.ETH3DPipeline
     with recipes.eth3d_flagship_conf and eth3d_sp_lg_stage2_conf over its 48 pairs at
     1024 keypoints on the 1024-pixel canvas, AP and mnum_matches held to the JAX
     package's on the same set, 12 + 12 launches a pair, kernel path against plain
     path and the time by stage on 8 pairs; (b) the refiner's static mode against
     its window mode on those pairs' matches, both timed; (c) SIFT+NN+AdaLAM
     (recipes.hpatches_sift_nn_adalam_conf) on famA's first 8 sequences against
     JAX's over seeds 0-4, AdaLAM on the card against the CPU on one pair; (d)
     SuperPoint exported by scripts/export_features over one scene, LightGlue with
     allow_no_extract from the cache against the full pipeline; (e) depth ground
     truth (gt_matches_from_pose_depth, depth_matcher, oracle_matcher) on the card
     against the CPU; (f) eval.timing_measurement of the flagship at batch 1 and 8.
 18. GlueStick stage 0 on the SuperPoint + LSD wireframe (chip_smoke_gluestick.py), 24 K2
     launches and no K1 a pair, held to the JAX package's summaries on the same sets: (a)
     HPatches famA and famB's first 8 sequences (phase 8's sets; famB's mAA to the band
     of JAX's RANSAC seeds 0-2), kernel against plain path, the time by stage; (b) HPatches-extended on famA's first 8 sequences; (c) ETH3D on phase 17's
     set; (d) MegaDepth-1500-extended on phase 10's set, its first pairs' 5-point
     LO-RANSAC on the card against the CPU on the same minimal sets in float64; (e) the
     port's host LSD on the gate views against OpenCV's segments.
 19. GlueStick training at full width (chip_smoke_gluestick.py): (a)
     recipes.gluestick_cached_conf: the cached-wireframe pool (640 + 64 images at
     448x448, 256 keypoints, 96 lines; SuperPoint on the card, LSD on the host)
     against the CPU and its cache, step 0 on the kernel path against the plain
     path (and with checkpointed layers: 48 K2 launches), train.training cut to 2 epochs
     of 4 steps with evaluations, the line losses, checkpoint_best and a --restore, 24 K2
     launches a step; (b)
     recipes.gluestick_stage1_conf from weights/gluestick_tpu_stage0 on its own pool:
     step 0 on the card against the CPU, the blob's validation loss below the
     initialisation's, 3 steps; (c) recipes.gluestick_train_homography_conf: 2 steps
     of 9 layers on the host dataset with the wireframe in the step (LSD on the host),
     36 K2 launches a step; K2 timed on a step's inputs of each beside SDPA.
 20. the line benchmarks at full width (chip_smoke_lines.py): the RDNIM (20
     pairs, day and night) and Wireframe (30 images) sets rendered by the port;
     (a) HPatches-lines on phase 8's famA (8 sequences) with LSD, LSD+LBD,
     ELSED, SOLD2+Wunsch (weights/sold2_tpu_stage0) and GlueStick stage 0 (24 K2
     launches a pair, kernel against plain path), (b) RDNIM-lines with LSD+LBD
     and SOLD2+Wunsch, (c) Wireframe with LSD and SOLD2, each held to the JAX
     package's summaries on the same sets (LINES_JAX; the line RANSAC's AUCs
     within the band of JAX's seeds 0-2); (d) ELSED and the exact assignment
     (LAP) built on this host against JAX's native libraries, SOLD2 and the
     Wunsch scores on the card against the CPU; (e) ms an item by stage, items
     a second, peak memory.
 21. JPLDD at full width (chip_smoke_jpldd.py; 16/32/64/128 channels, dim 128, 512
     keypoints, POLD2 on 250 of them, 480-pixel views): (a)
     weights/jpldd_tpu_structured_descB on the gate's 9 views, card against CPU (the
     CPU's side in a spawn process beside the rest); (b) HPatches-extended
     (jpldd_structured_descB) on famA's first 8 sequences and (c) HPatches-lines
     (jpldd_structured_descB_wunsch, jpldd_stage0_tuned) on them, held to the JAX
     package's summaries on the same set; (d) jpldd_ondevice_structured from the
     flax-style initialisation (step 0 card against CPU, 2 epochs of 4 steps with
     evaluations, a --restore), jpldd_desc_stage_structured from
     weights/jpldd_tpu_structured (3 steps, everything outside desc_head bit for
     bit), sold2_train_pairs (3 steps) and jpldd_train_synthetic (2 steps on the host
     dataset), the pools cut to 128 + 16 scenes; (e) ms a pair by stage, step times,
     peak memory.
 22. LoFTR at full width (chip_smoke_loftr.py; ResNet-FPN 128/196/256, 4 + 4 coarse
     and 1 + 1 fine linear-attention layers, the dual-softmax over every pair of
     coarse cells, 1024 slots, 5x5 fine windows): (a) weights/loftr_tpu_stage0b on
     the gate's 6 pairs, card against CPU (the coarse confidence, the slots as sets,
     the refined keypoints); (b) HPatches from the blob at 480 (loftr_stage0b and,
     with no extractor and the refiner, loftr_stage0b_refine on famA's first 8
     sequences; loftr_stage0b_famb on famB's) held to the JAX package's summaries on
     the same sets, ms a pair by stage; (c) loftr_ondevice from the flax-style
     initialisation (step 0 card against CPU, 2 epochs of 4 steps with evaluations,
     a --restore), loftr_finetune_fine from weights/loftr_tpu_stage0 (3 steps) and
     loftr_homography (2 steps on the host dataset), step times and peak memory; (d)
     no K1 or K2 launch on LoFTR's path.
 23. The SfM back-end and the trajectory benchmark at full width (chip_smoke_sfm.py; 4
     scenes x 8 views at 640x480): (a) one scene's BA, its chain links' RANSAC in
     float64 and a pose graph, card against CPU; (b) SIFT+LightGlue (two blobs) and
     GlueStick through run_sfm (1024 hypotheses, 40 BA iterations), the card's medians
     over its RANSAC seeds 0-2 held to the JAX package's band over seeds 0-9, timed by
     stage; (c) K1/K2 launches, kernel against plain path; (d) its time.
 24. ALIKED at full width from a seeded initialisation (chip_smoke_aliked.py; phase 3
     also holds K1/K2 at its 1x4x2048x64): (a) aliked-n16, aliked-n32 (2048 keypoints)
     and the official graph, card against CPU; (b) aliked+lightglue on famA's first 8
     sequences, 18 + 18 launches a pair, kernel against plain; (c) aliked+nn and
     aliked_official_compat, NN matches card against CPU; (d)
     aliked+lightglue_homography (batch 32, 640x640): step 0, 3 steps, a --restore.
Phase 9 also benchmarks its stage-5 run through the benchmark CLI's conf and
load_model, by the run's name and by its checkpoint_best.ckpt. The sets of
phases 8, 10, 17 and 23 are rendered on the host in the background from phase 4
on; each of those phases waits for its own.
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
H100_BF16_FLOPS = 989e12  # dense bf16 on the tensor cores (data sheet)
H100_BYTES_PER_S = 3.35e12  # HBM3
SEED = 20260417


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - T0:7.2f} s] {msg}", flush=True)


# --- phase 4: the flagship on the JAX gate's pairs ----------------------------

GATE_SEQS = 3  # tests/test_trained_quality.py:render_pairs: seeds (424242, s), views 2 and 4
GATE_FAMILY_SALT = {"a": 0, "b": 777}  # render_pairs' seed salt of each scene family


def gate_pairs(root: Path, device, family: str = "a"):
    """The JAX gate's 6 pairs of scene ``family``, rendered by the port:
    (image0, image1, H_0to1) with images (360, 480, 3) in [0, 1] on
    ``device``."""
    import numpy as np
    import torch

    from gluefactory_torch.scripts.generate_eval_set import render_sequence
    from gluefactory_torch.utils.image import read_image

    def load(path):
        return torch.from_numpy(read_image(path).astype(np.float32) / 255.0).to(device)

    pairs = []
    for s in range(GATE_SEQS):
        seq = root / f"v_q{family}{s}"
        render_sequence(seq, np.random.default_rng((424242 + GATE_FAMILY_SALT[family], s)),
                        (480, 360), family=family)
        for k in (2, 4):
            H = torch.from_numpy(np.loadtxt(seq / f"H_1_{k}").astype(np.float32)).to(device)
            pairs.append((load(seq / "1.ppm"), load(seq / f"{k}.ppm"), H))
    return pairs


def run_pair(model, estimator, img0, img1, H):
    """Predictions and the gate's readings (flagship.pair_quality) of one pair."""
    import torch

    from gluefactory_torch.flagship import pair_quality

    size = torch.tensor([[img0.shape[1], img0.shape[0]]], dtype=torch.float32,
                        device=img0.device)
    data = {"view0": {"image": img0[None], "image_size": size},
            "view1": {"image": img1[None], "image_size": size}}
    with torch.inference_mode():
        pred = model(data)
        quality = pair_quality(pred, H, size[0], estimator)
    return pred, quality


def check_flagship(device, root: Path):
    """The flagship on the JAX gate's 6 pairs through the kernels, against
    the plain path; the JAX gate's four bounds on the medians. Returns the
    attention launches of the kernel path."""
    import numpy as np
    import torch

    from gluefactory_torch.flagship import GATE, load_flagship, passes_gate
    from gluefactory_torch.ops import attention as A

    pairs = gate_pairs(root, device)
    model, estimator = load_flagship(device=device, attention="auto")
    plain_model, _ = load_flagship(device=device, attention="xla")
    log(f"  weights loaded (193 keys, strict), {len(pairs)} pairs rendered")
    run_pair(model, estimator, *pairs[0])  # warm-up: cuDNN and library handles
    run_pair(plain_model, estimator, *pairs[0])
    torch.cuda.synchronize()

    A.reset_launches()
    stats = {k: [] for k in GATE}
    ms, plain_ms, agree_all, per_pair = [], [], [], []
    for i, (img0, img1, H) in enumerate(pairs):
        before = dict(A.launches)
        t = time.perf_counter()
        pred, quality = run_pair(model, estimator, img0, img1, H)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
        per_pair.append({k: A.launches[k] - before[k] for k in A.launches})
        t = time.perf_counter()
        ppred, pquality = run_pair(plain_model, estimator, img0, img1, H)
        torch.cuda.synchronize()
        plain_ms.append((time.perf_counter() - t) * 1e3)

        m0, pm0 = pred["matches0"][0], ppred["matches0"][0]
        for key in ("keypoints0", "keypoint_valid0", "keypoint_valid1"):
            if not torch.equal(pred[key], ppred[key]):
                raise AssertionError(f"pair {i}: {key} differ between kernel and plain runs")
        unrefined = torch.ones_like(m0, dtype=torch.bool)
        unrefined[torch.cat([m0[m0 > -1], pm0[pm0 > -1]])] = False
        if not torch.equal(pred["keypoints1"][0][unrefined], ppred["keypoints1"][0][unrefined]):
            raise AssertionError(f"pair {i}: keypoints1 differ between kernel and plain runs")
        for key in ("keypoints1", "descriptors0", "log_assignment"):
            if not bool(torch.isfinite(pred[key].clamp_min(-1e30)).all()):
                raise AssertionError(f"pair {i}: non-finite {key}")
        agree = float((m0 == pm0).float().mean())
        agree_all.append(agree)
        for k in GATE:
            stats[k].append(quality[k])
        log(f"  pair {i}: {quality['matches']} matches, prec@1px {quality['prec1']:.3f}, "
            f"prec@3px {quality['prec3']:.3f}, corner error {quality['h_err']:.3f} px (plain "
            f"path {pquality['h_err']:.3f} px), matches0 agree {agree:.4f}, {ms[-1]:.1f} ms "
            f"(plain path {plain_ms[-1]:.1f} ms), launches {per_pair[-1]}")
    launches = dict(A.launches)

    for i, counts in enumerate(per_pair):
        if counts != {"attention_rotary": 12, "attention": 12}:
            raise AssertionError(f"pair {i}: kernel launches {counts}, expected 12 and 12")
    if min(agree_all) < 0.99:
        raise AssertionError(f"matches0 agree below 99%: {agree_all}")
    medians = {k: float(np.median(v)) for k, v in stats.items()}
    log(f"  medians {json.dumps(medians)} against the JAX gate {json.dumps(GATE)} "
        f"(matches, prec1, prec3 above; h_err below); median pair time {np.median(ms):.1f} ms "
        f"(plain path {np.median(plain_ms):.1f} ms), launches {launches}")
    if not passes_gate(stats):
        raise AssertionError(f"flagship quality gate: {stats}")
    return launches


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


def exact(args, rotary: bool):
    """The attention of ``args`` in float64, with the kernels' mask rules."""
    import torch

    from gluefactory_torch.ops import attention as A

    q, k, v = (x.double() for x in args[:3])
    mask = args[-1][:, None, None, :]
    if rotary:
        q = A.apply_rotary(q, args[3].double(), args[4].double())
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * q.shape[-1] ** -0.5
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.exp(s - s.amax(-1, keepdim=True)).masked_fill(~mask, 0.0)
    return torch.einsum("bhqk,bhkd->bhqd", p / p.sum(-1, keepdim=True), v)


def errors(out, ref) -> dict:
    """max, rms and mean of err * sign(ref) (negative: a bias toward 0)."""
    d = out.double() - ref
    return {"max": float(d.abs().max()), "rms": float(d.pow(2).mean().sqrt()),
            "bias": float((d * ref.sign()).mean())}


EXACT_SHAPE = (32, 4, 512, 512, 64)  # the training shape, float32
BF16_SHAPES = ((32, 4, 512, 64), (1, 4, 1024, 64))  # stage-5 training, the benchmark


SG_SLOTS = 2048  # SuperGlue on HPatches: SIFT's 2048 slots a view...
SG_FILLED = 331  # ...of which a famA view fills 331 (outputs/results/hpatches/sift_sg_stage1)


def time_masked_k2(q, k, v, mask, what: str, reps: int = 20) -> dict:
    """K2 on (q, k, v, mask) in float32: parity with the plain version
    (float32 tolerance), then timed beside it and SDPA with the same mask.
    The bound counts each item's valid keys (the kernel reads every key
    tile; the masked ones add no work to the function)."""
    import torch
    import torch.nn.functional as F

    from gluefactory_torch.ops import attention as A

    b, h, n, d = q.shape
    out, ref = A.attention_cuda(q, k, v, mask), A.attention_plain(q, k, v, mask)
    err = float((out - ref).abs().max())
    if err > TOLERANCES["float32"][0] or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"attention at {(b, h, n, n, d)} ({what}): max |err| {err:.3g}")
    ms = graph_ms(lambda: A.attention_cuda(q, k, v, mask), reps=reps)
    plain_ms = graph_ms(lambda: A.attention_plain(q, k, v, mask), reps=reps)
    library_ms = graph_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask[:, None, None, :]), reps=reps)
    valid = int(mask.sum())
    nbytes = (2 * q.numel() + 2 * h * valid * d) * 4 + mask.numel()
    t_tf32, t_f32, t_bytes = attention_bounds(1, h, n, valid, d, nbytes)
    plan = A.plan_attention(b, h, n, n, torch.cuda.get_device_properties(q.device)
                            .multi_processor_count)
    share = valid / mask.numel()
    log(f"  attention         f32 B,H,N,D={b},{h},{n},{d}, {share:.1%} of keys valid ({what}): "
        f"max |err| {err:.3g} ok; kernel {ms * 1e3:.1f} us, plain {plain_ms * 1e3:.1f} us, "
        f"SDPA with the mask {library_ms * 1e3:.1f} us ({library_ms / ms:.2f}x the kernel), "
        f"bound {max(t_tf32, t_bytes) * 1e3:.2f} us 3xTF32 over the valid keys "
        f"({max(t_tf32, t_bytes) / ms:.1%}) / {t_f32 * 1e3:.2f} us f32 CUDA cores; plan rows "
        f"{plan.rows}, {plan.splits} split(s) of {plan.tiles_per_split} tiles")
    return {"shape": [b, h, n, n, d], "valid_keys": valid, "valid_key_share": share,
            "path": what, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": max(t_tf32, t_bytes),
            "bound_by": "operations" if t_tf32 >= t_bytes else "bytes",
            "bound_ms_cuda_cores": t_f32, "plan": list(plan), "max_abs_err": err}


GS_SLOTS = 768  # GlueStick on HPatches: 256 junction slots and 512 keypoints a view,
GS_JUNCTIONS = 256
GS_FILLED = (92, 440)  # of which a famA view fills 92 and 440 (v_qa0/1.ppm, on the CPU)


def time_k2_shape(kern: dict, gen, device, n: int, valid: list, what: str) -> dict:
    """K2 at 1x4xNx64 in float32 with the key mask of a view whose slot
    ranges ``valid`` hold keypoints (time_masked_k2)."""
    import torch

    q, k, v, mask = _attention_inputs(1, 4, n, n, 64, torch.float32, False, gen, device)
    mask[:] = False
    for a, b in valid:
        mask[:, a:b] = True
    out = time_masked_k2(q, k, v, mask, what)
    kern["max_abs_err"] = max(kern["max_abs_err"], out["max_abs_err"])
    return out


def check_kernels(device):
    """Parity of both kernels with their plain versions; their float32 error
    against float64 at the training shape, no larger than the plain
    version's (max and rms); timings at the flagship (512 and 1024
    keypoints), training and probe shapes. Returns one JSON-ready dict per
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

    # float32 against float64 at the training shape, with no fully-masked item
    for name, kern in kernels.items():
        args = _attention_inputs(*EXACT_SHAPE, torch.float32, kern["rotary"], gen, device)
        args[-1][:] |= args[-1].sum(-1, keepdim=True) == 0
        ref = exact(args, kern["rotary"])
        kern["vs_float64"] = errors(kern["kernel"](*args), ref)
        kern["plain_vs_float64"] = errors(kern["plain"](*args), ref)
        k_err, p_err = kern["vs_float64"], kern["plain_vs_float64"]
        log(f"  {name:17s} f32 B,H,Nq,Nk,D={','.join(map(str, EXACT_SHAPE))} against float64: "
            f"kernel max {k_err['max']:.3g} rms {k_err['rms']:.3g} bias {k_err['bias']:.3g}; "
            f"plain max {p_err['max']:.3g} rms {p_err['rms']:.3g} bias {p_err['bias']:.3g}")
        if k_err["max"] > p_err["max"] or k_err["rms"] > p_err["rms"]:
            raise AssertionError(f"{name}: float32 error against float64 above the plain "
                                 f"version's: {k_err} against {p_err}")

    # timings in float32 with a key mask and no fully-masked item
    results = []
    for name, kern in kernels.items():
        times = []
        for b, h, n, d in ((1, 4, 512, 64), (1, 4, 1024, 64), (32, 4, 512, 64),
                           (8, 4, 1024, 64)):
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
        times_bf16 = []
        for b, h, n, d in BF16_SHAPES:
            args = _attention_inputs(b, h, n, n, d, torch.bfloat16, kern["rotary"], gen, device)
            q, k, v, mask = args[0], args[1], args[2], args[-1]
            mask[:] |= mask.sum(-1, keepdim=True) == 0
            q_lib = A.apply_rotary(q, args[3], args[4]) if kern["rotary"] else q
            reps = 20 if b == 1 else 5
            ms = graph_ms(lambda: kern["kernel"](*args), reps=reps)
            plain_ms = graph_ms(lambda: kern["plain"](*args), reps=reps)
            library_ms = graph_ms(lambda: F.scaled_dot_product_attention(
                q_lib, k, v, attn_mask=mask[:, None, None, :]), reps=reps)
            nbytes = sum(t.numel() * t.element_size() for t in args) + q.numel() * 2
            t_ops = 4 * b * h * n * n * d / H100_BF16_FLOPS * 1e3
            t_bytes = nbytes / H100_BYTES_PER_S * 1e3
            times_bf16.append({"shape": [b, h, n, n, d], "ms": ms, "plain_ms": plain_ms,
                               "library_ms": library_ms, "bound_ms": max(t_ops, t_bytes),
                               "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                               "bound_ms_operations": t_ops})
            log(f"  {name:17s} bf16 B,H,N,D={b},{h},{n},{d}: kernel {ms * 1e3:.1f} us, plain "
                f"{plain_ms * 1e3:.1f} us, SDPA bf16 {library_ms * 1e3:.1f} us "
                f"({library_ms / ms:.2f}x the kernel), bound {max(t_ops, t_bytes) * 1e3:.2f} us "
                f"({'operations' if t_ops >= t_bytes else 'bytes'}; {t_ops * 1e3:.2f} us of "
                f"operations at 989 TFLOP/s, {t_bytes * 1e3:.2f} us of {nbytes / 1e6:.2f} MB), "
                f"{max(t_ops, t_bytes) / ms:.1%} of it")
        if name == "attention":
            times.append(time_k2_shape(kern, gen, device, SG_SLOTS, [(0, SG_FILLED)],
                                       "SuperGlue on HPatches"))
            times.append(time_k2_shape(kern, gen, device, GS_SLOTS, [
                (0, GS_FILLED[0]), (GS_JUNCTIONS, GS_JUNCTIONS + GS_FILLED[1])],
                "GlueStick on HPatches"))
        main = times[1]  # 1x4x1024x64: the benchmark path's shape, most of the launches
        results.append({
            "name": name, "route": "cuda", "source": "gluefactory_torch/csrc/attention.cu",
            "replaces": kern["replaces"], "launches": 0,
            "max_abs_err": kern["max_abs_err"], "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"], "times_by_shape": times,
            "times_by_shape_bf16": times_bf16,
            "vs_float64": kern["vs_float64"], "plain_vs_float64": kern["plain_vs_float64"],
        })
    return results


# --- phase 5: the kernel probe entry point and K3 ------------------------------

PROBE_TIMEOUT = 300  # seconds for the whole probe (its workers have their own)
PROBE_OUT = "gluefactory_torch/_build/kernel_probe.json"


def start_probe() -> tuple:
    """Start the probe entry point in a subprocess: (the process, the file
    that takes its standard error)."""
    import tempfile

    root = Path(__file__).resolve().parent
    out_path = root / PROBE_OUT
    out_path.unlink(missing_ok=True)  # read only this run's verdict
    err = tempfile.TemporaryFile(mode="w+")
    proc = subprocess.Popen(
        [sys.executable, "-m", "gluefactory_torch.scripts.kernel_probe", "--out", str(out_path),
         "--timeout", "120"], stdout=subprocess.DEVNULL, stderr=err, text=True, cwd=root)
    return proc, err


def check_probe(device, probe: tuple):
    """Wait for the probe entry point (``start_probe``), hold K3 bit-exact
    against x + y, and time K3 at the probe's shape beside an empty kernel,
    the floor of any launch (K2 at the probe's 8x4x1024x64 is timed in phase
    3). Returns (K3's JSON-ready dict, the probe's verdict)."""
    import torch

    from gluefactory_torch.ops import elementwise as E

    out_path = Path(__file__).resolve().parent / PROBE_OUT
    proc, err = probe
    try:
        proc.wait(timeout=PROBE_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    err.seek(0)
    stderr = err.read()
    err.close()
    if not out_path.exists():
        raise AssertionError(f"kernel probe wrote no verdict (rc {proc.returncode}): "
                             f"{stderr[-2000:]}")
    verdict = json.loads(out_path.read_text())
    for which in ("tiny", "attention"):
        rec = verdict.get(which, {})
        log(f"  probe {which:9s}: {json.dumps(rec)[:300]}")
        if rec.get("status") != "EXECUTED" or not rec.get("ok"):
            raise AssertionError(f"kernel probe {which}: {rec} (rc {proc.returncode}, "
                                 f"stderr {stderr[-2000:]})")
    if proc.returncode != 0:
        raise AssertionError(f"kernel probe exited {proc.returncode}: {stderr[-2000:]}")
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
    floor_ms = graph_ms(lambda: E.launch_empty(device))
    log(f"  add f32 256x256: kernel {ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us, "
        f"torch.add {library_ms * 1e3:.2f} us, bound {max(t_bytes, t_ops) * 1e3:.3f} us "
        f"({nbytes / 1e3:.0f} KB); an empty kernel {floor_ms * 1e3:.2f} us (the launch floor)")

    k3 = {"name": "add", "route": "cuda", "source": "gluefactory_torch/csrc/elementwise.cu",
          "replaces": "gluefactory_tpu/scripts/pallas_probe.py:35", "launches": 0,
          "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
          "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops
          else "operations", "library_ms": library_ms, "launch_floor_ms": floor_ms}
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
TRAIN_GRAD_RTOL = 1e-2  # of each parameter's max |grad|, outside token_confidence.*
TRAIN_FLIP_SHARE = 1e-3  # of the confidence targets, that may differ from the plain path's
CONFIDENCE_HEADS = "token_confidence."


def step0(trainer, pool, seed: int):
    """A training step without the update: (loss, LightGlue gradients, the
    confidence targets that the loss reads (LightGlue.layer_confidence_targets,
    False on invalid keypoints), the number of targets on valid keypoints)."""
    model = trainer.model
    batch = trainer.batch(pool, seed)
    model.zero_grad(set_to_none=True)
    pred = model(batch)
    losses, _ = model.loss(pred, batch)
    loss = losses["total"].mean()
    loss.backward()
    grads = {n: p.grad.detach().clone() for n, p in model.matcher.named_parameters()}
    model.zero_grad(set_to_none=True)
    ctx = {**batch, **pred}
    targets = model.matcher.layer_confidence_targets(ctx, ctx)
    n_targets = (len(targets) // 2) * int(ctx["keypoint_valid0"].sum()
                                          + ctx["keypoint_valid1"].sum())
    return float(loss.detach()), grads, targets, n_targets


def against(ref, run) -> dict:
    """The step-0 gate's reading of ``run`` against the plain path's ``ref``.
    A confidence target is whether a layer's argmax is the final layer's; a
    near-tie flips it under any change in the last bits, and a flipped target
    changes only the gradients of the token_confidence heads (they read
    detached descriptors). So the heads are held by the share of targets that
    differ, every other parameter by its gradient."""
    errs = {n: float((run[1][n] - g).abs().max()) / max(float(g.abs().max()), 1e-30)
            for n, g in ref[1].items()}
    others = {n: e for n, e in errs.items() if not n.startswith(CONFIDENCE_HEADS)}
    heads = {n: e for n, e in errs.items() if n.startswith(CONFIDENCE_HEADS)}
    worst = max(others, key=others.get)
    flips = sum(int((a != b).sum()) for a, b in zip(ref[2], run[2]))
    share = flips / max(ref[3], 1)
    return {"loss_rel": abs(run[0] - ref[0]) / abs(ref[0]), "worst": errs[worst],
            "worst_param": worst, "median": float(sorted(others.values())[len(others) // 2]),
            "confidence_worst": max(heads.values()), "flips": flips, "targets": ref[3],
            "flip_share": share,
            "passes": errs[worst] <= TRAIN_GRAD_RTOL and share <= TRAIN_FLIP_SHARE}


def check_training(device):
    """The stage-2 recipe at its full widths (batch 32, 320x320, 512
    keypoints, 6 layers, 256-d, 4 heads) from the committed lg_tpu_stage2
    weights, 5 steps on the kernel path and on the plain path from the same
    pool and seeds. Returns the attention launches of the kernel path.

    Gates: at step 0 (``against``), losses within 1e-4 relative, LightGlue
    gradients outside the token_confidence heads within TRAIN_GRAD_RTOL of
    each parameter's largest gradient (the kernels differ from the plain path
    in the last bits), and at most TRAIN_FLIP_SHARE of the confidence targets
    flipped; losses after 5 steps within 1e-3 relative; every loss and
    gradient norm finite, no step skipped; 12 + 12 attention launches per
    step."""
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

    reading = against(step0(trainers["xla"], pool, seeds[0]),
                      step0(trainers["auto"], pool, seeds[0]))
    log(f"  step 0: loss differs by {reading['loss_rel']:.2g} relative; LightGlue gradients "
        f"outside {CONFIDENCE_HEADS}* differ by {reading['median']:.2g} (median), worst "
        f"{reading['worst']:.2g} in {reading['worst_param']} (of its max |grad|; gate "
        f"{TRAIN_GRAD_RTOL}); confidence targets flipped {reading['flips']} of "
        f"{reading['targets']} ({reading['flip_share']:.2g}; gate {TRAIN_FLIP_SHARE}); "
        f"{CONFIDENCE_HEADS}* gradients differ by up to {reading['confidence_worst']:.2g} "
        "(not gated)")
    if reading["loss_rel"] > 1e-4:
        raise AssertionError(f"step 0 losses differ by {reading['loss_rel']:.3g} relative")
    if not reading["passes"]:
        raise AssertionError(f"step 0 gate: {reading}")

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


# --- phase 8: the HPatches benchmark at 1024 keypoints ------------------------------

# The JAX package's summaries on the same sets (python -m gluefactory_tpu.eval.hpatches
# with the conf of outputs/results/hpatches/sp0b_lg2_com_refine/conf.yaml, on the
# CPU, RANSAC seed 0, sets from gluefactory_tpu.scripts.generate_eval_set: famA with
# its defaults, famB with --family b --illum_seqs 10; PERF.md, section 6)
HPATCHES_SETS = {
    "famA": {"family": "a", "num_seqs": 20, "illum_seqs": 0,
             "jax": {"H_error_ransac_mAA": 90.369, "mprec@1px": 0.523,
                     "mnum_keypoints": 892.2, "mnum_matches": 496.54}},
    "famB": {"family": "b", "num_seqs": 20, "illum_seqs": 10,
             "jax": {"H_error_ransac_mAA": 94.592, "mprec@1px": 0.825,
                     "mnum_keypoints": 1024.0, "mnum_matches": 617.333}},
}
# |port - JAX|: mAA points (the JAX mAA spreads by 0.05 / 0.12 over RANSAC seeds
# 0-2), precision, and relative keypoint and match counts
HPATCHES_TOLERANCES = {"H_error_ransac_mAA": 1.5, "mprec@1px": 0.02,
                       "mnum_keypoints": 0.01, "mnum_matches": 0.03}
RELATIVE = ("mnum_keypoints", "mnum_matches")
RENDER_WORKERS = 7


def render_sets(root: Path) -> float:
    """Render every set of HPATCHES_SETS at 640x480 under ``root`` in worker
    processes (numpy, no device); returns the seconds it took."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from gluefactory_torch.scripts.generate_eval_set import render_job, sequence_jobs

    t = time.perf_counter()
    context = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(RENDER_WORKERS, mp_context=context) as pool:
        futures = [pool.submit(render_job, root / name, (640, 480), spec["family"], job)
                   for name, spec in HPATCHES_SETS.items()
                   for job in sequence_jobs(spec["num_seqs"], 0, spec["family"],
                                            spec["illum_seqs"])]
        for future in futures:
            future.result()
    return time.perf_counter() - t


_RENDERS: dict = {}  # (renderer name, root) -> the future of a background render


def start_renders(jobs) -> None:
    """Start each (renderer, root) of ``jobs`` in one background thread, one
    after another (each renderer runs its own worker processes), so that the
    early phases' device work hides them; ``rendered`` then waits for one."""
    from concurrent.futures import ThreadPoolExecutor

    pool = ThreadPoolExecutor(1, thread_name_prefix="render")
    for fn, root in jobs:
        _RENDERS[(fn.__name__, Path(root))] = pool.submit(fn, Path(root))
    pool.shutdown(wait=False)


def rendered(fn, root: Path) -> tuple[float, float, str]:
    """(seconds ``fn(root)`` took, seconds the caller spent on it, how) : the
    background render's when ``start_renders`` began one, else rendered now."""
    t = time.perf_counter()
    future = _RENDERS.pop((fn.__name__, Path(root)), None)
    if future is None:
        seconds = fn(root)
        return seconds, seconds, "now"
    seconds = future.result()
    waited = time.perf_counter() - t
    return seconds, waited, f"in the background, waited {waited:.1f} s for it"


STAGE_PAIRS = 20  # famA pairs whose forward is timed stage by stage


def stage_calls_ms(model, stages: dict, dataset, device, n_pairs: int) -> dict:
    """{name: ms of each call} of each module of ``stages`` over the first
    ``n_pairs`` of ``dataset``: host clock around each call, synchronised at
    its entry and exit by forward hooks (which is why this is a separate pass
    from the benchmark's own timing; a nested module is timed inside its
    parent)."""
    import torch

    from gluefactory_torch.eval.eval_pipeline import to_model_input

    ms = {name: [] for name in stages}
    starts = []

    def enter(module, args):
        torch.cuda.synchronize(device)
        starts.append(time.perf_counter())

    def leave(name):
        def hook(module, args, out):
            torch.cuda.synchronize(device)
            ms[name].append((time.perf_counter() - starts.pop()) * 1e3)
        return hook

    handles = [h for name, m in stages.items() for h in (
        m.register_forward_pre_hook(enter), m.register_forward_hook(leave(name)))]
    try:
        for i, batch in enumerate(dataset.get_data_loader("test")):
            if i == n_pairs:
                break
            with torch.inference_mode():
                model(to_model_input(batch, device))
    finally:
        for handle in handles:
            handle.remove()
    return ms


def time_stages(model, dataset, device, n_pairs: int) -> dict:
    """Median ms a pair of the extractor (both views), the matcher and the
    refiner over the first ``n_pairs`` of ``dataset`` (stage_calls_ms)."""
    import numpy as np

    ms = stage_calls_ms(model, {"extractor": model.extractor, "matcher": model.matcher,
                                "refiner": model.filter}, dataset, device, n_pairs)
    extractor = np.add(ms["extractor"][0::2], ms["extractor"][1::2])  # two views a pair
    return {"extractor_ms": float(np.median(extractor)),
            "matcher_ms": float(np.median(ms["matcher"])),
            "refiner_ms": float(np.median(ms["refiner"]))}


def check_hpatches(device, root: Path):
    """``HPatchesPipeline`` (python -m gluefactory_torch.eval.hpatches) on famA
    and famB through the kernels: 12 + 12 launches a pair, and each summary
    within HPATCHES_TOLERANCES of the JAX package's on the same sets. Returns
    (the attention launches, what is printed per set)."""
    import numpy as np

    from gluefactory_torch.core.config import merge
    from gluefactory_torch.datasets.hpatches import HPatchesDataset
    from gluefactory_torch.eval.hpatches import HPatchesPipeline
    from gluefactory_torch.eval.io import load_model
    from gluefactory_torch.ops import attention as A
    from gluefactory_torch.recipes import hpatches_flagship_conf

    render_s, spent, where = rendered(render_sets, root)
    n_seqs = sum(s["num_seqs"] + s["illum_seqs"] for s in HPATCHES_SETS.values())
    log(f"  rendered {n_seqs} sequences of 640x480 in {render_s:.1f} s ({RENDER_WORKERS} "
        f"processes, {where})")
    conf = hpatches_flagship_conf()
    model = load_model(conf["model"], conf["checkpoint"], device)
    launches = {"attention_rotary": 0, "attention": 0}
    report = {"render_s": spent}
    failures = []
    for name, spec in HPATCHES_SETS.items():
        pipeline = HPatchesPipeline(merge(conf, {"data": {"data_dir": str(root / name)}}),
                                    device=device)
        n_pairs = len(pipeline.dataset)
        A.reset_launches()
        t = time.perf_counter()
        summaries, _ = pipeline.run(root / f"eval_{name}", model=model, overwrite=True)
        seconds = time.perf_counter() - t
        counts = dict(A.launches)
        if counts != {"attention_rotary": 12 * n_pairs, "attention": 12 * n_pairs}:
            raise AssertionError(f"{name}: kernel launches {counts} for {n_pairs} pairs, "
                                 "expected 12 and 12 a pair")
        for key in launches:
            launches[key] += counts[key]
        forward, sweep = pipeline.timings["forward_ms"], pipeline.timings["ransac_sweep_ms"]
        report[name] = {"pairs": n_pairs, "seconds": seconds, "pairs_per_s": n_pairs / seconds,
                        "median_forward_ms": float(np.median(forward)),
                        "median_ransac_sweep_ms": float(np.median(sweep)),
                        "summaries": summaries}
        log(f"  {name}: {n_pairs} pairs in {seconds:.1f} s ({n_pairs / seconds:.2f} pairs/s); "
            f"median pair latency {np.median(forward):.1f} ms (model forward and refiner), "
            f"median RANSAC sweep {np.median(sweep):.1f} ms a pair (6 thresholds x 1024 "
            f"hypotheses); launches {counts}")
        log(f"  {name} summaries: {json.dumps(summaries)}")
        for key, ref in spec["jax"].items():
            tol = HPATCHES_TOLERANCES[key] * (abs(ref) if key in RELATIVE else 1.0)
            diff = float(summaries[key]) - ref
            verdict = "ok" if abs(diff) <= tol else "FAILS"
            log(f"  {name} {key}: port {float(summaries[key]):.3f}, JAX {ref:.3f}, difference "
                f"{diff:+.3f} (tolerance {tol:.3f}) {verdict}")
            if verdict != "ok":
                failures.append(f"{name} {key}: {float(summaries[key])} against {ref}")
    if failures:
        raise AssertionError(f"HPatches against the JAX package: {failures}")
    report["stages"] = time_stages(model, HPatchesDataset({"data_dir": str(root / "famA")}),
                                   device, STAGE_PAIRS)
    log(f"  famA, first {STAGE_PAIRS} pairs, each stage synchronised: median "
        f"{report['stages']['extractor_ms']:.1f} ms SuperPoint (both views), "
        f"{report['stages']['matcher_ms']:.1f} ms LightGlue, "
        f"{report['stages']['refiner_ms']:.1f} ms refiner a pair")
    return launches, report


# --- phase 9: the stage-5 recipe in bf16 ------------------------------------------

# The JAX package's summaries of the stage-5 recipe's benchmark overlay (1024
# keypoints, the RANSAC sweep, no ground truth in the forward, SuperPoint and
# LightGlue in bf16) with weights/lg5_init_spsoft on famA's first 8 sequences (40
# pairs): python -m gluefactory_tpu.eval.hpatches on the CPU, RANSAC seed 0, on the
# set of gluefactory_torch.scripts.generate_eval_set --num_seqs 8 (PERF.md, section 6)
STAGE5_BENCH_JAX = {"H_error_ransac_mAA": 37.845, "mprec@1px": 0.136,
                    "mnum_keypoints": 1024.0, "mnum_matches": 502.9}
# |port - JAX|: mAA points (JAX's own mAA spans 36.671-37.845 over RANSAC seeds 0-2,
# and the port's RANSAC stream is another one), precision, and relative keypoint and
# match counts (as phase 8)
STAGE5_BENCH_TOLERANCES = {"H_error_ransac_mAA": 3.0, "mprec@1px": 0.02,
                           "mnum_keypoints": 0.01, "mnum_matches": 0.03}
# the recipe cut to a few steps: pool 768 -> 64 images, 250 -> 4 steps an epoch,
# 48 -> 2 epochs, an evaluation and a benchmark at each epoch end, every step logged
STAGE5_CUTS = {"data": {"pool_size": 64, "steps_per_epoch": 4},
               "train": {"epochs": 2, "eval_every_iter": 4, "benchmark_every_epoch": 1,
                         "log_every_iter": 1}}
# step 0, kernel path against the plain path in bf16: the plain path rounds the
# rotated q to bf16 where K1 keeps it in float32 (1.3e-4 to 1.2e-3 relative on the
# CPU at batch 2)
STAGE5_LOSS_RTOL = 1e-2
STAGE5_RESTORE_RTOL = 1e-6  # the first step after --restore against the same step


def stage5_bench(device, fam_dir: Path, out: Path, dtype: str) -> tuple[dict, float, int]:
    """The recipe's benchmark overlay with lg5_init_spsoft (strict) in ``dtype``
    on the first 8 sequences of ``fam_dir``: (summaries, seconds, pairs)."""
    from gluefactory_torch.core.config import merge
    from gluefactory_torch.eval.hpatches import HPatchesPipeline
    from gluefactory_torch.flagship import load_weights
    from gluefactory_torch.models import build_model
    from gluefactory_torch.recipes import STAGE5_WEIGHTS, stage5_conf

    conf = stage5_conf()
    bench = conf["train"]["run_benchmarks"][0]
    model_conf = merge(conf["model"], bench["model"])
    for comp in ("extractor", "matcher"):
        model_conf[comp]["dtype"] = dtype
    model = build_model(model_conf["name"], model_conf, device=device)
    load_weights(model, STAGE5_WEIGHTS)
    pipeline = HPatchesPipeline(merge(bench["conf"], {"data": {"data_dir": str(fam_dir)}}),
                                device=device)
    t = time.perf_counter()
    summaries, _ = pipeline.run(out, model=model, overwrite=True)
    return summaries, time.perf_counter() - t, len(pipeline.dataset)


class StepWatch:
    """Within ``with``: every Trainer.step calls ``before(trainer)`` first
    and records the attention launches it made."""

    def __init__(self, before=None):
        self.before, self.launches = before, []

    def __enter__(self):
        from gluefactory_torch import train
        from gluefactory_torch.ops import attention as A

        self.original = original = train.Trainer.step

        def step(trainer, seed):
            if self.before is not None:
                self.before(trainer)
            counts = dict(A.launches)
            out = original(trainer, seed)
            self.launches.append({k: A.launches[k] - counts[k] for k in counts})
            return out

        train.Trainer.step = step
        return self

    def __exit__(self, *exc):
        from gluefactory_torch import train

        train.Trainer.step = self.original


def check_restore(conf: dict, run: Path, resumed: Path, history: list, device, pool,
                  tag: str) -> dict:
    """``--restore`` of ``training(conf)`` from ``run``'s checkpoint_0_4 in a
    new folder: the parameters and the optimizer state bit for bit as saved,
    and the next step's loss as the first run's fifth (STAGE5_RESTORE_RTOL).
    Returns what is printed."""
    import argparse
    import shutil

    import numpy as np

    from gluefactory_torch.train import training
    from gluefactory_torch.utils.experiments import state_to_flat_dict
    from gluefactory_torch.utils.weights import decode_msgpack

    resumed.mkdir()
    shutil.copy(run / "checkpoint_0_4.ckpt", resumed)
    shutil.copy(run / "config.yaml", resumed)
    saved = decode_msgpack((run / "checkpoint_0_4.ckpt").read_bytes())["state"]
    compared = []

    def same_as_saved(trainer):
        if compared:
            return
        for part, obj in trainer.state().items():
            now = state_to_flat_dict(obj)
            if now.keys() != saved[part].keys():
                raise AssertionError(f"restored {part}: keys differ from the checkpoint's")
            for key, value in now.items():
                ref = saved[part][key]
                if value.dtype != ref.dtype or not np.array_equal(value, ref):
                    raise AssertionError(f"restored {part} {key} differs from the checkpoint")
            compared.append(len(now))

    with StepWatch(same_as_saved):
        _, again = training(conf, resumed, argparse.Namespace(restore=True), device=device,
                            pool=pool, steps=1)
    rel = abs(again[0]["loss/total"] - history[4]["loss/total"]) / abs(history[4]["loss/total"])
    log(f"  {tag} --restore from checkpoint_0_4: {compared[0]} parameters and {compared[1]} "
        f"optimizer arrays bit for bit; next step's loss {again[0]['loss/total']:.7f} against "
        f"{history[4]['loss/total']:.7f} in the first run ({rel:.2g} relative, tolerance "
        f"{STAGE5_RESTORE_RTOL})")
    if not rel <= STAGE5_RESTORE_RTOL:
        raise AssertionError(f"restored step: loss differs by {rel:.3g} relative")
    return {"parameters": compared[0], "optimizer_arrays": compared[1], "loss_rel": rel}


def check_stage5(device, fam_dir: Path, root: Path):
    """(a) The recipe's benchmark overlay in bf16 through the kernels on
    famA's first 8 sequences, held to the JAX package's summaries
    (STAGE5_BENCH_TOLERANCES); the float32 numbers printed beside. (b)
    ``training(stage5 recipe cut by STAGE5_CUTS)`` through the kernels in bf16:
    step 0 against the plain path, finite losses and no skipped step, 12 + 12
    launches a step, the train/val/bench keys of metrics.jsonl,
    checkpoint_best at the epoch of the highest bench mAA, at most 3 other
    checkpoints, then --restore from the first epoch's checkpoint: parameters
    and Adam state bit for bit, the next step's loss as the first run's.
    Returns (the attention launches of the training run, what is printed)."""
    import numpy as np
    import torch

    from gluefactory_torch.core.config import merge
    from gluefactory_torch.datasets import get_dataset
    from gluefactory_torch.datasets.homographies_ondevice import upload_pool
    from gluefactory_torch.ops import attention as A
    from gluefactory_torch.recipes import stage5_conf
    from gluefactory_torch.train import Trainer, training
    from gluefactory_torch.utils.weights import decode_msgpack

    report = {}
    A.reset_launches()
    summaries, seconds, n_pairs = stage5_bench(device, fam_dir, root / "bench_bf16", "bf16")
    counts = dict(A.launches)
    report["bench_bf16"] = {"seconds": seconds, "pairs": n_pairs, "summaries": summaries}
    log(f"  (a) bench overlay in bf16: {n_pairs} pairs in {seconds:.1f} s, launches {counts}; "
        f"{json.dumps(summaries)}")
    if counts != {"attention_rotary": 12 * n_pairs, "attention": 12 * n_pairs}:
        raise AssertionError(f"stage-5 bench: kernel launches {counts} for {n_pairs} pairs")
    f32, f32_seconds, _ = stage5_bench(device, fam_dir, root / "bench_f32", "float32")
    report["bench_f32"] = {"seconds": f32_seconds, "summaries": f32}
    failures = []
    for key, ref in STAGE5_BENCH_JAX.items():
        tol = STAGE5_BENCH_TOLERANCES[key] * (abs(ref) if key in RELATIVE else 1.0)
        diff = float(summaries[key]) - ref
        verdict = "ok" if abs(diff) <= tol else "FAILS"
        log(f"  (a) {key}: port bf16 {float(summaries[key]):.3f}, JAX bf16 {ref:.3f}, "
            f"difference {diff:+.3f} (tolerance {tol:.3f}) {verdict}; port float32 "
            f"{float(f32[key]):.3f} (reading, {f32_seconds:.1f} s)")
        if verdict != "ok":
            failures.append(f"{key}: {float(summaries[key])} against {ref}")
    if failures:
        raise AssertionError(f"stage-5 benchmark against the JAX package: {failures}")

    conf = merge(stage5_conf(), STAGE5_CUTS)
    conf["train"]["run_benchmarks"][0]["conf"]["data"]["data_dir"] = str(fam_dir)
    dataset = get_dataset(conf["data"]["name"])(conf["data"])
    t = time.perf_counter()
    pool = upload_pool(dataset.build_pool("train"), device)
    log(f"  (b) pool of {conf['data']['pool_size']} images on the card in "
        f"{time.perf_counter() - t:.1f} s")
    seed0 = next(iter(dataset.get_data_loader("train")))
    loss0 = {}
    for impl in ("auto", "xla"):
        impl_conf = merge(conf, {"model": {"matcher": {"attention": impl}}})
        loss0[impl] = step0(Trainer(impl_conf, device=device, pool=pool), pool, seed0)[0]
    rel0 = abs(loss0["auto"] - loss0["xla"]) / abs(loss0["xla"])
    log(f"  (b) step 0 in bf16: loss {loss0['auto']:.6f} on the kernel path, "
        f"{loss0['xla']:.6f} on the plain path, {rel0:.2g} relative (tolerance "
        f"{STAGE5_LOSS_RTOL})")
    if not rel0 <= STAGE5_LOSS_RTOL:
        raise AssertionError(f"stage-5 step 0: losses differ by {rel0:.3g} relative")
    torch.cuda.empty_cache()

    run = root / "stage5"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    A.reset_launches()
    t = time.perf_counter()
    with StepWatch() as watch:
        _, history = training(conf, run, device=device, pool=pool)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    launches = dict(A.launches)
    peak = torch.cuda.max_memory_allocated()
    bad = [(i, k) for i, h in enumerate(history) for k, v in h.items() if not np.isfinite(v)]
    if bad or any(h["skipped"] for h in history):
        raise AssertionError(f"stage-5 steps: non-finite {bad}, skipped "
                             f"{[h['skipped'] for h in history]}")
    n_steps = conf["train"]["epochs"] * conf["data"]["steps_per_epoch"]
    if watch.launches != [{"attention_rotary": 12, "attention": 12}] * n_steps:
        raise AssertionError(f"stage-5 kernel launches by step: {watch.launches}")
    records = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    keys = set().union(*records)
    need = {"loss/total", "grad_norm", "lr", "val/loss/total", "val/match_AP",
            "bench/hpatches/H_error_ransac_mAA", "bench/hpatches/mprec@1px",
            "bench/hpatches/mnum_keypoints"}
    if not need <= keys:
        raise AssertionError(f"metrics.jsonl lacks {sorted(need - keys)}")
    maa = [r["bench/hpatches/H_error_ransac_mAA"] for r in records
           if "bench/hpatches/H_error_ransac_mAA" in r]
    bench_s = [r["bench/hpatches/seconds"] for r in records if "bench/hpatches/seconds" in r]
    best = decode_msgpack((run / "checkpoint_best.ckpt").read_bytes())
    others = sorted(p.name for p in run.glob("checkpoint_*.ckpt") if "best" not in p.name)
    if best["epoch"] != int(np.argmax(maa)) or len(others) > 3:
        raise AssertionError(f"checkpoint_best of epoch {best['epoch']} for bench mAA {maa}; "
                             f"kept {others}")
    step_ms = [h["ms"] for h in history[1:]]
    report.update(steps=len(history), seconds=seconds, median_step_ms=float(np.median(step_ms)),
                  peak_gib=peak / 2**30, bench_maa=maa, bench_seconds=bench_s,
                  best_epoch=int(best["epoch"]), checkpoints=others)
    log(f"  (b) {len(history)} steps in {seconds:.1f} s (2 evaluations and 2 benchmarks "
        f"included): losses {[round(h['loss/total'], 4) for h in history]}; median step "
        f"{report['median_step_ms']:.1f} ms (steps 2-{len(history)}, host clock); peak memory "
        f"{report['peak_gib']:.2f} GiB; launches {launches}; bench mAA by epoch {maa} in "
        f"{[round(b, 1) for b in bench_s]} s; checkpoint_best epoch {best['epoch']}; kept "
        f"{others}")

    report["restore"] = check_restore(conf, run, root / "stage5_restored", history, device,
                                      pool, "(b)")
    report["by_name"] = bench_the_run(conf, run, fam_dir, maa[best["epoch"]], device)
    return launches, report


def bench_the_run(conf: dict, run: Path, fam_dir: Path, best_maa: float, device) -> dict:
    """(c) The stage-5 run benchmarked as its users do (eval.hpatches' parser,
    parse_eval_args, load_model): by its name under TRAINING_PATH and by its
    checkpoint_best.ckpt, the run's config.yaml under the conf of the
    recipe's benchmark overlay, on the same sequences; each mAA equal to the
    overlay's reading of checkpoint_best in training."""
    from gluefactory_torch.eval.hpatches import HPatchesPipeline
    from gluefactory_torch.eval.io import get_eval_parser, parse_eval_args
    from gluefactory_torch.recipes import hpatches_flagship_conf
    from gluefactory_torch.utils import experiments

    bench = conf["train"]["run_benchmarks"][0]
    named = {**bench["conf"], "model": {"name": "two_view_pipeline", **bench["model"]}}
    conf_file = run.parent / "stage5_bench.json"
    conf_file.write_text(json.dumps(named))
    experiments.TRAINING_PATH, training_path = run.parent, experiments.TRAINING_PATH
    out = {}
    try:
        for how, checkpoint in (("name", run.name),
                                ("ckpt", str(run / "checkpoint_best.ckpt"))):
            args = get_eval_parser().parse_intermixed_args(
                ["--conf", str(conf_file), "--checkpoint", checkpoint,
                 f"data.data_dir={fam_dir}"])
            bconf = parse_eval_args("hpatches", args, HPatchesPipeline.default_conf,
                                    hpatches_flagship_conf())
            t = time.perf_counter()
            summaries, _ = HPatchesPipeline(bconf, device=device).run(
                run.parent / f"bench_by_{how}", overwrite=True)
            out[how] = float(summaries["H_error_ransac_mAA"])
            log(f"  (c) --checkpoint {checkpoint} ({how}): mAA {out[how]:.3f} in "
                f"{time.perf_counter() - t:.1f} s; the overlay's reading of checkpoint_best "
                f"in training {best_maa:.3f}")
    finally:
        experiments.TRAINING_PATH = training_path
    if any(v != best_maa for v in out.values()):
        raise AssertionError(f"the run benchmarked by name and .ckpt: {out}, overlay {best_maa}")
    return out


# --- phase 10: the relative-pose benchmark at full width -----------------------------

POSE_SET = {"num_scenes": 10, "pairs_per_scene": 2, "seed": 31415}  # the renderer's defaults
# The JAX package's summaries on the same set (python -m gluefactory_tpu.eval.megadepth1500
# with the conf of outputs/results/megadepth1500/sp0b_lg2_com_refine_pose/conf.yaml, on
# the CPU, RANSAC seed 0, on the set of gluefactory_torch.scripts.generate_pose_eval_set
# with its defaults; PERF.md, section 6). Seeds 1 and 2 give mAA 97.508 and 97.437.
POSE_SET_JAX = {"rel_pose_error_mAA": 97.858, "mnum_matches": 349.3, "mepi_prec@1e-03": 0.734}
# |port - JAX|: mAA points (max(1.5, 3 x JAX's spread of 0.421 over RANSAC seeds 0-2)),
# relative match count, precision
POSE_TOLERANCES = {"rel_pose_error_mAA": 1.5, "mnum_matches": 0.03, "mepi_prec@1e-03": 0.02}
POSE_CPU_DEG = 0.05  # one pair's RANSAC on the card against the CPU, same minimal sets


def render_pose_set(root: Path) -> float:
    """Render POSE_SET under ``root`` in worker processes (numpy, no device);
    returns the seconds it took."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from gluefactory_torch.scripts.generate_pose_eval_set import render_scene_job, write_pairs

    t = time.perf_counter()
    context = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(RENDER_WORKERS, mp_context=context) as pool:
        jobs = [pool.submit(render_scene_job, root, POSE_SET["seed"], s,
                            POSE_SET["pairs_per_scene"]) for s in range(POSE_SET["num_scenes"])]
        write_pairs(root, [line for job in jobs for line in job.result()])
    return time.perf_counter() - t


def _angles(R, t, R_ref, t_ref) -> tuple[float, float]:
    """Degrees between two rotations and between two directions, in float64."""
    import numpy as np

    R, t, R_ref, t_ref = (np.asarray(x.double().cpu()) for x in (R, t, R_ref, t_ref))
    dr = np.degrees(2 * np.arcsin(min(1.0, np.linalg.norm(R - R_ref) / (2 * np.sqrt(2)))))
    t, t_ref = t / np.linalg.norm(t), t_ref / np.linalg.norm(t_ref)
    return float(dr), float(np.degrees(2 * np.arcsin(min(1.0, np.linalg.norm(t - t_ref) / 2))))


def pose_against_cpu(pipeline, pred_file: Path, th: float, device, n_pairs: int = 1,
                     dtypes: tuple = ("float64", "float32")) -> dict:
    """The first ``n_pairs`` pairs' RANSAC at ``th`` px on the card and on the
    CPU from the same minimal sets (``num_hypotheses`` of them), through the
    float32 estimator the benchmark runs (``RelativePoseEstimator``: the pixel
    threshold over the mean focal length, ``success``) and through
    ``ransac_essential`` in float64: for each of ``dtypes``, a pair's degrees
    between the card's rotation and the CPU's, and between their
    translations, for each pair."""
    import torch

    from gluefactory_torch.eval.eval_pipeline import unbatch
    from gluefactory_torch.eval.utils import get_matches_scores
    from gluefactory_torch.models.cache_loader import CacheLoader
    from gluefactory_torch.robust_estimators import load_estimator
    from gluefactory_torch.robust_estimators.homography.ransac import sample_minimal_sets
    from gluefactory_torch.robust_estimators.relative_pose.ransac import ransac_essential

    conf = {**pipeline.conf["eval"], "ransac_th": th}
    cache = CacheLoader({"path": str(pred_file)})
    out = {dtype: [] for dtype in dtypes}
    for pair, batch in zip(range(n_pairs), pipeline.get_dataloader()):
        data, pred = unbatch(batch), cache(batch)
        pts0, pts1, _, valid = get_matches_scores(pred["keypoints0"], pred["keypoints1"],
                                                  pred["matches0"], pred["matching_scores0"])
        valid = torch.from_numpy(valid)
        idx = sample_minimal_sets(valid, conf["num_hypotheses"],
                                  torch.Generator().manual_seed(0), 5)
        f_mean = float(torch.cat([data["camera0"].f, data["camera1"].f]).mean())
        for dtype in dtypes:
            poses = []
            for dev in (device, torch.device("cpu")):
                if dtype == "float64":
                    rays = [data[f"camera{i}"].to(dev, torch.float64).image2cam(
                        torch.from_numpy(p).to(dev, torch.float64)[None])[0]
                        for i, p in enumerate((pts0, pts1))]
                    _, R, t, _, _ = ransac_essential(
                        *rays, valid.to(dev), th=th / f_mean,
                        num_hypotheses=conf["num_hypotheses"], lo_iters=conf["lo_iters"],
                        sample_idx=idx.to(dev))
                else:
                    est = load_estimator("relative_pose", "ransac")(conf)({
                        "m_kpts0": torch.from_numpy(pts0).to(dev),
                        "m_kpts1": torch.from_numpy(pts1).to(dev),
                        "camera0": data["camera0"], "camera1": data["camera1"],
                        "valid": valid.to(dev), "sample_idx": idx.to(dev)})
                    if not est["success"]:
                        raise AssertionError(f"pose: pair {pair} at {th} px fails on {dev}")
                    R, t = est["M_0to1"].R, est["M_0to1"].t
                poses += [R, t]
            out[dtype].append(_angles(*poses))
    return out


def check_pose(device, root: Path):
    """``MegaDepth1500Pipeline`` (python -m gluefactory_torch.eval.megadepth1500)
    with ``recipes.pose_flagship_conf`` on the rendered set, through the
    kernels: 12 + 12 launches a pair, the summaries within POSE_TOLERANCES of
    the JAX package's on the same set, and pair 0's RANSAC on the card
    against the CPU. Returns (the attention launches, what is printed)."""
    import numpy as np
    import torch

    from gluefactory_torch.core.config import merge
    from gluefactory_torch.eval.io import load_model
    from gluefactory_torch.eval.megadepth1500 import MegaDepth1500Pipeline
    from gluefactory_torch.ops import attention as A
    from gluefactory_torch.recipes import pose_flagship_conf

    render_s, _, where = rendered(render_pose_set, root)
    conf = merge(pose_flagship_conf(), {"data": {"pairs": str(root / "pairs_calibrated.txt"),
                                                  "root": str(root / "images")}})
    pipeline = MegaDepth1500Pipeline(conf, device=device)
    n_pairs = len(pipeline.dataset)
    log(f"  rendered {n_pairs} pairs of 640x480 in {render_s:.1f} s ({RENDER_WORKERS} "
        f"processes, {where})")
    model = load_model(conf["model"], conf["checkpoint"], device)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    A.reset_launches()
    t = time.perf_counter()
    summaries, _ = pipeline.run(root / "eval", model=model, overwrite=True)
    seconds = time.perf_counter() - t
    counts = dict(A.launches)
    peak = torch.cuda.max_memory_allocated()
    forward, sweep = pipeline.timings["forward_ms"], pipeline.timings["ransac_sweep_ms"]
    report = {"render_s": render_s, "pairs": n_pairs, "seconds": seconds,
              "pairs_per_s": n_pairs / seconds, "median_forward_ms": float(np.median(forward)),
              "median_ransac_sweep_s": float(np.median(sweep)) / 1e3,
              "peak_gib": peak / 2**30, "launches": counts, "summaries": summaries}
    ev = pipeline.conf["eval"]
    log(f"  {n_pairs} pairs in {seconds:.1f} s ({n_pairs / seconds:.2f} pairs/s); median pair "
        f"latency {report['median_forward_ms']:.1f} ms (model forward and refiner at 1600x1600, "
        f"1024 keypoints); median RANSAC sweep {report['median_ransac_sweep_s']:.3f} s a pair "
        f"(6 thresholds x {ev['num_hypotheses']} hypotheses, 5-point, {ev['lo_iters']} LO "
        f"steps, 8 Gauss-Newton steps); peak memory {report['peak_gib']:.2f} GiB; launches "
        f"{counts}")
    log(f"  summaries: {json.dumps(summaries)}")
    if counts != {"attention_rotary": 12 * n_pairs, "attention": 12 * n_pairs}:
        raise AssertionError(f"pose: kernel launches {counts} for {n_pairs} pairs, expected "
                             "12 and 12 a pair")
    failures = []
    for key, ref in POSE_SET_JAX.items():
        tol = POSE_TOLERANCES[key] * (abs(ref) if key == "mnum_matches" else 1.0)
        diff = float(summaries[key]) - ref
        verdict = "ok" if abs(diff) <= tol else "FAILS"
        log(f"  {key}: port {float(summaries[key]):.3f}, JAX {ref:.3f}, difference {diff:+.3f} "
            f"(tolerance {tol:.3f}) {verdict}")
        if verdict != "ok":
            failures.append(f"{key}: {float(summaries[key])} against {ref}")
    th = float(summaries["best_ransac_th"])
    report["against_cpu"] = {k: v[0] for k, v in pose_against_cpu(
        pipeline, root / "eval" / "predictions.npz", th, device).items()}
    (r64, t64), (r32, t32) = report["against_cpu"]["float64"], report["against_cpu"]["float32"]
    log(f"  pair 0 at {th} px, card against CPU on the same minimal sets, rotation / "
        f"translation: the float32 estimator {r32:.2e} / {t32:.2e} deg, ransac_essential in "
        f"float64 {r64:.2e} / {t64:.2e} deg (tolerance {POSE_CPU_DEG} deg)")
    for name, (r, t) in report["against_cpu"].items():
        if not max(r, t) <= POSE_CPU_DEG:
            failures.append(f"pair 0 on the card against the CPU in {name}: {r}, {t} degrees")
    if failures:
        raise AssertionError(f"pose benchmark: {failures}")
    return counts, report


# --- phase 11: SuperPoint training ------------------------------------------------

SP_RECIPES = ("sp_stage0_conf", "sp_stage1_conf", "sp_soft_conf")
SP_POOL = 64  # the recipes' 768 procedural images cut to 64, as phases 7 and 9 cut theirs
SP_CHECK_BATCH = 4  # (a): one engine batch at full resolution, on the card and on the CPU
SP_LOSS_RTOL = 1e-3  # (a): each loss term of each pair, card against CPU
SP_GRAD_RTOL = 1e-2  # (a): each gradient, of its tensor's largest (phase 7's bound)
SP_SLOT_SHARE = 0.01  # (a): keypoint slots that may differ between card and CPU
SP_SLOT_PX = 1e-3  # (a): a slot differs when its validity does or it moves farther
# (b): the stage-1 recipe cut as phase 9 cuts stage 5: 250 -> 4 steps an epoch, 40 -> 2
# epochs, an evaluation (4 val batches of 32) every 4 steps, every step logged
SP_CUTS = {"data": {"pool_size": SP_POOL, "steps_per_epoch": 4},
           "train": {"epochs": 2, "eval_every_iter": 4, "log_every_iter": 1}}
SP_SCRATCH_STEPS = 8  # (c): stage 0 from scratch


def sp_step(model, batch):
    """(loss terms, gradients by parameter, keypoints and validity of both
    views) of one forward and backward of an extractor-only pipeline, on the
    host."""
    model.zero_grad(set_to_none=True)
    pred = model(batch)
    losses, _ = model.loss(pred, batch)
    losses["total"].mean().backward()
    grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters()
             if p.grad is not None}
    slots = {k: pred[k].detach().cpu() for k in ("keypoints0", "keypoints1", "keypoint_valid0",
                                                 "keypoint_valid1")}
    model.zero_grad(set_to_none=True)
    return {k: v.detach().cpu() for k, v in losses.items()}, grads, slots


def sp_card_against_cpu(trainer, batch) -> dict:
    """Phase 11(a) for one recipe: the same batch and parameters through the
    card and the CPU."""
    import copy

    import torch

    card = sp_step(trainer.model, batch)
    cpu_model = copy.deepcopy(trainer.model).cpu()
    cpu = sp_step(cpu_model, {k: (v.cpu() if torch.is_tensor(v) else
                                  {kk: vv.cpu() for kk, vv in v.items()})
                              for k, v in batch.items()})
    loss_rel = {k: float(((card[0][k] - cpu[0][k]).abs() / cpu[0][k].abs().clamp_min(1e-12)).max())
                for k in cpu[0]}
    grad_rel = {n: float((card[1][n] - g).abs().max()) / max(float(g.abs().max()), 1e-30)
                for n, g in cpu[1].items()}
    differ = total = 0
    for i in "01":
        valid_c, valid_h = card[2][f"keypoint_valid{i}"], cpu[2][f"keypoint_valid{i}"]
        moved = (card[2][f"keypoints{i}"] - cpu[2][f"keypoints{i}"]).abs().amax(-1) > SP_SLOT_PX
        differ += int(((valid_c != valid_h) | ((valid_c | valid_h) & moved)).sum())
        total += valid_h.numel()
    worst = max(grad_rel, key=grad_rel.get)
    return {"losses": {k: float(v.mean()) for k, v in cpu[0].items()}, "loss_rel": loss_rel,
            "worst_grad": grad_rel[worst], "worst_param": worst,
            "same_keys": card[1].keys() == cpu[1].keys() and card[0].keys() == cpu[0].keys(),
            "slots_differ": differ, "slots": total}


def check_sp_training(device, root: Path) -> dict:
    """(a) Each SuperPoint recipe (stage 0 and soft from the port's flax-style
    initialisation, stage 1 from sp_tpu_stage0b) on one engine batch of 4 at
    full resolution: every loss term and gradient on the card against the
    CPU, and the keypoint slots that differ. (b) ``training(sp_stage1_conf())``
    at batch 32 cut by SP_CUTS: finite, no step skipped, validation without
    match_AP, checkpoint_best by loss/total (min), a --restore bit for bit.
    (c) ``sp_stage0_conf()`` from scratch for SP_SCRATCH_STEPS steps at batch
    32, none skipped. Returns what is printed."""
    import numpy as np
    import torch

    from gluefactory_torch import recipes
    from gluefactory_torch.core.config import merge
    from gluefactory_torch.datasets import get_dataset
    from gluefactory_torch.datasets.homographies_ondevice import upload_pool
    from gluefactory_torch.train import Trainer, training
    from gluefactory_torch.utils.weights import decode_msgpack

    report = {}
    dataset = get_dataset("homographies_ondevice")(merge(recipes.sp_stage0_conf()["data"],
                                                         {"pool_size": SP_POOL}))
    t = time.perf_counter()
    pool = upload_pool(dataset.build_pool("train"), device)
    log(f"  pool of {SP_POOL} procedural images on the card in {time.perf_counter() - t:.1f} s")
    seed = next(iter(dataset.get_data_loader("train")))
    failures = []
    for name in SP_RECIPES:
        conf = merge(getattr(recipes, name)(), {"data": {"pool_size": SP_POOL,
                                                         "train_batch_size": SP_CHECK_BATCH}})
        trainer = Trainer(conf, device=device, pool=pool)
        batch = trainer.dataset.make_batch(pool, seed)
        t = time.perf_counter()
        r = sp_card_against_cpu(trainer, batch)
        report[name] = r
        worst_loss = max(r["loss_rel"], key=r["loss_rel"].get)
        start = "stage-0b blob" if conf["train"].get("load_experiment") else "flax-style init"
        size = conf["data"]["image_size"]
        log(f"  (a) {name} ({start}), batch {SP_CHECK_BATCH} at {size}x{size}, "
            f"card against CPU in {time.perf_counter() - t:.1f} s: losses "
            f"{json.dumps({k: round(v, 5) for k, v in r['losses'].items()})}; worst term "
            f"{worst_loss} {r['loss_rel'][worst_loss]:.2g} relative (tolerance {SP_LOSS_RTOL}); "
            f"worst gradient {r['worst_grad']:.2g} of its largest in {r['worst_param']} "
            f"(tolerance {SP_GRAD_RTOL}); keypoint slots that differ {r['slots_differ']} of "
            f"{r['slots']} (at most {SP_SLOT_SHARE:.0%})")
        if not r["same_keys"] or r["loss_rel"][worst_loss] > SP_LOSS_RTOL \
                or r["worst_grad"] > SP_GRAD_RTOL \
                or r["slots_differ"] > SP_SLOT_SHARE * r["slots"]:
            failures.append(name)
        del trainer
    if failures:
        raise AssertionError(f"SuperPoint training, card against CPU: {failures}")
    torch.cuda.empty_cache()

    conf = merge(recipes.sp_stage1_conf(), SP_CUTS)
    run = root / "sp_stage1"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    _, history = training(conf, run, device=device, pool=pool)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated()
    bad = [(i, k) for i, h in enumerate(history) for k, v in h.items() if not np.isfinite(v)]
    if bad or any(h["skipped"] for h in history):
        raise AssertionError(f"SuperPoint stage-1 steps: non-finite {bad}, skipped "
                             f"{[h['skipped'] for h in history]}")
    records = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    keys = set().union(*records)
    need = {"loss/total", "loss/desc_caps", "loss/desc_nll", "loss/kp_loc0", "grad_norm", "lr",
            "val/loss/total", "val/metric/kp_precision0", "val/metric/kp_recall0"}
    if not need <= keys or "val/match_AP" in keys:
        raise AssertionError(f"metrics.jsonl lacks {sorted(need - keys)} or has val/match_AP")
    val = [r for r in records if "val/loss/total" in r]
    best = decode_msgpack((run / "checkpoint_best.ckpt").read_bytes())
    others = sorted(p.name for p in run.glob("checkpoint_*.ckpt") if "best" not in p.name)
    if best["epoch"] != int(np.argmin([r["val/loss/total"] for r in val])) or len(others) > 3:
        raise AssertionError(f"checkpoint_best of epoch {best['epoch']} for val losses "
                             f"{[r['val/loss/total'] for r in val]}; kept {others}")
    terms = sorted(k for k in history[0] if k.startswith("loss/"))
    step_ms = [h["ms"] for h in history[1:]]
    report["stage1"] = {"steps": len(history), "seconds": seconds, "peak_gib": peak / 2**30,
                        "median_step_ms": float(np.median(step_ms)),
                        "first": {k: history[0][k] for k in terms},
                        "last": {k: history[-1][k] for k in terms},
                        "val": [{k: r[k] for k in r if k.startswith("val/metric/kp_")}
                                for r in val], "best_epoch": int(best["epoch"])}
    log(f"  (b) stage 1 at batch {conf['data']['train_batch_size']}: {len(history)} steps in "
        f"{seconds:.1f} s (2 evaluations of {conf['data']['val_steps']} val batches included); "
        f"median step {report['stage1']['median_step_ms']:.1f} ms (steps 2-{len(history)}, host "
        f"clock); peak memory {report['stage1']['peak_gib']:.2f} GiB")
    for which in ("first", "last"):
        rounded = {k: round(v, 5) for k, v in report["stage1"][which].items()}
        log(f"  (b) {which} losses {json.dumps(rounded)}")
    val_kp = [{k.split("/")[-1]: round(v, 4) for k, v in r.items()}
              for r in report["stage1"]["val"]]
    log(f"  (b) val kp precision / recall by evaluation: {val_kp}; checkpoint_best epoch "
        f"{best['epoch']}; kept {others}")
    report["stage1"]["restore"] = check_restore(conf, run, root / "sp_stage1_restored", history,
                                                device, pool, "(b)")
    torch.cuda.empty_cache()

    conf = merge(recipes.sp_stage0_conf(), {"data": {"pool_size": SP_POOL}})
    t = time.perf_counter()
    _, history = training(conf, root / "sp_stage0", device=device, pool=pool,
                          steps=SP_SCRATCH_STEPS)
    seconds = time.perf_counter() - t
    bad = [(i, k) for i, h in enumerate(history) for k, v in h.items() if not np.isfinite(v)]
    if bad or any(h["skipped"] for h in history) or len(history) != SP_SCRATCH_STEPS:
        raise AssertionError(f"SuperPoint stage 0 from scratch: non-finite {bad}, skipped "
                             f"{[h['skipped'] for h in history]}")
    report["stage0"] = {"losses": [h["loss/total"] for h in history], "seconds": seconds}
    log(f"  (c) stage 0 from scratch at batch {conf['data']['train_batch_size']}: "
        f"{SP_SCRATCH_STEPS} steps in {seconds:.1f} s, none skipped; losses "
        f"{[round(h['loss/total'], 4) for h in history]}; det_ce0 "
        f"{[round(h['loss/det_ce0'], 4) for h in history]}; desc_hinge "
        f"{[round(h['loss/desc_hinge'], 4) for h in history]}")
    return report


# --- phase 12: adaptive LightGlue on the HPatches sets -------------------------------------

# The JAX package's adaptive summaries, exit layers and pruned shares on the first
# ADAPTIVE_SEQS sequences of each of phase 8's sets (40 of their 100 and 150 pairs):
# JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_adaptive.py --sets
# famA=... famB=... --max_seqs 8 [--seed N], the conf of phase 8 with depth_confidence
# 0.95 and width_confidence 0.99 (recipes.hpatches_adaptive_conf), RANSAC seed 0, on the
# CPU; "maa_seeds": the mAA over JAX's seeds 0-2
ADAPTIVE_SEQS = 8
ADAPTIVE_JAX = {
    "famA": {"summaries": {"H_error_ransac_mAA": 89.036, "mprec@1px": 0.539,
                           "mnum_keypoints": 880.375, "mnum_matches": 483.425},
             "maa_seeds": [89.036, 88.717, 88.879],
             "exit_histogram": [0, 0, 0, 8, 30, 2], "mean_pruned_share": 0.1069},
    "famB": {"summaries": {"H_error_ransac_mAA": 97.085, "mprec@1px": 0.758,
                           "mnum_keypoints": 1024.0, "mnum_matches": 735.175},
             "maa_seeds": [97.085, 97.044, 96.896],
             "exit_histogram": [0, 0, 0, 0, 37, 3], "mean_pruned_share": 0.0151},
}
EXIT_SHARE = 0.05  # half the sum of |exit-layer count differences|, of the pairs
SYNC_PAIRS = 5  # pairs whose matcher runs under PyTorch's sync debug mode


class MatcherWatch:
    """Within ``with``: the exit layer, the prune counters and the validity
    masks of every LightGlue forward of ``model``, kept on the card until
    read."""

    def __init__(self, model):
        self.model, self.calls = model, []

    def __enter__(self):
        def hook(module, args, out):
            data = args[0]
            self.calls.append({k: v for k, v in {**data, **out}.items() if k in (
                "exit_layer", "prune0", "prune1", "keypoint_valid0", "keypoint_valid1")})

        self.handle = self.model.matcher.register_forward_hook(hook)
        return self

    def __exit__(self, *exc):
        self.handle.remove()

    def read(self, n_layers: int) -> tuple[list[int], list[float]]:
        """(exit layer, pruned share of the valid keypoints) of each call: a
        token never dropped counts 1 + (the non-final layers that ran) in
        ``prune*``."""
        exits, shares = [], []
        for call in self.calls:
            exit_layer = int(call["exit_layer"])
            counted = min(exit_layer + 1, n_layers - 1)
            dropped = valid = 0
            for i in "01":
                v = call[f"keypoint_valid{i}"]
                dropped += int(((call[f"prune{i}"] < 1 + counted) & v).sum())
                valid += int(v.sum())
            exits.append(exit_layer)
            shares.append(dropped / max(valid, 1))
        return exits, shares


def count_syncs(model, dataset, device, n_pairs: int) -> float:
    """Host reads a pair in the matcher: the synchronising calls that PyTorch's
    sync debug mode reports while LightGlue runs, over the first pairs."""
    import warnings

    import torch

    from gluefactory_torch.eval.eval_pipeline import to_model_input

    counts = []
    for i, batch in enumerate(dataset.get_data_loader("test")):
        if i == n_pairs:
            break
        with torch.inference_mode():
            data = to_model_input(batch, device)
            pred = model.extractor(data["view0"]), model.extractor(data["view1"])
            inputs = {**data, **{k + "0": v for k, v in pred[0].items()},
                      **{k + "1": v for k, v in pred[1].items()}}
            torch.cuda.synchronize(device)
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    model.matcher(inputs)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
        counts.append(sum("synchronizing" in str(w.message) for w in caught))
    return sum(counts) / len(counts)


def check_adaptive(device, root: Path, fixed: dict) -> tuple[dict, dict]:
    """``HPatchesPipeline`` with ``recipes.hpatches_adaptive_conf`` on the first
    ADAPTIVE_SEQS sequences of phase 8's famA and famB sets through the
    kernels: summaries within HPATCHES_TOLERANCES of the JAX package's adaptive
    numbers (the mAA of the band over its RANSAC seeds 0-2), the histogram of
    exit layers within EXIT_SHARE of the pairs of JAX's, and K1 and K2 each
    launched sum over pairs of 2 (exit layer + 1) times. ``fixed`` is phase
    8's report, printed beside. Returns (the attention launches, what is
    printed)."""
    import numpy as np

    from gluefactory_torch.core.config import merge
    from gluefactory_torch.datasets.hpatches import HPatchesDataset
    from gluefactory_torch.eval.hpatches import HPatchesPipeline
    from gluefactory_torch.eval.io import load_model
    from gluefactory_torch.ops import attention as A
    from gluefactory_torch.recipes import hpatches_adaptive_conf, hpatches_flagship_conf

    conf = hpatches_adaptive_conf()
    model = load_model(conf["model"], conf["checkpoint"], device)
    n_layers = model.matcher.conf["n_layers"]
    launches = {"attention_rotary": 0, "attention": 0}
    report, failures = {}, []
    for name, ref in ADAPTIVE_JAX.items():
        pipeline = HPatchesPipeline(merge(conf, {"data": {"data_dir": str(root / name),
                                                          "max_seqs": ADAPTIVE_SEQS}}),
                                    device=device)
        n_pairs = len(pipeline.dataset)
        A.reset_launches()
        t = time.perf_counter()
        with MatcherWatch(model) as watch:
            summaries, _ = pipeline.run(root / f"eval_adaptive_{name}", model=model,
                                        overwrite=True)
        seconds = time.perf_counter() - t
        counts = dict(A.launches)
        exits, shares = watch.read(n_layers)
        expected = sum(2 * (e + 1) for e in exits)
        hist = np.bincount(exits, minlength=n_layers).tolist()
        moved = 0.5 * sum(abs(a - b) for a, b in zip(hist, ref["exit_histogram"]))
        forward = float(np.median(pipeline.timings["forward_ms"]))
        report[name] = {"pairs": n_pairs, "seconds": seconds, "summaries": summaries,
                        "exit_histogram": hist, "mean_exit_layer": float(np.mean(exits)),
                        "mean_pruned_share": float(np.mean(shares)), "median_forward_ms": forward,
                        "launches": counts}
        log(f"  {name}: {n_pairs} pairs in {seconds:.1f} s; mean exit layer "
            f"{np.mean(exits):.3f}, exit layers {hist} (JAX {ref['exit_histogram']}: "
            f"{moved:g} pairs moved, at most {EXIT_SHARE * n_pairs:g}); mean pruned share "
            f"{np.mean(shares):.4f} (JAX {ref['mean_pruned_share']}); launches {counts} "
            f"(sum of 2 (exit + 1): {expected}); median pair latency {forward:.1f} ms "
            f"(phase 8, fixed depth: {fixed[name]['median_forward_ms']:.1f} ms)")
        log(f"  {name} summaries: {json.dumps(summaries)}")
        if counts != {"attention_rotary": expected, "attention": expected}:
            failures.append(f"{name} launches {counts}, expected {expected} each")
        if moved > EXIT_SHARE * n_pairs:
            failures.append(f"{name} exit layers {hist} against JAX's {ref['exit_histogram']}")
        for key, value in ref["summaries"].items():
            tol = HPATCHES_TOLERANCES[key] * (abs(value) if key in RELATIVE else 1.0)
            # the mAA beyond the band of JAX's RANSAC seeds 0-2, the rest beyond seed 0's
            band = ref["maa_seeds"] if key == "H_error_ransac_mAA" else [value]
            port = float(summaries[key])
            diff = port - min(band) if port < min(band) else max(port - max(band), 0.0)
            verdict = "ok" if abs(diff) <= tol else "FAILS"
            log(f"  {name} {key}: port {port:.3f}, JAX {value:.3f} ({min(band):.3f} to "
                f"{max(band):.3f} over its seeds 0-2), beyond it by {diff:+.3f} (tolerance "
                f"{tol:.3f}) {verdict}; fixed depth on the card, all of the set "
                f"{float(fixed[name]['summaries'][key]):.3f}")
            if verdict != "ok":
                failures.append(f"{name} {key}: {float(summaries[key])} against {value}")
        for key in launches:
            launches[key] += counts[key]
    if failures:
        raise AssertionError(f"adaptive HPatches against the JAX package: {failures}")
    famA = HPatchesDataset({"data_dir": str(root / "famA")})
    plain_conf = hpatches_flagship_conf()
    models = {"fixed": load_model(plain_conf["model"], plain_conf["checkpoint"], device),
              "adaptive": model}
    matcher_ms = {"fixed": [], "adaptive": []}
    for which in ("fixed", "adaptive", "adaptive", "fixed"):  # in turns, on one card
        stages = time_stages(models[which], famA, device, STAGE_PAIRS)
        matcher_ms[which].append(stages["matcher_ms"])
    report["matcher_ms"] = matcher_ms
    report["syncs_per_pair"] = count_syncs(model, famA, device, SYNC_PAIRS)
    report["fixed_syncs_per_pair"] = count_syncs(models["fixed"], famA, device, SYNC_PAIRS)
    added = report["syncs_per_pair"] - report["fixed_syncs_per_pair"]
    log(f"  famA, first {STAGE_PAIRS} pairs, LightGlue synchronised at entry and exit, fixed "
        f"depth and adaptive in turns: median {matcher_ms['fixed'][0]:.1f} / "
        f"{matcher_ms['fixed'][1]:.1f} ms a pair at fixed depth, "
        f"{matcher_ms['adaptive'][0]:.1f} / {matcher_ms['adaptive'][1]:.1f} ms adaptive "
        f"(phase 8: {fixed['stages']['matcher_ms']:.1f} ms); host reads in LightGlue "
        f"{report['syncs_per_pair']:g} a pair over {SYNC_PAIRS} pairs, "
        f"{report['fixed_syncs_per_pair']:g} at fixed depth: {added:g} added (at most "
        f"{n_layers - 1})")
    if added > n_layers - 1:
        raise AssertionError(f"adaptive LightGlue: {added} host reads a pair added")
    return launches, report


# --- main --------------------------------------------------------------------

# --- phase 13: LightGlue stage 4 on the cached-feature engine ---------------------------

# the recipe cut as phase 9 cuts stage 5: 250 -> 4 steps an epoch, 32 -> 2 epochs, an
# evaluation (its 4 val batches) at each epoch end; the pool is the recipe's 768 + 64
STAGE4_CUTS = {"data": {"steps_per_epoch": 4},
               "train": {"epochs": 2, "eval_every_iter": 4, "log_every_iter": 1}}
STAGE4_CPU_IMAGES = 16  # (a): pool images extracted on the CPU too
STAGE4_SLOT_PX = 1e-3  # (a): a keypoint on the card against the CPU
STAGE4_SLOT_SHARE = 1e-3  # (a): slots whose validity may differ
STAGE4_DESC_ATOL = 2e-3  # (a): float16 descriptors on the card against the CPU
ENGINE_SEEDS = 8  # (c): batches the engine makes alone, timed


def check_stage4(device, root: Path) -> tuple[dict, dict]:
    """(a) The cached-feature pool of ``recipes.stage4_conf`` (768 + 64 images,
    448x448, SuperPoint stage 0b with the CoM readout, 512 keypoints) extracted
    on the card, under a temporary DATA_PATH: its first STAGE4_CPU_IMAGES
    images against the same extraction on the CPU, its cache file read back
    bit for bit. (b) Step 0 (batch 32, 6 layers, float32) on the kernel path
    against the plain path from lg_tpu_stage2, phase 7's gate. (c)
    ``training`` cut by STAGE4_CUTS from the recipe's lg_tpu_stage2: finite,
    none skipped, 12 + 12 launches a step, checkpoint_best, a --restore bit
    for bit; the median step, the peak memory and the engine's share of a
    step. Returns (the attention launches of the training run, what is
    printed)."""
    from gluefactory_torch import settings

    report = {}
    data_path, settings.DATA_PATH = settings.DATA_PATH, root / "data"  # not the repository's
    try:
        return _check_stage4(device, root, report)
    finally:
        settings.DATA_PATH = data_path


def _check_stage4(device, root: Path, report: dict) -> tuple[dict, dict]:
    import numpy as np
    import torch

    from gluefactory_torch.core.config import merge
    from gluefactory_torch.datasets import get_dataset
    from gluefactory_torch.datasets.homographies_ondevice import (
        OnDeviceHomographyDataset,
        upload_pool,
    )
    from gluefactory_torch.recipes import stage4_conf
    from gluefactory_torch.train import Trainer

    conf = merge(stage4_conf(), STAGE4_CUTS)
    dataset = get_dataset(conf["data"]["name"])(conf["data"])
    drawn, draw = [], OnDeviceHomographyDataset.build_pool

    def timed_draw(self, *args, **kwargs):  # the source images, drawn on the host
        t0 = time.perf_counter()
        out = draw(self, *args, **kwargs)
        drawn.append(time.perf_counter() - t0)
        return out

    torch.cuda.synchronize()
    t = time.perf_counter()
    OnDeviceHomographyDataset.build_pool = timed_draw
    try:
        host = {split: dataset.build_pool(split, device) for split in ("train", "val")}
    finally:
        OnDeviceHomographyDataset.build_pool = draw
    torch.cuda.synchronize()
    report["extract_s"] = time.perf_counter() - t
    report["draw_s"] = sum(drawn)
    cache = {split: dataset.pool_cache_path(split) for split in host}
    log(f"  (a) pool of {conf['data']['pool_size']} + {conf['data']['val_pool_size']} images "
        f"in {report['extract_s']:.1f} s: {report['draw_s']:.1f} s drawing the source images "
        f"on the host, the rest extracting on the card and caching: "
        f"{int(host['train']['keypoint_valid'].sum())} keypoints in the train pool; cache "
        f"{[p.name for p in cache.values()]}")
    for split, path in cache.items():
        with np.load(path) as blob:
            again = {k: blob[k] for k in blob.files}
        if again.keys() != host[split].keys() or any(
                again[k].dtype != v.dtype or not np.array_equal(again[k], v)
                for k, v in host[split].items()):
            raise AssertionError(f"the {split} pool cache does not read back bit for bit")
    cpu_conf = merge(conf["data"], {"pool_size": STAGE4_CPU_IMAGES, "pool_cache": False})
    cpu_set = get_dataset(conf["data"]["name"])(cpu_conf)
    t = time.perf_counter()
    cpu = cpu_set.build_pool("train", "cpu")
    card = {k: v[:STAGE4_CPU_IMAGES] for k, v in host["train"].items() if k != "source_size"}
    both = card["keypoint_valid"] & cpu["keypoint_valid"]
    dist = np.abs(card["keypoints"] - cpu["keypoints"]).max(-1)
    same = both & (dist <= 0.5)  # the same detection in the same slot
    valid_share = float((card["keypoint_valid"] != cpu["keypoint_valid"]).mean())
    moved_share = 1 - same.sum() / max(both.sum(), 1)
    kp_err = float(dist[same].max())
    desc_err = float(np.abs(card["descriptors"][same].astype(np.float32)
                            - cpu["descriptors"][same].astype(np.float32)).max())
    report["card_vs_cpu"] = {"validity_share": valid_share, "moved_share": moved_share,
                             "kp_px": kp_err, "desc": desc_err}
    log(f"  (a) first {STAGE4_CPU_IMAGES} images on the CPU ({time.perf_counter() - t:.1f} s): "
        f"validity differs on {valid_share:.2g} of slots, {moved_share:.2g} of the slots valid "
        f"on both hold another detection, keypoints within {kp_err:.2g} px and descriptors "
        f"within {desc_err:.2g} on the rest (tolerances {STAGE4_SLOT_SHARE}, "
        f"{STAGE4_SLOT_SHARE}, {STAGE4_SLOT_PX}, {STAGE4_DESC_ATOL})")
    if not (valid_share <= STAGE4_SLOT_SHARE and moved_share <= STAGE4_SLOT_SHARE
            and kp_err <= STAGE4_SLOT_PX and desc_err <= STAGE4_DESC_ATOL):
        raise AssertionError(f"stage-4 pool on the card against the CPU: {report['card_vs_cpu']}")

    pool = upload_pool(host["train"], device)
    seed0 = next(iter(dataset.get_data_loader("train")))
    runs = {}
    for impl in ("xla", "auto"):
        impl_conf = merge(conf, {"model": {"matcher": {"attention": impl}}})
        runs[impl] = step0(Trainer(impl_conf, device=device, pool=pool), pool, seed0)
    reading = against(runs["xla"], runs["auto"])
    report["step0"] = {k: v for k, v in reading.items() if k != "passes"}
    log(f"  (b) step 0: loss {runs['auto'][0]:.6f} on the kernel path, {runs['xla'][0]:.6f} on "
        f"the plain path ({reading['loss_rel']:.2g} relative, tolerance 1e-4); gradients "
        f"outside {CONFIDENCE_HEADS}* within {reading['worst']:.2g} of their largest (gate "
        f"{TRAIN_GRAD_RTOL}; median {reading['median']:.2g}); confidence targets flipped "
        f"{reading['flips']} of {reading['targets']}")
    if reading["loss_rel"] > 1e-4 or not reading["passes"]:
        raise AssertionError(f"stage-4 step 0: {reading}")
    del runs
    torch.cuda.empty_cache()

    launches, report["training"] = train_cut(conf, root / "stage4", pool, device, "lightglue",
                                             "(c)")
    engine_ms = []
    for s in range(ENGINE_SEEDS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dataset.make_batch(pool, 1000 + s)
        torch.cuda.synchronize()
        engine_ms.append((time.perf_counter() - t0) * 1e3)
    report["engine_ms"] = float(np.median(engine_ms))
    step_ms = report["training"]["median_step_ms"]
    log(f"  (c) the engine {report['engine_ms']:.2f} ms a batch alone "
        f"({100 * report['engine_ms'] / step_ms:.1f}% of the median step; median of "
        f"{ENGINE_SEEDS} batches)")
    return launches, report


# --- phase 14: LightGlue stage 1 on the host homography dataset ---------------------------

STAGE1_STEPS = 3  # steps of the recipe at full width; the last two are profiled


def check_stage1(device, root: Path) -> tuple[dict, dict]:
    """``recipes.lg_homography_conf`` (synthetic 800x600 scenes warped onto
    640x640 views with the lg photometrics by 8 loader processes, batch 32,
    SuperPoint frozen from weights/sp_tpu_stage0b at 512 keypoints, 9-layer
    LightGlue from its initialisation with checkpointed layers): step 0 on the
    kernel path against the plain path on the loader's first batch (loss
    within 1e-4 relative); then STAGE1_STEPS steps of the Trainer on its
    loader, each step's wait for the loader and its host-clock time, K1/K2
    launches a step (the checkpointed layers run their forward again in the
    backward pass), and the device's busy and idle shares over the last
    steps from torch.profiler. Returns (the attention launches of the steps,
    what is printed)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gluefactory_torch.core.config import merge
    from gluefactory_torch.ops import attention as A
    from gluefactory_torch.recipes import SP_STAGE0B_WEIGHTS, lg_homography_conf
    from gluefactory_torch.train import Trainer, train_step

    report = {}
    conf = merge(lg_homography_conf(), {"train": {"load_experiment": str(SP_STAGE0B_WEIGHTS)}})
    trainers = {impl: Trainer(merge(conf, {"model": {"matcher": {"attention": impl}}}),
                              device=device) for impl in ("auto", "xla")}
    loader = iter(trainers["auto"].loader("train"))
    t = time.perf_counter()
    first = next(loader)
    report["first_batch_s"] = time.perf_counter() - t
    log(f"  first batch of {len(first['name'])} pairs from {conf['data']['num_workers']} loader "
        f"processes in {report['first_batch_s']:.2f} s (nothing to overlap yet)")
    loss0 = {impl: step0(trainer, None, first)[0] for impl, trainer in trainers.items()}
    rel0 = abs(loss0["auto"] - loss0["xla"]) / abs(loss0["xla"])
    report["step0_loss_rel"] = rel0
    log(f"  step 0: loss {loss0['auto']:.6f} on the kernel path, {loss0['xla']:.6f} on the "
        f"plain path ({rel0:.2g} relative, tolerance 1e-4)")
    if not rel0 <= 1e-4:
        raise AssertionError(f"stage-1 step 0: losses differ by {rel0:.3g} relative")
    trainer = trainers.pop("auto")
    del trainers
    torch.cuda.empty_cache()

    steps, per_step = [], []
    A.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    batch, wait = first, 0.0
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    window = 0.0
    for i in range(STAGE1_STEPS):
        if i == 1:
            prof.start()
            t_window = time.perf_counter()
        if i > 0:
            t = time.perf_counter()
            batch = next(loader)
            wait = (time.perf_counter() - t) * 1e3
        counts = dict(A.launches)
        t = time.perf_counter()
        scalars = train_step(trainer.model, trainer.optimizer, trainer.batch(None, batch))
        torch.cuda.synchronize()
        steps.append({**scalars, "data_ms": wait, "ms": (time.perf_counter() - t) * 1e3})
        per_step.append({k: A.launches[k] - counts[k] for k in counts})
    window = time.perf_counter() - t_window
    prof.stop()
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    launches = dict(A.launches)
    bad = [(i, k) for i, h in enumerate(steps) for k, v in h.items() if not np.isfinite(v)]
    if bad or any(h["skipped"] for h in steps):
        raise AssertionError(f"stage-1 steps: non-finite {bad}")
    n_layers = trainer.model.matcher.conf["n_layers"]
    expected = {"attention_rotary": 4 * n_layers, "attention": 4 * n_layers}
    if per_step != [expected] * STAGE1_STEPS:
        raise AssertionError(f"stage-1 kernel launches by step: {per_step}, expected {expected}")
    report.update(steps=steps, launches=launches, busy_s=busy, window_s=window,
                  idle_share=1 - busy / window,
                  peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    log(f"  {STAGE1_STEPS} steps: losses {[round(h['loss/total'], 4) for h in steps]}; step "
        f"{[round(h['ms'], 1) for h in steps]} ms, the wait for the loader before it "
        f"{[round(h['data_ms'], 1) for h in steps]} ms (host clock); steps 2-{STAGE1_STEPS}: "
        f"device busy {busy:.2f} s of {window:.2f} s, idle {100 * report['idle_share']:.1f}% "
        f"(torch.profiler); peak memory {report['peak_gib']:.2f} GiB; launches {per_step[0]} "
        f"a step ({n_layers} layers, 2 + 2 in each forward and again in its checkpointed "
        "recompute)")
    return launches, report


# --- phase 15: SIFT, SuperGlue and the nearest-neighbour matcher ------------------------

# (a) the port's SIFT on the card against the CPU on the gate's images (TF32 off):
SIFT_SLOT_SHARE = 1e-3  # slots whose validity may differ
SIFT_PX = 1e-3  # a card keypoint against the CPU's nearest (same orientation)
SIFT_SIZE_REL = 1e-5
SIFT_ANGLE_DEG = 1e-2
SIFT_MIN_DOT = 0.99  # RootSIFT descriptors of those keypoints: each, and the median
SIFT_MEDIAN_DOT = 0.9999
# (b) the JAX gates on their 6 pairs: the share of matches0 the kernel path and the
# plain path agree on (phase 4's), and the K1/K2 launches a pair of each gate
GATE_AGREE = 0.99
GATE_LAUNCHES = {"sift_superglue": {"attention_rotary": 0, "attention": 36},
                 "sift_lightglue": {"attention_rotary": 12, "attention": 12},
                 "superpoint_nn": {"attention_rotary": 0, "attention": 0},
                 "sift_lightglue_stage1": {"attention_rotary": 12, "attention": 12},
                 "sift_lightglue_ood": {"attention_rotary": 12, "attention": 12},
                 "superpoint_nn_stage0": {"attention_rotary": 0, "attention": 0}}
SIFT_GATES = ("sift_superglue", "sift_lightglue", "superpoint_nn")  # phase 15(b)
# (c), (d): the JAX package's summaries on phase 8's sets (RANSAC seed 0, on the CPU):
# JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_superglue.py --conf <folder of
# outputs/results/hpatches> --sets famA=... famB=... [--max_seqs 8]
SIFT_SG_JAX = {  # --conf sift_sg_stage1 --max_seqs 8
    "famA": {"H_error_ransac_mAA": 79.894, "mprec@1px": 0.565, "mnum_keypoints": 355.125,
             "mnum_matches": 229.6},
    "famB": {"H_error_ransac_mAA": 94.064, "mprec@1px": 0.639, "mnum_keypoints": 358.0,
             "mnum_matches": 217.625},
}
# (c) famA and famB at their first 8 sequences (40 of their 100 and 150 pairs; famB's
# are all illumination changes), for the script's time; the mAA is held within 1.5 of
# JAX's RANSAC seeds 0-2 on them (--seed N --reuse)
SIFT_SG_SEQS = {"famA": 8, "famB": 8}
SIFT_SG_MAA_SEEDS = {"famA": [79.894, 81.189, 80.532], "famB": [94.064, 93.814, 94.056]}
NN_SEQS = 8  # (d): famA's first 8 sequences, 40 pairs
# recipe -> (its folder of outputs/results/hpatches, JAX's summaries with RANSAC seed 0,
# JAX's mAA with seeds 0-4: --seed N --reuse)
NN_JAX = {
    "hpatches_sift_nn_conf": ("sift_nn", {"H_error_ransac_mAA": 71.828, "mprec@1px": 0.798,
                                          "mnum_keypoints": 271.375, "mnum_matches": 90.375},
                              [71.828, 69.321, 70.698, 70.935, 68.613]),
    "hpatches_sp_nn_conf": ("sp0b_nn_com", {"H_error_ransac_mAA": 43.685, "mprec@1px": 0.194,
                                            "mnum_keypoints": 880.375,
                                            "mnum_matches": 342.225},
                            [43.685, 37.354, 38.234, 39.092, 37.281]),
}
# |port - JAX|: mAA points, precision, and relative keypoint and match counts. In (d)
# the mAA of these weak pipelines on 40 pairs moves by several points with the RANSAC
# stream alone (JAX's own seeds), so there the port's mAA is held within 1.5 of the
# range of JAX's seeds 0-4 instead of seed 0's value
SIFT_TOLERANCES = {"H_error_ransac_mAA": 1.5, "mprec@1px": 0.02, "mnum_keypoints": 0.02,
                   "mnum_matches": 0.05}
SIFT_SG_LAUNCHES = 36  # K2 a pair: 9 layers x (2 self + 2 cross); no K1


def sift_card_against_cpu(device, pairs) -> dict:
    """The gate conf's SIFT (1024 keypoints, contrast 0.02) on the card (its
    CUDA graph) and on the CPU on both views of the gate's first and third
    pairs: validity, and for each of the CPU's keypoints the card's nearest
    one with the same orientation."""
    import torch

    from gluefactory_torch.models import build_model
    from gluefactory_torch.recipes import gate_conf

    conf = gate_conf("sift_superglue")[0]["extractor"]
    batch = torch.stack([view for pair in pairs[0:4:2] for view in pair[:2]])  # 4 views
    card = build_model("extractors.sift", conf, device=device)
    cpu = build_model("extractors.sift", conf, device="cpu")
    with torch.inference_mode():
        card({"image": batch})  # captures the graph of this shape
    torch.cuda.synchronize()
    t = time.perf_counter()
    with torch.inference_mode():
        ours = card({"image": batch})
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t
    t = time.perf_counter()
    with torch.inference_mode():
        ref = cpu({"image": batch.cpu()})
    cpu_s = time.perf_counter() - t
    ours = {k: v.cpu() for k, v in ours.items()}
    slots = int((ours["keypoint_valid"] != ref["keypoint_valid"]).sum())
    worst = {"px": 0.0, "size": 0.0, "deg": 0.0}
    dots = []
    for i in range(batch.shape[0]):
        vr, vo = ref["keypoint_valid"][i], ours["keypoint_valid"][i]
        pr, po = ref["keypoints"][i][vr], ours["keypoints"][i][vo]
        ar, ao = torch.rad2deg(ref["oris"][i][vr]), torch.rad2deg(ours["oris"][i][vo])
        dist = torch.cdist(pr.double(), po.double())
        dang = ((ar[:, None] - ao[None] + 180) % 360 - 180).abs()
        j = (dist + 1e-3 * dang).argmin(1)
        rows = torch.arange(len(j))
        worst["px"] = max(worst["px"], float(dist[rows, j].max()))
        worst["deg"] = max(worst["deg"], float(dang[rows, j].max()))
        size = (ours["scales"][i][vo][j] / ref["scales"][i][vr] - 1).abs()
        worst["size"] = max(worst["size"], float(size.max()))
        dots.append((ours["descriptors"][i][vo][j] * ref["descriptors"][i][vr]).sum(-1))
    dots = torch.cat(dots)
    out = {"images": batch.shape[0], "slots": batch.shape[0] * conf["max_num_keypoints"],
           "valid_differ": slots, "keypoints": int(ref["keypoint_valid"].sum()),
           **{f"max_{k}": v for k, v in worst.items()},
           "min_dot": float(dots.min()), "median_dot": float(dots.median()),
           "descriptors_equal": float((dots >= 1 - 1e-6).double().mean()),
           "card_s": card_s, "cpu_s": cpu_s}
    log(f"  (a) SIFT on {out['images']} views of 480x360 (1024 slots, contrast 0.02): card "
        f"{card_s * 1e3:.1f} ms, CPU {cpu_s * 1e3:.1f} ms; {out['keypoints']} keypoints on the "
        f"CPU; validity differs on {slots} of {out['slots']} slots (at most "
        f"{SIFT_SLOT_SHARE:g}); worst keypoint {worst['px']:.3g} px (at most {SIFT_PX:g}), "
        f"size {worst['size']:.3g} relative ({SIFT_SIZE_REL:g}), orientation "
        f"{worst['deg']:.3g} deg ({SIFT_ANGLE_DEG:g}); RootSIFT dot products min "
        f"{out['min_dot']:.6f} ({SIFT_MIN_DOT}), median {out['median_dot']:.6f} "
        f"({SIFT_MEDIAN_DOT}), {out['descriptors_equal']:.4f} of them 1")
    if (slots > SIFT_SLOT_SHARE * out["slots"] or worst["px"] > SIFT_PX
            or worst["size"] > SIFT_SIZE_REL or worst["deg"] > SIFT_ANGLE_DEG
            or out["min_dot"] < SIFT_MIN_DOT or out["median_dot"] < SIFT_MEDIAN_DOT):
        raise AssertionError(f"SIFT on the card against the CPU: {out}")
    return out


def check_sift_gates(device, pairs: dict, names, tag: str = "(b)") -> dict:
    """The JAX gates ``names`` (keys of recipes.GATE_BOUNDS) on their 6 pairs
    (``pairs`` by scene family, recipes.GATE_FAMILY): each pipeline from its
    blob through the kernels and through the plain versions, the medians
    within the gate's bounds, matches0 agreeing on GATE_AGREE of the slots
    and the launches of GATE_LAUNCHES a pair. Returns the launches."""
    import numpy as np
    import torch

    from gluefactory_torch.flagship import RANSAC_CONF
    from gluefactory_torch.models import build_model
    from gluefactory_torch.ops import attention as A
    from gluefactory_torch.recipes import GATE_BOUNDS, GATE_FAMILY, gate_conf
    from gluefactory_torch.robust_estimators import load_estimator
    from gluefactory_torch.utils.weights import load_blob_into

    estimator = load_estimator("homography", "ransac")(RANSAC_CONF)
    launches = {"attention_rotary": 0, "attention": 0}
    for name in names:
        bounds, family_pairs = GATE_BOUNDS[name], pairs[GATE_FAMILY[name]]
        models = []
        for impl in ("auto", "xla"):
            conf, blob = gate_conf(name)
            conf["matcher"]["attention"] = impl
            model = build_model("two_view_pipeline", conf, device=device)
            load_blob_into(model, blob, {"matcher": 4})
            models.append(model)
        run_pair(models[0], estimator, *family_pairs[0])  # warm-up
        torch.cuda.synchronize()
        stats = {k: [] for k in ("matches", "prec1", "prec3", "h_err")}
        agree, ms = [], []
        for i, (img0, img1, H) in enumerate(family_pairs):
            A.reset_launches()
            t = time.perf_counter()
            pred, quality = run_pair(models[0], estimator, img0, img1, H)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
            counts = dict(A.launches)
            if counts != GATE_LAUNCHES[name]:
                raise AssertionError(f"{name} pair {i}: launches {counts}, expected "
                                     f"{GATE_LAUNCHES[name]}")
            for key in launches:
                launches[key] += counts[key]
            ppred, _ = run_pair(models[1], estimator, img0, img1, H)
            for key in ("keypoints0", "keypoint_valid1", "descriptors1"):
                if not torch.equal(pred[key], ppred[key]):
                    raise AssertionError(f"{name} pair {i}: {key} differ between the paths")
            agree.append(float((pred["matches0"] == ppred["matches0"]).float().mean()))
            for k in stats:
                stats[k].append(quality[k])
        med = {k: float(np.median(v)) for k, v in stats.items()}
        ok = all(med[k] > v if k != "h_err" else med[k] < v for k, v in bounds.items())
        log(f"  {tag} {name} (family {GATE_FAMILY[name]}): medians {json.dumps({k: round(v, 4) for k, v in med.items()})} "
            f"against the JAX gate {json.dumps(bounds)} (h_err below, the rest above): "
            f"{'passes' if ok else 'FAILS'}; matches0 kernel vs plain agree min "
            f"{min(agree):.4f}; median pair {np.median(ms):.1f} ms; launches a pair "
            f"{GATE_LAUNCHES[name]}")
        if not ok or min(agree) < GATE_AGREE:
            raise AssertionError(f"{name}: {stats}, agreement {agree}")
    return launches


def time_sift_sg(model, dataset, device, n_pairs: int) -> dict:
    """Median ms a pair of SIFT (both views), SuperGlue and, inside it, the
    Sinkhorn assignment, over the first ``n_pairs`` of ``dataset``: host
    clock, each stage synchronised at entry and exit."""
    import numpy as np
    import torch

    from gluefactory_torch.eval.eval_pipeline import to_model_input
    from gluefactory_torch.models.matchers import superglue as SG

    ms = {"extractor": [], "matcher": [], "sinkhorn": []}

    def timed(name, fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize(device)
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize(device)
            ms[name].append((time.perf_counter() - t) * 1e3)
            return out
        return run

    transport = SG.log_optimal_transport
    forwards = {m: m.forward for m in (model.extractor, model.matcher)}
    SG.log_optimal_transport = timed("sinkhorn", transport)
    model.extractor.forward = timed("extractor", forwards[model.extractor])
    model.matcher.forward = timed("matcher", forwards[model.matcher])
    try:
        for i, batch in enumerate(dataset.get_data_loader("test")):
            if i == n_pairs:
                break
            with torch.inference_mode():
                model(to_model_input(batch, device))
    finally:
        SG.log_optimal_transport = transport
        for m in forwards:
            del m.forward
    extractor = np.add(ms["extractor"][0::2], ms["extractor"][1::2])
    return {"sift_ms": float(np.median(extractor)), "superglue_ms": float(np.median(ms["matcher"])),
            "sinkhorn_ms": float(np.median(ms["sinkhorn"]))}


def hold(name: str, summaries: dict, ref: dict, failures: list, maa_seeds=None) -> None:
    """Log each summary against the JAX package's; record those outside
    SIFT_TOLERANCES (the mAA against the range of ``maa_seeds`` where given)."""
    for key, value in ref.items():
        tol = SIFT_TOLERANCES[key] * (abs(value) if key in RELATIVE else 1.0)
        port = float(summaries[key])
        if key == "H_error_ransac_mAA" and maa_seeds:
            lo, hi = min(maa_seeds), max(maa_seeds)
            ok = lo - tol <= port <= hi + tol
            log(f"  {name} {key}: port {port:.3f}, JAX {lo:.3f} to {hi:.3f} over RANSAC seeds "
                f"0-{len(maa_seeds) - 1} (tolerance {tol:.3f} beyond) {'ok' if ok else 'FAILS'}")
        else:
            ok = abs(port - value) <= tol
            log(f"  {name} {key}: port {port:.3f}, JAX {value:.3f}, difference "
                f"{port - value:+.3f} (tolerance {tol:.3f}) {'ok' if ok else 'FAILS'}")
        if not ok:
            failures.append(f"{name} {key}: {port} against {value}")


def check_sift_hpatches(device, root: Path) -> tuple[dict, dict]:
    """(c) ``HPatchesPipeline`` with ``recipes.hpatches_sift_superglue_conf``
    (2048 slots, 9 layers, Sinkhorn 50, the RANSAC sweep) on the first
    SIFT_SG_SEQS sequences of phase 8's famA and famB, and (d) SIFT+NN and SP0b+NN on famA's first NN_SEQS sequences, each
    held to the JAX package's summaries; SIFT_SG_LAUNCHES K2 launches a pair
    and no K1. Returns (the launches of (c), what is printed)."""
    import numpy as np

    from gluefactory_torch import recipes
    from gluefactory_torch.core.config import merge
    from gluefactory_torch.datasets.hpatches import HPatchesDataset
    from gluefactory_torch.eval.hpatches import HPatchesPipeline
    from gluefactory_torch.eval.io import load_model
    from gluefactory_torch.ops import attention as A

    conf = recipes.hpatches_sift_superglue_conf()
    model = load_model(conf["model"], conf["checkpoint"], device)
    launches = {"attention_rotary": 0, "attention": 0}
    report, failures = {}, []
    for name, ref in SIFT_SG_JAX.items():
        data = {"data_dir": str(root / name), "max_seqs": SIFT_SG_SEQS.get(name)}
        pipeline = HPatchesPipeline(merge(conf, {"data": data}), device=device)
        n_pairs = len(pipeline.dataset)
        A.reset_launches()
        t = time.perf_counter()
        summaries, _ = pipeline.run(root / f"eval_sift_sg_{name}", model=model, overwrite=True)
        seconds = time.perf_counter() - t
        counts = dict(A.launches)
        if counts != {"attention_rotary": 0, "attention": SIFT_SG_LAUNCHES * n_pairs}:
            raise AssertionError(f"{name}: launches {counts} for {n_pairs} pairs, expected "
                                 f"{SIFT_SG_LAUNCHES} K2 and no K1 a pair")
        for key in launches:
            launches[key] += counts[key]
        forward = float(np.median(pipeline.timings["forward_ms"]))
        sweep = float(np.median(pipeline.timings["ransac_sweep_ms"]))
        report[name] = {"pairs": n_pairs, "seconds": seconds, "pairs_per_s": n_pairs / seconds,
                        "median_forward_ms": forward, "median_ransac_sweep_ms": sweep,
                        "summaries": summaries}
        log(f"  (c) {name}: {n_pairs} pairs in {seconds:.1f} s ({n_pairs / seconds:.2f} "
            f"pairs/s); median pair latency {forward:.1f} ms (SIFT on both views and "
            f"SuperGlue), median RANSAC sweep {sweep:.1f} ms a pair; launches {counts}")
        log(f"  {name} summaries: {json.dumps(summaries)}")
        hold(name, summaries, ref, failures, SIFT_SG_MAA_SEEDS.get(name))
    report["stages"] = time_sift_sg(model, HPatchesDataset({"data_dir": str(root / "famA")}),
                                    device, STAGE_PAIRS)
    s = report["stages"]
    log(f"  (c) famA, first {STAGE_PAIRS} pairs, each stage synchronised: median "
        f"{s['sift_ms']:.1f} ms SIFT (both views), {s['superglue_ms']:.1f} ms SuperGlue, of "
        f"which {s['sinkhorn_ms']:.1f} ms Sinkhorn (50 iterations on 2049x2049)")
    for recipe, (folder, ref, maa_seeds) in NN_JAX.items():
        nn_conf = getattr(recipes, recipe)()
        pipeline = HPatchesPipeline(merge(nn_conf, {"data": {"data_dir": str(root / "famA"),
                                                             "max_seqs": NN_SEQS}}),
                                    device=device)
        nn_model = load_model(nn_conf["model"], nn_conf["checkpoint"], device)
        t = time.perf_counter()
        summaries, _ = pipeline.run(root / f"eval_{folder}", model=nn_model, overwrite=True)
        seconds = time.perf_counter() - t
        report[folder] = {"pairs": len(pipeline.dataset), "seconds": seconds,
                          "median_forward_ms": float(np.median(pipeline.timings["forward_ms"])),
                          "summaries": summaries}
        log(f"  (d) {folder} on famA's first {NN_SEQS} sequences: {len(pipeline.dataset)} pairs "
            f"in {seconds:.1f} s, median pair latency "
            f"{report[folder]['median_forward_ms']:.1f} ms")
        hold(folder, summaries, ref, failures, maa_seeds)
    if failures:
        raise AssertionError(f"SIFT benchmarks against the JAX package: {failures}")
    return launches, report


def check_sift_superglue(device, root: Path) -> tuple[dict, dict]:
    """Phase 15: (a) SIFT on the card against the CPU, (b) the three JAX gates,
    (c) SIFT+SuperGlue on HPatches, (d) SIFT+NN and SP0b+NN. ``root`` holds
    phase 8's sets. Returns ({path: attention launches}, what is printed)."""
    pairs = gate_pairs(root / "gate15", device)
    report = {"sift": sift_card_against_cpu(device, pairs)}
    gates = check_sift_gates(device, {"a": pairs}, SIFT_GATES)
    hpatches, report["hpatches"] = check_sift_hpatches(device, root)
    return {"gates": gates, "sift_superglue": hpatches}, report


# --- phase 16: SIFT-feature training -------------------------------------------------

# the three cached SIFT recipes cut as phase 13 cuts stage 4: 250 -> 4 steps an epoch,
# 32 -> 2 epochs, an evaluation (its 4 val batches of 32) at each epoch end; the pool is
# the recipes' 768 + 64 images at 448x448, 512 slots
SIFT_TRAIN_CUTS = {"data": {"steps_per_epoch": 4},
                   "train": {"epochs": 2, "eval_every_iter": 4, "log_every_iter": 1}}
SIFT_POOL_CPU_IMAGES = 4  # (a): pool images extracted on the CPU too
SIFT_POOL_SLOT_SHARE = 1e-3  # (a): slots whose validity may differ
SIFT_POOL_PX = 1e-3  # (a): each CPU keypoint against the card's at its position
SIFT_POOL_MIN_DOT = 0.999  # (a): their RootSIFT descriptors (float16), each
STEP_LAUNCHES = {"lightglue": {"attention_rotary": 12, "attention": 12},
                 "superglue": {"attention_rotary": 0, "attention": 36},
                 # 6 layers x 4 in the forward; the backward recomputes in PyTorch
                 "gluestick": {"attention_rotary": 0, "attention": 24}}
SG_LOSS_RTOL = 1e-4  # (c) step 0, kernel path against plain path
SG_GRAD_RTOL = 1e-2  # (c): each gradient, of its tensor's largest
# (c): the key biases' gradients vanish (a bias on the keys adds one constant to a
# query's logits, which the softmax removes): both paths' are rounding, held below this
# share of the largest gradient of any parameter
SG_KEY_BIAS_SHARE = 1e-6
SINKHORN_REPS = 5  # (c): Sinkhorn's forward and backward timed alone on a step's inputs
# (d) the JAX package's validation of the trained blobs on its own val pools (the
# trainer's do_evaluation, 4 batches of 32), data seeds 0, 1, 2, on the CPU:
# JAX_PLATFORMS=cpu PYTHONPATH=.:tests python tests/test_torch_sift_train.py --side jax
SIFT_VAL_JAX = {
    "superglue": {"loss/total": (0.30623293155804276, 0.356059126497712, 0.3076176628819667),
                  "metric/match_recall": (0.9013815494254231, 0.8684506707359105,
                                          0.8916087301913649),
                  "metric/match_precision": (0.9544521011412144, 0.9438077034428716,
                                             0.9495823695324361)},
    "lightglue": {"loss/total": (0.8415708229877055, 0.96330854925327, 0.9484152961522341),
                  "metric/match_recall": (0.9394082520157099, 0.9366203914396465,
                                          0.9490801836363971),
                  "metric/match_precision": (0.9860873203724623, 0.9832410882227123,
                                             0.980944786220789)},
}
# How far beyond JAX's range the port may read: 1.5 times the farthest the port's own
# values fell outside it on the CPU over data seeds 0-2 (--side port: SuperGlue's loss
# 0.042 below, recall 0.021 and precision 0.005 above; LightGlue's within 0.004). The
# offset is the pools': each package's model on the other's val pool reads the other's
# numbers (--side cross), and the port's procedural scenes give SIFT 4% fewer keypoints
# an image.
SIFT_VAL_MARGIN = {"loss/total": 0.065, "metric/match_recall": 0.035,
                   "metric/match_precision": 0.01}


def sift_pool_card_against_cpu(conf: dict, host: dict) -> dict:
    """(a) The first SIFT_POOL_CPU_IMAGES images of the card's train pool
    against the same images extracted on the CPU: validity, and each CPU
    keypoint against the card's at its position with the nearest orientation
    (slots of keypoints that tie in response may be ordered either way)."""
    import numpy as np

    from gluefactory_torch.core.config import merge
    from gluefactory_torch.datasets import get_dataset

    cpu_conf = merge(conf, {"pool_size": SIFT_POOL_CPU_IMAGES, "pool_cache": False})
    t = time.perf_counter()
    cpu = get_dataset(conf["name"])(cpu_conf).build_pool("train", "cpu")
    seconds = time.perf_counter() - t
    card = {k: v[:SIFT_POOL_CPU_IMAGES] for k, v in host.items() if k != "source_size"}
    share = float((card["keypoint_valid"] != cpu["keypoint_valid"]).mean())
    worst_px, dots = 0.0, []
    for b in range(SIFT_POOL_CPU_IMAGES):
        vc, vg = cpu["keypoint_valid"][b], card["keypoint_valid"][b]
        dist = np.linalg.norm(cpu["keypoints"][b][vc][:, None] - card["keypoints"][b][vg][None],
                              axis=-1)
        dang = np.abs((np.rad2deg(cpu["oris"][b][vc][:, None] - card["oris"][b][vg][None])
                       + 180) % 360 - 180)
        j = (dist + 1e-3 * dang).argmin(1)
        worst_px = max(worst_px, float(dist[np.arange(len(j)), j].max()))
        dots.append((cpu["descriptors"][b][vc].astype(np.float32)
                     * card["descriptors"][b][vg][j].astype(np.float32)).sum(-1))
    dots = np.concatenate(dots)
    out = {"cpu_s": seconds, "validity_share": share, "keypoints": int(len(dots)),
           "max_px": worst_px, "min_dot": float(dots.min())}
    log(f"  (a) first {SIFT_POOL_CPU_IMAGES} images on the CPU ({seconds:.1f} s): validity "
        f"differs on {share:.2g} of slots (at most {SIFT_POOL_SLOT_SHARE}); {len(dots)} "
        f"keypoints within {worst_px:.3g} px of the card's (at most {SIFT_POOL_PX}); RootSIFT "
        f"dot products min {out['min_dot']:.6f} (at least {SIFT_POOL_MIN_DOT})")
    if not (share <= SIFT_POOL_SLOT_SHARE and worst_px <= SIFT_POOL_PX
            and out["min_dot"] >= SIFT_POOL_MIN_DOT):
        raise AssertionError(f"SIFT pool on the card against the CPU: {out}")
    return out


def sg_step0(trainer, pool, seed: int):
    """A SuperGlue training step without the update: (loss, gradients)."""
    model = trainer.model
    batch = trainer.batch(pool, seed)
    model.zero_grad(set_to_none=True)
    losses, _ = model.loss(model(batch), batch)
    loss = losses["total"].mean()
    loss.backward()
    grads = {n: p.grad.detach().clone() for n, p in model.matcher.named_parameters()}
    model.zero_grad(set_to_none=True)
    return float(loss.detach()), grads


def sg_against(ref, run) -> dict:
    """Step 0 on the kernel path (``run``) against the plain path (``ref``):
    the loss, each gradient against its tensor's largest, the key biases'
    against the largest gradient of any parameter (SG_KEY_BIAS_SHARE)."""
    largest = max(float(g.abs().max()) for g in ref[1].values())
    errs, key_bias = {}, 0.0
    for name, g in ref[1].items():
        if name.endswith(".k.bias"):
            key_bias = max(key_bias, float(g.abs().max()), float(run[1][name].abs().max()))
            continue
        errs[name] = float((run[1][name] - g).abs().max()) / max(float(g.abs().max()), 1e-30)
    worst = max(errs, key=errs.get)
    return {"loss_rel": abs(run[0] - ref[0]) / abs(ref[0]), "worst": errs[worst],
            "worst_param": worst, "median": float(sorted(errs.values())[len(errs) // 2]),
            "key_bias_share": key_bias / largest,
            "passes": (abs(run[0] - ref[0]) <= SG_LOSS_RTOL * abs(ref[0])
                       and errs[worst] <= SG_GRAD_RTOL and key_bias <= SG_KEY_BIAS_SHARE * largest)}


def train_cut(conf: dict, run: Path, pool, device, matcher: str, tag: str) -> tuple[dict, dict]:
    """``training(conf)`` through the kernels: finite, none skipped, the
    launches of STEP_LAUNCHES[matcher] a step, checkpoint_best, a
    --restore bit for bit; the median step and the peak memory. Returns
    (the training run's attention launches, what is printed)."""
    import numpy as np
    import torch

    from gluefactory_torch.ops import attention as A
    from gluefactory_torch.train import training
    from gluefactory_torch.utils.weights import decode_msgpack

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    A.reset_launches()
    t = time.perf_counter()
    with StepWatch() as watch:
        trainer, history = training(conf, run, device=device, pool=pool)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    launches, peak = dict(A.launches), torch.cuda.max_memory_allocated()
    bad = [(i, k) for i, h in enumerate(history) for k, v in h.items() if not np.isfinite(v)]
    if bad or any(h["skipped"] for h in history):
        raise AssertionError(f"{tag} steps: non-finite {bad}, skipped "
                             f"{[h['skipped'] for h in history]}")
    n_steps = conf["train"]["epochs"] * conf["data"]["steps_per_epoch"]
    if watch.launches != [STEP_LAUNCHES[matcher]] * n_steps:
        raise AssertionError(f"{tag} kernel launches by step: {watch.launches}")
    best = decode_msgpack((run / "checkpoint_best.ckpt").read_bytes())
    step_ms = float(np.median([h["ms"] for h in history[1:]]))
    report = {"steps": len(history), "seconds": seconds, "median_step_ms": step_ms,
              "peak_gib": peak / 2**30, "best_epoch": int(best["epoch"]), "launches": launches,
              "recall": history[-1]["metric/match_recall"]}
    log(f"  {tag} {len(history)} steps in {seconds:.1f} s (evaluations included): losses "
        f"{[round(h['loss/total'], 4) for h in history]}; median step {step_ms:.1f} ms "
        f"(steps 2-{len(history)}, host clock); peak memory {report['peak_gib']:.2f} GiB; "
        f"launches {launches} ({STEP_LAUNCHES[matcher]} a step); checkpoint_best epoch "
        f"{best['epoch']} by {conf['train']['best_key']}")
    report["restore"] = check_restore(conf, run, run.with_name(run.name + "_restored"), history,
                                      device, pool, tag)
    return launches, report


def time_sinkhorn(captured: dict) -> dict:
    """Sinkhorn (50 iterations) alone on the inputs of a training step, forward
    and forward+backward, each synchronised, median of SINKHORN_REPS."""
    import numpy as np
    import torch

    from gluefactory_torch.ops.assignment import log_optimal_transport

    sim, bins, kwargs = captured["args"]
    grad = torch.randn(sim.shape[0], sim.shape[1] + 1, sim.shape[2] + 1, device=sim.device,
                       generator=torch.Generator(sim.device).manual_seed(0))
    ms = {"forward": [], "forward_backward": []}
    for rep in range(SINKHORN_REPS + 1):
        for kind in ms:
            s = sim.detach().requires_grad_(kind != "forward")
            b = bins.detach().requires_grad_(kind != "forward")
            torch.cuda.synchronize()
            t = time.perf_counter()
            with torch.set_grad_enabled(kind != "forward"):
                z = log_optimal_transport(s, b, **kwargs)
                if kind != "forward":
                    z.backward(grad)
            torch.cuda.synchronize()
            if rep:  # the first is a warm-up
                ms[kind].append((time.perf_counter() - t) * 1e3)
    return {k: float(np.median(v)) for k, v in ms.items()}


def validate_blob(conf: dict, blob, device, pools: dict) -> dict:
    """The trainer's validation (``do_evaluation`` of the val loader, the
    recipe's 4 batches of 32) of ``blob`` loaded strictly into the recipe's
    model, on the uploaded val pool: loss/total, match recall and precision."""
    from gluefactory_torch.train import Trainer, do_evaluation, make_eval_forward

    trainer = Trainer(conf, device=device, weights=blob, pool=pools["train"])
    forward = make_eval_forward(trainer.model, lambda pool, item: trainer.batch(pool, item, "val"))
    results = do_evaluation(trainer.model, trainer.dataset.get_data_loader("val"), forward,
                            pools["val"])
    return {k: float(results[k]) for k in SIFT_VAL_JAX["superglue"]}


def check_trained_validation(device, pools: dict) -> dict:
    """(d) sg_sift_stage1 in the SuperGlue recipe and lg_sift_stage2 in the
    LightGlue stage-2 one on the port's val pool, each reading within the
    range of the JAX package's on its own val pools (SIFT_VAL_JAX, data seeds
    0-2) widened by SIFT_VAL_MARGIN."""
    from gluefactory_torch.core.config import merge
    from gluefactory_torch.recipes import LG_SIFT_WEIGHTS, SG_SIFT_WEIGHTS
    from gluefactory_torch.recipes import sift_lg_stage2_conf, sift_sg_cached_conf

    report, failures = {}, []
    for name, recipe, blob in (("superglue", sift_sg_cached_conf, SG_SIFT_WEIGHTS),
                               ("lightglue", sift_lg_stage2_conf, LG_SIFT_WEIGHTS)):
        conf = merge(recipe(), SIFT_TRAIN_CUTS)
        report[name] = ours = validate_blob(conf, blob, device, pools)
        for key, value in ours.items():
            lo, hi = min(SIFT_VAL_JAX[name][key]), max(SIFT_VAL_JAX[name][key])
            margin = SIFT_VAL_MARGIN[key]
            ok = lo - margin <= value <= hi + margin
            log(f"  (d) {name} from {blob.name}: {key} {value:.4f}; JAX {lo:.4f} to {hi:.4f} "
                f"over data seeds 0-2 (margin {margin} beyond) {'ok' if ok else 'FAILS'}")
            if not ok:
                failures.append((name, key, value))
    if failures:
        raise AssertionError(f"trained blobs' validation against the JAX package: {failures}")
    return report


def check_model_card(device, pair) -> dict:
    """(e) ``recipes.sift_lightglue_conf`` (SIFT, 2048 slots; LightGlue with
    ``add_scale_ori``) from the flax-style initialisation, every mutual match
    kept (untrained), on one gate pair: the kernel path against the plain
    path from the same parameters, one K1 and one K2 launch a view and layer
    (9 layers, the conf's default)."""
    import torch

    from gluefactory_torch.flagship import RANSAC_CONF
    from gluefactory_torch.models import build_model
    from gluefactory_torch.ops import attention as A
    from gluefactory_torch.recipes import sift_lightglue_conf
    from gluefactory_torch.robust_estimators import load_estimator

    estimator = load_estimator("homography", "ransac")(RANSAC_CONF)
    models = []
    for impl in ("auto", "xla"):
        conf = sift_lightglue_conf()["model"]
        conf["matcher"].update(attention=impl, filter_threshold=0.0)
        torch.manual_seed(0)
        models.append(build_model("two_view_pipeline", conf, device=device))
    models[1].load_state_dict(models[0].state_dict())
    A.reset_launches()
    pred, _ = run_pair(models[0], estimator, *pair)
    launches = dict(A.launches)
    layers = models[0].matcher.conf["n_layers"]
    ppred, _ = run_pair(models[1], estimator, *pair)
    agree = float((pred["matches0"] == ppred["matches0"]).float().mean())
    matches = int((pred["matches0"] > -1).sum())
    log(f"  (e) sift+lightglue (add_scale_ori, flax init, 2048 slots): "
        f"{int(pred['keypoint_valid0'].sum())} keypoints, {matches} mutual matches; matches0 "
        f"kernel vs plain agree {agree:.4f} (at least {GATE_AGREE}); launches {launches}")
    if (agree < GATE_AGREE or matches < 20
            or launches != {"attention_rotary": 2 * layers, "attention": 2 * layers}):
        raise AssertionError(f"sift+lightglue model card: agreement {agree}, launches "
                             f"{launches}, {matches} matches")
    return launches


def check_sift_training(device, root: Path) -> tuple[dict, dict]:
    """Phase 16: (a) the SIFT pool of the cached SIFT recipes (768 + 64
    images, 448x448, 512 slots, contrast 0.02, on_host) extracted on the
    card under a temporary DATA_PATH, against the CPU, its cache read back
    bit for bit; (b) SIFT+LightGlue stage 2 from lg_sift_stage1 and (c)
    SIFT+SuperGlue from the flax-style initialisation: step 0 on the kernel
    path against the plain path, then ``training`` cut by SIFT_TRAIN_CUTS
    and a --restore; (d) the trained blobs' validation against the JAX
    package's; (e) the three new JAX gates and the sift+lightglue model card.
    Returns ({path: attention launches}, what is printed)."""
    from gluefactory_torch import settings

    data_path, settings.DATA_PATH = settings.DATA_PATH, root / "data"  # not the repository's
    try:
        return _check_sift_training(device, root)
    finally:
        settings.DATA_PATH = data_path


def _check_sift_training(device, root: Path) -> tuple[dict, dict]:
    import numpy as np
    import torch

    from gluefactory_torch.core.config import merge
    from gluefactory_torch.datasets import get_dataset
    from gluefactory_torch.datasets.homographies_ondevice import (
        OnDeviceHomographyDataset,
        upload_pool,
    )
    from gluefactory_torch.models.matchers import superglue as SG
    from gluefactory_torch.recipes import sift_lg_stage2_conf, sift_sg_cached_conf
    from gluefactory_torch.train import Trainer

    report, launches = {}, {}
    conf = merge(sift_sg_cached_conf(), SIFT_TRAIN_CUTS)
    dataset = get_dataset(conf["data"]["name"])(conf["data"])
    drawn, draw = [], OnDeviceHomographyDataset.build_pool

    def timed_draw(self, *args, **kwargs):  # the source images, drawn on the host
        t0 = time.perf_counter()
        out = draw(self, *args, **kwargs)
        drawn.append(time.perf_counter() - t0)
        return out

    torch.cuda.synchronize()
    t = time.perf_counter()
    OnDeviceHomographyDataset.build_pool = timed_draw
    try:
        host = {split: dataset.build_pool(split, device) for split in ("train", "val")}
    finally:
        OnDeviceHomographyDataset.build_pool = draw
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    n_images = sum(len(p["keypoints"]) for p in host.values())
    extract_s = seconds - sum(drawn)
    nbytes = sum(v.nbytes for p in host.values() for v in p.values())
    report["pool"] = {"seconds": seconds, "draw_s": sum(drawn), "extract_s": extract_s,
                      "images_per_s": n_images / extract_s, "bytes": nbytes,
                      "keypoints": int(host["train"]["keypoint_valid"].sum())}
    log(f"  (a) SIFT pool of {conf['data']['pool_size']} + {conf['data']['val_pool_size']} "
        f"images (448x448, 512 slots, contrast 0.02) in {seconds:.1f} s: "
        f"{sum(drawn):.1f} s drawing the source images on the host, {extract_s:.1f} s "
        f"extracting on the card and caching ({n_images / extract_s:.1f} images/s); "
        f"{report['pool']['keypoints']} keypoints in the train pool; {nbytes / 1e6:.1f} MB "
        f"({sorted(host['train'])})")
    for split in host:
        with np.load(dataset.pool_cache_path(split)) as blob:
            again = {k: blob[k] for k in blob.files}
        if again.keys() != host[split].keys() or any(
                again[k].dtype != v.dtype or not np.array_equal(again[k], v)
                for k, v in host[split].items()):
            raise AssertionError(f"the {split} SIFT pool cache does not read back bit for bit")
    log("  (a) both cache files read back bit for bit")
    report["card_vs_cpu"] = sift_pool_card_against_cpu(conf["data"], host["train"])
    pools = {split: upload_pool(p, device) for split, p in host.items()}
    seed0 = next(iter(dataset.get_data_loader("train")))

    log("  (b) SIFT+LightGlue stage 2 (sift+lightglue_stage2, from lg_sift_stage1)")
    lg_conf = merge(sift_lg_stage2_conf(), SIFT_TRAIN_CUTS)
    runs = {impl: step0(Trainer(merge(lg_conf, {"model": {"matcher": {"attention": impl}}}),
                                device=device, pool=pools["train"]), pools["train"], seed0)
            for impl in ("xla", "auto")}
    reading = against(runs["xla"], runs["auto"])
    report["lg_step0"] = {k: v for k, v in reading.items() if k != "passes"}
    log(f"  (b) step 0: loss {runs['auto'][0]:.6f} on the kernel path, {runs['xla'][0]:.6f} on "
        f"the plain path ({reading['loss_rel']:.2g} relative, tolerance 1e-4); gradients "
        f"outside {CONFIDENCE_HEADS}* within {reading['worst']:.2g} of their largest (gate "
        f"{TRAIN_GRAD_RTOL}; median {reading['median']:.2g}); confidence targets flipped "
        f"{reading['flips']} of {reading['targets']}")
    if reading["loss_rel"] > 1e-4 or not reading["passes"]:
        raise AssertionError(f"SIFT+LightGlue step 0: {reading}")
    del runs
    torch.cuda.empty_cache()
    launches["sift_lightglue_train"], report["lightglue"] = train_cut(
        lg_conf, root / "sift_lg", pools["train"], device, "lightglue", "(b)")

    log("  (c) SIFT+SuperGlue (sift+superglue_cached, from the flax-style initialisation)")
    calls, attention = [], SG.attention

    def record(*args, **kwargs):  # the kernel path's attentions of step 0
        if kwargs.get("implementation") != "xla":
            calls.append((*(t.detach().contiguous() for t in args), kwargs["kv_mask"]))
        return attention(*args, **kwargs)

    SG.attention = record
    try:
        runs = {impl: sg_step0(Trainer(merge(conf, {"model": {"matcher": {"attention": impl}}}),
                                       device=device, pool=pools["train"]), pools["train"], seed0)
                for impl in ("xla", "auto")}
    finally:
        SG.attention = attention
    reading = sg_against(runs["xla"], runs["auto"])
    report["sg_step0"] = {k: v for k, v in reading.items() if k != "passes"}
    log(f"  (c) step 0: loss {runs['auto'][0]:.6f} on the kernel path, {runs['xla'][0]:.6f} on "
        f"the plain path ({reading['loss_rel']:.2g} relative, tolerance {SG_LOSS_RTOL}); "
        f"gradients within {reading['worst']:.2g} of their largest in {reading['worst_param']} "
        f"(gate {SG_GRAD_RTOL}; median {reading['median']:.2g}); key biases' gradients "
        f"{reading['key_bias_share']:.2g} of the largest gradient (at most "
        f"{SG_KEY_BIAS_SHARE})")
    if not reading["passes"]:
        raise AssertionError(f"SIFT+SuperGlue step 0: {reading}")
    del runs
    # K2 at SuperGlue's training shape on layer 0's first cross-attention of step 0
    report["k2"] = time_masked_k2(*calls[2], "a SuperGlue training step", reps=5)
    del calls
    torch.cuda.empty_cache()
    captured, transport = {}, SG.log_optimal_transport

    def capture(*args, **kwargs):  # the last call's Sinkhorn inputs, without their graph
        captured["args"] = (args[0].detach(), args[1].detach(), kwargs)
        return transport(*args, **kwargs)

    SG.log_optimal_transport = capture
    try:
        launches["sift_superglue_train"], report["superglue"] = train_cut(
            conf, root / "sift_sg", pools["train"], device, "superglue", "(c)")
    finally:
        SG.log_optimal_transport = transport
    sinkhorn = time_sinkhorn(captured)
    step_ms = report["superglue"]["median_step_ms"]
    report["superglue"]["sinkhorn_ms"] = sinkhorn
    log(f"  (c) Sinkhorn (50 iterations on 32x513x513) alone on a step's inputs: forward "
        f"{sinkhorn['forward']:.1f} ms, forward and backward {sinkhorn['forward_backward']:.1f} "
        f"ms ({100 * sinkhorn['forward_backward'] / step_ms:.1f}% of the median step)")

    report["validation"] = check_trained_validation(device, pools)
    del pools
    torch.cuda.empty_cache()

    pairs = {family: gate_pairs(root / f"gate16{family}", device, family) for family in "ab"}
    launches["sift_gates16"] = check_sift_gates(
        device, pairs, ("sift_lightglue_stage1", "sift_lightglue_ood", "superpoint_nn_stage0"),
        "(e)")
    card = check_model_card(device, pairs["a"][0])
    launches["sift_gates16"] = {k: v + card[k] for k, v in launches["sift_gates16"].items()}
    return launches, report


# --- phase 17: ETH3D, the refiner's modes, AdaLAM, the feature cache, depth ground truth ---

ETH3D_SET = {"num_scenes": 6, "views": 6, "points": 1500, "seed": 271828}  # the renderer's defaults
# The JAX package's summaries of each recipe on the same port-rendered set, on the CPU:
# JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_eth3d.py --set <the set of
# python -m gluefactory_torch.scripts.generate_eth3d_set> --out /tmp/x (48 pairs each)
ETH3D_JAX = {
    "eth3d_flagship_conf": {"AP": 73.43, "mnum_matches": 390.0416666666667},
    "eth3d_sp_lg_stage2_conf": {"AP": 41.0, "mnum_matches": 398.9166666666667},
}
# the committed JAX results (outputs/results/eth3d/*/summaries.json), on JAX's cv2-rendered
# set: printed for information only
ETH3D_COMMITTED = {"eth3d_flagship_conf": ("sp_lg2_com_refine", 72.97, 393.5625),
                   "eth3d_sp_lg_stage2_conf": ("sp_lg_stage2", 41.13, 403.3541666666667)}
ETH3D_TOLERANCES = {"AP": 1.0, "mnum_matches": 0.02}  # AP points; relative match count
ETH3D_CHECK_PAIRS = 8  # (a) kernel path against plain path, (b) static against window
ETH3D_AGREE = 0.99  # (a) share of matches0 the two paths agree on, each pair
# (b) |static - window| of the refined keypoints: the two formulations sample different
# images at the affinely mapped patch, so where the ZNCC surface is ambiguous or one
# mode's peak misses the gate they part by pixels. On the CPU, the flagship's matches of
# the same 8 pairs at full width (1969 refined keypoints) refined by both packages
# (JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_refiner_modes.py --set <the set
# of python -m gluefactory_torch.scripts.generate_eth3d_set>): the port's static mode
# refines the same matches as JAX's and lies within 1e-3 px of it on 99.14% of them,
# within 0.0136 px on all (window mode against JAX's window: 99.09%, 0.0493 px); JAX's own
# static against window spread is the port's to the fourth digit.
# The card is held to that spread: the share within 0.05 px no more than 3 points below
# JAX's, the median within 0.05 px
REFINER_CPU = {"within_0.05px": 0.7359, "median_px": 0.0167, "p99_px": 2.2526, "max_px": 8.0470}
REFINER_JAX_CPU = {"within_0.05px": 0.7364, "median_px": 0.0168, "p99_px": 2.2526,
                   "max_px": 8.0470}
REFINER_BOUND = {"within_0.05px": 0.7064, "median_px": 0.05}
# (c) the JAX package's sift_nn_adalam on famA's first 8 sequences (40 pairs), seeds 0-4
# setting both AdaLAM's stream and RANSAC's (JAX_PLATFORMS=cpu PYTHONPATH=. python
# tests/test_torch_adalam.py --set <famA of phase 8>): mAA, and the mean adalam_kept
ADALAM_SEQS = 8
ADALAM_JAX_MAA = [58.684, 59.321, 58.088, 59.058, 60.082]
ADALAM_JAX_KEPT = [76.35, 76.425, 76.425, 76.5, 76.525]
ADALAM_MAA_TOL = 1.5  # points beyond the range of JAX's seeds
ADALAM_KEPT_TOL = 0.03  # relative, against seed 0's
CACHE_AGREE = 0.99  # (d) cached matcher against the full pipeline, matches0, each pair
DEPTH_PX = 1e-4  # (e) reprojections, card against CPU
DEPTH_AGREE = 0.999  # (e) share of matches0 slots equal, card against CPU
DEPTH_SCENE = {"batch": 4, "size": (640, 480), "keypoints": 1024}
TIMING = {"batches": (1, 8), "size": 512, "iters": 10}  # (f), JAX's --size


def render_eth3d_set(root: Path) -> float:
    """Render ETH3D_SET under ``root`` in worker processes (numpy, no
    device); returns the seconds it took."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from gluefactory_torch.scripts.generate_eth3d_set import render_scene_job

    t = time.perf_counter()
    context = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(RENDER_WORKERS, mp_context=context) as pool:
        jobs = [pool.submit(render_scene_job, root, ETH3D_SET["seed"], s, ETH3D_SET["views"],
                            ETH3D_SET["points"]) for s in range(ETH3D_SET["num_scenes"])]
        for job in jobs:
            job.result()
    return time.perf_counter() - t


def _batches(dataset, n: int):
    for i, batch in enumerate(dataset.get_data_loader("test")):
        if i == n:
            break
        yield batch


def to_device(tree, device):
    """The tensors of a nested dict on ``device`` (other values dropped)."""
    import torch

    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()
                if isinstance(v, (dict, torch.Tensor))}
    return tree.to(device)


def matched_before_filter(model, data: dict) -> dict:
    """The pipeline's predictions up to its filter slot (extractor and
    matcher), merged with ``data``: the refiner's input."""
    pred = {}
    for i in ("0", "1"):
        pred.update({k + i: v for k, v in model.extract_view(data, i).items()})
    pred.update(model.matcher({**data, **pred}))
    return {**data, **pred}


def check_eth3d_benchmark(device, root: Path) -> tuple[dict, dict]:
    """(a) ``ETH3DPipeline`` with both recipes on the rendered set, every pair
    at full width through the kernels: 12 + 12 launches a pair, AP and
    mnum_matches within ETH3D_TOLERANCES of the JAX package's on the same
    set; the flagship's kernel path against its plain path on the first
    ETH3D_CHECK_PAIRS pairs and its time by stage. Returns (launches, report)."""
    import numpy as np
    import torch

    from gluefactory_torch import recipes
    from gluefactory_torch.core.config import merge
    from gluefactory_torch.eval.eth3d import ETH3DPipeline
    from gluefactory_torch.eval.eval_pipeline import to_model_input
    from gluefactory_torch.eval.io import load_model
    from gluefactory_torch.ops import attention as A

    launches = {"attention_rotary": 0, "attention": 0}
    report, failures = {}, []
    for recipe, ref in ETH3D_JAX.items():
        conf = merge(getattr(recipes, recipe)(), {"data": {"data_dir": str(root / "set")}})
        pipeline = ETH3DPipeline(conf, device=device)
        n_pairs = len(pipeline.dataset)
        model = load_model(conf["model"], conf["checkpoint"], device)
        A.reset_launches()
        t = time.perf_counter()
        summaries, _ = pipeline.run(root / f"eval_{recipe}", model=model, overwrite=True)
        seconds = time.perf_counter() - t
        counts = dict(A.launches)
        if counts != {"attention_rotary": 12 * n_pairs, "attention": 12 * n_pairs}:
            raise AssertionError(f"eth3d {recipe}: launches {counts} for {n_pairs} pairs, "
                                 "expected 12 and 12 a pair")
        for key in launches:
            launches[key] += counts[key]
        forward = float(np.median(pipeline.timings["forward_ms"]))
        report[recipe] = {"pairs": n_pairs, "seconds": seconds, "median_forward_ms": forward,
                          "summaries": summaries}
        folder, ap, matches = ETH3D_COMMITTED[recipe]
        log(f"  (a) {recipe}: {n_pairs} pairs in {seconds:.1f} s ({n_pairs / seconds:.2f} "
            f"pairs/s), median forward {forward:.1f} ms a pair (1024 keypoints, 1024-pixel "
            f"canvas); launches {counts}; summaries {json.dumps(summaries)} (the committed "
            f"{folder}, on JAX's cv2-rendered set: AP {ap}, mnum_matches {matches:.2f})")
        for key, value in ref.items():
            tol = ETH3D_TOLERANCES[key] * (abs(value) if key == "mnum_matches" else 1.0)
            port = float(summaries[key])
            ok = abs(port - value) <= tol
            log(f"  {recipe} {key}: port {port:.3f}, JAX {value:.3f} on the same set, "
                f"difference {port - value:+.3f} (tolerance {tol:.3f}) "
                f"{'ok' if ok else 'FAILS'}")
            if not ok:
                failures.append(f"{recipe} {key}: {port} against {value}")

    conf = merge(recipes.eth3d_flagship_conf(), {"data": {"data_dir": str(root / "set")}})
    model = load_model(conf["model"], conf["checkpoint"], device)
    plain = load_model(merge(conf["model"], {"matcher": {"attention": "xla"}}),
                       conf["checkpoint"], device)
    dataset = ETH3DPipeline(conf, device=device).dataset
    agree = []
    for batch in _batches(dataset, ETH3D_CHECK_PAIRS):
        data = to_model_input(batch, device)
        with torch.inference_mode():
            m0, pm0 = model(data)["matches0"], plain(data)["matches0"]
        agree.append(float((m0 == pm0).float().mean()))
    log(f"  (a) kernel path against plain path on the first {ETH3D_CHECK_PAIRS} pairs: "
        f"matches0 agree {min(agree):.4f} at worst (bound {ETH3D_AGREE})")
    if min(agree) < ETH3D_AGREE:
        failures.append(f"kernel against plain path: {agree}")
    report["agree"] = agree
    report["stages"] = time_stages(model, dataset, device, ETH3D_CHECK_PAIRS)
    s = report["stages"]
    log(f"  (a) the flagship's first {ETH3D_CHECK_PAIRS} pairs, each stage synchronised: "
        f"median {s['extractor_ms']:.1f} ms SuperPoint (both views), {s['matcher_ms']:.1f} ms "
        f"LightGlue, {s['refiner_ms']:.1f} ms refiner")
    if failures:
        raise AssertionError(f"ETH3D against the JAX package: {failures}")
    return launches, report


def check_refiner_modes(device, root: Path) -> tuple[dict, dict]:
    """(b) the flagship's refiner in static mode against window mode on the
    same matches of the first ETH3D_CHECK_PAIRS pairs: their distance held to
    REFINER_BOUND (set from the CPU's spread), both timed. Returns (launches,
    report)."""
    import numpy as np
    import torch

    from gluefactory_torch import recipes
    from gluefactory_torch.core.config import merge
    from gluefactory_torch.eval.eth3d import ETH3DPipeline
    from gluefactory_torch.eval.eval_pipeline import to_model_input
    from gluefactory_torch.eval.io import load_model
    from gluefactory_torch.models import build_model
    from gluefactory_torch.ops import attention as A

    conf = merge(recipes.eth3d_flagship_conf(), {"data": {"data_dir": str(root / "set")}})
    model = load_model(conf["model"], conf["checkpoint"], device)
    refiners = {mode: build_model("matchers.match_refiner", {"window_sampling": mode},
                                  device=device) for mode in ("static", True)}
    dataset = ETH3DPipeline(conf, device=device).dataset
    ms = {"static": [], "window": []}
    gaps, refined = [], 0
    A.reset_launches()
    for batch in _batches(dataset, ETH3D_CHECK_PAIRS):
        with torch.inference_mode():
            data = matched_before_filter(model, to_model_input(batch, device))
            out = {}
            for mode, refiner in refiners.items():
                name = "static" if mode == "static" else "window"
                torch.cuda.synchronize(device)
                t = time.perf_counter()
                out[name] = refiner(data)
                torch.cuda.synchronize(device)
                ms[name].append((time.perf_counter() - t) * 1e3)
        moved = out["window"]["refined1"][0]
        m0 = data["matches0"][0][moved].long()
        gap = (out["static"]["keypoints1"][0][m0] - out["window"]["keypoints1"][0][m0]).norm(dim=-1)
        gaps.append(gap.cpu().numpy())
        refined += int(moved.sum())
    counts = dict(A.launches)
    gaps = np.concatenate(gaps)
    report = {"static_ms": float(np.median(ms["static"])),
              "window_ms": float(np.median(ms["window"])), "refined": refined,
              "within_0.05px": float((gaps <= 0.05).mean()), "median_px": float(np.median(gaps)),
              "p99_px": float(np.quantile(gaps, 0.99)), "max_px": float(gaps.max())}
    log(f"  (b) refiner on the flagship's matches of {ETH3D_CHECK_PAIRS} pairs ({refined} "
        f"refined): static {report['static_ms']:.1f} ms, window {report['window_ms']:.1f} ms "
        f"a pair (median); |static - window|: {report['within_0.05px']:.4f} within 0.05 px, "
        f"median {report['median_px']:.4f}, 99% {report['p99_px']:.4f}, max "
        f"{report['max_px']:.4f} px (on the CPU the port's {json.dumps(REFINER_CPU)}, JAX's "
        f"{json.dumps(REFINER_JAX_CPU)}; bounds "
        f"{json.dumps(REFINER_BOUND)}); launches {counts}")
    if not (report["within_0.05px"] >= REFINER_BOUND["within_0.05px"]
            and report["median_px"] <= REFINER_BOUND["median_px"]):
        raise AssertionError(f"static against window refiner: {report}")
    return counts, report


def check_adalam(device, hpatches_root: Path) -> dict:
    """(c) ``HPatchesPipeline`` with ``recipes.hpatches_sift_nn_adalam_conf`` on
    famA's first ADALAM_SEQS sequences: the mAA within ADALAM_MAA_TOL of the
    range of the JAX package's over seeds 0-4, the mean adalam_kept within
    ADALAM_KEPT_TOL of seed 0's; pair 0's AdaLAM on the card against the CPU
    on the same matches and draws."""
    import numpy as np
    import torch

    from gluefactory_torch import recipes
    from gluefactory_torch.core.config import merge
    from gluefactory_torch.eval.eval_pipeline import to_model_input
    from gluefactory_torch.eval.hpatches import HPatchesPipeline
    from gluefactory_torch.eval.io import load_model

    conf = merge(recipes.hpatches_sift_nn_adalam_conf(),
                 {"data": {"data_dir": str(hpatches_root / "famA"), "max_seqs": ADALAM_SEQS}})
    pipeline = HPatchesPipeline(conf, device=device)
    model = load_model(conf["model"], conf["checkpoint"], device)
    out = hpatches_root / "eval_sift_nn_adalam"
    t = time.perf_counter()
    summaries, _ = pipeline.run(out, model=model, overwrite=True)
    seconds = time.perf_counter() - t
    with np.load(out / "predictions.npz") as f:
        kept = (f["matches0"] > -1).sum(-1)  # every kept match is one of matches0
    batch = next(iter(pipeline.get_dataloader()))
    with torch.inference_mode():
        data = matched_before_filter(model, to_model_input(batch, device))
        card = model.filter(data)
        cpu = model.filter(to_device(data, torch.device("cpu")))
    report = {"pairs": len(pipeline.dataset), "seconds": seconds,
              "median_forward_ms": float(np.median(pipeline.timings["forward_ms"])),
              "mean_adalam_kept": float(kept.mean()), "summaries": summaries,
              "pair0_kept": int(card["adalam_kept"][0]),
              "pair0_equal": bool(torch.equal(card["matches0"].cpu(), cpu["matches0"]))}
    maa = float(summaries["H_error_ransac_mAA"])
    lo, hi = min(ADALAM_JAX_MAA), max(ADALAM_JAX_MAA)
    kept_tol = ADALAM_KEPT_TOL * ADALAM_JAX_KEPT[0]
    log(f"  (c) sift_nn_adalam on famA's first {ADALAM_SEQS} sequences: {report['pairs']} pairs "
        f"in {seconds:.1f} s, median pair latency {report['median_forward_ms']:.1f} ms; "
        f"summaries {json.dumps(summaries)}")
    log(f"  (c) mAA {maa:.3f} against JAX's {lo:.3f} to {hi:.3f} over seeds 0-4 (tolerance "
        f"{ADALAM_MAA_TOL} beyond); mean adalam_kept {report['mean_adalam_kept']:.3f} against "
        f"JAX's {ADALAM_JAX_KEPT[0]:.3f} (tolerance {kept_tol:.3f}; seeds 0-4 "
        f"{min(ADALAM_JAX_KEPT):.3f} to {max(ADALAM_JAX_KEPT):.3f}); pair 0 on the card "
        f"against the CPU (same matches and draws): matches0 equal {report['pair0_equal']}, "
        f"{report['pair0_kept']} kept")
    failures = []
    if not lo - ADALAM_MAA_TOL <= maa <= hi + ADALAM_MAA_TOL:
        failures.append(f"mAA {maa}")
    if not abs(report["mean_adalam_kept"] - ADALAM_JAX_KEPT[0]) <= kept_tol:
        failures.append(f"mean adalam_kept {report['mean_adalam_kept']}")
    if report["pair0_kept"] != int(kept[0]) or not report["pair0_equal"]:
        failures.append(f"pair 0: {report}")
    if failures:
        raise AssertionError(f"AdaLAM: {failures}")
    return report


def check_feature_cache(device, root: Path) -> tuple[dict, dict]:
    """(d) SuperPoint (sp_tpu_stage0b, 1024 keypoints, CoM) exported with
    ``export_features`` over scene000's views on the card, then the
    flagship's LightGlue with ``allow_no_extract`` from that cache on the
    scene's ETH3D pairs, against the full pipeline: matches0 agree on at
    least CACHE_AGREE of the slots of each pair. Returns (launches, report)."""
    import numpy as np
    import torch

    from gluefactory_torch import recipes
    from gluefactory_torch.core.config import merge
    from gluefactory_torch.datasets.base_dataset import collate
    from gluefactory_torch.datasets.image_folder import ImageFolderDataset
    from gluefactory_torch.eval.eth3d import ETH3DPipeline
    from gluefactory_torch.eval.eval_pipeline import to_model_input
    from gluefactory_torch.eval.io import load_model
    from gluefactory_torch.models.cache_loader import CacheLoader
    from gluefactory_torch.ops import attention as A
    from gluefactory_torch.scripts.export_features import export_features, view_cache
    from gluefactory_torch.scripts.extract_pool_features import build_extractor

    conf = merge(recipes.eth3d_flagship_conf(), {"data": {"data_dir": str(root / "set")}})
    dataset = ETH3DPipeline(conf, device=device).dataset
    folder = ImageFolderDataset({"images": str(root / "set" / "scene000" / "images"),
                                 "preprocessing": dataset.conf["preprocessing"]})
    sp = build_extractor("extractors.superpoint", conf["model"]["extractor"], device,
                         weights=recipes.SP_STAGE0B_WEIGHTS)
    t = time.perf_counter()
    out = export_features(folder, sp, root / "sp_scene000.npz", device=device)
    export_s = time.perf_counter() - t
    full = load_model(conf["model"], conf["checkpoint"], device)
    cached = load_model({**conf["model"], "allow_no_extract": True}, conf["checkpoint"], device)
    loader = CacheLoader({"path": str(out)})
    agree, matches = [], []
    A.reset_launches()
    for i, (scene, _, names, a, b) in enumerate(dataset.items):
        if scene != "scene000":
            continue
        batch = collate([dataset[i]])
        data = to_model_input(batch, device)
        for j, im in zip("01", (a, b)):
            data[f"view{j}"]["cache"] = view_cache(loader, names[im]["name"],
                                                   batch[f"view{j}"]["scales"][0], device)
        with torch.inference_mode():
            m_full = full(data)["matches0"]
            m_cached = cached(data)["matches0"]
        agree.append(float((m_full == m_cached).float().mean()))
        matches.append(int((m_full > -1).sum()))
    counts = dict(A.launches)
    report = {"export_s": export_s, "images": len(folder), "pairs": len(agree),
              "agree": agree, "matches": matches}
    log(f"  (d) SuperPoint exported over scene000's {len(folder)} views in {export_s:.1f} s; "
        f"the cached matcher against the full pipeline on its {len(agree)} pairs: matches0 "
        f"agree {min(agree):.4f} at worst (bound {CACHE_AGREE}), {np.mean(matches):.1f} "
        f"matches a pair; launches {counts}")
    if not agree or min(agree) < CACHE_AGREE:
        raise AssertionError(f"cached matcher against the full pipeline: {report}")
    return counts, report


def planar_depth_scene(seed: int) -> dict:
    """DEPTH_SCENE's pairs of views of one slanted plane each (depth maps with
    holes of no depth, pinhole cameras, the pose, keypoints of view 0 and
    their noisy partners in view 1, a fifth of them random, shuffled), as
    numpy float32."""
    import numpy as np

    rng = np.random.default_rng(seed)
    (w, h), n, b = DEPTH_SCENE["size"], DEPTH_SCENE["keypoints"], DEPTH_SCENE["batch"]
    f, c = 0.9 * w, np.array([w / 2.0, h / 2.0])
    K = np.array([[f, 0, c[0]], [0, f, c[1]], [0, 0, 1.0]])
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    rays = np.stack([(xs - c[0]) / f, (ys - c[1]) / f, np.ones_like(xs)], -1)
    out = {k: [] for k in ("depth0", "depth1", "R", "t", "kp0", "kp1", "H")}
    for _ in range(b):
        nrm = np.array([*rng.uniform(-0.3, 0.3, 2), 1.0])
        nrm /= np.linalg.norm(nrm)
        d = rng.uniform(4.0, 6.0)
        axis = rng.normal(size=3)
        axis /= np.linalg.norm(axis)
        a = np.deg2rad(rng.uniform(3, 8))
        S = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
        R = np.eye(3) + np.sin(a) * S + (1 - np.cos(a)) * S @ S
        t = rng.normal(size=3)
        t = t / np.linalg.norm(t) * 0.4
        depths = []
        for nv, dv in ((nrm, d), (R @ nrm, d + (R @ nrm) @ t)):
            z = dv / (rays @ nv)
            z[rng.uniform(size=z.shape) < 0.03] = 0.0
            y0, x0 = rng.integers(0, h - 60), rng.integers(0, w - 60)
            z[y0:y0 + 50, x0:x0 + 50] = 0.0
            depths.append(z)
        Hm = K @ (R + np.outer(t, nrm) / d) @ np.linalg.inv(K)
        kp0 = rng.uniform([2, 2], [w - 3, h - 3], (n, 2))
        hp = np.c_[kp0, np.ones(n)] @ Hm.T
        kp1 = hp[:, :2] / hp[:, 2:] + rng.normal(0, 0.5, (n, 2))
        bad = rng.uniform(size=n) < 0.2
        kp1[bad] = rng.uniform([0, 0], [w, h], (bad.sum(), 2))
        for k, v in zip(out, (*depths, R, t, kp0, kp1[rng.permutation(n)], Hm)):
            out[k].append(v)
    out = {k: np.stack(v).astype(np.float32) for k, v in out.items()}
    out["size"] = np.tile(np.array([w, h], np.float32), (b, 1))
    out["f"] = np.full((b, 2), f, np.float32)
    out["c"] = np.tile(c.astype(np.float32), (b, 1))
    out["valid0"] = rng.uniform(size=(b, n)) < 0.95
    out["valid1"] = rng.uniform(size=(b, n)) < 0.95
    return out


def check_depth_gt(device) -> dict:
    """(e) ``gt_matches_from_pose_depth``, ``matchers.depth_matcher`` and
    ``matchers.oracle_matcher`` (both sources) on the card against the CPU on
    planar_depth_scene: reprojections within DEPTH_PX on the slots visible
    on both, matches0 (and matches1) equal on at least DEPTH_AGREE of the
    slots."""
    import torch

    from gluefactory_torch.geometry.gt_generation import gt_matches_from_pose_depth
    from gluefactory_torch.geometry.wrappers import Camera, Pose
    from gluefactory_torch.models import build_model

    scene = planar_depth_scene(SEED)

    def inputs(dev):
        t = {k: torch.from_numpy(v).to(dev) for k, v in scene.items()}
        cam = Camera.from_fc(t["size"], t["f"], t["c"])
        return {"keypoints0": t["kp0"], "keypoints1": t["kp1"], "keypoint_valid0": t["valid0"],
                "keypoint_valid1": t["valid1"], "T_0to1": Pose.from_Rt(t["R"], t["t"]),
                "H_0to1": t["H"], "view0": {"depth": t["depth0"], "camera": cam},
                "view1": {"depth": t["depth1"], "camera": cam}}

    def gt(data):
        v0, v1 = data["view0"], data["view1"]
        return gt_matches_from_pose_depth(
            data["keypoints0"], data["keypoints1"], v0["depth"], v1["depth"], v0["camera"],
            v1["camera"], data["T_0to1"], valid0=data["keypoint_valid0"],
            valid1=data["keypoint_valid1"])

    def matcher(name: str, conf: dict):
        def run(data):
            return build_model(name, conf, device=data["keypoints0"].device)(data)
        return run

    runs = {"gt_matches_from_pose_depth": gt,
            "depth_matcher": matcher("matchers.depth_matcher", {}),
            "oracle_matcher/depth": matcher("matchers.oracle_matcher", {"source": "depth"}),
            "oracle_matcher/homography": matcher("matchers.oracle_matcher",
                                                 {"source": "homography"})}
    report, failures = {}, []
    for name, fn in runs.items():
        with torch.inference_mode():
            card = {k: v.cpu() for k, v in fn(inputs(device)).items()}
            cpu = fn(inputs(torch.device("cpu")))
        r = {}
        for key in ("matches0", "matches1", "gt_matches0", "gt_matches1"):
            if key in cpu:
                r[key] = float((card[key] == cpu[key]).float().mean())
        for key, vis in (("reproj_0to1", "visible0"), ("reproj_1to0", "visible1")):
            for prefix in ("", "gt_"):
                if prefix + key in cpu:
                    both = card[prefix + vis] & cpu[prefix + vis]
                    r[prefix + vis] = float((card[prefix + vis] == cpu[prefix + vis])
                                            .float().mean())
                    r[prefix + key + "_px"] = float(
                        (card[prefix + key] - cpu[prefix + key]).abs()[both].max())
        positives = int(((cpu.get("matches0", cpu.get("gt_matches0"))) >= 0).sum())
        report[name] = r
        log(f"  (e) {name} on {DEPTH_SCENE['batch']} pairs of {DEPTH_SCENE['size']} depth maps, "
            f"{DEPTH_SCENE['keypoints']} keypoints a view ({positives} positives): card against "
            f"CPU {json.dumps(r)}")
        for key, value in r.items():
            bad = value > DEPTH_PX if key.endswith("_px") else value < DEPTH_AGREE
            if bad:
                failures.append(f"{name} {key}: {value}")
    if failures:
        raise AssertionError(f"depth ground truth, card against CPU: {failures}")
    return report


def check_timing(device) -> tuple[dict, dict]:
    """(f) ``timing_measurement.measure_pipeline`` of the ETH3D flagship (1024
    keypoints, lg_tpu_stage2) on synthetic pairs at TIMING's size, batch 1
    and 8. Returns (launches, report)."""
    from gluefactory_torch import recipes
    from gluefactory_torch.eval.io import load_model
    from gluefactory_torch.eval.timing_measurement import measure_pipeline
    from gluefactory_torch.ops import attention as A

    conf = recipes.eth3d_flagship_conf()
    model = load_model(conf["model"], conf["checkpoint"], device)
    report = {}
    A.reset_launches()
    for batch in TIMING["batches"]:
        r = measure_pipeline(model, batch, TIMING["size"], TIMING["iters"], device=device)
        report[batch] = r
        log(f"  (f) timing_measurement, flagship at {TIMING['size']}x{TIMING['size']}, batch "
            f"{batch}: {r['pairs_per_s']:.2f} pairs/s, {r['ms_per_pair']:.2f} ms a pair "
            f"({TIMING['iters']} timed calls after 3)")
    return dict(A.launches), report


def check_eth3d(device, root: Path, hpatches_root: Path) -> tuple[dict, dict]:
    """Phase 17: (a) the ETH3D benchmark, (b) the refiner's static mode, (c)
    AdaLAM on phase 8's famA, (d) the feature cache, (e) depth ground truth,
    (f) timing_measurement. Returns ({path: attention launches}, report)."""
    render_s, spent, where = rendered(render_eth3d_set, root / "set")
    report = {"render_s": spent}
    log(f"  rendered {ETH3D_SET['num_scenes']} scenes of {ETH3D_SET['views']} views "
        f"(640x480, {ETH3D_SET['points']} points) in {render_s:.1f} s "
        f"({RENDER_WORKERS} processes, {where})")
    launches = {}
    launches["eth3d"], report["eth3d"] = check_eth3d_benchmark(device, root)
    launches["refiner_modes"], report["refiner"] = check_refiner_modes(device, root)
    report["adalam"] = check_adalam(device, hpatches_root)
    launches["feature_cache"], report["cache"] = check_feature_cache(device, root)
    report["depth"] = check_depth_gt(device)
    launches["timing"], report["timing"] = check_timing(device)
    return launches, report


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
    import tempfile

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script checks the port on an "
              "NVIDIA GPU", file=sys.stderr)
        return 1

    from gluefactory_torch.ops import attention as A
    from gluefactory_torch.ops import elementwise as E
    from gluefactory_torch.ops import kernels
    from gluefactory_torch.models.lines.elsed import SOURCE as ELSED_SOURCE
    from gluefactory_torch.models.lines.lsd import SOURCE as LSD_SOURCE
    from gluefactory_torch.ops.lap import SOURCE as LAP_SOURCE

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
    sources = [A.SOURCE, E.SOURCE, LSD_SOURCE, LAP_SOURCE, ELSED_SOURCE]
    kernels.build_all(sources)  # one compiler each, in parallel
    for source in sources:
        kernels.load(source)
        log(f"  {source}: {'c++' if source.endswith('.cpp') else 'nvcc'} "
            f"{kernels.build_seconds[source]:.1f} s")
        ptxas = kernels.library_path(source).with_suffix(".log").read_text()
        for name, usage in ptxas_usage(ptxas):
            log(f"  ptxas {name}: {usage}")
    log(f"  built in {time.perf_counter() - t:.1f} s")

    # phase 5's probe runs in its own processes beside phases 3-4
    probe = start_probe()

    log("phase 3: kernels against their plain versions")
    results = check_kernels(device)
    from chip_smoke_aliked import check_aliked, check_kernels_2048

    check_kernels_2048(device, results)  # aliked+lightglue's 1x4x2048x64

    from chip_smoke_sfm import check_sfm, render_trajectory_set

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        # phases 8, 10, 17 and 23 read these sets; the host renders them meanwhile
        start_renders([(render_sets, Path(tmp) / "hpatches"),
                       (render_pose_set, Path(tmp) / "pose"),
                       (render_eth3d_set, Path(tmp) / "eth3d" / "set"),
                       (render_trajectory_set, Path(tmp) / "trajectory")])

        log("phase 4: flagship pipeline on the JAX gate's pairs")
        launches = check_flagship(device, Path(tmp) / "gate")

        log("phase 5: kernel probe entry point")
        k3, verdict = check_probe(device, probe)
        results.append(k3)

        log("phase 6: gradients through the kernels")
        grad_errs = check_gradients(device)

        log("phase 7: stage-2 training")
        train_launches = check_training(device)

        log("phase 8: the HPatches benchmark at 1024 keypoints")
        t = time.perf_counter()
        bench_launches, report = check_hpatches(device, Path(tmp) / "hpatches")
        seconds = time.perf_counter() - t
        log(f"  phase 8 took {seconds:.1f} s: waiting for the render {report['render_s']:.1f} s, "
            f"evaluation {seconds - report['render_s']:.1f} s")

        log("phase 9: the stage-5 recipe in bf16")
        t = time.perf_counter()
        stage5_launches, _ = check_stage5(device, Path(tmp) / "hpatches" / "famA",
                                          Path(tmp) / "stage5")
        log(f"  phase 9 took {time.perf_counter() - t:.1f} s")

        log("phase 10: the relative-pose benchmark at full width")
        t = time.perf_counter()
        pose_launches, _ = check_pose(device, Path(tmp) / "pose")
        log(f"  phase 10 took {time.perf_counter() - t:.1f} s")

        log("phase 11: SuperPoint training, the three recipes at full width")
        t = time.perf_counter()
        check_sp_training(device, Path(tmp) / "sp")
        log(f"  phase 11 took {time.perf_counter() - t:.1f} s")

        log("phase 12: adaptive LightGlue on the HPatches sets at 1024 keypoints")
        t = time.perf_counter()
        adaptive_launches, _ = check_adaptive(device, Path(tmp) / "hpatches", report)
        log(f"  phase 12 took {time.perf_counter() - t:.1f} s")

        log("phase 13: LightGlue stage 4 on the cached-feature engine at full width")
        t = time.perf_counter()
        stage4_launches, _ = check_stage4(device, Path(tmp) / "stage4")
        log(f"  phase 13 took {time.perf_counter() - t:.1f} s")

        log("phase 14: LightGlue stage 1 on the host homography dataset at full width")
        t = time.perf_counter()
        stage1_launches, _ = check_stage1(device, Path(tmp) / "stage1")
        log(f"  phase 14 took {time.perf_counter() - t:.1f} s")

        log("phase 15: SIFT, SuperGlue and the nearest-neighbour matcher")
        t = time.perf_counter()
        sift_launches, _ = check_sift_superglue(device, Path(tmp) / "hpatches")
        log(f"  phase 15 took {time.perf_counter() - t:.1f} s")

        log("phase 16: SIFT-feature training (the cached SIFT pool, SIFT+LightGlue, "
            "SIFT+SuperGlue)")
        t = time.perf_counter()
        sift_train_launches, sift_train = check_sift_training(device, Path(tmp) / "sift_train")
        log(f"  phase 16 took {time.perf_counter() - t:.1f} s")

        log("phase 17: ETH3D at full width, the refiner's modes, AdaLAM, the feature cache, "
            "depth ground truth, timing")
        t = time.perf_counter()
        eth3d_launches, _ = check_eth3d(device, Path(tmp) / "eth3d", Path(tmp) / "hpatches")
        log(f"  phase 17 took {time.perf_counter() - t:.1f} s")

        from chip_smoke_gluestick import check_gluestick, check_gluestick_training

        log("phase 18: GlueStick on points and lines at full width (the port's LSD, the "
            "wireframe, hybrid RANSAC)")
        t = time.perf_counter()
        gs_launches, _ = check_gluestick(device, Path(tmp), Path(tmp) / "gate")
        log(f"  phase 18 took {time.perf_counter() - t:.1f} s")

        log("phase 19: GlueStick training at full width (the cached-wireframe engine, the "
            "line ground truth, the three recipes)")
        t = time.perf_counter()
        gs_train_launches, gs_train = check_gluestick_training(device, Path(tmp) / "gs_train")
        log(f"  phase 19 took {time.perf_counter() - t:.1f} s")

        from chip_smoke_lines import check_lines

        log("phase 20: the line benchmarks at full width (HPatches-lines, RDNIM, Wireframe; "
            "LSD+LBD, ELSED, SOLD2+Wunsch, GlueStick; the exact assignment)")
        t = time.perf_counter()
        lines_launches, _ = check_lines(device, Path(tmp), Path(tmp) / "gate")
        log(f"  phase 20 took {time.perf_counter() - t:.1f} s")

        from chip_smoke_jpldd import check_jpldd

        log("phase 21: JPLDD at full width (the ALIKED blocks, POLD2, the NN point-line "
            "matcher; its two training phases, SOLD2's training)")
        t = time.perf_counter()
        check_jpldd(device, Path(tmp), Path(tmp) / "gate")
        log(f"  phase 21 took {time.perf_counter() - t:.1f} s")

        from chip_smoke_loftr import check_loftr

        log("phase 22: LoFTR at full width (ResNet-FPN, the linear-attention coarse "
            "transformer, the dual-softmax, the fine windows; HPatches with and without the "
            "refiner; its three training recipes)")
        t = time.perf_counter()
        loftr_launches = check_loftr(device, Path(tmp), Path(tmp) / "gate")
        log(f"  phase 22 took {time.perf_counter() - t:.1f} s")

        log("phase 23: the SfM back-end and the trajectory benchmark at full width "
            "(SIFT+LightGlue, GlueStick; triangulation, Schur-complement BA, pose graph)")
        sfm_launches = check_sfm(device, Path(tmp))

        log("phase 24: ALIKED at full width (aliked-n16/n32, the official graph; HPatches with "
            "LightGlue and NN; aliked+lightglue_homography training)")
        aliked_launches = check_aliked(device, Path(tmp), Path(tmp) / "gate")

    by_path = {
        "attention_rotary": {"flagship": launches["attention_rotary"],
                             "training": train_launches["attention_rotary"],
                             "hpatches": bench_launches["attention_rotary"],
                             "stage5": stage5_launches["attention_rotary"],
                             "pose": pose_launches["attention_rotary"],
                             "adaptive": adaptive_launches["attention_rotary"],
                             "stage4": stage4_launches["attention_rotary"],
                             "stage1": stage1_launches["attention_rotary"],
                             "sift_gates": sift_launches["gates"]["attention_rotary"],
                             **{path: counts["attention_rotary"]
                                for path, counts in sift_train_launches.items()},
                             **{path: counts["attention_rotary"]
                                for path, counts in eth3d_launches.items()},
                             "loftr": loftr_launches["attention_rotary"],
                             **{path: counts["attention_rotary"]
                                for path, counts in {**sfm_launches, **aliked_launches}.items()}},
        "attention": {"flagship": launches["attention"],
                      "probe": verdict["attention"]["launches"]["attention"],
                      "training": train_launches["attention"],
                      "hpatches": bench_launches["attention"],
                      "stage5": stage5_launches["attention"],
                      "pose": pose_launches["attention"],
                      "adaptive": adaptive_launches["attention"],
                      "stage4": stage4_launches["attention"],
                      "stage1": stage1_launches["attention"],
                      "sift_gates": sift_launches["gates"]["attention"],
                      "sift_superglue": sift_launches["sift_superglue"]["attention"],
                      **{path: counts["attention"]
                         for path, counts in sift_train_launches.items()},
                      **{path: counts["attention"]
                         for path, counts in eth3d_launches.items()},
                      **gs_launches, **gs_train_launches, **lines_launches,
                      "loftr": loftr_launches["attention"],
                      **{path: counts["attention"]
                         for path, counts in {**sfm_launches, **aliked_launches}.items()}},
        "add": {"probe": verdict["tiny"]["launches"]["add"]},
    }
    for r in results:
        if r["name"] == "attention":
            r["times_by_shape"] += [sift_train["k2"], *gs_train["k2"]]
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
    # chip_smoke_gluestick imports this module's helpers: one module, not a second copy
    sys.modules.setdefault("chip_smoke", sys.modules[__name__])
    sys.exit(main())
