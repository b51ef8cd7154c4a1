"""Phases 18 and 19 of chip_smoke.py, GlueStick on the card: inference on points and
lines against the JAX package's numbers (check_gluestick) and training at full width
(check_gluestick_training). Run through ``python3 chip_smoke.py``; the helpers they
share with the other phases are chip_smoke's."""

from __future__ import annotations

import json
import time
from pathlib import Path

from chip_smoke import (
    POSE_CPU_DEG,
    SG_GRAD_RTOL,
    SG_KEY_BIAS_SHARE,
    STAGE4_DESC_ATOL,
    STAGE4_SLOT_PX,
    STAGE4_SLOT_SHARE,
    STEP_LAUNCHES,
    StepWatch,
    _batches,
    log,
    pose_against_cpu,
    sg_against,
    sg_step0,
    stage_calls_ms,
    time_masked_k2,
    to_device,
    train_cut,
)

# --- phase 18: GlueStick on points and lines ---

# The JAX package's summaries of each run on the same port-rendered sets, on the CPU,
# RANSAC seed 0 (JAX_PLATFORMS=cpu PYTHONPATH=.:tests python tests/test_torch_lines_eval.py
# --root <dir> --render --out <dir>, which renders the sets as phases 8, 10 and 17 do)
GS_JAX = {
    "famA": {"H_error_ransac_mAA": 84.143, "mprec@1px": 0.659, "mnum_keypoints": 543.35,
             "mnum_matches": 89.95},
    "famB": {"H_error_ransac_mAA": 68.375, "mprec@1px": 0.536, "mnum_keypoints": 568.167,
             "mnum_matches": 59.8},
    "famA_extended": {"H_error_ransac_mAA": 55.963, "mline_repeatability": 0.7733,
                      "mline_match_precision": 0.931, "mnum_line_matches": 52.4},
    "eth3d": {"AP": 48.91, "AP_lines": 71.13, "mnum_matches": 111.85416666666667},
    "pose_extended": {"rel_pose_error_mAA": 68.898, "mline_epi_prec@1e-03": 0.8771,
                      "mnum_line_matches": 37.3},
}
# each mAA is held within 1.5 of the range of these readings at RANSAC seed 0: (b)
# JAX's mAA at RANSAC seeds 0-2; (d) JAX's at seeds 0-2 and the card's lowest and
# highest on the same predictions over seeds 0-4 (61.841-74.116, PERF.md §2), since the
# RANSAC stream moves that mAA by 12 points: a band that catches a gross regression
GS_MAA_SEEDS = {"famA_extended": [55.963, 54.736, 55.086],
                "pose_extended": [68.898, 62.588, 63.481, 61.841, 74.116]}
# (d) also holds the card's estimator to the CPU's on the same minimal sets
# (GS_POSE_CPU_PAIRS, POSE_CPU_DEG), in float64: the float32 estimator took another LO
# branch on pair 0 (0.98 deg; PERF.md §2)
GS_POSE_CPU_PAIRS = 4  # (d): the first pairs' 5-point LO-RANSAC, card against CPU
# the committed outputs/results/<folder>/summaries.json (JAX on its cv2-rendered sets),
# printed for information only
GS_COMMITTED = {"famA": ("hpatches/gluestick_stage0_com_refine", 84.353),
                "famB": ("hpatches/gluestick_famb_com_refine", 87.272),
                "famA_extended": ("hpatches_extended/gluestick_stage0_hybrid", 62.898),
                "eth3d": ("eth3d/gluestick_stage0", 46.38),
                "pose_extended": ("megadepth1500_extended/gluestick_pose", 58.921)}
# |port - JAX|: points of mAA, AP and AP_lines; shares; relative counts (phase 8's)
GS_TOLERANCES = {"H_error_ransac_mAA": 1.5, "mprec@1px": 0.02, "mnum_keypoints": 0.01,
                 "mnum_matches": 0.03, "mline_repeatability": 0.02,
                 "mline_match_precision": 0.02, "mnum_line_matches": 0.05, "AP": 1.0,
                 "AP_lines": 1.5, "rel_pose_error_mAA": 1.5, "mline_epi_prec@1e-03": 0.02}
GS_TOLERANCES_BY_RUN = {"eth3d": {"mnum_matches": 0.02}}
GS_RELATIVE = ("mnum_keypoints", "mnum_matches", "mnum_line_matches")
GS_LAUNCHES = 24  # K2 a pair: 6 layers x (2 self + 2 cross); no K1
GS_EXTENDED_SEQS = 8  # (b) famA's first 8 sequences (40 pairs), for the script's time
GS_CHECK_PAIRS = 8  # (a) kernel path against plain path, and the time by stage
GS_AGREE = 0.99  # (a) share of the 8 pairs' matches0 slots, and of line_matches0, equal
# (e) OpenCV's LSD_REFINE_STD on the gate views (phase 4's renders), computed on the CPU
# with cv2 (PYTHONPATH=. python tests/test_torch_lsd.py): the segment count, the sum of
# every endpoint coordinate and the first segment, in pixels rounded to 1e-4
LSD_CV2 = {
    "v_qa0/1.ppm": (91, 73070.5056, (264.5522, 167.1157, 321.8227, 177.1726)),
    "v_qa0/2.ppm": (85, 69303.2081, (265.7674, 158.4650, 328.1102, 168.2195)),
    "v_qa0/4.ppm": (80, 64187.6617, (384.5081, 69.0039, 348.0100, 71.2866)),
    "v_qa1/1.ppm": (156, 103025.9790, (379.3747, 190.4298, 461.8750, 190.4506)),
    "v_qa1/2.ppm": (153, 92483.8593, (478.1455, 194.3613, 396.8557, 195.7111)),
    "v_qa1/4.ppm": (119, 68268.7463, (395.3625, 221.0442, 478.3652, 234.0979)),
    "v_qa2/1.ppm": (110, 94792.5526, (394.3741, 243.4114, 343.1209, 243.2592)),
    "v_qa2/2.ppm": (100, 88535.2626, (357.1640, 258.1378, 354.0707, 328.1668)),
    "v_qa2/4.ppm": (116, 94335.0603, (433.1324, 225.4596, 366.7918, 222.4717)),
}
LSD_SUM_PX = 1e-2  # the coordinate sum; LSD_PX each coordinate of the first segment
LSD_PX = 1e-3


def time_gluestick_stages(model, dataset, device, n_pairs: int) -> dict:
    """Median ms a pair of each stage over the first ``n_pairs`` of
    ``dataset`` (stage_calls_ms; the extractor's both views summed)."""
    import numpy as np

    wireframe = model.extractor
    ms = stage_calls_ms(model, {"superpoint": wireframe.point_extractor,
                                "lsd": wireframe.line_extractor, "wireframe": wireframe,
                                "gluestick": model.matcher, "refiner": model.filter},
                        dataset, device, n_pairs)
    views = {k: np.add(ms[k][0::2], ms[k][1::2]) for k in ("superpoint", "lsd", "wireframe")}
    views["wireframe"] = views["wireframe"] - views["superpoint"] - views["lsd"]
    out = {f"{k}_ms": float(np.median(v)) for k, v in views.items()}
    out.update({f"{k}_ms": float(np.median(ms[k])) for k in ("gluestick", "refiner")})
    return out


def hold_gluestick(run: str, summaries: dict, failures: list) -> None:
    """Log each summary of GS_JAX[run] against the port's and collect the
    ones outside GS_TOLERANCES (an mAA of GS_MAA_SEEDS against the range of
    those readings)."""
    for key, ref in GS_JAX[run].items():
        tol = {**GS_TOLERANCES, **GS_TOLERANCES_BY_RUN.get(run, {})}[key]
        tol = tol * (abs(ref) if key in GS_RELATIVE else 1.0)
        port = float(summaries[key])
        seeds = GS_MAA_SEEDS.get(run) if key.endswith("_mAA") else None
        lo, hi = (min(seeds), max(seeds)) if seeds else (ref, ref)
        ok = lo - tol <= port <= hi + tol
        text = (f"port {port:.4f}, {lo:.3f} to {hi:.3f} over GS_MAA_SEEDS (JAX {ref:.3f})"
                if seeds else f"port {port:.4f}, JAX {ref:.3f}")
        log(f"  {run} {key}: {text} on the same set (tolerance {tol:.4f}) "
            f"{'ok' if ok else 'FAILS'}")
        if not ok:
            failures.append(f"{run} {key}: {port} against {ref}")
    folder, value = GS_COMMITTED[run]
    log(f"  {run}: {next(iter(GS_JAX[run]))} {value} in the committed {folder}")


def run_gluestick(pipeline, model, out: Path, run: str) -> tuple[dict, dict]:
    """One benchmark run through the kernels: 24 K2 launches a pair and no K1.
    Returns (summaries, report)."""
    import numpy as np

    from gluefactory_torch.ops import attention as A

    n_pairs = len(pipeline.dataset)
    A.reset_launches()
    t = time.perf_counter()
    summaries, _ = pipeline.run(out, model=model, overwrite=True)
    seconds = time.perf_counter() - t
    counts = dict(A.launches)
    if counts != {"attention_rotary": 0, "attention": GS_LAUNCHES * n_pairs}:
        raise AssertionError(f"{run}: launches {counts} for {n_pairs} pairs, expected "
                             f"{GS_LAUNCHES} K2 and no K1 a pair")
    forward, sweep = pipeline.timings["forward_ms"], pipeline.timings["ransac_sweep_ms"]
    sweep_ms = float(np.median(sweep)) if sweep else None
    report = {"pairs": n_pairs, "seconds": seconds, "pairs_per_s": n_pairs / seconds,
              "median_forward_ms": float(np.median(forward)), "launches": counts,
              "median_ransac_sweep_ms": sweep_ms, "summaries": summaries}
    swept = f", RANSAC sweep {sweep_ms:.1f}" if sweep else ""
    log(f"  {run}: {n_pairs} pairs in {seconds:.1f} s; median ms a pair: forward "
        f"{report['median_forward_ms']:.1f}{swept}; launches {counts}")
    log(f"  {run} summaries: {json.dumps(summaries)}")
    return summaries, report


def check_lsd_host(gate_root: Path) -> dict:
    """(e) the port's LSD on the gate views on this machine's host, against
    OpenCV's segments on them (LSD_CV2), timed a view."""
    import numpy as np
    import torch

    from gluefactory_torch.models.lines.lsd import detect_segments, grey_u8
    from gluefactory_torch.utils.image import read_image

    ms, failures = [], []
    for name, (count, total, first) in LSD_CV2.items():
        image = torch.from_numpy(read_image(gate_root / name).astype(np.float32) / 255.0)
        grey = grey_u8(image[None])[0].numpy()
        t = time.perf_counter()
        segs = detect_segments(grey)
        ms.append((time.perf_counter() - t) * 1e3)
        got = (len(segs), float(segs[:, :4].astype(np.float64).sum()))
        if (got[0] != count or abs(got[1] - total) > LSD_SUM_PX
                or np.abs(segs[0, :4] - np.float32(first)).max() > LSD_PX):
            failures.append(f"{name}: {got[0]} segments, sum {got[1]}, first {segs[0, :4]}; "
                            f"OpenCV {count}, {total}, {first}")
    report = {"views": len(LSD_CV2), "median_ms": float(np.median(ms)),
              "segments": sum(c for c, _, _ in LSD_CV2.values())}
    log(f"  (e) the host LSD on the {report['views']} gate views against OpenCV's "
        f"{report['segments']} segments: {'ok' if not failures else 'FAILS'}; median "
        f"{report['median_ms']:.1f} ms a view")
    if failures:
        raise AssertionError(f"LSD against OpenCV on the card's host: {failures}")
    return report


def check_gluestick(device, root: Path, gate_root: Path) -> tuple[dict, dict]:
    """Phase 18 (a)-(e) of chip_smoke's docstring, each held to GS_JAX; (d)'s
    5-point LO-RANSAC on its first GS_POSE_CPU_PAIRS pairs held to the CPU's
    on the same minimal sets in float64. Returns ({path: attention
    launches}, report)."""
    import numpy as np
    import torch

    from gluefactory_torch import recipes
    from gluefactory_torch.core.config import merge
    from gluefactory_torch.eval.eth3d import ETH3DPipeline
    from gluefactory_torch.eval.eval_pipeline import to_model_input
    from gluefactory_torch.eval.hpatches import HPatchesPipeline
    from gluefactory_torch.eval.hpatches_extended import HPatchesExtendedPipeline
    from gluefactory_torch.eval.io import load_model
    from gluefactory_torch.eval.megadepth1500_extended import MegaDepth1500ExtendedPipeline

    hp, famA = root / "hpatches", str(root / "hpatches" / "famA")
    report, failures, launches = {}, [], {}
    runs = [
        ("pose_extended", MegaDepth1500ExtendedPipeline, recipes.md1500_extended_gluestick_conf(),
         {"pairs": str(root / "pose" / "pairs_calibrated.txt"),
          "root": str(root / "pose" / "images")}),
        ("eth3d", ETH3DPipeline, recipes.eth3d_gluestick_conf(),
         {"data_dir": str(root / "eth3d" / "set")}),
        ("famA_extended", HPatchesExtendedPipeline, recipes.hpatches_extended_gluestick_conf(),
         {"data_dir": famA, "max_seqs": GS_EXTENDED_SEQS}),
        ("famB", HPatchesPipeline, recipes.hpatches_gluestick_famb_conf(refine=True),
         {"data_dir": str(hp / "famB")}),
        ("famA", HPatchesPipeline, recipes.hpatches_gluestick_conf(), {"data_dir": famA}),
    ]
    models = {}
    for run, cls, conf, data in runs:
        conf = merge(conf, {"data": data})
        key = json.dumps(conf["model"], sort_keys=True)
        if key not in models:
            models[key] = load_model(conf["model"], conf["checkpoint"], device)
        pipeline = cls(conf, device=device)
        summaries, report[run] = run_gluestick(pipeline, models[key], root / f"gs_{run}", run)
        launches[f"gluestick_{run}"] = report[run]["launches"]["attention"]
        hold_gluestick(run, summaries, failures)
        if run == "pose_extended":
            th = float(summaries["best_ransac_th"])
            t = time.perf_counter()
            angles = report[run]["against_cpu"] = pose_against_cpu(
                pipeline, root / f"gs_{run}" / "predictions.npz", th, device,
                n_pairs=GS_POSE_CPU_PAIRS, dtypes=("float64",))
            worst = max(max(a) for a in angles["float64"])
            log(f"  (d) the first {GS_POSE_CPU_PAIRS} pairs at {th} px, card against CPU on the "
                f"same minimal sets: ransac_essential in float64 within {worst:.2e} deg "
                f"(tolerance {POSE_CPU_DEG} deg; {time.perf_counter() - t:.1f} s)")
            if not worst <= POSE_CPU_DEG:
                failures.append(f"pose_extended: card against CPU {angles}")
        if run == "famA":
            model, famA_conf, famA_data = models[key], conf, pipeline.dataset
    plain = load_model(merge(famA_conf["model"], {"matcher": {"attention": "xla"}}),
                       famA_conf["checkpoint"], device)
    agree = {"matches0": [], "line_matches0": []}
    for batch in _batches(famA_data, GS_CHECK_PAIRS):
        data_in = to_model_input(batch, device)
        with torch.inference_mode():
            a, b = model(data_in), plain(data_in)
        for k in agree:
            agree[k].append(float((a[k] == b[k]).float().mean()))
    share = {k: float(np.mean(v)) for k, v in agree.items()}  # equal pairs, equal slots
    log(f"  (a) kernel against plain path, famA's first {GS_CHECK_PAIRS} pairs: slots agree "
        f"{share} (bound {GS_AGREE}); worst pair {min(agree['matches0']):.4f} / "
        f"{min(agree['line_matches0']):.4f}")
    if min(share.values()) < GS_AGREE:
        failures.append(f"kernel against plain path: {agree}")
    report["agree"] = agree
    del plain
    stages = time_gluestick_stages(model, famA_data, device, GS_CHECK_PAIRS)
    stages["sweep_ms"] = report["famA"]["median_ransac_sweep_ms"]
    report["stages"] = stages
    log(f"  (a) famA's first {GS_CHECK_PAIRS} pairs, each stage synchronised, median ms a "
        "pair (both views; LSD on the host; the sweep of 6 thresholds x 1024 hypotheses): "
        + ", ".join(f"{k[:-3]} {v:.1f}" for k, v in stages.items()))
    report["lsd"] = check_lsd_host(gate_root)
    if failures:
        raise AssertionError(f"GlueStick against the JAX package: {failures}")
    return launches, report


# --- phase 19: GlueStick training ---------------------------------------------------------

# (a) gluestick_cached cut as phase 13 cuts stage 4: 250 -> 4 steps an epoch, 32 -> 2 epochs,
# an evaluation (its 4 val batches of 16) and a checkpoint at each epoch end (the --restore
# of checkpoint_0_4 takes epoch 1's first step); the pool is the recipe's 640 + 64 images at
# 448x448, 256 keypoints and 96 lines
GS_TRAIN_CUTS = {"data": {"steps_per_epoch": 4},
                 "train": {"epochs": 2, "eval_every_iter": 4, "log_every_iter": 1}}
GS_POOL_CPU_IMAGES = 4  # (a): pool images extracted on the CPU too
GS_STAGE1_STEPS = 3  # (b)
GS_HOMOGRAPHY_STEPS = 2  # (c), batch 8 as the recipe has it
GS_LOSS_RTOL = 1e-4  # step 0: kernel path against plain path, (b) card against CPU
GS_HOMOGRAPHY_LAUNCHES = 36  # (c) K2 a step: 9 layers x 4 in the forward (no remat)


class ExtractorTimers:
    """Within ``with``: the seconds spent in SuperPoint's forward
    (synchronised, on the card) and in LSD's (on the host) since entering,
    and each LSD call's ms (``lsd_ms``)."""

    def __enter__(self):
        import torch

        from gluefactory_torch.models.extractors.superpoint import SuperPoint
        from gluefactory_torch.models.lines.lsd import LSD

        self.seconds, self.lsd_ms = {"superpoint": 0.0, "lsd": 0.0}, []
        self.patched = [(SuperPoint, SuperPoint._forward), (LSD, LSD._forward)]

        def timed(key, fn, sync):
            def run(*args, **kwargs):
                if sync:
                    torch.cuda.synchronize()
                t = time.perf_counter()
                out = fn(*args, **kwargs)
                if sync:
                    torch.cuda.synchronize()
                seconds = time.perf_counter() - t
                self.seconds[key] += seconds
                if key == "lsd":
                    self.lsd_ms.append(seconds * 1e3)
                return out
            return run

        SuperPoint._forward = timed("superpoint", SuperPoint._forward, True)
        LSD._forward = timed("lsd", LSD._forward, False)
        return self

    def __exit__(self, *exc):
        for owner, value in self.patched:
            owner._forward = value


def build_pools(dataset, device, tag: str) -> dict:
    """Both pools of ``dataset`` made on ``device`` and cached; the cache
    files read back bit for bit. Returns (the host pools, the seconds of
    each part)."""
    import numpy as np
    import torch

    with ExtractorTimers() as timers:
        torch.cuda.synchronize()
        t = time.perf_counter()
        host = {split: dataset.build_pool(split, device) for split in ("train", "val")}
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
    for split in host:
        with np.load(dataset.pool_cache_path(split)) as blob:
            again = {k: blob[k] for k in blob.files}
        if again.keys() != host[split].keys() or any(
                again[k].dtype != v.dtype or not np.array_equal(again[k], v)
                for k, v in host[split].items()):
            raise AssertionError(f"{tag}: the {split} pool cache does not read back bit for bit")
    s = timers.seconds
    rest = seconds - sum(s.values())
    conf = dataset.conf
    fconf = conf["features_from"]
    w, h = conf["source_size"]
    log(f"  {tag} wireframe pool of {conf['pool_size']} + {conf['val_pool_size']} images "
        f"({w}x{h}, {fconf['point_extractor']['max_num_keypoints']} keypoints, "
        f"{fconf['line_extractor']['max_num_lines']} lines) in {seconds:.1f} s: SuperPoint "
        f"{s['superpoint']:.1f} s (card), LSD {s['lsd']:.1f} s (host, threads), the rest "
        f"(drawing the source images, junctions, descriptors, cache) {rest:.1f} s; "
        f"{int(host['train']['valid_lines'].sum())} lines and "
        f"{int(host['train']['keypoint_valid'].sum())} nodes in the train pool; caches read "
        "back bit for bit")
    return host, {"seconds": seconds, **{f"{k}_s": v for k, v in s.items()}, "rest_s": rest}


def wireframe_pool_card_against_cpu(conf: dict, host: dict) -> dict:
    """(a) The first GS_POOL_CPU_IMAGES images of the card's train pool
    against the same images extracted on the CPU: LSD's segments equal
    (their scores, validity and order; endpoints snapped to the junctions
    within STAGE4_SLOT_PX), junction indices equal, and the nodes held as
    phase 13 holds its pool."""
    import numpy as np

    from gluefactory_torch.core.config import merge
    from gluefactory_torch.datasets import get_dataset

    cpu_conf = merge(conf, {"pool_size": GS_POOL_CPU_IMAGES, "pool_cache": False})
    t = time.perf_counter()
    cpu = get_dataset(conf["name"])(cpu_conf).build_pool("train", "cpu")
    seconds = time.perf_counter() - t
    card = {k: v[:GS_POOL_CPU_IMAGES] for k, v in host.items() if k != "source_size"}
    same_lines = all(np.array_equal(card[k], cpu[k])
                     for k in ("line_scores", "valid_lines", "lines_junc_idx", "n_junctions"))
    line_px = float(np.abs(card["lines"] - cpu["lines"]).max())
    both = card["keypoint_valid"] & cpu["keypoint_valid"]
    dist = np.abs(card["keypoints"] - cpu["keypoints"]).max(-1)
    same = both & (dist <= 0.5)
    out = {"cpu_s": seconds, "lines_equal": same_lines, "line_px": line_px,
           "validity_share": float((card["keypoint_valid"] != cpu["keypoint_valid"]).mean()),
           "moved_share": float(1 - same.sum() / max(both.sum(), 1)),
           "kp_px": float(dist[same].max()),
           "desc": float(np.abs(card["descriptors"][same].astype(np.float32)
                                - cpu["descriptors"][same].astype(np.float32)).max())}
    log(f"  (a) first {GS_POOL_CPU_IMAGES} images on the CPU ({seconds:.1f} s): LSD's segments "
        f"{'equal' if same_lines else 'DIFFER'} ({int(cpu['valid_lines'].sum())} lines; scores, "
        f"validity, junction indices), endpoints within {line_px:.2g} px; node validity differs "
        f"on {out['validity_share']:.2g} of slots, {out['moved_share']:.2g} of the slots valid on "
        f"both hold another node, nodes within {out['kp_px']:.2g} px and descriptors within "
        f"{out['desc']:.2g} (tolerances {STAGE4_SLOT_SHARE}, {STAGE4_SLOT_SHARE}, "
        f"{STAGE4_SLOT_PX}, {STAGE4_DESC_ATOL})")
    if not (same_lines and line_px <= STAGE4_SLOT_PX
            and out["validity_share"] <= STAGE4_SLOT_SHARE
            and out["moved_share"] <= STAGE4_SLOT_SHARE and out["kp_px"] <= STAGE4_SLOT_PX
            and out["desc"] <= STAGE4_DESC_ATOL):
        raise AssertionError(f"wireframe pool on the card against the CPU: {out}")
    return out


class FirstAttention:
    """Within ``with``: the inputs (q, k, v, key mask) of the first
    kernel-path call of GlueStick's attention, without their graph, as
    ``inputs``."""

    def __init__(self):
        self.inputs = None

    def __enter__(self):
        from gluefactory_torch.models.matchers import gluestick as GS

        self.original = attention = GS.attention

        def record(*args, **kwargs):
            if kwargs.get("implementation") != "xla" and self.inputs is None:
                self.inputs = (*(t.detach().contiguous() for t in args), kwargs["kv_mask"])
            return attention(*args, **kwargs)

        GS.attention = record
        return self

    def __exit__(self, *exc):
        from gluefactory_torch.models.matchers import gluestick as GS

        GS.attention = self.original


def check_gluestick_training(device, root: Path) -> tuple[dict, dict]:
    """Phase 19: GlueStick training on the card at full width. (a)
    ``recipes.gluestick_cached_conf``: the wireframe pool extracted on the card
    (SuperPoint) and the host (LSD), against the CPU on its first images, its
    cache read back; step 0 from the flax-style initialisation on the kernel
    path against the plain path (phase 16(c)'s gate) and with checkpointed
    layers (twice the K2 launches); ``training`` cut by
    GS_TRAIN_CUTS with the line losses, an evaluation, checkpoint_best and a
    --restore bit for bit. (b) ``recipes.gluestick_stage1_conf`` from
    weights/gluestick_tpu_stage0 on its own pool: step 0 on the card against
    the CPU on the same batch, the blob's validation loss below a flax-
    initialised GlueStick's on the same batches, GS_STAGE1_STEPS steps. (c)
    ``recipes.gluestick_train_homography_conf``: GS_HOMOGRAPHY_STEPS steps on the
    host dataset with the wireframe (LSD on the host) in the step, 36 K2
    launches a step. Then K2 timed on a step's inputs of each. Returns
    ({path: K2 launches}, what is printed)."""
    from gluefactory_torch import settings

    data_path, settings.DATA_PATH = settings.DATA_PATH, root / "data"  # not the repository's
    try:
        return _check_gluestick_training(device, root)
    finally:
        settings.DATA_PATH = data_path


def _check_gluestick_training(device, root: Path) -> tuple[dict, dict]:
    import numpy as np
    import torch

    from gluefactory_torch.core.config import merge
    from gluefactory_torch.datasets import get_dataset
    from gluefactory_torch.datasets.homographies_ondevice import upload_pool
    from gluefactory_torch.models import build_model
    from gluefactory_torch.ops import attention as A
    from gluefactory_torch.recipes import (
        gluestick_cached_conf,
        gluestick_stage1_conf,
        gluestick_train_homography_conf,
    )
    from gluefactory_torch.train import Trainer, do_evaluation, make_eval_forward, training

    report, launches, k2_inputs = {}, {}, {}
    log("  (a) gluestick_cached (6 layers, inter-supervision at 2 and 4, from the flax-style "
        "initialisation, batch 16)")
    conf = merge(gluestick_cached_conf(), GS_TRAIN_CUTS)
    dataset = get_dataset(conf["data"]["name"])(conf["data"])
    host, report["pool"] = build_pools(dataset, device, "(a)")
    report["card_vs_cpu"] = wireframe_pool_card_against_cpu(conf["data"], host["train"])
    pool = upload_pool(host["train"], device)
    seed0 = next(iter(dataset.get_data_loader("train")))
    runs = {}
    for impl in ("xla", "auto"):  # the kernel path last: its first attention is kept
        with FirstAttention() as first:
            runs[impl] = sg_step0(Trainer(merge(conf, {"model": {"matcher": {"attention": impl}}}),
                                          device=device, pool=pool), pool, seed0)
    k2_inputs["gluestick_cached"] = first.inputs
    reading = sg_against(runs["xla"], runs["auto"])
    report["step0"] = {k: v for k, v in reading.items() if k != "passes"}
    log(f"  (a) step 0: loss {runs['auto'][0]:.6f} on the kernel path, {runs['xla'][0]:.6f} on "
        f"the plain path ({reading['loss_rel']:.2g} relative, tolerance {GS_LOSS_RTOL}; the "
        f"line message adds with atomics); gradients within {reading['worst']:.2g} of their "
        f"largest in {reading['worst_param']} (gate {SG_GRAD_RTOL}; median "
        f"{reading['median']:.2g}); key biases' gradients {reading['key_bias_share']:.2g} of the "
        f"largest gradient (at most {SG_KEY_BIAS_SHARE})")
    if not (reading["passes"] and reading["loss_rel"] <= GS_LOSS_RTOL):
        raise AssertionError(f"gluestick_cached step 0: {reading}")
    # checkpointed layers: each layer's forward runs again in the backward pass
    A.reset_launches()
    runs["remat"] = sg_step0(Trainer(merge(conf, {"model": {"matcher": {"checkpointed": True}}}),
                                     device=device, pool=pool), pool, seed0)
    remat_launches = A.launches["attention"]
    reading = sg_against(runs["auto"], runs["remat"])
    report["remat"] = {"launches": remat_launches,
                       **{k: v for k, v in reading.items() if k != "passes"}}
    layers = conf["model"]["matcher"]["n_layers"]
    log(f"  (a) step 0 with checkpointed layers: loss {runs['remat'][0]:.6f} "
        f"({reading['loss_rel']:.2g} relative to the kernel path's); gradients within "
        f"{reading['worst']:.2g} of their largest; {remat_launches} K2 launches (4 a layer in "
        f"the forward and 4 again in its recompute: {8 * layers})")
    if not (reading["passes"] and reading["loss_rel"] <= GS_LOSS_RTOL
            and remat_launches == 8 * layers):
        raise AssertionError(f"gluestick_cached step 0 with checkpointed layers: "
                             f"{report['remat']}")
    del runs
    torch.cuda.empty_cache()
    counts, report["training"] = train_cut(conf, root / "gs_cached", pool, device, "gluestick",
                                           "(a)")
    launches["gluestick_cached_train"] = counts["attention"]
    records = [json.loads(line) for line in
               (root / "gs_cached" / "metrics.jsonl").read_text().splitlines()]
    line_losses = {k: records[0][f"loss/{k}"] for k in ("line_nll", "line_nll_2", "line_nll_4")
                   if f"loss/{k}" in records[0]}
    evaluations = [r for r in records if "val/loss/total" in r]
    log(f"  (a) step 1's line losses {line_losses}; {len(evaluations)} evaluations of "
        f"{conf['data']['val_steps']} val batches: loss/total "
        f"{[round(r['val/loss/total'], 4) for r in evaluations]}")
    if len(line_losses) != 3 or not all(np.isfinite(v) for v in line_losses.values()) \
            or not evaluations:
        raise AssertionError(f"gluestick_cached: line losses {line_losses}, "
                             f"{len(evaluations)} evaluations")
    report["line_losses"] = line_losses
    del pool
    torch.cuda.empty_cache()

    log("  (b) gluestick_stage1 (from weights/gluestick_tpu_stage0, its own pool)")
    conf = merge(gluestick_stage1_conf(), {"data": {"steps_per_epoch": GS_STAGE1_STEPS}})
    dataset = get_dataset(conf["data"]["name"])(conf["data"])
    host, report["stage1_pool"] = build_pools(dataset, device, "(b)")
    pools = {split: upload_pool(p, device) for split, p in host.items()}
    trainer = Trainer(conf, device=device, pool=pools["train"])
    seed0 = next(iter(dataset.get_data_loader("train")))
    with FirstAttention() as first:
        card_loss = sg_step0(trainer, pools["train"], seed0)[0]
    k2_inputs["gluestick_stage1"] = first.inputs
    batch = trainer.batch(pools["train"], seed0)
    cpu_model = build_model("two_view_pipeline", conf["model"], device="cpu", train=True)
    cpu_model.load_state_dict({k: v.cpu() for k, v in trainer.model.state_dict().items()})
    with torch.inference_mode():
        cpu_batch = to_device(batch, torch.device("cpu"))
        cpu_loss = float(cpu_model.loss(cpu_model(cpu_batch), cpu_batch)[0]["total"].mean())
    rel = abs(card_loss - cpu_loss) / abs(cpu_loss)
    log(f"  (b) step 0 on the same batch: loss {card_loss:.6f} on the card, {cpu_loss:.6f} on "
        f"the CPU ({rel:.2g} relative, tolerance {GS_LOSS_RTOL})")
    if not rel <= GS_LOSS_RTOL:
        raise AssertionError(f"gluestick_stage1 step 0 on the card against the CPU: {rel:.3g}")
    del cpu_model
    val = {}
    for name, source in (("blob", conf["train"]["load_experiment"]), ("init", None)):
        model = trainer.model if source else Trainer(
            merge(conf, {"train": {"load_experiment": None}}), device=device,
            pool=pools["train"]).model
        forward = make_eval_forward(model, lambda p, item: dataset.make_batch(p, item, "val"))
        val[name] = float(do_evaluation(model, dataset.get_data_loader("val"), forward,
                                        pools["val"])["loss/total"])
    report["stage1_val"] = val
    log(f"  (b) validation ({conf['data']['val_steps']} batches of "
        f"{conf['data']['val_batch_size']}): loss/total {val['blob']:.4f} from the blob, "
        f"{val['init']:.4f} from the flax-style initialisation")
    if not val["blob"] < val["init"]:
        raise AssertionError(f"gluestick_stage1: the blob does not beat the initialisation {val}")
    del trainer
    A.reset_launches()
    with StepWatch() as watch:
        _, history = training(conf, root / "gs_stage1", device=device, pool=pools["train"],
                              steps=GS_STAGE1_STEPS)
    launches["gluestick_stage1_train"] = A.launches["attention"]
    if watch.launches != [STEP_LAUNCHES["gluestick"]] * GS_STAGE1_STEPS or not all(
            np.isfinite(h["loss/total"]) and not h["skipped"] for h in history):
        raise AssertionError(f"gluestick_stage1 steps: {history}, launches {watch.launches}")
    report["stage1_steps_ms"] = [h["ms"] for h in history]
    log(f"  (b) {GS_STAGE1_STEPS} steps: losses {[round(h['loss/total'], 4) for h in history]}; "
        f"{[round(h['ms'], 1) for h in history]} ms (host clock); launches {watch.launches[0]} "
        "a step")
    del pools
    torch.cuda.empty_cache()

    log("  (c) gluestick_train_homography (9 layers, the wireframe in the step, batch 8)")
    conf = gluestick_train_homography_conf()
    A.reset_launches()
    with StepWatch() as watch, FirstAttention() as first, ExtractorTimers() as timers:
        _, history = training(conf, root / "gs_homography", device=device,
                              steps=GS_HOMOGRAPHY_STEPS)
    lsd_ms = timers.lsd_ms
    launches["gluestick_homography_train"] = A.launches["attention"]
    k2_inputs["gluestick_train_homography"] = first.inputs
    per_step_lsd = [sum(lsd_ms[2 * i:2 * i + 2]) for i in range(GS_HOMOGRAPHY_STEPS)]
    expected = {"attention_rotary": 0, "attention": GS_HOMOGRAPHY_LAUNCHES}
    report["homography"] = {"steps_ms": [h["ms"] for h in history],
                            "data_ms": [h["data_ms"] for h in history], "lsd_ms": per_step_lsd,
                            "losses": [h["loss/total"] for h in history]}
    log(f"  (c) {GS_HOMOGRAPHY_STEPS} steps: losses "
        f"{[round(h['loss/total'], 4) for h in history]}; step "
        f"{[round(h['ms'], 1) for h in history]} ms of which the host LSD (both views) "
        f"{[round(x, 1) for x in per_step_lsd]} ms and the rest (device work and its launches) "
        f"{[round(h['ms'] - x, 1) for h, x in zip(history, per_step_lsd)]} ms; the wait for "
        f"the loader before it {[round(h['data_ms'], 1) for h in history]} ms; launches "
        f"{watch.launches}")
    if watch.launches != [expected] * GS_HOMOGRAPHY_STEPS or not all(
            np.isfinite(h["loss/total"]) and not h["skipped"] for h in history):
        raise AssertionError(f"gluestick_train_homography: {history}, launches {watch.launches}")
    torch.cuda.empty_cache()

    report["k2"] = [time_masked_k2(*k2_inputs[name], f"a {name} step", reps=5)
                    for name in ("gluestick_cached", "gluestick_stage1",
                                 "gluestick_train_homography")]
    return launches, report
