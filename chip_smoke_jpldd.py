"""Phase 21 of chip_smoke.py, JPLDD on the card at full width: (a) the model from
weights/jpldd_tpu_structured_descB on the card against the CPU on the gate's views,
(b) HPatches-extended and (c) HPatches-lines against the JAX package's numbers on the
same sets, (d) JPLDD's two training phases, SOLD2's training and the host shapes
dataset, (e) the time by stage (check_jpldd). Run through ``python3 chip_smoke.py``;
the helpers it shares with the other phases are chip_smoke's."""

from __future__ import annotations

import json
import time
from pathlib import Path

from chip_smoke import log

# --- the runs -----------------------------------------------------------------------------

JPLDD_EXT_SEQS = 8  # (b) famA's first 8 sequences of phase 8's set (40 pairs)
# (run, benchmark, conf of recipes.LINE_CONFS, the set it reads: chip_smoke_lines.run_data)
JPLDD_EXT_RUNS = [("famA_extended_jpldd", "hpatches_extended", "jpldd_structured_descB",
                   "extended")]
JPLDD_LINE_RUNS = [
    ("hp_jpldd_structured_descB_wunsch", "hpatches_lines", "jpldd_structured_descB_wunsch",
     "hpatches"),
    ("hp_jpldd_stage0_tuned", "hpatches_lines", "jpldd_stage0_tuned", "hpatches"),
]


def run_conf(root: Path, bench: str, name: str, which: str) -> dict:
    """The conf of a phase-21 run on the sets under ``root`` (phase 8's
    HPatches renders), its checkpoint an absolute path."""
    from chip_smoke_lines import run_data
    from gluefactory_torch.core.config import merge
    from gluefactory_torch.recipes import line_conf
    from gluefactory_torch.settings import ROOT_PATH

    data = ({"data_dir": str(root / "hpatches" / "famA"), "max_seqs": JPLDD_EXT_SEQS}
            if which == "extended" else run_data(root, which))
    conf = merge(line_conf(bench, name), {"data": data})
    conf["checkpoint"] = str(ROOT_PATH / conf["checkpoint"])
    return conf


# --- the JAX package's numbers ------------------------------------------------------------

# The JAX package's summaries of each run on the same sets, on the CPU, RANSAC seed 0
# (JAX_PLATFORMS=cpu PYTHONPATH=.:tests python tests/test_torch_jpldd.py --root <dir>
# --out <dir>, on phase 8's famA rendered under <dir>/hpatches); JPLDD_SEEDS: the RANSAC
# summaries over JAX's seeds 0-2 on the same predictions
JPLDD_JAX: dict = {
    "famA_extended_jpldd": {
        "H_error_ransac_mAA": 68.741, "mkp_repeatability": 0.9053,
        "mline_repeatability": 0.7346, "mnum_matches": 309.875},
    "hp_jpldd_structured_descB_wunsch": {
        "mnum_lines0": 23.375, "mnum_lines1": 22.275, "morth_rep@1.0": 0.5589,
        "morth_rep@3.0": 0.7296, "morth_rep@5.0": 0.7442, "morth_loc@3.0": 0.7222,
        "morth_loc@5.0": 0.8073, "mstruct_rep@1.0": 0.292, "mstruct_rep@3.0": 0.6819,
        "mstruct_rep@5.0": 0.7072, "mstruct_loc@3.0": 1.2317, "mstruct_loc@5.0": 1.3168,
        "mline_match_precision": 0.8448, "mline_match_recall": 0.7829,
        "mnum_line_matches": 17.275, "mH_error_lines": 17.8815, "H_error_lines@1px": 0.0,
        "H_error_lines@3px": 0.1062, "H_error_lines@5px": 0.263},
    "hp_jpldd_stage0_tuned": {
        "mnum_lines0": 25.425, "mnum_lines1": 24.725, "morth_rep@1.0": 0.2703,
        "morth_rep@3.0": 0.6119, "morth_rep@5.0": 0.6399, "morth_loc@3.0": 1.1661,
        "morth_loc@5.0": 1.2836, "mstruct_rep@1.0": 0.0797, "mstruct_rep@3.0": 0.4769,
        "mstruct_rep@5.0": 0.5722, "mstruct_loc@3.0": 1.7158, "mstruct_loc@5.0": 2.0177},
}
JPLDD_SEEDS: dict = {
    "famA_extended_jpldd": {
        "H_error_ransac_mAA": [68.741, 68.714, 68.795]},
    "hp_jpldd_structured_descB_wunsch": {
        "H_error_lines@1px": [0.0, 0.0, 0.0],
        "H_error_lines@3px": [0.1062, 0.1062, 0.1062],
        "H_error_lines@5px": [0.263, 0.263, 0.263]},
}
# the committed outputs/results/<benchmark>/<conf>/summaries.json (JAX on its cv2-rendered
# sets, 100 sequences), printed for information only
JPLDD_COMMITTED = {
    "famA_extended_jpldd": ("hpatches_extended/jpldd_structured_descB",
                            {"H_error_ransac_mAA": 65.307, "mkp_repeatability": 0.9073,
                             "mline_repeatability": 0.7398}),
    "hp_jpldd_structured_descB_wunsch": ("hpatches_lines/jpldd_structured_descB_wunsch",
                                         {"morth_rep@3.0": 0.7248,
                                          "mline_match_precision": 0.8248}),
    "hp_jpldd_stage0_tuned": ("hpatches_lines/jpldd_stage0_tuned", {"morth_rep@3.0": 0.0463}),
}
# (b) |port - JAX| on the same set: mAA points beyond JAX's seed band, repeatability
# shares, the match count relative
EXT_TOLERANCES = {"H_error_ransac_mAA": 1.5, "mkp_repeatability": 0.02,
                  "mline_repeatability": 0.02, "mnum_matches": 0.03}

# (a) the card against the CPU on the gate's 9 views (480x360)
CARD_FIELD_TOL = 1e-4  # heatmap, distance field (normalised), the angle field's sin/cos
CARD_SLOT_SHARE = 0.999  # keypoint slots of equal validity; the CPU's keypoints that the
CARD_KP_PX = 1e-3  # card holds within CARD_KP_PX (in any slot)
CARD_DESC_DOT = 0.9999
CARD_LINE_SHARE = 0.99  # line slots of equal validity with endpoints within CARD_KP_PX
CPU_THREADS = 4  # (a)'s CPU side runs in a spawn process beside (b)-(d)

# (d) training, each recipe at its width; the pools cut from 512/768 + 48/64 images
TRAIN_POOL = {"pool_size": 128, "val_pool_size": 16}
# jpldd_ondevice_structured cut as phase 13 cuts stage 4: 2 epochs of 4 steps, an
# evaluation (4 val batches of 8) and a checkpoint at each epoch end; --restore of
# checkpoint_0_4
PHASE_A_CUTS = {"data": {**TRAIN_POOL, "steps_per_epoch": 4},
                "train": {"epochs": 2, "eval_every_iter": 4, "log_every_iter": 1}}
TRAIN_STEPS = {"jpldd_desc_stage_structured": 3, "sold2_train_pairs": 3,
               "jpldd_train_synthetic": 2}
STEP0_LOSS_RTOL = 1e-4  # step 0, card against CPU on the same batch
STEP0_GRAD_RTOL = 1e-2  # each gradient within this share of its tensor's largest


def hold(run: str, summaries: dict, tolerance, failures: list) -> None:
    """Log each summary of JPLDD_JAX[run] beside the port's; collect those
    outside ``tolerance(key, ref)`` (a RANSAC summary against the range of
    JPLDD_SEEDS[run][key]; the lines' mean corner error printed only)."""
    from chip_smoke_lines import LINES_PRINTED

    for key, ref in JPLDD_JAX[run].items():
        port = float(summaries.get(key, float("nan")))
        if key in LINES_PRINTED:
            log(f"  {run} {key}: port {port:.4f}, JAX {ref} (printed, not held)")
            continue
        seeds = JPLDD_SEEDS.get(run, {}).get(key)
        lo, hi = (min(seeds), max(seeds)) if seeds else (ref, ref)
        tol = tolerance(key, ref)
        ok = lo - tol <= port <= hi + tol
        band = f", {lo:.4f} to {hi:.4f} over JAX's seeds 0-2" if seeds else ""
        log(f"  {run} {key}: port {port:.4f}, JAX {ref:.4f}{band} (tolerance {tol:.4f}) "
            f"{'ok' if ok else 'FAILS'}")
        if not ok:
            failures.append(f"{run} {key}: {port} against {ref}")
    folder, values = JPLDD_COMMITTED[run]
    log(f"  {run}: committed {folder}: {json.dumps(values)} (JAX on its cv2 sets; "
        "information only)")


def ext_tolerance(key: str, ref: float) -> float:
    return EXT_TOLERANCES[key] * (abs(ref) if key == "mnum_matches" else 1.0)


# --- (a) the card against the CPU ---------------------------------------------------------

def gate_views(gate_root: Path):
    """The gate's 9 views (phase 4's renders) as one (9, 360, 480, 3) batch."""
    import numpy as np

    from chip_smoke_gluestick import LSD_CV2
    from gluefactory_torch.utils.image import read_image

    return np.stack([read_image(gate_root / name).astype(np.float32) / 255.0
                     for name in LSD_CV2])


def extract_views(conf: dict, images, device: str, threads: int = 0) -> dict:
    """JPLDD of the pipeline ``conf`` (its checkpoint) on ``images`` on
    ``device``, one view at a time: its outputs as numpy arrays stacked."""
    import numpy as np
    import torch

    from gluefactory_torch.eval.io import load_model

    if threads:
        torch.set_num_threads(threads)
    model = load_model(conf["model"], conf["checkpoint"], device).extractor
    keys = ("heatmap", "distance_field_norm", "angle_field", "angle_field_sincos",
            "keypoints", "keypoint_valid", "descriptors", "lines", "valid_lines",
            "line_desc_samples")
    out = {k: [] for k in keys}
    h, w = images.shape[1:3]
    for image in images:
        data = {"image": torch.from_numpy(image)[None].to(device),
                "image_size": torch.tensor([[w, h]], dtype=torch.float32, device=device)}
        with torch.inference_mode():
            pred = model(data)
        for k in keys:
            out[k].append(pred[k][0].cpu().numpy())
    return {k: np.stack(v) for k, v in out.items()}


def card_against_cpu(card: dict, cpu: dict) -> dict:
    """The (a) readings of the card's outputs against the CPU's."""
    import numpy as np

    out = {k: float(np.abs(card[k] - cpu[k]).max())
           for k in ("heatmap", "distance_field_norm", "angle_field_sincos")}
    diff = np.abs(card["angle_field"] - cpu["angle_field"])
    diff = np.minimum(diff, np.pi - diff)  # mod pi
    # atan2 amplifies its inputs' error by the inverse length of the (sin, cos) pair
    out["angle_x_length"] = float((diff * np.linalg.norm(cpu["angle_field_sincos"], axis=-1)).max())
    out["slot_share"] = float((card["keypoint_valid"] == cpu["keypoint_valid"]).mean())
    # slots of keypoints whose heatmap scores tie within the fields' error may
    # swap places: each of the CPU's keypoints is held to the card's nearest
    near, dots = [], []
    for i in range(len(cpu["keypoints"])):
        kc = cpu["keypoints"][i][cpu["keypoint_valid"][i]]
        kg = card["keypoints"][i][card["keypoint_valid"][i]]
        d = np.abs(kc[:, None] - kg[None]).max(-1)
        j = d.argmin(1)
        near.append(d[np.arange(len(kc)), j])
        dots.append((cpu["descriptors"][i][cpu["keypoint_valid"][i]]
                     * card["descriptors"][i][card["keypoint_valid"][i]][j]).sum(-1))
    near, dots = np.concatenate(near), np.concatenate(dots)
    held = near <= CARD_KP_PX
    out["kp_share"] = float(held.mean())
    out["kp_px"] = float(near[held].max())
    out["desc_dot"] = float(dots[held].min())
    lv = card["valid_lines"] == cpu["valid_lines"]
    lb = card["valid_lines"] & cpu["valid_lines"]
    lpx = np.abs(card["lines"] - cpu["lines"]).reshape(*lb.shape, 4).max(-1)
    out["line_share"] = float((lv & (~lb | (lpx <= CARD_KP_PX))).mean())
    out["lines"] = int(cpu["valid_lines"].sum())
    out["passes"] = bool(max(out[k] for k in ("heatmap", "distance_field_norm",
                                               "angle_field_sincos", "angle_x_length"))
                         <= CARD_FIELD_TOL and out["slot_share"] >= CARD_SLOT_SHARE
                         and out["kp_share"] >= CARD_SLOT_SHARE and out["desc_dot"] >= CARD_DESC_DOT
                         and out["line_share"] >= CARD_LINE_SHARE)
    return out


# --- (b), (c), (e): the benchmarks, timed by stage ----------------------------------------

class JPLDDTimers:
    """Within ``with``: the synchronised ms of every call of JPLDD's trunk,
    its SDDH head, POLD2 and the matcher of ``model`` (a pipeline)."""

    def __init__(self, model, device):
        self.model, self.device, self.ms = model, device, {}

    def _timed(self, name: str, fn):
        import torch

        def run(*args, **kwargs):
            torch.cuda.synchronize(self.device)
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize(self.device)
            self.ms.setdefault(name, []).append((time.perf_counter() - t) * 1e3)
            return out
        return run

    def __enter__(self):
        ext = self.model.extractor
        self.patched = [(ext, "backbone"), (ext.desc_head, "forward"),
                        (ext.line_extractor, "forward"), (self.model.matcher, "forward")]
        for (obj, attr), name in zip(self.patched, ("trunk", "sddh", "pold2", "matcher")):
            setattr(obj, attr, self._timed(name, getattr(obj, attr)))
        return self

    def __exit__(self, *exc):
        for obj, attr in self.patched:
            delattr(obj, attr)  # back to the class's method

    def per_pair(self, n_pairs: int) -> dict:
        return {f"{k}_ms": sum(v) / n_pairs for k, v in self.ms.items()}


def run_benchmark(run: str, pipeline, model, out: Path, device) -> dict:
    """One benchmark run, its stages timed, and its peak memory: the report."""
    import numpy as np
    import torch

    torch.cuda.reset_peak_memory_stats()
    with JPLDDTimers(model, device) as timers:
        t = time.perf_counter()
        summaries, _ = pipeline.run(out, model=model, overwrite=True)
        seconds = time.perf_counter() - t
    n = len(pipeline.timings["forward_ms"])
    stages = timers.per_pair(n)
    for key in ("forward_ms", "ransac_sweep_ms", "metrics_ms", "line_ransac_ms"):
        if pipeline.timings.get(key):
            stages[key] = float(np.median(pipeline.timings[key]))
    peak = torch.cuda.max_memory_allocated() / 2**30
    report = {"pairs": n, "seconds": seconds, "pairs_per_s": n / seconds, "stages": stages,
              "peak_gib": peak, "summaries": summaries}
    log(f"  {run}: {n} pairs in {seconds:.1f} s ({n / seconds:.2f} pairs/s, timers on; peak "
        f"memory {peak:.2f} GiB); ms a pair by stage (synchronised; both views; the forward "
        "and the sweeps are medians): "
        + ", ".join(f"{k[:-3]} {v:.2f}" for k, v in stages.items()))
    log(f"  {run} summaries: {json.dumps(summaries)}")
    return report


# --- (d) training -------------------------------------------------------------------------

def step0_grads(model, batch) -> tuple[float, dict]:
    """A training step without the update: (loss, {name: gradient as numpy})."""
    model.zero_grad(set_to_none=True)
    losses, _ = model.loss(model(batch), batch)
    loss = losses["total"].mean()
    loss.backward()
    grads = {n: p.grad.detach().cpu().numpy() for n, p in model.named_parameters()
             if p.grad is not None}
    model.zero_grad(set_to_none=True)
    return float(loss.detach()), grads


def cpu_step0(model_conf: dict, state: dict, batch: dict, threads: int) -> tuple:
    """``step0_grads`` on the CPU (in the spawn process) of the model of
    ``model_conf`` with ``state`` on ``batch`` (numpy trees): (loss,
    gradients, seconds)."""
    import numpy as np
    import torch

    from gluefactory_torch.models import build_model

    torch.set_num_threads(threads)

    def tensors(tree):
        if isinstance(tree, dict):
            return {k: tensors(v) for k, v in tree.items()}
        return torch.from_numpy(tree) if isinstance(tree, np.ndarray) else tree

    model = build_model(model_conf["name"], model_conf, device="cpu", train=True)
    model.load_state_dict(tensors(state))
    t = time.perf_counter()
    loss, grads = step0_grads(model, tensors(batch))
    return loss, grads, time.perf_counter() - t


def numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy() if hasattr(tree, "detach") else tree


def step0_against(card: tuple, cpu: tuple, tag: str) -> dict:
    """Step 0's loss and gradients on the card against the CPU's on the same
    batch and parameters."""
    import numpy as np

    (card_loss, card_g), (cpu_loss, cpu_g, cpu_s) = card, cpu
    errs = {n: float(np.abs(card_g[n] - g).max()) / max(float(np.abs(g).max()), 1e-30)
            for n, g in cpu_g.items()}
    worst = max(errs, key=errs.get)
    rel = abs(card_loss - cpu_loss) / abs(cpu_loss)
    out = {"loss_card": card_loss, "loss_cpu": cpu_loss, "loss_rel": rel, "worst": errs[worst],
           "worst_param": worst, "params": len(errs), "cpu_s": cpu_s,
           "passes": bool(rel <= STEP0_LOSS_RTOL and errs[worst] <= STEP0_GRAD_RTOL
                          and card_g.keys() == cpu_g.keys())}
    log(f"  {tag} step 0 on the same batch: loss {card_loss:.6f} on the card, {cpu_loss:.6f} on "
        f"the CPU ({rel:.2g} relative, tolerance {STEP0_LOSS_RTOL}); {len(errs)} gradients "
        f"within {errs[worst]:.2g} of their largest ({worst}; tolerance {STEP0_GRAD_RTOL}); the "
        f"CPU's step {cpu_s:.1f} s ({CPU_THREADS} threads, beside the card's work)")
    if not out["passes"]:
        raise AssertionError(f"{tag} step 0, card against CPU: {out}")
    return out


def steps_report(history: list, tag: str, peak: float) -> dict:
    import numpy as np

    bad = [(i, k) for i, h in enumerate(history) for k, v in h.items() if not np.isfinite(v)]
    if bad or any(h["skipped"] for h in history):
        raise AssertionError(f"{tag} steps: non-finite {bad}, skipped "
                             f"{[h['skipped'] for h in history]}")
    ms = [h["ms"] for h in history]
    log(f"  {tag} {len(history)} steps: losses {[round(h['loss/total'], 4) for h in history]}; "
        f"{[round(x, 1) for x in ms]} ms a step (host clock); peak memory {peak:.2f} GiB")
    return {"steps_ms": ms, "losses": [h["loss/total"] for h in history], "peak_gib": peak}


def check_training(device, root: Path, cpu_pool) -> dict:
    """(d): jpldd_ondevice_structured (step 0 card against CPU, the CPU's
    side in ``cpu_pool``; ``training`` cut by PHASE_A_CUTS with evaluations,
    a --restore bit for bit),
    jpldd_desc_stage_structured from its blob (every parameter outside
    desc_head bit for bit after its steps), sold2_train_pairs and
    jpldd_train_synthetic."""
    import torch

    from chip_smoke import check_restore
    from gluefactory_torch.core.config import merge
    from gluefactory_torch.datasets import get_dataset
    from gluefactory_torch.datasets.homographies_ondevice import upload_pool
    from gluefactory_torch.recipes import (
        jpldd_desc_stage_conf,
        jpldd_ondevice_conf,
        jpldd_train_synthetic_conf,
        sold2_train_pairs_conf,
    )
    from gluefactory_torch.train import Trainer, training
    from gluefactory_torch.utils.weights import load_weight_blob, params_from_flat

    report = {}
    tag = "(d) jpldd_ondevice_structured"
    conf = merge(jpldd_ondevice_conf(structured=True), PHASE_A_CUTS)
    dataset = get_dataset(conf["data"]["name"])(conf["data"])
    t = time.perf_counter()
    pool = upload_pool(dataset.build_pool("train", device), device)
    log(f"  {tag}: pool of {conf['data']['pool_size']} structured scenes (448x448) in "
        f"{time.perf_counter() - t:.1f} s; batch {conf['data']['train_batch_size']} at "
        f"{conf['data']['image_size']} px, from the flax-style initialisation")
    trainer = Trainer(conf, device=device, pool=pool)
    batch = trainer.batch(pool, next(iter(dataset.get_data_loader("train"))))
    card_step0 = step0_grads(trainer.model, batch)
    cpu_job = cpu_pool.submit(cpu_step0, conf["model"], numpy_tree(trainer.model.state_dict()),
                              numpy_tree(batch), CPU_THREADS)
    del trainer, batch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    run = root / "jpldd_a"
    t = time.perf_counter()
    _, history = training(conf, run, device=device, pool=pool)
    seconds = time.perf_counter() - t
    report["phase_a"] = steps_report(history, tag, torch.cuda.max_memory_allocated() / 2**30)
    records = [json.loads(x) for x in (run / "metrics.jsonl").read_text().splitlines()]
    evaluations = [r["val/loss/total"] for r in records if "val/loss/total" in r]
    log(f"  {tag}: {len(history)} steps and {len(evaluations)} evaluations in {seconds:.1f} s; "
        f"val loss/total {[round(v, 4) for v in evaluations]}; step 1's terms "
        f"{ {k: round(v, 4) for k, v in records[0].items() if k.startswith('loss/')} }")
    if not evaluations or not (run / "checkpoint_best.ckpt").exists():
        raise AssertionError(f"{tag}: {len(evaluations)} evaluations, checkpoint_best missing")
    report["phase_a"]["restore"] = check_restore(conf, run, run.with_name(run.name + "_restored"),
                                                 history, device, pool, tag)
    del pool
    torch.cuda.empty_cache()

    tag = "(d) jpldd_desc_stage_structured"
    conf = merge(jpldd_desc_stage_conf(structured=True), {"data": TRAIN_POOL})
    blob = params_from_flat(load_weight_blob(conf["train"]["load_experiment"])[0])
    dataset = get_dataset(conf["data"]["name"])(conf["data"])
    pool = upload_pool(dataset.build_pool("train", device), device)
    torch.cuda.reset_peak_memory_stats()
    trainer, history = training(conf, root / "jpldd_b", device=device, pool=pool,
                                steps=TRAIN_STEPS["jpldd_desc_stage_structured"])
    report["phase_b"] = steps_report(history, tag, torch.cuda.max_memory_allocated() / 2**30)
    state = trainer.model.extractor.state_dict()
    frozen = [n for n in state if not n.startswith("desc_head.")]
    moved = [n for n in frozen if not torch.equal(state[n].cpu(), blob[n])]
    learned = [n for n in state if n.startswith("desc_head.") and not torch.equal(
        state[n].cpu(), blob[n])]
    log(f"  {tag}: after the steps {len(frozen) - len(moved)} of {len(frozen)} parameters "
        f"outside desc_head bit for bit the blob's; {len(learned)} of "
        f"{len(state) - len(frozen)} desc_head parameters moved")
    if moved or not learned:
        raise AssertionError(f"{tag}: frozen parameters moved {moved}; desc_head {learned}")
    del trainer, pool
    torch.cuda.empty_cache()

    tag = "(d) sold2_train_pairs"
    conf = merge(sold2_train_pairs_conf(), {"data": TRAIN_POOL})
    dataset = get_dataset(conf["data"]["name"])(conf["data"])
    pool = upload_pool(dataset.build_pool("train", device), device)
    torch.cuda.reset_peak_memory_stats()
    _, history = training(conf, root / "sold2", device=device, pool=pool,
                          steps=TRAIN_STEPS["sold2_train_pairs"])
    report["sold2"] = steps_report(history, tag, torch.cuda.max_memory_allocated() / 2**30)
    del pool
    torch.cuda.empty_cache()

    tag = "(d) jpldd_train_synthetic"
    torch.cuda.reset_peak_memory_stats()
    _, history = training(jpldd_train_synthetic_conf(), root / "jpldd_host", device=device,
                          steps=TRAIN_STEPS["jpldd_train_synthetic"])
    report["host"] = steps_report(history, tag, torch.cuda.max_memory_allocated() / 2**30)
    report["host"]["data_ms"] = [h["data_ms"] for h in history]
    log(f"  {tag}: the wait for the host loader before each step "
        f"{[round(h['data_ms'], 1) for h in history]} ms")
    report["phase_a_step0"] = step0_against(card_step0, cpu_job.result(),
                                            "(d) jpldd_ondevice_structured")
    return report


# --- phase 21 -------------------------------------------------------------------------------

def check_jpldd(device, root: Path, gate_root: Path) -> dict:
    """Phase 21 (a)-(e) of chip_smoke's docstring. ``root`` holds phase 8's
    HPatches sets under ``hpatches``; ``gate_root`` phase 4's gate views."""
    import multiprocessing
    import subprocess
    from concurrent.futures import ProcessPoolExecutor

    import torch

    from chip_smoke_lines import tolerance as lines_tolerance
    from gluefactory_torch.eval import get_benchmark
    from gluefactory_torch.eval.io import load_model

    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=10).stdout.strip()
    except OSError as e:
        smi = f"no nvidia-smi ({e})"
    log(f"  on {smi}")
    report, failures = {}, []
    conf = run_conf(root, *JPLDD_LINE_RUNS[0][1:])
    views = gate_views(gate_root)
    # (a)'s CPU side in a spawn process, beside the card's work
    with ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn")) as pool:
        cpu_job = pool.submit(extract_views, conf, views, "cpu", CPU_THREADS)
        card = extract_views(conf, views, str(device))
        torch.cuda.synchronize()
        t = time.perf_counter()
        extract_views(conf, views, str(device))
        torch.cuda.synchronize()
        card_ms = (time.perf_counter() - t) * 1e3 / len(views)

        for run, bench, name, which in JPLDD_EXT_RUNS + JPLDD_LINE_RUNS:
            conf_r = run_conf(root, bench, name, which)
            pipeline = get_benchmark(bench)(conf_r, device=device)
            model = load_model(conf_r["model"], conf_r["checkpoint"], device)
            report[run] = run_benchmark(run, pipeline, model, root / f"jp_{run}", device)
            hold(run, report[run]["summaries"],
                 ext_tolerance if bench == "hpatches_extended" else lines_tolerance, failures)
            del model

        report["training"] = check_training(device, root / "jpldd_train", pool)
        t = time.perf_counter()
        cpu = cpu_job.result()
        wait = time.perf_counter() - t
    a = report["card_vs_cpu"] = card_against_cpu(card, cpu)
    log(f"  (a) jpldd_tpu_structured_descB on the gate's {len(views)} views (480x360, 512 "
        f"keypoints, POLD2 on 250, 8 SDDH samples a line), card against CPU (the CPU's side "
        f"waited for {wait:.1f} s): heatmap {a['heatmap']:.2g}, distance field "
        f"{a['distance_field_norm']:.2g}, angle sin/cos {a['angle_field_sincos']:.2g}, angle "
        f"x its length {a['angle_x_length']:.2g} (tolerance {CARD_FIELD_TOL}); keypoint "
        f"validity equal on {a['slot_share']:.4f} of slots, the CPU's keypoints held within "
        f"{CARD_KP_PX} px by the card: {a['kp_share']:.4f} (both at least {CARD_SLOT_SHARE}; "
        f"within {a['kp_px']:.2g} px); their descriptor dot products at least {a['desc_dot']:.6f} "
        f"(bound {CARD_DESC_DOT}); line slots equal {a['line_share']:.4f} of "
        f"{cpu['valid_lines'].size} ({a['lines']} valid; at least {CARD_LINE_SHARE}); "
        f"{card_ms:.1f} ms a view on the card")
    if not a["passes"]:
        failures.append(f"card against CPU: {a}")
    report["card_ms_a_view"] = card_ms
    if failures:
        raise AssertionError(f"JPLDD against the JAX package: {failures}")
    return report


def main() -> int:
    """Phase 21 alone, on phase 8's famA (its first JPLDD_EXT_SEQS sequences)
    and the gate views rendered here: ``python3 chip_smoke_jpldd.py``."""
    import multiprocessing
    import sys
    import tempfile
    from concurrent.futures import ProcessPoolExecutor

    import torch

    from chip_smoke import RENDER_WORKERS, gate_pairs
    from gluefactory_torch.scripts.generate_eval_set import render_job, sequence_jobs

    if not torch.cuda.is_available():
        print("chip_smoke_jpldd: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    device = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_jpldd_") as tmp:
        root = Path(tmp)
        with ProcessPoolExecutor(RENDER_WORKERS,
                                 mp_context=multiprocessing.get_context("spawn")) as pool:
            jobs = [pool.submit(render_job, root / "hpatches" / "famA", (640, 480), "a", job)
                    for job in sequence_jobs(JPLDD_EXT_SEQS, 0, "a")]
            for job in jobs:
                job.result()
        gate_pairs(root / "gate", device)
        t = time.perf_counter()
        check_jpldd(device, root, root / "gate")
        log(f"  phase 21 took {time.perf_counter() - t:.1f} s")
    return 0


if __name__ == "__main__":
    import sys

    import chip_smoke

    sys.modules.setdefault("chip_smoke", chip_smoke)
    sys.exit(main())
