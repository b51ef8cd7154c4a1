"""Phase 22 of chip_smoke.py, LoFTR on the card at full width: (a) the matcher from
weights/loftr_tpu_stage0b on the gate's pairs, card against CPU, (b) the HPatches
benchmark from the blob with and without the refiner against the JAX package's
numbers on the same sets, timed by stage, (c) LoFTR's three training recipes, (d) no
launch of K1 or K2 on LoFTR's path (check_loftr). Run through ``python3 chip_smoke.py``;
the helpers it shares with the other phases are chip_smoke's."""

from __future__ import annotations

import json
import time
from pathlib import Path

from chip_smoke import log

# --- the runs -----------------------------------------------------------------------------

LOFTR_SEQS = 8  # (b) the first 8 sequences of phase 8's famA or famB (40 pairs)
# (run: a conf of recipes.LOFTR_CONFS, the set of phase 8 it reads)
LOFTR_RUNS = [("loftr_stage0b", "famA"), ("loftr_stage0b_refine", "famA"),
              ("loftr_stage0b_famb", "famB")]


def run_conf(root: Path, name: str, family: str) -> dict:
    """The conf of a phase-22 run on phase 8's set ``family`` under
    ``root / "hpatches"``, its checkpoint an absolute path."""
    from gluefactory_torch.recipes import hpatches_loftr_conf
    from gluefactory_torch.settings import ROOT_PATH

    conf = hpatches_loftr_conf(name)
    conf["data"].update(data_dir=str(root / "hpatches" / family), max_seqs=LOFTR_SEQS)
    conf["checkpoint"] = str(ROOT_PATH / conf["checkpoint"])
    return conf


# --- the JAX package's numbers ------------------------------------------------------------

# The JAX package's summaries of each run on the same sets, on the CPU, RANSAC seed 0
# (JAX_PLATFORMS=cpu PYTHONPATH=.:tests python tests/test_torch_loftr.py --root <dir>
# --out <dir>, on phase 8's sets rendered under <dir>/hpatches); LOFTR_SEEDS: the mAA
# over JAX's seeds 0-2 on the same predictions
LOFTR_JAX = {
    "loftr_stage0b": {"H_error_ransac_mAA": 41.178, "mprec@1px": 0.305, "mnum_matches": 911.775},
    "loftr_stage0b_refine": {"H_error_ransac_mAA": 86.624, "mprec@1px": 0.449,
                             "mnum_matches": 911.775},
    "loftr_stage0b_famb": {"H_error_ransac_mAA": 92.86, "mprec@1px": 0.892,
                           "mnum_matches": 1024.0},
}
LOFTR_SEEDS = {
    "loftr_stage0b": [41.178, 41.901, 43.155],
    "loftr_stage0b_refine": [86.624, 83.94, 85.715],
    "loftr_stage0b_famb": [92.86, 92.868, 92.86],
}
# the committed outputs/results/hpatches/<run>/summaries.json (JAX on its cv2-rendered
# sets, 100 or 150 pairs), printed for information only
LOFTR_COMMITTED = {
    "loftr_stage0b": {"H_error_ransac_mAA": 41.274, "mprec@1px": 0.298, "mnum_matches": 892.31},
    "loftr_stage0b_refine": {"H_error_ransac_mAA": 88.007, "mprec@1px": 0.446,
                             "mnum_matches": 892.31},
    "loftr_stage0b_famb": {"H_error_ransac_mAA": 70.385, "mprec@1px": 0.597,
                           "mnum_matches": 986.52},
}
# (b) |port - JAX| on the same set: mAA points beyond JAX's seed band, the precision, the
# match count relative
LOFTR_TOLERANCES = {"H_error_ransac_mAA": 1.5, "mprec@1px": 0.02, "mnum_matches": 0.03}

# (a) the card against the CPU on the gate's 6 pairs (480x360), 1024 slots
CARD_CONF_TOL = 1e-4  # the coarse confidence, of its largest value
CARD_SLOT_SHARE = 0.999  # valid slots equal as sets of (view-0 cell, view-1 cell)
CARD_KP_PX = 1e-3  # the refined keypoints of the common slots
# the CPU's sides of (a) and (c) run in two spawn processes beside the card's work
CPU_THREADS = {"gate": 3, "step0": 4}

# (c) training, each recipe at its width; the pool cut from 512 + 48 images. loftr_ondevice
# cut as phase 13 cuts stage 4: 2 epochs of 4 steps, an evaluation (4 val batches of 8)
# and a checkpoint at each epoch end; --restore of checkpoint_0_4
TRAIN_POOL = {"pool_size": 128, "val_pool_size": 16}
ONDEVICE_CUTS = {"data": {**TRAIN_POOL, "steps_per_epoch": 4},
                 "train": {"epochs": 2, "eval_every_iter": 4, "log_every_iter": 1}}
TRAIN_STEPS = {"loftr_finetune_fine": 3, "loftr_homography": 2}
STEP0_LOSS_RTOL = 1e-5  # step 0, card against CPU on the same batch
# each gradient within this share of its tensor's largest. From the initialisation the
# dual-softmax is nearly flat (1 / 1600^2 = 3.9e-7 a cell at 320 px), so the focal loss's
# clamp of the confidence at 1e-6, below which it passes no gradient, cuts through the
# positive cells: a cell that rounding moves across it adds or drops its whole term
STEP0_GRAD_RTOL = 1e-2
CLAMP = 1e-6  # the focal loss's clamp of the confidence


def hold(run: str, summaries: dict, failures: list) -> None:
    """Log each summary of LOFTR_JAX[run] beside the port's; collect those
    outside LOFTR_TOLERANCES (the mAA against the range of LOFTR_SEEDS[run])."""
    for key, ref in LOFTR_JAX[run].items():
        port = float(summaries.get(key, float("nan")))
        lo, hi = (min(LOFTR_SEEDS[run]), max(LOFTR_SEEDS[run])) if key == "H_error_ransac_mAA" \
            else (ref, ref)
        tol = LOFTR_TOLERANCES[key] * (abs(ref) if key == "mnum_matches" else 1.0)
        ok = lo - tol <= port <= hi + tol
        band = f", {lo:.3f} to {hi:.3f} over JAX's seeds 0-2" if lo != hi else ""
        log(f"  {run} {key}: port {port:.4f}, JAX {ref:.4f}{band} (tolerance {tol:.4f}) "
            f"{'ok' if ok else 'FAILS'}")
        if not ok:
            failures.append(f"{run} {key}: {port} against {ref}")
    log(f"  {run}: committed outputs/results/hpatches/{run}: "
        f"{json.dumps(LOFTR_COMMITTED[run])} (JAX on its cv2 sets; information only)")


# --- (a) the card against the CPU ---------------------------------------------------------

def gate_images(gate_root: Path) -> list:
    """The gate's 6 pairs (phase 4's renders) as (image0, image1) numpy pairs,
    each (360, 480, 3) in [0, 1]."""
    import numpy as np

    from chip_smoke import GATE_SEQS
    from gluefactory_torch.utils.image import read_image

    def load(path):
        return read_image(path).astype(np.float32) / 255.0

    return [(load(gate_root / f"v_qa{s}" / "1.ppm"), load(gate_root / f"v_qa{s}" / f"{k}.ppm"))
            for s in range(GATE_SEQS) for k in (2, 4)]


def match_pairs(conf: dict, pairs: list, device: str, threads: int = 0,
                passes: int = 1) -> tuple[list, float]:
    """LoFTR of the HPatches ``conf`` (its blob) on each pair on ``device``,
    ``passes`` times: the last pass's coarse confidence, keypoints and
    validity as numpy arrays, and its ms a pair (host clock, synchronised)."""
    import torch

    from gluefactory_torch.eval.eval_pipeline import synchronize
    from gluefactory_torch.eval.io import load_model

    if threads:
        torch.set_num_threads(threads)
    device = torch.device(device)
    model = load_model(conf["model"], conf["checkpoint"], device)
    for _ in range(passes):
        out = []
        synchronize(device)
        t = time.perf_counter()
        for img0, img1 in pairs:
            data = {"view0": {"image": torch.from_numpy(img0)[None].to(device)},
                    "view1": {"image": torch.from_numpy(img1)[None].to(device)}}
            with torch.inference_mode():
                pred = model(data)
            out.append({k: pred[k][0].cpu().numpy() for k in (
                "coarse_confidence", "keypoints0", "keypoints1", "keypoint_valid0")})
        synchronize(device)
        ms = (time.perf_counter() - t) * 1e3 / len(pairs)
    return out, ms


def card_against_cpu(card: list, cpu: list) -> dict:
    """The (a) readings: the confidence's largest difference over its largest
    value, the share of valid slots common to both as sets of (view-0 cell,
    view-1 cell) pairs, the refined keypoints of the common slots."""
    import numpy as np

    conf = max(float(np.abs(g["coarse_confidence"] - c["coarse_confidence"]).max())
               / float(np.abs(c["coarse_confidence"]).max()) for g, c in zip(card, cpu))

    def slots(pred):
        v = pred["keypoint_valid0"]
        return {tuple(k0.round().astype(int)): k1 for k0, k1 in
                zip(pred["keypoints0"][v], pred["keypoints1"][v])}

    common = total = 0
    px = 0.0
    for g, c in zip(card, cpu):
        a, b = slots(g), slots(c)
        shared = a.keys() & b.keys()
        common += len(shared)
        total += max(len(a), len(b))
        px = max([px] + [float(np.abs(a[k] - b[k]).max()) for k in shared])
    out = {"confidence": conf, "slot_share": common / max(total, 1), "kp_px": px,
           "valid": total}
    out["passes"] = bool(conf <= CARD_CONF_TOL and out["slot_share"] >= CARD_SLOT_SHARE
                         and px <= CARD_KP_PX)
    return out


# --- (b): the benchmark, timed by stage --------------------------------------------------

class LoFTRTimers:
    """Within ``with``: the synchronised ms of every call of LoFTR's stages in
    ``model`` (LoFTR itself, or a pipeline holding it as its matcher, whose
    refiner is timed too)."""

    STAGES = (("_backbone", "backbone"), ("_coarse_transformer", "coarse_transformer"),
              ("_confidence", "dual_softmax_topk"), ("_select", "dual_softmax_topk"),
              ("_fine_refine", "fine"))

    def __init__(self, model, device):
        self.model, self.device, self.ms = model, device, {}

    def _timed(self, name: str, fn):
        import torch

        def run(*args, **kwargs):
            torch.cuda.synchronize(self.device)
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize(self.device)
            self.ms[name] = self.ms.get(name, 0.0) + (time.perf_counter() - t) * 1e3
            return out
        return run

    def __enter__(self):
        loftr = getattr(self.model, "matcher", None) or self.model
        self.patched = [(loftr, attr, name) for attr, name in self.STAGES]
        if getattr(self.model, "filter", None) is not None:
            self.patched.append((self.model.filter, "forward", "refiner"))
        for obj, attr, name in self.patched:
            setattr(obj, attr, self._timed(name, getattr(obj, attr)))
        return self

    def __exit__(self, *exc):
        for obj, attr, _ in self.patched:
            delattr(obj, attr)  # back to the class's method

    def per_pair(self, n_pairs: int) -> dict:
        return {f"{k}_ms": v / n_pairs for k, v in self.ms.items()}


def run_benchmark(run: str, pipeline, model, out: Path, device) -> dict:
    """One benchmark run, its stages timed, and its peak memory: the report."""
    import numpy as np
    import torch

    torch.cuda.reset_peak_memory_stats()
    with LoFTRTimers(model, device) as timers:
        t = time.perf_counter()
        summaries, _ = pipeline.run(out, model=model, overwrite=True)
        seconds = time.perf_counter() - t
    n = len(pipeline.timings["forward_ms"])
    stages = timers.per_pair(n)
    stages["forward_ms"] = float(np.median(pipeline.timings["forward_ms"]))
    stages["ransac_sweep_ms"] = float(np.median(pipeline.timings["ransac_sweep_ms"]))
    peak = torch.cuda.max_memory_allocated() / 2**30
    report = {"pairs": n, "seconds": seconds, "pairs_per_s": n / seconds, "stages": stages,
              "peak_gib": peak, "summaries": summaries}
    log(f"  {run}: {n} pairs in {seconds:.1f} s ({n / seconds:.2f} pairs/s, timers on; peak "
        f"memory {peak:.2f} GiB); ms a pair by stage (synchronised; both views; the forward "
        "and the sweep are medians): "
        + ", ".join(f"{k[:-3]} {v:.2f}" for k, v in stages.items()))
    log(f"  {run} summaries: {json.dumps(summaries)}")
    return report


# --- (c) training -------------------------------------------------------------------------

def step0(model, batch) -> tuple:
    """A training step without the update: (loss, {name: gradient}, the
    coarse confidence), numpy."""
    model.zero_grad(set_to_none=True)
    pred = model(batch)
    losses, _ = model.loss(pred, batch)
    loss = losses["total"].mean()
    loss.backward()
    grads = {n: p.grad.detach().cpu().numpy() for n, p in model.named_parameters()
             if p.grad is not None}
    model.zero_grad(set_to_none=True)
    return float(loss.detach()), grads, pred["coarse_confidence"].detach().cpu().numpy()


def cpu_step0(model_conf: dict, state: dict, batch: dict, threads: int) -> tuple:
    """``step0`` on the CPU (in the spawn process) of the model of
    ``model_conf`` with ``state`` on ``batch`` (numpy trees), and its seconds."""
    import torch

    from gluefactory_torch.models import build_model

    torch.set_num_threads(threads)

    def tensors(tree):
        if isinstance(tree, dict):
            return {k: tensors(v) for k, v in tree.items()}
        return torch.from_numpy(tree)

    model = build_model(model_conf["name"], model_conf, device="cpu", train=True)
    model.load_state_dict(tensors(state))
    t = time.perf_counter()
    out = step0(model, tensors(batch))
    return (*out, time.perf_counter() - t)


def step0_against(card: tuple, cpu: tuple, tag: str) -> dict:
    """Step 0's loss and gradients on the card against the CPU's on the same
    batch and parameters, within STEP0_LOSS_RTOL and STEP0_GRAD_RTOL; the
    confidence entries on either side of CLAMP in one and not the other."""
    import numpy as np

    (card_loss, card_g, card_c), (cpu_loss, cpu_g, cpu_c, cpu_s) = card, cpu
    crossed = int(((card_c > CLAMP) != (cpu_c > CLAMP)).sum())
    log(f"  {tag} step 0: {crossed} of {cpu_c.size} confidence entries lie on the two sides "
        f"of the focal loss's clamp at {CLAMP} on the card and on the CPU; "
        f"{float((cpu_c > CLAMP).mean()):.3f} of the CPU's lie above it")
    errs = {n: float(np.abs(card_g[n] - g).max()) / max(float(np.abs(g).max()), 1e-30)
            for n, g in cpu_g.items()}
    worst = max(errs, key=errs.get)
    rel = abs(card_loss - cpu_loss) / abs(cpu_loss)
    out = {"loss_card": card_loss, "loss_cpu": cpu_loss, "loss_rel": rel, "worst": errs[worst],
           "worst_param": worst, "params": len(errs), "cpu_s": cpu_s,
           "passes": bool(rel <= STEP0_LOSS_RTOL and errs[worst] <= STEP0_GRAD_RTOL
                          and card_g.keys() == cpu_g.keys())}
    log(f"  {tag} step 0 on the same batch: loss {card_loss:.7f} on the card, {cpu_loss:.7f} on "
        f"the CPU ({rel:.2g} relative, tolerance {STEP0_LOSS_RTOL}); {len(errs)} gradients "
        f"within {errs[worst]:.2g} of their largest ({worst}; tolerance {STEP0_GRAD_RTOL}); the "
        f"CPU's step {cpu_s:.1f} s ({CPU_THREADS['step0']} threads, beside the card's work)")
    if not out["passes"]:
        raise AssertionError(f"{tag} step 0, card against CPU: {out}")
    return out


def ondevice_step0(device, cpu_pool) -> tuple:
    """loftr_ondevice's pool, cut by ONDEVICE_CUTS, and step 0 on its first
    batch from the flax-style initialisation on the card; the same step on the
    CPU submitted to ``cpu_pool``: (conf, pool, the card's step 0, the CPU's job)."""
    import torch

    from chip_smoke_jpldd import numpy_tree
    from gluefactory_torch.core.config import merge
    from gluefactory_torch.datasets import get_dataset
    from gluefactory_torch.datasets.homographies_ondevice import upload_pool
    from gluefactory_torch.recipes import loftr_ondevice_conf
    from gluefactory_torch.train import Trainer

    conf = merge(loftr_ondevice_conf(), ONDEVICE_CUTS)
    dataset = get_dataset(conf["data"]["name"])(conf["data"])
    t = time.perf_counter()
    pool = upload_pool(dataset.build_pool("train", device), device)
    log(f"  (c) loftr_ondevice: pool of {conf['data']['pool_size']} images (448x448) in "
        f"{time.perf_counter() - t:.1f} s; batch {conf['data']['train_batch_size']} at "
        f"{conf['data']['image_size']} px, from the flax-style initialisation")
    ticks = [time.perf_counter()]
    trainer = Trainer(conf, device=device, pool=pool)
    batch = trainer.batch(pool, next(iter(dataset.get_data_loader("train"))))
    ticks.append(time.perf_counter())
    card = step0(trainer.model, batch)
    ticks.append(time.perf_counter())
    job = cpu_pool.submit(cpu_step0, conf["model"], numpy_tree(trainer.model.state_dict()),
                          numpy_tree(batch), CPU_THREADS["step0"])
    del trainer, batch
    torch.cuda.synchronize()
    ticks.append(time.perf_counter())
    log("  (c) loftr_ondevice step 0 on the card: the trainer and its first batch "
        f"{ticks[1] - ticks[0]:.1f} s, the step {ticks[2] - ticks[1]:.1f} s (cuDNN's first "
        f"plans), sent to the CPU in {ticks[3] - ticks[2]:.1f} s")
    return conf, pool, card, job


def check_training(device, root: Path, conf: dict, pool: dict, card_step0, cpu_job) -> dict:
    """(c): loftr_ondevice on ``pool`` (``training`` cut by ONDEVICE_CUTS with
    evaluations, a --restore bit for bit; step 0 card against CPU, the CPU's
    side in ``cpu_job``), loftr_finetune_fine from the loftr_tpu_stage0 blob
    on the same pool (its data section is loftr_ondevice's), loftr_homography
    on the host dataset."""
    import torch

    from chip_smoke import check_restore
    from chip_smoke_jpldd import steps_report
    from gluefactory_torch.core.config import merge
    from gluefactory_torch.recipes import loftr_finetune_fine_conf, loftr_homography_conf
    from gluefactory_torch.train import training

    report = {}
    tag = "(c) loftr_ondevice"
    torch.cuda.reset_peak_memory_stats()
    run = root / "loftr_ondevice"
    t = time.perf_counter()
    _, history = training(conf, run, device=device, pool=pool)
    seconds = time.perf_counter() - t
    report["ondevice"] = steps_report(history, tag, torch.cuda.max_memory_allocated() / 2**30)
    records = [json.loads(x) for x in (run / "metrics.jsonl").read_text().splitlines()]
    evaluations = [r["val/loss/total"] for r in records if "val/loss/total" in r]
    log(f"  {tag}: {len(history)} steps and {len(evaluations)} evaluations in {seconds:.1f} s; "
        f"val loss/total {[round(v, 4) for v in evaluations]}; step 1's terms "
        f"{ {k: round(v, 4) for k, v in records[0].items() if k.startswith('loss/')} }")
    if not evaluations or not (run / "checkpoint_best.ckpt").exists():
        raise AssertionError(f"{tag}: {len(evaluations)} evaluations, checkpoint_best missing")
    report["ondevice"]["restore"] = check_restore(conf, run, run.with_name(run.name + "_restored"),
                                                  history, device, pool, tag)

    tag = "(c) loftr_finetune_fine"
    conf = merge(loftr_finetune_fine_conf(), {"data": TRAIN_POOL})
    torch.cuda.reset_peak_memory_stats()
    _, history = training(conf, root / "loftr_fine", device=device, pool=pool,
                          steps=TRAIN_STEPS["loftr_finetune_fine"])
    report["finetune_fine"] = steps_report(history, tag, torch.cuda.max_memory_allocated() / 2**30)
    log(f"  {tag} from {conf['train']['load_experiment']}: matches a pair "
        f"{[round(h['metric/num_matches'], 1) for h in history]}, fine_l2 "
        f"{[round(h['loss/fine_l2'], 4) for h in history]}")
    if not all(h["metric/num_matches"] > 0 and h["loss/fine_l2"] > 0 for h in history):
        raise AssertionError(f"{tag}: the blob's matches do not reach the fine loss: {history}")
    del pool
    torch.cuda.empty_cache()

    tag = "(c) loftr_homography"
    torch.cuda.reset_peak_memory_stats()
    _, history = training(loftr_homography_conf(), root / "loftr_host", device=device,
                          steps=TRAIN_STEPS["loftr_homography"])
    report["host"] = steps_report(history, tag, torch.cuda.max_memory_allocated() / 2**30)
    report["host"]["data_ms"] = [h["data_ms"] for h in history]
    log(f"  {tag}: the wait for the host loader before each step "
        f"{[round(h['data_ms'], 1) for h in history]} ms")
    report["ondevice_step0"] = step0_against(card_step0, cpu_job.result(), "(c) loftr_ondevice")
    return report


# --- phase 22 -------------------------------------------------------------------------------

def check_loftr(device, root: Path, gate_root: Path) -> dict:
    """Phase 22 (a)-(d) of chip_smoke's docstring. ``root`` holds phase 8's
    HPatches sets under ``hpatches``; ``gate_root`` phase 4's gate views.
    Returns the K1/K2 launches of LoFTR's path (none)."""
    import multiprocessing
    import subprocess
    from concurrent.futures import ProcessPoolExecutor

    import torch

    from gluefactory_torch.eval.hpatches import HPatchesPipeline
    from gluefactory_torch.eval.io import load_model
    from gluefactory_torch.ops import attention as A

    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=10).stdout.strip()
    except OSError as e:
        smi = f"no nvidia-smi ({e})"
    log(f"  on {smi}")
    report, failures = {}, []
    A.reset_launches()
    conf_a = run_conf(root, *LOFTR_RUNS[0])
    pairs = gate_images(gate_root)
    # the CPU's sides of (a) and (c) in spawn processes, beside the card's work
    with ProcessPoolExecutor(2, mp_context=multiprocessing.get_context("spawn")) as pool:
        step0_setup = ondevice_step0(device, pool)
        cpu_job = pool.submit(match_pairs, conf_a, pairs, "cpu", CPU_THREADS["gate"])
        t = time.perf_counter()
        card, card_ms = match_pairs(conf_a, pairs, str(device), passes=2)
        log(f"  (a) the card's side: two passes over the gate's {len(pairs)} pairs in "
            f"{time.perf_counter() - t:.1f} s, the model loaded once")

        for run, family in LOFTR_RUNS:
            conf = run_conf(root, run, family)
            pipeline = HPatchesPipeline(conf, device=device)
            model = load_model(conf["model"], conf["checkpoint"], device)
            report[run] = run_benchmark(run, pipeline, model, root / f"lf_{run}", device)
            hold(run, report[run]["summaries"], failures)
            del model

        report["training"] = check_training(device, root / "loftr_train", *step0_setup)
        t = time.perf_counter()
        cpu, cpu_ms = cpu_job.result()
        wait = time.perf_counter() - t
    a = report["card_vs_cpu"] = card_against_cpu(card, cpu)
    log(f"  (a) loftr_tpu_stage0b on the gate's {len(pairs)} pairs (480x360: 2700 x 2700 "
        f"coarse cells, 1024 slots), card against CPU (the CPU's side waited for {wait:.1f} s): "
        f"coarse confidence within {a['confidence']:.2g} of its largest value (tolerance "
        f"{CARD_CONF_TOL}); {a['slot_share']:.4f} of {a['valid']} valid slots common as sets "
        f"(at least {CARD_SLOT_SHARE}); their refined keypoints within {a['kp_px']:.2g} px "
        f"(tolerance {CARD_KP_PX}); {card_ms:.1f} ms a pair on the card, {cpu_ms:.0f} ms on the "
        f"CPU ({CPU_THREADS['gate']} threads, beside the card's work)")
    if not a["passes"]:
        failures.append(f"card against CPU: {a}")
    report["card_ms_a_pair"] = card_ms
    launches = dict(A.launches)
    log(f"  (d) K1/K2 launches on LoFTR's path (a)-(c): {launches} (none expected: linear "
        "attention is three products, the TPU package's too)")
    if any(launches.values()):
        failures.append(f"LoFTR launched the attention kernels: {launches}")
    if failures:
        raise AssertionError(f"LoFTR against the JAX package: {failures}")
    return launches


def main() -> int:
    """Phase 22 alone, on phase 8's sets and the gate views rendered here:
    ``python3 chip_smoke_loftr.py``."""
    import sys
    import tempfile

    import torch

    from chip_smoke import gate_pairs, render_sets

    if not torch.cuda.is_available():
        print("chip_smoke_loftr: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    device = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_loftr_") as tmp:
        root = Path(tmp)
        render_sets(root / "hpatches")
        gate_pairs(root / "gate", device)
        t = time.perf_counter()
        check_loftr(device, root, root / "gate")
        log(f"  phase 22 took {time.perf_counter() - t:.1f} s")
    return 0


if __name__ == "__main__":
    import sys

    import chip_smoke

    sys.modules.setdefault("chip_smoke", chip_smoke)
    sys.exit(main())
