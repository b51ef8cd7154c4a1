"""Phase 24 of chip_smoke.py, ALIKED at full width from a seeded flax-style
initialisation (no ALIKED weights are in the repository; every zero-initialised
kernel, the deformable convolutions' and SDDH's offsets, drawn from normal(0, 0.3)
so that the offset paths do real work): (a) aliked-n16 and aliked-n32 at 2048
keypoints and the official graph (compat) on the gate's views, card against CPU;
(b) aliked+lightglue on the first 8 sequences of phase 8's famA (K1 and K2 at
1x4x2048x64, 18 + 18 a pair; kernel against plain path; ms a pair by stage);
(c) aliked+nn and aliked_official_compat on the same pairs, the NN matches card
against CPU (the official graph's with every slot valid); (d)
aliked+lightglue_homography at full width (batch 32 at 640x640, 512 keypoints, 9
checkpointed layers, the host dataset): step 0 kernel against plain path and card
against CPU, 3 steps, a --restore; (d) runs first, while no CPU work of the phase
competes with its host loader. Also phase 3's K1/K2 at 1x4x2048x64 f32, every key
valid (check_kernels_2048). Run through ``python3 chip_smoke.py``; the
helpers it shares with the other phases are chip_smoke's."""

from __future__ import annotations

import json
import time
from pathlib import Path

from chip_smoke import log

SEED = 20261019  # the models' initialisation and the offsets' draws
OFFSET_SCALE = 0.3
ALIKED_SEQS = 8  # (b), (c): famA's first 8 sequences of phase 8's set (40 pairs)
RUNS = ("aliked+lightglue", "aliked+nn", "aliked_official_compat")  # recipes.ALIKED_CONFS
# (c) the official graph's card-against-CPU matches with every slot valid: initialised
# weights put ~5 raw scores a view above aliked_official_compat's 0.2, so at the card's
# threshold its HPatches run (timed as published) matches almost nothing
CHECK_OVERRIDES = {"aliked_official_compat": {"extractor": {"detection_threshold": -1e9}}}
# (a) the extractors held card against CPU: the runs' own and aliked-n32
CARD_CONFS = {
    "aliked-n16": {"name": "extractors.aliked", "model_name": "aliked-n16",
                   "max_num_keypoints": 2048},
    "aliked-n32": {"name": "extractors.aliked", "model_name": "aliked-n32",
                   "max_num_keypoints": 2048},
    # the official graph with every slot valid (initialised weights put few raw scores
    # above aliked_official_compat's 0.2), as the JAX package's converter test runs it
    "compat": {"name": "extractors.aliked", "model_name": "aliked-n16", "compat": True,
               "max_num_keypoints": 2048, "detection_threshold": -1e9, "nms_radius": 2},
}
CARD_MAP_TOL = 1e-4  # (a) dense maps, relative to their largest magnitude
CARD_KP_PX = 1e-3  # a CPU keypoint held by the card's nearest valid one
CARD_SLOT_SHARE = 0.99  # of the CPU's valid keypoints, and of equal validity
CARD_DESC_TOL = 1e-4  # descriptors and scores of the held keypoints
DENSE_VIEWS = 1  # (a) the feature maps (B, H, W, 128) compared on the first view
CHECK_PAIRS = 4  # (b) kernel against plain, (c) card against CPU
MATCH_SHARE = 0.99  # (b) match slots equal, kernel against plain path
CPU_THREADS = 4  # the CPU's side runs in a spawn process beside the card's work
# (d) the recipe cut in steps only: an epoch of 3 steps (train_size 96), an evaluation
# (1 validation pair) and checkpoint_0_3 at its end; then a --restore's first step
# against the first run's trainer taking the same step. The host dataset renders ~2.3 s
# a pair on a loader process: a fresh loader waits ~10 s for its first batch of 32, so
# the restored run takes the first run's last batch (HeldLoader) and starts none
TRAIN_CUTS = {"data": {"train_size": 96, "val_size": 1},
              "train": {"epochs": 2, "log_every_iter": 1}}
STEP0_LOSS_RTOL = 1e-4  # kernel against plain, card against CPU
STEP0_GRAD_RTOL = 1e-2  # card against CPU: each gradient within this share of its largest
STEP0_ITEMS = 2  # step 0's checks on the first batch's first items
TRAIN_TAG = "(d) aliked+lightglue_homography"
LAUNCHES_A_PAIR = {"attention_rotary": 18, "attention": 18}  # 9 layers x 2 views / 2 ways


# --- the models ---------------------------------------------------------------------------

def perturb_zero_kernels_(model, generator, scale: float = OFFSET_SCALE) -> int:
    """Draw every zero-initialised kernel of ``model`` (flax's
    ``kernel_init=zeros``: the deformable convolutions' and SDDH's offsets)
    from normal(0, ``scale``) with ``generator``. Returns how many."""
    import torch

    layers = [m for m in model.modules() if getattr(m, "zero_init", False)]
    with torch.no_grad():
        for layer in layers:
            layer.weight.copy_(torch.randn(layer.weight.shape, generator=generator) * scale)
    return len(layers)


def seeded_model(conf: dict, device, train: bool = False):
    """The model of ``conf`` built on the CPU under SEED, its extractor's zero
    kernels drawn at OFFSET_SCALE from a generator seeded by SEED, on ``device``."""
    import torch

    from gluefactory_torch.models import build_model

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(SEED)
        model = build_model(conf["name"], conf, device="cpu", train=train)
    extractor = getattr(model, "extractor", None) or model
    perturb_zero_kernels_(extractor, torch.Generator().manual_seed(SEED), OFFSET_SCALE)
    return model.to(device)


def numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy() if hasattr(tree, "detach") else tree


def tensor_tree(tree, device):
    import numpy as np
    import torch

    if isinstance(tree, dict):
        return {k: tensor_tree(v, device) for k, v in tree.items()}
    return torch.from_numpy(tree).to(device) if isinstance(tree, np.ndarray) else tree


def model_from_state(conf: dict, state: dict, device, train: bool = False):
    import torch

    from gluefactory_torch.models import build_model

    model = build_model(conf["name"], conf, device="cpu", train=train)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return model.to(device)


# --- (a) the extractors, card against CPU ----------------------------------------------------

A_KEYS = ("keypoints", "keypoint_valid", "keypoint_scores", "descriptors", "score_map")


def extract(conf: dict, state: dict, views, device: str, threads: int = 0) -> dict:
    """The extractor of ``conf`` (``state``, dense outputs) on each view: its
    sparse outputs and score map stacked, the feature maps of the first
    DENSE_VIEWS views."""
    import numpy as np
    import torch

    if threads:
        torch.set_num_threads(threads)
    model = model_from_state({**conf, "dense_outputs": True}, state, device)
    h, w = views.shape[1:3]
    out = {k: [] for k in (*A_KEYS, "descriptors_dense")}
    for i, view in enumerate(views):
        data = {"image": torch.from_numpy(view)[None].to(device),
                "image_size": torch.tensor([[w, h]], dtype=torch.float32, device=device)}
        with torch.inference_mode():
            pred = model(data)
        for k in A_KEYS + (("descriptors_dense",) if i < DENSE_VIEWS else ()):
            out[k].append(pred[k][0].cpu().numpy())
    return {k: np.stack(v) for k, v in out.items()}


def nearest(a, b, device):
    """For each row of ``a`` (n, d), the max-norm distance to its nearest row
    of ``b`` (m, d) and that row's index, computed on ``device``."""
    import torch

    d = torch.cdist(torch.from_numpy(a).to(device)[None], torch.from_numpy(b).to(device)[None],
                    p=float("inf"))[0]
    dist, j = d.min(1)
    return dist.cpu().numpy(), j.cpu().numpy()


def held_keypoints(card: dict, cpu: dict, compat: bool, device) -> dict:
    """Each CPU keypoint held to the card's nearest valid one (slots whose
    scores tie within the maps' error may swap: compared as sets), and the
    descriptors and scores of the held ones. The official SDDH reads an
    integer patch at the floor of the keypoint: where card and CPU fall on
    either side of an integer (within CARD_KP_PX) its descriptor is another
    function, so those are counted and not compared."""
    import numpy as np

    near, desc, score, flipped = [], [], [], 0
    for i in range(len(cpu["keypoints"])):
        vc, vg = cpu["keypoint_valid"][i], card["keypoint_valid"][i]
        kc, kg = cpu["keypoints"][i][vc], card["keypoints"][i][vg]
        if not len(kc) or not len(kg):
            near.append(np.full(len(kc), np.inf))
            continue
        dist, j = nearest(kc, kg, device)
        near.append(dist)
        held = dist <= CARD_KP_PX
        if compat:  # the patch corner of the official SDDH, in the unscaled frame
            h, w = cpu["score_map"].shape[1:3]
            scale = np.float32([(w - 1.0) / w, (h - 1.0) / h])
            same = (np.floor(kc * scale) == np.floor(kg[j] * scale)).all(-1)
            flipped += int((held & ~same).sum())
            held &= same
        desc.append(np.abs(cpu["descriptors"][i][vc][held]
                           - card["descriptors"][i][vg][j[held]]).max(initial=0.0))
        score.append(np.abs(cpu["keypoint_scores"][i][vc][held]
                            - card["keypoint_scores"][i][vg][j[held]]).max(initial=0.0))
    near = np.concatenate(near)
    held = near <= CARD_KP_PX
    return {"kp_share": float(held.mean()), "kp_px": float(near[held].max(initial=0.0)),
            "keypoints": int(len(near)), "desc": float(max(desc, default=0.0)),
            "score": float(max(score, default=0.0)),
            "floor_flips": flipped}


def card_against_cpu(card: dict, cpu: dict, compat: bool, device) -> dict:
    import numpy as np

    out = {}
    for key in ("score_map", "descriptors_dense"):
        scale = float(np.abs(cpu[key]).max())
        out[key] = float(np.abs(card[key] - cpu[key]).max()) / scale
    out["slot_share"] = float((card["keypoint_valid"] == cpu["keypoint_valid"]).mean())
    out.update(held_keypoints(card, cpu, compat, device))
    out["passes"] = bool(max(out["score_map"], out["descriptors_dense"]) <= CARD_MAP_TOL
                         and out["slot_share"] >= CARD_SLOT_SHARE
                         and out["kp_share"] >= CARD_SLOT_SHARE
                         and max(out["desc"], out["score"]) <= CARD_DESC_TOL)
    return out


# --- (b), (c) the HPatches runs ----------------------------------------------------------

class StageTimers:
    """Within ``with``: the synchronised ms of every call of the pipeline's
    extractor (both views) and matcher."""

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
        self.patched = [self.model.extractor, self.model.matcher]
        for module, name in zip(self.patched, ("aliked", "matcher")):
            module.forward = self._timed(name, module.forward)
        return self

    def __exit__(self, *exc):
        for module in self.patched:
            del module.forward  # back to the class's method


def run_conf(root: Path, name: str) -> dict:
    from gluefactory_torch.core.config import merge
    from gluefactory_torch.eval.hpatches import HPatchesPipeline
    from gluefactory_torch.recipes import aliked_conf

    data = {"data_dir": str(root / "hpatches" / "famA"), "max_seqs": ALIKED_SEQS}
    return merge(HPatchesPipeline.default_conf, merge(aliked_conf(name), {"data": data}))


def run_hpatches(name: str, conf: dict, model, out: Path, device) -> dict:
    """One HPatches run of ``model``: summaries, launches, ms a pair by stage."""
    import numpy as np
    import torch

    from gluefactory_torch.eval.hpatches import HPatchesPipeline
    from gluefactory_torch.ops import attention as A

    pipeline = HPatchesPipeline(conf, device=device)
    torch.cuda.reset_peak_memory_stats()
    A.reset_launches()
    with StageTimers(model, device) as timers:
        t = time.perf_counter()
        summaries, _ = pipeline.run(out, model=model, overwrite=True)
        seconds = time.perf_counter() - t
    launches = dict(A.launches)
    n = len(pipeline.timings["forward_ms"])
    stages = {f"{k}_ms": sum(v) / n for k, v in timers.ms.items()}
    stages["forward_ms"] = float(np.median(pipeline.timings["forward_ms"]))
    stages["sweep_ms"] = float(np.median(pipeline.timings["ransac_sweep_ms"]))
    report = {"pairs": n, "seconds": seconds, "pairs_per_s": n / seconds, "stages": stages,
              "launches": launches, "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
              "summaries": summaries}
    log(f"  ({'b' if name == RUNS[0] else 'c'}) {name}: {n} pairs in {seconds:.1f} s "
        f"({n / seconds:.2f} pairs/s, timers on; peak memory {report['peak_gib']:.2f} GiB); ms a "
        "pair by stage (synchronised; ALIKED both views; forward and sweep medians): "
        + ", ".join(f"{k[:-3]} {v:.2f}" for k, v in stages.items()) + f"; launches {launches}")
    log(f"  {name} summaries (initialised weights: printed, not held): {json.dumps(summaries)}")
    return report


def first_pairs(conf: dict, n: int) -> list:
    """The first ``n`` pairs of the run's loader as model inputs (numpy)."""
    from gluefactory_torch.eval.hpatches import HPatchesPipeline

    pipeline = HPatchesPipeline(conf, device="cpu")
    pairs = []
    for batch in pipeline.get_dataloader():
        pairs.append(numpy_tree(to_input(batch)))
        if len(pairs) == n:
            break
    return pairs


def to_input(batch):
    import torch

    from gluefactory_torch.eval.eval_pipeline import to_model_input

    return to_model_input(batch, torch.device("cpu"))


def match_pairs(conf: dict, state: dict, pairs: list, device: str, threads: int = 0) -> list:
    """(keypoints0, keypoints1, matches0) of the pipeline ``conf`` with
    ``state`` on each pair."""
    import torch

    if threads:
        torch.set_num_threads(threads)
    model = model_from_state(conf, state, device)
    out = []
    for pair in pairs:
        with torch.inference_mode():
            pred = model(tensor_tree(pair, device))
        out.append({k: pred[k].cpu().numpy() for k in ("keypoints0", "keypoints1", "matches0")})
    return out


def matched_points(pred: dict):
    """The matched keypoint pairs (M, 4) of one pair's prediction."""
    import numpy as np

    m = pred["matches0"][0]
    valid = m >= 0
    return np.concatenate([pred["keypoints0"][0][valid], pred["keypoints1"][0][m[valid]]], -1)


def same_matches(card: list, cpu: list, device) -> dict:
    """Matches card against CPU as sets of keypoint pairs (slots may swap
    at tied scores): the CPU's matches that a card match holds within
    CARD_KP_PX at both ends, as a share of all matches either side makes
    (at least MATCH_SHARE: a mutual nearest neighbour whose distances tie
    within the descriptors' error may go either way)."""
    counts, held = [], []
    for a, b in zip(card, cpu):
        pa, pb = matched_points(a), matched_points(b)
        counts.append((len(pa), len(pb)))
        if len(pb) and len(pa):
            held.append(int((nearest(pb, pa, device)[0] <= CARD_KP_PX).sum()))
        else:
            held.append(0)
    union = sum(max(c, g) for c, g in counts)
    share = sum(held) / union if union else 1.0
    return {"matches_card_cpu": counts, "cpu_held": held, "share": share,
            "equal": share >= MATCH_SHARE}


# --- (d) training ---------------------------------------------------------------------------

def step_grads(model, batch) -> tuple[float, dict]:
    """A training step without the update: (loss, LightGlue's gradients)."""
    model.zero_grad(set_to_none=True)
    losses, _ = model.loss(model(batch), batch)
    loss = losses["total"].mean()
    loss.backward()
    grads = {n: p.grad.detach().cpu().numpy() for n, p in model.matcher.named_parameters()
             if p.grad is not None}
    model.zero_grad(set_to_none=True)
    return float(loss.detach()), grads


def cpu_step_grads(conf: dict, state: dict, batch: dict, threads: int) -> tuple:
    """``step_grads`` on the CPU. The frozen extractor runs without autograd
    there (LightGlue's loss and gradients do not depend on its gradients;
    they would triple its CPU time)."""
    import torch

    torch.set_num_threads(threads)
    model = model_from_state(conf, state, "cpu", train=True)
    model.extractor.requires_grad_(False)
    t = time.perf_counter()
    loss, grads = step_grads(model, tensor_tree(batch, "cpu"))
    return loss, grads, time.perf_counter() - t


def set_attention(model, implementation: str) -> None:
    """LightGlue's attention layers on the kernels (``'auto'``) or the plain
    path (``'xla'``)."""
    layers = [m for m in model.modules() if hasattr(m, "attn_impl")]
    if not layers:
        raise AssertionError("no attention layer to switch")
    for module in layers:
        module.attn_impl = implementation


def first_items(batch, n: int):
    if isinstance(batch, dict):
        return {k: first_items(v, n) for k, v in batch.items()}
    return batch[:n] if hasattr(batch, "shape") and batch.ndim else batch


class FirstStep:
    """Within ``with``: before the first Trainer.step, ``check(trainer,
    item)``; the attention launches of every step and its ``last`` item."""

    def __init__(self, check):
        self.check, self.launches, self.last = check, [], None

    def __enter__(self):
        from gluefactory_torch import train
        from gluefactory_torch.ops import attention as A

        self.original = original = train.Trainer.step

        def step(trainer, item):
            if not self.launches:
                self.check(trainer, item)
            self.last = item
            counts = dict(A.launches)
            out = original(trainer, item)
            self.launches.append({k: A.launches[k] - counts[k] for k in counts})
            return out

        train.Trainer.step = step
        return self

    def __exit__(self, *exc):
        from gluefactory_torch import train

        train.Trainer.step = self.original


class HeldLoader:
    """Within ``with``: every Trainer's train loader yields ``item`` once (a
    batch already loaded), so that a run starts no loader processes."""

    def __init__(self, item):
        self.item = item

    def set_epoch(self, epoch: int) -> None:
        pass

    def __iter__(self):
        return iter([self.item])

    def __enter__(self):
        from gluefactory_torch import train

        self.original = train.Trainer.loader
        train.Trainer.loader = lambda trainer, split: self
        return self

    def __exit__(self, *exc):
        from gluefactory_torch import train

        train.Trainer.loader = self.original


def fmt_seconds(seconds: dict) -> str:
    return ", ".join(f"{k} {v:.1f}" for k, v in seconds.items())


class CallSeconds:
    """Within ``with``: the wall seconds of every call of each ``(owner,
    name)`` attribute, summed into ``seconds['<owner>.<name>']``."""

    def __init__(self, *targets):
        self.targets, self.seconds = targets, {}

    def __enter__(self):
        self.originals = [getattr(owner, name) for owner, name in self.targets]
        for (owner, name), fn in zip(self.targets, self.originals):
            label = f"{owner.__name__.rsplit('.', 1)[-1]}.{name}"
            setattr(owner, name, self._timed(label, fn))
        return self

    def _timed(self, name: str, fn):
        def run(*args, **kwargs):
            t = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.seconds[name] = self.seconds.get(name, 0.0) + time.perf_counter() - t
        return run

    def __exit__(self, *exc):
        for (owner, name), fn in zip(self.targets, self.originals):
            setattr(owner, name, fn)


def check_training(device, root: Path, cpu_pool) -> tuple:
    """(d): the recipe from the seeded initialisation (saved as a checkpoint
    that ``train.load_experiment`` restores); step 0 on the first batch's first
    STEP0_ITEMS items on the kernel and plain paths and card against CPU; an
    epoch of 3 steps with the loader's wait, the step time and peak memory,
    an evaluation and checkpoint_0_3; a --restore from it on the first run's
    last batch, whose parameters and optimizer state are the checkpoint's bit
    for bit and whose first step is the first run's trainer's on the same
    batch bit for bit (the loss and every parameter after it). Returns the
    launches, the report and the CPU's step-0 job (``step0_card_against_cpu``)."""
    import argparse
    import shutil

    import numpy as np
    import torch

    from gluefactory_torch import train
    from gluefactory_torch.core.config import merge
    from gluefactory_torch.ops import attention as A
    from gluefactory_torch.recipes import aliked_lightglue_homography_conf
    from gluefactory_torch.train import training
    from gluefactory_torch.utils.experiments import save_experiment, state_to_flat_dict
    from gluefactory_torch.utils.weights import decode_msgpack

    tag = TRAIN_TAG
    conf = aliked_lightglue_homography_conf()
    init = seeded_model(conf["model"], "cpu", train=True)
    save_experiment(root / "init", {"params": init}, conf, 0, 0, cp_name="init.ckpt")
    conf = merge(conf, merge(TRAIN_CUTS, {"train": {"load_experiment": str(root / "init" /
                                                                           "init.ckpt")}}))
    report, jobs = {}, {}

    def first_batch_checks(trainer, item):
        model = trainer.model
        items = first_items(trainer.batch(trainer.pool, item), STEP0_ITEMS)
        losses, check_s = {}, {}
        for impl in ("xla", "auto"):
            set_attention(model, impl)
            t = time.perf_counter()
            losses[impl], grads = step_grads(model, items)
            check_s[impl] = time.perf_counter() - t
        jobs["cpu"] = cpu_pool.submit(cpu_step_grads, conf["model"],
                                      numpy_tree(model.state_dict()), numpy_tree(items),
                                      CPU_THREADS)
        rel = abs(losses["auto"] - losses["xla"]) / abs(losses["xla"])
        report["step0"] = {"loss_kernel": losses["auto"], "loss_plain": losses["xla"],
                           "loss_rel": rel, "card_items": (losses["auto"], grads)}
        log(f"  {tag} step 0 on the first batch's first {STEP0_ITEMS} pairs "
            f"({item['view0']['image'].shape[1]} px): loss {losses['auto']:.6f} on the kernel "
            f"path, {losses['xla']:.6f} on the plain path ({rel:.2g} relative, tolerance "
            f"{STEP0_LOSS_RTOL}); the plain path's step {check_s['xla']:.1f} s (this process's "
            f"first ALIKED backward), the kernel path's {check_s['auto']:.1f} s")
        if not rel <= STEP0_LOSS_RTOL:
            raise AssertionError(f"{tag} step 0: kernel against plain {rel:.3g} relative")

    run, resumed = root / "train", root / "train_restored"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timed = ((train.Trainer, "__init__"), (train, "do_evaluation"), (train, "save_experiment"))
    t = time.perf_counter()
    with FirstStep(first_batch_checks) as watch, CallSeconds(*timed) as calls:
        first, history = training(merge(conf, {"train": {"epochs": 1}}), run, device=device)
    seconds = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated() / 2**30
    bad = [(i, k) for i, h in enumerate(history) for k, v in h.items() if not np.isfinite(v)]
    if bad or any(h["skipped"] for h in history):
        raise AssertionError(f"{tag} steps: non-finite {bad}")
    n_layers = first.model.matcher.conf["n_layers"]
    expected = {"attention_rotary": 4 * n_layers, "attention": 4 * n_layers}
    frozen = [n for n, p in first.model.extractor.state_dict().items()
              if not torch.equal(p.cpu(), init.extractor.state_dict()[n])]
    report["steps"] = {"ms": [h["ms"] for h in history], "data_ms": [h["data_ms"] for h in history],
                       "losses": [h["loss/total"] for h in history], "peak_gib": peak,
                       "seconds": seconds, "calls_s": calls.seconds}
    log(f"  {tag}: {len(history)} steps in {seconds:.1f} s (with step 0's checks, an evaluation "
        f"and a checkpoint; seconds in {fmt_seconds(calls.seconds)}): losses "
        f"{[round(h['loss/total'], 4) for h in history]}; step "
        f"{[round(h['ms'], 1) for h in history]} ms (the first with step 0's checks), the wait "
        f"for the loader before it {[round(h['data_ms'], 1) for h in history]} ms (host clock); "
        f"peak memory {peak:.2f} GiB; launches {watch.launches} ({n_layers} layers, 2 + 2 in "
        f"each forward and again in its checkpointed recompute); ALIKED frozen: {len(frozen)} of "
        "its parameters moved")
    if frozen or watch.launches != [expected] * len(history):
        raise AssertionError(f"{tag}: frozen parameters moved {frozen[:4]}; launches "
                             f"{watch.launches}, expected {expected} a step")

    # --restore from checkpoint_0_3: the state as saved, then the same step as the first
    # run's trainer, both on the first run's last batch
    resumed.mkdir()
    shutil.copy(run / "checkpoint_0_3.ckpt", resumed)
    shutil.copy(run / "config.yaml", resumed)
    saved = decode_msgpack((run / "checkpoint_0_3.ckpt").read_bytes())["state"]
    compared = []

    def same_as_saved(trainer, item):
        if item is not watch.last:
            raise AssertionError(f"{tag}: the restored run did not take the held batch")
        for part, obj in trainer.state().items():
            now = state_to_flat_dict(obj)
            same = now.keys() == saved[part].keys() and all(
                v.dtype == saved[part][k].dtype and np.array_equal(v, saved[part][k])
                for k, v in now.items())
            if not same:
                raise AssertionError(f"{tag}: restored {part} differs from the checkpoint")
            compared.append(len(now))

    t = time.perf_counter()
    with FirstStep(same_as_saved) as restored_watch, HeldLoader(watch.last), \
            CallSeconds(*timed) as restored_calls:
        again, restored = training(conf, resumed, argparse.Namespace(restore=True),
                                   device=device, steps=1)
    counts = dict(A.launches)
    continued = first.step(watch.last)
    torch.cuda.synchronize()
    continued_launches = {k: A.launches[k] - counts[k] for k in counts}
    ours, theirs = first.model.state_dict(), again.model.state_dict()
    moved = [n for n in ours if not torch.equal(ours[n], theirs[n])]
    equal_loss = restored[0]["loss/total"] == continued["loss/total"]
    report["restore"] = {"parameters": compared[0], "optimizer_arrays": compared[1],
                         "loss": restored[0]["loss/total"],
                         "loss_continued": continued["loss/total"],
                         "parameters_differing": len(moved), "seconds": time.perf_counter() - t,
                         "step_ms": restored[0]["ms"], "calls_s": restored_calls.seconds}
    log(f"  {tag} --restore from checkpoint_0_3 on the first run's last batch: {compared[0]} "
        f"parameters and {compared[1]} optimizer arrays bit for bit; its first step "
        f"({restored[0]['ms']:.1f} ms) loss {restored[0]['loss/total']:.9g}, the first run's "
        f"trainer on the same batch {continued['loss/total']:.9g}; {len(ours) - len(moved)} of "
        f"{len(ours)} parameters after it bit for bit ({report['restore']['seconds']:.1f} s; "
        f"seconds in {fmt_seconds(restored_calls.seconds)})")
    if not equal_loss or moved or restored_watch.launches != [expected] or \
            continued_launches != expected:
        raise AssertionError(f"{tag} restore: {report['restore']}, parameters {moved[:4]}, "
                             f"launches {restored_watch.launches} / {continued_launches}")
    launches = {"aliked_train": {k: sum(s[k] for s in watch.launches) + 2 * expected[k]
                                 for k in expected}}

    return launches, report, jobs["cpu"]


def step0_card_against_cpu(step0: dict, job) -> bool:
    """(d)'s step 0 on the card (``step0['card_items']``) against the CPU's
    ``job`` (``cpu_step_grads``): the loss and LightGlue's gradients."""
    import numpy as np

    card_loss, card_g = step0.pop("card_items")
    cpu_loss, cpu_g, cpu_s = job.result()
    errs = {n: float(np.abs(card_g[n] - g).max()) / max(float(np.abs(g).max()), 1e-30)
            for n, g in cpu_g.items()}
    worst = max(errs, key=errs.get)
    rel = abs(card_loss - cpu_loss) / abs(cpu_loss)
    step0.update(card_cpu_loss_rel=rel, card_cpu_worst=errs[worst], worst_param=worst, cpu_s=cpu_s)
    log(f"  {TRAIN_TAG} step 0 on the first batch's first {STEP0_ITEMS} pairs: loss "
        f"{card_loss:.6f} on the card, {cpu_loss:.6f} on the CPU ({rel:.2g} relative, tolerance "
        f"{STEP0_LOSS_RTOL}); {len(errs)} LightGlue gradients within {errs[worst]:.2g} of their "
        f"largest ({worst}; tolerance {STEP0_GRAD_RTOL}); the CPU's step {cpu_s:.1f} s")
    return (rel <= STEP0_LOSS_RTOL and errs[worst] <= STEP0_GRAD_RTOL
            and card_g.keys() == cpu_g.keys())


# --- phase 3's K1/K2 at LightGlue's 2048-keypoint shape -----------------------------------

KERNEL_SHAPE = (1, 4, 2048, 2048, 64)  # aliked+lightglue's self- and cross-attention, f32


def check_kernels_2048(device, results: list) -> None:
    """K1 and K2 at KERNEL_SHAPE in float32, every key valid (as in
    aliked+lightglue, whose 2048 slots are all filled): against
    the plain version (phase 3's tolerance), against float64 (no worse than
    the plain version), timed beside the plain version and SDPA (q
    pre-rotated for K1), with the 3xTF32 bound. Appended to each kernel's
    ``times_by_shape``."""
    import torch
    import torch.nn.functional as F

    from chip_smoke import (
        TOLERANCES,
        _attention_inputs,
        attention_bounds,
        errors,
        exact,
        graph_ms,
    )
    from gluefactory_torch.ops import attention as A

    kernels = {"attention_rotary": (A.attention_rotary_cuda, A.attention_rotary_plain, True),
               "attention": (A.attention_cuda, A.attention_plain, False)}
    gen = torch.Generator(device=device).manual_seed(SEED)
    b, h, n, _, d = KERNEL_SHAPE
    for r in results:
        if r["name"] not in kernels:
            continue
        kernel, plain, rotary = kernels[r["name"]]
        args = _attention_inputs(b, h, n, n, d, torch.float32, rotary, gen, device)
        mask = args[-1].fill_(True)
        out, ref = kernel(*args), plain(*args)
        err = float((out - ref).abs().max())
        atol, rtol = TOLERANCES["float32"]
        if not bool(((out - ref).abs() <= atol + rtol * ref.abs()).all()):
            raise AssertionError(f"{r['name']} at {KERNEL_SHAPE}: max |err| {err:.3g}")
        f64 = exact(args, rotary)
        k_err, p_err = errors(out, f64), errors(ref, f64)
        if k_err["max"] > p_err["max"] or k_err["rms"] > p_err["rms"]:
            raise AssertionError(f"{r['name']} at {KERNEL_SHAPE}: float32 error against "
                                 f"float64 above the plain version's: {k_err} against {p_err}")
        q_lib = A.apply_rotary(args[0], args[3], args[4]) if rotary else args[0]
        ms = graph_ms(lambda: kernel(*args))
        plain_ms = graph_ms(lambda: plain(*args))
        library_ms = graph_ms(lambda: F.scaled_dot_product_attention(
            q_lib, args[1], args[2], attn_mask=mask[:, None, None, :]))
        nbytes = sum(t.numel() * t.element_size() for t in args) + args[0].numel() * 4
        t_tf32, t_f32, t_bytes = attention_bounds(b, h, n, n, d, nbytes)
        bound = max(t_tf32, t_bytes)
        r["times_by_shape"].append({
            "shape": list(KERNEL_SHAPE), "path": "aliked+lightglue (2048 keypoints)", "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound,
            "bound_by": "operations" if t_tf32 >= t_bytes else "bytes",
            "bound_ms_cuda_cores": t_f32, "max_abs_err": err, "vs_float64": k_err,
            "plain_vs_float64": p_err})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        log(f"  {r['name']:17s} f32 B,H,N,D={b},{h},{n},{d} (aliked+lightglue): max |err| "
            f"{err:.3g} ok; against float64 kernel max {k_err['max']:.3g} rms {k_err['rms']:.3g}, "
            f"plain max {p_err['max']:.3g} rms {p_err['rms']:.3g}; kernel {ms * 1e3:.1f} us, "
            f"plain {plain_ms * 1e3:.1f} us, SDPA {library_ms * 1e3:.1f} us "
            f"({library_ms / ms:.2f}x the kernel), bound {bound * 1e3:.2f} us 3xTF32 "
            f"({bound / ms:.1%})")


# --- phase 24 -------------------------------------------------------------------------------

def check_aliked(device, root: Path, gate_root: Path) -> dict:
    """Phase 24 (a)-(d) of the module docstring. ``root`` holds phase 8's
    HPatches sets under ``hpatches``; ``gate_root`` phase 4's gate views.
    Returns {path: K1/K2 launches}."""
    import multiprocessing
    import subprocess
    from concurrent.futures import ProcessPoolExecutor

    import torch

    from chip_smoke_jpldd import gate_views
    from gluefactory_torch.core.config import merge

    t0 = time.perf_counter()
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=10).stdout.strip()
    except OSError as e:
        smi = f"no nvidia-smi ({e})"
    log(f"  on {smi}; seed {SEED}, offsets drawn at {OFFSET_SCALE}")
    failures, report, launches = [], {}, {}
    views = gate_views(gate_root)
    states = {name: numpy_tree(seeded_model(conf, "cpu").state_dict())
              for name, conf in CARD_CONFS.items()}
    confs = {name: run_conf(root, name) for name in RUNS}
    # (d) first: its host loader fills the cores while it waits, and the CPU's sides of
    # (a), (c) and (d)'s step 0 run on 2 spawn workers beside the card's (a)-(c), read last
    with ProcessPoolExecutor(2, mp_context=multiprocessing.get_context("spawn")) as pool:
        t = time.perf_counter()
        train_launches, report["training"], step0_cpu = check_training(
            device, root / "aliked_train", pool)
        launches.update(train_launches)
        report["training"]["seconds"] = time.perf_counter() - t
        torch.cuda.empty_cache()

        # (a)
        cpu_a = {name: pool.submit(extract, CARD_CONFS[name], states[name], views, "cpu",
                                   CPU_THREADS) for name in CARD_CONFS}
        card_a = {name: extract(CARD_CONFS[name], states[name], views, str(device))
                  for name in CARD_CONFS}

        # (b), (c)
        pairs = first_pairs(confs[RUNS[0]], CHECK_PAIRS)
        cpu_c = {}
        for name in RUNS:
            model = seeded_model(confs[name]["model"], device)
            if name != RUNS[0]:
                state = numpy_tree(model.state_dict())
                checked = merge(confs[name]["model"], CHECK_OVERRIDES.get(name))
                cpu_c[name] = pool.submit(match_pairs, checked, state, pairs, "cpu", CPU_THREADS)
                report[f"{name}_card_pairs"] = match_pairs(checked, state, pairs, str(device))
            report[name] = run_hpatches(name, confs[name], model, root / f"aliked_{name}",
                                        device)
            if name == RUNS[0]:
                counts, n = report[name]["launches"], report[name]["pairs"]
                launches["aliked_hpatches"] = counts
                if counts != {k: v * n for k, v in LAUNCHES_A_PAIR.items()}:
                    failures.append(f"(b) launches {counts} over {n} pairs, expected "
                                    f"{LAUNCHES_A_PAIR} a pair")
                report["kernel_vs_plain"] = kernel_against_plain(confs[name]["model"], model,
                                                                 pairs, device)
                if report["kernel_vs_plain"]["share"] < MATCH_SHARE:
                    failures.append(f"(b) kernel against plain: {report['kernel_vs_plain']}")
            elif report[name]["launches"] != {"attention_rotary": 0, "attention": 0}:
                failures.append(f"({name}) launches {report[name]['launches']}")
            del model

        for name in RUNS[1:]:
            same = same_matches(report.pop(f"{name}_card_pairs"), cpu_c[name].result(), device)
            report[f"{name}_card_vs_cpu"] = same
            log(f"  (c) {name} on the first {CHECK_PAIRS} pairs"
                + (f" ({CHECK_OVERRIDES[name]})" if name in CHECK_OVERRIDES else "")
                + ", card against CPU: matches "
                f"(card, CPU) {same['matches_card_cpu']}, the CPU's held by the card within "
                f"{CARD_KP_PX} px at both ends {same['cpu_held']}: {same['share']:.4f} of them "
                f"(at least {MATCH_SHARE}) {'ok' if same['equal'] else 'DIFFER'}")
            if not same["equal"]:
                failures.append(f"(c) {name} card against CPU: {same}")
        t = time.perf_counter()
        if not step0_card_against_cpu(report["training"]["step0"], step0_cpu):
            failures.append(f"{TRAIN_TAG} step 0, card against CPU: {report['training']['step0']}")
        cpu_a = {name: job.result() for name, job in cpu_a.items()}
        wait = time.perf_counter() - t
    for name, conf in CARD_CONFS.items():
        a = report[f"card_vs_cpu_{name}"] = card_against_cpu(card_a[name], cpu_a[name],
                                                             bool(conf.get("compat")), device)
        log(f"  (a) {name} ({conf['max_num_keypoints']} slots) on the gate's {len(views)} views "
            f"({views.shape[2]}x{views.shape[1]}), card against CPU: score map {a['score_map']:.2g}"
            f", feature map {a['descriptors_dense']:.2g} of their largest (tolerance "
            f"{CARD_MAP_TOL}; the feature map on {DENSE_VIEWS} view); validity equal on "
            f"{a['slot_share']:.4f} of slots; the CPU's {a['keypoints']} keypoints held within "
            f"{CARD_KP_PX} px by the card: {a['kp_share']:.4f} (within {a['kp_px']:.2g} px; both "
            f"at least {CARD_SLOT_SHARE}); their descriptors within {a['desc']:.2g}, scores "
            f"{a['score']:.2g} (tolerance {CARD_DESC_TOL}); "
            + (f"{a['floor_flips']} on either side of an integer (the official SDDH's patch), "
               "not compared; " if conf.get("compat") else "")
            + f"the CPU's side waited for {wait:.1f} s")
        if not a["passes"]:
            failures.append(f"(a) {name}: {a}")
    report["seconds"] = time.perf_counter() - t0
    log(f"  phase 24 took {report['seconds']:.1f} s")
    if failures:
        raise AssertionError(f"ALIKED: {failures}")
    return launches


def kernel_against_plain(conf: dict, model, pairs: list, device) -> dict:
    """(b) aliked+lightglue's match slots on the kernel path against the
    plain path (the same model, ``attention: 'xla'``) on ``pairs``, with the
    filter at 0 (initialised weights score no match above the card's 0.1:
    the mutual argmax of the assignment is compared)."""
    import numpy as np
    import torch

    threshold = model.matcher.conf["filter_threshold"]
    model.matcher.conf["filter_threshold"] = 0.0
    preds = {}
    for impl in ("xla", "auto"):
        set_attention(model, impl)
        preds[impl] = []
        for pair in pairs:
            with torch.inference_mode():
                preds[impl].append(model(tensor_tree(pair, device))["matches0"].cpu().numpy())
    set_attention(model, "auto")
    model.matcher.conf["filter_threshold"] = threshold
    a, b = np.concatenate(preds["auto"], 1), np.concatenate(preds["xla"], 1)
    out = {"share": float((a == b).mean()), "matches_kernel": int((a >= 0).sum()),
           "matches_plain": int((b >= 0).sum())}
    log(f"  (b) kernel against plain path on the first {len(pairs)} pairs (filter at 0): "
        f"{out['share']:.4f} of {a.size} match slots equal (at least {MATCH_SHARE}); "
        f"{out['matches_kernel']} / {out['matches_plain']} matches")
    return out


def main() -> int:
    """Phase 24 alone, on phase 8's famA (its first ALIKED_SEQS sequences)
    and the gate views rendered here: ``python3 chip_smoke_aliked.py``."""
    import multiprocessing
    import sys
    import tempfile
    from concurrent.futures import ProcessPoolExecutor

    import torch

    from chip_smoke import RENDER_WORKERS, gate_pairs
    from gluefactory_torch.ops import attention as A
    from gluefactory_torch.ops import kernels
    from gluefactory_torch.scripts.generate_eval_set import render_job, sequence_jobs

    if not torch.cuda.is_available():
        print("chip_smoke_aliked: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    device = torch.device("cuda", 0)
    kernels.build_all([A.SOURCE])
    with tempfile.TemporaryDirectory(prefix="chip_smoke_aliked_") as tmp:
        root = Path(tmp)
        with ProcessPoolExecutor(RENDER_WORKERS,
                                 mp_context=multiprocessing.get_context("spawn")) as pool:
            jobs = [pool.submit(render_job, root / "hpatches" / "famA", (640, 480), "a", job)
                    for job in sequence_jobs(ALIKED_SEQS, 0, "a")]
            for job in jobs:
                job.result()
        gate_pairs(root / "gate", device)
        results = [{"name": name, "times_by_shape": [], "max_abs_err": 0.0}
                   for name in ("attention_rotary", "attention")]
        check_kernels_2048(device, results)
        log(f"  launches {check_aliked(device, root, root / 'gate')}")
    return 0


if __name__ == "__main__":
    import sys

    import chip_smoke

    sys.modules.setdefault("chip_smoke", chip_smoke)
    sys.exit(main())
