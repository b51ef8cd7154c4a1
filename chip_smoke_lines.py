"""Phase 20 of chip_smoke.py, the line benchmarks on the card: HPatches-lines,
RDNIM-lines and Wireframe at the committed confs' full width with LSD, LSD+LBD,
ELSED, SOLD2+Wunsch and GlueStick, each held to the JAX package's summaries on
the same sets (check_lines). Run through ``python3 chip_smoke.py``; the helpers
it shares with the other phases are chip_smoke's."""

from __future__ import annotations

import hashlib
import json
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from chip_smoke import RENDER_WORKERS, _batches, log

# --- the runs -------------------------------------------------------------------------

HP_SEQS = 8  # (a) famA's first 8 sequences of phase 8's set (40 pairs)
RDNIM_SET = {"num_pairs": 20, "size": (640, 480), "seed": 314159}  # the renderer's defaults
WIREFRAME_SET = {"num_images": 30, "size": (512, 512), "seed": 161803}  # likewise
# (run, benchmark, conf of recipes.LINE_CONFS, the set it reads)
LINE_RUNS = [
    ("hp_lsd_lines", "hpatches_lines", "lsd_lines", "hpatches"),
    ("hp_lsd_lbd", "hpatches_lines", "lsd_lbd", "hpatches"),
    ("hp_elsed_lines", "hpatches_lines", "elsed_lines", "hpatches"),
    ("hp_sold2_wunsch", "hpatches_lines", "sold2_wunsch", "hpatches"),
    ("hp_gluestick_stage0", "hpatches_lines", "gluestick_stage0", "hpatches"),
    ("rdnim_day_lsd_lbd", "rdnim_lines", "lsd_lbd", "rdnim_day"),
    ("rdnim_night_lsd_lbd", "rdnim_lines", "lsd_lbd", "rdnim_night"),
    ("rdnim_day_sold2_wunsch", "rdnim_lines", "sold2_wunsch", "rdnim_day"),
    ("rdnim_night_sold2_wunsch", "rdnim_lines", "sold2_wunsch", "rdnim_night"),
    ("wf_lsd", "wireframe", "lsd", "wireframe"),
    ("wf_sold2", "wireframe", "sold2", "wireframe"),
]


def run_data(root: Path, which: str) -> dict:
    """The ``data`` overrides of a run's set under ``root`` (as phase 20
    renders them)."""
    if which == "hpatches":
        return {"data_dir": str(root / "hpatches" / "famA"), "max_seqs": HP_SEQS}
    if which.startswith("rdnim_"):
        return {"data_dir": str(root / "rdnim"), "reference": which.split("_")[1]}
    return {"data_dir": str(root / "wireframe")}


def render_line_sets(root: Path, hpatches: bool = False) -> float:
    """The RDNIM and Wireframe sets at their renderers' defaults under
    ``root`` (and famA's first HP_SEQS sequences at 640x480 when
    ``hpatches``: phase 8 renders them on the card's run), in spawn
    processes; returns the seconds it took."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from gluefactory_torch.scripts.generate_eval_set import render_job, sequence_jobs
    from gluefactory_torch.scripts.generate_rdnim_set import render_pair
    from gluefactory_torch.scripts.generate_wireframe_set import render_image

    t = time.perf_counter()
    (root / "wireframe" / "test").mkdir(parents=True, exist_ok=True)
    context = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(RENDER_WORKERS, mp_context=context) as pool:
        jobs = [pool.submit(render_pair, root / "rdnim", i, RDNIM_SET["num_pairs"],
                            RDNIM_SET["size"], RDNIM_SET["seed"])
                for i in range(RDNIM_SET["num_pairs"])]
        jobs += [pool.submit(render_image, root / "wireframe" / "test", i,
                             WIREFRAME_SET["size"], WIREFRAME_SET["seed"])
                 for i in range(WIREFRAME_SET["num_images"])]
        if hpatches:
            jobs += [pool.submit(render_job, root / "hpatches" / "famA", (640, 480), "a", job)
                     for job in sequence_jobs(HP_SEQS, 0, "a")]
        for job in jobs:
            job.result()
    return time.perf_counter() - t


# --- the JAX package's numbers ------------------------------------------------------------

# The JAX package's summaries of each run on the same sets, on the CPU, RANSAC seed 0
# (JAX_PLATFORMS=cpu PYTHONPATH=.:tests python tests/test_torch_line_metrics.py --root <dir>
# --render --out <dir>: it renders the sets as phase 20 does and prints one JSON line a
# run and seed); LINES_H_AUC_SEEDS: the line RANSAC's AUCs over JAX's seeds 0-2
LINES_JAX = {
    "hp_lsd_lines": {
        "mnum_lines0": 80.425, "mnum_lines1": 88.125, "morth_rep@1.0": 0.7306,
        "morth_rep@3.0": 0.7932, "morth_rep@5.0": 0.806, "morth_loc@3.0": 0.2869,
        "morth_loc@5.0": 0.3366, "mstruct_rep@1.0": 0.5196, "mstruct_rep@3.0": 0.6496,
        "mstruct_rep@5.0": 0.6887, "mstruct_loc@3.0": 0.7536, "mstruct_loc@5.0": 0.9384},
    "hp_lsd_lbd": {
        "mnum_lines0": 80.425, "mnum_lines1": 88.125, "morth_rep@1.0": 0.7306,
        "morth_rep@3.0": 0.7932, "morth_rep@5.0": 0.806, "morth_loc@3.0": 0.2869,
        "morth_loc@5.0": 0.3366, "mstruct_rep@1.0": 0.5196, "mstruct_rep@3.0": 0.6496,
        "mstruct_rep@5.0": 0.6887, "mstruct_loc@3.0": 0.7536, "mstruct_loc@5.0": 0.9384,
        "mline_match_precision": 0.5478, "mline_match_recall": 0.3044,
        "mnum_line_matches": 38.7, "mH_error_lines": 101.3869, "H_error_lines@1px": 0.2965,
        "H_error_lines@3px": 0.5617, "H_error_lines@5px": 0.6632},
    "hp_elsed_lines": {
        "mnum_lines0": 98.375, "mnum_lines1": 102.325, "morth_rep@1.0": 0.4493,
        "morth_rep@3.0": 0.6511, "morth_rep@5.0": 0.6995, "morth_loc@3.0": 0.8372,
        "morth_loc@5.0": 1.0455, "mstruct_rep@1.0": 0.212, "mstruct_rep@3.0": 0.5031,
        "mstruct_rep@5.0": 0.6043, "mstruct_loc@3.0": 1.313, "mstruct_loc@5.0": 1.734},
    "hp_sold2_wunsch": {
        "mnum_lines0": 415.9, "mnum_lines1": 398.55, "morth_rep@1.0": 0.4444,
        "morth_rep@3.0": 0.6282, "morth_rep@5.0": 0.6865, "morth_loc@3.0": 0.8711,
        "morth_loc@5.0": 1.1526, "mstruct_rep@1.0": 0.3186, "mstruct_rep@3.0": 0.6461,
        "mstruct_rep@5.0": 0.6697, "mstruct_loc@3.0": 1.1085, "mstruct_loc@5.0": 1.2007,
        "mline_match_precision": 0.5587, "mline_match_recall": 0.4359,
        "mnum_line_matches": 279.8, "mH_error_lines": 3.379, "H_error_lines@1px": 0.0266,
        "H_error_lines@3px": 0.3241, "H_error_lines@5px": 0.5116},
    "hp_gluestick_stage0": {
        "mnum_lines0": 80.35, "mnum_lines1": 87.575, "morth_rep@1.0": 0.7063,
        "morth_rep@3.0": 0.7973, "morth_rep@5.0": 0.8071, "morth_loc@3.0": 0.4631,
        "morth_loc@5.0": 0.4999, "mstruct_rep@1.0": 0.4888, "mstruct_rep@3.0": 0.6452,
        "mstruct_rep@5.0": 0.6876, "mstruct_loc@3.0": 0.7604, "mstruct_loc@5.0": 0.9558,
        "mline_match_precision": 0.7937, "mline_match_recall": 0.5806,
        "mnum_line_matches": 51.9, "mH_error_lines": 1.4375, "H_error_lines@1px": 0.2131,
        "H_error_lines@3px": 0.6154, "H_error_lines@5px": 0.7371},
    "rdnim_day_lsd_lbd": {
        "mnum_lines0": 74.2, "mnum_lines1": 44.75, "morth_rep@1.0": 0.6754,
        "morth_rep@3.0": 0.7166, "morth_rep@5.0": 0.7213, "morth_loc@3.0": 0.4076,
        "morth_loc@5.0": 0.4322, "mstruct_rep@1.0": 0.3794, "mstruct_rep@3.0": 0.6009,
        "mstruct_rep@5.0": 0.6435, "mstruct_loc@3.0": 0.9421, "mstruct_loc@5.0": 1.1442,
        "mline_match_precision": 0.3304, "mline_match_recall": 0.1745,
        "mnum_line_matches": 18.1, "mH_error_lines": 267.8553, "H_error_lines@1px": 0.0829,
        "H_error_lines@3px": 0.1562, "H_error_lines@5px": 0.1979},
    "rdnim_night_lsd_lbd": {
        "mnum_lines0": 42.35, "mnum_lines1": 79.25, "morth_rep@1.0": 0.7309,
        "morth_rep@3.0": 0.7908, "morth_rep@5.0": 0.8021, "morth_loc@3.0": 0.451,
        "morth_loc@5.0": 0.4959, "mstruct_rep@1.0": 0.4167, "mstruct_rep@3.0": 0.6495,
        "mstruct_rep@5.0": 0.6903, "mstruct_loc@3.0": 0.9474, "mstruct_loc@5.0": 1.1163,
        "mline_match_precision": 0.3456, "mline_match_recall": 0.1719,
        "mnum_line_matches": 16.75, "mH_error_lines": 109.799, "H_error_lines@1px": 0.0347,
        "H_error_lines@3px": 0.1137, "H_error_lines@5px": 0.1574},
    "rdnim_day_sold2_wunsch": {
        "mnum_lines0": 414.8, "mnum_lines1": 408.85, "morth_rep@1.0": 0.2544,
        "morth_rep@3.0": 0.4546, "morth_rep@5.0": 0.5341, "morth_loc@3.0": 1.0977,
        "morth_loc@5.0": 1.5285, "mstruct_rep@1.0": 0.1315, "mstruct_rep@3.0": 0.4193,
        "mstruct_rep@5.0": 0.4578, "mstruct_loc@3.0": 1.3829, "mstruct_loc@5.0": 1.5857,
        "mline_match_precision": 0.1823, "mline_match_recall": 0.103,
        "mnum_line_matches": 134.95, "mH_error_lines": 236.4542, "H_error_lines@1px": 0.0,
        "H_error_lines@3px": 0.1607, "H_error_lines@5px": 0.2289},
    "rdnim_night_sold2_wunsch": {
        "mnum_lines0": 385.6, "mnum_lines1": 439.1, "morth_rep@1.0": 0.2562,
        "morth_rep@3.0": 0.433, "morth_rep@5.0": 0.4976, "morth_loc@3.0": 1.0357,
        "morth_loc@5.0": 1.443, "mstruct_rep@1.0": 0.131, "mstruct_rep@3.0": 0.417,
        "mstruct_rep@5.0": 0.4386, "mstruct_loc@3.0": 1.3236, "mstruct_loc@5.0": 1.4628,
        "mline_match_precision": 0.1723, "mline_match_recall": 0.0932,
        "mnum_line_matches": 141.75, "mH_error_lines": 225.9975, "H_error_lines@1px": 0.0,
        "H_error_lines@3px": 0.089, "H_error_lines@5px": 0.1614},
    "wf_lsd": {
        "mnum_lines": 106.2, "mnum_gt_lines": 57.233, "mstruct_rep@1.0px": 0.125,
        "mstruct_prec@1.0px": 0.074, "mstruct_recall@1.0px": 0.125, "mstruct_rep@3.0px": 0.205,
        "mstruct_prec@3.0px": 0.121, "mstruct_recall@3.0px": 0.205, "mstruct_rep@5.0px": 0.216,
        "mstruct_prec@5.0px": 0.128, "mstruct_recall@5.0px": 0.216, "mstruct_loc@3.0px": 1.049,
        "mstruct_loc@5.0px": 1.185, "morth_rep@1.0px": 0.272, "morth_prec@1.0px": 0.162,
        "morth_recall@1.0px": 0.272, "morth_rep@3.0px": 0.308, "morth_prec@3.0px": 0.183,
        "morth_recall@3.0px": 0.308, "morth_rep@5.0px": 0.31, "morth_prec@5.0px": 0.184,
        "morth_recall@5.0px": 0.31, "morth_loc@3.0px": 0.691, "morth_loc@5.0px": 0.724},
    "wf_sold2": {
        "mnum_lines": 465.467, "mnum_gt_lines": 57.233, "mstruct_rep@1.0px": 0.315,
        "mstruct_prec@1.0px": 0.04, "mstruct_recall@1.0px": 0.315, "mstruct_rep@3.0px": 0.443,
        "mstruct_prec@3.0px": 0.056, "mstruct_recall@3.0px": 0.443, "mstruct_rep@5.0px": 0.477,
        "mstruct_prec@5.0px": 0.061, "mstruct_recall@5.0px": 0.477, "mstruct_loc@3.0px": 0.793,
        "mstruct_loc@5.0px": 1.032, "morth_rep@1.0px": 0.494, "morth_prec@1.0px": 0.064,
        "morth_recall@1.0px": 0.494, "morth_rep@3.0px": 0.582, "morth_prec@3.0px": 0.075,
        "morth_recall@3.0px": 0.582, "morth_rep@5.0px": 0.615, "morth_prec@5.0px": 0.078,
        "morth_recall@5.0px": 0.615, "morth_loc@3.0px": 0.525, "morth_loc@5.0px": 0.713,
        "mjunc_prec@2px": 0.59, "mjunc_recall@2px": 0.539, "mjunc_prec@4px": 0.672,
        "mjunc_recall@4px": 0.618},
}
LINES_H_AUC_SEEDS = {
    "hp_lsd_lbd": {
        "H_error_lines@1px": [0.2965, 0.3117, 0.2965],
        "H_error_lines@3px": [0.5617, 0.5526, 0.5709],
        "H_error_lines@5px": [0.6632, 0.6401, 0.6787]},
    "hp_sold2_wunsch": {
        "H_error_lines@1px": [0.0266, 0.0266, 0.0266],
        "H_error_lines@3px": [0.3241, 0.3241, 0.3241],
        "H_error_lines@5px": [0.5116, 0.511, 0.511]},
    "hp_gluestick_stage0": {
        "H_error_lines@1px": [0.2131, 0.2131, 0.2037],
        "H_error_lines@3px": [0.6154, 0.6154, 0.5956],
        "H_error_lines@5px": [0.7371, 0.7371, 0.7174]},
    "rdnim_day_lsd_lbd": {
        "H_error_lines@1px": [0.0829, 0.0829, 0.0497],
        "H_error_lines@3px": [0.1562, 0.1562, 0.11],
        "H_error_lines@5px": [0.1979, 0.215, 0.1662]},
    "rdnim_night_lsd_lbd": {
        "H_error_lines@1px": [0.0347, 0.0347, 0.0347],
        "H_error_lines@3px": [0.1137, 0.1137, 0.1137],
        "H_error_lines@5px": [0.1574, 0.1574, 0.1574]},
    "rdnim_day_sold2_wunsch": {
        "H_error_lines@1px": [0.0, 0.0, 0.0], "H_error_lines@3px": [0.1607, 0.148, 0.1607],
        "H_error_lines@5px": [0.2289, 0.2161, 0.2289]},
    "rdnim_night_sold2_wunsch": {
        "H_error_lines@1px": [0.0, 0.0, 0.0], "H_error_lines@3px": [0.089, 0.089, 0.089],
        "H_error_lines@5px": [0.1614, 0.1614, 0.1614]},
}

# (d) JAX's native libraries on this host (same command, --constants): ELSED on the grey
# gate views (segment count, sum of every endpoint coordinate in float64, the first
# segment) and the LAP's assignments of LAP_COSTS (sha256 of the int32 rows, their sum)
ELSED_JAX = {
    "v_qa0/1.ppm": (92, 75715.7541, (264.0662, 102.7257, 382.0826, 106.1583)),
    "v_qa0/2.ppm": (84, 70554.7495, (261.015, 91.8602, 387.0229, 92.7459)),
    "v_qa0/4.ppm": (80, 65102.133, (263.8347, 72.5214, 385.9649, 68.8361)),
    "v_qa1/1.ppm": (144, 92278.2028, (300.8423, 226.7785, 453.8839, 222.1557)),
    "v_qa1/2.ppm": (135, 83344.6507, (311.741, 212.204, 477.9899, 204.7736)),
    "v_qa1/4.ppm": (118, 67485.9551, (304.8844, 251.8615, 477.9889, 275.083)),
    "v_qa2/1.ppm": (100, 84217.1257, (342.325, 243.0211, 343.3311, 323.0713)),
    "v_qa2/2.ppm": (95, 85055.6927, (354.339, 328.9677, 357.8178, 257.7956)),
    "v_qa2/4.ppm": (89, 73358.3924, (365.7174, 223.1851, 381.3957, 331.8089)),
}
LAP_JAX = ("663c002d735932a0", 18263)
LAP_COSTS = {"seed": 2718, "shape": (4, 96, 128), "levels": 6, "big": 0.25}
ELSED_MAX_LINES = 256  # (d): the slots of the gate views' ELSED
# the committed outputs/results/<benchmark>/<conf>/summaries.json (JAX on its cv2-rendered
# sets), printed for information only
LINES_COMMITTED = {
    "hp_lsd_lbd": ("hpatches_lines/lsd_lbd", {"morth_rep@3.0": 0.8276,
                                              "mline_match_precision": 0.5823}),
    "hp_sold2_wunsch": ("hpatches_lines/sold2_wunsch", {"mnum_line_matches": 247.09}),
    "hp_gluestick_stage0": ("hpatches_lines/gluestick_stage0",
                            {"mline_match_precision": 0.8185}),
    "hp_elsed_lines": ("hpatches_lines/elsed_lines", {"morth_rep@3.0": 0.6553}),
    "rdnim_day_lsd_lbd": ("rdnim_lines/lsd_lbd", {"morth_rep@3.0": 0.7099}),
    "rdnim_day_sold2_wunsch": ("rdnim_lines/sold2_wunsch", {"mnum_line_matches": 135.9}),
    "wf_lsd": ("wireframe/lsd", {"morth_rep@5.0px": 0.311}),
    "wf_sold2": ("wireframe/sold2", {"mjunc_recall@4px": 0.619}),
}

# |port - JAX| on the same set: counts relative, shares and AUCs absolute, localisation
# errors in pixels. LSD and ELSED run on the host, bit for bit JAX's; LBD, SOLD2 and the
# matchers run on the card. The card's largest differences in a whole run (an NVIDIA
# H100 80GB HBM3 at 700 W, PERF.md §2): counts 1.2e-4 relative, shares 0.0017,
# localisation 0.0014 px (SOLD2 on RDNIM); the line RANSAC's AUC 0.017 outside JAX's
# seed band (its own stream): the bounds are about 5x those, 3x for the AUCs
LINES_TOLERANCES = {"count": 0.005, "share": 0.01, "loc": 0.01, "auc": 0.05}
LINES_COUNT_KEYS = ("mnum_lines", "mnum_lines0", "mnum_lines1", "mnum_gt_lines",
                    "mnum_line_matches")
LINES_PRINTED = ("mH_error_lines",)  # a mean of corner errors (often inf): printed
GS_LINES_PAIRS = 8  # (a) kernel path against plain path
GS_LINES_AGREE = 0.99  # (a) share of line_matches0 slots equal
SOLD2_CPU_VIEWS = 4  # (d) SOLD2 on the card against the CPU
SOLD2_HEAD_TOL = 1e-4
SOLD2_SLOT_SHARE = 0.99  # (d) valid line slots equal within SOLD2_SLOT_PX
SOLD2_SLOT_PX = 1e-3
WUNSCH_TOL = 1e-5  # (d) the Wunsch scores, card against CPU


def tolerance(key: str, ref: float) -> float:
    if key in LINES_COUNT_KEYS:
        return LINES_TOLERANCES["count"] * abs(ref)
    if "loc@" in key:
        return LINES_TOLERANCES["loc"]
    if key.startswith("H_error_lines@"):
        return LINES_TOLERANCES["auc"]
    return LINES_TOLERANCES["share"]


def hold_lines(run: str, summaries: dict, failures: list) -> None:
    """Log each summary of LINES_JAX[run] beside the port's; collect those
    outside their tolerance (an AUC of the line RANSAC against the range of
    LINES_H_AUC_SEEDS[run][key])."""
    for key, ref in LINES_JAX[run].items():
        port = float(summaries.get(key, float("nan")))
        if key in LINES_PRINTED:
            log(f"  {run} {key}: port {port:.4f}, JAX {ref} (printed, not held)")
            continue
        seeds = LINES_H_AUC_SEEDS.get(run, {}).get(key)
        lo, hi = (min(seeds), max(seeds)) if seeds else (ref, ref)
        tol = tolerance(key, ref)
        ok = lo - tol <= port <= hi + tol
        band = f", {lo:.4f} to {hi:.4f} over JAX's seeds 0-2" if seeds else ""
        log(f"  {run} {key}: port {port:.4f}, JAX {ref:.4f}{band} (tolerance {tol:.4f}) "
            f"{'ok' if ok else 'FAILS'}")
        if not ok:
            failures.append(f"{run} {key}: {port} against {ref}")
    if run in LINES_COMMITTED:
        folder, values = LINES_COMMITTED[run]
        log(f"  {run}: committed {folder}: {json.dumps(values)} (JAX on its JPEG/cv2 sets; "
            "information only)")


# --- (e) the time by stage ---------------------------------------------------------------

class StageTimers:
    """Within ``with``: the synchronised milliseconds of each call of LBD
    (``lbd_describe``), SOLD2's heads and line extraction, and of each
    forward of the ``modules`` given ({name: module}, by hooks)."""

    def __init__(self, device, modules: dict):
        self.device, self.modules = device, modules
        self.ms: dict[str, list] = {}

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
        import torch

        from gluefactory_torch.models.lines import lbd
        from gluefactory_torch.models.lines.sold2 import SOLD2

        self.patched = [(lbd, "lbd_describe", lbd.lbd_describe),
                        (SOLD2, "_heads", SOLD2._heads),
                        (SOLD2, "_extract_lines", SOLD2._extract_lines)]
        lbd.lbd_describe = self._timed("lbd", lbd.lbd_describe)
        SOLD2._heads = self._timed("sold2_heads", SOLD2._heads)
        SOLD2._extract_lines = self._timed("sold2_lines", SOLD2._extract_lines)
        starts = []

        def enter(module, args):
            torch.cuda.synchronize(self.device)
            starts.append(time.perf_counter())

        def leave(name):
            def hook(module, args, out):
                torch.cuda.synchronize(self.device)
                self.ms.setdefault(name, []).append((time.perf_counter() - starts.pop()) * 1e3)
            return hook

        self.handles = [h for name, m in self.modules.items() for h in (
            m.register_forward_pre_hook(enter), m.register_forward_hook(leave(name)))]
        return self

    def __exit__(self, *exc):
        for owner, name, value in self.patched:
            setattr(owner, name, value)
        for handle in self.handles:
            handle.remove()

    def per_pair(self, views: int) -> dict:
        """Median ms a pair (an item of the benchmark) of each stage; the
        per-view stages summed over ``views`` views."""
        import numpy as np

        out = {}
        for name, ms in self.ms.items():
            per_view = name in ("extractor", "lbd", "sold2_heads", "sold2_lines")
            ms = np.add.reduceat(ms, np.arange(0, len(ms), views)) if per_view else ms
            out[f"{name}_ms"] = float(np.median(ms))
        return out


def run_line_benchmark(run: str, bench: str, pipeline, model, out: Path, device) -> dict:
    """One benchmark run, timed by stage; returns its report (summaries,
    seconds, pairs a second, ms a pair by stage, attention launches)."""
    import numpy as np

    from gluefactory_torch.ops import attention as A

    modules = {"extractor": model} if bench == "wireframe" else {"extractor": model.extractor}
    if bench != "wireframe" and model.matcher is not None:
        modules["matcher"] = model.matcher
    A.reset_launches()
    with StageTimers(device, modules) as timers:
        t = time.perf_counter()
        summaries, _ = pipeline.run(out, model=model, overwrite=True)
        seconds = time.perf_counter() - t
    stages = timers.per_pair(1 if bench == "wireframe" else 2)
    for key in ("forward_ms", "metrics_ms", "line_ransac_ms"):
        if pipeline.timings.get(key):
            stages[key] = float(np.median(pipeline.timings[key]))
    n = len(pipeline.timings["forward_ms"])
    report = {"items": n, "seconds": seconds, "items_per_s": n / seconds, "stages": stages,
              "launches": dict(A.launches), "summaries": summaries}
    log(f"  {run}: {n} items in {seconds:.1f} s ({n / seconds:.1f} a second); median ms an "
        "item by stage (synchronised): " + ", ".join(f"{k[:-3]} {v:.2f}"
                                                      for k, v in stages.items()))
    return report


# --- (d) host and card parity ------------------------------------------------------------

def lap_costs():
    import numpy as np

    rng = np.random.default_rng(LAP_COSTS["seed"])
    c = np.round(rng.uniform(0, LAP_COSTS["levels"], LAP_COSTS["shape"])) / 2
    c[rng.uniform(size=c.shape) < LAP_COSTS["big"]] = 1e6
    return c.astype(np.float32)


def lap_digest(assign) -> tuple:
    import numpy as np

    a = np.ascontiguousarray(assign, np.int32)
    return hashlib.sha256(a.tobytes()).hexdigest()[:16], int(a.astype(np.int64).sum())


def elsed_views(gate_root: Path) -> dict:
    """{gate view: its float grey image} of the views LSD_CV2 names."""
    import numpy as np
    import torch

    from chip_smoke_gluestick import LSD_CV2
    from gluefactory_torch.models.lines.lsd import grey_float
    from gluefactory_torch.utils.image import read_image

    return {name: grey_float(torch.from_numpy(
        read_image(gate_root / name).astype(np.float32) / 255.0)[None])[0].numpy()
        for name in LSD_CV2}


def elsed_digest(segs, valid) -> tuple:
    import numpy as np

    kept = segs[valid].reshape(-1, 4)
    return (int(valid.sum()), round(float(kept.astype(np.float64).sum()), 4),
            tuple(round(float(v), 4) for v in kept[0]))


def check_host_parity(gate_root: Path) -> dict:
    """(d) ELSED on the gate views and the LAP on LAP_COSTS, built with this
    host's compiler, against JAX's native libraries' results (ELSED_JAX,
    LAP_JAX)."""
    from gluefactory_torch.models.lines.elsed import detect_elsed_np
    from gluefactory_torch.ops.lap import batch_linear_assignment

    failures, ms = [], []
    for name, grey in elsed_views(gate_root).items():
        t = time.perf_counter()
        segs, _, valid = detect_elsed_np(grey, ELSED_MAX_LINES)
        ms.append((time.perf_counter() - t) * 1e3)
        got = elsed_digest(segs, valid)
        if got != ELSED_JAX[name]:
            failures.append(f"ELSED {name}: {got} against {ELSED_JAX[name]}")
    costs = lap_costs()
    t = time.perf_counter()
    lap = lap_digest(batch_linear_assignment(costs))
    lap_ms = (time.perf_counter() - t) * 1e3
    if lap != tuple(LAP_JAX):
        failures.append(f"LAP {lap} against {LAP_JAX}")
    log(f"  (d) ELSED on {len(ms)} gate views and the LAP on {costs.shape} costs, built on "
        f"this host, against JAX's native libraries: {'equal' if not failures else failures}; "
        f"ELSED {sorted(ms)[len(ms) // 2]:.1f} ms a view, LAP {lap_ms:.1f} ms for the batch")
    if failures:
        raise AssertionError(f"host libraries against JAX's: {failures}")
    return {"elsed_ms": sorted(ms)[len(ms) // 2], "lap_ms": lap_ms}


def check_card_parity(model_card, famA, device) -> dict:
    """(d) SOLD2 (from its blob) on the card against the CPU on
    SOLD2_CPU_VIEWS views of famA, and the Wunsch scores of their first pair
    card against CPU."""
    import numpy as np
    import torch

    from gluefactory_torch.eval.io import load_model
    from gluefactory_torch.recipes import SOLD2_WEIGHTS, line_conf

    conf = line_conf("hpatches_lines", "sold2_wunsch")
    cpu = load_model(conf["model"], SOLD2_WEIGHTS, "cpu")
    heads_err, slots, views = 0.0, [], []
    for batch in _batches(famA, SOLD2_CPU_VIEWS // 2):
        for v in ("view0", "view1"):
            views.append({k: torch.from_numpy(batch[v][k]) for k in ("image", "image_size")})
    outs = []
    for view in views:
        with torch.inference_mode():
            a = model_card.extractor({k: x.to(device) for k, x in view.items()})
            b = cpu.extractor(view)
        a = {k: x.cpu() for k, x in a.items()}
        for key in ("junction_map", "junction_logits", "line_heatmap", "descriptors_dense"):
            heads_err = max(heads_err, float((a[key] - b[key]).abs().max()))
        same = (a["valid_lines"] == b["valid_lines"]) & (
            (a["lines"] - b["lines"]).abs().amax(dim=(-1, -2)) <= SOLD2_SLOT_PX)
        slots.append(float(same[b["valid_lines"] | a["valid_lines"]].float().mean()))
        outs.append((a, b))
    (a0, b0), (a1, b1) = outs[0], outs[1]
    data = {"lines0": b0["lines"], "lines1": b1["lines"], "valid_lines0": b0["valid_lines"],
            "valid_lines1": b1["valid_lines"], "descriptors_dense0": b0["descriptors_dense"],
            "descriptors_dense1": b1["descriptors_dense"]}
    with torch.inference_mode():
        s_cpu = cpu.matcher.scores(data)
        s_card = model_card.matcher.scores({k: x.to(device) for k, x in data.items()}).cpu()
    finite = torch.isfinite(s_cpu)
    wunsch_err = float((s_card[finite] - s_cpu[finite]).abs().max())
    same_inf = bool(torch.equal(finite, torch.isfinite(s_card)))
    report = {"heads_max_abs_err": heads_err, "slot_share": slots, "wunsch_max_abs_err":
              wunsch_err, "wunsch_pairs": int(finite.sum())}
    log(f"  (d) SOLD2 card against CPU on {len(views)} famA views: heads within {heads_err:.2e} "
        f"(bound {SOLD2_HEAD_TOL}), valid line slots equal {np.round(slots, 4).tolist()} "
        f"(bound {SOLD2_SLOT_SHARE}); Wunsch scores of {report['wunsch_pairs']} segment pairs "
        f"within {wunsch_err:.2e} (bound {WUNSCH_TOL})")
    if not (heads_err <= SOLD2_HEAD_TOL and min(slots) >= SOLD2_SLOT_SHARE
            and wunsch_err <= WUNSCH_TOL and same_inf):
        raise AssertionError(f"SOLD2 / Wunsch card against CPU: {report}")
    return report


# --- phase 20 ---------------------------------------------------------------------------

def check_lines(device, root: Path, gate_root: Path) -> tuple[dict, dict]:
    """Phase 20 (a)-(e) of chip_smoke's docstring. ``root`` holds phase 8's
    sets (``hpatches/famA``); the RDNIM and Wireframe sets are rendered under
    it. Returns ({path: attention launches}, report)."""
    import numpy as np
    import torch

    from chip_smoke_gluestick import run_gluestick
    from gluefactory_torch.core.config import merge
    from gluefactory_torch.eval import get_benchmark
    from gluefactory_torch.eval.eval_pipeline import to_model_input
    from gluefactory_torch.eval.io import load_model
    from gluefactory_torch.recipes import line_conf

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    report = {}
    # RDNIM and Wireframe render in worker processes while HPatches-lines runs
    background = ThreadPoolExecutor(1)
    render = background.submit(render_line_sets, root)
    background.shutdown(wait=False)
    report["host"] = check_host_parity(gate_root)
    failures, models, launches = [], {}, {}
    for run, bench, name, which in LINE_RUNS:
        if which != "hpatches" and "render_s" not in report:
            report["render_s"] = render.result()
            log(f"  rendered RDNIM ({RDNIM_SET['num_pairs']} pairs, day and night) and "
                f"Wireframe ({WIREFRAME_SET['num_images']} images) in {report['render_s']:.1f} "
                f"s, beside HPatches-lines; waited {time.perf_counter() - t0:.1f} s into the phase")
        conf = merge(line_conf(bench, name), {"data": run_data(root, which)})
        key = json.dumps([conf["model"], conf.get("checkpoint")], sort_keys=True)
        if key not in models:
            models[key] = load_model(conf["model"], conf.get("checkpoint"), device)
        model = models[key]
        pipeline = get_benchmark(bench)(conf, device=device)
        out = root / "lines" / run
        if name == "gluestick_stage0":
            summaries, rep = run_gluestick(pipeline, model, out, run)
            launches[f"lines_{run}"] = rep["launches"]["attention"]
            gs_model, gs_conf, gs_data = model, conf, pipeline.dataset
        else:
            rep = run_line_benchmark(run, bench, pipeline, model, out, device)
            summaries = rep["summaries"]
            log(f"  {run} summaries: {json.dumps(summaries)}")
        report[run] = rep
        hold_lines(run, summaries, failures)
        if run == "hp_sold2_wunsch":
            report["card_parity"] = check_card_parity(model, pipeline.dataset, device)
    plain = load_model(merge(gs_conf["model"], {"matcher": {"attention": "xla"}}),
                       gs_conf["checkpoint"], device)
    agree = []
    for batch in _batches(gs_data, GS_LINES_PAIRS):
        data_in = to_model_input(batch, device)
        with torch.inference_mode():
            a, b = gs_model(data_in), plain(data_in)
        agree.append(float((a["line_matches0"] == b["line_matches0"]).float().mean()))
    log(f"  (a) GlueStick kernel against plain path, the first {GS_LINES_PAIRS} pairs: "
        f"line_matches0 slots agree {np.mean(agree):.4f} (bound {GS_LINES_AGREE}); worst pair "
        f"{min(agree):.4f}")
    if np.mean(agree) < GS_LINES_AGREE:
        failures.append(f"GlueStick kernel against plain path: {agree}")
    report["gs_agree"] = agree
    report["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    report["seconds"] = time.perf_counter() - t0
    log(f"  (e) peak memory {report['max_memory_allocated'] / 2**20:.0f} MiB; phase 20 in "
        f"{report['seconds']:.1f} s")
    if failures:
        raise AssertionError(f"line benchmarks against the JAX package: {failures}")
    return launches, report
