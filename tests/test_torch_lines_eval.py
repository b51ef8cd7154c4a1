"""The line geometry and the line-aware evaluation against the JAX package on
the CPU: ``geometry/lines.py``, ``warp_lines``, ``line_repeatability``,
``eval_homography_robust`` with matched lines (hybrid RANSAC), the
``run_eval`` of the extended HPatches and MegaDepth-1500 benchmarks on
identical cached predictions (JAX's side reads them as HDF5), and the
HPatches GlueStick pipeline against JAX's on one small sequence.

Bounds: geometry within GEO_TOL; evaluations on the same predictions
with JAX's minimal sets: the line summaries equal, the point ones equal
but for the RANSAC corner errors' float32 eigensolves (mAA within
MAA_POINTS); the pipelines, each on its own predictions: phase 18's bounds
of ``chip_smoke.py`` (mAA within 1.5 points, prec@1px within 0.02,
keypoints within 1%, matches within 3%, line repeatability and line match
precision within 0.02, line matches within 5%)."""

import time
from pathlib import Path

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gluefactory_torch.core.config import merge
from gluefactory_torch.eval import get_benchmark
from gluefactory_torch.eval import utils as port_eval
from gluefactory_torch.eval.hpatches_extended import HPatchesExtendedPipeline
from gluefactory_torch.eval.megadepth1500_extended import MegaDepth1500ExtendedPipeline
from gluefactory_torch.eval.metrics import line_repeatability
from gluefactory_torch.geometry import lines as G
from gluefactory_torch.geometry.homography import warp_lines
from gluefactory_torch.recipes import (
    hpatches_extended_gluestick_conf,
    md1500_extended_gluestick_conf,
)
from gluefactory_torch.robust_estimators.homography import hybrid_ransac as port_hybrid
from gluefactory_torch.scripts.generate_eval_set import render_sequence
from gluefactory_torch.scripts.generate_pose_eval_set import render_pose_scene
from gluefactory_torch.settings import ROOT_PATH
from gluefactory_tpu.eval import utils as jax_eval
from gluefactory_tpu.eval.hpatches_extended import HPatchesExtendedPipeline as JaxHPExtended
from gluefactory_tpu.eval.megadepth1500_extended import (
    MegaDepth1500ExtendedPipeline as JaxMDExtended,
)
from gluefactory_tpu.eval.metrics import line_repeatability as jax_line_repeatability
from gluefactory_tpu.geometry import lines as JG
from gluefactory_tpu.geometry.homography import warp_lines as jax_warp_lines

from test_torch_hybrid_ransac import _jax_sample_idx

torch.set_num_threads(2)

GEO_TOL = 1e-4
MAA_POINTS = 1.5
H = np.array([[1.05, 0.04, -12.0], [-0.03, 0.97, 8.0], [2e-4, -1e-4, 1.0]], np.float32)


def _segments(seed, n=30, size=(320.0, 240.0)):
    rng = np.random.default_rng(seed)
    segs = rng.uniform([-20, -20], [size[0] + 20, size[1] + 20], (2, n, 2, 2))
    segs[:, :3] = segs[:, :3, :1]  # degenerate (zero-length) segments
    return segs.astype(np.float32)


GEOMETRY = {
    "point_to_seg_dist": lambda m, s0, s1: m.point_to_seg_dist(s0.reshape(2, -1, 2), s1),
    "project_point_to_line": lambda m, s0, s1: m.project_point_to_line(
        s0.reshape(2, -1, 2), s1),
    "orth_line_dist": lambda m, s0, s1: m.orth_line_dist(s0, s1),
    "struct_line_dist": lambda m, s0, s1: m.struct_line_dist(s0, s1),
    "overlap_fraction": lambda m, s0, s1: m.overlap_fraction(s0, s1),
    "sample_points_on_lines": lambda m, s0, s1: m.sample_points_on_lines(s0, 7),
}


@pytest.mark.parametrize("name", sorted(GEOMETRY))
def test_line_geometry_is_jaxs(name):
    s0, s1 = _segments(1), _segments(2)[:, :24]
    ours = GEOMETRY[name](G, torch.from_numpy(s0), torch.from_numpy(s1))
    ref = GEOMETRY[name](JG, jnp.asarray(s0), jnp.asarray(s1))
    ours, ref = (ours, ref) if isinstance(ours, tuple) else ((ours,), (ref,))
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=GEO_TOL, rtol=GEO_TOL)


def test_warp_lines_is_jaxs():
    segs = _segments(3, n=200)
    Hs = np.stack([H, np.linalg.inv(H)]).astype(np.float32)
    size = np.float32([[320.0, 240.0], [300.0, 260.0]])
    ours, valid = warp_lines(*map(torch.from_numpy, (segs, Hs, size)))
    ref, ref_valid = jax_warp_lines(*map(jnp.asarray, (segs, Hs, size)))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(ref_valid))
    assert 0.2 < valid.float().mean() < 1.0  # some clipped away entirely
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=GEO_TOL, rtol=GEO_TOL)


@pytest.mark.parametrize("distance", ["orth", "struct"])
def test_line_repeatability_is_jaxs(distance):
    rng = np.random.default_rng(4)
    lines0 = _segments(5, n=60)[:1]
    w = np.concatenate([lines0.reshape(-1, 2), np.ones((120, 1))], 1) @ H.T
    lines1 = (w[:, :2] / w[:, 2:]).reshape(1, 60, 2, 2) + rng.normal(0, 1.5, (1, 60, 2, 2))
    lines1[:, 40:] = rng.uniform(0, 300, (1, 20, 2, 2))
    lines1 = lines1.astype(np.float32)
    valid0, valid1 = rng.uniform(size=(1, 60)) > 0.1, rng.uniform(size=(1, 60)) > 0.1
    args = (lines0, lines1, valid0, valid1, H[None], np.float32([[320.0, 240.0]]))
    ours = line_repeatability(*map(torch.from_numpy, args), th=5.0, distance=distance)
    ref = jax_line_repeatability(*map(jnp.asarray, args), th=5.0, distance=distance)
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=1e-5)
    assert 0.3 < float(ours[0][0]) < 1.0


def _line_predictions(seed, n=96, n_lines=40):
    rng = np.random.default_rng(seed)
    kp0 = rng.uniform([0, 0], [480, 360], (n, 2)).astype(np.float32)
    h = np.c_[kp0, np.ones(n)] @ H.T
    kp1 = (h[:, :2] / h[:, 2:] + rng.normal(0, 0.4, (n, 2))).astype(np.float32)
    m0 = np.arange(n)
    m0[rng.uniform(size=n) < 0.5] = -1  # few point matches: the lines matter
    l0 = rng.uniform([0, 0], [480, 360], (n_lines, 2, 2)).astype(np.float32)
    w = np.c_[l0.reshape(-1, 2), np.ones(2 * n_lines)] @ H.T
    l1 = (w[:, :2] / w[:, 2:]).reshape(n_lines, 2, 2) + rng.normal(0, 0.3, (n_lines, 2, 2))
    perm = rng.permutation(n_lines)
    lm0 = perm.copy()
    lines1 = np.empty_like(l1)
    lines1[perm] = l1
    lm0[rng.uniform(size=n_lines) < 0.3] = rng.integers(0, n_lines, 1)
    lm0[rng.uniform(size=n_lines) < 0.1] = -1
    valid_lines0 = rng.uniform(size=n_lines) > 0.05
    return {"keypoints0": kp0, "keypoints1": kp1, "matches0": m0.astype(np.int32),
            "matching_scores0": np.where(m0 > -1, 0.9, 0.0).astype(np.float32),
            "lines0": l0, "lines1": lines1.astype(np.float32),
            "line_matches0": lm0.astype(np.int32), "valid_lines0": valid_lines0}


@pytest.mark.parametrize("th", [1.0, 3.0])
def test_robust_evaluation_with_lines_is_jaxs(th):
    """hybrid_ransac fed the matched lines as JAX feeds them, with JAX's
    minimal sets: the same inliers, the corner error within 1e-3 px; the
    point metrics ignore the lines."""
    pred = _line_predictions(int(th))
    data = {"H_0to1": H, "view0": {"image_size": np.float32([480.0, 360.0])}}
    conf = {"estimator": "hybrid_ransac", "ransac_th": th, "num_hypotheses": 256}
    lm0 = pred["line_matches0"]
    idx = _jax_sample_idx(pred["matches0"] > -1, (lm0 > -1) & pred["valid_lines0"], 0, 256)
    ours = port_eval.eval_homography_robust(data, pred, conf, device="cpu", sample_idx=idx)
    ref = jax_eval.eval_homography_robust(data, pred, conf)
    assert ours["ransac_inl"] == ref["ransac_inl"] > 20
    np.testing.assert_allclose(ours["H_error_ransac"], ref["H_error_ransac"], atol=1e-3)
    assert ours["H_error_ransac"] < 2.0
    points = {k: v for k, v in pred.items() if "line" not in k}
    assert (port_eval.eval_matches_homography(data, pred, device="cpu")
            == port_eval.eval_matches_homography(data, points, device="cpu"))


def _jax_draws(monkeypatch):
    """The port's hybrid RANSAC draws JAX's minimal sets (seed 0)."""
    def draws(valid, num_hypotheses, generator=None, size=4):
        return torch.from_numpy(_jax_sample_idx(valid.cpu().numpy(), np.zeros(0, bool), 0,
                                                num_hypotheses))
    monkeypatch.setattr(port_hybrid, "sample_minimal_sets", draws)


def _to_h5(npz, h5):
    with np.load(npz) as f, h5py.File(h5, "w") as h:
        for i, name in enumerate(f["names"]):
            group = h.create_group(str(name))
            for key in f.files:
                if key != "names":
                    group.create_dataset(key, data=f[key][i])


@pytest.fixture(scope="module")
def hpatches_runs(tmp_path_factory):
    """One rendered sequence (5 pairs) at 240 pixels; the extended HPatches
    benchmark with GlueStick stage 0 (256 keypoints, 64 lines) through the
    port and through the JAX package, each on its own predictions, both with
    JAX's minimal sets."""
    root = tmp_path_factory.mktemp("hp_lines")
    render_sequence(root / "set" / "v_lines0", np.random.default_rng((424242, 5)), (320, 240),
                    "a")
    recipe = hpatches_extended_gluestick_conf()
    conf = merge(recipe, {
        "data": {"data_dir": str(root / "set"), "num_workers": 1,
                 "preprocessing": {"resize": 240}},
        "model": {"extractor": {"point_extractor": {"max_num_keypoints": 256},
                                "line_extractor": {"max_num_lines": 64}}},
        "eval": {"num_hypotheses": 256},
        "checkpoint": str(ROOT_PATH / recipe["checkpoint"])})
    with pytest.MonkeyPatch.context() as mp:
        _jax_draws(mp)
        pipeline = get_benchmark("hpatches_extended")(conf, device="cpu")
        ours = pipeline.run(root / "port")[0]
    ref = JaxHPExtended(conf).run(root / "jax")[0]
    return root, conf, ours, ref


def test_hpatches_extended_run_eval_is_jaxs(hpatches_runs, monkeypatch):
    """JAX's run_eval on the port's predictions (as HDF5) against the port's."""
    assert get_benchmark("hpatches_extended") is HPatchesExtendedPipeline
    root, conf, ours, _ = hpatches_runs
    _to_h5(root / "port" / "predictions.npz", root / "port.h5")
    jpipeline = JaxHPExtended(conf)
    ref = jpipeline.run_eval(jpipeline.get_dataloader(), root / "port.h5")[0]
    assert ours.keys() == ref.keys()
    for key in ref:
        if "ransac" in key or key == "best_ransac_th":
            continue
        assert ours[key] == pytest.approx(ref[key], abs=2e-3 if "dlt" in key else 1e-6), key
    assert abs(ours["H_error_ransac_mAA"] - ref["H_error_ransac_mAA"]) <= MAA_POINTS
    assert ours["mnum_line_matches"] > 10 and ours["mline_repeatability"] > 0.3


def test_hpatches_gluestick_pipeline_is_jaxs(hpatches_runs):
    """The port's model against the JAX package's, each benchmark on its own
    predictions, within phase 18's bounds."""
    _, _, ours, ref = hpatches_runs
    assert abs(ours["H_error_ransac_mAA"] - ref["H_error_ransac_mAA"]) <= 1.5
    assert abs(ours["mprec@1px"] - ref["mprec@1px"]) <= 0.02
    assert ours["mnum_keypoints"] == pytest.approx(ref["mnum_keypoints"], rel=0.01)
    assert ours["mnum_matches"] == pytest.approx(ref["mnum_matches"], rel=0.03)
    for key in ("mline_repeatability", "mline_match_precision"):
        assert abs(ours[key] - ref[key]) <= 0.02, key
    assert ours["mnum_line_matches"] == pytest.approx(ref["mnum_line_matches"], rel=0.05)


def test_megadepth1500_extended_run_eval_is_jaxs(tmp_path):
    """The extended pose benchmark's line scores: JAX's run_eval on the
    port's predictions equal the port's (the pose summaries draw from each
    package's stream and are held to JAX by tests/test_torch_pose_eval.py)."""
    lines = render_pose_scene(tmp_path / "scene000", np.random.default_rng((31415, 0)),
                              size=(320, 240))
    (tmp_path / "pairs_calibrated.txt").write_text("\n".join(lines) + "\n")
    recipe = md1500_extended_gluestick_conf()
    conf = merge(recipe, {
        "data": {"pairs": str(tmp_path / "pairs_calibrated.txt"), "root": str(tmp_path),
                 "preprocessing": {"resize": 320}, "num_workers": 1},
        "model": {"extractor": {"point_extractor": {"max_num_keypoints": 256},
                                "line_extractor": {"max_num_lines": 64}}},
        "eval": {"num_hypotheses": 64, "ransac_th": 1.0},
        "checkpoint": str(ROOT_PATH / recipe["checkpoint"])})
    assert get_benchmark("megadepth1500_extended") is MegaDepth1500ExtendedPipeline
    pipeline = MegaDepth1500ExtendedPipeline(conf, device="cpu")
    ours, results = pipeline.run(tmp_path / "port")
    with np.load(tmp_path / "port" / "predictions.npz") as f:
        assert "lines0" in f.files and "line_matches0" in f.files
    _to_h5(tmp_path / "port" / "predictions.npz", tmp_path / "port.h5")
    jpipeline = JaxMDExtended(conf)
    ref = jpipeline.run_eval(jpipeline.get_dataloader(), tmp_path / "port.h5")[0]
    assert ours.keys() == ref.keys()
    for key in ref:
        if key.startswith("mline") or key in ("mnum_line_matches", "mnum_matches"):
            assert ours[key] == pytest.approx(ref[key], abs=1e-6), key
    assert ours["mnum_line_matches"] > 5


# --- the reference numbers of chip_smoke.py phase 18 ---------------------------------

# (summary key of each benchmark printed by the __main__ below)
REFERENCE_KEYS = {
    "hpatches": ("H_error_ransac_mAA", "mprec@1px", "mnum_keypoints", "mnum_matches"),
    "hpatches_extended": ("H_error_ransac_mAA", "mprec@1px", "mnum_keypoints", "mnum_matches",
                          "mline_repeatability", "mline_match_precision",
                          "mnum_line_matches"),
    "eth3d": ("AP", "AP_lines", "mnum_matches"),
    "megadepth1500_extended": ("rel_pose_error_mAA", "mnum_matches", "mline_epi_prec@1e-03",
                               "mnum_line_matches"),
}


JAX_PIPELINES = {"hpatches": "HPatchesPipeline", "hpatches_extended": "HPatchesExtendedPipeline",
                 "eth3d": "ETH3DPipeline",
                 "megadepth1500_extended": "MegaDepth1500ExtendedPipeline"}


def phase18_runs(root: Path) -> list[tuple]:
    """(run name, benchmark, recipe conf) of phase 18's runs on the sets that
    chip_smoke.py renders under ``root``."""
    from gluefactory_torch import recipes as R

    hp = root / "hpatches"
    runs = [("famA", "hpatches", R.hpatches_gluestick_conf(), {"data_dir": str(hp / "famA")}),
            ("famB", "hpatches", R.hpatches_gluestick_famb_conf(refine=True),
             {"data_dir": str(hp / "famB")}),
            ("famA_extended", "hpatches_extended", R.hpatches_extended_gluestick_conf(),
             {"data_dir": str(hp / "famA"), "max_seqs": 8}),
            ("eth3d", "eth3d", R.eth3d_gluestick_conf(),
             {"data_dir": str(root / "eth3d" / "set")}),
            ("pose_extended", "megadepth1500_extended", R.md1500_extended_gluestick_conf(),
             {"pairs": str(root / "pose" / "pairs_calibrated.txt"),
              "root": str(root / "pose" / "images")})]
    return [(name, bench, merge(conf, {"data": data,
                                       "checkpoint": str(ROOT_PATH / conf["checkpoint"])}))
            for name, bench, conf, data in runs]


def render_phase18_sets(root: Path) -> None:
    """Phase 8's HPatches sets, phase 17's ETH3D set and phase 10's pose
    set, rendered as chip_smoke.py renders them."""
    import chip_smoke

    chip_smoke.render_sets(root / "hpatches")
    chip_smoke.render_eth3d_set(root / "eth3d" / "set")
    chip_smoke.render_pose_set(root / "pose")


def reference(side: str, name: str, bench: str, conf: dict, out: Path, seeds) -> list[dict]:
    """One run's summaries at each RANSAC seed (the later seeds rescore the
    first one's predictions), by the JAX package or by the port on the CPU."""
    rows = []
    for i, seed in enumerate(seeds):
        conf_s = merge(conf, {"eval": {"seed": seed}})
        if side == "jax":
            import importlib

            from gluefactory_tpu.core.config import Config

            cls = getattr(importlib.import_module(f"gluefactory_tpu.eval.{bench}"),
                          JAX_PIPELINES[bench])
            pipeline = cls(Config(conf_s))
        else:
            pipeline = get_benchmark(bench)(conf_s, device="cpu")
        t = time.perf_counter()
        summaries, _ = pipeline.run(out / name, overwrite=i == 0, overwrite_eval=i > 0)
        rows.append({"side": side, "run": name, "seed": seed,
                     "seconds": round(time.perf_counter() - t, 1),
                     "summaries": {k: float(summaries[k]) for k in REFERENCE_KEYS[bench]
                                   if k in summaries}})
    return rows


if __name__ == "__main__":
    import argparse
    import json

    parser = argparse.ArgumentParser(
        description="Phase 18's reference numbers: the summaries of its GlueStick runs on "
                    "the sets chip_smoke.py renders, by the JAX package or by the port, on "
                    "the CPU, one JSON line a (run, RANSAC seed).")
    parser.add_argument("--root", required=True, help="where the sets are (or are rendered)")
    parser.add_argument("--out", required=True)
    parser.add_argument("--side", choices=("jax", "port"), default="jax")
    parser.add_argument("--render", action="store_true")
    parser.add_argument("--runs", nargs="*", default=None)
    parser.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    args = parser.parse_args()
    if args.render:
        render_phase18_sets(Path(args.root))
    if args.side == "jax":
        jax.config.update("jax_platforms", "cpu")
    for name, bench, conf in phase18_runs(Path(args.root)):
        if args.runs is None or name in args.runs:
            for row in reference(args.side, name, bench, conf, Path(args.out), args.seeds):
                print(json.dumps(row), flush=True)
