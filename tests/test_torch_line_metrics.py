"""The exact line assignment and the line benchmarks against the JAX package on
the CPU: ``ops/lap.py`` (the port's copy of the native Jonker-Volgenant
solver) against JAX's native library on seeded costs with ties and ``BIG``
entries, ``gt_line_matches_exact``, ``area_line_dist`` and ``merge_lines``,
the line metrics (``eval/line_metrics.py``) on JAX's distance matrices, the
RDNIM and Wireframe renderers, and the ``run_eval`` of the HPatches-lines
(2 sequences, LSD+LBD, JAX's RANSAC draws fed in), RDNIM-lines (2 pairs) and
Wireframe (3 images) benchmarks against JAX's summaries on the same sets.

Bounds: the assignments, the exact ground truth, the metrics and the
benchmarks' summaries equal (an ``inf`` summary equal to an ``inf``) but for
the line RANSAC's corner errors, whose float32 solves part in the last bits
(H_ERR_RTOL relative, the AUCs within H_AUC_TOL); ``area_line_dist`` and
``merge_lines`` within GEO_TOL; the renderers' images (the port draws the
scenes in numpy, OpenCV in C++) differ on edge pixels, at most
RENDER_SHARE of them."""

import math
import os
from pathlib import Path

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gluefactory_torch.core.config import merge
from gluefactory_torch.eval import get_benchmark
from gluefactory_torch.eval import line_metrics as LM
from gluefactory_torch.geometry import lines as G
from gluefactory_torch.ops.lap import batch_linear_assignment
from gluefactory_torch.recipes import line_conf
from gluefactory_torch.robust_estimators.homography import hybrid_ransac as port_hybrid
from gluefactory_torch.scripts import generate_rdnim_set as port_rdnim
from gluefactory_torch.scripts import generate_wireframe_set as port_wireframe
from gluefactory_torch.scripts.generate_eval_set import render_sequence
from gluefactory_torch.utils.image import read_image
from gluefactory_tpu.core.config import Config
from gluefactory_tpu.eval import line_metrics as JLM
from gluefactory_tpu.geometry import lines as JG
from gluefactory_tpu.ops.lap import batch_linear_assignment as jax_lap

from test_torch_hybrid_ransac import _jax_sample_idx

torch.set_num_threads(2)

GEO_TOL = 1e-5
H_ERR_RTOL = 1e-3
H_AUC_TOL = 5e-3
RENDER_SHARE = 0.01

# JAX's references jitted (eager JAX compiles op by op)
jax_area_line_dist = jax.jit(JG.area_line_dist)
jax_merge_lines = jax.jit(JG.merge_lines)
jax_segment_distance_matrix = jax.jit(JLM.segment_distance_matrix, static_argnames="kind")


def _costs(seed, b, n, m):
    """Costs on a coarse grid (many ties) with a quarter of the entries BIG."""
    rng = np.random.default_rng(seed)
    c = np.round(rng.uniform(0, 6, (b, n, m))) / 2
    c[rng.uniform(size=c.shape) < 0.25] = 1e6
    return c.astype(np.float32)


@pytest.mark.parametrize("shape", [(3, 20, 20), (2, 17, 40), (1, 64, 64), (4, 1, 5)])
def test_lap_is_jaxs_native(shape):
    costs = _costs(sum(shape), *shape)
    ours = batch_linear_assignment(costs)
    ref = jax_lap(costs, use_native=True)
    np.testing.assert_array_equal(ours, ref)
    assert ours.dtype == np.int32 and (ours >= 0).all()
    for row in ours:  # one to one
        assert len(set(row.tolist())) == len(row)


def test_lap_refuses_more_rows_than_columns():
    with pytest.raises(ValueError, match="N <= M"):
        batch_linear_assignment(np.zeros((1, 5, 4), np.float32))


def test_gt_line_matches_exact_is_jaxs():
    rng = np.random.default_rng(7)
    cost = rng.uniform(0, 10, (2, 30, 36)).astype(np.float32)
    valid_pair = rng.uniform(size=cost.shape) < 0.6
    ours = G.gt_line_matches_exact(torch.from_numpy(cost), torch.from_numpy(valid_pair), 1.5)
    ref = JG.gt_line_matches_exact(cost, valid_pair, 1.5)
    np.testing.assert_array_equal(ours, ref)
    assert ours.dtype == np.int32 and 5 < (ours >= 0).sum() < 60


def _segments(seed, n, size=(320.0, 240.0)):
    """Random segments with degenerate, parallel, collinear and crossing ones."""
    rng = np.random.default_rng(seed)
    segs = rng.uniform([0, 0], size, (2, n, 2, 2))
    segs[:, 0] = segs[:, 0, :1]  # zero length
    segs[:, 1] = segs[:, 2] + [[5.0, 0.0]]  # parallel to the next
    segs[:, 3] = segs[:, 2] + (segs[:, 2, 1] - segs[:, 2, 0])[:, None] * 0.5  # collinear
    return segs.astype(np.float32)


def test_area_line_dist_is_jaxs():
    s0, s1 = _segments(1, 40), _segments(2, 33)
    ours = G.area_line_dist(torch.from_numpy(s0), torch.from_numpy(s1)).numpy()
    ref = np.asarray(jax_area_line_dist(jnp.asarray(s0), jnp.asarray(s1)))
    assert np.isfinite(ref).mean() > 0.9
    np.testing.assert_allclose(ours, ref, atol=GEO_TOL, rtol=GEO_TOL)


def _clustered_segments(seed, n_clusters=12, per=4):
    """Chains of near-collinear overlapping segments plus strays."""
    rng = np.random.default_rng(seed)
    segs = []
    for _ in range(n_clusters):
        p = rng.uniform(20, 300, 2)
        u = rng.normal(size=2)
        u /= np.linalg.norm(u)
        for k in range(per):
            a = p + u * (k * 15.0 + rng.uniform(-3, 3)) + rng.normal(0, 0.8, 2)
            segs.append([a, a + u * rng.uniform(18, 30) + rng.normal(0, 0.8, 2)])
    segs = np.asarray(segs, np.float32)
    segs = segs[rng.permutation(len(segs))][None].repeat(2, 0)
    segs[1] = segs[1, ::-1]
    valid = rng.uniform(size=segs.shape[:2]) > 0.1
    return segs, valid


def test_merge_lines_is_jaxs():
    segs, valid = _clustered_segments(3)
    ours, ours_valid = G.merge_lines(torch.from_numpy(segs), torch.from_numpy(valid))
    ref, ref_valid = jax_merge_lines(jnp.asarray(segs), jnp.asarray(valid))
    np.testing.assert_array_equal(ours_valid.numpy(), np.asarray(ref_valid))
    assert 10 <= ours_valid.sum(-1).min() < valid.sum(-1).min()  # clusters merged
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=GEO_TOL * 10, rtol=GEO_TOL)


def _near_pairs(seed, n=48):
    """Segments of view 0 and noisy copies of most of them in view 1."""
    rng = np.random.default_rng(seed)
    s0 = rng.uniform(0, 300, (1, n, 2, 2))
    s1 = s0[:, rng.permutation(n)] + rng.normal(0, 1.5, (1, n, 2, 2))
    s1[:, n - 8:] = rng.uniform(0, 300, (1, 8, 2, 2))
    s1 = np.concatenate([s1, rng.uniform(0, 300, (1, 4, 2, 2))], axis=1)
    return s0.astype(np.float32), s1.astype(np.float32)


@pytest.mark.parametrize("kind", ["orth", "struct", "area"])
def test_segment_distance_matrix_is_jaxs(kind):
    s0, s1 = _near_pairs(4)
    ours = LM.segment_distance_matrix(torch.from_numpy(s0), torch.from_numpy(s1), kind).numpy()
    ref = np.asarray(jax_segment_distance_matrix(jnp.asarray(s0), jnp.asarray(s1), kind=kind))
    np.testing.assert_allclose(ours, ref, atol=1e-4, rtol=GEO_TOL)


@pytest.mark.parametrize("kind", ["orth", "struct"])
def test_line_metrics_on_jaxs_distances_are_jaxs(kind):
    """The assignment, repeatability and localisation on JAX's matrices."""
    s0, s1 = _near_pairs(5)
    dist = np.asarray(jax_segment_distance_matrix(jnp.asarray(s0), jnp.asarray(s1), kind=kind))
    dist = np.repeat(dist, 2, axis=0)
    rng = np.random.default_rng(6)
    v0 = rng.uniform(size=dist.shape[:2]) > 0.1
    v1 = rng.uniform(size=(2, dist.shape[2])) > 0.1
    ours = LM.match_segments_one_to_one(dist, v0, v1)
    ref = JLM.match_segments_one_to_one(dist, v0, v1)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)
    n0, n1 = v0.sum(-1), v1.sum(-1)
    th = [1.0, 3.0, 5.0]
    for a, b in ((LM.segment_repeatability(ours[1], n0, n1, th),
                  JLM.segment_repeatability(ref[1], n0, n1, th)),
                 (LM.segment_localization_error(ours[1], th),
                  JLM.segment_localization_error(ref[1], th))):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    assert 0.3 < LM.segment_repeatability(ours[1], n0, n1, [5.0])["rep@5.0"][0] < 1.0


def _same_summaries(ours: dict, ref: dict) -> None:
    """Equal summaries; an inf (JSON text "inf") equal to an inf."""
    assert ours.keys() == ref.keys()
    for key, value in ref.items():
        a, b = float(ours[key]), float(value)
        if math.isinf(b):
            assert a == b, key
        elif key == "mH_error_lines":
            assert a == pytest.approx(b, rel=H_ERR_RTOL), key
        elif key.startswith("H_error_lines@"):
            assert a == pytest.approx(b, abs=H_AUC_TOL), key
        else:
            assert a == pytest.approx(b, abs=1e-9, nan_ok=True), key


def _jax_draws(monkeypatch):
    """The port's hybrid RANSAC draws JAX's minimal sets (seed 0)."""
    def draws(valid, num_hypotheses, generator=None, size=4):
        return torch.from_numpy(_jax_sample_idx(np.zeros(0, bool), valid.cpu().numpy(), 0,
                                                num_hypotheses))
    monkeypatch.setattr(port_hybrid, "sample_minimal_sets", draws)


def _to_h5(npz, h5):
    with np.load(npz) as f, h5py.File(h5, "w") as h:
        for i, name in enumerate(f["names"]):
            group = h.create_group(str(name))
            for key in f.files:
                if key != "names":
                    group.create_dataset(key, data=f[key][i])


def test_hybrid_ransac_takes_no_points():
    """The line-only estimate of the benchmark (no point, a (0, 2) set) is
    JAX's on the same minimal sets."""
    from gluefactory_torch.robust_estimators import load_estimator
    from gluefactory_tpu.robust_estimators import load_estimator as jax_load_estimator

    rng = np.random.default_rng(8)
    H = np.array([[1.02, 0.03, -9.0], [-0.02, 0.98, 6.0], [1e-4, -2e-4, 1.0]])
    l0 = rng.uniform(0, 320, (30, 2, 2))
    w = np.c_[l0.reshape(-1, 2), np.ones(60)] @ H.T
    l1 = (w[:, :2] / w[:, 2:]).reshape(30, 2, 2) + rng.normal(0, 0.3, (30, 2, 2))
    l1[:6] = rng.uniform(0, 320, (6, 2, 2))
    data = {"m_kpts0": np.zeros((0, 2), np.float32), "m_kpts1": np.zeros((0, 2), np.float32),
            "m_lines0": l0.astype(np.float32), "m_lines1": l1.astype(np.float32)}
    idx = _jax_sample_idx(np.zeros(0, bool), np.ones(30, bool), 0, 1024)
    ours = load_estimator("homography", "hybrid_ransac")({"ransac_th": 3.0})(
        {**{k: torch.from_numpy(v) for k, v in data.items()}, "sample_idx": torch.from_numpy(idx)})
    ref = jax_load_estimator("homography", "hybrid_ransac")(Config({"ransac_th": 3.0}))(
        {k: jnp.asarray(v) for k, v in data.items()})
    assert ours["success"] and bool(ref["success"])
    np.testing.assert_array_equal(ours["line_inliers"].numpy(), np.asarray(ref["line_inliers"]))
    np.testing.assert_allclose(ours["M_0to1"].numpy(), np.asarray(ref["M_0to1"]), atol=1e-4,
                               rtol=1e-3)
    assert ours["inliers"].shape == (0,)


@pytest.fixture(scope="module")
def hpatches_lines_runs(tmp_path_factory):
    """Two rendered sequences (10 pairs) at 240 pixels, LSD+LBD: the port's
    benchmark with JAX's draws, and JAX's own."""
    from gluefactory_tpu.eval.hpatches_lines import HPatchesLinesPipeline as JaxPipeline

    root = tmp_path_factory.mktemp("hp_lines")
    for s in range(2):
        render_sequence(root / "set" / f"v_lines{s}", np.random.default_rng((515151, s)),
                        (320, 240), "a")
    conf = merge(line_conf("hpatches_lines", "lsd_lbd"), {
        "data": {"data_dir": str(root / "set"), "preprocessing": {"resize": 240}}})
    with pytest.MonkeyPatch.context() as mp:
        _jax_draws(mp)
        pipeline = get_benchmark("hpatches_lines")(conf, device="cpu")
        ours = pipeline.run(root / "port")[0]
    jax_pipeline = JaxPipeline(Config(conf))
    ref = jax_pipeline.run(root / "jax")[0]
    return root, jax_pipeline, ours, ref


def test_hpatches_lines_run_eval_is_jaxs(hpatches_lines_runs):
    """JAX's run_eval on the port's predictions (as HDF5) against the
    port's, JAX's minimal sets on both sides."""
    root, jax_pipeline, ours, _ = hpatches_lines_runs
    _to_h5(root / "port" / "predictions.npz", root / "port.h5")
    ref = jax_pipeline.run_eval(jax_pipeline.get_dataloader(), root / "port.h5")[0]
    _same_summaries(ours, ref)
    assert ours["mnum_line_matches"] > 10 and ours["morth_rep@3.0"] > 0.5
    assert "H_error_lines@3px" in ours


def test_hpatches_lines_pipeline_is_jaxs(hpatches_lines_runs):
    """The whole benchmark, each package on its own predictions: LSD is
    OpenCV's bit for bit and LBD within 1e-5, so the summaries are equal."""
    _, _, ours, ref = hpatches_lines_runs
    _same_summaries(ours, ref)


@pytest.fixture(scope="module")
def rdnim_set(tmp_path_factory):
    """Two pairs at the renderer's 640x480: the benchmark's 480-pixel canvas
    then takes OpenCV's area resize, which the port computes bit for bit
    (its linear upsampling parts from OpenCV's in the last bit, enough to
    move LSD's uint8 input)."""
    root = tmp_path_factory.mktemp("rdnim")
    port_rdnim.generate(root / "RDNIM", 2, (640, 480), 314159)
    return root


def test_rdnim_renderer_is_jaxs(rdnim_set, tmp_path, monkeypatch):
    """The port's lossless set against the images that the JAX renderer
    hands to its JPEG writer, and the same homographies."""
    import cv2

    from gluefactory_tpu.scripts import generate_rdnim_set as jax_rdnim

    written = {}
    monkeypatch.setattr(cv2, "imwrite", lambda path, img: written.setdefault(path, img) is None)
    jax_rdnim.generate(tmp_path, 2, (640, 480), 314159)
    assert len(written) == 8
    for path, img in written.items():
        rel = Path(path).relative_to(tmp_path)
        ours = read_image(rdnim_set / "RDNIM" / rel.with_suffix(".ppm"))
        assert (np.abs(ours.astype(int) - img[..., ::-1].astype(int)) > 1).mean() < RENDER_SHARE
        assert np.abs(ours.astype(float) - img[..., ::-1]).mean() < 1.0, rel
        stem = rel.name.split("_")[0]
        np.testing.assert_array_equal(np.loadtxt(rdnim_set / "RDNIM" / rel.parent / f"H_{stem}"),
                                      np.loadtxt(tmp_path / rel.parent / f"H_{stem}"))


def test_rdnim_lines_pipeline_is_jaxs(rdnim_set, tmp_path):
    """RDNIM-lines with LSD+LBD on the port's set (2 pairs): JAX's dataset
    reads the same images through .jpg links (OpenCV decodes by content)."""
    from gluefactory_tpu.eval.rdnim_lines import RDNIMLinesPipeline as JaxPipeline

    with pytest.raises(IOError, match="JPEG"):
        jpg = tmp_path / "jpg" / "day" / "s"
        jpg.mkdir(parents=True)
        (jpg / "H_s").write_text("1 0 0\n0 1 0\n0 0 1\n")
        (jpg / "s_ref.jpg").write_bytes(b"")
        get_benchmark("rdnim_lines")({"data": {"data_dir": str(tmp_path / "jpg")}}, device="cpu")
    jax_root = tmp_path / "jax_set"
    for ppm in (rdnim_set / "RDNIM").glob("*/*/*"):
        target = jax_root / ppm.relative_to(rdnim_set / "RDNIM")
        target = target.with_suffix(".jpg") if ppm.suffix == ".ppm" else target
        target.parent.mkdir(parents=True, exist_ok=True)
        os.symlink(ppm, target)
    conf = merge(line_conf("rdnim_lines", "lsd_lbd"),
                 {"data": {"data_dir": str(rdnim_set / "RDNIM")}})
    with pytest.MonkeyPatch.context() as mp:
        _jax_draws(mp)
        ours = get_benchmark("rdnim_lines")(conf, device="cpu").run(tmp_path / "port")[0]
    jconf = merge(conf, {"data": {"data_dir": str(jax_root)}})
    ref = JaxPipeline(Config(jconf)).run(tmp_path / "jax")[0]
    _same_summaries(ours, ref)
    assert ours["mnum_lines0"] > 30 and ours["mnum_line_matches"] > 3


def test_wireframe_set_and_pipeline_are_jaxs(tmp_path):
    """The port's Wireframe renderer writes JAX's files; the benchmark with
    LSD (3 images at 256 pixels) reads JAX's summaries."""
    from gluefactory_tpu.eval.wireframe import WireframePipeline as JaxPipeline
    from gluefactory_tpu.scripts import generate_wireframe_set as jax_wireframe

    port_wireframe.generate(tmp_path / "port_set", 3, (256, 256), 161803)
    jax_wireframe.generate(tmp_path / "jax_set", 3, (256, 256), 161803)
    for f in sorted((tmp_path / "jax_set" / "test").glob("*.npz")):
        with np.load(f) as a, np.load(tmp_path / "port_set" / "test" / f.name) as b:
            assert a.files == b.files
            for key in ("junctions", "lines"):
                np.testing.assert_array_equal(a[key], b[key])
            assert (a["image"] != b["image"]).mean() < RENDER_SHARE
    conf = merge(line_conf("wireframe", "lsd"), {
        "data": {"data_dir": str(tmp_path / "port_set"), "preprocessing": {"resize": 256}}})
    ours = get_benchmark("wireframe")(conf, device="cpu").run(tmp_path / "port")[0]
    ref = JaxPipeline(Config(conf)).run(tmp_path / "jax")[0]
    _same_summaries(ours, ref)
    assert ours["mnum_gt_lines"] > 20 and ours["morth_rep@5.0px"] > 0.1


# --- the reference numbers of chip_smoke.py phase 20 ---------------------------------

def phase20_conf(root: Path, bench: str, name: str, which: str, side: str) -> dict:
    """A run of chip_smoke_lines.LINE_RUNS on the sets under ``root``; JAX's
    RDNIM reads the .jpg links of ``root / 'rdnim_jpg'``."""
    import chip_smoke_lines as CL
    from gluefactory_torch.settings import ROOT_PATH

    conf = merge(line_conf(bench, name), {"data": CL.run_data(root, which)})
    if side == "jax" and bench == "rdnim_lines":
        conf["data"]["data_dir"] = str(root / "rdnim_jpg")
    if conf.get("checkpoint"):
        conf["checkpoint"] = str(ROOT_PATH / conf["checkpoint"])
    return conf


def link_jpg(src: Path, dst: Path) -> None:
    """``dst``: the RDNIM set of ``src`` with each PPM linked as .jpg."""
    for ppm in src.glob("*/*/*"):
        target = dst / ppm.relative_to(src)
        target = target.with_suffix(".jpg") if ppm.suffix == ".ppm" else target
        target.parent.mkdir(parents=True, exist_ok=True)
        if not target.exists():
            os.symlink(ppm, target)


def reference(side: str, root: Path, out: Path, runs, seeds, table=None) -> None:
    """Print one JSON line of summaries a (run, RANSAC seed) of ``table``
    (phase 20's LINE_RUNS by default): the JAX package's, or the port's on
    the CPU. The later seeds rescore the first one's predictions (only runs
    that match lines use RANSAC)."""
    import importlib
    import json
    import time

    import chip_smoke_lines as CL

    for run, bench, name, which in table or CL.LINE_RUNS:
        if runs and run not in runs:
            continue
        conf = phase20_conf(root, bench, name, which, side)
        matched = "matcher" in conf["model"]
        for i, seed in enumerate(seeds if matched else seeds[:1]):
            if side == "jax":
                from gluefactory_tpu.robust_estimators.homography import hybrid_ransac as jh

                jh.HybridHomographyEstimator.default_conf["seed"] = seed
                module = importlib.import_module(f"gluefactory_tpu.eval.{bench}")
                cls = {"hpatches_lines": "HPatchesLinesPipeline",
                       "rdnim_lines": "RDNIMLinesPipeline",
                       "wireframe": "WireframePipeline"}[bench]
                pipeline = getattr(module, cls)(Config(conf))
            else:
                port_hybrid.HybridHomographyEstimator.default_conf["seed"] = seed
                pipeline = get_benchmark(bench)(conf, device="cpu")
            t = time.perf_counter()
            summaries, _ = pipeline.run(out / side / run, overwrite=i == 0,
                                        overwrite_eval=i > 0)[:2]
            print(json.dumps({"side": side, "run": run, "seed": seed,
                              "seconds": round(time.perf_counter() - t, 1),
                              "summaries": {k: float(v) for k, v in summaries.items()}}),
                  flush=True)


def constants(root: Path) -> None:
    """Print ELSED_JAX and LAP_JAX of chip_smoke_lines: JAX's native
    libraries on the gate views and on LAP_COSTS."""
    import json

    import chip_smoke_lines as CL
    from gluefactory_tpu.models.lines.elsed import detect_elsed_np as jax_elsed

    elsed = {}
    for view, grey in CL.elsed_views(root / "gate").items():
        segs, _, valid = jax_elsed(grey, CL.ELSED_MAX_LINES)
        elsed[view] = CL.elsed_digest(segs, valid)
    print(json.dumps({"ELSED_JAX": elsed,
                      "LAP_JAX": CL.lap_digest(jax_lap(CL.lap_costs(), use_native=True))}))


if __name__ == "__main__":
    import argparse

    parser = argparse.ArgumentParser(description="The JAX package's numbers of "
                                     "chip_smoke.py phase 20, on the sets it renders")
    parser.add_argument("--root", type=Path, required=True)
    parser.add_argument("--out", type=Path)
    parser.add_argument("--render", action="store_true")
    parser.add_argument("--constants", action="store_true")
    parser.add_argument("--side", choices=("jax", "port"), default="jax")
    parser.add_argument("--runs", nargs="*")
    parser.add_argument("--seeds", type=int, nargs="*", default=[0, 1, 2])
    args = parser.parse_args()
    if args.render:
        import chip_smoke
        import chip_smoke_lines

        chip_smoke_lines.render_line_sets(args.root, hpatches=True)
        chip_smoke.gate_pairs(args.root / "gate", "cpu")
        link_jpg(args.root / "rdnim", args.root / "rdnim_jpg")
    if args.constants:
        constants(args.root)
    if args.out:
        reference(args.side, args.root, args.out, args.runs, args.seeds)
