"""The port and chip_smoke.py import and run (the flagship pipeline and a
training step) with none of the JAX stack and none of the packages the GPU
machine lacks (a stand-in, on the CPU, for the GPU machine's environment)."""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
BLOCKED = ("jax", "flax", "gluefactory_tpu", "msgpack", "cv2", "yaml", "h5py", "omegaconf",
           "scipy")

SCRIPT = """
import sys
for name in {blocked!r}:
    sys.modules[name] = None  # any import of it raises ImportError
sys.path.insert(0, {root!r})
import importlib, pkgutil
import numpy as np
import torch
torch.set_num_threads(2)  # beside the suite's workers: threads that wait on each other
import chip_smoke
import chip_smoke_gluestick
import chip_smoke_lines
import chip_smoke_jpldd
import chip_smoke_loftr
import chip_smoke_sfm
import attention_variants
import gluefactory_torch
for mod in pkgutil.walk_packages(gluefactory_torch.__path__, "gluefactory_torch."):
    importlib.import_module(mod.name)

from gluefactory_torch.models import build_model
from gluefactory_torch.robust_estimators import load_estimator

torch.manual_seed(0)
conf = {{
    "extractor": {{"name": "extractors.superpoint", "max_num_keypoints": 48,
                  "channels": [8, 8, 16, 16, 32, 32, 32, 32], "head_channels": 32,
                  "descriptor_dim": 32, "refinement_radius": 2, "refinement_mode": "com",
                  "detection_threshold": 0.0}},
    "matcher": {{"name": "matchers.lightglue", "input_dim": 32, "descriptor_dim": 32,
                "n_layers": 2, "num_heads": 2, "filter_threshold": 0.0}},
    "filter": {{"name": "matchers.match_refiner"}},
}}
model = build_model("two_view_pipeline", conf, device="cpu")
estimator = load_estimator("homography", "ransac")({{"num_hypotheses": 64}})
import tempfile
from pathlib import Path

with tempfile.TemporaryDirectory() as tmp:
    img0, img1, H = chip_smoke.gate_pairs(Path(tmp) / "gate", "cpu")[0]
    pred, quality = chip_smoke.run_pair(model, estimator, img0, img1, H)
    assert pred["keypoints1"].shape == (1, 48, 2) and pred["matches0"].shape == (1, 48)
    assert bool(torch.isfinite(pred["keypoints1"]).all()) and quality["h_err"] >= 0

    # the benchmark entry point, on a set rendered by the port
    from gluefactory_torch.eval.hpatches import HPatchesPipeline
    from gluefactory_torch.scripts.generate_eval_set import generate

    generate(Path(tmp) / "hp", 1, (128, 96), 0, family="b", illum_seqs=1)
    bench = HPatchesPipeline({{"data": {{"data_dir": str(Path(tmp) / "hp"),
                                         "preprocessing": {{"resize": 128}}}},
                               "model": {{**conf, "name": "two_view_pipeline"}},
                               "eval": {{"num_hypotheses": 64}}}}, device="cpu")
    summaries, results = bench.run(Path(tmp) / "eval", model=model)
    assert len(results["names"]) == 10 and "H_error_ransac_mAA_i" in summaries, summaries

    # the relative-pose benchmark, on a pose set rendered by the port
    from gluefactory_torch.eval.megadepth1500 import MegaDepth1500Pipeline
    from gluefactory_torch.scripts.generate_pose_eval_set import render_pose_scene, write_pairs

    write_pairs(Path(tmp) / "pose", render_pose_scene(Path(tmp) / "pose" / "s0",
                                                      np.random.default_rng(0), (160, 120)))
    pose = MegaDepth1500Pipeline({{"data": {{"pairs": str(Path(tmp) / "pose" / "pairs_calibrated.txt"),
                                            "root": str(Path(tmp) / "pose"),
                                            "preprocessing": {{"resize": 160}}}},
                                  "model": {{**conf, "name": "two_view_pipeline"}},
                                  "eval": {{"num_hypotheses": 32}}}}, device="cpu")
    summaries, results = pose.run(Path(tmp) / "pose_eval", model=model)
    assert len(results["names"]) == 2 and "rel_pose_error_mAA" in summaries, summaries
from gluefactory_torch.train import training

tconf = {{"data": {{"name": "homographies_ondevice", "pool_size": 2, "source_size": [96, 96],
                  "image_size": 64, "max_gt_points": 32, "train_batch_size": 2}},
         "model": {{**conf, "name": "two_view_pipeline",
                   "matcher": {{**conf["matcher"], "filter_threshold": 0.1}},
                   "filter": {{"name": None}},
                   "ground_truth": {{"name": "matchers.homography_matcher"}},
                   "run_gt_in_forward": True}},
         "train": {{"lr": 1e-4}}}}
with tempfile.TemporaryDirectory() as tmp:
    _, history = training(tconf, Path(tmp) / "train", steps=1, device="cpu")
assert history[0]["skipped"] == 0.0 and history[0]["loss/total"] > 0

# the stage-5 path in miniature: bf16, validation, the benchmark on an
# overlay, checkpoints (msgpack encoder, JSON config.yaml) and a restore
import argparse, json

from gluefactory_torch.utils.experiments import load_experiment

for comp in ("extractor", "matcher"):
    tconf["model"][comp]["dtype"] = "bf16"
tconf["data"].update(val_pool_size=2, val_batch_size=2, val_steps=1, steps_per_epoch=2)
with tempfile.TemporaryDirectory() as tmp:
    generate(Path(tmp) / "hp", 1, (128, 96), 0)
    tconf["train"].update(epochs=1, eval_every_iter=2, log_every_iter=1,
                          best_key="bench/hpatches/mnum_keypoints", best_mode="max",
                          run_benchmarks=[{{"name": "hpatches", "conf": {{
                              "data": {{"data_dir": str(Path(tmp) / "hp"),
                                        "preprocessing": {{"resize": 128}}}},
                              "eval": {{"num_hypotheses": 64}}}},
                              "model": {{"extractor": {{"max_num_keypoints": 40}},
                                        "ground_truth": {{"name": None}},
                                        "run_gt_in_forward": False}}}}])
    run = Path(tmp) / "stage5"
    training(tconf, run, device="cpu")
    tconf["train"]["epochs"] = 2
    trainer, resumed = training(tconf, run, argparse.Namespace(restore=True), device="cpu")
    assert len(resumed) == 2 and trainer.optimizer.count == 4
    blob, saved = load_experiment(str(run), best=True)
    assert blob["eval"]["bench/hpatches/mnum_keypoints"] == 40.0 and saved == trainer.conf
    records = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    assert any("val/match_AP" in r for r in records)
# the cached-feature engine (a pool cache written and read back), the host
# homography dataset with the lg photometrics, and a blob loaded as a
# benchmark loads a run
from gluefactory_torch import settings
from gluefactory_torch.datasets.homographies import HomographyDataset
from gluefactory_torch.datasets.homographies_ondevice import (
    OnDeviceCachedFeatureDataset,
    upload_pool,
)
from gluefactory_torch.eval.io import load_model
from gluefactory_torch.recipes import hpatches_flagship_conf

with tempfile.TemporaryDirectory() as tmp:
    settings.DATA_PATH = Path(tmp)
    cconf = {{"pool_size": 2, "source_size": [96, 96], "image_size": 64, "train_batch_size": 2,
             "features_from": {{"experiment": "weights/sp_tpu_stage0b.f16.msgpack",
                               "max_num_keypoints": 32, "batch": 2}}}}
    built = OnDeviceCachedFeatureDataset(cconf).build_pool("train", "cpu")
    read = OnDeviceCachedFeatureDataset(cconf).build_pool("train", "cpu")
    assert all(np.array_equal(built[k], read[k]) for k in built)
    batch = OnDeviceCachedFeatureDataset(cconf).make_batch(upload_pool(read, "cpu"), 0)
    assert batch["view0"]["cache"]["descriptors"].shape == (2, 32, 256)
item = HomographyDataset({{"synthetic": True, "image_size": 64,
                          "synthetic_source_size": [96, 80]}}).get_dataset("train").getitem(
    0, np.random.default_rng(0))
assert item["view1"]["image"].shape == (64, 64, 3) and item["H_0to1"].shape == (3, 3)
flagship = hpatches_flagship_conf()
assert load_model(flagship["model"], flagship["checkpoint"], "cpu").matcher is not None
# SIFT and SuperGlue from its blob by the benchmark recipe, on a gate pair
from gluefactory_torch.recipes import hpatches_sift_superglue_conf

sg = hpatches_sift_superglue_conf()
sg["model"]["extractor"]["max_num_keypoints"] = 64
sg_model = load_model(sg["model"], sg["checkpoint"], "cpu")
with tempfile.TemporaryDirectory() as tmp:
    pred, quality = chip_smoke.run_pair(sg_model, estimator,
                                        *chip_smoke.gate_pairs(Path(tmp) / "gate", "cpu")[0])
    assert pred["matches0"].shape == (1, 64) and int((pred["matches0"] > -1).sum()) > 10
# the ETH3D benchmark on a scene the port renders, the feature cache and the
# filter-slot and ground-truth models of the eleventh slice
from gluefactory_torch.eval.eth3d import ETH3DPipeline
from gluefactory_torch.eval.timing_measurement import measure_pipeline
from gluefactory_torch.datasets.image_folder import ImageFolderDataset
from gluefactory_torch.models.cache_loader import CacheLoader
from gluefactory_torch.scripts.export_features import export_features, view_cache
from gluefactory_torch.scripts.generate_eth3d_set import render_eth3d_scene

with tempfile.TemporaryDirectory() as tmp:
    render_eth3d_scene(Path(tmp) / "set" / "scene000", np.random.default_rng(0), (160, 120),
                       n_views=3, n_points=400)
    eth = ETH3DPipeline({{"data": {{"data_dir": str(Path(tmp) / "set"), "min_covisible": 100,
                                    "preprocessing": {{"resize": 160}}}},
                         "model": {{**conf, "name": "two_view_pipeline",
                                   "filter": {{"name": "matchers.match_refiner",
                                              "window_sampling": "static"}}}}}}, device="cpu")
    summaries, results = eth.run(Path(tmp) / "eth_eval", model=model)
    assert len(results["names"]) == 3 and 0 <= summaries["AP"] <= 100, summaries
    folder = ImageFolderDataset({{"images": str(Path(tmp) / "set" / "scene000" / "images"),
                                  "preprocessing": {{"resize": 160}}}})
    out = export_features(folder, model.extractor, Path(tmp) / "sp.npz", device="cpu")
    cache = view_cache(CacheLoader({{"path": str(out)}}), "view1.ppm", folder[1]["scales"], "cpu")
    assert cache["keypoints"].shape == (1, 48, 2) and cache["descriptors"].dtype == torch.float32
    assert measure_pipeline(model, 1, 64, iters=1, warmup=1, device="cpu")["pairs_per_s"] > 0
adalam = build_model("two_view_pipeline", {{**conf, "filter": {{"name": "matchers.adalam"}}}},
                     device="cpu")
size = torch.tensor([[img0.shape[1], img0.shape[0]]], dtype=torch.float32)
views = {{f"view{{i}}": {{"image": img[None], "image_size": size}} for i, img in enumerate((img0, img1))}}
assert "adalam_kept" in adalam(views)
for name in ("matchers.depth_matcher", "matchers.oracle_matcher"):
    build_model(name, device="cpu")
# the twelfth slice: the port's LSD (host C++), the wireframe, GlueStick,
# hybrid RANSAC and the extended benchmarks
from gluefactory_torch.eval import get_benchmark

gs = build_model("two_view_pipeline", {{
    "extractor": {{"name": "lines.wireframe",
                  "point_extractor": {{**conf["extractor"], "dense_outputs": True}},
                  "line_extractor": {{"name": "lines.lsd", "max_num_lines": 16}}}},
    "matcher": {{"name": "matchers.gluestick", "input_dim": 32, "descriptor_dim": 32,
                "n_layers": 1, "filter_threshold": 0.0}}}}, device="cpu")
pred = gs(views)
assert pred["line_matches0"].shape == (1, 16) and pred["keypoints0"].shape == (1, 80, 2)
assert int(pred["valid_lines0"].sum()) > 0
kp = torch.rand(40, 2) * 100
est = load_estimator("homography", "hybrid_ransac")({{"num_hypotheses": 32}})(
    {{"m_kpts0": kp, "m_kpts1": kp + 1.0, "m_lines0": kp[:10].reshape(5, 2, 2),
      "m_lines1": kp[:10].reshape(5, 2, 2) + 1.0}})
assert est["success"] and est["line_inliers"].shape == (5,)
for name in ("hpatches_extended", "megadepth1500_extended"):
    assert get_benchmark(name).__module__.startswith("gluefactory_torch.eval.")
# the thirteenth slice: GlueStick training on the cached-wireframe engine (the
# wireframe pool extracted on_host, the line ground truth, the loss, remat)
from gluefactory_torch.recipes import gluestick_cached_conf

gconf = gluestick_cached_conf()
gconf["data"].update(pool_size=2, val_pool_size=1, source_size=[96, 96], image_size=64,
                     train_batch_size=2)
gconf["data"]["features_from"].update(
    weights=None, point_extractor={{**conf["extractor"], "dense_outputs": True,
                                    "max_num_keypoints": 16}},
    line_extractor={{"name": "lines.lsd", "max_num_lines": 8}})
gconf["model"]["matcher"].update(n_layers=1, input_dim=32, descriptor_dim=32,
                                 checkpointed=True, inter_supervision=[0])
with tempfile.TemporaryDirectory() as tmp:
    settings.DATA_PATH = Path(tmp)
    _, history = training(gconf, Path(tmp) / "gs", steps=1, device="cpu")
assert history[0]["skipped"] == 0.0 and np.isfinite(history[0]["loss/line_nll_0"]), history
# the sixteenth slice: LoFTR from its blob by a committed HPatches conf's model
# (no extractor, the refiner), and a step of its on-device recipe
from gluefactory_torch.eval.io import load_model
from gluefactory_torch.recipes import hpatches_loftr_conf, loftr_ondevice_conf
lconf = hpatches_loftr_conf("loftr_stage0b_refine")
lmodel = load_model(lconf["model"], lconf["checkpoint"], "cpu")
limg = torch.rand(1, 48, 64, 3)
with torch.inference_mode():
    lpred = lmodel({{"view0": {{"image": limg}}, "view1": {{"image": limg}}}})
assert lpred["keypoint_valid0"].sum() > 0 and "refined1" in lpred
lconf = loftr_ondevice_conf()
lconf["data"].update(pool_size=2, val_pool_size=1, source_size=[96, 96], image_size=64,
                     train_batch_size=1)
lconf["model"].update(initial_dim=8, block_dims=[8, 8, 16], fine_dim=8, heads=2)
with tempfile.TemporaryDirectory() as tmp:
    _, history = training(lconf, Path(tmp) / "loftr", steps=1, device="cpu")
assert history[0]["skipped"] == 0.0 and np.isfinite(history[0]["loss/fine_l2"]), history
# the seventeenth slice: run_sfm on a tiny chain of views, and a trajectory scene
from gluefactory_torch.geometry.wrappers import Camera
from gluefactory_torch.scripts.sfm_trajectory import render_trajectory_scene, run_scene
from gluefactory_torch.sfm import run_sfm

rng = np.random.default_rng(0)
X = np.c_[rng.uniform(-1, 1, (40, 2)), rng.uniform(4, 6, 40)]
uv = np.stack([(X + [0.2 * v, 0.0, 0.0])[:, :2] / X[:, 2:] * 100 + [80, 60] for v in range(3)])
cams = Camera.from_fc([[160.0, 120.0]] * 3, [[100.0, 100.0]] * 3, [[80.0, 60.0]] * 3)
sfm = run_sfm(uv.astype(np.float32), np.ones((3, 40), bool),
              {{(0, 1): np.arange(40), (1, 2): np.arange(40)}}, cams, num_hypotheses=32,
              ba_iters=3, device="cpu")
assert sfm["points"].shape == (40, 3) and sfm["ba_info"]["costs"].shape == (3,)
sift = build_model("two_view_pipeline", {{
    "extractor": {{"name": "extractors.sift", "max_num_keypoints": 128}},
    "matcher": {{"name": "matchers.nearest_neighbor_matcher", "mutual_check": True}}}},
    device="cpu")
with tempfile.TemporaryDirectory() as tmp:
    render_trajectory_scene(Path(tmp) / "scene", np.random.default_rng(0), (160, 120), n_views=3)
    res = run_scene(Path(tmp) / "scene", sift, "cpu")
    assert res["n_matches_mean"] > 10 and res["ba_cost_last"] <= res["ba_cost_first"], res
leaked = sorted(m for m in sys.modules if m.split(".")[0] in {blocked!r}
                and sys.modules[m] is not None)
assert not leaked, leaked
print("ok")
"""


def test_port_runs_without_jax_and_missing_packages():
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT.format(blocked=BLOCKED, root=str(ROOT))],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0 and proc.stdout.strip().endswith("ok"), proc.stderr[-4000:]


def test_chip_smoke_without_the_repository_fails(tmp_path):
    """Copied alone into an empty directory, chip_smoke.py fails before it
    prints any result line."""
    (tmp_path / "chip_smoke.py").write_text((ROOT / "chip_smoke.py").read_text())
    proc = subprocess.run([sys.executable, "chip_smoke.py"], capture_output=True, text=True,
                          timeout=300, cwd=tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
