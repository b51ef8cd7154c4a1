"""The port and chip_smoke.py import and run (the flagship pipeline and a
training step) with none of the JAX stack and none of the packages the GPU
machine lacks (a stand-in, on the CPU, for the GPU machine's environment)."""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
BLOCKED = ("jax", "flax", "gluefactory_tpu", "msgpack", "cv2", "yaml", "h5py", "omegaconf")

SCRIPT = """
import sys
for name in {blocked!r}:
    sys.modules[name] = None  # any import of it raises ImportError
sys.path.insert(0, {root!r})
import importlib, pkgutil
import numpy as np
import torch
import chip_smoke
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
