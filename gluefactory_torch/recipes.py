"""Training recipes as conf dicts, copies of the JAX package's YAML files (the
GPU machine has no ``yaml``; tests hold each dict equal to its file)."""

from __future__ import annotations

import copy

from .settings import WEIGHTS_PATH

# the stage's own output: both halves, and the init of stage 3
STAGE2_WEIGHTS = WEIGHTS_PATH / "lg_tpu_stage2.f16.msgpack"
# the stage-5 recipe's start: LightGlue and the soft-label SuperPoint
STAGE5_WEIGHTS = WEIGHTS_PATH / "lg5_init_spsoft.f16.msgpack"

_STAGE2 = {  # gluefactory_tpu/configs/superpoint+lightglue_stage2.yaml
    "data": {
        "name": "homographies_ondevice",
        "pool_size": 768,
        "val_pool_size": 64,
        "source_size": [448, 448],
        "image_size": 320,
        "max_gt_points": 192,
        "train_batch_size": 32,
        "val_batch_size": 32,
        "steps_per_epoch": 250,
        "val_steps": 4,
        "homography": {"difficulty": 0.7, "translation": 0.3, "max_angle": 45.0},
        "photometric": {"p": 0.95, "strength": 1.0},
    },
    "model": {
        "name": "two_view_pipeline",
        "extractor": {"name": "extractors.superpoint", "max_num_keypoints": 512,
                      "detection_threshold": 0.0005, "nms_radius": 4, "trainable": False},
        "matcher": {"name": "matchers.lightglue", "filter_threshold": 0.1, "n_layers": 6,
                    "checkpointed": False},
        "ground_truth": {"name": "matchers.homography_matcher", "th_positive": 3.0,
                         "th_negative": 6.0},
        "run_gt_in_forward": True,
    },
    "train": {
        "seed": 2,
        "epochs": 40,
        "optimizer": "adam",
        "lr": 2.5e-05,
        "lr_schedule": {"type": "exp", "start": 4000, "exp_div_10": 20000},
        "eval_every_iter": 250,
        "save_every_iter": 5000,
        "log_every_iter": 50,
        "keep_last_checkpoints": 3,
        "load_experiment": "lg_r2_sp0b",
        "clip_grad": 1.0,
        "best_key": "loss/total",
    },
}


def stage2_conf() -> dict:
    """Stage 2: LightGlue fine-tuned on the frozen stage-0b SuperPoint, on the
    on-device homography engine. Its ``load_experiment`` is not committed;
    start from ``STAGE2_WEIGHTS`` instead."""
    return copy.deepcopy(_STAGE2)


_STAGE5 = {  # gluefactory_tpu/configs/superpoint+lightglue_stage5_r4.yaml
    "data": {
        "name": "homographies_ondevice",
        "pool_size": 768,
        "val_pool_size": 64,
        "source_size": [448, 448],
        "image_size": 320,
        "max_gt_points": 192,
        "train_batch_size": 32,
        "val_batch_size": 32,
        "steps_per_epoch": 250,
        "val_steps": 4,
        "homography": {"difficulty": 0.7, "translation": 0.3, "max_angle": 45.0},
        "photometric": {"p": 0.95, "strength": 1.0},
    },
    "model": {
        "name": "two_view_pipeline",
        "extractor": {"name": "extractors.superpoint", "max_num_keypoints": 512,
                      "detection_threshold": 0.0005, "nms_radius": 4, "refinement_radius": 2,
                      "refinement_mode": "com", "trainable": False, "dtype": "bf16"},
        "matcher": {"name": "matchers.lightglue", "filter_threshold": 0.1, "n_layers": 6,
                    "checkpointed": False, "dtype": "bf16"},
        "ground_truth": {"name": "matchers.homography_matcher", "th_positive": 3.0,
                         "th_negative": 6.0},
        "run_gt_in_forward": True,
    },
    "train": {
        "seed": 45,
        "epochs": 48,
        "optimizer": "adam",
        "lr": 1.0e-4,
        "lr_schedule": {"type": "exp", "start": 2500, "exp_div_10": 10000},
        "eval_every_iter": 250,
        "save_every_iter": 2000,
        "log_every_iter": 50,
        "keep_last_checkpoints": 3,
        "clip_grad": 1.0,
        "load_experiment": "weights/lg5_init_spsoft.f16.msgpack",
        "best_key": "bench/hpatches/H_error_ransac_mAA",
        "best_mode": "max",
        "benchmark_every_epoch": 2,
        "run_benchmarks": [{
            "name": "hpatches",
            "conf": {"data": {"max_seqs": 8}, "eval": {"ransac_th": -1.0}},
            "model": {"extractor": {"max_num_keypoints": 1024},
                      "matcher": {"filter_threshold": 0.1},
                      "ground_truth": {"name": None}, "run_gt_in_forward": False},
        }],
    },
}


def stage5_conf() -> dict:
    """Stage 5: LightGlue retrained in bf16 on the on-device engine with the
    frozen soft-label SuperPoint (CoM readout, bf16) in the loop, from
    ``weights/lg5_init_spsoft.f16.msgpack`` (``STAGE5_WEIGHTS``); at every
    second epoch end the HPatches benchmark at the eval operating point (1024
    keypoints, the RANSAC sweep, no ground truth in the forward) on 8
    sequences picks ``checkpoint_best`` by its mAA."""
    return copy.deepcopy(_STAGE5)


_HPATCHES_FLAGSHIP = {  # outputs/results/hpatches/sp0b_lg2_com_refine/conf.yaml
    "data": {
        "name": "hpatches",
        "test_batch_size": 1,
        "num_workers": 2,
        "preprocessing": {"resize": 480, "side": "long", "square_pad": True},
    },
    "model": {
        "name": "two_view_pipeline",
        "extractor": {"name": "extractors.superpoint", "max_num_keypoints": 1024,
                      "detection_threshold": 0.005, "refinement_radius": 2,
                      "refinement_mode": "com"},
        "matcher": {"name": "matchers.lightglue", "filter_threshold": 0.1,
                    "depth_confidence": -1, "width_confidence": -1,
                    "save_layer_outputs": False, "checkpointed": False, "n_layers": 6},
        "ground_truth": {"name": None},
        "run_gt_in_forward": False,
        "filter": {"name": "matchers.match_refiner"},
    },
    "eval": {"estimator": "ransac", "ransac_th": -1.0, "num_hypotheses": 1024},
    "checkpoint": "weights/lg_tpu_stage2.f16.msgpack",
}


def hpatches_flagship_conf() -> dict:
    """The flagship on the HPatches benchmark at 1024 keypoints, the conf of
    the published famA/famB numbers: SuperPoint with the CoM readout, 6-layer
    LightGlue, the ZNCC refiner (window mode off the TPU), RANSAC swept over 6
    thresholds with 1024 hypotheses each. ``checkpoint`` is relative to the
    repository root. famB sets ``data.data_dir`` to its own set."""
    return copy.deepcopy(_HPATCHES_FLAGSHIP)


_POSE_FLAGSHIP = {  # outputs/results/megadepth1500/sp0b_lg2_com_refine_pose/conf.yaml
    "data": {
        "name": "image_pairs",
        "pairs": "pose-eval/pairs_calibrated.txt",
        "root": "pose-eval/images",
        "preprocessing": {"resize": 1600, "side": "long", "square_pad": True},
        "test_batch_size": 1,
        "num_workers": 2,
    },
    "model": {
        "name": "two_view_pipeline",
        "extractor": {"name": "extractors.superpoint", "max_num_keypoints": 1024,
                      "detection_threshold": 0.005, "refinement_radius": 2,
                      "refinement_mode": "com"},
        "matcher": {"name": "matchers.lightglue", "filter_threshold": 0.1,
                    "depth_confidence": -1, "width_confidence": -1,
                    "save_layer_outputs": False, "checkpointed": False, "n_layers": 6},
        "ground_truth": {"name": None},
        "run_gt_in_forward": False,
        "filter": {"name": "matchers.match_refiner"},
    },
    "eval": {"estimator": "ransac", "ransac_th": -1.0, "num_hypotheses": 2048, "lo_iters": 6},
    "checkpoint": "weights/lg_tpu_stage2.f16.msgpack",
}


def pose_flagship_conf() -> dict:
    """The flagship on the relative-pose benchmark, the conf of the published
    pose numbers: the HPatches flagship (CoM readout, 6-layer LightGlue, the
    ZNCC refiner) at 1024 keypoints on a 1600-pixel canvas, 5-point
    LO-RANSAC swept over 6 thresholds with 2048 hypotheses and 6 LO steps
    each, on the rendered set of ``scripts/generate_pose_eval_set.py`` under
    ``data/pose-eval``."""
    return copy.deepcopy(_POSE_FLAGSHIP)
