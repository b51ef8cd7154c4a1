"""Training recipes as conf dicts, copies of the JAX package's YAML files (the
GPU machine has no ``yaml``; tests hold each dict equal to its file)."""

from __future__ import annotations

import copy

from .settings import WEIGHTS_PATH

# the stage's own output: both halves, and the init of stage 3
STAGE2_WEIGHTS = WEIGHTS_PATH / "lg_tpu_stage2.f16.msgpack"
# the stage-5 recipe's start: LightGlue and the soft-label SuperPoint
STAGE5_WEIGHTS = WEIGHTS_PATH / "lg5_init_spsoft.f16.msgpack"
# SuperPoint stage 0b, the start of SuperPoint stage 1 (its tree under ['extractor'])
SP_STAGE0B_WEIGHTS = WEIGHTS_PATH / "sp_tpu_stage0b.f16.msgpack"

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


def hpatches_adaptive_conf() -> dict:
    """The HPatches flagship with adaptive LightGlue at the adaptive card's
    thresholds (``superpoint+lightglue_adaptive.yaml``): early exit by token
    confidence (``depth_confidence: 0.95``) and width pruning
    (``width_confidence: 0.99``)."""
    conf = hpatches_flagship_conf()
    conf["model"]["matcher"].update(depth_confidence=0.95, width_confidence=0.99)
    return conf


_SP_DATA = {  # the on-device engine as the three SuperPoint recipes set it
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
}
_SP_EXTRACTOR = {"name": "extractors.superpoint", "max_num_keypoints": 512,
                 "detection_threshold": 0.0005, "nms_radius": 4}
_SP_DESC_LOSSES = {"desc_weight": 1.0, "desc_nll_weight": 1.0, "desc_nll_temp": 0.1,
                   "desc_match_th": 3.0, "desc_caps_weight": 1.0, "desc_caps_window": 24.0}

_SP_STAGE0 = {  # gluefactory_tpu/configs/superpoint_train_ondevice.yaml
    "data": _SP_DATA,
    "model": {"name": "two_view_pipeline",
              "extractor": {**_SP_EXTRACTOR, "training_outputs": True}},
    "train": {
        "seed": 7,
        "epochs": 24,
        "optimizer": "adam",
        "lr": 0.001,
        "lr_schedule": {"type": "exp", "start": 3000, "exp_div_10": 6000},
        "eval_every_iter": 250,
        "log_every_iter": 50,
        "keep_last_checkpoints": 3,
        "clip_grad": 5.0,
        "best_key": "loss/total",
    },
}

_SP_STAGE1 = {  # gluefactory_tpu/configs/superpoint_stage1_r3.yaml
    "data": _SP_DATA,
    "model": {"name": "two_view_pipeline",
              "extractor": {**_SP_EXTRACTOR, "refinement_radius": 2, "training_outputs": True,
                            "loss": {"loc_weight": 3.0, "loc_radius": 2, "loc_max_dist": 4.0,
                                     "peaky_weight": 0.5, "peaky_radius": 2,
                                     **_SP_DESC_LOSSES}}},
    "train": {
        "seed": 23,
        "epochs": 40,
        "optimizer": "adam",
        "lr": 0.0003,
        "lr_schedule": {"type": "exp", "start": 2000, "exp_div_10": 8000},
        "eval_every_iter": 250,
        "save_every_iter": 1000,
        "log_every_iter": 50,
        "keep_last_checkpoints": 3,
        "clip_grad": 5.0,
        "best_key": "loss/total",
        "load_experiment": "weights/sp_tpu_stage0b.f16.msgpack",
    },
}

_SP_SOFT = {  # gluefactory_tpu/configs/superpoint_stage2_soft_r4.yaml
    "data": _SP_DATA,
    "model": {"name": "two_view_pipeline",
              "extractor": {**_SP_EXTRACTOR, "refinement_radius": 2, "refinement_mode": "com",
                            "training_outputs": True,
                            "loss": {"cell_labels": "soft", "cell_pos_weight": 32.0,
                                     "loc_weight": 3.0, "loc_radius": 2, "loc_anchor": "gt",
                                     "peaky_weight": 0.0, **_SP_DESC_LOSSES}}},
    "train": {
        "seed": 44,
        "epochs": 40,
        "optimizer": "adam",
        "lr": 0.001,
        "lr_schedule": {"type": "exp", "start": 3000, "exp_div_10": 8000},
        "eval_every_iter": 250,
        "save_every_iter": 1000,
        "log_every_iter": 50,
        "keep_last_checkpoints": 3,
        "clip_grad": 5.0,
        "best_key": "loss/total",
    },
}


def sp_stage0_conf() -> dict:
    """SuperPoint stage 0: detector and descriptor trained from scratch on
    the on-device engine's exact corner ground truth, hard cell labels and
    the dense cell hinge only."""
    return copy.deepcopy(_SP_STAGE0)


def sp_stage1_conf() -> dict:
    """SuperPoint stage 1 (round 3): stage 0b (``SP_STAGE0B_WEIGHTS``)
    continued with the whole loss stack: the softargmax localisation at the
    GT corners, peakiness, the keypoint InfoNCE and CAPS beside the hinge."""
    return copy.deepcopy(_SP_STAGE1)


def sp_soft_conf() -> dict:
    """SuperPoint from scratch with soft bilinear cell labels and the CoM
    readout (round 4), the stage-1 descriptor losses, no peakiness."""
    return copy.deepcopy(_SP_SOFT)
