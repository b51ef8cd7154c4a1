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


# --- LightGlue on the cached-feature engine, the host dataset, and the rest --------------

# the stage-0 SuperPoint alone, the start of superpoint_finetune_loc and of the
# on-device LightGlue recipe
SP_STAGE0_WEIGHTS = WEIGHTS_PATH / "sp_tpu_stage0.f16.msgpack"
# the SuperPoint of stage 1c (soft labels, CoM), the features of LightGlue stage 3
SP_STAGE1C_WEIGHTS = WEIGHTS_PATH / "sp_tpu_stage1c.f16.msgpack"
# both halves of the round-2 on-device LightGlue, the start of its round-3 recipe
LG_STAGE1_R2_WEIGHTS = WEIGHTS_PATH / "lg_tpu_stage1_r2.f16.msgpack"

_CACHED_DATA = {  # the cached-feature engine as LightGlue stages 3 and 4 set it
    "name": "homographies_ondevice_cached",
    "pool_size": 768,
    "val_pool_size": 64,
    "source_size": [448, 448],
    "image_size": 320,
    "train_batch_size": 32,
    "val_batch_size": 32,
    "steps_per_epoch": 250,
    "val_steps": 4,
    "features_from": {"name": "extractors.superpoint", "experiment": None,
                      "max_num_keypoints": 512, "detection_threshold": 0.0005,
                      "nms_radius": 4, "refinement_radius": 2, "refinement_mode": "com",
                      "batch": 16},
    "desc_noise": 0.02,
    "desc_dropout": 0.03,
    "kp_noise": 0.5,
    "homography": {"difficulty": 0.8, "translation": 0.35, "max_angle": 60.0},
}
_MATCHER_ONLY = {
    "name": "two_view_pipeline",
    "extractor": {"name": None},
    "allow_no_extract": True,
    "matcher": {"name": "matchers.lightglue", "filter_threshold": 0.1, "n_layers": 6,
                "checkpointed": False},
    "ground_truth": {"name": "matchers.homography_matcher", "th_positive": 3.0,
                     "th_negative": 6.0},
    "run_gt_in_forward": True,
}
_CACHED_TRAIN = {
    "optimizer": "adam",
    "lr": 1.0e-4,
    "lr_schedule": {"type": "exp", "start": 3000, "exp_div_10": 12000},
    "eval_every_iter": 250,
    "save_every_iter": 2000,
    "log_every_iter": 50,
    "keep_last_checkpoints": 3,
    "clip_grad": 1.0,
    "best_key": "loss/total",
    "load_experiment": "weights/lg_tpu_stage2.f16.msgpack",
}


def stage4_conf() -> dict:
    """LightGlue stage 4 (``superpoint+lightglue_stage4_r3.yaml``): the
    matcher alone retrained on the cached-feature engine, on the features of
    the stage-0b SuperPoint with the CoM readout (``SP_STAGE0B_WEIGHTS``,
    extracted once), keypoints jittered by 0.5 px; from
    ``weights/lg_tpu_stage2.f16.msgpack`` (``STAGE2_WEIGHTS``; its
    ``['extractor']`` half is dropped). Both blobs are committed."""
    conf = {"data": copy.deepcopy(_CACHED_DATA), "model": copy.deepcopy(_MATCHER_ONLY),
            "train": {"seed": 47, "epochs": 32, **copy.deepcopy(_CACHED_TRAIN)}}
    conf["data"]["features_from"]["experiment"] = "weights/sp_tpu_stage0b.f16.msgpack"
    return conf


def stage3_conf() -> dict:
    """LightGlue stage 3 (``superpoint+lightglue_stage3_r3.yaml``): stage 4's
    recipe on the features of the run ``sp_tpu_stage1c_r3``, which is not in
    the repository: its export is ``SP_STAGE1C_WEIGHTS``
    (``weights/sp_tpu_stage1c.f16.msgpack``), so a run sets
    ``data.features_from.experiment`` to that blob. From ``STAGE2_WEIGHTS``."""
    conf = {"data": copy.deepcopy(_CACHED_DATA), "model": copy.deepcopy(_MATCHER_ONLY),
            "train": {"seed": 37, "epochs": 48, **copy.deepcopy(_CACHED_TRAIN)}}
    conf["data"]["features_from"]["experiment"] = "sp_tpu_stage1c_r3"
    return conf


_LG_HOMOGRAPHY = {  # gluefactory_tpu/configs/superpoint+lightglue_homography.yaml
    "data": {
        "name": "homographies",
        "synthetic": True,
        "image_size": 640,
        "train_batch_size": 32,
        "val_batch_size": 16,
        "num_workers": 8,
        "homography": {"difficulty": 0.7, "max_angle": 45.0},
        "photometric": {"name": "lg"},
    },
    "model": {
        "name": "two_view_pipeline",
        "extractor": {"name": "extractors.superpoint", "max_num_keypoints": 512,
                      "detection_threshold": 0.0, "nms_radius": 3, "trainable": False},
        "matcher": {"name": "matchers.lightglue", "filter_threshold": 0.1,
                    "checkpointed": True},
        "ground_truth": {"name": "matchers.homography_matcher", "th_positive": 3.0,
                         "th_negative": 6.0},
        "run_gt_in_forward": True,
    },
    "train": {
        "seed": 0,
        "epochs": 40,
        "lr": 1.0e-4,
        "lr_schedule": {"type": "exp", "start": 20000, "exp_div_10": 200000},
        "log_every_iter": 100,
        "eval_every_iter": 1000,
        "best_key": "loss/total",
    },
}


def lg_homography_conf() -> dict:
    """LightGlue stage 1, the reference's own recipe: 9 layers from their
    initialisation (``checkpointed``), trained on the host homography
    dataset (synthetic scenes, 640x640 views, the ``lg`` photometrics, 8
    loader threads) against a frozen SuperPoint. The YAML gives SuperPoint
    no weights; a run starts it from ``SP_STAGE0B_WEIGHTS`` by setting
    ``train.load_experiment`` to that blob (the matcher, which it lacks,
    keeps its initialisation)."""
    return copy.deepcopy(_LG_HOMOGRAPHY)


def stage6_sp0b_conf() -> dict:
    """LightGlue stage 6 (``superpoint+lightglue_stage6_sp0b.yaml``): stage
    5's bf16 recipe (the benchmark picks ``checkpoint_best``) on the frozen
    stage-0b SuperPoint with the CoM readout, at lr 3e-5. Its
    ``load_experiment`` is a file under ``/tmp`` made for that run; a run
    starts from ``STAGE2_WEIGHTS`` for the matcher and ``SP_STAGE0B_WEIGHTS``
    for the extractor: ``train.load_experiment`` set to
    ``weights/lg_tpu_stage2.f16.msgpack,weights/sp_tpu_stage0b.f16.msgpack``
    (the later blob's extractor overrides)."""
    conf = stage5_conf()
    conf["train"].update(seed=46, epochs=24, lr=3.0e-5,
                         load_experiment="/tmp/lg6_init_sp0b.msgpack")
    return conf


_SP_FINETUNE_LOC = {  # gluefactory_tpu/configs/superpoint_finetune_loc.yaml
    "data": _SP_DATA,
    "model": {"name": "two_view_pipeline",
              "extractor": {**_SP_EXTRACTOR, "refinement_radius": 2, "training_outputs": True,
                            "loss": {"loc_weight": 2.0, "loc_radius": 2, "loc_max_dist": 4.0,
                                     "peaky_weight": 0.5, "peaky_radius": 2}}},
    "train": {
        "seed": 11,
        "epochs": 8,
        "optimizer": "adam",
        "lr": 0.0002,
        "lr_schedule": {"type": "exp", "start": 1000, "exp_div_10": 4000},
        "eval_every_iter": 250,
        "log_every_iter": 50,
        "keep_last_checkpoints": 3,
        "clip_grad": 5.0,
        "best_key": "loss/total",
        "load_experiment": "sp_tpu_stage0",
    },
}


def sp_finetune_loc_conf() -> dict:
    """SuperPoint stage 0b: stage 0 fine-tuned with the softargmax
    localisation and peakiness losses. Its ``load_experiment`` names the run
    ``sp_tpu_stage0``, whose export is ``SP_STAGE0_WEIGHTS``."""
    return copy.deepcopy(_SP_FINETUNE_LOC)


_SP_STAGE1B = copy.deepcopy(_SP_STAGE1)  # gluefactory_tpu/configs/superpoint_stage1b_r3.yaml
_SP_STAGE1B["model"]["extractor"]["loss"] = {
    "loc_weight": 3.0, "loc_radius": 2, "loc_anchor": "gt", "peaky_weight": 0.5,
    "peaky_radius": 2, **_SP_DESC_LOSSES}
_SP_STAGE1B["train"].update(seed=31, epochs=32, load_experiment="sp_tpu_stage1_r3")

_SP_STAGE1C = copy.deepcopy(_SP_SOFT)  # gluefactory_tpu/configs/superpoint_stage1c_r3.yaml
_SP_STAGE1C["train"].update(seed=41, epochs=36, lr=0.0003, load_experiment="sp_tpu_stage1b_r3")
_SP_STAGE1C["train"]["lr_schedule"] = {"type": "exp", "start": 2500, "exp_div_10": 9000}


def sp_stage1b_conf() -> dict:
    """SuperPoint stage 1b (round 3): stage 1 continued with the localisation
    anchored at the ground truth. Its ``load_experiment`` names the run
    ``sp_tpu_stage1_r3`` (``sp_stage1_conf``'s), which is not in the
    repository; its nearest committed blob is that run's own start,
    ``SP_STAGE0B_WEIGHTS``."""
    return copy.deepcopy(_SP_STAGE1B)


def sp_stage1c_conf() -> dict:
    """SuperPoint stage 1c (round 3): soft cell labels and the CoM readout,
    continued from the run ``sp_tpu_stage1b_r3``, which is not in the
    repository; the nearest committed blob on its line is
    ``SP_STAGE0B_WEIGHTS`` (stage 1b's line starts there). This recipe's own
    export is ``SP_STAGE1C_WEIGHTS``."""
    return copy.deepcopy(_SP_STAGE1C)


_LG_ONDEVICE = copy.deepcopy(_STAGE2)  # gluefactory_tpu/configs/superpoint+lightglue_ondevice.yaml
_LG_ONDEVICE["train"] = {
    "seed": 0,
    "epochs": 40,
    "optimizer": "adam",
    "lr": 0.0001,
    "lr_schedule": {"type": "exp", "start": 4000, "exp_div_10": 10000},
    "eval_every_iter": 250,
    "log_every_iter": 50,
    "keep_last_checkpoints": 3,
    "load_experiment": "sp_tpu_stage0",
    "clip_grad": 1.0,
    "best_key": "loss/total",
}
_LG_ONDEVICE_R3 = copy.deepcopy(_STAGE2)  # .../superpoint+lightglue_ondevice_r3.yaml
_LG_ONDEVICE_R3["train"].update(seed=1, lr=0.000025, load_experiment="lg_tpu_stage1_r2")
_LG_ONDEVICE_R3["train"]["lr_schedule"] = {"type": "exp", "start": 4000, "exp_div_10": 20000}


def lg_ondevice_conf() -> dict:
    """LightGlue on the on-device engine from its initialisation, on the
    frozen stage-0 SuperPoint: the run ``sp_tpu_stage0`` is
    ``SP_STAGE0_WEIGHTS`` (the matcher, which it lacks, keeps its
    initialisation)."""
    return copy.deepcopy(_LG_ONDEVICE)


def lg_ondevice_r3_conf() -> dict:
    """The on-device LightGlue recipe of round 3, continued from the run
    ``lg_tpu_stage1_r2``, whose export is ``LG_STAGE1_R2_WEIGHTS``."""
    return copy.deepcopy(_LG_ONDEVICE_R3)


# --- SIFT, SuperGlue and the nearest-neighbour matcher -----------------------------

SG_SIFT_WEIGHTS = WEIGHTS_PATH / "sg_sift_stage1.f16.msgpack"  # SuperGlue on RootSIFT
LG_SIFT_WEIGHTS = WEIGHTS_PATH / "lg_sift_stage2.f16.msgpack"  # LightGlue on RootSIFT

_HPATCHES_DATA = {"name": "hpatches", "test_batch_size": 1, "num_workers": 2,
                  "preprocessing": {"resize": 480, "side": "long", "square_pad": True}}
_HPATCHES_EVAL = {"estimator": "ransac", "ransac_th": -1.0, "num_hypotheses": 1024}
_SUPERGLUE = {"name": "matchers.superglue", "input_dim": 128, "descriptor_dim": 256,
              "n_layers": 9, "sinkhorn_iterations": 50, "filter_threshold": 0.2}

_HPATCHES_SIFT_SG = {  # outputs/results/hpatches/sift_sg_stage1/conf.yaml
    "data": _HPATCHES_DATA,
    "model": {"name": "two_view_pipeline",
              "extractor": {"name": "extractors.sift", "max_num_keypoints": 2048,
                            "contrast_threshold": 0.02},
              "matcher": _SUPERGLUE,
              "ground_truth": {"name": None},
              "run_gt_in_forward": False},
    "eval": _HPATCHES_EVAL,
    "checkpoint": "weights/sg_sift_stage1.f16.msgpack",
}
_HPATCHES_SIFT_NN = {  # outputs/results/hpatches/sift_nn/conf.yaml
    "data": _HPATCHES_DATA,
    "model": {"name": "two_view_pipeline",
              "extractor": {"name": "extractors.sift", "max_num_keypoints": 2048},
              "matcher": {"name": "matchers.nearest_neighbor_matcher", "ratio_thresh": 0.8}},
    "eval": _HPATCHES_EVAL,
    "checkpoint": None,
}
_HPATCHES_SP_NN = {  # outputs/results/hpatches/sp0b_nn_com/conf.yaml
    "data": _HPATCHES_DATA,
    "model": {"name": "two_view_pipeline",
              "extractor": {"name": "extractors.superpoint", "max_num_keypoints": 1024,
                            "detection_threshold": 0.005, "refinement_radius": 2,
                            "refinement_mode": "com"},
              "matcher": {"name": "matchers.nearest_neighbor_matcher", "ratio_thresh": 0.95}},
    "eval": _HPATCHES_EVAL,
    "checkpoint": "weights/sp_tpu_stage0b.f16.msgpack",
}


def hpatches_sift_superglue_conf() -> dict:
    """SIFT (2048 keypoints, contrast 0.02, RootSIFT) and 9-layer SuperGlue
    from ``SG_SIFT_WEIGHTS`` on the HPatches benchmark, the conf of the
    published famA/famB numbers (famB sets ``data.data_dir``)."""
    return copy.deepcopy(_HPATCHES_SIFT_SG)


def hpatches_sift_nn_conf() -> dict:
    """SIFT (2048 keypoints, contrast 0.04) and the mutual nearest neighbour
    with the ratio test at 0.8 on the HPatches benchmark: no weights."""
    return copy.deepcopy(_HPATCHES_SIFT_NN)


def hpatches_sp_nn_conf() -> dict:
    """SuperPoint stage 0b (1024 keypoints, CoM readout) and the mutual
    nearest neighbour with the ratio test at 0.95 on the HPatches benchmark,
    from ``SP_STAGE0B_WEIGHTS``."""
    return copy.deepcopy(_HPATCHES_SP_NN)

_HPATCHES_SIFT_NN_ADALAM = {  # outputs/results/hpatches/sift_nn_adalam/conf.yaml
    "data": _HPATCHES_DATA,
    "model": {"name": "two_view_pipeline",
              "extractor": {"name": "extractors.sift", "max_num_keypoints": 2048},
              "matcher": {"name": "matchers.nearest_neighbor_matcher", "ratio_thresh": None,
                          "mutual_check": True},
              "filter": {"name": "matchers.adalam", "min_inliers": 5}},
    "eval": _HPATCHES_EVAL,
    "checkpoint": None,
}


def hpatches_sift_nn_adalam_conf() -> dict:
    """SIFT (2048 keypoints, contrast 0.04), the mutual nearest neighbour
    without a ratio test and AdaLAM (5 inliers) in the filter slot on the
    HPatches benchmark: no weights."""
    return copy.deepcopy(_HPATCHES_SIFT_NN_ADALAM)


# --- the ETH3D benchmark ----------------------------------------------------------

_ETH3D_DATA = {"name": "eth3d", "min_covisible": 300, "max_pairs_per_scene": 8}
_ETH3D_SP_LG = {
    "name": "two_view_pipeline",
    "extractor": {"name": "extractors.superpoint", "max_num_keypoints": 1024,
                  "detection_threshold": 0.005, "refinement_radius": 2},
    "matcher": {"name": "matchers.lightglue", "filter_threshold": 0.1,
                "depth_confidence": -1, "width_confidence": -1,
                "save_layer_outputs": False, "checkpointed": False, "n_layers": 6},
    "ground_truth": {"name": None},
    "run_gt_in_forward": False,
}
_ETH3D_SP_LG_STAGE2 = {  # outputs/results/eth3d/sp_lg_stage2/conf.yaml
    "data": _ETH3D_DATA,
    "model": _ETH3D_SP_LG,
    "eval": {"correct_th": 0.001},
    "checkpoint": "weights/lg_tpu_stage2.f16.msgpack",
}
_ETH3D_FLAGSHIP = copy.deepcopy(_ETH3D_SP_LG_STAGE2)  # outputs/results/eth3d/sp_lg2_com_refine
_ETH3D_FLAGSHIP["model"]["extractor"]["refinement_mode"] = "com"
_ETH3D_FLAGSHIP["model"]["filter"] = {"name": "matchers.match_refiner"}


def eth3d_flagship_conf() -> dict:
    """The flagship on the ETH3D benchmark: SuperPoint at 1024 keypoints with
    the CoM readout on the 1024-pixel canvas, 6-layer LightGlue from
    ``STAGE2_WEIGHTS``, the refiner; covisibility 300, 8 pairs a scene; a
    match is correct within 1e-3 of its epipolar line."""
    return copy.deepcopy(_ETH3D_FLAGSHIP)


def eth3d_sp_lg_stage2_conf() -> dict:
    """``eth3d_flagship_conf`` without the CoM readout and the refiner."""
    return copy.deepcopy(_ETH3D_SP_LG_STAGE2)


# --- GlueStick on points and lines: SuperPoint + LSD wireframe -----------------------

# GlueStick stage 0 and its own SuperPoint (under ['extractor']['point_extractor'])
GLUESTICK_WEIGHTS = WEIGHTS_PATH / "gluestick_tpu_stage0.f16.msgpack"


def _wireframe(max_keypoints: int = 512, threshold: float = 0.0,
               refinement: bool = False) -> dict:
    point = {"name": "extractors.superpoint", "max_num_keypoints": max_keypoints,
             "detection_threshold": threshold, "dense_outputs": True}
    if refinement:
        point.update(refinement_radius=2, refinement_mode="com")
    return {"name": "lines.wireframe", "point_extractor": point,
            "line_extractor": {"name": "lines.lsd", "max_num_lines": 128, "min_length": 15},
            "nms_radius": 3.0}


def _gluestick_model(**wireframe) -> dict:
    return {"name": "two_view_pipeline", "extractor": _wireframe(**wireframe),
            "matcher": {"name": "matchers.gluestick", "filter_threshold": 0.2},
            "ground_truth": {"name": None}, "run_gt_in_forward": False}


_HPATCHES_HYBRID_EVAL = {**_HPATCHES_EVAL, "estimator": "hybrid_ransac"}


def hpatches_gluestick_conf() -> dict:
    """GlueStick stage 0 (``GLUESTICK_WEIGHTS``, 6 layers) on the SuperPoint +
    LSD wireframe (512 keypoints with the CoM readout, 128 lines) with the
    refiner on the HPatches benchmark, hybrid RANSAC on the point matches
    (this benchmark exports no lines): outputs/results/hpatches/
    gluestick_stage0_com_refine."""
    conf = {"data": {**_HPATCHES_DATA, "data_dir": "hpatches-sequences-release"},
            "model": {**_gluestick_model(refinement=True),
                      "filter": {"name": "matchers.match_refiner"}},
            "eval": dict(_HPATCHES_HYBRID_EVAL),
            "checkpoint": "weights/gluestick_tpu_stage0.f16.msgpack"}
    return copy.deepcopy(conf)


def hpatches_gluestick_famb_conf(refine: bool = True) -> dict:
    """``hpatches_gluestick_conf`` on famB (``data_dir: hpatches-b``), with the
    refiner (outputs/results/hpatches/gluestick_famb_com_refine) or without
    it (gluestick_famb_com)."""
    conf = hpatches_gluestick_conf()
    conf["data"]["data_dir"] = "hpatches-b"
    if not refine:
        del conf["model"]["filter"]
    return conf


def hpatches_extended_gluestick_conf() -> dict:
    """GlueStick stage 0 on the wireframe without the CoM readout or the
    refiner on the extended HPatches benchmark: the matched lines feed
    hybrid RANSAC; keypoint and line repeatability (3 and 5 px) and line
    match precision (5 px): outputs/results/hpatches_extended/
    gluestick_stage0_hybrid."""
    return copy.deepcopy({
        "data": dict(_HPATCHES_DATA), "model": _gluestick_model(),
        "eval": {**_HPATCHES_HYBRID_EVAL, "rep_th_kp": 3.0, "rep_th_line": 5.0,
                 "line_match_th": 5.0},
        "checkpoint": "weights/gluestick_tpu_stage0.f16.msgpack"})


def eth3d_gluestick_conf() -> dict:
    """GlueStick stage 0 on the wireframe on the ETH3D benchmark (points
    and lines): outputs/results/eth3d/gluestick_stage0."""
    return copy.deepcopy({"data": dict(_ETH3D_DATA), "model": _gluestick_model(),
                          "eval": {"correct_th": 0.001},
                          "checkpoint": "weights/gluestick_tpu_stage0.f16.msgpack"})


def md1500_extended_gluestick_conf() -> dict:
    """GlueStick stage 0 on the wireframe (1024 keypoints, threshold 0.005)
    on the extended relative-pose benchmark at 480 pixels: 5-point
    LO-RANSAC swept over 6 thresholds (2048 hypotheses, 6 LO steps) and the
    line matches' epipolar precision on 8 samples a line, on the rendered
    pose set: outputs/results/megadepth1500_extended/gluestick_pose."""
    data = copy.deepcopy(_POSE_FLAGSHIP["data"])
    data["preprocessing"]["resize"] = 480
    return copy.deepcopy({
        "data": data, "model": _gluestick_model(max_keypoints=1024, threshold=0.005),
        "eval": {"estimator": "ransac", "ransac_th": -1.0, "num_hypotheses": 2048,
                 "lo_iters": 6, "line_samples": 8},
        "checkpoint": "weights/gluestick_tpu_stage0.f16.msgpack"})


# --- GlueStick training ------------------------------------------------------------

_GLUESTICK_CACHED = {  # gluefactory_tpu/configs/gluestick_cached.yaml
    "data": {
        "name": "homographies_ondevice_cached_wireframe",
        "pool_size": 640,
        "val_pool_size": 64,
        "source_size": [448, 448],
        "image_size": 320,
        "train_batch_size": 16,
        "val_batch_size": 16,
        "steps_per_epoch": 250,
        "val_steps": 4,
        "features_from": {
            "name": "lines.wireframe", "on_host": True, "batch": 8,
            "weights": "sp_tpu_stage0b.f16.msgpack",
            "remap": "['extractor']=['point_extractor']",
            "point_extractor": {"name": "extractors.superpoint", "max_num_keypoints": 256,
                                "detection_threshold": 0.0005, "nms_radius": 4,
                                "dense_outputs": True, "trainable": False},
            "line_extractor": {"name": "lines.lsd", "max_num_lines": 96},
            "nms_radius": 3.0,
        },
        "desc_noise": 0.03,
        "desc_dropout": 0.05,
        "homography": {"difficulty": 0.7, "translation": 0.3, "max_angle": 45.0},
    },
    "model": {
        "name": "two_view_pipeline",
        "extractor": {"name": None},
        "allow_no_extract": True,
        "matcher": {"name": "matchers.gluestick", "input_dim": 256, "descriptor_dim": 256,
                    "n_layers": 6, "checkpointed": False, "inter_supervision": [2, 4]},
        "ground_truth": {"name": "matchers.homography_matcher", "use_lines": True,
                         "th_positive": 3.0, "th_negative": 6.0, "line_dist_th": 5.0},
        "run_gt_in_forward": True,
    },
    "train": {
        "seed": 7,
        "epochs": 32,
        "optimizer": "adam",
        "lr": 0.0001,
        "lr_schedule": {"type": "exp", "start": 3000, "exp_div_10": 8000},
        "eval_every_iter": 250,
        "save_every_iter": 2000,
        "log_every_iter": 50,
        "keep_last_checkpoints": 3,
        "clip_grad": 1.0,
        "best_key": "loss/total",
    },
}


def gluestick_cached_conf() -> dict:
    """``gluestick_cached.yaml``: GlueStick (6 layers, inter-supervision at
    layers 2 and 4) trained from its initialisation on the cached-wireframe
    engine (640 + 64 images at 448x448; SuperPoint from
    ``SP_STAGE0B_WEIGHTS`` with 256 keypoints, LSD with 96 lines, extracted
    once ``on_host``) against the homography's point and line ground truth;
    the recipe of ``gluestick_tpu_stage0`` (``GLUESTICK_WEIGHTS``)."""
    return copy.deepcopy(_GLUESTICK_CACHED)


def gluestick_stage1_conf() -> dict:
    """``gluestick_stage1.yaml``: stage 0 continued on a denser pool (384
    keypoints, 128 lines) with harder homographies at a decayed rate. Its
    ``load_experiment``, the run ``gluestick_tpu_stage0``, is not committed:
    the recipe starts from that run's export, ``GLUESTICK_WEIGHTS`` (its
    extractor half is dropped for the matcher-only model)."""
    conf = gluestick_cached_conf()
    conf["data"].update(desc_noise=0.02, desc_dropout=0.03,
                        homography={"difficulty": 0.8, "translation": 0.35, "max_angle": 60.0})
    conf["data"]["features_from"]["point_extractor"]["max_num_keypoints"] = 384
    conf["data"]["features_from"]["line_extractor"]["max_num_lines"] = 128
    conf["train"].update(seed=17, lr=3.0e-5,
                         lr_schedule={"type": "exp", "start": 2000, "exp_div_10": 8000},
                         load_experiment="weights/gluestick_tpu_stage0.f16.msgpack")
    return conf


def gluestick_train_homography_conf() -> dict:
    """``gluestick_train_homography.yaml``: GlueStick at its default 9 layers
    on the host homography dataset (synthetic scenes, 320x320 views, 8
    loader processes, batch 8) with a frozen SuperPoint + LSD wireframe (512
    keypoints at threshold 0, 128 lines) in the step, against the point
    ground truth only. The YAML gives the wireframe's SuperPoint no
    weights."""
    return {
        "data": {"name": "homographies", "synthetic": True, "image_size": 320,
                 "train_batch_size": 8, "num_workers": 8},
        "model": {
            "name": "two_view_pipeline",
            "extractor": {
                "name": "lines.wireframe",
                "point_extractor": {"name": "extractors.superpoint", "max_num_keypoints": 512,
                                    "detection_threshold": 0.0, "dense_outputs": True,
                                    "trainable": False},
                "line_extractor": {"name": "lines.lsd", "max_num_lines": 128},
                "trainable": False,
            },
            "matcher": {"name": "matchers.gluestick"},
            "ground_truth": {"name": "matchers.homography_matcher"},
            "run_gt_in_forward": True,
        },
        "train": {"seed": 0, "epochs": 20, "lr": 1.0e-4, "log_every_iter": 100,
                  "eval_every_iter": 1000},
    }


# --- JPLDD's and SOLD2's training --------------------------------------------------

_SHAPES_ENGINE = {  # the on-device synthetic-shapes engine as the four recipes set it
    "name": "synthetic_shapes_ondevice",
    "pool_size": 512,
    "val_pool_size": 48,
    "source_size": [448, 448],
    "image_size": 320,
    "max_segments": 48,
    "max_vertices": 96,
    "train_batch_size": 8,
    "val_batch_size": 8,
    "steps_per_epoch": 250,
    "val_steps": 4,
    "homography": {"difficulty": 0.6, "translation": 0.3, "max_angle": 35.0},
    "photometric": {"p": 0.9, "strength": 1.0},
}
_JPLDD_TRAIN = {"optimizer": "adam", "lr": 3.0e-4, "eval_every_iter": 250,
                "save_every_iter": 1000, "log_every_iter": 50, "keep_last_checkpoints": 3,
                "clip_grad": 5.0, "best_key": "loss/total"}


def jpldd_ondevice_conf(structured: bool = False) -> dict:
    """``jpldd_ondevice.yaml`` (``structured``: ``jpldd_ondevice_structured.yaml``):
    JPLDD's phase A from its initialisation on the on-device shapes engine
    (512 + 48 drawn scenes at 448x448, 320-pixel views, batch 8; the
    structured one on the benchmarks' scene family) with the focal heatmap
    loss; the recipes of ``jpldd_tpu_stage0`` and ``jpldd_tpu_structured``."""
    data = copy.deepcopy(_SHAPES_ENGINE)
    if structured:
        data["scene_family"] = "structured"
    return copy.deepcopy({
        "data": data,
        "model": {"name": "extractors.joint_point_line_extractor", "max_num_keypoints": 512,
                  "detection_threshold": 0.0, "extract_lines": False,
                  "loss": {"heatmap": "focal", "pos_weight": 100.0}},
        "train": {"seed": 43 if structured else 5, "epochs": 16 if structured else 24,
                  **_JPLDD_TRAIN,
                  "lr_schedule": {"type": "exp", "start": 2500, "exp_div_10": 6000}}})


def jpldd_desc_stage_conf(structured: bool = False) -> dict:
    """``jpldd_desc_stage.yaml`` (``structured``: ``jpldd_desc_stage_structured.yaml``):
    JPLDD's phase B, the SDDH head alone (everything else at a zero update
    scale) trained by the keypoint InfoNCE over mutual detections on the
    homography engine (768 + 64 scenes, batch 16, grey views tiled to the
    trunk's 3 channels), from phase A's blob: ``JPLDD_WEIGHTS['structured']``,
    as the structured YAML names it, or ``JPLDD_WEIGHTS['stage0']``, the
    export of the run ``jpldd_tpu_stage0`` that the other names and that is
    not committed; the recipes of ``jpldd_tpu_structured_descB`` and
    ``jpldd_tpu_stage1_desc``."""
    return copy.deepcopy({
        "data": {"name": "homographies_ondevice", "pool_size": 768, "val_pool_size": 64,
                 "source_size": [448, 448], "image_size": 320, "max_gt_points": 192,
                 "train_batch_size": 16, "val_batch_size": 16, "steps_per_epoch": 250,
                 "val_steps": 4,
                 "homography": {"difficulty": 0.7, "translation": 0.3, "max_angle": 45.0},
                 "photometric": {"p": 0.95, "strength": 1.0}},
        "model": {"name": "two_view_pipeline",
                  "extractor": {"name": "extractors.joint_point_line_extractor",
                                "max_num_keypoints": 512, "detection_threshold": 0.0,
                                "extract_lines": False, "input_channels": 3,
                                "loss": {"desc_nll_weight": 1.0, "desc_nll_temp": 0.1,
                                         "desc_match_th": 3.0}}},
        "train": {"seed": 47 if structured else 17, "epochs": 16, **_JPLDD_TRAIN,
                  "lr_schedule": {"type": "exp", "start": 1500, "exp_div_10": 6000},
                  "lr_scaling": [[0.0, ["block", "agg_conv", "kp1", "kp2", "kp3", "df1", "df2",
                                        "df3", "af1", "af3", "backbone"]]],
                  "load_experiment": JPLDD_WEIGHTS["structured" if structured else "stage0"]}})


def jpldd_train_synthetic_conf() -> dict:
    """``jpldd_train_synthetic.yaml``: JPLDD from its initialisation on the
    host shapes dataset (320-pixel views, batch 8, 8 loader processes)."""
    return {"data": {"name": "synthetic_shapes", "image_size": 320, "train_batch_size": 8,
                     "num_workers": 8},
            "model": {"name": "extractors.joint_point_line_extractor",
                      "max_num_keypoints": 512, "detection_threshold": 0.0},
            "train": {"seed": 0, "epochs": 20, "lr": 3.0e-4, "log_every_iter": 100,
                      "eval_every_iter": 1000}}


def sold2_train_pairs_conf() -> dict:
    """``sold2_train_pairs.yaml``: SOLD2 from its initialisation on the
    two-view shapes engine (structured scenes, batch 16): each view's
    junction CE and heatmap BCE, and the dense descriptors' InfoNCE over the
    shared vertices; the recipe of ``sold2_tpu_stage0``."""
    return copy.deepcopy({
        "data": {**_SHAPES_ENGINE, "name": "synthetic_shapes_ondevice_pairs",
                 "scene_family": "structured", "train_batch_size": 16, "val_batch_size": 16},
        "model": {"name": "two_view_pipeline",
                  "extractor": {"name": "lines.sold2", "sparse_outputs": False,
                                "loss": {"junction_weight": 1.0, "heatmap_weight": 1.0,
                                         "pos_weight": 100.0, "desc_nll_weight": 1.0,
                                         "desc_nll_temp": 0.1}}},
        "train": {"seed": 29, "epochs": 24, **_JPLDD_TRAIN, "lr": 0.0005,
                  "lr_schedule": {"type": "exp", "start": 2000, "exp_div_10": 6000}}})


def jpldd_eval_conf() -> dict:
    """``jpldd_eval.yaml``: JPLDD's model card, 512 keypoints matched by the
    NN point-line matcher, with its HPatches-lines section."""
    return copy.deepcopy({
        "model": {"name": "two_view_pipeline",
                  "extractor": {"name": "extractors.joint_point_line_extractor",
                                "max_num_keypoints": 512},
                  "matcher": {"name": "matchers.nn_point_line"}},
        "benchmarks": _REP_THRESHOLDS})


# --- SIFT-feature training on the cached-feature engine -----------------------------

LG_SIFT_STAGE1_WEIGHTS = WEIGHTS_PATH / "lg_sift_stage1.f16.msgpack"  # LightGlue stage 1, SIFT

_SIFT_CACHED_DATA = {  # the cached engine as the three cached SIFT YAMLs set it
    "name": "homographies_ondevice_cached",
    "pool_size": 768,
    "val_pool_size": 64,
    "source_size": [448, 448],
    "image_size": 320,
    "train_batch_size": 32,
    "val_batch_size": 32,
    "steps_per_epoch": 250,
    "val_steps": 4,
    "features_from": {"name": "extractors.sift", "max_num_keypoints": 512,
                      "contrast_threshold": 0.02, "batch": 16, "on_host": True},
    "desc_noise": 0.03,
    "desc_dropout": 0.05,
    "homography": {"difficulty": 0.7, "translation": 0.3, "max_angle": 45.0},
}
_SIFT_CACHED_MODEL = {
    "name": "two_view_pipeline",
    "extractor": {"name": None},
    "allow_no_extract": True,
    "matcher": {"name": "matchers.lightglue", "input_dim": 128, "filter_threshold": 0.1,
                "n_layers": 6, "checkpointed": False},
    "ground_truth": {"name": "matchers.homography_matcher", "th_positive": 3.0,
                     "th_negative": 6.0},
    "run_gt_in_forward": True,
}
_SIFT_CACHED_TRAIN = {
    "epochs": 32,
    "optimizer": "adam",
    "lr": 1.0e-4,
    "lr_schedule": {"type": "exp", "start": 3000, "exp_div_10": 8000},
    "eval_every_iter": 250,
    "save_every_iter": 2000,
    "log_every_iter": 50,
    "keep_last_checkpoints": 3,
    "clip_grad": 1.0,
    "best_key": "loss/total",
}


def sift_lg_cached_conf() -> dict:
    """``sift+lightglue_cached.yaml``: LightGlue (6 layers, ``input_dim``
    128) trained from its initialisation on the cached engine's SIFT pool
    (512 slots, contrast 0.02, RootSIFT, extracted ``on_host``); the recipe
    of the run ``lg_sift_stage1`` (``LG_SIFT_STAGE1_WEIGHTS``)."""
    return {"data": copy.deepcopy(_SIFT_CACHED_DATA), "model": copy.deepcopy(_SIFT_CACHED_MODEL),
            "train": {"seed": 3, **copy.deepcopy(_SIFT_CACHED_TRAIN)}}


def sift_lg_stage2_conf() -> dict:
    """``sift+lightglue_stage2.yaml``: stage 1 continued on harder
    homographies at a decayed rate; the recipe of ``lg_sift_stage2``. Its
    ``load_experiment``, the run ``lg_sift_stage1``, is not committed: the
    recipe starts from that run's export, ``LG_SIFT_STAGE1_WEIGHTS``."""
    conf = sift_lg_cached_conf()
    conf["data"].update(desc_noise=0.02, desc_dropout=0.03,
                        homography={"difficulty": 0.8, "translation": 0.35, "max_angle": 60.0})
    conf["train"].update(seed=11, lr=3.0e-5, lr_schedule={"type": "exp", "start": 2000,
                                                          "exp_div_10": 8000},
                         load_experiment="weights/lg_sift_stage1.f16.msgpack")
    return conf


def sift_sg_cached_conf() -> dict:
    """``sift+superglue_cached.yaml``: SuperGlue (9 layers, Sinkhorn 50,
    ``input_dim`` 128) trained from its initialisation on the SIFT pool of
    ``sift_lg_cached_conf``; the recipe of ``sg_sift_stage1``
    (``SG_SIFT_WEIGHTS``)."""
    conf = sift_lg_cached_conf()
    conf["model"]["matcher"] = copy.deepcopy(_SUPERGLUE)
    conf["train"]["seed"] = 7
    return conf


def sift_lightglue_conf() -> dict:
    """``sift+lightglue.yaml``, the model card (no data, no blob): SIFT with
    2048 keypoints and LightGlue with ``add_scale_ori``."""
    return {"model": {"name": "two_view_pipeline",
                      "extractor": {"name": "extractors.sift", "max_num_keypoints": 2048},
                      "matcher": {"name": "matchers.lightglue", "input_dim": 128,
                                  "add_scale_ori": True, "filter_threshold": 0.1,
                                  "save_layer_outputs": False, "checkpointed": False}}}


_GATE_SIFT = {"name": "extractors.sift", "max_num_keypoints": 1024,
              "contrast_threshold": 0.02}
# the confs of the JAX package's quality gates (tests/test_trained_quality.py), each
# with its blob: SIFT+SuperGlue (test_trained_sift_superglue_quality), SIFT+LightGlue
# stage 2 (test_trained_sift_lightglue_stage2_quality) and the stage-0b SuperPoint
# with the nearest neighbour (test_trained_superpoint_loc_finetune_quality)
_GATE_SIFT_LG = {"name": "matchers.lightglue", "input_dim": 128, "n_layers": 6,
                 "filter_threshold": 0.1, "checkpointed": False, "save_layer_outputs": False}
_GATE_SP = {"name": "extractors.superpoint", "max_num_keypoints": 512,
            "detection_threshold": 0.005, "nms_radius": 4, "refinement_radius": 2,
            "refinement_mode": "softargmax"}
_GATE_NN = {"name": "matchers.nearest_neighbor_matcher"}
_GATES = {
    "sift_superglue": ({"extractor": _GATE_SIFT, "matcher": _SUPERGLUE}, SG_SIFT_WEIGHTS),
    "sift_lightglue": ({"extractor": _GATE_SIFT, "matcher": _GATE_SIFT_LG}, LG_SIFT_WEIGHTS),
    "superpoint_nn": ({"extractor": _GATE_SP, "matcher": _GATE_NN}, SP_STAGE0B_WEIGHTS),
    # test_trained_sift_lightglue_quality (:284), test_trained_sift_lightglue_stage2_ood_quality
    # (:477, family B) and test_trained_superpoint_nn_quality (:138, no sub-pixel readout)
    "sift_lightglue_stage1": ({"extractor": _GATE_SIFT, "matcher": _GATE_SIFT_LG},
                              LG_SIFT_STAGE1_WEIGHTS),
    "sift_lightglue_ood": ({"extractor": _GATE_SIFT, "matcher": _GATE_SIFT_LG}, LG_SIFT_WEIGHTS),
    "superpoint_nn_stage0": ({"extractor": {**_GATE_SP, "refinement_radius": 0},
                              "matcher": _GATE_NN}, SP_STAGE0_WEIGHTS),
}
# the family of each gate's rendered pairs (render_pairs of tests/test_trained_quality.py)
GATE_FAMILY = {name: "b" if name == "sift_lightglue_ood" else "a" for name in _GATES}
# their bounds on the medians over the gate's 6 pairs: matches and precisions above,
# the corner error (px) below
GATE_BOUNDS = {
    "sift_superglue": {"matches": 60, "prec3": 0.6, "h_err": 1.5},
    "sift_lightglue": {"matches": 60, "prec1": 0.55, "prec3": 0.7, "h_err": 1.0},
    "superpoint_nn": {"matches": 80, "prec1": 0.12, "prec3": 0.4, "h_err": 3.0},
    "sift_lightglue_stage1": {"matches": 60, "prec1": 0.5, "prec3": 0.65, "h_err": 1.0},
    "sift_lightglue_ood": {"matches": 60, "prec1": 0.5, "prec3": 0.7, "h_err": 1.5},
    "superpoint_nn_stage0": {"matches": 80, "prec3": 0.4, "h_err": 5.0},
}


def gate_conf(name: str) -> tuple[dict, object]:
    """(the two-view pipeline's conf, its blob) of the JAX gate ``name``, a
    key of ``GATE_BOUNDS``."""
    conf, blob = _GATES[name]
    return {"name": "two_view_pipeline", **copy.deepcopy(conf)}, blob


# --- the line benchmarks: HPatches lines, RDNIM lines, Wireframe ----------------------

SOLD2_WEIGHTS = "weights/sold2_tpu_stage0.f16.msgpack"
_LSD_LBD = {"name": "two_view_pipeline",
            "extractor": {"name": "lines.lsd", "max_num_lines": 256, "describe": "lbd"},
            "matcher": {"name": "matchers.line_matcher_lbd", "score_th": 0.1}}
_SOLD2 = {"name": "lines.sold2", "max_num_lines": 512, "max_num_junctions": 250,
          "sparse_outputs": True}
_SOLD2_WUNSCH = {"name": "two_view_pipeline", "extractor": _SOLD2,
                 "matcher": {"name": "matchers.wunsch_line_matcher", "num_samples": 8,
                             "desc_stride": 4}}
# JPLDD's blobs: phase A on the shapes engine and on the structured scenes, and
# each one's phase B (the SDDH head trained alone, under ['extractor'])
JPLDD_WEIGHTS = {name: f"weights/jpldd_tpu_{name}.f16.msgpack"
                 for name in ("stage0", "stage1_desc", "structured", "structured_descB")}
_JPLDD_NN = {"name": "two_view_pipeline",
             "extractor": {"name": "extractors.joint_point_line_extractor",
                           "max_num_keypoints": 512, "extract_lines": True,
                           "detection_threshold": 0.005},
             "matcher": {"name": "matchers.nn_point_line"}}
_REP_THRESHOLDS = {"hpatches_lines": {"eval": {"rep_thresholds": [1.0, 3.0, 5.0]}}}


def _jpldd_extended(blob: str, famb: bool = False, benchmarks: bool = False) -> dict:
    """JPLDD with POLD2's lines and the NN point-line matcher on the extended
    HPatches benchmark (RANSAC on the point matches)."""
    conf = {"model": _JPLDD_NN, "checkpoint": JPLDD_WEIGHTS[blob]}
    if famb:
        conf["data"] = {"data_dir": "hpatches-b"}
    if benchmarks:  # the card's sections, carried by some of the committed confs
        conf["benchmarks"] = _REP_THRESHOLDS
    return conf


def _jpldd_lines(blob: str, wunsch: bool = False, **extractor) -> dict:
    """JPLDD's lines on the HPatches-lines benchmark, matched by the NN
    point-line matcher (which matches no JPLDD line: JPLDD has no dense
    descriptors) or by the Wunsch matcher on SDDH's descriptors at 8
    samples a line. The committed confs' ``max_num_lines`` is not a JPLDD
    key (POLD2 keeps its 512 slots)."""
    ext = {**_JPLDD_NN["extractor"], "max_num_lines": 256, **extractor}
    model = {**_JPLDD_NN, "extractor": ext}
    if wunsch:
        ext["line_desc_samples"] = 8
        model["matcher"] = {"name": "matchers.wunsch_line_matcher", "min_score": 0.1}
    conf = {"model": model, "checkpoint": JPLDD_WEIGHTS[blob]}
    if not wunsch:
        conf["benchmarks"] = _REP_THRESHOLDS
    return conf


# each benchmark's confs, named after the committed outputs/results/<benchmark>/<name>
# (each a model and its checkpoint; the data and eval sections are the pipeline's)
LINE_CONFS = {
    "hpatches_extended": {
        "gluestick_stage0_hybrid": hpatches_extended_gluestick_conf(),
        "jpldd_stage0": _jpldd_extended("stage0", benchmarks=True),
        "jpldd_stage1_desc": _jpldd_extended("stage1_desc", benchmarks=True),
        "jpldd_stage1_desc_famb": _jpldd_extended("stage1_desc", famb=True, benchmarks=True),
        "jpldd_structured_phaseA": _jpldd_extended("structured"),
        "jpldd_structured_descB": _jpldd_extended("structured_descB"),
        "jpldd_structured_descB_famb": _jpldd_extended("structured_descB", famb=True),
    },
    "hpatches_lines": {
        "jpldd_stage0": _jpldd_lines("stage0"),
        "jpldd_stage0_320": {**_jpldd_lines("stage0"),
                             "data": {"preprocessing": {"resize": 320}}},
        "jpldd_stage0_tuned": _jpldd_lines(
            "stage0", detection_threshold=0.003,
            line_extractor={"fine_inlier_ratio": 0.85, "coarse_inlier_ratio": 0.8,
                            "mean_df_th": 2.0, "df_inlier_th": 2.5, "use_angle_field": True}),
        "jpldd_structured_wunsch": _jpldd_lines("structured", wunsch=True),
        "jpldd_structured_descB_wunsch": _jpldd_lines("structured_descB", wunsch=True),
        "lsd_lines": {"model": {"name": "two_view_pipeline",
                                "extractor": {"name": "lines.lsd", "max_num_lines": 256}}},
        "lsd_lbd": {"model": _LSD_LBD},
        "elsed_lines": {"model": {"name": "two_view_pipeline",
                                  "extractor": {"name": "lines.elsed", "max_num_lines": 256}}},
        "sold2_wunsch": {"model": _SOLD2_WUNSCH, "checkpoint": SOLD2_WEIGHTS},
        "gluestick_stage0": {  # the committed conf's extractor names 256 lines; the
            # wireframe reads its line extractor's 128
            "model": {**_gluestick_model(), "extractor": {**_wireframe(), "max_num_lines": 256}},
            "checkpoint": "weights/gluestick_tpu_stage0.f16.msgpack"},
    },
    "rdnim_lines": {
        "lsd_lbd": {"model": _LSD_LBD},
        "sold2_wunsch": {"model": _SOLD2_WUNSCH, "checkpoint": SOLD2_WEIGHTS},
    },
    "wireframe": {
        "lsd": {"model": {"name": "lines.lsd", "max_num_lines": 512}},
        "sold2": {"model": _SOLD2, "checkpoint": SOLD2_WEIGHTS},
    },
}


def line_conf(benchmark: str, name: str) -> dict | None:
    """The conf ``name`` of the line benchmark ``benchmark`` (``LINE_CONFS``),
    or None where it has none of that name."""
    conf = LINE_CONFS.get(benchmark, {}).get(name)
    return None if conf is None else copy.deepcopy(conf)


# --- LoFTR -------------------------------------------------------------------------

# LoFTR's two blobs: stage 0 (trained with the saturated fine window) and 0b
LOFTR_WEIGHTS = {name: f"weights/loftr_tpu_{name}.f16.msgpack" for name in ("stage0", "stage0b")}
_LOFTR = {"name": "matchers.loftr", "coarse_layers": 4, "max_matches": 1024,
          "match_threshold": 0.2}


def _loftr_hpatches(blob: str, refine: bool = False, famb: bool = False) -> dict:
    """LoFTR from ``LOFTR_WEIGHTS[blob]`` on the HPatches benchmark: the bare
    matcher as the model, or (``refine``) a pipeline with no extractor, LoFTR
    and the ZNCC refiner, whose committed conf repeats LoFTR's keys at its top
    level (the pipeline ignores them, as JAX's does)."""
    data = {**_HPATCHES_DATA, "data_dir": "hpatches-b"} if famb else _HPATCHES_DATA
    model = ({"name": "two_view_pipeline", **{k: v for k, v in _LOFTR.items() if k != "name"},
              "matcher": _LOFTR, "extractor": {"name": None},
              "filter": {"name": "matchers.match_refiner"}} if refine else _LOFTR)
    return copy.deepcopy({"data": data, "model": model, "eval": _HPATCHES_EVAL,
                          "checkpoint": LOFTR_WEIGHTS[blob]})


# each committed outputs/results/hpatches/<name>/conf.yaml; ``loftr_stage0`` names its
# run ``loftr_tpu_stage0``, which is not committed: here its export, the blob
LOFTR_CONFS = {
    "loftr_stage0b": _loftr_hpatches("stage0b"),
    "loftr_stage0b_famb": _loftr_hpatches("stage0b", famb=True),
    "loftr_stage0b_refine": _loftr_hpatches("stage0b", refine=True),
    "loftr_stage0": _loftr_hpatches("stage0"),
}


def hpatches_loftr_conf(name: str = "loftr_stage0b") -> dict:
    """The committed LoFTR HPatches conf ``name`` of ``LOFTR_CONFS``."""
    return copy.deepcopy(LOFTR_CONFS[name])


def loftr_conf() -> dict:
    """``loftr.yaml``: LoFTR's model card (4 coarse layers, 1024 slots)."""
    return {"model": dict(_LOFTR)}


_LOFTR_TRAIN = {"log_every_iter": 50, "eval_every_iter": 500, "keep_last_checkpoints": 3,
                "clip_grad": 5.0, "best_key": "loss/total"}
_LOFTR_ENGINE = {"name": "homographies_ondevice", "pool_size": 512, "val_pool_size": 48,
                 "source_size": [448, 448], "image_size": 320, "max_gt_points": 32,
                 "train_batch_size": 8, "val_batch_size": 8, "steps_per_epoch": 500,
                 "val_steps": 4,
                 "homography": {"difficulty": 0.6, "translation": 0.3, "max_angle": 30.0},
                 "photometric": {"p": 0.95, "strength": 1.0}}


def loftr_ondevice_conf() -> dict:
    """``loftr_ondevice.yaml``: LoFTR (512 slots) from its initialisation on
    the on-device homography engine (512 + 48 images at 448x448, 320-pixel
    views, batch 8) with the focal coarse loss and the fine L2; the recipe of
    ``loftr_tpu_stage0``."""
    return copy.deepcopy({
        "data": _LOFTR_ENGINE,
        "model": {**_LOFTR, "max_matches": 512},
        "train": {"seed": 0, "epochs": 12, "optimizer": "adam", "lr": 3.0e-4,
                  "lr_schedule": {"type": "exp", "start": 3000, "exp_div_10": 12000},
                  **_LOFTR_TRAIN, "save_every_iter": 1000}})


def loftr_finetune_fine_conf() -> dict:
    """``loftr_finetune_fine.yaml``: stage 0 fine-tuned with the normalised
    fine correlation at a lower rate and twice the fine weight. Its
    ``load_experiment``, the run ``loftr_tpu_stage0``, is not committed: the
    recipe starts from that run's export, ``LOFTR_WEIGHTS['stage0']``."""
    conf = loftr_ondevice_conf()
    conf["model"]["loss"] = {"fine_weight": 2.0}
    conf["train"].update(seed=1, epochs=8, lr=1.0e-4,
                         lr_schedule={"type": "exp", "start": 1500, "exp_div_10": 8000},
                         load_experiment=LOFTR_WEIGHTS["stage0"])
    return conf


def loftr_homography_conf() -> dict:
    """``loftr_homography.yaml``: LoFTR (512 slots) from its initialisation on
    the host homography dataset (synthetic scenes, 320-pixel views, the lg
    photometrics, 8 loader processes, batch 8)."""
    return copy.deepcopy({
        "data": {"name": "homographies", "synthetic": True, "image_size": 320,
                 "train_size": 4000, "val_size": 64, "train_batch_size": 8,
                 "val_batch_size": 8, "num_workers": 8,
                 "homography": {"difficulty": 0.6, "max_angle": 30.0},
                 "photometric": {"name": "lg"}},
        "model": {**_LOFTR, "max_matches": 512},
        "train": {"seed": 0, "epochs": 8, "lr": 3.0e-4,
                  "lr_schedule": {"type": "exp", "start": 4000, "exp_div_10": 16000},
                  **_LOFTR_TRAIN, "save_every_iter": 2000}})


# --- the trajectory benchmark (scripts/sfm_trajectory.py) ------------------------------

def trajectory_sift_lg_card(max_kpts: int = 1024) -> dict:
    """The trajectory benchmark's default model card
    (gluefactory_tpu/scripts/sfm_trajectory.py ``_default_model_conf``): SIFT
    at contrast 0.02, then LightGlue on RootSIFT without scale and
    orientation."""
    return {"name": "two_view_pipeline",
            "extractor": {"name": "extractors.sift", "max_num_keypoints": max_kpts,
                          "contrast_threshold": 0.02},
            "matcher": {"name": "matchers.lightglue", "input_dim": 128,
                        "add_scale_ori": False, "n_layers": 6, "filter_threshold": 0.1,
                        "checkpointed": False, "save_layer_outputs": False},
            "ground_truth": {"name": None}, "run_gt_in_forward": False}


_GLUESTICK_CARD = {  # gluefactory_tpu/configs/superpoint+lsd+gluestick.yaml
    "name": "two_view_pipeline",
    "extractor": {"name": "lines.wireframe",
                  "point_extractor": {"name": "extractors.superpoint",
                                      "max_num_keypoints": 1000, "detection_threshold": 0.0,
                                      "dense_outputs": True},
                  "line_extractor": {"name": "lines.lsd", "max_num_lines": 250,
                                     "min_length": 15},
                  "nms_radius": 3.0},
    "matcher": {"name": "matchers.gluestick", "filter_threshold": 0.2},
    # sfm_trajectory's --conf merges these over a card
    "ground_truth": {"name": None}, "run_gt_in_forward": False,
}

# the committed runs outputs/results/trajectory/<name>: each run's model card and blob
TRAJECTORY_CONFS = {
    "sift_lg": {"model": trajectory_sift_lg_card(),
                "checkpoint": "weights/lg_sift_stage1.f16.msgpack"},
    "sift_lg_stage2": {"model": trajectory_sift_lg_card(),
                       "checkpoint": "weights/lg_sift_stage2.f16.msgpack"},
    "gluestick": {"model": _GLUESTICK_CARD,
                  "checkpoint": "weights/gluestick_tpu_stage0.f16.msgpack"},
}


def trajectory_conf(name: str) -> dict:
    """``{"model", "checkpoint"}`` of the trajectory run ``name``, a key of
    ``TRAJECTORY_CONFS``."""
    return copy.deepcopy(TRAJECTORY_CONFS[name])


# --- ALIKED ---------------------------------------------------------------------------

_ALIKED_N16 = {"name": "extractors.aliked", "model_name": "aliked-n16",
               "max_num_keypoints": 2048}
_NN = {"name": "matchers.nearest_neighbor_matcher"}

# gluefactory_tpu/configs/<name>.yaml, the model cards that the eval CLIs take by name
# (eval.io.read_named_conf); no ALIKED weights are in the repository, so each runs from
# its initialisation, and aliked_official_compat from torch_weight_converter's output
ALIKED_CONFS = {
    "aliked+lightglue": {"model": {
        "name": "two_view_pipeline", "extractor": _ALIKED_N16,
        "matcher": {"name": "matchers.lightglue", "input_dim": 128, "filter_threshold": 0.1,
                    "save_layer_outputs": False, "checkpointed": False}}},
    "aliked+nn": {"model": {"name": "two_view_pipeline", "extractor": _ALIKED_N16,
                            "matcher": _NN}},
    "aliked_official_compat": {"model": {
        "name": "two_view_pipeline",
        "extractor": {**_ALIKED_N16, "compat": True, "detection_threshold": 0.2,
                      "nms_radius": 2, "trainable": False},
        "matcher": _NN}},
}


def aliked_conf(name: str) -> dict:
    """The ALIKED model card ``name`` of ``ALIKED_CONFS``."""
    return copy.deepcopy(ALIKED_CONFS[name])


def aliked_lightglue_homography_conf() -> dict:
    """``aliked+lightglue_homography.yaml``: 9-layer LightGlue (checkpointed
    layers) on a frozen ALIKED-n16 (512 keypoints, threshold 0) from their
    initialisation, on the host homography dataset (synthetic scenes,
    640-pixel views, the lg photometrics, 8 loader processes, batch 32)."""
    return copy.deepcopy({
        "data": {"name": "homographies", "synthetic": True, "image_size": 640,
                 "train_batch_size": 32, "val_batch_size": 16, "num_workers": 8,
                 "homography": {"difficulty": 0.7, "max_angle": 45.0},
                 "photometric": {"name": "lg"}},
        "model": {"name": "two_view_pipeline",
                  "extractor": {"name": "extractors.aliked", "max_num_keypoints": 512,
                                "detection_threshold": 0.0, "trainable": False},
                  "matcher": {"name": "matchers.lightglue", "input_dim": 128,
                              "filter_threshold": 0.1, "checkpointed": True},
                  "ground_truth": {"name": "matchers.homography_matcher", "th_positive": 3.0,
                                   "th_negative": 6.0},
                  "run_gt_in_forward": True},
        "train": {"seed": 0, "epochs": 40, "lr": 1.0e-4,
                  "lr_schedule": {"type": "exp", "start": 20000, "exp_div_10": 200000},
                  "log_every_iter": 100, "eval_every_iter": 1000, "best_key": "loss/total"}})
