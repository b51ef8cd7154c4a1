"""The flagship two-view pipeline: SuperPoint with the CoM sub-pixel readout,
6-layer LightGlue, the ZNCC match refiner and batched LO-RANSAC homography,
with the committed ``lg_tpu_stage2`` weights (both halves are in the blob).
The JAX package gates the same pipeline in
tests/test_trained_quality.py::test_trained_flagship_refined_quality."""

from __future__ import annotations

import torch

from .models import build_model
from .models.matchers.lightglue import LightGlue
from .robust_estimators import load_estimator
from .settings import WEIGHTS_PATH
from .utils.weights import load_blob_into

FLAGSHIP_WEIGHTS = WEIGHTS_PATH / "lg_tpu_stage2.f16.msgpack"
RANSAC_CONF = {"ransac_th": 3.0, "num_hypotheses": 512, "lo_iters": 4}


def flagship_conf(attention: str = "auto") -> dict:
    """``attention``: 'auto' runs the CUDA kernels, 'xla' the plain versions."""
    return {
        "name": "two_view_pipeline",
        "extractor": {
            "name": "extractors.superpoint",
            "max_num_keypoints": 512,
            "detection_threshold": 0.005,
            "nms_radius": 4,
            "refinement_radius": 2,
            "refinement_mode": "com",
        },
        "matcher": {"name": "matchers.lightglue", "n_layers": 6, "filter_threshold": 0.1,
                    "save_layer_outputs": False, "attention": attention},
        "filter": {"name": "matchers.match_refiner", "window_sampling": True},
    }


def load_weights(model: torch.nn.Module, path=FLAGSHIP_WEIGHTS) -> dict:
    """Load a committed blob strictly into a pipeline; returns its model_conf."""
    heads = {name: m.conf["num_heads"] for name, m in model.named_modules()
             if isinstance(m, LightGlue)}
    model_conf, _ = load_blob_into(model, path, num_heads=heads)
    return model_conf


def load_flagship(device: str | torch.device = "cuda", attention: str = "auto"):
    """(pipeline with the flagship weights, homography estimator)."""
    model = build_model("two_view_pipeline", flagship_conf(attention), device=device)
    load_weights(model)
    return model, load_estimator("homography", "ransac")(RANSAC_CONF)


def matched_keypoints(pred: dict, i: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Matched keypoint pairs of batch item ``i``, padded slots excluded."""
    m0 = pred["matches0"][i]
    valid = (m0 > -1) & pred["keypoint_valid0"][i]
    valid = valid & pred["keypoint_valid1"][i][m0.clamp_min(0)]
    return pred["keypoints0"][i][valid], pred["keypoints1"][i][m0[valid]]


def estimate_homography(pred: dict, estimator, i: int = 0) -> dict:
    """RANSAC homography of the matches of item ``i`` (zeros if fewer than 4,
    as the JAX gate does)."""
    mk0, mk1 = matched_keypoints(pred, i)
    if mk0.shape[0] < 4:
        mk0 = mk1 = torch.zeros(4, 2, device=mk0.device)
    return estimator({"m_kpts0": mk0, "m_kpts1": mk1})
