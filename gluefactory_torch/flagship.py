"""The flagship two-view pipeline: SuperPoint with the CoM sub-pixel readout,
6-layer LightGlue, the ZNCC match refiner and batched LO-RANSAC homography,
with the committed ``lg_tpu_stage2`` weights (both halves are in the blob).
The JAX package gates the same pipeline in
tests/test_trained_quality.py::test_trained_flagship_refined_quality."""

from __future__ import annotations

import numpy as np
import torch

from .geometry.homography import homography_corner_error, warp_points
from .models import build_model
from .models.matchers.lightglue import head_counts
from .robust_estimators import load_estimator
from .settings import WEIGHTS_PATH
from .utils.weights import load_blob_into

FLAGSHIP_WEIGHTS = WEIGHTS_PATH / "lg_tpu_stage2.f16.msgpack"
RANSAC_CONF = {"ransac_th": 3.0, "num_hypotheses": 512, "lo_iters": 4}
# the JAX gate's bounds on the medians over its 6 pairs
# (tests/test_trained_quality.py::test_trained_flagship_refined_quality)
GATE = {"matches": 150, "prec1": 0.35, "prec3": 0.6, "h_err": 1.5}


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
    heads = head_counts(model)
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


def pair_quality(pred: dict, H_gt: torch.Tensor, image_size: torch.Tensor, estimator,
                 i: int = 0) -> dict:
    """The JAX gate's readings of one pair: matches, the share of matches
    within 1 and 3 px of where ``H_gt`` puts them, and the corner error of
    the RANSAC homography over the image of size ``image_size`` (w, h)."""
    mk0, mk1 = matched_keypoints(pred, i)
    err = torch.linalg.vector_norm(warp_points(mk0, H_gt) - mk1, dim=-1)
    n = int(mk0.shape[0])
    out = estimate_homography(pred, estimator, i)
    return {"matches": n,
            "prec1": float((err < 1).float().mean()) if n else 0.0,
            "prec3": float((err < 3).float().mean()) if n else 0.0,
            "h_err": float(homography_corner_error(out["M_0to1"], H_gt, image_size))}


def passes_gate(stats: dict[str, list]) -> bool:
    """The medians of ``pair_quality`` readings against ``GATE``."""
    med = {k: float(np.median(v)) for k, v in stats.items()}
    return (med["matches"] > GATE["matches"] and med["prec1"] > GATE["prec1"]
            and med["prec3"] > GATE["prec3"] and med["h_err"] < GATE["h_err"])
