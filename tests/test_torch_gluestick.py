"""GlueStick (``models/matchers/gluestick.py``) against the JAX package on the
CPU: at small width with the JAX initialisation carried over, in each of its
forward options; the official-checkpoint converter against JAX's; and the
committed ``weights/gluestick_tpu_stage0`` loaded strictly into the
SuperPoint + LSD wireframe pipeline and run on one rendered HPatches pair
at full width against the JAX pipeline.

Bounds: log-assignments (points, lines, the inter-supervision heads) and
line scores within TOL (1 + |JAX|) on valid rows and columns, matches
equal, matching scores within TOL; at full width with trained weights the
log-assignments within FULL_TOL and at least MATCH_SHARE of matches0 and
line_matches0 equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gluefactory_torch.eval.io import load_model
from gluefactory_torch.models import build_model
from gluefactory_torch.recipes import GLUESTICK_WEIGHTS, hpatches_gluestick_conf
from gluefactory_torch.scripts.generate_eval_set import render_sequence
from gluefactory_torch.utils.image import read_image
from gluefactory_torch.utils.weights import load_state_strict, params_from_flat
from gluefactory_tpu.core.config import Config
from gluefactory_tpu.eval.io import load_model as jax_load_model
from gluefactory_tpu.eval.io import restore_params
from gluefactory_tpu.models import build_model as jax_build_model
from gluefactory_tpu.utils.experiments import state_to_flat_dict

torch.set_num_threads(2)

TOL = 1e-4
FULL_TOL = 2e-3  # trained weights: log-probabilities of tens through 6 layers
MATCH_SHARE = 0.99


def _ragged(rng, b, n):
    valid = rng.uniform(size=(b, n)) > 0.2
    valid[0, (2 * n) // 3:] = False
    return valid


def _data(seed, b=2, n_lines=(10, 8), n_kpts=(40, 36), d=32):
    """Two views of random junction graphs: 2L junction slots then keypoints,
    lines whose endpoints index the junction slots, ragged masks."""
    rng = np.random.default_rng(seed)
    out = {}
    for i, (nl, nk) in enumerate(zip(n_lines, n_kpts)):
        n = 2 * nl + nk
        out[f"keypoints{i}"] = rng.uniform(0, 320, (b, n, 2)).astype(np.float32)
        out[f"keypoint_scores{i}"] = rng.uniform(size=(b, n)).astype(np.float32)
        out[f"descriptors{i}"] = rng.normal(size=(b, n, d)).astype(np.float32)
        out[f"keypoint_valid{i}"] = _ragged(rng, b, n)
        out[f"lines{i}"] = rng.uniform(0, 320, (b, nl, 2, 2)).astype(np.float32)
        out[f"line_scores{i}"] = rng.uniform(1, 5, (b, nl)).astype(np.float32)
        out[f"valid_lines{i}"] = _ragged(rng, b, nl)
        out[f"lines_junc_idx{i}"] = rng.integers(0, 2 * nl, (b, 2 * nl)).astype(np.int32)
        out[f"view{i}"] = {"image_size": np.tile(np.float32([[320.0, 240.0 + 40 * i]]), (b, 1))}
    return out


def _valid(x, mask0, mask1):
    b = x.shape[0]
    rows = np.concatenate([mask0, np.ones((b, 1), bool)], 1)
    cols = np.concatenate([mask1, np.ones((b, 1), bool)], 1)
    return x[rows[:, :, None] & cols[:, None, :]]


def _compare(pred, ref, data, tol=TOL):
    masks = {"log_assignment": ("keypoint_valid0", "keypoint_valid1")}
    for key in ref:
        if key.endswith("log_assignment") and key != "log_assignment":
            masks[key] = ("valid_lines0", "valid_lines1")
    for key, (m0, m1) in masks.items():
        a, r = _valid(pred[key], data[m0], data[m1]), _valid(ref[key], data[m0], data[m1])
        assert np.isfinite(a).all(), key
        np.testing.assert_allclose(a, r, atol=tol, rtol=tol, err_msg=key)
    pair = data["valid_lines0"][:, :, None] & data["valid_lines1"][:, None, :]
    np.testing.assert_allclose(pred["raw_line_scores"][pair], ref["raw_line_scores"][pair],
                               atol=tol, rtol=tol)
    for key in ("matches0", "matches1", "line_matches0", "line_matches1"):
        np.testing.assert_array_equal(pred[key], ref[key], err_msg=key)
    for key in ("matching_scores0", "line_matching_scores0"):
        np.testing.assert_allclose(pred[key], ref[key], atol=tol, rtol=0, err_msg=key)


VARIANTS = {
    "default": {},
    "norm_none": {"norm": "none"},
    "line_proj": {"line_score_source": "line_proj"},
    "compat_score_tiling": {"compat_score_tiling": True},
    "inference_only": {"inference_only": True},
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_gluestick_is_jaxs_with_flax_init(variant):
    conf = {"input_dim": 32, "descriptor_dim": 32, "num_heads": 4, "n_layers": 2,
            "inter_supervision": [0], "filter_threshold": 0.0, "line_filter_threshold": 0.0,
            **VARIANTS[variant]}
    data = _data(len(variant))
    jdata = jax.tree.map(jnp.asarray, data)
    jmodel = jax_build_model("matchers.gluestick", conf)
    params = jax.jit(jmodel.init)(jax.random.key(0), jdata)
    ref = jax.tree.map(np.asarray, dict(jax.jit(jmodel.apply)(params, jdata)))
    model = build_model("matchers.gluestick", conf, device="cpu")
    load_state_strict(model, params_from_flat(state_to_flat_dict(params)))
    with torch.inference_mode():
        pred = {k: v.numpy() for k, v in model(jax.tree.map(torch.from_numpy, data)).items()}
    assert pred.keys() == ref.keys()
    assert ("line_0_log_assignment" in pred) == (variant != "inference_only")
    _compare(pred, ref, data)
    assert (pred["matches0"] > -1).sum() > 5 and (pred["line_matches0"] > -1).sum() > 2


def test_training_options_are_refused():
    """The training options are ported (tests/test_torch_gluestick_train.py):
    ``checkpointed`` and the loss weights build and are kept; a norm or a line
    score source that the JAX model lacks is still refused."""
    model = build_model("matchers.gluestick", {"checkpointed": True,
                                               "loss": {"inter_weight": 1.0}}, device="cpu")
    assert model.conf["checkpointed"] and model.conf["loss"]["inter_weight"] == 1.0
    assert model.conf["loss"]["line_nll_weight"] == 1.0
    for conf in ({"norm": "batch"}, {"line_score_source": "mean"}):
        with pytest.raises(NotImplementedError):
            build_model("matchers.gluestick", conf, device="cpu")


def test_torch_weight_converter_is_jaxs():
    """The port's converter of an official checkpoint (a random state dict of
    its layout, BatchNorms with non-trivial statistics) against the JAX
    package's: the same parameters, and the same forward."""
    from gluefactory_torch.models.matchers.gluestick import torch_weight_converter
    from gluefactory_tpu.models.matchers.gluestick import (
        torch_weight_converter as jax_torch_weight_converter,
    )
    from test_weight_converters import _rand_state_gluestick

    torch.manual_seed(0)
    official = _rand_state_gluestick(d=32, h=4, L=2)
    conf = {"input_dim": 32, "descriptor_dim": 32, "num_heads": 4, "n_layers": 2,
            "norm": "none", "line_score_source": "line_proj", "compat_score_tiling": True,
            "filter_threshold": 0.0, "line_filter_threshold": 0.0}
    jparams = jax.tree.map(jnp.asarray, jax_torch_weight_converter(
        {k: v.numpy() for k, v in official.items()}, conf))
    state = torch_weight_converter(official, conf)
    expected = params_from_flat(state_to_flat_dict(jparams))
    assert state.keys() == expected.keys()
    for name, value in expected.items():
        assert state[name].dtype == value.dtype and torch.equal(state[name], value), name
    model = build_model("matchers.gluestick", conf, device="cpu")
    load_state_strict(model, state)
    data = _data(7)
    ref = jax.tree.map(np.asarray, dict(jax.jit(jax_build_model("matchers.gluestick",
                                                                conf).apply)(
        jparams, jax.tree.map(jnp.asarray, data))))
    with torch.inference_mode():
        pred = {k: v.numpy() for k, v in model(jax.tree.map(torch.from_numpy, data)).items()}
    _compare(pred, ref, data)


def test_blob_loads_strictly_and_pipeline_is_jaxs(tmp_path):
    """gluestick_tpu_stage0 (its own SuperPoint, 6 layers, inter-supervision at
    2 and 4) in the wireframe pipeline of ``hpatches_gluestick_conf`` (512
    keypoints, 128 lines, CoM readout; refiner left out: it is held to JAX on
    its own) on a rendered 480x360 pair, against the JAX pipeline."""
    from gluefactory_torch.utils.weights import load_weight_blob

    model_conf = hpatches_gluestick_conf()["model"]
    model_conf.pop("filter")
    # strict: every parameter of the pipeline (SuperPoint under the
    # wireframe, GlueStick at the blob's 6 layers) from the blob, every key used
    flat, blob_model_conf, _ = load_weight_blob(GLUESTICK_WEIGHTS)
    strict = build_model("two_view_pipeline", {**model_conf, "matcher": {
        **model_conf["matcher"], **blob_model_conf["matcher"]}}, device="cpu")
    load_state_strict(strict, params_from_flat(flat))
    ours_model = load_model(model_conf, str(GLUESTICK_WEIGHTS), "cpu")
    for name, value in strict.state_dict().items():
        assert torch.equal(ours_model.state_dict()[name], value), name
    assert ours_model.matcher.conf["n_layers"] == 6

    render_sequence(tmp_path / "s", np.random.default_rng((424242, 2)), (480, 360), "a")
    images = [read_image(tmp_path / "s" / f"{v}.ppm").astype(np.float32)[None] / 255.0
              for v in (1, 4)]
    size = np.float32([[480.0, 360.0]])
    data = {f"view{i}": {"image": im, "image_size": size} for i, im in enumerate(images)}
    jmodel, jflat = jax_load_model(Config(model_conf), str(GLUESTICK_WEIGHTS))
    jdata = jax.tree.map(jnp.asarray, data)
    # the blob holds every parameter: the template needs only their shapes
    jparams = restore_params(jax.eval_shape(jmodel.init, jax.random.key(0), jdata), jflat)
    ref = jax.tree.map(np.asarray, dict(jax.jit(jmodel.apply)(jparams, jdata)))
    with torch.inference_mode():
        pred = {k: v.numpy() for k, v in ours_model(jax.tree.map(torch.from_numpy, data)).items()}
    for key in ("lines0", "lines_junc_idx1", "keypoint_valid0", "valid_lines1"):
        np.testing.assert_allclose(pred[key], ref[key], atol=1e-3, rtol=0, err_msg=key)
    for key in ("matches0", "line_matches0"):
        share = (pred[key] == ref[key]).mean()
        assert share >= MATCH_SHARE, (key, share)
    both = {k: pred[k] for k in ("keypoint_valid0", "keypoint_valid1", "valid_lines0",
                                 "valid_lines1")}
    for key, (m0, m1) in (("log_assignment", ("keypoint_valid0", "keypoint_valid1")),
                          ("line_log_assignment", ("valid_lines0", "valid_lines1"))):
        np.testing.assert_allclose(_valid(pred[key][0:1], both[m0], both[m1]),
                                   _valid(ref[key][0:1], both[m0], both[m1]),
                                   atol=FULL_TOL, rtol=FULL_TOL, err_msg=key)
    assert (pred["matches0"] > -1).sum() > 50 and (pred["line_matches0"] > -1).sum() > 20
