"""The port's models, weights and estimators against the JAX package, on the
CPU, at small sizes: both sides get the same numpy inputs and the same
parameters (the JAX init, carried over by ``params_from_flat``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from gluefactory_tpu.models import build_model as jax_build_model
from gluefactory_tpu.robust_estimators.homography.ransac import ransac_homography
from gluefactory_tpu.scripts.export_weights import load_weight_blob as jax_load_blob
from gluefactory_tpu.utils.experiments import state_to_flat_dict
from gluefactory_torch.core.config import merge
from gluefactory_torch.geometry.homography import homography_corner_error
from gluefactory_torch.flagship import FLAGSHIP_WEIGHTS, flagship_conf, load_weights
from gluefactory_torch.models import build_model, get_model
from gluefactory_torch.models.matchers.lightglue import LightGlue
from gluefactory_torch.models.matchers.match_refiner import MatchRefiner
from gluefactory_torch.robust_estimators import load_estimator
from gluefactory_torch.utils.weights import (
    load_state_strict,
    load_weight_blob,
    params_from_flat,
)

torch.set_num_threads(2)


def _port(name, conf, jax_params, heads=None):
    """The port's model ``name`` holding the JAX params."""
    model = build_model(name, conf, device="cpu")
    load_state_strict(model, params_from_flat(state_to_flat_dict(jax_params), heads))
    return model


def _tiny_conf():
    conf = __graft_entry__._flagship_conf(tiny=True)
    conf["extractor"]["detection_threshold"] = 0.005
    return conf


def _images(rng, b=1, h=64, w=80):
    return rng.uniform(0, 1, (b, h, w, 3)).astype(np.float32)


def test_blob_decoder_matches_flax():
    """The pure-Python msgpack decoder reads every array of the flagship blob
    exactly as flax does (193 keys: 24 extractor, 169 matcher)."""
    flat, conf, meta = load_weight_blob(FLAGSHIP_WEIGHTS)
    jflat, jconf, jmeta = jax_load_blob(FLAGSHIP_WEIGHTS)
    assert (conf, meta) == (jconf, jmeta)
    assert flat.keys() == jflat.keys() and len(flat) == 193
    assert sum("['extractor']" in k for k in flat) == 24
    for key, value in jflat.items():
        assert flat[key].dtype == value.dtype and np.array_equal(flat[key], value), key


def test_flagship_blob_loads_strictly():
    model = build_model("two_view_pipeline", flagship_conf(), device="cpu")
    model_conf = load_weights(model)
    assert model_conf["matcher"]["n_layers"] == 6
    assert len(model.state_dict()) == 193
    flat, _, _ = load_weight_blob(FLAGSHIP_WEIGHTS)
    state = params_from_flat(flat, {"matcher": 4})
    extra = dict(state, **{"matcher.unused.weight": torch.zeros(1)})
    with pytest.raises(KeyError, match="unused"):
        load_state_strict(model, extra)
    state.pop("matcher.input_proj.bias")
    with pytest.raises(KeyError, match="missing"):
        load_state_strict(model, state)


def test_superpoint_matches_jax():
    conf = _tiny_conf()["extractor"]
    conf.update(refinement_radius=2, refinement_mode="com")
    rng = np.random.default_rng(0)
    img = _images(rng, b=2)
    size = np.array([[80.0, 64.0], [72.0, 60.0]], np.float32)
    jmodel = jax_build_model("extractors.superpoint", conf)
    jdata = {"image": jnp.asarray(img), "image_size": jnp.asarray(size)}
    params = jax.jit(jmodel.init)(jax.random.key(0), jdata)
    jpred = jax.jit(jmodel.apply)(params, jdata)
    model = _port("extractors.superpoint", conf, params)
    with torch.inference_mode():
        pred = model({"image": torch.from_numpy(img), "image_size": torch.from_numpy(size)})
    assert set(pred) == {"keypoints", "keypoint_scores", "keypoint_valid", "descriptors"}
    np.testing.assert_array_equal(pred["keypoint_valid"].numpy(),
                                  np.asarray(jpred["keypoint_valid"]))
    assert pred["keypoint_valid"].sum() > 10
    np.testing.assert_allclose(pred["keypoints"].numpy(), np.asarray(jpred["keypoints"]),
                               atol=1e-4)  # CoM over conv outputs summed in another order
    for key, atol in (("keypoint_scores", 1e-6), ("descriptors", 1e-5)):
        np.testing.assert_allclose(pred[key].numpy(), np.asarray(jpred[key]), atol=atol)


def _lightglue_inputs(rng, b=2, n=24, m=20, dim=32):
    def view(k):
        kp = rng.uniform(0, 60, (b, k, 2)).astype(np.float32)
        desc = rng.normal(size=(b, k, dim)).astype(np.float32)
        valid = rng.uniform(size=(b, k)) > 0.15
        return kp, desc / np.linalg.norm(desc, axis=-1, keepdims=True), valid

    kp0, d0, v0 = view(n)
    kp1, d1, v1 = view(m)
    d1[:, : n // 2] = d0[:, : n // 2] + 0.1 * rng.normal(size=(b, n // 2, dim))
    size = np.full((b, 2), 64.0, np.float32)
    return {"keypoints0": kp0, "keypoints1": kp1, "descriptors0": d0,
            "descriptors1": d1.astype(np.float32), "keypoint_valid0": v0,
            "keypoint_valid1": v1, "view0": {"image_size": size},
            "view1": {"image_size": size}}


@pytest.mark.parametrize("attention", ["auto", "xla"])
def test_lightglue_matches_jax(attention):
    conf = {k: v for k, v in _tiny_conf()["matcher"].items() if k != "flash"}
    conf["attention"] = attention
    data = _lightglue_inputs(np.random.default_rng(1))
    jdata = jax.tree.map(jnp.asarray, data)
    jmodel = jax_build_model("matchers.lightglue", {**conf, "attention": "xla"})
    params = jax.jit(jmodel.init)(jax.random.key(1), jdata)
    jpred = jax.jit(jmodel.apply)(params, jdata)
    model = _port("matchers.lightglue", conf, params, heads={"": conf["num_heads"]})
    with torch.inference_mode():
        pred = model(jax.tree.map(torch.from_numpy, data))
    scores = pred["log_assignment"].numpy()
    jscores = np.asarray(jpred["log_assignment"])
    finite = jscores > -1e29
    np.testing.assert_array_equal(scores > -1e29, finite)
    np.testing.assert_allclose(scores[finite], jscores[finite], atol=1e-4)
    for key in ("matches0", "matches1"):
        np.testing.assert_array_equal(pred[key].numpy(), np.asarray(jpred[key]))
    for key in ("matching_scores0", "matchability0", "matchability1"):
        np.testing.assert_allclose(pred[key].numpy(), np.asarray(jpred[key]), atol=1e-5)


@pytest.mark.parametrize("with_scale_ori", [True, False])
def test_lightglue_scale_ori_matches_jax(with_scale_ori):
    """``add_scale_ori``: posenc reads [x, y, scale, orientation], zeros where
    the data carry no ``scales*``/``oris*`` (the cached engine's batches)."""
    conf = {k: v for k, v in _tiny_conf()["matcher"].items() if k != "flash"}
    conf.update(add_scale_ori=True, attention="xla")
    rng = np.random.default_rng(2)
    data = _lightglue_inputs(rng)
    if with_scale_ori:
        for i, n in (("0", 24), ("1", 20)):
            data[f"scales{i}"] = rng.uniform(1, 12, (2, n)).astype(np.float32)
            data[f"oris{i}"] = rng.uniform(-np.pi, np.pi, (2, n)).astype(np.float32)
    jdata = jax.tree.map(jnp.asarray, data)
    jmodel = jax_build_model("matchers.lightglue", conf)
    params = jax.jit(jmodel.init)(jax.random.key(3), jdata)
    jpred = jax.jit(jmodel.apply)(params, jdata)
    model = _port("matchers.lightglue", conf, params, heads={"": conf["num_heads"]})
    assert model.posenc.Wr.weight.shape[1] == 4
    with torch.inference_mode():
        pred = model(jax.tree.map(torch.from_numpy, data))
    scores, jscores = pred["log_assignment"].numpy(), np.asarray(jpred["log_assignment"])
    finite = jscores > -1e29
    np.testing.assert_allclose(scores[finite], jscores[finite], atol=1e-4)
    np.testing.assert_array_equal(pred["matches0"].numpy(), np.asarray(jpred["matches0"]))
    # a blob of the 2-input posenc does not load into it
    flat = {k: v for k, v in state_to_flat_dict(params).items()}
    flat["['params']['posenc']['kernel']"] = np.asarray(flat["['params']['posenc']['kernel']"])[:2]
    with pytest.raises(ValueError, match="posenc"):
        load_state_strict(model, params_from_flat(flat, {"": conf["num_heads"]}))


def _texture(h, w, rng):
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    img = np.zeros((h, w))
    for k in (4, 9, 17):
        for _ in range(6):
            fx, fy = rng.uniform(-k, k, 2) / max(h, w) * 2 * np.pi
            img += rng.uniform(0.2, 1.0) * np.cos(fx * xx + fy * yy + rng.uniform(0, 6.3))
    return ((img - img.min()) / (img.max() - img.min())).astype(np.float32)


def test_match_refiner_matches_jax():
    """Window mode on a textured pair: noisy matches, an unmatched slot and
    an invalid slot, compared with the JAX refiner on the same inputs."""
    rng = np.random.default_rng(2)
    img0 = _texture(96, 96, rng)
    img1 = np.roll(img0, (2, -3), axis=(0, 1)) * 0.9 + 0.05
    n = 40
    kp0 = rng.uniform(14, 80, (1, n, 2)).astype(np.float32)
    kp1 = (kp0 + np.array([-3.0, 2.0]) + rng.normal(0, 1.0, kp0.shape)).astype(np.float32)
    matches0 = rng.permutation(n)[None]
    kp1 = kp1[:, np.argsort(matches0[0])]  # kp1[matches0[i]] is kp0[i]'s match
    matches0[0, :3] = -1
    valid0 = np.ones((1, n), bool)
    valid0[0, 5] = False
    data = {"view0": {"image": img0[None, :, :, None]},
            "view1": {"image": np.repeat(img1[None, :, :, None], 3, -1)},
            "keypoints0": kp0, "keypoints1": kp1, "matches0": matches0.astype(np.int32),
            "matching_scores0": rng.uniform(0.2, 1.0, (1, n)).astype(np.float32),
            "keypoint_valid0": valid0}
    conf = {"window_sampling": True}
    jdata = jax.tree.map(jnp.asarray, data)
    jmodel = jax_build_model("matchers.match_refiner", conf)
    jpred = jax.jit(jmodel.apply)(jax.jit(jmodel.init)(jax.random.key(0), jdata), jdata)
    pred = MatchRefiner(conf)(jax.tree.map(torch.from_numpy, data))
    np.testing.assert_array_equal(pred["refined1"].numpy(), np.asarray(jpred["refined1"]))
    moved = np.abs(pred["keypoints1"].numpy() - kp1).max(-1) > 0.05
    assert moved.sum() > n // 2
    # the IRLS homography's 9x9 eigensolvers differ in the last bits
    np.testing.assert_allclose(pred["keypoints1"].numpy(), np.asarray(jpred["keypoints1"]),
                               atol=1e-3)


def test_ransac_with_shared_samples_matches_jax():
    """Fed the minimal sets that the JAX estimator draws, the port's LO-RANSAC
    finds the same homography and inliers."""
    rng = np.random.default_rng(3)
    n = 200
    p0 = rng.uniform(0, 400, (n, 2)).astype(np.float32)
    H = np.array([[1.05, 0.03, 12.0], [-0.02, 0.97, -8.0], [1e-4, -5e-5, 1.0]], np.float32)
    hp = np.concatenate([p0, np.ones((n, 1), np.float32)], 1) @ H.T
    p1 = (hp[:, :2] / hp[:, 2:] + rng.normal(0, 0.7, (n, 2))).astype(np.float32)
    p1[:60] = rng.uniform(0, 400, (60, 2))  # outliers
    valid = np.ones(n, bool)
    valid[-10:] = False
    key, s = jax.random.key(0), 256
    logits = jnp.where(jnp.asarray(valid), 0.0, -1e9)
    sample_idx = jax.vmap(lambda k: jax.random.categorical(k, logits, shape=(4,)))(
        jax.random.split(key, s))
    jH, jinl, jscore = ransac_homography(jnp.asarray(p0), jnp.asarray(p1),
                                         jnp.asarray(valid), key, th=3.0,
                                         num_hypotheses=s, lo_iters=4)
    est = load_estimator("homography", "ransac")({"num_hypotheses": s})
    out = est({"m_kpts0": torch.from_numpy(p0), "m_kpts1": torch.from_numpy(p1),
               "valid": torch.from_numpy(valid),
               "sample_idx": torch.from_numpy(np.array(sample_idx)).long()})
    assert out["success"]
    np.testing.assert_allclose(out["M_0to1"].numpy(), np.asarray(jH), rtol=1e-3, atol=1e-4)
    np.testing.assert_array_equal(out["inliers"].numpy(), np.asarray(jinl))
    assert out["score"] == pytest.approx(float(jscore))
    # with its own random minimal sets it still recovers the homography
    own = est({"m_kpts0": torch.from_numpy(p0), "m_kpts1": torch.from_numpy(p1)})
    assert own["success"]
    assert float(homography_corner_error(own["M_0to1"], torch.from_numpy(H),
                                         torch.tensor([400.0, 400.0]))) < 1.0


def test_config_merge_and_registry():
    base = {"a": 1, "sub": {"x": 1, "y": [1, 2]}}
    merged = merge(base, {"sub": {"x": 5}, "b": 2})
    assert merged == {"a": 1, "b": 2, "sub": {"x": 5, "y": [1, 2]}}
    assert base["sub"]["x"] == 1  # the defaults are not mutated
    assert get_model("matchers.lightglue") is LightGlue
    assert get_model("extractors.superpoint").__name__ == "SuperPoint"
    with pytest.raises(ImportError, match="no component"):
        get_model("matchers.no_such_matcher")


def test_entry_points_need_cuda_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model("matchers.match_refiner")


def test_unported_options_raise():
    # adaptive depth and width (tests/test_torch_adaptive.py), add_scale_ori
    # (test_lightglue_scale_ori_matches_jax), the refiner's static mode
    # (tests/test_torch_refiner_modes.py), the line ground truth
    # (tests/test_torch_line_gt.py) and LBD descriptors (tests/test_torch_line_models.py)
    # are ported; SOLD2's loss is not
    build_model("matchers.lightglue", {"add_scale_ori": True}, device="cpu")
    build_model("matchers.match_refiner", {"window_sampling": "static"}, device="cpu")
    build_model("matchers.depth_matcher", {"use_lines": True}, device="cpu")
    build_model("lines.lsd", {"describe": "lbd"}, device="cpu")
    with pytest.raises(NotImplementedError):
        build_model("lines.sold2", {"loss": {"desc_nll_weight": 1.0}}, device="cpu")
