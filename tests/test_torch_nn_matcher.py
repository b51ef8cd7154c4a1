"""The nearest-neighbour matcher of the port against the JAX package on the
CPU: the same seeded descriptors and ragged masks through both, with the
ratio, distance and mutual options. Random float descriptors have no exact
similarity ties, so the matches are held equal; scores and similarities
within 1e-6 (one float32 product's rounding)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gluefactory_torch.models import build_model
from gluefactory_tpu.models import build_model as jax_build_model

torch.set_num_threads(2)

SCORE_ATOL = 1e-6


def _data(seed, b=2, n=96, m=80, d=32, masks=True):
    rng = np.random.default_rng(seed)

    def unit(k):
        x = rng.normal(size=(b, k, d)).astype(np.float32)
        return x / np.linalg.norm(x, axis=-1, keepdims=True)

    d0, d1 = unit(n), unit(m)
    d1[:, :n // 2] = d0[:, :n // 2] + 0.3 * d1[:, :n // 2]  # some near pairs
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
    data = {"descriptors0": d0, "descriptors1": d1}
    if masks:
        data["keypoint_valid0"] = rng.uniform(size=(b, n)) > 0.2
        data["keypoint_valid1"] = rng.uniform(size=(b, m)) > 0.3
    return data


@pytest.mark.parametrize("conf", [
    {},
    {"ratio_thresh": 0.8},
    {"ratio_thresh": 0.95, "mutual_check": False},
    {"distance_thresh": 0.7},
    {"ratio_thresh": 0.9, "distance_thresh": 0.9},
    {"mutual_check": False},
], ids=lambda c: ",".join(f"{k}={v}" for k, v in c.items()) or "default")
@pytest.mark.parametrize("masks", [True, False])
def test_nn_matcher_matches_jax(conf, masks):
    data = _data(len(conf) + 10 * masks, masks=masks)
    jax_model = jax_build_model("matchers.nearest_neighbor_matcher", conf)
    jdata = jax.tree.map(jnp.asarray, data)
    jpred = jax.tree.map(np.asarray, dict(jax.jit(jax_model.apply)(
        jax.jit(jax_model.init)(jax.random.key(0), jdata), jdata)))
    model = build_model("matchers.nearest_neighbor_matcher", conf, device="cpu")
    with torch.inference_mode():
        tpred = {k: v.numpy() for k, v in model(jax.tree.map(torch.from_numpy, data)).items()}
    for key in ("matches0", "matches1"):
        np.testing.assert_array_equal(tpred[key], jpred[key])
    assert (tpred["matches0"] > -1).sum() > 10  # the case matches something
    for key in ("matching_scores0", "matching_scores1", "similarity"):
        np.testing.assert_allclose(tpred[key], jpred[key], atol=SCORE_ATOL, rtol=0)


def test_nn_matcher_masks_and_codes():
    """Invalid slots are unmatched (-1) with score 0 and never a match
    target; mutual matches point at each other."""
    data = _data(3)
    model = build_model("matchers.nearest_neighbor_matcher", {}, device="cpu")
    with torch.inference_mode():
        pred = model(jax.tree.map(torch.from_numpy, data))
    m0, m1 = pred["matches0"], pred["matches1"]
    v0 = torch.from_numpy(data["keypoint_valid0"])
    v1 = torch.from_numpy(data["keypoint_valid1"])
    assert (m0[~v0] == -1).all() and (pred["matching_scores0"][~v0] == 0).all()
    assert (m1[~v1] == -1).all()
    for b in range(m0.shape[0]):
        idx = torch.nonzero(m0[b] > -1)[:, 0]
        assert v1[b, m0[b, idx]].all() and (m1[b, m0[b, idx]] == idx).all()
