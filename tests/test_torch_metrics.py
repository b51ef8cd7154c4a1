"""The point half of gluefactory_torch/eval/metrics.py against
gluefactory_tpu/eval/metrics.py on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gluefactory_torch.eval import metrics as M
from gluefactory_tpu.eval import metrics as JM

torch.set_num_threads(2)

H = np.array([[1.02, 0.04, 9.0], [-0.03, 0.99, -6.0], [1.5e-4, -1e-4, 1.0]])
SIZE = np.array([320.0, 240.0])


def _warp(pts, H):
    hp = np.concatenate([pts, np.ones_like(pts[..., :1])], -1) @ H.T
    return hp[..., :2] / hp[..., 2:]


def keypoint_pair(seed: int, b: int = 2, n: int = 120):
    """View-1 keypoints: view 0's warped with noise, in another order, some
    replaced by random ones; padded slots in both."""
    rng = np.random.default_rng(seed)
    kp0 = rng.uniform(0, SIZE, (b, n, 2))
    kp1 = _warp(kp0, H) + rng.normal(0, 1.2, (b, n, 2))
    swap = rng.uniform(size=(b, n)) < 0.25
    kp1[swap] = rng.uniform(0, SIZE, (swap.sum(), 2))
    perm = np.stack([rng.permutation(n) for _ in range(b)])
    kp1 = np.take_along_axis(kp1, perm[..., None], 1)
    valid0 = rng.uniform(size=(b, n)) < 0.9
    valid1 = rng.uniform(size=(b, n)) < 0.9
    gt_m0 = np.argsort(perm, axis=1)  # kp1[gt_m0[i]] is kp0[i]'s
    gt_m0 = np.where(swap, -1, gt_m0)
    return {
        "kpts0": kp0.astype(np.float32), "kpts1": kp1.astype(np.float32),
        "valid0": valid0, "valid1": valid1,
        "scores0": rng.uniform(size=(b, n)).astype(np.float32),
        "scores1": rng.uniform(size=(b, n)).astype(np.float32),
        "H_0to1": np.broadcast_to(H, (b, 3, 3)).astype(np.float32),
        "image_size": np.broadcast_to(SIZE, (b, 2)).astype(np.float32),
        "gt_m0": gt_m0.astype(np.int64),
    }


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _close(port, jax_out, atol=1e-5):
    np.testing.assert_allclose(port.numpy(), np.asarray(jax_out), rtol=1e-5, atol=atol)


@pytest.mark.parametrize("seed", [0, 1])
def test_keypoint_repeatability_matches_jax(seed):
    d = keypoint_pair(seed)
    args = ("kpts0", "kpts1", "valid0", "valid1", "H_0to1", "image_size")
    for th in (1.0, 3.0):
        rep, loc = M.keypoint_repeatability(*(_t(d[k]) for k in args), th=th)
        jrep, jloc = JM.keypoint_repeatability(*(jnp.asarray(d[k]) for k in args), th=th)
        _close(rep, jrep)
        _close(loc, jloc)
    assert (rep.numpy() > 0.4).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_symmetric_rep_loc_H_matches_jax(seed):
    d = keypoint_pair(seed)
    args = [d[k] for k in ("kpts0", "kpts1", "scores0", "scores1", "valid0", "valid1",
                           "H_0to1", "image_size", "image_size")]
    for k in (50, 300):
        rep, loc = M.symmetric_rep_loc_H(*map(_t, args), k=k)
        jrep, jloc = JM.symmetric_rep_loc_H(*map(jnp.asarray, args), k=k)
        _close(rep, jrep)
        _close(loc, jloc)
    # nothing kept: -1 on both
    none = [*args[:4], np.zeros_like(d["valid0"]), np.zeros_like(d["valid1"]), *args[6:]]
    rep, loc = M.symmetric_rep_loc_H(*map(_t, none))
    assert (rep.numpy() == -1).all() and (loc.numpy() == -1).all()


def test_top_k_mask_matches_jax_with_ties():
    rng = np.random.default_rng(3)
    scores = rng.integers(0, 5, (3, 40)).astype(np.float32)  # many ties
    valid = rng.uniform(size=(3, 40)) < 0.8
    for k in (1, 7, 40):
        np.testing.assert_array_equal(
            M._top_k_mask(_t(scores), _t(valid), k).numpy(),
            np.asarray(JM._top_k_mask(jnp.asarray(scores), jnp.asarray(valid), k)))


def test_matching_scores_match_jax():
    d = keypoint_pair(2)
    rng = np.random.default_rng(4)
    m0 = np.where(rng.uniform(size=d["gt_m0"].shape) < 0.7, d["gt_m0"],
                  rng.integers(-1, 120, d["gt_m0"].shape))
    _close(M.matching_score(_t(m0), _t(d["gt_m0"]), _t(d["valid0"])),
           JM.matching_score(jnp.asarray(m0), jnp.asarray(d["gt_m0"]), jnp.asarray(d["valid0"])))
    args = [d["kpts0"], d["kpts1"], m0, d["valid0"], d["H_0to1"], d["image_size"]]
    port = M.descriptor_matching_score_H(*map(_t, args))
    ref = JM.descriptor_matching_score_H(*map(jnp.asarray, args))
    assert port.keys() == ref.keys()
    for th in ref:
        _close(port[th], ref[th])
    assert 0.3 < float(port[3.0].mean()) < 1.0


def test_descriptor_homography_correctness_matches_jax():
    """Descriptors that identify each keypoint's true partner (with noise),
    a quarter of them random: both packages find the same mutual matches
    and recover H, so the corner errors agree within 0.05 px (RANSAC's
    streams differ; the fits on the same inliers do not)."""
    rng = np.random.default_rng(5)
    n = 150
    kp0 = rng.uniform(10, SIZE - 10, (n, 2))
    kp1 = _warp(kp0, H) + rng.normal(0, 0.3, (n, 2))
    desc0 = rng.normal(size=(n, 32))
    desc1 = desc0 + rng.normal(0, 0.1, (n, 32))
    bad = rng.uniform(size=n) < 0.25
    desc1[bad] = rng.normal(size=(bad.sum(), 32))
    valid = np.ones(n, bool)
    valid[-5:] = False
    args = [kp0, desc0, valid, kp1, desc1, valid, H, SIZE]
    args = [a.astype(np.float32) if a.dtype == np.float64 else a for a in args]
    port, err = M.descriptor_homography_correctness(*map(_t, args))
    ref, jerr = JM.descriptor_homography_correctness(*map(jnp.asarray, args))
    assert port == ref and err < 1.0
    assert abs(err - jerr) < 0.05, (err, jerr)
    # fewer than 4 mutual matches: no fit
    few = [*args[:2], np.arange(n) < 3, *args[3:]]
    assert M.descriptor_homography_correctness(*map(_t, few)) == (
        {1.0: 0.0, 3.0: 0.0, 5.0: 0.0}, float("inf"))
