"""Hybrid point and line homography RANSAC
(``robust_estimators/homography/hybrid_ransac.py``) against the JAX package
on the CPU, fed JAX's minimal sets (drawn here exactly as the JAX estimator
draws them from its seed), on synthetic correspondences with outliers:
points only, lines only, and both.

Bounds: the homographies' corner distance within H_PX on a 640x480 image,
the point and line inliers equal, ``success`` equal; the building blocks
(line coefficients, residuals, the joint DLT) within BLOCK_TOL."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gluefactory_torch.geometry.homography import homography_corner_error
from gluefactory_torch.robust_estimators import load_estimator
from gluefactory_torch.robust_estimators.homography import hybrid_ransac as HR
from gluefactory_tpu.robust_estimators import load_estimator as jax_load_estimator
from gluefactory_tpu.robust_estimators.homography import hybrid_ransac as JHR

torch.set_num_threads(2)

H_PX = 1e-2
BLOCK_TOL = 1e-4
SIZE = np.float32([640.0, 480.0])


def _scene(seed, n_pts=120, n_lines=40, outliers=0.3):
    rng = np.random.default_rng(seed)
    H = np.eye(3) + rng.normal(0, [[0.05, 0.05, 8], [0.05, 0.05, 8], [5e-5, 5e-5, 0]])
    def warp(p):
        q = np.c_[p, np.ones(len(p))] @ H.T
        return q[:, :2] / q[:, 2:]
    k0 = rng.uniform([0, 0], SIZE, (n_pts, 2))
    k1 = warp(k0) + rng.normal(0, 0.5, (n_pts, 2))
    bad = rng.uniform(size=n_pts) < outliers
    k1[bad] = rng.uniform([0, 0], SIZE, (bad.sum(), 2))
    s0 = rng.uniform([0, 0], SIZE, (n_lines, 2, 2))
    # view-1 segments: the warped line, its endpoints slid along it and noisy
    w = warp(s0.reshape(-1, 2)).reshape(n_lines, 2, 2)
    t = rng.uniform(-0.2, 0.2, (n_lines, 2, 1))
    s1 = w + t * (w[:, 1:] - w[:, :1]) + rng.normal(0, 0.4, (n_lines, 2, 2))
    bad = rng.uniform(size=n_lines) < outliers
    s1[bad] = rng.uniform([0, 0], SIZE, (bad.sum(), 2, 2))
    f32 = np.float32
    return {"m_kpts0": k0.astype(f32), "m_kpts1": k1.astype(f32),
            "valid": rng.uniform(size=n_pts) > 0.05,
            "m_lines0": s0.astype(f32), "m_lines1": s1.astype(f32),
            "valid_lines": rng.uniform(size=n_lines) > 0.05}


def _jax_sample_idx(valid_pts, valid_lines, seed, num_hypotheses):
    """The JAX estimator's minimal sets: 4 categorical draws a hypothesis
    over the valid points then lines, from its key's split."""
    logits = jnp.concatenate([jnp.where(jnp.asarray(valid_pts), 0.0, -1e9),
                              jnp.where(jnp.asarray(valid_lines), 0.0, -1e9)])
    keys = jax.random.split(jax.random.key(seed), num_hypotheses)
    return np.array(jax.vmap(lambda k: jax.random.categorical(k, logits, shape=(4,)))(keys))


CASES = {
    "mixed": {},
    "points_only": {"drop_lines": True},
    "lines_only": {"no_points": True},
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("th", [1.0, 3.0])
def test_hybrid_ransac_is_jaxs(case, th):
    data = _scene(7 + int(th))
    if CASES[case].get("drop_lines"):
        data = {k: v for k, v in data.items() if "lines" not in k}
    if CASES[case].get("no_points"):
        data["valid"] = np.zeros_like(data["valid"])
    conf = {"ransac_th": th, "line_th": th, "num_hypotheses": 256, "lo_iters": 4, "seed": 3}
    ref = jax_load_estimator("homography", "hybrid_ransac")(conf)(
        {k: jnp.asarray(v) for k, v in data.items()})
    vlines = data.get("valid_lines", np.zeros(1, bool))
    idx = _jax_sample_idx(data["valid"], vlines, conf["seed"], conf["num_hypotheses"])
    est = load_estimator("homography", "hybrid_ransac")(conf)
    ours = est({**{k: torch.from_numpy(v) for k, v in data.items()},
                "sample_idx": torch.from_numpy(idx)})
    assert ours["success"] == ref["success"] is True
    err = homography_corner_error(ours["M_0to1"][None], torch.from_numpy(
        np.asarray(ref["M_0to1"]))[None], torch.from_numpy(SIZE)[None])
    assert float(err[0]) < H_PX
    np.testing.assert_array_equal(ours["inliers"].numpy(), np.asarray(ref["inliers"]))
    np.testing.assert_array_equal(ours["line_inliers"].numpy(), np.asarray(ref["line_inliers"]))
    if case != "points_only":
        assert ours["line_inliers"].sum() > 10
    if case != "lines_only":
        assert ours["inliers"].sum() > 40


def test_without_enough_correspondences_fails_as_jax():
    data = _scene(1, n_pts=3, n_lines=2)
    data["valid_lines"][:] = False
    conf = {"num_hypotheses": 32}
    ref = jax_load_estimator("homography", "hybrid_ransac")(conf)(
        {k: jnp.asarray(v) for k, v in data.items()})
    ours = load_estimator("homography", "hybrid_ransac")(conf)(
        {k: torch.from_numpy(v) for k, v in data.items()})
    assert ours["success"] == ref["success"] is False


def test_building_blocks_are_jaxs():
    data = _scene(2)
    segs0, segs1 = data["m_lines0"], data["m_lines1"]
    l1 = HR.line_coeffs(torch.from_numpy(segs1))
    np.testing.assert_allclose(l1.numpy(), np.asarray(JHR.line_coeffs(jnp.asarray(segs1))),
                               atol=BLOCK_TOL, rtol=BLOCK_TOL)
    rng = np.random.default_rng(0)
    H = (np.eye(3) + rng.normal(0, 0.01, (5, 3, 3))).astype(np.float32)
    res = HR.point_on_line_residual(torch.from_numpy(segs0)[None], l1[None], torch.from_numpy(H))
    ref = JHR.point_on_line_residual(jnp.asarray(segs0)[None], jnp.asarray(l1.numpy())[None],
                                     jnp.asarray(H))
    np.testing.assert_allclose(res.numpy(), np.asarray(ref), atol=1e-3, rtol=BLOCK_TOL)
    wp = (rng.uniform(size=(4, 120)) > 0.3).astype(np.float32)
    wl = (rng.uniform(size=(4, 40)) > 0.5).astype(np.float32)
    args = (data["m_kpts0"], data["m_kpts1"], wp, segs0, segs1, l1.numpy(), wl)
    shapes = ((120, 2), (120, 2), None, (40, 2, 2), (40, 2, 2), (40, 3), None)
    full = [a if s is None else np.broadcast_to(a, (4, *s)).copy() for a, s in zip(args, shapes)]
    ours = HR.joint_dlt(*map(torch.from_numpy, full))
    ref = JHR.joint_dlt(*map(jnp.asarray, full))
    err = homography_corner_error(ours, torch.from_numpy(np.asarray(ref)),
                                  torch.from_numpy(SIZE).expand(4, 2))
    assert float(err.max()) < H_PX
