"""Depth ground truth (gluefactory_torch/geometry/depth.py,
gt_generation.gt_matches_from_pose_depth, matchers.depth_matcher and
matchers.oracle_matcher) against the JAX package on seeded planar scenes,
and against the plane homography's ground truth."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gluefactory_torch.geometry import depth as D
from gluefactory_torch.geometry.gt_generation import (
    gt_matches_from_homography,
    gt_matches_from_pose_depth,
)
from gluefactory_torch.geometry.wrappers import Camera, Pose
from gluefactory_torch.models import build_model
from gluefactory_tpu.geometry import depth as JD
from gluefactory_tpu.geometry.gt_generation import gt_matches_from_pose_depth as jax_gt
from gluefactory_tpu.geometry.wrappers import Camera as JCamera
from gluefactory_tpu.geometry.wrappers import Pose as JPose
from gluefactory_tpu.models import build_model as jax_build_model

torch.set_num_threads(2)

PX = 1e-4  # reprojections, port against JAX (float32 pixels of a 160x120 view)


def _rotation(rng, deg):
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    a = np.deg2rad(deg)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(a) * K + (1 - np.cos(a)) * K @ K


def planar_scene(seed: int, b: int = 2, size=(160, 120), n: int = 150, holes: bool = True):
    """Two views of one slanted plane per batch item: depth maps of both
    (with holes of no depth), cameras, the pose, keypoints of view 0 and
    their true partners in view 1 (with noise and outliers, shuffled), and
    the plane's homography. Numpy, float32."""
    rng = np.random.default_rng(seed)
    w, h = size
    f, c = 0.9 * w, np.array([w / 2.0, h / 2.0])
    K = np.array([[f, 0, c[0]], [0, f, c[1]], [0, 0, 1.0]])
    out = {k: [] for k in ("depth0", "depth1", "R", "t", "kp0", "kp1", "H")}
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    for _ in range(b):
        nrm = np.array([*rng.uniform(-0.3, 0.3, 2), 1.0])
        nrm /= np.linalg.norm(nrm)
        d = rng.uniform(4.0, 6.0)
        R = _rotation(rng, rng.uniform(3, 8))
        t = rng.normal(size=3)
        t = t / np.linalg.norm(t) * 0.4
        n1, d1 = R @ nrm, d + (R @ nrm) @ t

        def depth_map(nv, dv):
            rays = np.stack([(xs - c[0]) / f, (ys - c[1]) / f, np.ones_like(xs)], -1)
            z = dv / (rays @ nv)
            if holes:
                z[rng.uniform(size=z.shape) < 0.03] = 0.0  # scattered missing depth
                y0, x0 = rng.integers(0, h - 20), rng.integers(0, w - 20)
                z[y0:y0 + 15, x0:x0 + 15] = 0.0
            return z

        Hm = K @ (R + np.outer(t, nrm) / d) @ np.linalg.inv(K)
        kp0 = rng.uniform([2, 2], [w - 3, h - 3], (n, 2))
        hp = np.c_[kp0, np.ones(n)] @ Hm.T
        kp1 = hp[:, :2] / hp[:, 2:] + rng.normal(0, 0.4, (n, 2))
        bad = rng.uniform(size=n) < 0.2
        kp1[bad] = rng.uniform([0, 0], [w, h], (bad.sum(), 2))
        kp1 = kp1[rng.permutation(n)]
        for k, v in zip(out, (depth_map(nrm, d), depth_map(n1, d1), R, t, kp0, kp1, Hm)):
            out[k].append(v)
    out = {k: np.stack(v).astype(np.float32) for k, v in out.items()}
    out["size"] = np.broadcast_to(np.array(size, np.float32), (b, 2)).copy()
    out["f"] = np.full((b, 2), f, np.float32)
    out["c"] = np.broadcast_to(c.astype(np.float32), (b, 2)).copy()
    out["valid0"] = rng.uniform(size=(b, n)) < 0.95
    out["valid1"] = rng.uniform(size=(b, n)) < 0.95
    return out


def _port(s, device="cpu"):
    t = {k: torch.from_numpy(v).to(device) for k, v in s.items()}
    cam = Camera.from_fc(t["size"], t["f"], t["c"])
    return t, cam, cam, Pose.from_Rt(t["R"], t["t"])


def _jax(s):
    t = {k: jnp.asarray(v) for k, v in s.items()}
    cam = JCamera.from_fc(t["size"], t["f"], t["c"])
    return t, cam, cam, JPose.from_Rt(t["R"], t["t"])


def test_sample_depth_matches_jax():
    s = planar_scene(0)
    rng = np.random.default_rng(1)
    pts = rng.uniform(-3, [163, 123], (2, 400, 2)).astype(np.float32)  # some outside
    pts[:, :4] = [[0, 0], [159, 119], [159, 0], [0, 119]]  # the corners exactly
    d, v = D.sample_depth(torch.from_numpy(pts), torch.from_numpy(s["depth0"]))
    jd, jv = JD.sample_depth(jnp.asarray(pts), jnp.asarray(s["depth0"]))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-6, atol=1e-6)
    assert 0.8 < v.numpy().mean() < 0.99


@pytest.mark.parametrize("ccth", [None, 0.05])
def test_project_matches_jax(ccth):
    s = planar_scene(2)
    t, c0, c1, T = _port(s)
    jt, jc0, jc1, jT = _jax(s)
    d0, v0 = D.sample_depth(t["kp0"], t["depth0"])
    jd0, jv0 = JD.sample_depth(jt["kp0"], jt["depth0"])
    p, v = D.project(t["kp0"], d0, t["depth1"], c0, c1, T, v0, ccth)
    jp, jv = JD.project(jt["kp0"], jd0, jt["depth1"], jc0, jc1, jT, jv0, ccth)
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_allclose(p.numpy()[v.numpy()], np.asarray(jp)[v.numpy()], atol=PX)
    # on the plane the reprojection is the homography's, but for the
    # bilinear interpolation of depth (1/z is linear in the pixels, z is not)
    hp = np.c_[s["kp0"][0], np.ones(len(s["kp0"][0]))] @ s["H"][0].T
    np.testing.assert_allclose(p.numpy()[0][v.numpy()[0]],
                               (hp[:, :2] / hp[:, 2:])[v.numpy()[0]], atol=0.02)


def test_dense_warp_consistency_matches_jax():
    s = planar_scene(3, size=(40, 30))
    t, c0, c1, T = _port(s)
    jt, jc0, jc1, jT = _jax(s)
    w, v = D.dense_warp_consistency(t["depth0"], t["depth1"], T, c0, c1)
    jw, jv = JD.dense_warp_consistency(jt["depth0"], jt["depth1"], jT, jc0, jc1)
    assert w.shape == (2, 30, 40, 2) and v.shape == (2, 30, 40)
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_allclose(w.numpy()[v.numpy()], np.asarray(jw)[v.numpy()], atol=PX)
    assert v.numpy().mean() > 0.5


def _gt_both(s, **kw):
    t, c0, c1, T = _port(s)
    jt, jc0, jc1, jT = _jax(s)
    out = gt_matches_from_pose_depth(t["kp0"], t["kp1"], t["depth0"], t["depth1"], c0, c1, T,
                                     valid0=t["valid0"], valid1=t["valid1"], **kw)
    ref = jax_gt(jt["kp0"], jt["kp1"], jt["depth0"], jt["depth1"], jc0, jc1, jT,
                 valid0=jt["valid0"], valid1=jt["valid1"], **kw)
    return out, ref


@pytest.mark.parametrize("seed,kw", [(4, {}), (5, {"pos_th": 2.0, "neg_th": 4.0, "ccth": 0.02})])
def test_gt_matches_from_pose_depth_matches_jax(seed, kw):
    out, ref = _gt_both(planar_scene(seed), **kw)
    for key in ("matches0", "matches1", "visible0", "visible1", "assignment"):
        np.testing.assert_array_equal(out[key].numpy(), np.asarray(ref[key]), err_msg=key)
    for key in ("reproj_0to1", "reproj_1to0"):
        vis = out["visible" + key[-4]].numpy()
        np.testing.assert_allclose(out[key].numpy()[vis], np.asarray(ref[key])[vis], atol=PX)
    m0 = out["matches0"].numpy()
    assert (m0 >= 0).sum() > 150 and (m0 == -1).sum() > 20 and (m0 == -2).sum() > 5


def test_depth_ground_truth_agrees_with_the_plane_homography():
    """On one plane without holes, depth and pose give the homography's
    positives: the same matches0 on every slot that either calls positive
    and whose reprojection lands in view 1 (the homography's ground truth
    does not see view 1's border, where depth's ignores)."""
    s = planar_scene(6, holes=False)
    t, c0, c1, T = _port(s)
    kw = dict(valid0=t["valid0"], valid1=t["valid1"], pos_th=3.0, neg_th=5.0)
    dep = gt_matches_from_pose_depth(t["kp0"], t["kp1"], t["depth0"], t["depth1"], c0, c1, T,
                                     **kw)
    hom = gt_matches_from_homography(t["kp0"], t["kp1"], t["H"], **kw)
    m_d, m_h = dep["matches0"].numpy(), hom["matches0"].numpy()
    pos = ((m_d >= 0) | (m_h >= 0)) & dep["visible0"].numpy()
    assert pos.sum() > 150
    assert (m_d[pos] == m_h[pos]).mean() > 0.99, (m_d[pos] != m_h[pos]).sum()
    np.testing.assert_allclose(dep["reproj_0to1"].numpy()[dep["visible0"].numpy()],
                               hom["reproj_0to1"].numpy()[dep["visible0"].numpy()], atol=0.02)


def _pipeline_data(s, framework):
    t, c0, c1, T = (_port if framework == "torch" else _jax)(s)
    return {"keypoints0": t["kp0"], "keypoints1": t["kp1"], "keypoint_valid0": t["valid0"],
            "keypoint_valid1": t["valid1"], "T_0to1": T, "H_0to1": t["H"],
            "view0": {"depth": t["depth0"], "camera": c0},
            "view1": {"depth": t["depth1"], "camera": c1}}


@pytest.mark.parametrize("name,conf", [
    ("matchers.depth_matcher", {}),
    ("matchers.depth_matcher", {"th_positive": 2.0, "th_negative": 6.0, "th_epi": 5.0}),
    ("matchers.oracle_matcher", {"source": "depth"}),
    ("matchers.oracle_matcher", {"source": "homography", "th_positive": 2.0}),
])
def test_ground_truth_matchers_match_jax(name, conf):
    s = planar_scene(7)
    pred = build_model(name, conf, device="cpu")(_pipeline_data(s, "torch"))
    jdata = _pipeline_data(s, "jax")
    jmodel = jax_build_model(name, conf)
    ref = jax.jit(jmodel.apply)(jax.jit(jmodel.init)(jax.random.key(0), jdata), jdata)
    assert set(pred) == set(ref)
    for key, value in ref.items():
        value = np.asarray(value)
        if value.dtype.kind == "f" and "reproj" in key:
            vis = pred[key.replace("reproj_0to1", "visible0").replace("reproj_1to0",
                                                                     "visible1")].numpy()
            np.testing.assert_allclose(pred[key].numpy()[vis], value[vis], atol=PX, err_msg=key)
        else:
            np.testing.assert_array_equal(pred[key].numpy(), value, err_msg=key)
