"""The port's relative-pose geometry (gluefactory_torch.geometry.{wrappers,
epipolar,essential}), its LO-RANSAC (robust_estimators/relative_pose) and
SuperPoint's softargmax readout against the JAX package, on the CPU, with
the same numpy inputs; then the JAX relative-pose gate's counterpart."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gluefactory_tpu.geometry import epipolar as JEp
from gluefactory_tpu.geometry import essential as JE
from gluefactory_tpu.geometry.wrappers import Camera as JCamera
from gluefactory_tpu.geometry.wrappers import Pose as JPose
from gluefactory_tpu.models import build_model as jax_build_model
from gluefactory_tpu.ops.nms import soft_argmax_refinement as jax_soft_argmax
from gluefactory_tpu.robust_estimators.relative_pose.ransac import ransac_essential as jax_ransac
from gluefactory_tpu.utils.experiments import restore_from_flat_dict
from gluefactory_torch.datasets.homographies import generate_structured_image
from gluefactory_torch.geometry import epipolar as Ep
from gluefactory_torch.geometry import essential as E
from gluefactory_torch.geometry.wrappers import Camera, Pose
from gluefactory_torch.models import build_model
from gluefactory_torch.ops.nms import soft_argmax_refinement
from gluefactory_torch.robust_estimators import load_estimator
from gluefactory_torch.robust_estimators.relative_pose.ransac import ransac_essential
from gluefactory_torch.scripts.generate_pose_eval_set import render_pose_scene
from gluefactory_torch.utils.image import read_image
from gluefactory_torch.utils.weights import (
    load_state_strict,
    load_weight_blob,
    params_from_flat,
)
from test_trained_quality import LG_BLOB, SP0B_BLOB

torch.set_num_threads(2)


def _rotation(rng, max_deg):
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    ang = np.deg2rad(rng.uniform(0.3 * max_deg, max_deg))
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(ang) * K + (1 - np.cos(ang)) * K @ K


def _two_view(rng, n, noise=0.0, outliers=0.0):
    """Normalized correspondences (n, 2) x2 of points 4-8 units in front of
    camera 0, the pose (R, t) with |t| = 1, and the outlier mask."""
    X = np.c_[rng.uniform(-2, 2, (n, 2)), rng.uniform(4, 8, n)]
    R, t = _rotation(rng, 10.0), rng.normal(size=3)
    t /= np.linalg.norm(t)
    X1 = X @ R.T + t
    x0 = X[:, :2] / X[:, 2:] + rng.normal(0, noise, (n, 2))
    x1 = X1[:, :2] / X1[:, 2:] + rng.normal(0, noise, (n, 2))
    out = rng.uniform(size=n) < outliers
    x1[out] = rng.uniform(-0.6, 0.6, (out.sum(), 2))
    return x0.astype(np.float32), x1.astype(np.float32), R, t, out


def _up_to_sign(a, b):
    """max |a - b| with b's sign chosen, a and b normalized."""
    a, b = a / np.linalg.norm(a), b / np.linalg.norm(b)
    return min(np.abs(a - b).max(), np.abs(a + b).max())


def _t(x):
    return torch.from_numpy(np.array(x))


def _rot_deg(Ra, Rb):
    """Angle (degrees) between two rotations, from their chord in float64
    (arccos near 1 resolves only ~0.02 degrees in float32)."""
    chord = np.linalg.norm(np.asarray(Ra, np.float64) - np.asarray(Rb, np.float64))
    return np.degrees(2 * np.arcsin(min(1.0, chord / (2 * np.sqrt(2)))))


def _dir_deg(a, b):
    """Angle (degrees) between two directions, from their chord in float64."""
    a, b = (np.asarray(v, np.float64) / np.linalg.norm(np.asarray(v, np.float64))
            for v in (a, b))
    return np.degrees(2 * np.arcsin(min(1.0, np.linalg.norm(a - b) / 2)))


# --- Camera, Pose, epipolar geometry ------------------------------------------------


def _cameras(rng, b=3):
    K = np.zeros((b, 3, 3), np.float32)
    K[:, 0, 0], K[:, 1, 1] = rng.uniform(300, 700, b), rng.uniform(300, 700, b)
    K[:, 0, 2], K[:, 1, 2], K[:, 2, 2] = rng.uniform(200, 400, b), rng.uniform(150, 300, b), 1
    return K, rng.uniform(400, 800, (b, 2)).astype(np.float32)


def test_camera_and_pose_match_jax():
    """image2cam after a 2.5x scale (the pose set's cameras), to 1e-6; the
    pose's inverse, composition and transform to 1e-6."""
    rng = np.random.default_rng(0)
    K, size = _cameras(rng)
    pts = rng.uniform(0, 1600, (3, 50, 2)).astype(np.float32)
    scales = np.array([2.5, 2.5], np.float32)
    cam = Camera.from_calibration_matrix(K, size=size).scale(scales)
    jcam = JCamera.from_calibration_matrix(jnp.asarray(K), size=jnp.asarray(size)).scale(
        jnp.asarray(scales))
    np.testing.assert_allclose(cam.image2cam(_t(pts)).numpy(),
                               np.asarray(jcam.image2cam(jnp.asarray(pts))), atol=1e-6)
    np.testing.assert_allclose(cam.calibration_matrix().numpy(),
                               np.asarray(jcam.calibration_matrix()), atol=1e-6)
    T = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    for i in range(3):
        T[i, :3, :3], T[i, :3, 3] = _rotation(rng, 30.0), rng.normal(size=3)
    pose, jpose = Pose.from_4x4mat(T), JPose.from_4x4mat(jnp.asarray(T))
    p3d = rng.normal(size=(3, 20, 3)).astype(np.float32)
    other, jother = pose.inv(), jpose.inv()
    shifted = Pose.from_4x4mat(T[[1, 2, 0]]).inv()
    jshifted = JPose.from_4x4mat(jnp.asarray(T[[1, 2, 0]])).inv()
    for ours, theirs in ((other.R, jother.R), (other.t, jother.t),
                         (pose.compose(shifted).R, jpose.compose(jshifted).R),
                         (pose.compose(shifted).t, jpose.compose(jshifted).t),
                         (pose.transform(_t(p3d)), jpose.transform(jnp.asarray(p3d)))):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=1e-6)


def test_geometry_utils_match_jax():
    """The cross-product matrix, the SO(3) exponential and logarithm, and
    Brown distortion with its Jacobian (2 and 4 coefficients), to 1e-6."""
    from gluefactory_tpu.geometry import utils as JU
    from gluefactory_torch.geometry import utils as U

    rng = np.random.default_rng(8)
    w = np.concatenate([rng.normal(0, 1, (6, 3)), np.zeros((1, 3)), 1e-9 * np.ones((1, 3))])
    w = w.astype(np.float32)
    for ours, theirs in ((U.skew_symmetric, JU.skew_symmetric), (U.so3exp_map, JU.so3exp_map)):
        np.testing.assert_allclose(ours(_t(w)).numpy(), np.asarray(theirs(jnp.asarray(w))),
                                   atol=1e-6)
    R = U.so3exp_map(_t(w[:6]))
    np.testing.assert_allclose(U.so3log_map(R).numpy(),
                               np.asarray(JU.so3log_map(jnp.asarray(R.numpy()))), atol=1e-5)
    np.testing.assert_allclose(U.so3log_map(R).numpy(), w[:6], atol=1e-4)
    pts = rng.uniform(-0.8, 0.8, (2, 30, 2)).astype(np.float32)
    for n in (2, 4):
        dist = rng.normal(0, 0.05, (2, n)).astype(np.float32)
        for ours, theirs in ((U.distort_points, JU.distort_points),
                             (U.J_distort_points, JU.J_distort_points)):
            np.testing.assert_allclose(ours(_t(pts), _t(dist)).numpy(),
                                       np.asarray(theirs(jnp.asarray(pts), jnp.asarray(dist))),
                                       atol=1e-6)


def test_epipolar_distance_and_pose_error_match_jax():
    """generalized_epi_dist and relative_pose_error against JAX, to 1e-5:
    the distance in normalized units (what the benchmark reads) in float32,
    in pixels through F in float64 (its float32 products cancel to ~3e-3
    relative in either package)."""
    rng = np.random.default_rng(1)
    K, size = _cameras(rng, 1)
    x0, x1, R, t, _ = _two_view(rng, 64, noise=2e-3, outliers=0.2)
    k0 = (x0 * K[0, [0, 1], [0, 1]] + K[0, :2, 2]).astype(np.float32)
    k1 = (x1 * K[0, [0, 1], [0, 1]] + K[0, :2, 2]).astype(np.float32)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3], T[:3, 3] = R, t
    cam, jcam = Camera.from_calibration_matrix(K[0]), JCamera.from_calibration_matrix(
        jnp.asarray(K[0]))
    pose, jpose = Pose.from_4x4mat(T), JPose.from_4x4mat(jnp.asarray(T))
    ours = Ep.generalized_epi_dist(_t(k0)[None], _t(k1)[None], cam, cam, pose)
    theirs = JEp.generalized_epi_dist(jnp.asarray(k0)[None], jnp.asarray(k1)[None], jcam,
                                      jcam, jpose)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=1e-5, atol=1e-5)
    with jax.enable_x64(True):
        f64 = [np.float64(x) for x in (K[0], k0, k1, T)]
        ours = Ep.generalized_epi_dist(
            _t(f64[1])[None], _t(f64[2])[None], Camera.from_calibration_matrix(_t(f64[0])),
            Camera.from_calibration_matrix(_t(f64[0])), Pose.from_4x4mat(_t(f64[3])),
            essential=False)
        jcam64 = JCamera.from_calibration_matrix(jnp.asarray(f64[0]))
        theirs = JEp.generalized_epi_dist(jnp.asarray(f64[1])[None], jnp.asarray(f64[2])[None],
                                          jcam64, jcam64, JPose.from_4x4mat(jnp.asarray(f64[3])),
                                          essential=False)
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=1e-5, atol=1e-5)
    # in float64: arccos resolves only ~1e-4 degrees near 1 in float32
    R_est = np.stack([_rotation(rng, 5.0) @ R for _ in range(8)])
    t_est = t + rng.normal(0, 0.1, (8, 3))
    t_est[::2] *= -1  # the error takes the smaller of the two signs
    R8, t8 = np.tile(R, (8, 1, 1)), np.tile(t, (8, 1))
    ours = Ep.relative_pose_error(Pose.from_Rt(_t(R8), _t(t8)), _t(R_est), _t(t_est))
    with jax.enable_x64(True):
        theirs = JEp.relative_pose_error(JPose.from_Rt(jnp.asarray(R8), jnp.asarray(t8)),
                                         jnp.asarray(R_est), jnp.asarray(t_est))
        for o, j in zip(ours, theirs):
            np.testing.assert_allclose(o.numpy(), np.asarray(j), atol=1e-5)
    assert float(ours[1].max()) < 90.0


# --- the solvers ------------------------------------------------------------------


def test_eight_point_sampson_and_cheirality_match_jax():
    """The weighted 8-point E (up to scale and sign) to 1e-4, the Sampson
    distance to 1e-6 relative, and the cheirality vote's (R, t) to 1e-4."""
    rng = np.random.default_rng(2)
    x0, x1, R, t, _ = _two_view(rng, 100, noise=1e-3)
    w = rng.uniform(0.2, 1.0, 100).astype(np.float32)
    E8 = E.eight_point_essential(_t(x0), _t(x1), _t(w)).numpy()
    jE8 = np.asarray(JE.eight_point_essential(jnp.asarray(x0), jnp.asarray(x1), jnp.asarray(w)))
    assert _up_to_sign(E8, jE8) < 1e-4
    d = E.sampson_distance(_t(x0), _t(x1), _t(jE8)).numpy()
    jd = np.asarray(JE.sampson_distance(jnp.asarray(x0), jnp.asarray(x1), jnp.asarray(jE8)))
    np.testing.assert_allclose(d, jd, rtol=1e-5, atol=1e-12)
    valid = rng.uniform(size=100) > 0.1
    R_, t_ = E.recover_pose_from_essential(_t(jE8), _t(x0), _t(x1), _t(valid))
    jR, jt = JE.recover_pose_from_essential(jnp.asarray(jE8), jnp.asarray(x0),
                                            jnp.asarray(x1), jnp.asarray(valid))
    np.testing.assert_allclose(R_.numpy(), np.asarray(jR), atol=1e-4)
    np.testing.assert_allclose(t_.numpy(), np.asarray(jt), atol=1e-4)
    np.testing.assert_allclose(R_.numpy(), R, atol=2e-2)  # and the right one


def test_five_point_matches_jax():
    """64 seeded minimal sets. The null space of the 5x9 system is
    4-dimensional and each SVD returns another basis of it, and the
    resultant's brackets and spurious roots depend on the basis; so on JAX's
    basis, in float64, the port finds as many valid candidates as JAX, each
    JAX candidate matched up to scale and sign to 1e-4. In float32, each on
    its own basis (the port's canonical one), the port finds the true E (to
    1e-2) in no fewer sets than JAX, give or take 2 (61 and 57 of 64 here;
    the solver's float32 accuracy is ~1e-3 and a missed bracket moves a
    set)."""
    rng = np.random.default_rng(3)
    sets = [_two_view(rng, 5) for _ in range(64)]
    x0 = np.stack([s[0] for s in sets]).astype(np.float64)
    x1 = np.stack([s[1] for s in sets]).astype(np.float64)
    with jax.enable_x64(True):
        jE5, jvalid = JE.five_point_essential(jnp.asarray(x0), jnp.asarray(x1))
        a = (np.concatenate([x1, np.ones((64, 5, 1))], -1)[..., :, None]
             * np.concatenate([x0, np.ones((64, 5, 1))], -1)[..., None, :]).reshape(64, 5, 9)
        basis = np.asarray(jnp.linalg.svd(jnp.asarray(a), full_matrices=True)[2])[:, 5:]
    jE5, jvalid = np.asarray(jE5), np.asarray(jvalid)
    E5, valid = E.essentials_from_basis(_t(basis.reshape(64, 4, 3, 3).copy()))
    E5, valid = E5.numpy(), valid.numpy()
    np.testing.assert_array_equal(valid.sum(-1), jvalid.sum(-1))
    assert valid.sum() >= 128
    for i in range(64):
        for cand in jE5[i][jvalid[i]]:
            assert min(_up_to_sign(cand, c) for c in E5[i][valid[i]]) < 1e-4, i

    E5, valid = E.five_point_essential(_t(x0.astype(np.float32)), _t(x1.astype(np.float32)))
    jE5, jvalid = JE.five_point_essential(jnp.asarray(x0, jnp.float32),
                                          jnp.asarray(x1, jnp.float32))
    found = jfound = 0
    for i, (_, _, R, t, _) in enumerate(sets):
        gt = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]]) @ R
        found += min([_up_to_sign(gt, c) for c in E5[i][valid[i]].numpy()] + [1.0]) < 1e-2
        jfound += min([_up_to_sign(gt, c) for c in np.asarray(jE5[i])[np.asarray(jvalid[i])]]
                      + [1.0]) < 1e-2
    assert found >= jfound - 2 and found >= 54, (found, jfound)


def test_refine_pose_sampson_matches_jax():
    """8 Gauss-Newton steps from a perturbed pose: the same pose as JAX to
    1e-4 degrees, and closer to the truth than the start."""
    rng = np.random.default_rng(4)
    x0, x1, R, t, out = _two_view(rng, 200, noise=1e-3, outliers=0.2)
    w = np.where(out, 0.0, rng.uniform(0.5, 1.0, 200)).astype(np.float32)
    R0 = (_rotation(rng, 2.0) @ R).astype(np.float32)
    t0 = t + rng.normal(0, 0.05, 3)
    t0 = (t0 / np.linalg.norm(t0)).astype(np.float32)
    Rr, tr = E.refine_pose_sampson(_t(R0), _t(t0), _t(x0), _t(x1), _t(w))
    jR, jt = JE.refine_pose_sampson(jnp.asarray(R0), jnp.asarray(t0), jnp.asarray(x0),
                                    jnp.asarray(x1), jnp.asarray(w))
    assert _rot_deg(Rr, jR) < 1e-4 and _dir_deg(tr, jt) < 1e-4
    assert _rot_deg(Rr, R) < _rot_deg(R0, R)


def _jax_sample_idx(valid, seed, num_hypotheses, n_min=5):
    """The minimal sets that JAX's ransac_essential draws for ``seed``."""
    logits = jnp.where(jnp.asarray(valid), 0.0, -1e9)
    keys = jax.random.split(jax.random.key(seed), num_hypotheses)
    return np.asarray(jax.vmap(
        lambda k: jax.random.categorical(k, logits, shape=(n_min,)))(keys))


def test_ransac_essential_matches_jax():
    """LO-RANSAC on 300 correspondences with 30% outliers, fed JAX's minimal
    sets: R and t within 1e-2 degrees of JAX's, and the same inliers except
    where the Sampson error lies within 1e-3 (relative) of the threshold."""
    rng = np.random.default_rng(5)
    x0, x1, R, t, out = _two_view(rng, 300, noise=1e-3, outliers=0.3)
    valid = rng.uniform(size=300) > 0.05
    r0 = np.c_[x0, np.ones(300)].astype(np.float32)
    r1 = np.c_[x1, np.ones(300)].astype(np.float32)
    th = 2.0 / 500.0
    idx = _jax_sample_idx(valid, 0, 256)
    jE_, jR, jt, jinl, _ = jax_ransac(jnp.asarray(r0), jnp.asarray(r1), jnp.asarray(valid),
                                      jax.random.key(0), th=th, num_hypotheses=256, lo_iters=6)
    E_, R_, t_, inl, _ = ransac_essential(_t(r0), _t(r1), _t(valid), th=th, num_hypotheses=256,
                                          lo_iters=6, sample_idx=_t(idx))
    assert _rot_deg(R_, jR) < 1e-2 and _dir_deg(t_, jt) < 1e-2
    assert _rot_deg(R_, R) < 1.0
    err = E.sampson_distance(_t(r0), _t(r1), E_).numpy()
    near = np.abs(err / th**2 - 1.0) < 1e-3
    differ = inl.numpy() != np.asarray(jinl)
    assert not (differ & ~near).any()
    assert inl.sum() > 150


def test_relative_pose_estimator_draws_and_device():
    """The estimator: pixel threshold over the mean focal length, success at
    8 inliers, its own seeded draws recover the pose, and a fixed
    ``sample_idx`` gives the same result twice."""
    rng = np.random.default_rng(6)
    x0, x1, R, t, _ = _two_view(rng, 200, noise=5e-4, outliers=0.25)
    K = np.array([[500, 0, 320], [0, 500, 240], [0, 0, 1]], np.float32)
    cam = Camera.from_calibration_matrix(K)
    k0, k1 = (_t(x * 500 + K[:2, 2]) for x in (x0, x1))
    est = load_estimator("relative_pose", "ransac")({"ransac_th": 1.0, "num_hypotheses": 128})
    out = est({"m_kpts0": k0, "m_kpts1": k1, "camera0": cam, "camera1": cam})
    r_err, t_err = Ep.relative_pose_error(Pose.from_Rt(R.astype(np.float32),
                                                       t.astype(np.float32)),
                                          out["M_0to1"].R, out["M_0to1"].t)
    assert out["success"] and max(float(r_err), float(t_err)) < 1.0
    idx = _t(rng.integers(0, 200, (64, 5)))
    a = est({"m_kpts0": k0, "m_kpts1": k1, "camera0": cam, "camera1": cam, "sample_idx": idx})
    b = est({"m_kpts0": k0, "m_kpts1": k1, "camera0": cam, "camera1": cam, "sample_idx": idx})
    assert torch.equal(a["M_0to1"].R, b["M_0to1"].R) and torch.equal(a["inliers"], b["inliers"])
    few = est({"m_kpts0": k0[:6], "m_kpts1": k1[:6], "camera0": cam, "camera1": cam})
    assert not few["success"]


# --- SuperPoint's softargmax readout, and the JAX relative-pose gate ------------------


def test_soft_argmax_readout_matches_jax():
    """The softargmax readout at radius 2, alone and inside SuperPoint with
    the stage-0b weights on a rendered scene, against JAX to 1e-4 px."""
    rng = np.random.default_rng(7)
    heat = rng.uniform(0, 1, (2, 40, 50)).astype(np.float32)
    kpts = np.stack([rng.integers(0, 50, (2, 30)), rng.integers(0, 40, (2, 30))],
                    -1).astype(np.float32)
    np.testing.assert_allclose(
        soft_argmax_refinement(_t(kpts), _t(heat), 2).numpy(),
        np.asarray(jax_soft_argmax(jnp.asarray(kpts), jnp.asarray(heat), 2)), atol=1e-4)

    conf = {"name": "extractors.superpoint", "max_num_keypoints": 256,
            "detection_threshold": 0.005, "refinement_radius": 2}  # the default softargmax
    img = generate_structured_image(rng, (160, 120))[None].astype(np.float32)
    flat, _, _ = load_weight_blob(SP0B_BLOB)
    model = build_model("extractors.superpoint", conf, device="cpu")
    load_state_strict(model, {k.removeprefix("extractor."): v
                              for k, v in params_from_flat(flat).items()})
    jmodel = jax_build_model("extractors.superpoint", conf)
    jdata = {"image": jnp.asarray(img)}
    params = restore_from_flat_dict(jax.eval_shape(jmodel.init, jax.random.key(0), jdata),
                                    flat)  # the blob holds every parameter
    jpred = jax.jit(jmodel.apply)(params, jdata)
    with torch.inference_mode():
        pred = model({"image": _t(img)})
    np.testing.assert_array_equal(pred["keypoint_valid"].numpy(),
                                  np.asarray(jpred["keypoint_valid"]))
    assert pred["keypoint_valid"].sum() > 50
    np.testing.assert_allclose(pred["keypoints"].numpy(), np.asarray(jpred["keypoints"]),
                               atol=1e-4)


def test_trained_relative_pose_quality(tmp_path):
    """The port's counterpart of the JAX gate
    tests/test_trained_quality.py::test_trained_relative_pose_quality: the
    stage-0b SuperPoint blob, then the stage-1 LightGlue blob (which holds
    an extractor too, so it replaces the first, as JAX's restore does),
    softargmax readout at radius 2, on the 4 pairs of the port's renderer
    at the gate's seeds; 5-point RANSAC (2 px, 512 hypotheses, 4 LO steps);
    the median of max(rotation, translation) error below 15 degrees."""
    lines = []
    for s in range(2):
        lines += render_pose_scene(tmp_path / f"scene{s}", np.random.default_rng((777, s)),
                                   n_pairs=2)
    conf = {"name": "two_view_pipeline",
            "extractor": {"name": "extractors.superpoint", "max_num_keypoints": 512,
                          "detection_threshold": 0.005, "nms_radius": 4,
                          "refinement_radius": 2, "refinement_mode": "softargmax"},
            "matcher": {"name": "matchers.lightglue", "n_layers": 6, "filter_threshold": 0.1,
                        "checkpointed": False, "save_layer_outputs": False}}
    model = build_model("two_view_pipeline", conf, device="cpu")
    sp = params_from_flat(load_weight_blob(SP0B_BLOB)[0])
    assert set(sp) < set(model.state_dict())
    model.load_state_dict(sp, strict=False)
    load_state_strict(model, params_from_flat(load_weight_blob(LG_BLOB)[0], {"matcher": 4}))
    est = load_estimator("relative_pose", "ransac")(
        {"ransac_th": 2.0, "num_hypotheses": 512, "lo_iters": 4})
    errs = []
    for line in lines:
        parts = line.split()
        imgs = [read_image(tmp_path / p).astype(np.float32) / 255.0 for p in parts[:2]]
        K = np.array([float(x) for x in parts[2:11]], np.float32).reshape(3, 3)
        T = np.array([float(x) for x in parts[20:36]], np.float32).reshape(4, 4)
        size = torch.tensor([[imgs[0].shape[1], imgs[0].shape[0]]], dtype=torch.float32)
        with torch.inference_mode():
            pred = model({f"view{i}": {"image": _t(img)[None], "image_size": size}
                          for i, img in enumerate(imgs)})
        m0 = pred["matches0"][0]
        valid = m0 > -1
        cam = Camera.from_calibration_matrix(K, size=size[0])
        out = est({"m_kpts0": pred["keypoints0"][0][valid],
                   "m_kpts1": pred["keypoints1"][0][m0[valid]], "camera0": cam, "camera1": cam})
        r_err, t_err = Ep.relative_pose_error(Pose.from_4x4mat(T), out["M_0to1"].R,
                                              out["M_0to1"].t)
        errs.append(max(float(r_err), float(t_err)))
    assert np.median(errs) < 15.0, errs
