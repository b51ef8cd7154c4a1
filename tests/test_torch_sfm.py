"""The port's SfM back-end (gluefactory_torch.sfm) and trajectory benchmark
(scripts/sfm_trajectory.py) against the JAX package on the CPU, on the same
numpy inputs: the wrappers' tangent-space updates and Jacobians, the
triangulation, the Sim(3) alignment and ATE, one Levenberg-Marquardt step
block by block, a whole bundle adjustment with outliers and the trim, the
pose graph, the tracks, and ``run_sfm`` fed JAX's minimal sets; then the
trajectory benchmark on a rendered 4-view scene, the recipes, and what the
port refuses. The JAX functions are jitted once per module.

Bounds: float32 on both sides, so each quantity is held within a few
hundred float32 roundings of its scale (each test states its own)."""

import functools
import hashlib
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gluefactory_torch.geometry import essential as port_essential
from gluefactory_torch.geometry.wrappers import Camera, Pose
from gluefactory_torch import settings
from gluefactory_torch.recipes import TRAJECTORY_CONFS, trajectory_conf
from gluefactory_torch.settings import ROOT_PATH
from gluefactory_torch.sfm import ba as B
from gluefactory_torch.sfm import pipeline as port_pipeline
from gluefactory_torch.sfm import (
    BAProblem,
    absolute_trajectory_error,
    bundle_adjust,
    bundle_adjust_sharded,
    optimize_pose_graph,
    run_sfm,
    triangulate_linear,
    triangulate_two_view,
    umeyama_alignment,
)
from gluefactory_torch.sfm.alignment import camera_centers
from gluefactory_torch.sfm.pipeline import build_tracks
from gluefactory_tpu.geometry.wrappers import Camera as JCamera
from gluefactory_tpu.geometry.wrappers import Pose as JPose
from gluefactory_tpu.sfm import alignment as JA
from gluefactory_tpu.sfm import ba as JB
from gluefactory_tpu.sfm import pipeline as JP
from gluefactory_tpu.sfm import pose_graph as JG
from gluefactory_tpu.sfm import triangulation as JT

torch.set_num_threads(2)


def _t(x, dtype=None):
    return torch.from_numpy(np.array(x)) if dtype is None else torch.from_numpy(np.array(x, dtype))


def _so3(w):
    """Rodrigues in float64 numpy: (3,) -> (3, 3)."""
    th = np.linalg.norm(w)
    K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]]) / max(th, 1e-12)
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K


def _scene(rng, M=6, P=200, noise_px=0.0, dist=None):
    """Cameras on an arc looking at a point cloud (tests/test_sfm.py's
    scene), in float32 numpy: R (M, 3, 3), t (M, 3), camera fields, points
    (P, 3), and every camera's observation of every point: obs_cam, obs_pt,
    uv (M P, 2) with ``noise_px`` pixels of noise, valid (M P,) where the
    point lies in front and inside the image."""
    f = np.full((M, 2), 500.0)
    c = np.tile([320.0, 240.0], (M, 1))
    size = np.tile([640.0, 480.0], (M, 1))
    dist = np.zeros((M, 4)) if dist is None else np.tile(dist, (M, 1))
    points = rng.uniform(-1, 1, (P, 3)) * np.array([2, 2, 1])
    Rs, ts = [], []
    for a in np.linspace(-0.4, 0.4, M):
        R = _so3(np.array([0.0, a, 0.0]))
        Rs.append(R)
        ts.append(-R @ np.array([4 * np.sin(a), 0.0, -4 * np.cos(a)]) + np.array([0, 0, 5.0]))
    R, t = np.stack(Rs), np.stack(ts)
    p_cam = np.einsum("mij,pj->mpi", R, points) + t[:, None]
    xy = p_cam[..., :2] / p_cam[..., 2:]
    r2 = (xy**2).sum(-1)
    xy = xy * (1 + dist[:, None, 0] * r2 + dist[:, None, 1] * r2**2)[..., None]
    uv = xy * f[:, None] + c[:, None]
    valid = (p_cam[..., 2] > 1e-4) & (uv >= 0).all(-1) & (uv <= size[:, None] - 1).all(-1)
    uv = uv.reshape(M * P, 2) + rng.normal(0, noise_px, (M * P, 2))
    f32 = np.float32
    return {"R": R.astype(f32), "t": t.astype(f32), "f": f.astype(f32), "c": c.astype(f32),
            "size": size.astype(f32), "dist": dist.astype(f32), "points": points.astype(f32),
            "obs_cam": np.repeat(np.arange(M), P).astype(np.int32),
            "obs_pt": np.tile(np.arange(P), M).astype(np.int32),
            "uv": uv.astype(f32), "valid": valid.reshape(M * P)}


def _cams(s):
    return (Camera.from_fc(_t(s["size"]), _t(s["f"]), _t(s["c"]), _t(s["dist"])),
            JCamera.from_fc(jnp.asarray(s["size"]), jnp.asarray(s["f"]), jnp.asarray(s["c"]),
                            jnp.asarray(s["dist"])))


def _perturb(rng, R, t, points, rot=0.01, trans=0.05, pt=0.05, keep=1):
    """Poses moved by a left se(3) step and points by noise, in float32."""
    d = rng.normal(0, 1, (len(R), 6)) * np.r_[[rot] * 3, [trans] * 3]
    d[:keep] = 0
    R2 = np.stack([_so3(w) @ r for w, r in zip(d[:, :3], R)])
    t2 = np.stack([_so3(w) @ x for w, x in zip(d[:, :3], t)]) + d[:, 3:]
    return (R2.astype(np.float32), t2.astype(np.float32),
            (points + rng.normal(0, pt, points.shape)).astype(np.float32))


def _problems(s, R, t, points, uv, fixed):
    """The same BA problem in both packages."""
    cam, jcam = _cams(s)
    port = BAProblem(poses=Pose(_t(R), _t(t)), cameras=cam, points=_t(points),
                     obs_cam=_t(s["obs_cam"]).long(), obs_pt=_t(s["obs_pt"]).long(),
                     obs_uv=_t(uv), obs_valid=_t(s["valid"]), fixed_cams=_t(fixed))
    jax_ = JB.BAProblem(poses=JPose(R=jnp.asarray(R), t=jnp.asarray(t)), cameras=jcam,
                        points=jnp.asarray(points), obs_cam=jnp.asarray(s["obs_cam"]),
                        obs_pt=jnp.asarray(s["obs_pt"]), obs_uv=jnp.asarray(uv),
                        obs_valid=jnp.asarray(s["valid"]), fixed_cams=jnp.asarray(fixed))
    return port, jax_


def _close(port, ref, rtol, what=""):
    """|port - ref| within ``rtol`` of ref's largest magnitude."""
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape, (what, port.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(port.astype(np.float64) - ref).max()) / scale
    assert err <= rtol, (what, err, rtol)
    return err


# --- the wrappers, the triangulation, the alignment --------------------------------------

@jax.jit
def _jax_wrappers(R, t, delta, f, c, size, dist, p3d):
    pose = JPose(R=R, t=t)
    cam = JCamera.from_fc(size, f, c, dist)
    moved = pose.retract_left(delta)
    return {"R": moved.R, "t": moved.t, "local": pose.local(moved),
            "identity": JPose.identity((R.shape[0],)).local(pose),
            "J_project": cam.J_project(p3d), "J_distort": cam.J_distort(p3d[..., :2] / 4.0),
            "J_world2image": cam.J_world2image(p3d)}


def test_wrapper_jacobians_match_jax():
    """``Pose.retract_left``/``local``/``identity`` and ``Camera.J_project``,
    ``J_distort``, ``J_world2image`` under Brown distortion, within 2e-6 of
    each output's largest value."""
    rng = np.random.default_rng(0)
    M, N = 5, 64
    R = np.stack([_so3(rng.normal(0, 0.5, 3)) for _ in range(M)]).astype(np.float32)
    t = rng.normal(size=(M, 3)).astype(np.float32)
    delta = rng.normal(0, 0.1, (M, 6)).astype(np.float32)
    f = rng.uniform(400, 600, (M, 2)).astype(np.float32)
    c = rng.uniform(200, 300, (M, 2)).astype(np.float32)
    size = np.tile([640.0, 480.0], (M, 1)).astype(np.float32)
    dist = rng.normal(0, 0.05, (M, 4)).astype(np.float32)
    p3d = np.c_[rng.uniform(-1, 1, (M * N, 2)), rng.uniform(2, 6, M * N)].reshape(M, N, 3)
    p3d = p3d.astype(np.float32)
    ref = _jax_wrappers(R, t, delta, f, c, size, dist, p3d)
    pose = Pose(_t(R), _t(t))
    cam = Camera.from_fc(_t(size), _t(f), _t(c), _t(dist))
    moved = pose.retract_left(_t(delta))
    port = {"R": moved.R, "t": moved.t, "local": pose.local(moved),
            "identity": Pose.identity((M,)).local(pose),
            "J_project": cam.J_project(_t(p3d)), "J_distort": cam.J_distort(_t(p3d[..., :2] / 4.0)),
            "J_world2image": cam.J_world2image(_t(p3d))}
    for key, value in ref.items():
        _close(port[key], value, 2e-6, key)
    identity = Pose.identity((M,))
    _close(identity.local(identity.retract_left(_t(delta))), delta, 1e-6, "local")
    assert Pose.identity((2, 3)).R.shape == (2, 3, 3, 3)


_jax_triangulate = jax.jit(JT.triangulate_linear)


def test_triangulation_and_alignment_match_jax():
    """The N-view DLT on 4 views x 50 points (some outside an image) within
    1e-5 of JAX's, and exact on noise-free data; the two-view depths; the
    Umeyama alignment and the ATE of a similarity-moved trajectory within
    1e-9 relative of JAX's (both float64 numpy)."""
    rng = np.random.default_rng(1)
    s = _scene(rng, M=4, P=50)
    obs = s["uv"].reshape(4, 50, 2).transpose(1, 0, 2).copy()
    mask = s["valid"].reshape(4, 50).T.copy()
    cam, jcam = _cams(s)
    X = triangulate_linear(Pose(_t(s["R"]), _t(s["t"])), cam, _t(obs), _t(mask))
    jX = _jax_triangulate(JPose(R=jnp.asarray(s["R"]), t=jnp.asarray(s["t"])), jcam,
                          jnp.asarray(obs), jnp.asarray(mask))
    seen = mask.sum(1) >= 2
    _close(X[seen], np.asarray(jX)[seen], 1e-5, "triangulate_linear")
    assert np.median(np.linalg.norm(X.numpy()[seen] - s["points"][seen], axis=-1)) < 1e-3

    x0 =np.c_[rng.uniform(-0.5, 0.5, (30, 2)), np.ones(30)].astype(np.float32)
    Rr, tr = _so3(rng.normal(0, 0.1, 3)).astype(np.float32), np.array([1, 0.1, 0], np.float32)
    X0 = x0 * rng.uniform(3, 6, (30, 1)).astype(np.float32)
    X1 = X0 @ Rr.T + tr
    x1 = (X1 / X1[:, 2:]).astype(np.float32)
    pts, ok = triangulate_two_view(_t(x0), _t(x1), Pose(_t(Rr), _t(tr)))
    jpts, jok = JT.triangulate_two_view(jnp.asarray(x0), jnp.asarray(x1),
                                        JPose(R=jnp.asarray(Rr), t=jnp.asarray(tr)))
    _close(pts, jpts, 1e-5, "triangulate_two_view")
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))

    src = rng.normal(size=(8, 3))
    Rs = _so3(rng.normal(size=3))
    dst = 2.5 * src @ Rs.T + np.array([1.0, -2.0, 0.5]) + rng.normal(0, 0.01, (8, 3))
    for got, ref in zip(umeyama_alignment(src, dst), JA.umeyama_alignment(src, dst)):
        _close(np.asarray(got), np.asarray(ref), 1e-9, "umeyama")
    R_est = np.stack([_so3(rng.normal(0, 0.3, 3)) for _ in range(8)]).astype(np.float32)
    t_est = rng.normal(size=(8, 3)).astype(np.float32)
    R_gt = np.stack([r @ Rs.T for r in R_est]).astype(np.float32)
    t_gt = (2.0 * t_est + rng.normal(0, 0.02, (8, 3))).astype(np.float32)
    port = absolute_trajectory_error(Pose(_t(R_est), _t(t_est)), Pose(_t(R_gt), _t(t_gt)))
    ref = JA.absolute_trajectory_error(JPose(R=jnp.asarray(R_est), t=jnp.asarray(t_est)),
                                       JPose(R=jnp.asarray(R_gt), t=jnp.asarray(t_gt)))
    assert abs(port - ref) <= 1e-6 * ref, (port, ref)
    _close(camera_centers(Pose(_t(R_est), _t(t_est))),
           JA.camera_centers(JPose(R=jnp.asarray(R_est), t=jnp.asarray(t_est))), 1e-6)


# --- bundle adjustment --------------------------------------------------------------------

HUBER, TRIM = 2.0, 15.0


@jax.jit
def _jax_lm_step(problem, lam):
    r, w, J_cam, J_pt, cost = JB._residuals_and_jacobians(problem, problem.poses,
                                                          problem.points, HUBER, TRIM)
    blocks = JB._block_aggregates(problem, r, w, J_cam, J_pt)
    dxc, dxp = JB._schur_solve(problem, *blocks, lam)
    return (r, w, J_cam, J_pt, cost), blocks, (dxc, dxp)


def _outlier_problem(seed=2, M=6, P=200):
    """tests/test_sfm.py's outlier scene: 0.3 px noise, 150 observations
    moved by 30-120 px, poses and points perturbed, cameras 0 and 1 fixed."""
    rng = np.random.default_rng(seed)
    s = _scene(rng, M=M, P=P, noise_px=0.3, dist=np.array([0.02, -0.01, 0.001, 0.0005]))
    uv = s["uv"].copy()
    out = rng.choice(len(uv), 150, replace=False)
    uv[out] += rng.uniform(30, 120, (150, 2)).astype(np.float32)
    R, t, pts = _perturb(rng, s["R"], s["t"], s["points"], 0.005, 0.02, 0.02, keep=2)
    fixed = np.zeros(M, bool)
    fixed[:2] = True
    return s, _problems(s, R, t, pts, uv, fixed)


def test_lm_step_matches_jax():
    """One LM step with Huber 2 px and the trim at 15 px, block by block:
    residuals, Jacobians and the cost within 1e-6 of their largest value;
    the robust weights (2 / |r| past 2 px) within 5e-5 (the residuals of
    ~100 px part by ~3e-5 px, a float32 rounding at 640 px); U, V, bc, bp
    and the (point, camera) blocks within 5e-5; the step (dxc, dxp) within
    1e-3 of its largest component (a 36x36 solve of a system whose
    condition number is ~1e5)."""
    _, (port, jax_) = _outlier_problem()
    lam = 1e-3
    (jr, jw, jJc, jJp, jcost), jblocks, (jdxc, jdxp) = _jax_lm_step(jax_, jnp.asarray(lam))
    r, w, J_cam, J_pt, cost = B._residuals_and_jacobians(port, port.poses, port.points,
                                                          HUBER, TRIM)
    for name, got, ref, tol in (("r", r, jr, 1e-6), ("w", w, jw, 5e-5),
                                ("J_cam", J_cam, jJc, 1e-6), ("J_pt", J_pt, jJp, 1e-6),
                                ("cost", cost, jcost, 1e-6)):
        _close(got, ref, tol, name)
    assert (w.numpy() == 0).sum() == (np.asarray(jw) == 0).sum() > 100  # the trim and Huber
    blocks = B._block_aggregates(port, r, w, J_cam, J_pt)
    for name, got, ref in zip(("U", "V", "bc", "bp", "Apc"), blocks, jblocks):
        _close(got, ref, 5e-5, name)
    dxc, dxp = B._schur_solve(port, *blocks, torch.tensor(lam))
    _close(dxc, jdxc, 1e-3, "dxc")
    _close(dxp, jdxp, 1e-3, "dxp")
    assert not dxc[:2].any()  # the gauge


def _jax_accepts(costs, cost0):
    """JAX's accept decisions, from the costs it returns: a rejected step
    repeats the cost before it."""
    return costs < np.r_[cost0, costs[:-1]]


def test_bundle_adjust_matches_jax():
    """20 LM iterations on the outlier scene, twice. From lambda 100 every
    step is taken and lowers the cost by more than 1e-5 of it: the costs
    within 2e-5 of JAX's and the same steps taken, the poses within 1e-4
    and the points within 1e-3 (a few are seen by two cameras only and
    move along their rays), the ATE to the truth < 0.02. From lambda 1e-3
    the cost settles in 5 steps: the same steps taken while JAX's step
    lowers the cost by more than 1e-5 of it; beyond that floor (a float32
    sum of ~1000 terms rounds at ~1e-6 of it) either side takes or rejects
    steps that change the cost by rounding, so there every cost is held
    within 2e-5 of JAX's, and a rejected step repeats the cost before it."""
    s, (port, jax_) = _outlier_problem()
    cost0 = float(JB._cost_only(jax_, jax_.poses, jax_.points, HUBER, TRIM))
    for lam0 in (100.0, 1e-3):
        poses, pts, info = bundle_adjust(port, num_iters=20, huber_delta=HUBER,
                                         init_lambda=lam0, trim_th=TRIM)
        jposes, jpts, jinfo = JB.bundle_adjust(jax_, num_iters=20, huber_delta=HUBER,
                                               init_lambda=lam0, trim_th=TRIM)
        jcosts = np.asarray(jinfo["costs"])
        costs, accepted = info["costs"].numpy(), info["accepted"].numpy()
        _close(costs, jcosts, 2e-5, "costs")
        before = np.r_[cost0, jcosts[:-1]]
        real = (before - jcosts) > 1e-5 * jcosts
        if lam0 == 100.0:
            assert real.all()
            _close(poses.R, jposes.R, 1e-4, "R")
            _close(poses.t, jposes.t, 1e-4, "t")
            _close(pts, jpts, 1e-3, "points")
            gt = Pose(_t(s["R"]), _t(s["t"]))
            ate = np.linalg.norm(camera_centers(poses) - camera_centers(gt), axis=-1).mean()
            assert ate < 0.02, ate
        else:
            assert 3 <= real.sum() < 20 and not real[real.argmin():].any()
        np.testing.assert_array_equal(accepted[real], _jax_accepts(jcosts, cost0)[real])
        port_before = np.r_[cost0, costs[:-1]]
        assert (costs[~accepted] == port_before[~accepted]).all()
        assert (costs[accepted] < port_before[accepted]).all()
    with pytest.raises(NotImplementedError, match="queue 1 item 7"):
        bundle_adjust_sharded(port)


# --- the pose graph and the tracks ---------------------------------------------------------

def test_pose_graph_matches_jax():
    """tests/test_sfm.py's closed loop (12 poses on a circle, noisy odometry
    and one exact loop closure): every iteration's cost within 1e-4 of
    JAX's, the Jacobian by ``torch.func.jacrev`` against ``jax.jacobian``
    through them, and the poses within 1e-4; the loop closes (the ATE at
    most half the chained odometry's)."""
    from chip_smoke_sfm import loop_graph

    iR, it, ei, ej, mR, mt, Rg, tg = (x.numpy() for x in loop_graph())
    opt, info = optimize_pose_graph(Pose(_t(iR), _t(it)), _t(ei).long(), _t(ej).long(),
                                    Pose(_t(mR), _t(mt)), num_iters=25)
    jopt, jinfo = JG.optimize_pose_graph(JPose(R=jnp.asarray(iR), t=jnp.asarray(it)),
                                         jnp.asarray(ei), jnp.asarray(ej),
                                         JPose(R=jnp.asarray(mR), t=jnp.asarray(mt)),
                                         num_iters=25)
    _close(info["costs"], jinfo["costs"], 1e-4, "costs")
    _close(opt.R, jopt.R, 1e-4, "R")
    _close(opt.t, jopt.t, 1e-4, "t")
    gt = Pose(_t(Rg), _t(tg))

    def ate(p):
        return np.linalg.norm(camera_centers(p) - camera_centers(gt), axis=-1).mean()

    assert ate(opt) < 0.5 * ate(Pose(_t(iR), _t(it)))
    assert info["costs"][-1] < info["costs"][0]


def test_build_tracks_matches_jax():
    """Union-find tracks over 5 views x 40 keypoints of random chain and
    skip matches (merging components, a view holding two keypoints of one
    track): the same track ids as JAX's."""
    rng = np.random.default_rng(4)
    V, N = 5, 40
    matches = {}
    for i, j in [(0, 1), (1, 2), (2, 3), (3, 4), (0, 2), (1, 3)]:
        m = np.where(rng.uniform(size=N) < 0.6, rng.integers(0, N, N), -1)
        matches[(i, j)] = m
    tracks = build_tracks(matches, V, N)
    np.testing.assert_array_equal(tracks, JP.build_tracks(matches, V, N))
    assert tracks.max() > 10 and (tracks == -1).any()


# --- run_sfm ------------------------------------------------------------------------------

def _jax_link_draws(valid_links, seed, num_hypotheses):
    """The minimal sets that JAX's ``run_sfm`` draws for each chain link:
    the key of ``seed`` split once a link, each link's ``ransac_essential``
    drawing ``jax.random.categorical`` over its valid matches."""
    key, draws = jax.random.key(seed), []
    for valid in valid_links:
        key, sub = jax.random.split(key)
        logits = jnp.where(jnp.asarray(valid), 0.0, -1e9)
        keys = jax.random.split(sub, num_hypotheses)
        draws.append(np.array(jax.vmap(
            lambda k: jax.random.categorical(k, logits, shape=(5,)))(keys)))
    return draws


def _jax_bases(x0, x1):
    """JAX's null-space basis of the 5-point system (each SVD returns
    another basis, and the candidates depend on it)."""
    x0, x1 = (torch.cat([x, torch.ones_like(x[..., :1])], -1) for x in (x0, x1))
    a = (x1[..., :, None] * x0[..., None, :]).reshape(*x0.shape[:-2], 5, 9)
    vt = jnp.linalg.svd(jnp.asarray(a.numpy()), full_matrices=True)[2]
    return torch.from_numpy(np.array(vt[..., 5:, :])).reshape(*x0.shape[:-2], 4, 3, 3)


def _rot_deg(Ra, Rb):
    """Degrees between rotations (..., 3, 3), from their chord in float64
    (the trace's arccos resolves only ~0.03 degrees near 0 in float32)."""
    chord = np.linalg.norm(np.asarray(Ra, np.float64) - np.asarray(Rb, np.float64),
                           axis=(-2, -1))
    return np.degrees(2 * np.arcsin(np.minimum(1.0, chord / (2 * np.sqrt(2)))))


def _each_link(rays0, rays1, valid, ths, sample_idx):
    """``pipeline.ransac_links`` one link at a time."""
    from gluefactory_torch.robust_estimators.relative_pose.ransac import ransac_essential

    return [tuple(x.numpy() for x in ransac_essential(
        rays0[i], rays1[i], valid[i], th=th, num_hypotheses=sample_idx.shape[1],
        sample_idx=sample_idx[i])[1:4]) for i, th in enumerate(ths)]


def test_ransac_links_batch_equals_each_link():
    """The chain's links in one ``torch.func.vmap`` batch a threshold (two
    thresholds here, as for two cameras) against ``ransac_essential`` link
    by link on the same minimal sets: R and t within 1e-2 degrees, the bound
    of the port against JAX (the batched products round otherwise in
    float32, and the Gauss-Newton steps carry it: up to 1.0e-3 degrees
    here), the same inliers."""
    from gluefactory_torch.robust_estimators.homography.ransac import sample_minimal_sets

    rng = np.random.default_rng(6)
    L, N = 4, 300
    rays0, rays1 = [], []
    for _ in range(L):
        X = np.c_[rng.uniform(-2, 2, (N, 2)), rng.uniform(4, 8, N)]
        R, t = _so3(rng.normal(0, 0.1, 3)), rng.normal(size=3)
        X1 = X @ R.T + t / np.linalg.norm(t)
        x0, x1 = X / X[:, 2:], X1 / X1[:, 2:]
        x1[:, :2] += rng.normal(0, 1e-3, (N, 2))
        out = rng.uniform(size=N) < 0.3
        x1[out, :2] = rng.uniform(-0.6, 0.6, (out.sum(), 2))
        rays0.append(x0)
        rays1.append(x1)
    rays0, rays1 = (_t(np.stack(x).astype(np.float32)) for x in (rays0, rays1))
    valid = _t(rng.uniform(size=(L, N)) > 0.05)
    g = torch.Generator().manual_seed(0)
    idx = torch.stack([sample_minimal_sets(valid[i], 128, g, 5) for i in range(L)])
    ths = [2.0 / 500.0, 2.0 / 400.0, 2.0 / 500.0, 2.0 / 400.0]
    for got, ref in zip(port_pipeline.ransac_links(rays0, rays1, valid, ths, idx),
                        _each_link(rays0, rays1, valid, ths, idx)):
        t_deg = np.degrees(2 * np.arcsin(min(1.0, np.linalg.norm(
            got[1].astype(np.float64) - ref[1]) / 2)))
        assert _rot_deg(got[0], ref[0]) < 1e-2 and t_deg < 1e-2, (got, ref)
        np.testing.assert_array_equal(got[2], ref[2])
        assert got[2].sum() > 150


def test_run_sfm_matches_jax(monkeypatch):
    """``run_sfm`` on tests/test_sfm.py's pipeline scene (5 views x 150
    points, 0.3 px noise, keypoint k of each view is point k), 256
    hypotheses a link and 15 BA iterations, fed JAX's minimal sets and
    null-space bases: the same tracks; every chain link's relative rotation
    within 1e-2 degrees of JAX's (no link of this scene takes another LO
    branch in float32, so none is held in float64) and the chain's camera
    centres within 1e-3 of the trajectory's extent; the BA's costs within
    1e-3 of JAX's (its start differs by the chain's ~1e-4) and its last
    cost within 1e-5; its poses' centres within 1e-3 of the extent; the ATE
    after alignment within 1e-4 of the extent of JAX's and below 2% of it."""
    M, P = 5, 150
    s = _scene(np.random.default_rng(21), M=M, P=P, noise_px=0.3)
    uv = s["uv"].reshape(M, P, 2)
    vis = s["valid"].reshape(M, P)
    matches = {(i, i + 1): np.where(vis[i] & vis[i + 1], np.arange(P), -1) for i in range(M - 1)}
    cam, jcam = _cams(s)
    jout = JP.run_sfm(uv, vis, matches, jcam, ransac_th=2.0, num_hypotheses=256, ba_iters=15)
    draws = _jax_link_draws([(matches[(i, i + 1)] >= 0) & vis[i] for i in range(M - 1)], 0, 256)
    monkeypatch.setattr(port_essential, "null_space_basis", _jax_bases)
    # JAX's bases come through numpy, so the links run one by one here (the batch
    # equals them: test_ransac_links_batch_equals_each_link)
    monkeypatch.setattr(port_pipeline, "ransac_links", _each_link)
    out = run_sfm(uv, vis, matches, cam, ransac_th=2.0, num_hypotheses=256, ba_iters=15,
                  sample_idx=draws, device="cpu")
    np.testing.assert_array_equal(out["track_id"], jout["track_id"])
    gt = Pose(_t(s["R"]), _t(s["t"]))
    c_gt = camera_centers(gt)
    extent = np.linalg.norm(c_gt - c_gt.mean(0), axis=-1).max()
    init, jinit = out["poses_init"], jout["poses_init"]
    rel = init.R[1:].numpy() @ init.R[:-1].numpy().transpose(0, 2, 1)
    jrel = np.asarray(jinit.R[1:]) @ np.asarray(jinit.R[:-1]).transpose(0, 2, 1)
    assert (_rot_deg(rel, jrel) < 1e-2).all(), _rot_deg(rel, jrel)
    c_init = camera_centers(init)
    jc_init = JA.camera_centers(jinit)
    assert np.abs(c_init - jc_init).max() < 1e-3 * extent
    costs, jcosts = out["ba_info"]["costs"], np.asarray(jout["ba_info"]["costs"])
    _close(costs, jcosts, 1e-3, "BA costs")
    assert abs(costs[-1] - jcosts[-1]) <= 1e-5 * jcosts[-1], (costs[-1], jcosts[-1])
    assert np.abs(camera_centers(out["poses"]) - JA.camera_centers(jout["poses"])).max() \
        < 1e-3 * extent
    ate = absolute_trajectory_error(out["poses"], gt) / extent
    jate = JA.absolute_trajectory_error(jout["poses"], JPose(R=jnp.asarray(s["R"]),
                                                             t=jnp.asarray(s["t"]))) / extent
    assert abs(ate - jate) < 1e-4 and ate < 0.02, (ate, jate)


# --- the trajectory benchmark ---------------------------------------------------------------

def test_trajectory_scene_runs_the_port(tmp_path):
    """tests/test_sfm_trajectory.py's check on the port alone: a rendered
    4-view arc (at 320x240, half that test's size, for time), SIFT (512
    keypoints) and the mutual nearest neighbour: more than 30 matches a
    pair, the ATE after alignment under 15% of the trajectory's extent, and
    the BA lowers the reprojection cost; each stage timed."""
    from gluefactory_torch.models import build_model
    from gluefactory_torch.scripts.sfm_trajectory import render_trajectory_scene, run_scene

    scene = tmp_path / "scene_0"
    render_trajectory_scene(scene, np.random.default_rng(99), (320, 240), n_views=4,
                            step_rot_deg=3.0, step_t=0.10)
    meta = json.loads((scene / "poses.json").read_text())
    T = [np.asarray(x) for x in meta["poses_0tok"]]
    assert len(T) == 4 and np.allclose(T[0], np.eye(4)) and np.linalg.norm(T[1][:3, 3]) > 0.05
    model = build_model("two_view_pipeline", {
        "extractor": {"name": "extractors.sift", "max_num_keypoints": 512,
                      "contrast_threshold": 0.02},
        "matcher": {"name": "matchers.nearest_neighbor_matcher", "ratio_thresh": 0.9,
                    "mutual_check": True}}, device="cpu")
    timings = {}
    res = run_scene(scene, model, "cpu", timings=timings)
    assert res["n_matches_mean"] > 30, res
    assert res["ate"] / res["extent"] < 0.15, res
    assert res["ba_cost_last"] <= res["ba_cost_first"], res
    assert set(timings) == {"forward_ms", "chain_ms", "tracks_ms", "ba_ms"}


def test_trajectory_recipes_and_refusals(tmp_path, monkeypatch):
    """The recipes are the JAX script's cards (its default SIFT+LightGlue
    card, superpoint+lsd+gluestick.yaml with the ground truth off) with the
    committed runs' blobs; the CLI renders, runs a committed run by name
    (on the CPU here, 2 views at 320x240) into summaries.json with the keys of the
    committed one, and runs on the card unless asked (``--device``); a
    model whose keypoints of a view differ
    between its two pairs (a detector-free matcher) is refused, as are
    ``bundle_adjust_sharded`` and ``run_sfm`` on a missing card."""
    import yaml

    from gluefactory_torch.scripts import sfm_trajectory as S
    from gluefactory_tpu.scripts import sfm_trajectory as JS

    assert S.model_conf(None, None, 512)[0] == JS._default_model_conf(512).to_dict()
    jcard = dict(JS._default_model_conf(1024))
    assert json.loads(json.dumps(jcard, default=dict)) == trajectory_conf("sift_lg")["model"]
    card = yaml.safe_load(GLUESTICK_CARD.read_text())["model"]
    card.update(ground_truth={"name": None}, run_gt_in_forward=False)
    assert trajectory_conf("gluestick")["model"] == card
    assert {k: v["checkpoint"] for k, v in TRAJECTORY_CONFS.items()} == {
        run: json.loads((ROOT_PATH / "outputs" / "results" / "trajectory" / run
                         / "summaries.json").read_text())["checkpoint"]
        for run in TRAJECTORY_CONFS}
    assert S.model_conf("sift_lg_stage2", "x.msgpack")[1] == "x.msgpack"
    assert S.model_conf(str(GLUESTICK_CARD), None)[0] == card

    S.main(["--render", "--out", str(tmp_path / "set"), "--scenes", "1", "--views", "2"])
    assert sorted(p.name for p in (tmp_path / "set" / "scene_0").iterdir()) == [
        "0.ppm", "1.ppm", "poses.json"]
    # a committed run by name on the CPU, on 2 views at 320x240 (for time):
    # summaries.json with the JAX script's keys
    monkeypatch.setattr(settings, "EVAL_PATH", tmp_path / "results")
    S.render_trajectory_scene(tmp_path / "small" / "scene_0", np.random.default_rng(0),
                              (320, 240), n_views=2)
    S.main(["--out", str(tmp_path / "small"), "--conf", "sift_lg_stage2", "--device", "cpu",
            "--tag", "t", "--views", "2"])
    ours = json.loads((tmp_path / "results" / "trajectory" / "t" / "summaries.json").read_text())
    committed = json.loads((ROOT_PATH / "outputs" / "results" / "trajectory" / "sift_lg_stage2"
                            / "summaries.json").read_text())
    assert set(ours) == set(committed) and ours["views"] == 2
    assert set(ours["scenes"]["scene_0"]) == set(committed["scenes"]["scene_0"])
    assert ours["checkpoint"] == committed["checkpoint"]
    with pytest.raises(FileExistsError, match="another --tag"):  # never over a committed run
        S.main(["--out", str(tmp_path / "small"), "--conf", "sift_lg_stage2", "--device", "cpu",
                "--tag", "t"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            S.main(["--out", str(tmp_path / "set"), "--conf", "sift_lg_stage2"])
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run_sfm(np.zeros((2, 8, 2)), np.ones((2, 8), bool), {(0, 1): np.arange(8)},
                    Camera.from_fc([[640.0, 480.0]] * 2, [[500.0, 500.0]] * 2,
                                   [[320.0, 240.0]] * 2))

    class Shifting(torch.nn.Module):  # its keypoints of a view move with the pair
        calls = 0

        def forward(self, data):
            Shifting.calls += 1
            k = torch.rand(1, 16, 2) * 100 + Shifting.calls
            return {"keypoints0": k, "keypoints1": k + 1.0,
                    "matches0": torch.arange(16)[None]}

    (tmp_path / "set" / "scene_0" / "2.ppm").write_bytes(
        (tmp_path / "set" / "scene_0" / "1.ppm").read_bytes())
    meta = json.loads((tmp_path / "set" / "scene_0" / "poses.json").read_text())
    meta["poses_0tok"].append(meta["poses_0tok"][-1])
    (tmp_path / "set" / "scene_0" / "poses.json").write_text(json.dumps(meta))
    with pytest.raises(RuntimeError, match="pair-dependent"):
        S.run_scene(tmp_path / "set" / "scene_0", Shifting(), "cpu")


# --- phase 23's reference numbers ---------------------------------------------------------

GLUESTICK_CARD = ROOT_PATH / "gluefactory_tpu" / "configs" / "superpoint+lsd+gluestick.yaml"


def _png_scenes(root: Path, out: Path) -> list:
    """The port's rendered scenes under ``root`` copied to ``out`` as the PNG
    files that the JAX script's ``run_scene`` reads (the same pixels)."""
    import cv2

    from gluefactory_torch.utils.image import read_image

    scenes = []
    for sd in sorted(d for d in root.iterdir() if d.is_dir()):
        dst = out / sd.name
        dst.mkdir(parents=True, exist_ok=True)
        (dst / "poses.json").write_text((sd / "poses.json").read_text())
        for ppm in sd.glob("*.ppm"):
            cv2.imwrite(str(dst / f"{ppm.stem}.png"), read_image(ppm)[..., ::-1])
        scenes.append(dst)
    return scenes


def _runaway_draws(problem, draws: int) -> list:
    """run_sfm's float32 BA (40 iterations, Huber 1 px, the trim at 20 px)
    of ``problem`` as built, then with its observations moved by at most 4
    float32 ulps (``draws`` times, generator seeds 1 to ``draws``): each
    run's last cost over the starting cost (a runaway ends near 0)."""
    import dataclasses

    start = float(B._cost_only(problem, problem.poses, problem.points, 1.0, 20.0))
    out = []
    for k in range(draws + 1):
        uv = problem.obs_uv
        if k:
            ulps = torch.randint(-4, 5, uv.shape, generator=torch.Generator().manual_seed(k))
            uv = uv * (1 + ulps * 2.0**-23)
        costs = bundle_adjust(dataclasses.replace(problem, obs_uv=uv), 40, 1.0,
                              trim_th=20.0)[2]["costs"]
        out.append(round(float(costs[-1]) / start, 4))
    return out


def reference(side: str, run: str, root: Path, out: Path, seeds, perturb: int = 0) -> list:
    """The summaries of trajectory run ``run`` on the scenes under ``root``
    for each RANSAC seed of ``seeds``: the JAX script's ``run_scene``
    (``side`` "jax", on PNG copies under ``out``; the pairs' forward is run
    once and reused across the seeds) or the port's on the CPU ("port"; with
    ``perturb``, each scene's ``_runaway_draws`` under "runaway")."""
    from gluefactory_torch.scripts.sfm_trajectory import summarize

    conf = trajectory_conf(run)
    checkpoint = str(ROOT_PATH / conf["checkpoint"])
    rows = []
    if side == "port":
        from gluefactory_torch.scripts.sfm_trajectory import build_pipeline, run_scene

        model = build_pipeline(run, None, device="cpu")
        scenes = sorted(d for d in root.iterdir() if d.is_dir())
        for seed in seeds:
            per_scene, details = {}, {sd.name: {} for sd in scenes}
            for sd in scenes:
                per_scene[sd.name] = run_scene(sd, model, "cpu", seed=seed,
                                               details=details[sd.name])
            rows.append({"run": run, "seed": seed, **summarize(per_scene, checkpoint, 8)})
            if perturb:
                rows[-1]["runaway"] = {name: _runaway_draws(d["sfm"]["problem"], perturb)
                                       for name, d in details.items()}
        return rows

    import gluefactory_tpu.sfm.pipeline as JP
    from gluefactory_tpu.scripts import sfm_trajectory as JT

    model, params = JT._build_pipeline(checkpoint, 1024,
                                       str(GLUESTICK_CARD) if run == "gluestick" else None)
    apply, cache = jax.jit(model.apply), {}

    def apply_fn(params, data):
        key = hashlib.sha1(b"".join(np.asarray(data[v]["image"]).tobytes()
                                    for v in ("view0", "view1"))).hexdigest()
        if key not in cache:
            cache[key] = jax.device_get(apply(params, data))
        return cache[key]

    scenes = _png_scenes(root, out / "png")
    run_sfm = JP.run_sfm
    try:
        for seed in seeds:
            JP.run_sfm = functools.partial(run_sfm, seed=seed)
            per_scene = {sd.name: JT.run_scene(sd, model, params, apply_fn) for sd in scenes}
            rows.append({"run": run, "seed": seed, **summarize(per_scene, checkpoint, 8)})
    finally:
        JP.run_sfm = run_sfm
    return rows


if __name__ == "__main__":
    import argparse
    import sys

    parser = argparse.ArgumentParser(
        description="chip_smoke.py phase 23's reference numbers: the JAX package's trajectory "
                    "summaries (or the port's on the CPU) on the set rendered under "
                    "--root/trajectory (--render renders it), one JSON line a (run, RANSAC seed)")
    parser.add_argument("--root", type=Path, required=True)
    parser.add_argument("--out", type=Path, required=True)
    parser.add_argument("--render", action="store_true")
    parser.add_argument("--side", choices=("jax", "port"), default="jax")
    parser.add_argument("--runs", nargs="*")
    parser.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    parser.add_argument("--perturb", type=int, default=0,
                        help="with --side port: rerun each scene's float32 BA this many "
                             "times on observations moved by at most 4 ulps")
    args = parser.parse_args()
    import chip_smoke

    sys.modules.setdefault("chip_smoke", chip_smoke)
    import chip_smoke_sfm as CS

    if args.render:
        CS.render_trajectory_set(args.root / "trajectory")
    if args.side == "jax":
        jax.config.update("jax_platforms", "cpu")
    for run in CS.TRAJ_RUNS:
        if not args.runs or run in args.runs:
            for row in reference(args.side, run, args.root / "trajectory",
                                 args.out / run, args.seeds, args.perturb):
                print(json.dumps(row), flush=True)
