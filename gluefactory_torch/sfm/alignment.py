"""Trajectory alignment and the absolute trajectory error
(gluefactory_tpu/sfm/alignment.py): the Umeyama Sim(3) alignment of
estimated to ground-truth camera centres, the standard evaluation of a
monocular reconstruction, whose frame and scale are free. In float64 numpy,
as the JAX package computes it."""

from __future__ import annotations

import numpy as np

from ..geometry.wrappers import Pose


def camera_centers(poses: Pose) -> np.ndarray:
    """(M, 3) centres -R^T t of world-to-camera poses (M,), in float64."""
    R = poses.R.detach().cpu().double().numpy()
    t = poses.t.detach().cpu().double().numpy()
    return -np.einsum("mji,mj->mi", R, t)


def umeyama_alignment(src: np.ndarray, dst: np.ndarray, with_scale: bool = True):
    """The least-squares similarity s R src + t ~ dst: (s, R (3, 3), t (3,))."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    mu_s, mu_d = src.mean(0), dst.mean(0)
    xs, xd = src - mu_s, dst - mu_d
    U, D, Vt = np.linalg.svd(xd.T @ xs / len(src))
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    var_s = (xs**2).sum() / len(src)
    s = float(np.trace(np.diag(D) @ S) / var_s) if with_scale else 1.0
    return s, R, mu_d - s * R @ mu_s


def absolute_trajectory_error(poses_est: Pose, poses_gt: Pose, align: bool = True) -> float:
    """RMS distance of the camera centres, after the Sim(3) alignment."""
    c_est, c_gt = camera_centers(poses_est), camera_centers(poses_gt)
    if align:
        s, R, t = umeyama_alignment(c_est, c_gt)
        c_est = (s * (R @ c_est.T)).T + t
    return float(np.sqrt(((c_est - c_gt) ** 2).sum(-1).mean()))
