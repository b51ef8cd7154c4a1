"""Batched epipolar geometry (gluefactory_tpu/geometry/epipolar.py):
essential and fundamental matrices of a pose, epipolar distances, the
decomposition of an essential matrix and the angular errors of a relative
pose."""

from __future__ import annotations

import torch

from .utils import skew_symmetric, to_homogeneous
from .wrappers import Camera, Pose


def T_to_E(T: Pose) -> torch.Tensor:
    """E = [t]x R."""
    return skew_symmetric(T.t) @ T.R


def E_to_F(E: torch.Tensor, K0: torch.Tensor, K1: torch.Tensor) -> torch.Tensor:
    return torch.linalg.inv(K1).transpose(-1, -2) @ E @ torch.linalg.inv(K0)


def sym_epipolar_distance(p0: torch.Tensor, p1: torch.Tensor, E: torch.Tensor,
                          squared: bool = True) -> torch.Tensor:
    """Symmetric epipolar distance (..., N) of paired points (..., N, 2|3)."""
    if p0.shape[-1] != 3:
        p0 = to_homogeneous(p0)
    if p1.shape[-1] != 3:
        p1 = to_homogeneous(p1)
    E_p0 = torch.einsum("...ij,...nj->...ni", E, p0)
    Et_p1 = torch.einsum("...ij,...ni->...nj", E, p1)
    p1_E_p0 = (p1 * E_p0).sum(-1)
    d0 = E_p0[..., 0] ** 2 + E_p0[..., 1] ** 2
    d1 = Et_p1[..., 0] ** 2 + Et_p1[..., 1] ** 2
    inv = 1.0 / (d0 + 1e-15) + 1.0 / (d1 + 1e-15)
    if squared:
        return p1_E_p0**2 * inv
    return p1_E_p0.abs() * torch.sqrt(inv)


def generalized_epi_dist(kpts0: torch.Tensor, kpts1: torch.Tensor, cam0: Camera,
                         cam1: Camera, T_0to1: Pose, essential: bool = True) -> torch.Tensor:
    """Epipolar distance (..., N) of paired pixel keypoints under the cameras
    and the relative pose: in normalized coordinates with ``essential``,
    else in pixels through F."""
    if essential:
        return sym_epipolar_distance(cam0.image2cam(kpts0), cam1.image2cam(kpts1),
                                     T_to_E(T_0to1), squared=False)
    F = E_to_F(T_to_E(T_0to1), cam0.calibration_matrix(), cam1.calibration_matrix())
    return sym_epipolar_distance(kpts0, kpts1, F, squared=False)


def decompose_essential_matrix(E: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """E -> (the two rotations (..., 2, 3, 3), the translation direction
    (..., 3)), from the SVD with U and V made proper rotations."""
    U, _, Vt = torch.linalg.svd(E)
    U = U * torch.sign(torch.linalg.det(U))[..., None, None]
    Vt = Vt * torch.sign(torch.linalg.det(Vt))[..., None, None]
    W = E.new_tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    return torch.stack([U @ W @ Vt, U @ W.T @ Vt], dim=-3), U[..., :, 2]


def angle_error_mat(R1: torch.Tensor, R2: torch.Tensor) -> torch.Tensor:
    """Angle (degrees) of the rotation between R1 and R2."""
    cos = ((R1.transpose(-1, -2) @ R2).diagonal(dim1=-2, dim2=-1).sum(-1) - 1.0) / 2.0
    return torch.rad2deg(torch.arccos(cos.clamp(-1.0, 1.0)))


def angle_error_vec(v1: torch.Tensor, v2: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """Angle (degrees) between two vectors."""
    n = torch.linalg.vector_norm(v1, dim=-1) * torch.linalg.vector_norm(v2, dim=-1)
    cos = (v1 * v2).sum(-1) / (n + eps)
    return torch.rad2deg(torch.arccos(cos.clamp(-1.0, 1.0)))


def relative_pose_error(T_0to1: Pose, R_est: torch.Tensor, t_est: torch.Tensor,
                        ignore_gt_t_thr: float = 0.0) -> tuple[torch.Tensor, torch.Tensor]:
    """(rotation error, translation error) in degrees; the translation error
    is the smaller of the two signs, since E fixes t only up to sign."""
    t_gt = T_0to1.t
    t_err = angle_error_vec(t_est, t_gt)
    t_err = torch.minimum(t_err, 180.0 - t_err)
    t_err = torch.where(torch.linalg.vector_norm(t_gt, dim=-1) < ignore_gt_t_thr,
                        torch.zeros_like(t_err), t_err)
    return angle_error_mat(R_est, T_0to1.R), t_err
