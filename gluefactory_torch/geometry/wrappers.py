"""Batched poses and pinhole cameras (gluefactory_tpu/geometry/wrappers.py),
as dataclasses of plain tensors with leading batch dimensions.

``Pose`` maps camera-A coordinates to camera B: x_B = R x_A + t. ``Camera``
follows COLMAP: the centre of the upper-left pixel is (0.5, 0.5). Only what
the relative-pose path and the depth ground truth read is ported: the
constructors, the group operations, scaling, pixels to rays and back
through Brown distortion, and the tangent-space updates and projection
Jacobians that bundle adjustment and the pose graph (``sfm``) read."""

from __future__ import annotations

import dataclasses

import torch

from .utils import J_distort_points, distort_points, so3exp_map, so3log_map, to_homogeneous


def _tensor(x, dtype=None, device=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(dtype=dtype or x.dtype, device=device or x.device)
    return torch.as_tensor(x, dtype=dtype or torch.float32, device=device)


@dataclasses.dataclass(frozen=True)
class Pose:
    """SE(3) transform: R (..., 3, 3), t (..., 3)."""

    R: torch.Tensor
    t: torch.Tensor

    @classmethod
    def from_Rt(cls, R, t) -> "Pose":
        return cls(R=_tensor(R), t=_tensor(t))

    @classmethod
    def from_4x4mat(cls, T) -> "Pose":
        T = _tensor(T)
        return cls(R=T[..., :3, :3], t=T[..., :3, 3])

    @classmethod
    def identity(cls, batch_shape: tuple = (), dtype=torch.float32, device=None) -> "Pose":
        R = torch.eye(3, dtype=dtype, device=device).expand(*batch_shape, 3, 3)
        return cls(R=R, t=torch.zeros(*batch_shape, 3, dtype=dtype, device=device))

    def to(self, device=None, dtype=None) -> "Pose":
        return Pose(R=self.R.to(device=device, dtype=dtype),
                    t=self.t.to(device=device, dtype=dtype))

    def __getitem__(self, idx) -> "Pose":
        return Pose(R=self.R[idx], t=self.t[idx])

    def inv(self) -> "Pose":
        R_inv = self.R.transpose(-1, -2)
        return Pose(R=R_inv, t=-(R_inv @ self.t[..., None])[..., 0])

    def compose(self, other: "Pose") -> "Pose":
        """self @ other: ``other`` applies first."""
        return Pose(R=self.R @ other.R, t=self.t + (self.R @ other.t[..., None])[..., 0])

    def transform(self, p3d: torch.Tensor) -> torch.Tensor:
        """Points (..., N, 3) from frame A to frame B."""
        return p3d @ self.R.transpose(-1, -2) + self.t[..., None, :]

    def retract_left(self, delta: torch.Tensor) -> "Pose":
        """exp(delta) applied after self, delta = (omega, v) (..., 6): the
        perturbation that bundle adjustment's Jacobians [-[p]x | I] linearize."""
        dR = so3exp_map(delta[..., :3])
        return Pose(R=dR @ self.R, t=(dR @ self.t[..., None])[..., 0] + delta[..., 3:])

    def local(self, other: "Pose") -> torch.Tensor:
        """(omega, t) (..., 6) of self^-1 other."""
        rel = self.inv().compose(other)
        return torch.cat([so3log_map(rel.R), rel.t], dim=-1)


@dataclasses.dataclass(frozen=True)
class Camera:
    """Pinhole camera with Brown distortion: size (..., 2) = (w, h), f (..., 2),
    c (..., 2), dist (..., 4)."""

    size: torch.Tensor
    f: torch.Tensor
    c: torch.Tensor
    dist: torch.Tensor
    eps = 1e-4  # the least depth in front of the camera

    @classmethod
    def from_fc(cls, size, f, c, dist=None) -> "Camera":
        f = _tensor(f)
        size, c = _tensor(size, f.dtype, f.device), _tensor(c, f.dtype, f.device)
        dist = (torch.zeros(*f.shape[:-1], 4, dtype=f.dtype, device=f.device) if dist is None
                else _tensor(dist, f.dtype, f.device))
        return cls(size=size, f=f, c=c, dist=dist)

    @classmethod
    def from_calibration_matrix(cls, K, size=None) -> "Camera":
        K = _tensor(K)
        f = torch.stack([K[..., 0, 0], K[..., 1, 1]], dim=-1)
        c = torch.stack([K[..., 0, 2], K[..., 1, 2]], dim=-1)
        return cls.from_fc(2.0 * c if size is None else size, f, c)

    def to(self, device=None, dtype=None) -> "Camera":
        return Camera(*(x.to(device=device, dtype=dtype)
                        for x in (self.size, self.f, self.c, self.dist)))

    def calibration_matrix(self) -> torch.Tensor:
        """(..., 3, 3) K."""
        z = torch.zeros_like(self.f[..., 0])
        return torch.stack([self.f[..., 0], z, self.c[..., 0],
                            z, self.f[..., 1], self.c[..., 1],
                            z, z, torch.ones_like(z)], dim=-1).reshape(*self.f.shape[:-1], 3, 3)

    def scale(self, scales) -> "Camera":
        """The camera of the image resized by ``scales`` (sx, sy): size, focal
        lengths and principal point all multiplied, as the JAX package does."""
        s = _tensor(scales, self.f.dtype, self.f.device).expand_as(self.f)
        return Camera(size=self.size * s, f=self.f * s, c=self.c * s, dist=self.dist)

    def distort(self, pts: torch.Tensor) -> torch.Tensor:
        return distort_points(pts, self.dist)

    def undistort(self, pts: torch.Tensor, num_iters: int = 5) -> torch.Tensor:
        """Invert the Brown model by a fixed number of fixed-point steps."""
        undist = pts
        for _ in range(num_iters):
            undist = pts - (self.distort(undist) - undist)
        return undist

    def normalize(self, p2d: torch.Tensor) -> torch.Tensor:
        return (p2d - self.c[..., None, :]) / self.f[..., None, :]

    def denormalize(self, p2d: torch.Tensor) -> torch.Tensor:
        return p2d * self.f[..., None, :] + self.c[..., None, :]

    def in_image(self, p2d: torch.Tensor) -> torch.Tensor:
        """(..., N) whether pixels (..., N, 2) lie in [0, size - 1]."""
        return ((p2d >= 0.0) & (p2d <= self.size[..., None, :] - 1.0)).all(dim=-1)

    def project(self, p3d: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Camera-frame points (..., N, 3) -> (the normalized image plane
        (..., N, 2), whether each lies in front of the camera)."""
        z = p3d[..., -1]
        valid = z > self.eps
        z_safe = torch.where(valid, z, torch.ones_like(z))
        return p3d[..., :-1] / z_safe[..., None], valid

    def J_project(self, p3d: torch.Tensor) -> torch.Tensor:
        """(..., N, 2, 3) Jacobian of ``project``, the depth held at ``eps``
        or more."""
        x, y, z = p3d.unbind(-1)
        z = torch.where(z > self.eps, z, torch.full_like(z, self.eps))
        zero = torch.zeros_like(z)
        return torch.stack([1.0 / z, zero, -x / z**2, zero, 1.0 / z, -y / z**2],
                           dim=-1).reshape(*p3d.shape[:-1], 2, 3)

    def J_distort(self, pts: torch.Tensor) -> torch.Tensor:
        return J_distort_points(pts, self.dist)

    def J_world2image(self, p3d: torch.Tensor) -> torch.Tensor:
        """(..., N, 2, 3) Jacobian of the pixels with respect to camera-frame
        points (..., N, 3)."""
        p2d, _ = self.project(p3d)
        J_dn = self.f[..., None, :, None] * torch.eye(2, dtype=p3d.dtype, device=p3d.device)
        return J_dn @ self.J_distort(p2d) @ self.J_project(p3d)

    def cam2image(self, p3d: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Camera-frame points (..., N, 3) -> (pixels (..., N, 2), whether
        each is in front of the camera and inside the image)."""
        p2d, visible = self.project(p3d)
        p2d = self.denormalize(self.distort(p2d))
        return p2d, visible & self.in_image(p2d)

    def image2cam(self, p2d: torch.Tensor) -> torch.Tensor:
        """Pixels (..., N, 2) -> rays at unit depth (..., N, 3)."""
        return to_homogeneous(self.undistort(self.normalize(p2d)))
