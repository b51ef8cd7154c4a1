"""Batched essential-matrix solvers, triangulation and pose recovery
(gluefactory_tpu/geometry/essential.py). Inputs are normalized camera
coordinates (rays on the unit plane); E satisfies x1^T E x0 = 0.

The minimal solver is a numeric hidden-variable resultant with no
eigensolver, as in the JAX package:

  1. the null space X, Y, Z, W of the 5x9 epipolar system (batched SVD, then
     a canonical basis of it), so E(x, y, z) = xX + yY + zZ + W;
  2. the 10 cubic constraints (det E = 0 and 2 E E^T E - tr(E E^T) E = 0)
     over the 20 monomials of degree <= 3, their coefficients fitted at 20
     fixed points through a precomputed inverse Vandermonde matrix;
  3. z hidden: a 10x10 matrix A(z) whose determinant vanishes at solutions;
  4. real roots of det A(z) bracketed by sign changes on a tan(theta) grid,
     then bisected a fixed number of times (batched 10x10 determinants);
  5. the null vector of A(z*) (batched SVD) gives x and y.

Every step is batched over hypotheses and stays on the device: up to 10
candidates a sample, with a validity mask. Linear solves use the ``_ex``
variants, so a degenerate hypothesis gives inf or nan instead of an error."""

from __future__ import annotations

import numpy as np
import torch

from .epipolar import decompose_essential_matrix
from .utils import skew_symmetric, so3exp_map, to_homogeneous


def _rays(x: torch.Tensor) -> torch.Tensor:
    return to_homogeneous(x) if x.shape[-1] == 2 else x


def eight_point_essential(x0: torch.Tensor, x1: torch.Tensor,
                          weights: torch.Tensor | None = None) -> torch.Tensor:
    """Weighted 8-point algorithm: (..., N, 2|3) x2 -> (..., 3, 3), projected
    onto the essential manifold (singular values 1, 1, 0)."""
    x0, x1 = _rays(x0), _rays(x1)
    if weights is None:
        weights = torch.ones(x0.shape[:-1], dtype=x0.dtype, device=x0.device)
    a = (x1[..., :, None] * x0[..., None, :]).reshape(*x0.shape[:-1], 9)
    AtA = torch.einsum("...ni,...n,...nj->...ij", a, weights, a)
    E = torch.linalg.eigh(AtA).eigenvectors[..., :, 0].reshape(*AtA.shape[:-2], 3, 3)
    U, s, Vt = torch.linalg.svd(E)
    d = torch.zeros_like(s)
    d[..., :2] = 1.0
    return U @ (d[..., :, None] * Vt)


def sampson_distance(x0: torch.Tensor, x1: torch.Tensor, E: torch.Tensor) -> torch.Tensor:
    """First-order geometric (Sampson) error (..., N), squared."""
    x0, x1 = _rays(x0), _rays(x1)
    Ex0 = torch.einsum("...ij,...nj->...ni", E, x0)
    Etx1 = torch.einsum("...ji,...nj->...ni", E, x1)
    x1Ex0 = (x1 * Ex0).sum(-1)
    denom = Ex0[..., 0] ** 2 + Ex0[..., 1] ** 2 + Etx1[..., 0] ** 2 + Etx1[..., 1] ** 2
    return x1Ex0**2 / (denom + 1e-15)


def triangulate_depths(r0: torch.Tensor, r1: torch.Tensor, R: torch.Tensor,
                       t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Depths (s, u), each (..., N), of rays r0 (view 0) and r1 (view 1) under
    x1 = R x0 + t: min ||s R r0 + t - u r1||^2 by the 2x2 normal equations,
    solved by Cramer's rule with |det| clamped at 1e-12."""
    Rr0 = torch.einsum("...ij,...nj->...ni", R, r0)
    a = (Rr0 * Rr0).sum(-1)
    b = -(Rr0 * r1).sum(-1)
    c = (r1 * r1).sum(-1)
    d = -(Rr0 * t[..., None, :]).sum(-1)
    e = (r1 * t[..., None, :]).sum(-1)
    det = a * c - b * b
    det = torch.where(det.abs() < 1e-12, torch.full_like(det, 1e-12), det)
    return (d * c - b * e) / det, (a * e - b * d) / det


def recover_pose_from_essential(E: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor,
                                valid: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The (R, t) of the four decompositions of E (3, 3) with the most valid
    correspondences in front of both cameras (cv2.recoverPose's vote)."""
    x0, x1 = _rays(x0), _rays(x1)
    Rs, t = decompose_essential_matrix(E)
    cands_R = torch.stack([Rs[0], Rs[0], Rs[1], Rs[1]])
    cands_t = torch.stack([t, -t, t, -t])
    s, u = triangulate_depths(x0[None], x1[None], cands_R, cands_t)  # (4, N)
    best = ((s > 0) & (u > 0) & valid[None]).sum(-1).argmax()
    return cands_R[best], cands_t[best]


# --- the 5-point minimal solver ---------------------------------------------------

_MONOMIALS_3 = [(a, b, c) for a in range(4) for b in range(4 - a)
                for c in range(4 - a - b)]  # x^a y^b z^c, a + b + c <= 3: 20
_XY_MONOMIALS = sorted({(a, b) for (a, b, _c) in _MONOMIALS_3})  # 10


def _make_vandermonde_inv():
    """20 sample points and the inverse of their monomial Vandermonde matrix,
    the first well-conditioned draw of a fixed stream."""
    rng = np.random.default_rng(1234)
    for _ in range(100):
        pts = rng.normal(size=(20, 3))
        V = np.stack([np.prod(pts ** np.asarray(m, float), axis=-1) for m in _MONOMIALS_3],
                     axis=-1)  # (20 points, 20 monomials)
        if np.linalg.cond(V) < 1e4:
            return pts, np.linalg.inv(V)
    raise RuntimeError("could not build a well-conditioned monomial basis")


_FP_PTS, _FP_VINV = _make_vandermonde_inv()
# monomial i lands at (its xy group, its z power) of the hidden-variable matrix
_GROUP_FLAT = np.array([_XY_MONOMIALS.index((a, b)) * 4 + c for (a, b, c) in _MONOMIALS_3])
_XY_DEG = np.array([3 - a - b for (a, b) in _XY_MONOMIALS], np.float32)
_IDX_ONE = _XY_MONOMIALS.index((0, 0))
_IDX_X = _XY_MONOMIALS.index((1, 0))
_IDX_Y = _XY_MONOMIALS.index((0, 1))
_PROBES = np.random.default_rng(5).normal(size=(4, 9))  # projected onto each null space


def _essential_constraints(E: torch.Tensor) -> torch.Tensor:
    """det(E) and the 9 entries of the trace constraint -> (..., 10)."""
    EEt = E @ E.transpose(-1, -2)
    tr = EEt.diagonal(dim1=-2, dim2=-1).sum(-1)
    C = 2.0 * (EEt @ E) - tr[..., None, None] * E
    return torch.cat([torch.linalg.det(E)[..., None], C.reshape(*E.shape[:-2], 9)], dim=-1)


def _z_powers(z: torch.Tensor) -> torch.Tensor:
    return torch.stack([torch.ones_like(z), z, z * z, z**3], dim=-1)


def null_space_basis(x0: torch.Tensor, x1: torch.Tensor) -> torch.Tensor:
    """(..., 5, 2|3) x2 -> (..., 4, 3, 3): X, Y, Z, W spanning the null space
    of the 5x9 epipolar system.

    The SVD's basis of that space is arbitrary (LAPACK, cuSOLVER and JAX
    each return another), and the resultant's brackets and spurious roots
    depend on the basis. So the basis is made canonical: fixed vectors
    projected onto the space (its projector does not depend on the basis),
    then orthonormalized in order, so that every device solves the same
    resultant."""
    x0, x1 = _rays(x0), _rays(x1)
    a = (x1[..., :, None] * x0[..., None, :]).reshape(*x0.shape[:-2], 5, 9)
    B = torch.linalg.svd(a, full_matrices=True).Vh[..., 5:9, :]
    C = torch.as_tensor(_PROBES, dtype=B.dtype, device=B.device) @ (B.transpose(-1, -2) @ B)
    rows = []
    for v in C.unbind(-2):  # Gram-Schmidt
        for q in rows:
            v = v - (v * q).sum(-1, keepdim=True) * q
        rows.append(v / torch.linalg.vector_norm(v, dim=-1, keepdim=True))
    return torch.stack(rows, dim=-2).reshape(*x0.shape[:-2], 4, 3, 3)


def five_point_essential(x0: torch.Tensor, x1: torch.Tensor, grid_size: int = 128,
                         bisect_iters: int = 40) -> tuple[torch.Tensor, torch.Tensor]:
    """Minimal solver: (..., 5, 2|3) x2 -> up to 10 essential matrices
    (..., 10, 3, 3) and their validity (..., 10)."""
    return essentials_from_basis(null_space_basis(x0, x1), grid_size, bisect_iters)


def essentials_from_basis(XYZW: torch.Tensor, grid_size: int = 128,
                          bisect_iters: int = 40) -> tuple[torch.Tensor, torch.Tensor]:
    """Steps 2-5 of the 5-point solver on a null-space basis (..., 4, 3, 3)."""
    batch = XYZW.shape[:-3]
    dtype, device = XYZW.dtype, XYZW.device
    pts = torch.as_tensor(_FP_PTS, dtype=dtype, device=device)
    coef_xyzw = torch.cat([pts, torch.ones(20, 1, dtype=dtype, device=device)], dim=-1)
    E_pts = torch.einsum("pk,...kij->...pij", coef_xyzw, XYZW)
    F = _essential_constraints(E_pts).transpose(-1, -2)  # (..., 10 constraints, 20 points)
    coeffs = F @ torch.as_tensor(_FP_VINV, dtype=dtype, device=device).T  # (..., 10, 20)
    coeffs = coeffs / (torch.linalg.vector_norm(coeffs, dim=-1, keepdim=True) + 1e-12)
    grouped = coeffs.new_zeros(*coeffs.shape[:-1], 40)
    grouped[..., torch.as_tensor(_GROUP_FLAT, device=device)] = coeffs
    grouped = grouped.reshape(*coeffs.shape[:-1], 10, 4)  # (..., constraint, xy group, z power)
    xy_deg = torch.as_tensor(_XY_DEG, dtype=dtype, device=device)

    def det_a(z):
        """det A(z) (..., Z), columns scaled so that it stays O(1) for large |z|."""
        A = torch.einsum("...cgp,...zp->...zcg", grouped, _z_powers(z))
        scale = (1.0 + z.abs())[..., None] ** xy_deg
        return torch.linalg.det(A / scale[..., None, :])

    eps = 1e-3
    zgrid = torch.tan(torch.linspace(-np.pi / 2 + eps, np.pi / 2 - eps, grid_size,
                                     dtype=dtype, device=device))
    d = det_a(zgrid.expand(*batch, grid_size))
    sign_change = torch.sign(d[..., :-1]) * torch.sign(d[..., 1:]) < 0  # (..., G-1)
    # the first 10 brackets, in grid order
    order = torch.argsort((~sign_change).to(torch.uint8), dim=-1, stable=True)[..., :10]
    has_root = sign_change.gather(-1, order)
    zl = zgrid[:-1].expand_as(sign_change).gather(-1, order)
    zr = zgrid[1:].expand_as(sign_change).gather(-1, order)
    fl = d[..., :-1].gather(-1, order)
    for _ in range(bisect_iters):
        zm = 0.5 * (zl + zr)
        fm = det_a(zm)
        left = torch.sign(fm) == torch.sign(fl)
        zl = torch.where(left, zm, zl)
        fl = torch.where(left, fm, fl)
        zr = torch.where(left, zr, zm)
    z_root = 0.5 * (zl + zr)  # (..., 10)

    A_root = torch.einsum("...cgp,...rp->...rcg", grouped, _z_powers(z_root))
    v = torch.linalg.svd(A_root).Vh[..., -1, :]  # (..., 10 roots, 10 xy monomials)
    denom = v[..., _IDX_ONE]
    ok_denom = denom.abs() > 1e-6
    denom = torch.where(ok_denom, denom, torch.ones_like(denom))
    x, y = v[..., _IDX_X] / denom, v[..., _IDX_Y] / denom
    xyzw = torch.stack([x, y, z_root, torch.ones_like(x)], dim=-1)  # (..., 10, 4)
    E = torch.einsum("...rk,...kij->...rij", xyzw, XYZW)
    E = E / (torch.linalg.vector_norm(E, dim=(-2, -1), keepdim=True) + 1e-12)
    return E, has_root & ok_denom & torch.isfinite(E).all(-1).all(-1)


# --- nonlinear refinement --------------------------------------------------------


def _sampson_residual(E: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor) -> torch.Tensor:
    """Signed Sampson residual (N,): the square root of sampson_distance with
    the sign of x1^T E x0."""
    Ex0 = x0 @ E.T
    Etx1 = x1 @ E
    x1Ex0 = (x1 * Ex0).sum(-1)
    denom = Ex0[:, 0] ** 2 + Ex0[:, 1] ** 2 + Etx1[:, 0] ** 2 + Etx1[:, 1] ** 2
    return x1Ex0 / torch.sqrt(denom + 1e-15)


def _tangent_basis(t: torch.Tensor) -> torch.Tensor:
    """(3, 2): two directions orthogonal to the unit translation t."""
    a = torch.where(t[0].abs() < 0.9, t.new_tensor([1.0, 0.0, 0.0]),
                    t.new_tensor([0.0, 1.0, 0.0]))
    b1 = torch.linalg.cross(t, a)
    b1 = b1 / (torch.linalg.vector_norm(b1) + 1e-12)
    return torch.stack([b1, torch.linalg.cross(t, b1)], dim=-1)


def _update(R, t, B, delta):
    t_new = t + B @ delta[3:5]
    return R @ so3exp_map(delta[:3]), t_new / (torch.linalg.vector_norm(t_new) + 1e-12)


def refine_pose_sampson(R: torch.Tensor, t: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor,
                        weights: torch.Tensor, iters: int = 8,
                        damping: float = 1e-6) -> tuple[torch.Tensor, torch.Tensor]:
    """Damped Gauss-Newton on the weighted Sampson error over the 5 degrees of
    freedom of a relative pose (so(3) and the tangent of the unit sphere of
    t). x0/x1 (N, 2|3) normalized; weights (N,) >= 0. A step is taken only
    if it lowers the cost and is finite; the Jacobian is forward-mode
    autodiff, as in the JAX package."""
    x0, x1 = _rays(x0), _rays(x1)
    eye = torch.eye(5, dtype=x0.dtype, device=x0.device)
    zero = torch.zeros(5, dtype=x0.dtype, device=x0.device)
    for _ in range(iters):
        B = _tangent_basis(t)

        def residuals(delta, R=R, t=t, B=B):
            R_new, t_new = _update(R, t, B, delta)
            return _sampson_residual(skew_symmetric(t_new) @ R_new, x0, x1)

        r = residuals(zero)
        J = torch.func.jacfwd(residuals)(zero)  # (N, 5)
        Jw = J * weights[:, None]
        delta = -torch.linalg.solve_ex(J.T @ Jw + damping * eye, Jw.T @ r).result
        ok = (((weights * residuals(delta) ** 2).sum() < (weights * r**2).sum())
              & torch.isfinite(delta).all())
        R, t = _update(R, t, B, torch.where(ok, delta, zero))
    return R, t
