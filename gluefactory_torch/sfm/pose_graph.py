"""Pose-graph optimization (gluefactory_tpu/sfm/pose_graph.py):
Levenberg-Marquardt over SE(3) nodes under relative-pose edges,

  residual(e) = Log(T_meas_ij^-1 o (T_j o T_i^-1))   (world-to-camera poses),

with the Jacobian of the batched residual at a zero left perturbation taken
by ``torch.func.jacrev`` (JAX's ``jax.jacobian``), Huber weights on the edge
errors and the dense (6M, 6M) system solved on the device."""

from __future__ import annotations

import torch

from ..geometry.wrappers import Pose


def _edge_residual(poses: Pose, edge_i, edge_j, meas: Pose) -> torch.Tensor:
    """(E, 6) tangent residuals."""
    T_ij = poses[edge_j].compose(poses[edge_i].inv())  # camera i to camera j
    rel = meas.inv().compose(T_ij)
    return Pose.identity((rel.R.shape[0],), rel.R.dtype, rel.R.device).local(rel)


def _huber_cost(r: torch.Tensor, huber_delta: float, edge_weight: torch.Tensor) -> torch.Tensor:
    rn = torch.linalg.vector_norm(r, dim=-1)
    return (torch.where(rn <= huber_delta, 0.5 * rn**2, huber_delta * (rn - 0.5 * huber_delta))
            * edge_weight).sum()


def optimize_pose_graph(poses: Pose, edge_i: torch.Tensor, edge_j: torch.Tensor, meas: Pose,
                        edge_weight: torch.Tensor | None = None,
                        fixed: torch.Tensor | None = None, num_iters: int = 20,
                        huber_delta: float = 0.5, init_lambda: float = 1e-4
                        ) -> tuple[Pose, dict]:
    """Nodes ``poses`` (M,), edges (E,) as index arrays and measured relative
    poses: (the optimized poses, {"costs": (num_iters,)}). Node 0 is fixed
    unless ``fixed`` (M,) says otherwise."""
    M, E = poses.R.shape[0], edge_i.shape[0]
    dtype, device = poses.R.dtype, poses.R.device
    if edge_weight is None:
        edge_weight = torch.ones(E, dtype=dtype, device=device)
    if fixed is None:
        fixed = torch.zeros(M, dtype=torch.bool, device=device)
        fixed[0] = True
    free = (~fixed).repeat_interleave(6).to(dtype)
    eye = torch.eye(6 * M, dtype=dtype, device=device)
    lam = torch.tensor(init_lambda, dtype=dtype, device=device)
    costs = []
    for _ in range(num_iters):
        r = _edge_residual(poses, edge_i, edge_j, meas)  # (E, 6)
        rn = torch.linalg.vector_norm(r, dim=-1)
        w = torch.where(rn <= huber_delta, 1.0, huber_delta / rn.clamp_min(1e-12)) * edge_weight
        cost = _huber_cost(r, huber_delta, edge_weight)

        def residual_flat(x6, base=poses):
            return _edge_residual(base.retract_left(x6.reshape(M, 6)), edge_i, edge_j,
                                  meas).reshape(-1)

        J = torch.func.jacrev(residual_flat)(poses.R.new_zeros(6 * M)).reshape(E, 6, 6 * M)
        JW = J * w[:, None, None]
        H = torch.einsum("eik,eil->kl", JW, J)
        g = -torch.einsum("eik,ei->k", JW, r)
        # the gauge
        H = H * free[:, None] * free[None, :] + torch.diag(1.0 - free)
        g = g * free
        H = H + lam * torch.diag(torch.diag(H)) + 1e-9 * eye
        dx = torch.linalg.solve_ex(H, g[:, None])[0][:, 0]
        new_poses = poses.retract_left(dx.reshape(M, 6))
        new_cost = _huber_cost(_edge_residual(new_poses, edge_i, edge_j, meas), huber_delta,
                               edge_weight)
        accept = (new_cost < cost) & torch.isfinite(new_cost)
        poses = Pose(R=torch.where(accept, new_poses.R, poses.R),
                     t=torch.where(accept, new_poses.t, poses.t))
        lam = torch.where(accept, (lam * 0.5).clamp_min(1e-9), (lam * 4.0).clamp_max(1e6))
        costs.append(torch.where(accept, new_cost, cost))
    return poses, {"costs": torch.stack(costs)}
