"""Bundle adjustment by Levenberg-Marquardt on the Schur complement
(gluefactory_tpu/sfm/ba.py, its single-device path).

Camera poses (se(3), left perturbation) and 3D points under robust Huber
reprojection errors, the intrinsics held fixed:

  - the observations are flat arrays (obs_cam, obs_pt, obs_uv, obs_valid);
    every per-observation quantity (residual, Jacobians, Hessian blocks) is
    one batched product, and the blocks are summed per camera, per point and
    per (point, camera) by ``index_add_``;
  - the reduced camera system S = U - W V^-1 W^T is assembled densely over
    the few cameras and solved; the point block V is block-diagonal 3x3 and
    inverted in one batch, and the points follow by back-substitution.

``bundle_adjust`` runs its iterations as a loop that never waits on the
host (on the card, one captured CUDA graph replayed): the accept/reject
decision and the damping stay on the device, and the costs are read once,
by the caller. The data-distributed
``bundle_adjust_sharded`` of the JAX package is not ported."""

from __future__ import annotations

import dataclasses

import torch

from ..geometry.utils import skew_symmetric
from ..geometry.wrappers import Camera, Pose


@dataclasses.dataclass(frozen=True)
class BAProblem:
    poses: Pose  # (M,) world to camera
    cameras: Camera  # (M,)
    points: torch.Tensor  # (P, 3) world
    obs_cam: torch.Tensor  # (O,) int64
    obs_pt: torch.Tensor  # (O,) int64
    obs_uv: torch.Tensor  # (O, 2) pixels
    obs_valid: torch.Tensor  # (O,) bool
    fixed_cams: torch.Tensor  # (M,) bool, the gauge

    def to(self, device=None, dtype=None) -> "BAProblem":
        """The problem on ``device``, its real tensors in ``dtype``."""
        return BAProblem(self.poses.to(device, dtype), self.cameras.to(device, dtype),
                         self.points.to(device, dtype), self.obs_cam.to(device),
                         self.obs_pt.to(device), self.obs_uv.to(device, dtype),
                         self.obs_valid.to(device), self.fixed_cams.to(device))

    @property
    def num_cams(self) -> int:
        return self.poses.R.shape[0]

    @property
    def num_points(self) -> int:
        return self.points.shape[0]


def _observed_cameras(problem: BAProblem) -> Camera:
    """The camera of each observation (O,)."""
    cams, i = problem.cameras, problem.obs_cam
    return Camera(size=cams.size[i], f=cams.f[i], c=cams.c[i], dist=cams.dist[i])


def _project(problem: BAProblem, cam_o: Camera, poses: Pose, points: torch.Tensor):
    """(the observations' poses, camera-frame points (O, 3), residuals (O, 2),
    their norms (O,), whether each observation counts (O,))."""
    T_o = poses[problem.obs_cam]
    p_cam = (T_o.R @ points[problem.obs_pt][:, :, None])[..., 0] + T_o.t  # (O, 3)
    uv_pred, visible = cam_o.cam2image(p_cam[:, None, :])
    r = uv_pred[:, 0] - problem.obs_uv  # (O, 2)
    valid = problem.obs_valid & visible[:, 0] & (p_cam[:, 2] > 1e-3)
    return T_o, p_cam, r, torch.linalg.vector_norm(r, dim=-1), valid


def _robust_cost(rn: torch.Tensor, valid: torch.Tensor, huber_delta: float,
                 trim_th: float | None) -> torch.Tensor:
    """The Huber cost of the residual norms, the trimmed ones and the invalid
    ones left out."""
    in_cost = valid.to(rn.dtype)
    if trim_th is not None:
        in_cost = in_cost * (rn <= trim_th).to(rn.dtype)
    huber = torch.where(rn <= huber_delta, 0.5 * rn**2, huber_delta * (rn - 0.5 * huber_delta))
    return (huber * in_cost).sum()


def _residuals_and_jacobians(problem: BAProblem, poses: Pose, points: torch.Tensor,
                             huber_delta: float, trim_th: float | None = None,
                             cam_o: Camera | None = None):
    """Residuals (O, 2), robust weights (O,), J_cam (O, 2, 6), J_pt (O, 2, 3)
    and the robust cost."""
    cam_o = _observed_cameras(problem) if cam_o is None else cam_o
    T_o, p_cam, r, rn, valid = _project(problem, cam_o, poses, points)
    w = torch.where(rn <= huber_delta, 1.0, huber_delta / rn.clamp_min(1e-12))
    if trim_th is not None:
        # a hard trim of gross outliers: Huber alone still lets them bias the
        # solution when they are a sizable share of the observations
        w = torch.where(rn > trim_th, 0.0, w)
    w = torch.where(valid, w, 0.0)
    J_px = cam_o.J_world2image(p_cam[:, None, :])[:, 0]  # (O, 2, 3)
    # left perturbation: d p_cam = [-[p_cam]x | I] (omega, v)
    eye = torch.eye(3, dtype=r.dtype, device=r.device).expand(r.shape[0], 3, 3)
    J_pose = torch.cat([-skew_symmetric(p_cam), eye], dim=-1)  # (O, 3, 6)
    J_cam = J_px @ J_pose  # (O, 2, 6)
    J_pt = J_px @ T_o.R  # (O, 2, 3)
    return r, w, J_cam, J_pt, _robust_cost(rn, valid, huber_delta, trim_th)


def _block_aggregates(problem: BAProblem, r, w, J_cam, J_pt):
    """The normal equations' blocks: U (M, 6, 6), V (P, 3, 3), bc (M, 6),
    bp (P, 3) and Apc (P, M, 6, 3), the sum of W_o over the observations of
    point p by camera c."""
    M, P = problem.num_cams, problem.num_points
    Wr = w[:, None] * r
    wJ_cam = w[:, None, None] * J_cam
    U_o = wJ_cam.transpose(1, 2) @ J_cam  # (O, 6, 6)
    V_o = (w[:, None, None] * J_pt).transpose(1, 2) @ J_pt  # (O, 3, 3)
    W_o = wJ_cam.transpose(1, 2) @ J_pt  # (O, 6, 3)
    bc_o = -(J_cam.transpose(1, 2) @ Wr[..., None])[..., 0]  # (O, 6)
    bp_o = -(J_pt.transpose(1, 2) @ Wr[..., None])[..., 0]  # (O, 3)
    cam, pt = problem.obs_cam, problem.obs_pt
    U = r.new_zeros(M, 6, 6).index_add_(0, cam, U_o)
    V = r.new_zeros(P, 3, 3).index_add_(0, pt, V_o)
    bc = r.new_zeros(M, 6).index_add_(0, cam, bc_o)
    bp = r.new_zeros(P, 3).index_add_(0, pt, bp_o)
    Apc = r.new_zeros(P * M, 6, 3).index_add_(0, pt * M + cam, W_o).view(P, M, 6, 3)
    return U, V, bc, bp, Apc


def _damped(B: torch.Tensor, lm_lambda: torch.Tensor) -> torch.Tensor:
    """B + lambda (diag(B) + 1e-6 I), the LM damping of blocks (..., n, n)."""
    eye = torch.eye(B.shape[-1], dtype=B.dtype, device=B.device)
    return B + lm_lambda * (torch.diag_embed(B.diagonal(dim1=-2, dim2=-1)) + 1e-6 * eye)


def _schur_solve(problem: BAProblem, U, V, bc, bp, Apc, lm_lambda):
    """Form and solve the reduced camera system, then back-substitute the
    points: (dxc (M, 6), dxp (P, 3))."""
    M = problem.num_cams
    U_d, V_d = _damped(U, lm_lambda), _damped(V, lm_lambda)
    eye3 = torch.eye(3, dtype=V.dtype, device=V.device)
    Vinv = torch.linalg.inv_ex(V_d + 1e-9 * eye3)[0]
    Y = torch.einsum("pmik,pkl->pmil", Apc, Vinv)  # (P, M, 6, 3)
    S_cross = torch.einsum("pmik,pnjk->minj", Y, Apc)
    b_cross = torch.einsum("pmik,pk->mi", Y, bp)
    arange = torch.arange(M, device=U.device)
    S = U.new_zeros(M, 6, M, 6)
    S[arange, :, arange, :] = U_d
    S = S - S_cross
    rhs = bc - b_cross
    # the gauge: identity rows and columns for the fixed cameras
    free = (~problem.fixed_cams).to(S.dtype)
    S = S * (free[:, None, None, None] * free[None, None, :, None])
    S[arange, :, arange, :] += (1.0 - free)[:, None, None] * torch.eye(
        6, dtype=S.dtype, device=S.device)
    rhs = rhs * free[:, None]
    Sd = S.reshape(6 * M, 6 * M) + 1e-8 * torch.eye(6 * M, dtype=S.dtype, device=S.device)
    dxc = torch.linalg.solve_ex(Sd, rhs.reshape(-1, 1))[0].reshape(M, 6)
    dxp = (Vinv @ (bp - torch.einsum("pmik,mi->pk", Apc, dxc))[..., None])[..., 0]
    return dxc, dxp


def _cost_only(problem: BAProblem, poses: Pose, points: torch.Tensor, huber_delta: float,
               trim_th: float | None = None, cam_o: Camera | None = None) -> torch.Tensor:
    cam_o = _observed_cameras(problem) if cam_o is None else cam_o
    _, _, _, rn, valid = _project(problem, cam_o, poses, points)
    return _robust_cost(rn, valid, huber_delta, trim_th)


def lm_step(problem: BAProblem, poses: Pose, points: torch.Tensor, lam: torch.Tensor,
            huber_delta: float, trim_th: float | None = None, cam_o: Camera | None = None):
    """One LM iteration: (poses, points, lambda, the cost after it, whether
    the step was taken), all on the device."""
    cam_o = _observed_cameras(problem) if cam_o is None else cam_o
    r, w, J_cam, J_pt, cost = _residuals_and_jacobians(problem, poses, points, huber_delta,
                                                       trim_th, cam_o)
    dxc, dxp = _schur_solve(problem, *_block_aggregates(problem, r, w, J_cam, J_pt), lam)
    new_poses = poses.retract_left(dxc)
    new_points = points + dxp
    new_cost = _cost_only(problem, new_poses, new_points, huber_delta, trim_th, cam_o)
    accept = (new_cost < cost) & torch.isfinite(new_cost)
    poses = Pose(R=torch.where(accept, new_poses.R, poses.R),
                 t=torch.where(accept, new_poses.t, poses.t))
    points = torch.where(accept, new_points, points)
    lam = torch.where(accept, (lam * 0.5).clamp_min(1e-9), (lam * 4.0).clamp_max(1e6))
    return poses, points, lam, torch.where(accept, new_cost, cost), accept


def bundle_adjust(problem: BAProblem, num_iters: int = 20, huber_delta: float = 3.0,
                  init_lambda: float = 1e-3, trim_th: float | None = None
                  ) -> tuple[Pose, torch.Tensor, dict]:
    """LM bundle adjustment on the problem's device: (poses, points, info),
    info's ``costs`` (num_iters,) the cost after each iteration, ``accepted``
    (num_iters,) whether its step was taken, and ``final_lambda``. On the
    card one iteration is captured as a CUDA graph and replayed: eagerly the
    host launches ~350 kernels an iteration for ~0.7 ms of device work."""
    cam_o = _observed_cameras(problem)
    lam = torch.tensor(init_lambda, dtype=problem.points.dtype, device=problem.points.device)
    if problem.points.is_cuda:
        return _bundle_adjust_graphed(problem, cam_o, lam, num_iters, huber_delta, trim_th)
    poses, points = problem.poses, problem.points
    costs, accepted = [], []
    for _ in range(num_iters):
        poses, points, lam, cost, accept = lm_step(problem, poses, points, lam, huber_delta,
                                                   trim_th, cam_o)
        costs.append(cost)
        accepted.append(accept)
    return poses, points, {"costs": torch.stack(costs), "accepted": torch.stack(accepted),
                           "final_lambda": lam}


def _bundle_adjust_graphed(problem: BAProblem, cam_o: Camera, lam: torch.Tensor,
                           num_iters: int, huber_delta: float, trim_th: float | None):
    """``bundle_adjust``'s loop on the card: the state (poses, points,
    lambda) and the costs live in static tensors that one captured
    iteration reads and writes, replayed ``num_iters`` times."""
    R, t, points = problem.poses.R.clone(), problem.poses.t.clone(), problem.points.clone()
    state = (R, t, points, lam)
    start = tuple(x.clone() for x in state)
    costs = points.new_zeros(num_iters)
    accepted = torch.zeros(num_iters, dtype=torch.bool, device=points.device)
    it = torch.zeros(1, dtype=torch.long, device=points.device)

    def step():
        poses, new_points, new_lam, cost, accept = lm_step(
            problem, Pose(R, t), points, lam, huber_delta, trim_th, cam_o)
        for old, new in zip(state, (poses.R, poses.t, new_points, new_lam)):
            old.copy_(new)
        costs.index_copy_(0, it, cost[None])
        accepted.index_copy_(0, it, accept[None])
        it.add_(1)

    # one eager step on a side stream first (library handles, workspaces), as
    # torch.cuda.graphs asks, then the state back to the start
    side = torch.cuda.Stream(points.device)
    side.wait_stream(torch.cuda.current_stream(points.device))
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream(points.device).wait_stream(side)
    for x, x0 in zip(state, start):
        x.copy_(x0)
    it.zero_()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        step()
    for _ in range(num_iters):
        graph.replay()
    return Pose(R, t), points, {"costs": costs, "accepted": accepted, "final_lambda": lam}


def bundle_adjust_sharded(*args, **kwargs):
    """The JAX package's data-distributed BA (observations sharded over a
    mesh axis, the blocks summed across devices) is not ported: it needs
    several devices, and the multi-card work is ROADMAP queue 1 item 7,
    beside DDP."""
    raise NotImplementedError(
        "bundle_adjust_sharded is not ported (it shards the observations over several "
        "devices; see ROADMAP.md queue 1 item 7, beside DDP): use bundle_adjust")
