"""Two-view to multi-view reconstruction (gluefactory_tpu/sfm/pipeline.py):
pairwise matches -> the chain of relative poses (essential LO-RANSAC, the
scale carried through common keypoints) -> feature tracks (union-find) ->
N-view triangulation -> bundle adjustment.

The orchestration (the chain's scales, the tracks, the observation lists) is
host numpy, as in the JAX package; RANSAC, the triangulation and the bundle
adjustment run on the device."""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

from ..eval.eval_pipeline import synchronize
from ..geometry.wrappers import Camera, Pose
from ..robust_estimators.homography.ransac import sample_minimal_sets
from ..robust_estimators.relative_pose.ransac import ransac_essential
from ..utils.device import resolve_device
from .ba import BAProblem, bundle_adjust
from .triangulation import triangulate_depths, triangulate_linear

logger = logging.getLogger(__name__)


class UnionFind:
    def __init__(self, n: int):
        self.parent = np.arange(n)

    def find(self, x: int) -> int:
        while self.parent[x] != x:
            self.parent[x] = self.parent[self.parent[x]]
            x = self.parent[x]
        return x

    def union(self, a: int, b: int):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[rb] = ra


def build_tracks(matches: dict, num_views: int, num_kpts: int) -> np.ndarray:
    """``matches[(i, j)]`` (N,): the index in view j of view i's keypoint k,
    or -1. Returns the track of each keypoint (V, N) int32, -1 where none;
    only components of two or more keypoints are tracks, numbered [0, T)."""
    uf = UnionFind(num_views * num_kpts)
    for (i, j), m in matches.items():
        m = np.asarray(m)
        for k in np.nonzero(m >= 0)[0]:
            uf.union(i * num_kpts + k, j * num_kpts + int(m[k]))
    roots = np.array([uf.find(x) for x in range(num_views * num_kpts)])
    uniq, inverse, counts = np.unique(roots, return_inverse=True, return_counts=True)
    keep = counts >= 2
    remap = np.full(len(uniq), -1, np.int32)
    remap[keep] = np.arange(keep.sum(), dtype=np.int32)
    return remap[inverse].reshape(num_views, num_kpts)


def ransac_links(rays0: torch.Tensor, rays1: torch.Tensor, valid: torch.Tensor, ths: list,
                 sample_idx: torch.Tensor) -> list:
    """``ransac_essential`` of each chain link, the links of one threshold
    (of one camera) in one batch through ``torch.func.vmap``: rays (L, N, 3),
    valid (L, N), thresholds (L,) in normalised units, minimal sets
    (L, S, 5). Returns each link's (R, t, inliers) as numpy arrays."""
    out = [None] * len(ths)
    for th in sorted(set(ths)):
        links = [i for i, x in enumerate(ths) if x == th]
        sel = torch.tensor(links, device=rays0.device)

        def one(r0, r1, v, idx, th=th):
            return ransac_essential(r0, r1, v, th=th, num_hypotheses=idx.shape[0],
                                    sample_idx=idx)[1:4]

        fits = [x.cpu().numpy() for x in torch.func.vmap(one)(
            rays0[sel], rays1[sel], valid[sel], sample_idx[sel])]
        for k, i in enumerate(links):
            out[i] = tuple(x[k] for x in fits)
    return out


def run_sfm(keypoints: np.ndarray, valid: np.ndarray, matches: dict, cameras: Camera,
            ransac_th: float = 2.0, num_hypotheses: int = 1024, ba_iters: int = 20,
            seed: int = 0, sample_idx: list | None = None,
            device: str | torch.device = "cuda", timings: dict | None = None) -> dict:
    """Incremental SfM over a sequence of V views: keypoints (V, N, 2) pixels,
    valid (V, N), ``matches[(i, i + 1)]`` (N,) and ``cameras`` of batch (V,).
    Each chain link draws its minimal sets from one ``torch.Generator``
    seeded by ``seed`` in turn, unless ``sample_idx`` gives each link's
    (S, 5). ``timings``, when given, receives the ms of each stage, the
    device synchronised at each stage's end. Returns poses (the bundle
    adjustment's), points (P, 3), track_id (V, N), poses_init (the chain's),
    ba_info (its ``costs`` and ``accepted`` read back as numpy) and the
    ``problem`` it solved."""
    device = resolve_device(device)
    V, N = keypoints.shape[:2]
    cameras = cameras.to(device, torch.float32)
    kpts = torch.as_tensor(np.asarray(keypoints), dtype=torch.float32, device=device)
    rays = cameras.image2cam(kpts).cpu().numpy()  # (V, N, 3)
    f_mean = cameras.f.mean(-1).cpu().numpy()
    generator = torch.Generator(device=device).manual_seed(seed)
    clock = time.perf_counter()

    def lap(stage: str):
        nonlocal clock
        if timings is not None:
            synchronize(device)
            timings[stage] = (time.perf_counter() - clock) * 1e3
            clock = time.perf_counter()

    # --- 1. the relative pose of each link of the chain ---------------------------
    r0 = np.zeros((V - 1, N, 3), np.float32)
    r1 = np.zeros((V - 1, N, 3), np.float32)
    link_valid, idx = [], []
    for i in range(V - 1):
        m = np.asarray(matches[(i, i + 1)])
        sel = m >= 0
        r0[i][sel] = rays[i][sel]
        r1[i][sel] = rays[i + 1][np.clip(m, 0, None)][sel]
        link_valid.append(torch.from_numpy(sel & np.asarray(valid[i], bool)).to(device))
        idx.append(sample_minimal_sets(link_valid[-1], num_hypotheses, generator, 5)
                   if sample_idx is None else torch.as_tensor(sample_idx[i], device=device))
    ths = [ransac_th / float(f_mean[i]) for i in range(V - 1)]
    rel_poses = ransac_links(torch.from_numpy(r0).to(device), torch.from_numpy(r1).to(device),
                             torch.stack(link_valid), ths, torch.stack(idx))

    # --- 2. chain the poses, carrying the scale -----------------------------------
    Rs, ts = [np.eye(3, dtype=np.float32)], [np.zeros(3, np.float32)]
    prev_depths: dict[int, float] | None = None
    for i in range(V - 1):
        R_rel, t_rel, inl = rel_poses[i]
        m = np.asarray(matches[(i, i + 1)])
        sel = np.nonzero((m >= 0) & inl)[0]
        r0 = rays[i][sel]
        r1 = rays[i + 1][np.clip(m[sel], 0, None)]
        s_d, u_d = triangulate_depths(*(torch.from_numpy(np.ascontiguousarray(x))[None]
                                        for x in (r0, r1, R_rel, t_rel)))
        s_d, u_d = s_d[0].numpy(), u_d[0].numpy()
        depths_i = {int(k): float(d) for k, d in zip(sel, s_d)}
        if prev_depths is None:
            scale = 1.0
        else:
            # keypoints of view i seen by both links: their depth from the
            # previous link (its u) against this link's (its s)
            ratios = [prev_depths[k] / depths_i[k] for k in depths_i
                      if k in prev_depths and depths_i[k] > 1e-6 and prev_depths[k] > 1e-6]
            scale = float(np.median(ratios)) if len(ratios) >= 3 else 1.0
        Rs.append((R_rel @ Rs[i]).astype(np.float32))
        ts.append((R_rel @ ts[i] + t_rel * scale).astype(np.float32))
        prev_depths = {int(kn): float(u) * scale
                       for kn, u in zip(np.clip(m[sel], 0, None), u_d)}
    poses = Pose(R=torch.from_numpy(np.stack(Rs)).to(device),
                 t=torch.from_numpy(np.stack(ts)).to(device))
    lap("chain_ms")

    # --- 3. tracks and triangulation ----------------------------------------------
    track_id = np.where(valid, build_tracks(matches, V, N), -1)
    T = int(track_id.max()) + 1 if (track_id >= 0).any() else 0
    if T == 0:
        return {"poses": poses, "points": kpts.new_zeros(0, 3), "track_id": track_id}
    v_obs, k_obs = np.nonzero(track_id >= 0)  # view-major, as the JAX package's loops
    t_obs = track_id[v_obs, k_obs]
    obs_uv = np.zeros((T, V, 2), np.float32)
    obs_mask = np.zeros((T, V), bool)
    # a track's first keypoint in a view triangulates (a view may hold several)
    _, keep = np.unique(t_obs * V + v_obs, return_index=True)
    obs_uv[t_obs[keep], v_obs[keep]] = np.asarray(keypoints)[v_obs[keep], k_obs[keep]]
    obs_mask[t_obs[keep], v_obs[keep]] = True
    points = triangulate_linear(poses, cameras, torch.from_numpy(obs_uv).to(device),
                                torch.from_numpy(obs_mask).to(device))
    lap("tracks_ms")

    # --- 4. bundle adjustment ------------------------------------------------------
    fixed = torch.zeros(V, dtype=torch.bool, device=device)
    fixed[0] = True  # the gauge: camera 0 only (fixing camera 1 too froze the error of
    # the first link into the solution); the scale is left to the damping and to the
    # Sim(3)-aligned ATE
    problem = BAProblem(
        poses=poses, cameras=cameras, points=points,
        obs_cam=torch.from_numpy(v_obs).to(device),
        obs_pt=torch.from_numpy(t_obs.astype(np.int64)).to(device),
        obs_uv=torch.from_numpy(np.asarray(keypoints, np.float32)[v_obs, k_obs]).to(device),
        obs_valid=torch.ones(len(v_obs), dtype=torch.bool, device=device),
        fixed_cams=fixed)
    # Huber at 1 px: at 3 px it kept near-full weight on 1-3 px biased observations
    # (mislocalised repeated texture) and pulled the poses away from the truth while
    # the cost fell; with 40 iterations and the camera-0 gauge it lowers the ATE
    poses_opt, points_opt, info = bundle_adjust(problem, num_iters=ba_iters, huber_delta=1.0,
                                                trim_th=20.0)
    info = {k: v.cpu().numpy() for k, v in info.items()}
    lap("ba_ms")
    logger.info("SfM: %d views, %d tracks, %d obs; BA cost %.4g -> %.4g", V, T, len(v_obs),
                info["costs"][0], info["costs"][-1])
    return {"poses": poses_opt, "points": points_opt, "track_id": track_id,
            "poses_init": poses, "ba_info": info, "problem": problem}
