"""The trajectory benchmark (gluefactory_tpu/scripts/sfm_trajectory.py):
rendered multi-view scenes -> a two-view matcher -> incremental SfM
(``sfm.pipeline.run_sfm``: the chain of essential LO-RANSAC poses with the
scale carried along, triangulation, Schur-complement bundle adjustment) ->
the trajectory error against the exact rendered poses.

A scene is the piecewise-planar world of ``generate_pose_eval_set`` (one
homography a plane keeps K, R and t exact while giving real parallax); the
camera advances along a smooth arc, so that consecutive views overlap as in
a video. The seeds and draws are the JAX script's; the views are PPM (the
JAX script writes PNG with cv2).

    python -m gluefactory_torch.scripts.sfm_trajectory --render
        [--out trajectory-eval] [--scenes 4] [--views 8]
    python -m gluefactory_torch.scripts.sfm_trajectory --tag port_sift_lg_stage2
        --conf sift_lg_stage2 [--device cpu]

``--conf`` takes a run of ``recipes.TRAJECTORY_CONFS`` by name (its card and
blob), or a model card's file (JSON, or YAML where ``yaml`` imports); without
it, SIFT+LightGlue at ``--max_kpts``. ``--checkpoint`` names the blob
otherwise. The run writes outputs/results/trajectory/<tag>/summaries.json:
per scene the Sim(3)-aligned ATE before and after the bundle adjustment, the
trajectory's extent, the matches a pair and the BA's first and last cost,
and their means, with the JAX script's keys. It refuses a tag whose
summaries.json exists: the repository commits the JAX package's runs there
under their run names.
"""

from __future__ import annotations

import argparse
import json
import logging
import time
from pathlib import Path

import numpy as np
import torch

from .. import settings
from ..eval.eval_pipeline import synchronize
from ..datasets.homographies import generate_structured_image
from ..utils.image import read_image, write_image
from .generate_pose_eval_set import _rotation, composite_view, make_planar_world

logger = logging.getLogger(__name__)

DEFAULT_OUT = "trajectory-eval"


# --- rendering --------------------------------------------------------------------------

def render_trajectory_scene(out_dir: Path, rng: np.random.Generator, size=(640, 480),
                            n_planes: int = 4, n_views: int = 8, step_rot_deg: float = 4.0,
                            step_t: float = 0.12) -> None:
    """Render ``n_views`` views {k}.ppm along a smooth arc through a
    piecewise-planar world, and poses.json (K, size, T_0tok as 4x4 lists)."""
    w, h = size
    out_dir.mkdir(parents=True, exist_ok=True)
    img0_u8 = (generate_structured_image(rng, (w, h)) * 255).astype(np.uint8)
    write_image(out_dir / "0.ppm", img0_u8)
    Kmat, edges, planes = make_planar_world(rng, (w, h), n_planes)
    # a small fixed rotation a step and a slowly turning direction of travel
    R_step = _rotation(rng, step_rot_deg)
    t_dir = rng.normal(size=3)
    t_dir /= np.linalg.norm(t_dir)
    poses = [np.eye(4)]
    R_cur, t_cur = np.eye(3), np.zeros(3)
    for k in range(1, n_views):
        R_cur = R_step @ R_cur
        t_cur = t_cur + R_step @ (step_t * t_dir)
        t_dir = t_dir + 0.15 * rng.normal(size=3)
        t_dir /= np.linalg.norm(t_dir)
        T = np.eye(4)
        T[:3, :3] = R_cur
        T[:3, 3] = t_cur
        poses.append(T)
        write_image(out_dir / f"{k}.ppm",
                    composite_view(img0_u8, Kmat, planes, edges, R_cur, t_cur, rng,
                                   gain_range=(0.92, 1.08), bias_range=(-6, 6)))
    meta = {"K": Kmat.tolist(), "size": [w, h], "poses_0tok": [T.tolist() for T in poses]}
    (out_dir / "poses.json").write_text(json.dumps(meta))


def render_scene_job(out: Path, seed: int, scene: int, views: int) -> None:
    """Scene ``scene`` of the set of ``seed`` under ``out`` (one job of a
    process pool; the random stream is the scene's own)."""
    render_trajectory_scene(Path(out) / f"scene_{scene}",
                            np.random.default_rng((737373, seed, scene)), n_views=views)


def render(out: Path, scenes: int, views: int, seed: int = 0) -> None:
    for s in range(scenes):
        render_scene_job(out, seed, s, views)
        logger.info("Rendered %s (%d views)", out / f"scene_{s}", views)


# --- matching and SfM -------------------------------------------------------------------

def model_conf(conf: str | None, checkpoint: str | None, max_kpts: int = 1024
               ) -> tuple[dict, str | None]:
    """(model card, blob) of the CLI's ``--conf`` and ``--checkpoint``: a run
    of ``recipes.TRAJECTORY_CONFS`` by name, a card's file, or the default
    SIFT+LightGlue card; ``checkpoint`` replaces the run's blob."""
    from ..core.config import load_conf, merge
    from ..recipes import TRAJECTORY_CONFS, trajectory_conf, trajectory_sift_lg_card

    if conf is None:
        return trajectory_sift_lg_card(max_kpts), checkpoint
    if conf in TRAJECTORY_CONFS:
        run = trajectory_conf(conf)
        return run["model"], checkpoint or run["checkpoint"]
    card = load_conf(conf)
    return merge(card.get("model", card), {"ground_truth": {"name": None},
                                           "run_gt_in_forward": False}), checkpoint


def build_pipeline(conf: str | None, checkpoint: str | None, max_kpts: int = 1024,
                   device: str | torch.device = "cuda") -> torch.nn.Module:
    from ..eval.io import load_model

    card, blob = model_conf(conf, checkpoint, max_kpts)
    if blob and not Path(blob).is_absolute():
        blob = str(settings.ROOT_PATH / blob)
    return load_model(card, blob, device).eval()


def match_scene(scene_dir: Path, model, device) -> tuple:
    """Each consecutive pair of the scene through ``model``: (keypoints
    (V, N, 2), valid (V, N), matches {(i, i + 1): (N,)}, poses.json's
    contents). Raises where a view's keypoints differ between its two pairs:
    the chain needs a detector of each image, and a detector-free matcher
    (LoFTR) places its keypoints by the pair."""
    meta = json.loads((scene_dir / "poses.json").read_text())
    w, h = meta["size"]
    V = len(meta["poses_0tok"])
    images = [torch.from_numpy(read_image(scene_dir / f"{k}.ppm").astype(np.float32) / 255.0)
              .to(device)[None] for k in range(V)]
    size = torch.tensor([[w, h]], dtype=torch.float32, device=device)
    kpts, valid, matches = [None] * V, [None] * V, {}
    for i in range(V - 1):
        with torch.inference_mode():
            pred = model({"view0": {"image": images[i], "image_size": size},
                          "view1": {"image": images[i + 1], "image_size": size}})
        k0 = pred["keypoints0"][0].float().cpu().numpy()
        if kpts[i] is not None:
            dev = float(np.abs(kpts[i] - k0).max())
            if dev > 1e-3:
                raise RuntimeError(
                    f"view {i}: keypoints differ between consecutive pairs (max dev "
                    f"{dev:.2f}px) — the model card's detections are pair-dependent "
                    "(detector-free matcher?); the trajectory chain needs a per-image detector")
        kpts[i] = k0
        kpts[i + 1] = pred["keypoints1"][0].float().cpu().numpy()
        for v, key in ((i, "keypoint_valid0"), (i + 1, "keypoint_valid1")):
            valid[v] = (pred[key][0].cpu().numpy() > 0 if key in pred
                        else np.ones(kpts[v].shape[0], bool))
        matches[(i, i + 1)] = pred["matches0"][0].cpu().numpy().astype(int)
    return np.stack(kpts), np.stack(valid), matches, meta


def run_scene(scene_dir: Path, model, device: str | torch.device = "cuda", seed: int = 0,
              timings: dict | None = None, details: dict | None = None) -> dict:
    """One scene: the pairs through ``model``, then ``score_scene``.
    ``timings``, when given, receives the ms of the pairs' forward and of
    each SfM stage; ``details`` the keypoints, their validity, the matches,
    poses.json's contents and ``run_sfm``'s output."""
    device = torch.device(device)
    t = time.perf_counter()
    kpts, valid, matches, meta = match_scene(Path(scene_dir), model, device)
    if timings is not None:
        synchronize(device)
        timings["forward_ms"] = (time.perf_counter() - t) * 1e3
    if details is not None:
        details.update(keypoints=kpts, valid=valid, matches=matches, meta=meta)
    return score_scene(kpts, valid, matches, meta, device, seed, timings, details)


def score_scene(kpts: np.ndarray, valid: np.ndarray, matches: dict, meta: dict,
                device: str | torch.device = "cuda", seed: int = 0,
                timings: dict | None = None, details: dict | None = None) -> dict:
    """``run_sfm`` (2 px, 1024 hypotheses, 40 BA iterations, RANSAC seed
    ``seed``) on a scene's matched keypoints, and the ATE after Sim(3)
    alignment before and after the BA, with the JAX script's keys."""
    from ..geometry.wrappers import Camera, Pose
    from ..sfm.alignment import absolute_trajectory_error, camera_centers
    from ..sfm.pipeline import run_sfm

    V = len(meta["poses_0tok"])
    w, h = meta["size"]
    K = torch.tensor(meta["K"], dtype=torch.float32)
    cams = Camera.from_calibration_matrix(K[None].expand(V, 3, 3).contiguous(),
                                          size=torch.tensor([[float(w), float(h)]]).expand(V, 2))
    out = run_sfm(kpts, valid, matches, cams, ransac_th=2.0, num_hypotheses=1024,
                  ba_iters=40, seed=seed, device=device, timings=timings)
    if details is not None:
        details.update(cameras=cams, sfm=out)
    poses_gt = Pose.from_4x4mat(torch.tensor(meta["poses_0tok"], dtype=torch.float32))
    centers = camera_centers(poses_gt)
    costs = out["ba_info"]["costs"]
    return {
        "ate": absolute_trajectory_error(out["poses"], poses_gt),
        "ate_init": absolute_trajectory_error(out["poses_init"], poses_gt),
        "extent": float(np.linalg.norm(centers - centers.mean(0), axis=-1).max()),
        "n_matches_mean": float(np.mean([(m > -1).sum() for m in matches.values()])),
        "ba_cost_first": float(costs[0]),
        "ba_cost_last": float(costs[-1]),
    }


def summarize(per_scene: dict, checkpoint: str | None, views: int) -> dict:
    """The summaries of the JAX script: mean and median ATE over the scenes
    (absolute and of each scene's extent) and the scenes whose BA made the
    ATE worse than 1.5 times the chain's (modulo 0.2% of the extent)."""
    ates = np.array([r["ate"] for r in per_scene.values()])
    ates_rel = np.array([r["ate"] / r["extent"] for r in per_scene.values()])
    ba_regressions = [k for k, r in per_scene.items()
                      if r["ate"] > max(r["ate_init"] * 1.5, 0.002 * r["extent"])]
    if ba_regressions:
        logger.warning("BA regressed ATE on scenes %s (> 1.5x init)", ba_regressions)
    return {
        "ba_regressions": ba_regressions,
        "mATE": round(float(ates.mean()), 4),
        "mATE_norm": round(float(ates_rel.mean()), 4),
        "medATE_norm": round(float(np.median(ates_rel)), 4),
        "scenes": {k: {kk: round(vv, 4) for kk, vv in v.items()} for k, v in per_scene.items()},
        "checkpoint": checkpoint,
        "views": views,
    }


def main(argv: list[str] | None = None):
    from ..utils.device import resolve_device

    ap = argparse.ArgumentParser()
    ap.add_argument("--render", action="store_true")
    ap.add_argument("--out", type=str, default=DEFAULT_OUT)
    ap.add_argument("--scenes", type=int, default=4)
    ap.add_argument("--views", type=int, default=8)
    ap.add_argument("--tag", type=str, default="default")
    ap.add_argument("--checkpoint", type=str, default=None)
    ap.add_argument("--conf", type=str, default=None,
                    help="a run of recipes.TRAJECTORY_CONFS or a model card's file "
                         "(default: SIFT+LightGlue)")
    ap.add_argument("--max_kpts", type=int, default=1024)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)

    root = Path(args.out)
    if not root.is_absolute():
        root = settings.DATA_PATH / root
    if args.render:
        render(root, args.scenes, args.views)
        return

    out_dir = settings.EVAL_PATH / "trajectory" / args.tag
    if (out_dir / "summaries.json").exists():
        raise FileExistsError(
            f"{out_dir / 'summaries.json'} exists (the repository commits the JAX package's "
            "runs under their names): pick another --tag, or remove the file")
    device = resolve_device(args.device)
    _, checkpoint = model_conf(args.conf, args.checkpoint, args.max_kpts)
    model = build_pipeline(args.conf, args.checkpoint, args.max_kpts, device)
    per_scene = {}
    for sd in sorted(d for d in root.iterdir() if d.is_dir()):
        res = per_scene[sd.name] = run_scene(sd, model, device)
        logger.info("%s: ATE %.4f (init %.4f, extent %.2f) matches %.0f", sd.name, res["ate"],
                    res["ate_init"], res["extent"], res["n_matches_mean"])
    summary = summarize(per_scene, checkpoint, args.views)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "summaries.json").write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary))


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
