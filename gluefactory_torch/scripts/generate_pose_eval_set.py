"""Render a relative-pose benchmark in the MegaDepth-1500 calibrated-pairs
format (gluefactory_tpu/scripts/generate_pose_eval_set.py), in numpy.

Each scene is piecewise planar: vertical strips of a procedural colour image
(``datasets.homographies.generate_structured_image``) lie on slanted planes
at different depths. A second view at (R, t) renders exactly by one
homography per plane, H_i = K (R + t n_i^T / d_i) K^-1, composited far to
near, and the depths give real parallax, so no single homography explains a
pair. K, R and t are exact by construction. Written as

    <out>/images/scene<s>/{0,1,...}.ppm  +  <out>/pairs_calibrated.txt

with one line a pair: ``im0 im1 K0(9) K1(9) T_0to1(16)``, T_0to1 mapping
camera-0 coordinates to camera 1 (X1 = R X0 + t), numbers as ``%.8g``.

The seeds, draws and numbers are the JAX script's; the images are PPM (the
JAX script writes PNG with cv2) and agree with its pixels within the
tolerances of ``tests/test_torch_pose_eval.py``.

Usage: python -m gluefactory_torch.scripts.generate_pose_eval_set
          [--out data/pose-eval] [--num_scenes 10] [--pairs_per_scene 2]
          [--seed 31415]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from ..datasets.homographies import generate_structured_image
from ..settings import DATA_PATH
from ..utils.image import warp_perspective, write_image


def _rotation(rng: np.random.Generator, max_deg: float) -> np.ndarray:
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    ang = np.deg2rad(rng.uniform(0.3 * max_deg, max_deg))
    K = np.array([[0, -axis[2], axis[1]],
                  [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(ang) * K + (1 - np.cos(ang)) * K @ K


def _plane_homography(Kmat, R, t, n, d):
    """View-0 pixels on the plane {n^T X = d} (camera-0 coordinates) to
    view-1 pixels, with X1 = R X0 + t."""
    return Kmat @ (R + np.outer(t, n) / d) @ np.linalg.inv(Kmat)


def _check_convention(Kmat, R, t, n, d, rng):
    """Project points of the plane into both views and compare with the
    homography; returns (H, the nearest depth)."""
    H = _plane_homography(Kmat, R, t, n, d)
    px = rng.uniform([100, 100], [500, 380], (16, 2))
    rays = np.linalg.inv(Kmat) @ np.c_[px, np.ones(len(px))].T  # (3, N)
    depth = d / (n @ rays)
    X1 = R @ (rays * depth) + t[:, None]
    proj1 = Kmat @ X1
    proj1 = (proj1[:2] / proj1[2]).T
    warped = H @ np.c_[px, np.ones(len(px))].T
    warped = (warped[:2] / warped[2]).T
    err = np.abs(warped - proj1).max()
    assert err < 1e-6, f"homography/pose convention broke: {err}"
    return H, float(depth.min())


def make_planar_world(rng: np.random.Generator, size, n_planes: int):
    """(K, strip edges, [(normal, depth)] of each plane) of a scene."""
    w, h = size
    f = 0.9 * w
    Kmat = np.array([[f, 0, w / 2.0], [0, f, h / 2.0], [0, 0, 1.0]])
    edges = np.linspace(0, w, n_planes + 1).astype(int)
    depths = rng.permutation(np.linspace(4.0, 9.0, n_planes))
    planes = []
    for i in range(n_planes):
        tilt = rng.uniform(-0.25, 0.25, size=2)
        n = np.array([tilt[0], tilt[1], 1.0])
        planes.append((n / np.linalg.norm(n), float(depths[i])))
    return Kmat, edges, planes


def composite_view(img0_u8: np.ndarray, Kmat: np.ndarray, planes, edges,
                   R: np.ndarray, t: np.ndarray, rng: np.random.Generator,
                   gain_range=(0.9, 1.1), bias_range=(-8, 8)) -> np.ndarray:
    """The uint8 view at (R, t): each plane's strip warped by its homography,
    far to near, then a gain, a bias and noise; pixels that no plane covers
    stay 0."""
    h, w = img0_u8.shape[:2]
    img1 = np.zeros_like(img0_u8)
    filled = np.zeros((h, w), bool)
    for pi in np.argsort([-d for _, d in planes]):
        n, d = planes[pi]
        H, _ = _check_convention(Kmat, R, t, n, d, rng)
        strip = np.zeros((h, w), np.uint8)
        strip[:, edges[pi]:edges[pi + 1]] = 255
        warped = warp_perspective(img0_u8, H, (w, h))
        mask = warp_perspective(strip, H, (w, h)) > 127
        img1[mask] = warped[mask]
        filled |= mask
    gain = rng.uniform(*gain_range)
    img1 = np.clip(img1.astype(np.float32) * gain + rng.uniform(*bias_range), 0, 255)
    img1 = (img1 + rng.normal(0, 2.0, img1.shape)).clip(0, 255).astype(np.uint8)
    img1[~filled] = 0
    return img1


def render_pose_scene(out_dir: Path, rng: np.random.Generator, size=(640, 480),
                      n_planes: int = 4, max_rot_deg: float = 10.0, t_scale: float = 0.35,
                      n_pairs: int = 2) -> list[str]:
    """Render the reference view 0.ppm and ``n_pairs`` views {1..}.ppm under
    ``out_dir``; returns the pairs lines, image paths relative to the
    folder above ``out_dir``."""
    w, h = size
    out_dir.mkdir(parents=True, exist_ok=True)
    img0 = generate_structured_image(rng, (w, h))
    img0_u8 = (img0 * 255).astype(np.uint8)
    write_image(out_dir / "0.ppm", img0_u8)
    Kmat, edges, planes = make_planar_world(rng, (w, h), n_planes)
    kflat = " ".join(f"{x:.8g}" for x in Kmat.ravel())
    lines = []
    for k in range(n_pairs):
        R = _rotation(rng, max_rot_deg)
        t = rng.normal(size=3)
        t = t / np.linalg.norm(t) * t_scale * (1.0 + 0.5 * k)
        write_image(out_dir / f"{k + 1}.ppm",
                    composite_view(img0_u8, Kmat, planes, edges, R, t, rng))
        T = np.eye(4)
        T[:3, :3] = R
        T[:3, 3] = t
        tflat = " ".join(f"{x:.8g}" for x in T.ravel())
        lines.append(f"{out_dir.name}/0.ppm {out_dir.name}/{k + 1}.ppm {kflat} {kflat} {tflat}")
    return lines


def render_scene_job(out: Path, seed: int, scene: int, pairs_per_scene: int) -> list[str]:
    """Scene ``scene`` of the set of ``seed`` under ``out``/images (one job
    of a process pool; the random stream is the scene's own)."""
    return render_pose_scene(Path(out) / "images" / f"scene{scene:03d}",
                             np.random.default_rng((seed, scene)), n_pairs=pairs_per_scene)


def write_pairs(out: Path, lines: list[str]) -> None:
    (Path(out) / "pairs_calibrated.txt").write_text("\n".join(lines) + "\n")


def main(argv: list[str] | None = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(DATA_PATH / "pose-eval"))
    ap.add_argument("--num_scenes", type=int, default=10)
    ap.add_argument("--pairs_per_scene", type=int, default=2)
    ap.add_argument("--seed", type=int, default=31415)
    args = ap.parse_args(argv)
    out = Path(args.out)
    lines = []
    for s in range(args.num_scenes):
        lines += render_scene_job(out, args.seed, s, args.pairs_per_scene)
    write_pairs(out, lines)
    print(f"wrote {len(lines)} calibrated pairs under {out}")


if __name__ == "__main__":
    main()
