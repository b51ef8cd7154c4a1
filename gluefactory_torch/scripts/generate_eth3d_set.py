"""Render an ETH3D-layout multi-view benchmark
(gluefactory_tpu/scripts/generate_eth3d_set.py), in numpy:

    <out>/<scene>/images/view{k}.ppm
    <out>/<scene>/dslr_calibration_undistorted/{cameras,images,points3D}.txt

Each scene is one of the pose set's piecewise-planar worlds
(``generate_pose_eval_set``): strips of a procedural image on slanted
planes at staggered depths, each view rendered exactly by one homography a
plane, far to near, with K, R and t exact. 3-D points sampled on the planes
are projected into every view and count as seen where their plane is the
top surface at their projection (painter's occlusion), so the COLMAP
``images.txt`` point ids give the dataset its covisibility as in real ETH3D.

The seeds, draws, defaults and text files are the JAX script's, character
for character where the same draws decide them; the point lists differ only
where the rasterised plane labels do at strip edges. The images are PPM
(the JAX script writes PNG with cv2, from the RGB array as if it were BGR,
so both packages read it channel-reversed; the PPM holds what they read).

Usage: python -m gluefactory_torch.scripts.generate_eth3d_set
          [--out data/ETH3D_undistorted] [--num_scenes 6] [--views 6]
          [--points 1500] [--seed 271828]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from ..datasets.homographies import generate_structured_image
from ..settings import DATA_PATH
from ..utils.image import warp_perspective, write_image
from .generate_pose_eval_set import _plane_homography, _rotation, make_planar_world


def rotmat2qvec(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> COLMAP (w, x, y, z) quaternion, w >= 0 (the inverse
    of ``datasets.eth3d.qvec2rotmat``)."""
    K = np.array([
        [R[0, 0] - R[1, 1] - R[2, 2], 0, 0, 0],
        [R[0, 1] + R[1, 0], R[1, 1] - R[0, 0] - R[2, 2], 0, 0],
        [R[0, 2] + R[2, 0], R[1, 2] + R[2, 1], R[2, 2] - R[0, 0] - R[1, 1], 0],
        [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1],
         R[0, 0] + R[1, 1] + R[2, 2]],
    ]) / 3.0
    vals, vecs = np.linalg.eigh(K)
    q = vecs[[3, 0, 1, 2], np.argmax(vals)]
    return -q if q[0] < 0 else q


def _render_view(img0_u8, Kmat, planes, edges, R, t, rng):
    """The uint8 view at (R, t) and its map of the plane seen at each pixel
    (-1 where none is)."""
    h, w = img0_u8.shape[:2]
    img1 = np.zeros_like(img0_u8)
    label = np.full((h, w), -1, np.int32)
    for pi in np.argsort([-d for _, d in planes]):
        n, d = planes[pi]
        H = _plane_homography(Kmat, R, t, n, d)
        strip = np.zeros((h, w), np.uint8)
        strip[:, edges[pi]:edges[pi + 1]] = 255
        warped = warp_perspective(img0_u8, H, (w, h))
        mask = warp_perspective(strip, H, (w, h)) > 127
        img1[mask] = warped[mask]
        label[mask] = pi
    gain = rng.uniform(0.92, 1.08)
    img1 = np.clip(img1.astype(np.float32) * gain + rng.uniform(-6, 6), 0, 255)
    img1 = (img1 + rng.normal(0, 1.5, img1.shape)).clip(0, 255).astype(np.uint8)
    img1[label < 0] = 0
    return img1, label


def _sample_world_points(rng, Kmat, planes, edges, size, n_points):
    """3-D points on the planes at uniform view-0 pixels: (X (N, 3) in
    camera-0 coordinates, the plane of each (N,))."""
    w, h = size
    px = np.stack([rng.uniform(4, w - 5, n_points), rng.uniform(4, h - 5, n_points)], -1)
    plane_idx = np.searchsorted(edges[1:-1], px[:, 0], side="right")
    rays = np.linalg.inv(Kmat) @ np.c_[px, np.ones(len(px))].T  # (3, N)
    X = np.empty((n_points, 3))
    for i, (n, d) in enumerate(planes):
        sel = plane_idx == i
        X[sel] = (rays[:, sel] * (d / (n @ rays[:, sel]))).T
    return X, plane_idx


def render_eth3d_scene(scene_dir: Path, rng: np.random.Generator, size=(640, 480),
                       n_planes: int = 4, n_views: int = 6, n_points: int = 1500,
                       max_rot_deg: float = 9.0, t_scale: float = 0.3) -> None:
    """Render the views of one scene and write its COLMAP text model."""
    w, h = size
    scene_dir = Path(scene_dir)
    (scene_dir / "images").mkdir(parents=True, exist_ok=True)
    calib = scene_dir / "dslr_calibration_undistorted"
    calib.mkdir(parents=True, exist_ok=True)

    img0_u8 = (generate_structured_image(rng, (w, h)) * 255).astype(np.uint8)
    Kmat, edges, planes = make_planar_world(rng, (w, h), n_planes)
    X, plane_idx = _sample_world_points(rng, Kmat, planes, edges, size, n_points)

    views = [(np.eye(3), np.zeros(3))]
    for k in range(1, n_views):
        R = _rotation(rng, max_rot_deg * (0.4 + 0.6 * k / (n_views - 1)))
        t = rng.normal(size=3)
        t = t / np.linalg.norm(t) * t_scale * (0.5 + 0.8 * k / (n_views - 1))
        views.append((R, t))

    image_lines = [
        "# Image list with two lines of data per image:",
        "#   IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME",
        "#   POINTS2D[] as (X, Y, POINT3D_ID)",
    ]
    for k, (R, t) in enumerate(views):
        if k == 0:
            img_k = img0_u8
            label = np.broadcast_to(
                np.searchsorted(edges[1:-1], np.arange(w), side="right")[None, :], (h, w))
        else:
            img_k, label = _render_view(img0_u8, Kmat, planes, edges, R, t, rng)
        write_image(scene_dir / "images" / f"view{k}.ppm", img_k[..., ::-1])
        # project the world points; keep those whose plane is the top surface
        Xc = R @ X.T + t[:, None]
        uv = Kmat @ Xc
        uv = (uv[:2] / uv[2]).T
        ui = np.round(uv).astype(int)
        inb = ((ui[:, 0] >= 0) & (ui[:, 0] < w) & (ui[:, 1] >= 0) & (ui[:, 1] < h)
               & (Xc[2] > 0.1))
        vis = inb.copy()
        vis[inb] = label[ui[inb, 1], ui[inb, 0]] == plane_idx[inb]
        q = rotmat2qvec(R)
        image_lines.append(
            f"{k + 1} {q[0]:.9f} {q[1]:.9f} {q[2]:.9f} {q[3]:.9f} "
            f"{t[0]:.9f} {t[1]:.9f} {t[2]:.9f} 1 view{k}.ppm")
        image_lines.append(" ".join(f"{uv[i, 0]:.3f} {uv[i, 1]:.3f} {i}"
                                    for i in np.where(vis)[0]))

    f = Kmat[0, 0]
    (calib / "cameras.txt").write_text(
        "# Camera list: CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n"
        f"1 PINHOLE {w} {h} {f:.6f} {f:.6f} {w / 2.0:.6f} {h / 2.0:.6f}\n")
    (calib / "images.txt").write_text("\n".join(image_lines) + "\n")
    (calib / "points3D.txt").write_text(
        "# 3D point list: POINT3D_ID, X, Y, Z, R, G, B, ERROR, TRACK[]\n"
        + "\n".join(f"{i} {X[i, 0]:.6f} {X[i, 1]:.6f} {X[i, 2]:.6f} 128 128 128 0.0"
                    for i in range(len(X))) + "\n")


def render_scene_job(out: Path, seed: int, scene: int, views: int = 6, points: int = 1500,
                     size=(640, 480)) -> str:
    """Scene ``scene`` of the set of ``seed`` under ``out`` (one job of a
    process pool; the random stream is the scene's own). Returns its name."""
    name = f"scene{scene:03d}"
    render_eth3d_scene(Path(out) / name, np.random.default_rng((seed, scene)), size=size,
                       n_views=views, n_points=points)
    return name


def main(argv: list[str] | None = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(DATA_PATH / "ETH3D_undistorted"))
    ap.add_argument("--num_scenes", type=int, default=6)
    ap.add_argument("--views", type=int, default=6)
    ap.add_argument("--points", type=int, default=1500)
    ap.add_argument("--seed", type=int, default=271828)
    args = ap.parse_args(argv)
    for s in range(args.num_scenes):
        render_scene_job(Path(args.out), args.seed, s, args.views, args.points)
    print(f"wrote {args.num_scenes} ETH3D-layout scenes to {args.out}")


if __name__ == "__main__":
    main()
