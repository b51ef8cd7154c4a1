"""On-device homography data engine (gluefactory_tpu/datasets/
homographies_ondevice.py): image pairs for matcher training made on the GPU.

A pool of source images is drawn once on the host, uploaded to the card as
uint8, and every step builds its batch there from one integer seed:

  pool gather -> two random homographies (geometry/homography.py)
  -> warp_image (ops/warp.py) -> photometric jitter (ops/photometric.py)
  -> H_0to1 and the warped corner ground truth.

So the only per-step traffic from host to device is the seed. The random
numbers come from a ``torch.Generator`` on the card; ``batch_draws`` makes
them and ``make_batch_from_draws`` is deterministic given them, so tests can
feed the JAX engine's numbers. The pool is procedural: the JAX engine draws
its scenes with cv2, which the GPU machine does not have, so
``generate_structured_scene`` rasterises the same scenes with numpy (same
random draws, same corner ground truth, pixels that differ on shape edges).
A pool from a folder of real images (``data_dir``) is not ported yet."""

from __future__ import annotations

from typing import ClassVar

import numpy as np
import torch

from ..geometry.homography import homography_draws, homography_from_draws, warp_points
from ..ops.photometric import photometric_apply, photometric_draws
from ..ops.warp import warp_image
from .base_dataset import BaseDataset

# --- numpy rasterisation of the scene primitives (cv2's filled shapes) ---------


def _window(img, x0, y0, x1, y1):
    """Pixel-center grids of the image window [x0, x1] x [y0, y1], clipped."""
    h, w = img.shape
    x0, y0 = max(int(np.floor(x0)), 0), max(int(np.floor(y0)), 0)
    x1, y1 = min(int(np.ceil(x1)), w - 1), min(int(np.ceil(y1)), h - 1)
    if x0 > x1 or y0 > y1:
        return None
    py, px = np.mgrid[y0:y1 + 1, x0:x1 + 1].astype(np.float64)
    return (slice(y0, y1 + 1), slice(x0, x1 + 1)), px, py


def fill_polygon(img, pts, color):
    """Pixels whose centers are inside the polygon (n, 2), edges included."""
    win = _window(img, pts[:, 0].min(), pts[:, 1].min(), pts[:, 0].max(), pts[:, 1].max())
    if win is None:
        return
    sl, px, py = win
    inside = np.zeros(px.shape, bool)
    on_edge = np.zeros(px.shape, bool)
    for (xa, ya), (xb, yb) in zip(pts, np.roll(pts, -1, axis=0)):
        crosses = (ya > py) != (yb > py)
        xcross = (xb - xa) * (py - ya) / np.where(yb == ya, 1e-12, yb - ya) + xa
        inside ^= crosses & (px < xcross)
        on_edge |= _segment_distance(px, py, (xa, ya), (xb, yb)) <= 0.5
    img[sl][inside | on_edge] = color


def fill_rectangle(img, x0, y0, x1, y1, color):
    """cv2.rectangle(..., thickness=-1): both corners included."""
    h, w = img.shape
    xa, xb = sorted((x0, x1))
    ya, yb = sorted((y0, y1))
    img[max(ya, 0):min(yb, h - 1) + 1, max(xa, 0):min(xb, w - 1) + 1] = color


def _segment_distance(px, py, p0, p1):
    (xa, ya), (xb, yb) = p0, p1
    dx, dy = xb - xa, yb - ya
    t = ((px - xa) * dx + (py - ya) * dy) / max(dx * dx + dy * dy, 1e-12)
    t = np.clip(t, 0.0, 1.0)
    return np.hypot(px - (xa + t * dx), py - (ya + t * dy))


def _bresenham(img, p0, p1, color):
    """cv2.line of thickness 1: OpenCV's 8-connected line iterator."""
    (x0, y0), (x1, y1) = (int(v) for v in p0), (int(v) for v in p1)
    h, w = img.shape
    if x1 < x0:  # left to right
        x0, y0, x1, y1 = x1, y1, x0, y0
    dx, dy = x1 - x0, abs(y1 - y0)
    step_y = -1 if y1 < y0 else 1
    steep = dy > dx
    if steep:
        dx, dy = dy, dx
    err = dx - 2 * dy
    x, y = x0, y0
    for _ in range(dx + 1):
        if 0 <= x < w and 0 <= y < h:
            img[y, x] = color
        minor = err < 0
        err += -2 * dy + (2 * dx if minor else 0)
        if steep:
            y, x = y + step_y, x + minor
        else:
            x, y = x + 1, y + step_y * minor


def _fill_disk(img, center, radius, color):
    win = _window(img, center[0] - radius, center[1] - radius, center[0] + radius,
                  center[1] + radius)
    if win is not None:
        sl, px, py = win
        img[sl][(px - center[0]) ** 2 + (py - center[1]) ** 2 <= radius * radius] = color


def draw_line(img, p0, p1, color, thickness):
    """cv2.line: a thin line is OpenCV's 8-connected one; a thick one is the
    quad of half-width t/2 (t/2 + 0.5 for odd t) around the segment with a
    disk of radius (t + 1) // 2 at each end, as OpenCV draws it."""
    if thickness <= 1:
        _bresenham(img, p0, p1, color)
        return
    p0, p1 = np.asarray(p0, np.float64), np.asarray(p1, np.float64)
    d = p1 - p0
    length = float(np.hypot(d[0], d[1]))
    if length > 0:
        half = thickness / 2.0 + (0.5 if thickness & 1 else 0.0)
        dp = np.round(np.array([-d[1], d[0]]) / length * half * 65536) / 65536  # 16.16
        fill_polygon(img, np.stack([p0 + dp, p0 - dp, p1 - dp, p1 + dp]), color)
    for end in (p0, p1):
        _fill_disk(img, end, (thickness + 1) // 2, color)


def fill_ellipse(img, center, axes, angle_deg, color):
    """cv2.ellipse(..., thickness=-1): the polygon of ellipse2Poly (a vertex
    every 5 degrees for half-axes of 15 px or more, the rotation rounded to
    a whole degree), filled."""
    (cx, cy), (ax, ay) = center, axes
    largest = max(ax, ay)
    delta = 90 if largest < 3 else 30 if largest < 10 else 18 if largest < 15 else 5
    a = np.deg2rad(int(np.round(angle_deg)) % 360)
    t = np.deg2rad(np.minimum(np.arange(0, 360 + delta, delta), 360))
    x, y = ax * np.cos(t), ay * np.sin(t)
    fill_polygon(img, np.stack([cx + x * np.cos(a) - y * np.sin(a),
                                cy + x * np.sin(a) + y * np.cos(a)], -1), color)


def generate_structured_scene(rng: np.random.Generator, size: tuple[int, int],
                              max_points: int):
    """A procedural grayscale scene with exact corner ground truth: filled
    polygons, rectangles, checkerboards, lines and ellipses on a shaded
    background, plus noise. Every polygon vertex, rectangle corner, checker
    corner and line end inside the image is a ground-truth keypoint. The
    random draws are those of the JAX engine, in the same order.

    Returns (image (h, w, 1) in [0, 1], points (max_points, 2), valid
    (max_points,))."""
    w, h = size
    gx = np.linspace(0, 1, w, dtype=np.float32)[None, :]
    gy = np.linspace(0, 1, h, dtype=np.float32)[:, None]
    a, b, c = rng.uniform(0.1, 0.9, 3)
    img = np.ascontiguousarray((a * gx + b * gy + c) / (a + b + c + 1e-8))
    img *= rng.uniform(0.3, 0.9)
    points: list[np.ndarray] = []

    def add_pts(pts):
        for p in np.atleast_2d(pts):
            if 2 <= p[0] < w - 2 and 2 <= p[1] < h - 2:
                points.append(np.asarray(p, np.float32))

    for _ in range(int(rng.integers(12, 26))):
        color = float(rng.uniform(0, 1))
        kind = int(rng.integers(0, 5))
        if kind == 0:  # polygon
            n_pts = int(rng.integers(3, 7))
            cx, cy = rng.uniform(0, w), rng.uniform(0, h)
            r = rng.uniform(10, min(w, h) / 4)
            ang = np.sort(rng.uniform(0, 2 * np.pi, n_pts))
            pts = np.stack([cx + r * np.cos(ang), cy + r * np.sin(ang)], -1)
            ipts = pts.astype(np.int32).astype(np.float32)
            fill_polygon(img, ipts.astype(np.float64), color)
            add_pts(ipts)
        elif kind == 1:  # rectangle
            x0, y0 = rng.uniform(0, w - 20), rng.uniform(0, h - 20)
            x1, y1 = x0 + rng.uniform(10, w / 3), y0 + rng.uniform(10, h / 3)
            x0, y0, x1, y1 = int(x0), int(y0), int(x1), int(y1)
            fill_rectangle(img, x0, y0, x1, y1, color)
            add_pts(np.array([[x0, y0], [x1, y0], [x1, y1], [x0, y1]], np.float32))
        elif kind == 2:  # checkerboard patch
            rows, cols = int(rng.integers(2, 5)), int(rng.integers(2, 5))
            cell = int(rng.uniform(8, min(w, h) / 10))
            x0 = int(rng.uniform(0, w - cols * cell))
            y0 = int(rng.uniform(0, h - rows * cell))
            c2 = float(rng.uniform(0, 1))
            for i in range(rows):
                for j in range(cols):
                    fill_rectangle(img, x0 + j * cell, y0 + i * cell, x0 + (j + 1) * cell,
                                   y0 + (i + 1) * cell, color if (i + j) % 2 == 0 else c2)
            corners = np.stack(np.meshgrid(x0 + cell * np.arange(cols + 1),
                                           y0 + cell * np.arange(rows + 1)), -1)
            add_pts(corners.reshape(-1, 2).astype(np.float32))
        elif kind == 3:  # line
            p0 = rng.uniform([0, 0], [w, h]).astype(int)
            p1 = rng.uniform([0, 0], [w, h]).astype(int)
            draw_line(img, p0.astype(np.float64), p1.astype(np.float64), color,
                      int(rng.integers(1, 4)))
            add_pts(np.stack([p0, p1]).astype(np.float32))
        else:  # ellipse: texture, no corner ground truth
            center = (int(rng.uniform(0, w)), int(rng.uniform(0, h)))
            axes = (int(rng.uniform(5, w / 6)), int(rng.uniform(5, h / 6)))
            fill_ellipse(img, center, axes, float(rng.uniform(0, 180)), color)
    img += rng.normal(0, 0.015, img.shape).astype(np.float32)
    img = np.clip(img, 0.0, 1.0)[..., None]

    pts = np.zeros((max_points, 2), np.float32)
    valid = np.zeros((max_points,), bool)
    if points:
        arr = np.unique(np.stack(points), axis=0)
        if len(arr) > max_points:
            arr = arr[rng.permutation(len(arr))[:max_points]]
        pts[:len(arr)] = arr
        valid[:len(arr)] = True
    return img, pts, valid


class OnDeviceHomographyDataset(BaseDataset):
    """Pool-on-the-card homography pair engine."""

    default_conf: ClassVar[dict] = {
        "name": "homographies_ondevice",
        "pool_size": 512,
        "val_pool_size": 48,
        "source_size": [448, 448],  # pool image size (w, h)
        "image_size": 320,  # canvas of each view
        "max_gt_points": 192,
        "data_dir": None,  # a folder of real images for the pool: not ported
        "train_batch_size": 32,
        "val_batch_size": 32,
        "steps_per_epoch": 500,
        "val_steps": 4,
        "seed": 0,
        "homography": {"difficulty": 0.7, "translation": 0.3, "max_angle": 45.0},
        "photometric": {"p": 0.95, "strength": 1.0},
        "right_only": False,  # view0 gets a milder warp when True
    }

    def __init__(self, conf: dict | None = None):
        super().__init__(conf)
        if self.conf["data_dir"]:
            raise NotImplementedError("a pool of real images (data_dir) is not ported")

    def build_pool(self, split: str = "train") -> dict:
        """The procedural source pool as host arrays: uint8 images
        (n, h, w, 1), corner points (n, K, 2) and their validity (n, K)."""
        conf = self.conf
        n = int(conf["val_pool_size"] if split == "val" else conf["pool_size"])
        w, h = (int(x) for x in conf["source_size"])
        k = int(conf["max_gt_points"])
        images = np.zeros((n, h, w, 1), np.uint8)
        points = np.zeros((n, k, 2), np.float32)
        valid = np.zeros((n, k), bool)
        salt = 104729 if split == "val" else 0
        for i in range(n):
            rng = np.random.default_rng((int(conf["seed"]) + salt, i))
            img, points[i], valid[i] = generate_structured_scene(rng, (w, h), k)
            images[i] = np.clip(img * 255, 0, 255).astype(np.uint8)
        return {"images": images, "points": points, "point_valid": valid}

    def batch_size(self, split: str) -> int:
        return int(self.conf[f"{split}_batch_size"])

    def batch_draws(self, generator: torch.Generator, pool: dict, split: str = "train") -> dict:
        """Every random number of one batch, drawn on the generator's device."""
        bsz, s = self.batch_size(split), int(self.conf["image_size"])
        idx = torch.randint(0, pool["images"].shape[0], (bsz,), generator=generator,
                            device=generator.device)
        return {"idx": idx,
                "h0": homography_draws(generator, bsz), "h1": homography_draws(generator, bsz),
                "p0": photometric_draws(generator, (bsz, s, s, 1)),
                "p1": photometric_draws(generator, (bsz, s, s, 1))}

    def make_batch_from_draws(self, pool: dict, draws: dict) -> dict:
        """A training batch from the pool (tensors on the device) and draws."""
        conf = self.conf
        s = int(conf["image_size"])
        hs, ws = pool["images"].shape[1:3]
        idx = draws["idx"]
        bsz = idx.shape[0]
        images = pool["images"][idx].float() / 255.0
        gt_pts, gt_valid = pool["points"][idx], pool["point_valid"][idx]
        hconf, pconf = conf["homography"], conf["photometric"]
        mild = 0.3 if conf["right_only"] else 1.0
        H0, _ = homography_from_draws(
            draws["h0"], (ws, hs), (s, s), difficulty=float(hconf["difficulty"]) * mild,
            translation=float(hconf["translation"]), max_angle=float(hconf["max_angle"]) * mild)
        H1, _ = homography_from_draws(
            draws["h1"], (ws, hs), (s, s), difficulty=float(hconf["difficulty"]),
            translation=float(hconf["translation"]), max_angle=float(hconf["max_angle"]))
        p, strength = float(pconf["p"]), float(pconf["strength"])
        im0 = photometric_apply(warp_image(images, H0, (s, s)), draws["p0"], p, strength)
        im1 = photometric_apply(warp_image(images, H1, (s, s)), draws["p1"], p, strength)
        kp0, kp1 = warp_points(gt_pts, H0), warp_points(gt_pts, H1)

        def inside(kp):
            return ((kp[..., 0] >= 2.0) & (kp[..., 0] <= s - 3.0)
                    & (kp[..., 1] >= 2.0) & (kp[..., 1] <= s - 3.0))

        size = torch.full((bsz, 2), float(s), device=images.device)
        return {
            "view0": {"image": im0, "image_size": size},
            "view1": {"image": im1, "image_size": size},
            "H_0to1": H1 @ torch.linalg.inv(H0),
            "gt_keypoints0": kp0,
            "gt_keypoint_valid0": gt_valid & inside(kp0),
            "gt_keypoints1": kp1,
            "gt_keypoint_valid1": gt_valid & inside(kp1),
        }

    def make_batch(self, pool: dict, seed: int, split: str = "train") -> dict:
        """The batch of one step: its random numbers come from a generator on
        the pool's device seeded with ``seed``."""
        generator = torch.Generator(device=pool["images"].device).manual_seed(int(seed))
        return self.make_batch_from_draws(pool, self.batch_draws(generator, pool, split))

    def get_data_loader(self, split: str):
        steps = int(self.conf["val_steps"] if split == "val" else self.conf["steps_per_epoch"])
        return SeedLoader(int(self.conf["seed"]), split, steps)


def upload_pool(pool: dict, device: str | torch.device) -> dict:
    """The host pool as tensors on ``device``, uploaded once."""
    return {k: torch.from_numpy(v).to(device) for k, v in pool.items()}


class SeedLoader:
    """Yields one integer seed per step; ``make_batch`` turns it into a batch
    (the JAX engine's ``_SeedLoader``)."""

    def __init__(self, base_seed: int, split: str, steps: int):
        self.base, self.split, self.steps = base_seed, split, steps
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return self.steps

    def __iter__(self):
        salt = 1 << 40 if self.split == "val" else 0  # disjoint seed streams
        for i in range(self.steps):
            yield self.base + salt + self.epoch * self.steps + i


__main_dataset__ = OnDeviceHomographyDataset
