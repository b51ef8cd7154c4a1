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
With ``data_dir`` the pool is a folder of images instead (binary PPM/PGM,
the files ``utils/image.read_image`` reads), without corner ground truth.

``OnDeviceCachedFeatureDataset`` (``homographies_ondevice_cached``) keeps
an extractor's features of the pool instead of its images: extracted once
on the card, cached as ``.npz`` under ``DATA_PATH/engine_pool_cache`` (the
JAX package's file name and layout, so each package reads the other's),
and each step warps the keypoints by the two homographies and perturbs the
descriptors, so a step runs only the matcher."""

from __future__ import annotations

import hashlib
import json
import logging
import multiprocessing as mp
import os
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path
from typing import ClassVar

import numpy as np
import torch

from .. import settings
from ..geometry.homography import homography_draws, homography_from_draws, warp_points
from ..ops.photometric import photometric_apply, photometric_draws
from ..ops.warp import warp_image
from .base_dataset import BaseDataset

logger = logging.getLogger(__name__)

# --- numpy rasterisation of the scene primitives (cv2's filled shapes), gray or colour


def _window(img, x0, y0, x1, y1):
    """Pixel-center grids of the image window [x0, x1] x [y0, y1], clipped."""
    h, w = img.shape[:2]
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
    x0, y0 = px[0, 0], py[0, 0]
    h, w = px.shape

    def rows(lo, hi):  # the window's rows with centres in [lo, hi]
        return slice(max(int(np.ceil(lo - y0)), 0), max(min(int(np.floor(hi - y0)) + 1, h), 0))

    for (xa, ya), (xb, yb) in zip(pts, np.roll(pts, -1, axis=0)):
        # only the rows an edge crosses, and the pixels within half a pixel of
        # its bounding box, can change: the same pixels as testing every one
        r = rows(min(ya, yb), max(ya, yb))
        crosses = (ya > py[r]) != (yb > py[r])
        xcross = (xb - xa) * (py[r] - ya) / np.where(yb == ya, 1e-12, yb - ya) + xa
        inside[r] ^= crosses & (px[r] < xcross)
        r = rows(min(ya, yb) - 0.5, max(ya, yb) + 0.5)
        c = slice(max(int(np.ceil(min(xa, xb) - 0.5 - x0)), 0),
                  max(min(int(np.floor(max(xa, xb) + 0.5 - x0)) + 1, w), 0))
        on_edge[r, c] |= _segment_distance(px[r, c], py[r, c], (xa, ya), (xb, yb)) <= 0.5
    img[sl][inside | on_edge] = color


def fill_rectangle(img, x0, y0, x1, y1, color):
    """cv2.rectangle(..., thickness=-1): both corners included."""
    h, w = img.shape[:2]
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
    h, w = img.shape[:2]
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


POOL_PROCESS_MIN = 64  # procedural pools at least this large are drawn by forked processes


def _pool_scene(job: tuple) -> tuple:
    """Scene ``i`` of a procedural pool as (uint8 image, points, validity)."""
    seed, i, w, h, k = job
    img, pts, valid = generate_structured_scene(np.random.default_rng((seed, i)), (w, h), k)
    return np.clip(img * 255, 0, 255).astype(np.uint8), pts, valid


class OnDeviceHomographyDataset(BaseDataset):
    """Pool-on-the-card homography pair engine."""

    device_engine: ClassVar[bool] = True
    default_conf: ClassVar[dict] = {
        "name": "homographies_ondevice",
        "pool_size": 512,
        "val_pool_size": 48,
        "source_size": [448, 448],  # pool image size (w, h)
        "image_size": 320,  # canvas of each view
        "max_gt_points": 192,
        "data_dir": None,  # a folder of images for the pool (else procedural)
        "glob": ["*.jpg", "*.png", "*.jpeg", "*.ppm"],
        "train_batch_size": 32,
        "val_batch_size": 32,
        "batch_size": 32,
        "num_workers": 0,
        "steps_per_epoch": 500,
        "val_steps": 4,
        "seed": 0,
        "homography": {"difficulty": 0.7, "translation": 0.3, "max_angle": 45.0},
        "photometric": {"p": 0.95, "strength": 1.0},
        "right_only": False,  # view0 gets a milder warp when True
    }

    def build_pool(self, split: str = "train", device: str | torch.device = "cpu") -> dict:
        """The source pool as host arrays: uint8 images (n, h, w, 1), corner
        points (n, K, 2) and their validity (n, K). Procedural, or with
        ``data_dir`` the images of that folder (``glob`` under it, recursive;
        relative to DATA_PATH): one permutation seeded by ``seed`` takes the
        train pool from its head and the val pool from its tail; each image
        is the mean of its channels, resized by INTER_AREA, without corner
        ground truth (validity False). ``device`` is where a subclass
        computes the pool; the images are made on the host."""
        conf = self.conf
        n = int(conf["val_pool_size"] if split == "val" else conf["pool_size"])
        w, h = (int(x) for x in conf["source_size"])
        k = int(conf["max_gt_points"])
        images = np.zeros((n, h, w, 1), np.uint8)
        points = np.zeros((n, k, 2), np.float32)
        valid = np.zeros((n, k), bool)
        if conf["data_dir"]:
            from ..utils.image import read_image, resize

            root = Path(conf["data_dir"])
            if not root.is_absolute():
                root = settings.DATA_PATH / root
            paths = sorted(p for pat in conf["glob"] for p in root.glob("**/" + pat))
            if not paths:
                raise FileNotFoundError(f"no pool images under {root}")
            # one permutation, so that the val tail is disjoint from the train head
            sel = np.random.default_rng(int(conf["seed"])).permutation(len(paths))
            sel = sel[-n:] if split == "val" else sel[:n]
            if len(paths) < n + (int(conf["val_pool_size"]) if split != "val" else 0):
                logger.warning("pool wants %d+val images but only %d available; train/val "
                               "pools will overlap", n, len(paths))
            for i, pi in enumerate(sel):
                img = read_image(paths[pi % len(paths)]).astype(np.float32) / 255.0
                if img.ndim == 3:
                    img = img.mean(-1)
                if img.shape[0] < h or img.shape[1] < w:
                    raise NotImplementedError(
                        f"{paths[pi % len(paths)]}: {img.shape[1]}x{img.shape[0]} is smaller "
                        f"than source_size {w}x{h}; INTER_AREA upscaling is not ported")
                img = resize(img, (w, h), "area")
                images[i, ..., 0] = np.clip(img * 255, 0, 255).astype(np.uint8)
        else:
            salt = 104729 if split == "val" else 0
            jobs = [(int(conf["seed"]) + salt, i, w, h, k) for i in range(n)]
            if n >= POOL_PROCESS_MIN:  # each scene has its own generator: any order gives one pool
                with ProcessPoolExecutor(min(os.cpu_count() or 1, 8),
                                         mp_context=mp.get_context("fork")) as ex:
                    scenes = list(ex.map(_pool_scene, jobs, chunksize=8))
            else:
                scenes = [_pool_scene(job) for job in jobs]
            for i, (img, pts, val) in enumerate(scenes):
                images[i], points[i], valid[i] = img, pts, val
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

    def get_overfit_loader(self, split: str, num_items: int = 1):
        """One step an epoch, always the seed of step 0."""
        return SeedLoader(int(self.conf["seed"]), split, 1, frozen=True)


class OnDeviceCachedFeatureDataset(OnDeviceHomographyDataset):
    """The cached-feature engine: the pool holds the features that
    ``features_from`` (an extractor, its weights from ``experiment``)
    extracts once from the source images; each step warps the keypoint
    positions by the sampled homographies, jitters them by ``kp_noise``
    pixels, and gives each view the source's descriptors with Gaussian
    noise (``desc_noise``), renormalised, and a random share
    (``desc_dropout``) of its keypoints dropped. The views carry these
    features under ``cache``, so a pipeline with ``allow_no_extract`` runs
    only its matcher. ``on_host`` extraction (the SIFT family) is not ported."""

    default_conf: ClassVar[dict] = {
        "name": "homographies_ondevice_cached",
        "features_from": {
            "name": "extractors.superpoint",  # unknown keys are filtered per extractor
            "experiment": None,  # a run, a .ckpt or a weights blob holding the extractor
            "max_num_keypoints": 512,
            "detection_threshold": 0.0005,
            "nms_radius": 4,
            "batch": 16,  # images a forward
            "on_host": False,  # extract on the host (not ported)
        },
        "desc_noise": 0.05,
        "desc_dropout": 0.05,
        "kp_noise": 0.0,  # px std of each view's keypoint jitter
        "pool_cache": True,  # keep extracted pools as .npz under DATA_PATH
    }

    def __init__(self, conf: dict | None = None):
        super().__init__(conf)
        self._pools: dict[str, dict] = {}

    def pool_cache_path(self, split: str) -> Path | None:
        """``DATA_PATH/engine_pool_cache/<class>_<hash>.npz``: the hash is the
        JAX package's, over the same keys of the conf serialised alike, so
        one conf names one file in both packages."""
        if not self.conf.get("pool_cache", True):
            return None
        keys = ["pool_size", "val_pool_size", "source_size", "seed", "data_dir", "glob",
                "max_gt_points", "features_from"]
        spec = {k: self.conf.get(k) for k in keys}
        spec["split"] = split
        digest = hashlib.sha1(json.dumps(spec, sort_keys=True, default=str).encode())
        folder = settings.DATA_PATH / "engine_pool_cache"
        folder.mkdir(parents=True, exist_ok=True)
        return folder / f"{type(self).__name__}_{digest.hexdigest()[:16]}.npz"

    def build_pool(self, split: str = "train", device: str | torch.device = "cuda") -> dict:
        """The feature pool as host arrays: keypoints (n, K, 2), float16
        descriptors (n, K, D), scores and validity (n, K), and the
        ``source_size`` they were extracted at. Read from the pool cache
        where it holds this conf's file, else extracted on ``device`` and
        written there (atomically: a ``.tmp.npz`` renamed)."""
        if split in self._pools:
            return self._pools[split]
        path = self.pool_cache_path(split)
        if path is not None and path.exists():
            with np.load(path) as blob:
                pool = {k: blob[k] for k in blob.files}
        else:
            pool = self.extract_pool(split, device)
            if path is not None:
                tmp = path.with_suffix(".tmp.npz")
                np.savez(tmp, **pool)
                tmp.replace(path)
        self._pools[split] = pool
        return pool

    def extractor(self, device: str | torch.device) -> torch.nn.Module:
        """The extractor of ``features_from`` on ``device``, in inference
        mode: its conf is the keys of ``features_from`` that the extractor's
        ``default_conf`` names; its weights come from ``experiment`` (a run's
        last checkpoint, a ``.ckpt`` or a blob; a pipeline's ``['extractor']``
        scope is stripped), every parameter restored."""
        from ..models import build_model, get_model
        from ..utils.experiments import load_experiment, require_restored
        from ..utils.experiments import restore_from_flat_dict

        fconf = self.conf["features_from"]
        name = fconf.get("name", "extractors.superpoint")
        known = get_model(name).default_conf
        ext_conf = {k: v for k, v in fconf.items() if k in known and k != "name"}
        with torch.random.fork_rng(devices=[]):  # the JAX engine initialises from key 0
            torch.manual_seed(0)
            model = build_model(name, ext_conf, device=device)
        if fconf.get("experiment"):
            blob, _ = load_experiment(str(fconf["experiment"]), best=False)
            flat = {k.replace("['extractor']", ""): v for k, v in blob["state"]["params"].items()}
            require_restored(restore_from_flat_dict(model, flat), [fconf["experiment"]])
        return model.eval()

    def extract_pool(self, split: str, device: str | torch.device = "cuda") -> dict:
        """The features of the source pool (``OnDeviceHomographyDataset``'s
        images), ``features_from.batch`` images a forward on ``device``."""
        if self.conf["features_from"].get("on_host", False):  # where JAX branches
            raise NotImplementedError("features_from.on_host (host extraction) is not ported")
        images = OnDeviceHomographyDataset.build_pool(self, split)["images"]
        n, h, w = images.shape[:3]
        model = self.extractor(device)
        size = torch.tensor([[float(w), float(h)]], device=device)
        keys = ("keypoints", "descriptors", "keypoint_scores", "keypoint_valid")
        out = {k: [] for k in keys}
        bs = int(self.conf["features_from"]["batch"])
        with torch.inference_mode():
            for i in range(0, n, bs):
                chunk = torch.from_numpy(images[i:i + bs]).to(device).float() / 255.0
                pred = model({"image": chunk, "image_size": size.expand(chunk.shape[0], 2)})
                for k in keys:
                    out[k].append(pred[k].cpu().numpy())
        pool = {k: np.concatenate(v) for k, v in out.items()}
        pool["descriptors"] = pool["descriptors"].astype(np.float16)
        pool["source_size"] = np.asarray([w, h], np.float32)
        return pool

    def batch_draws(self, generator: torch.Generator, pool: dict, split: str = "train") -> dict:
        """Every random number of one batch, in the JAX engine's order: pool
        indices, the two homographies, the two descriptor noises, the two
        dropout uniforms (a keypoint drops where its uniform is below
        ``desc_dropout``) and the two keypoint jitters."""
        bsz = self.batch_size(split)
        m, k, d = pool["descriptors"].shape
        dev = generator.device

        def normal(*shape):
            return torch.randn(shape, generator=generator, device=dev)

        def uniform(*shape):
            return torch.rand(shape, generator=generator, device=dev)

        return {"idx": torch.randint(0, m, (bsz,), generator=generator, device=dev),
                "h0": homography_draws(generator, bsz), "h1": homography_draws(generator, bsz),
                "n0": normal(bsz, k, d), "n1": normal(bsz, k, d),
                "d0": uniform(bsz, k), "d1": uniform(bsz, k),
                "j0": normal(bsz, k, 2), "j1": normal(bsz, k, 2)}

    def make_batch_from_draws(self, pool: dict, draws: dict) -> dict:
        """A batch of two views, each with its features under ``cache``, from
        the pool (tensors on the device) and draws."""
        conf = self.conf
        s = int(conf["image_size"])
        ws, hs = (int(float(x)) for x in conf["source_size"])
        idx = draws["idx"]
        bsz = idx.shape[0]
        kp_src = pool["keypoints"][idx]
        desc = pool["descriptors"][idx].float()
        scores, kv = pool["keypoint_scores"][idx], pool["keypoint_valid"][idx]
        hconf = conf["homography"]
        mild = 0.3 if conf["right_only"] else 1.0
        H0, _ = homography_from_draws(
            draws["h0"], (ws, hs), (s, s), difficulty=float(hconf["difficulty"]) * mild,
            translation=float(hconf["translation"]), max_angle=float(hconf["max_angle"]) * mild)
        H1, _ = homography_from_draws(
            draws["h1"], (ws, hs), (s, s), difficulty=float(hconf["difficulty"]),
            translation=float(hconf["translation"]), max_angle=float(hconf["max_angle"]))
        kp_noise = float(conf["kp_noise"])

        def view(H, i):
            kp = warp_points(kp_src, H)
            if kp_noise > 0:
                kp = kp + kp_noise * draws[f"j{i}"]
            inside = ((kp[..., 0] >= 0.0) & (kp[..., 0] <= s - 1.0)
                      & (kp[..., 1] >= 0.0) & (kp[..., 1] <= s - 1.0))
            d = desc + float(conf["desc_noise"]) * draws[f"n{i}"]
            d = d / (torch.linalg.vector_norm(d, dim=-1, keepdim=True) + 1e-8)
            drop = draws[f"d{i}"] < float(conf["desc_dropout"])
            return {"cache": {"keypoints": kp, "descriptors": d, "keypoint_scores": scores,
                              "keypoint_valid": kv & inside & ~drop},
                    "image_size": torch.full((bsz, 2), float(s), device=kp.device)}

        return {"view0": view(H0, 0), "view1": view(H1, 1),
                "H_0to1": H1 @ torch.linalg.inv(H0)}

    def make_batch(self, pool: dict, seed: int, split: str = "train") -> dict:
        generator = torch.Generator(device=pool["keypoints"].device).manual_seed(int(seed))
        return self.make_batch_from_draws(pool, self.batch_draws(generator, pool, split))


def upload_pool(pool: dict, device: str | torch.device) -> dict:
    """The host pool as tensors on ``device``, uploaded once."""
    return {k: torch.from_numpy(v).to(device) for k, v in pool.items()}


class SeedLoader:
    """Yields one integer seed per step; ``make_batch`` turns it into a batch
    (the JAX engine's ``_SeedLoader``). A ``frozen`` loader (the overfit
    loader) yields the seed of step 0 at every step of every epoch."""

    def __init__(self, base_seed: int, split: str, steps: int, frozen: bool = False):
        self.base, self.split, self.steps, self.frozen = base_seed, split, steps, frozen
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return self.steps

    def __iter__(self):
        salt = 1 << 40 if self.split == "val" else 0  # disjoint seed streams
        for i in range(self.steps):
            yield self.base + salt + (0 if self.frozen else self.epoch * self.steps + i)


__main_dataset__ = OnDeviceHomographyDataset
