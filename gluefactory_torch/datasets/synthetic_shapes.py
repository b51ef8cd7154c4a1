"""The host synthetic-shapes dataset (gluefactory_tpu/datasets/
synthetic_shapes.py): single views of drawn polygons and segments with
exact point and line ground truth, for JPLDD's training
(``jpldd_train_synthetic``).

``draw_scene`` makes the JAX package's draws in the same order and
rasterises with the port's numpy drawing (``homographies_ondevice
.fill_polygon`` and ``draw_line``, where JAX calls ``cv2.fillPoly`` and a
2-pixel ``cv2.line``), in colour on a float32 canvas: the ground truth is
the same, the pixels differ on shapes' edges. Each item holds the image,
the vertex heatmap (1 at each vertex, blurred as ``cv2.GaussianBlur`` with
a 7-tap kernel of ``heatmap_sigma``, scaled to a maximum of 1), the exact
distance field and the orientation (mod pi) of the nearest segment
(``exact_df_af``), and the segments in ``max_segments`` slots. Train items
go through the ``lg`` photometric augmentation with probability
``photometric.p``."""

from __future__ import annotations

from typing import ClassVar

import numpy as np

from ..utils.image import gaussian_blur
from .augmentations import augmentations
from .base_dataset import BaseDataset
from .homographies_ondevice import draw_line, fill_polygon


def draw_scene(rng: np.random.Generator, size: int, max_segments: int):
    """Random polygons and standalone segments on a shaded colour canvas:
    (image (size, size, 3) in [0, 1], segments (<= max_segments, 2, 2),
    vertices (V, 2))."""
    img = np.full((size, size, 3), rng.uniform(0.2, 0.8), np.float32)
    img += rng.normal(0, 0.02, img.shape).astype(np.float32)
    segments, vertices = [], []
    for _ in range(int(rng.integers(1, 4))):
        n_pts = int(rng.integers(3, 6))
        cx, cy = rng.uniform(size * 0.15, size * 0.85, 2)
        radius = rng.uniform(size * 0.08, size * 0.3)
        angles = np.sort(rng.uniform(0, 2 * np.pi, n_pts))
        pts = np.clip(np.stack([cx + radius * np.cos(angles), cy + radius * np.sin(angles)], -1),
                      2, size - 3)
        color = tuple(float(c) for c in rng.uniform(0, 1, 3))
        fill_polygon(img, pts.astype(np.int32).astype(np.float64), color)
        for i in range(n_pts):
            segments.append((pts[i], pts[(i + 1) % n_pts]))
            vertices.append(pts[i])
    for _ in range(int(rng.integers(1, 5))):
        p0 = rng.uniform(5, size - 5, 2)
        ang = rng.uniform(0, 2 * np.pi)
        ln = rng.uniform(size * 0.15, size * 0.5)
        p1 = np.clip(p0 + ln * np.array([np.cos(ang), np.sin(ang)]), 2, size - 3)
        color = tuple(float(c) for c in rng.uniform(0, 1, 3))
        draw_line(img, p0.astype(int).astype(np.float64), p1.astype(int).astype(np.float64),
                  color, 2)
        segments.append((p0, p1))
        vertices += [p0, p1]
    segments = np.asarray(segments, np.float32)[:max_segments]
    return np.clip(img, 0, 1), segments, np.asarray(vertices, np.float32)


def exact_df_af(segments: np.ndarray, size: int):
    """The exact distance of each pixel to the nearest segment (size, size)
    and that segment's orientation mod pi."""
    ys, xs = np.mgrid[0:size, 0:size]
    p = np.stack([xs, ys], -1).reshape(-1, 2).astype(np.float32)[:, None]  # (P, 1, 2)
    a, b = segments[:, 0][None], segments[:, 1][None]
    ab = b - a
    t = np.clip(np.sum((p - a) * ab, -1) / (np.sum(ab * ab, -1) + 1e-8), 0.0, 1.0)
    d = np.linalg.norm(p - (a + t[..., None] * ab), axis=-1)  # (P, L)
    df = d.min(-1).reshape(size, size).astype(np.float32)
    seg_ang = np.arctan2(ab[0, :, 1], ab[0, :, 0]) % np.pi
    return df, seg_ang[d.argmin(-1)].reshape(size, size).astype(np.float32)


class SyntheticShapesDataset(BaseDataset):
    default_conf: ClassVar[dict] = {
        "name": "synthetic_shapes",
        "image_size": 240,
        "max_segments": 32,
        "max_vertices": 64,
        "train_size": 10000,
        "val_size": 200,
        "photometric": {"name": "lg", "p": 0.5},
        "heatmap_sigma": 1.0,
    }

    def __init__(self, conf: dict | None = None):
        super().__init__(conf)
        self.photometric = augmentations[self.conf["photometric"]["name"]]()

    def get_dataset(self, split: str) -> "SyntheticShapesSplit":
        return SyntheticShapesSplit(self, split)


class SyntheticShapesSplit:
    def __init__(self, parent: SyntheticShapesDataset, split: str):
        self.parent, self.conf, self.split = parent, parent.conf, split

    def __len__(self) -> int:
        return int(self.conf["val_size" if self.split == "val" else "train_size"])

    def getitem(self, idx: int, rng: np.random.Generator) -> dict:
        conf = self.conf
        s = int(conf["image_size"])
        salt = 104729 if self.split == "val" else 0
        img, segments, vertices = draw_scene(np.random.default_rng((int(conf["seed"]), idx + salt)),
                                             s, int(conf["max_segments"]))
        df, af = exact_df_af(segments, s)
        heat = np.zeros((s, s), np.float32)
        vi = np.clip(np.round(vertices).astype(int), 0, s - 1)
        heat[vi[:, 1], vi[:, 0]] = 1.0
        sigma = float(conf["heatmap_sigma"])
        if sigma > 0:
            heat = gaussian_blur(heat, int(sigma * 6) | 1, sigma)
            heat = heat / max(heat.max(), 1e-8)
        if self.split == "train" and rng.uniform() < float(conf["photometric"]["p"]):
            img = self.parent.photometric(img, rng)
        n_seg = int(conf["max_segments"])
        segs = np.zeros((n_seg, 2, 2), np.float32)
        seg_valid = np.zeros((n_seg,), bool)
        segs[:len(segments)], seg_valid[:len(segments)] = segments, True
        return {"image": img.astype(np.float32), "image_size": np.array([s, s], np.float32),
                "gt_heatmap": heat, "gt_distance_field": df, "gt_angle_field": af,
                "gt_segments": segs, "gt_segment_valid": seg_valid, "idx": np.int32(idx),
                "name": f"synth/{idx}"}

    def __getitem__(self, idx: int) -> dict:
        return self.getitem(idx, np.random.default_rng(idx))


__main_dataset__ = SyntheticShapesDataset
