"""The procedural colour scene of the homography datasets
(gluefactory_tpu/datasets/homographies.py ``generate_structured_image``):
polygons, rectangles, ellipses and lines on a shaded background, with
texture noise. The JAX package draws it with cv2; here the shapes are the
numpy rasterisers of ``homographies_ondevice`` (OpenCV's fill rules), with
the same random draws in the same order. Only the scene is ported, for the
pose benchmark's renderer (``scripts/generate_pose_eval_set.py``)."""

from __future__ import annotations

import numpy as np

from .homographies_ondevice import draw_line, fill_ellipse, fill_polygon, fill_rectangle


def generate_structured_image(rng: np.random.Generator, size=(800, 600)) -> np.ndarray:
    """A float32 (h, w, 3) image in [0, 1] for ``size`` (w, h)."""
    w, h = size
    gx = np.linspace(0, 1, w, dtype=np.float32)[None, :]
    gy = np.linspace(0, 1, h, dtype=np.float32)[:, None]
    a, b, c = rng.uniform(0.1, 0.9, 3)
    img = (a * gx + b * gy + c) / (a + b + c + 1e-8)
    img = np.repeat(img[..., None], 3, axis=2)
    img *= rng.uniform(0.4, 1.0, size=(1, 1, 3)).astype(np.float32)
    img = np.ascontiguousarray(img)
    for _ in range(int(rng.integers(10, 30))):
        color = tuple(float(x) for x in rng.uniform(0, 1, 3))
        kind = rng.integers(0, 4)
        if kind == 0:  # polygon
            n_pts = int(rng.integers(3, 7))
            cx, cy = rng.uniform(0, w), rng.uniform(0, h)
            r = rng.uniform(10, min(w, h) / 4)
            ang = np.sort(rng.uniform(0, 2 * np.pi, n_pts))
            pts = np.stack([cx + r * np.cos(ang), cy + r * np.sin(ang)], -1).astype(np.int32)
            fill_polygon(img, pts.astype(np.float64), color)
        elif kind == 1:  # rectangle
            x0, y0 = rng.uniform(0, w - 20), rng.uniform(0, h - 20)
            x1, y1 = x0 + rng.uniform(10, w / 3), y0 + rng.uniform(10, h / 3)
            fill_rectangle(img, int(x0), int(y0), int(x1), int(y1), color)
        elif kind == 2:  # ellipse
            center = (int(rng.uniform(0, w)), int(rng.uniform(0, h)))
            axes = (int(rng.uniform(5, w / 6)), int(rng.uniform(5, h / 6)))
            fill_ellipse(img, center, axes, float(rng.uniform(0, 180)), color)
        else:  # line
            p0 = (int(rng.uniform(0, w)), int(rng.uniform(0, h)))
            p1 = (int(rng.uniform(0, w)), int(rng.uniform(0, h)))
            draw_line(img, p0, p1, color, int(rng.integers(1, 5)))
    img += rng.normal(0, 0.02, img.shape).astype(np.float32)
    return np.clip(img, 0.0, 1.0)
