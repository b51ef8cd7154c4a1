"""Procedural scene families for the benchmark renderer
(gluefactory_tpu/datasets/scene_families.py), in numpy.

Family B is the held-out evaluation family: multi-octave value noise,
dead-leaves disks with radial shading, a Voronoi mosaic, an oriented grating
and a smooth illumination field with sensor noise; no training pool draws
from it. ``photometric_view`` renders illumination variants of a scene with
an identity homography (the HPatches i_ split). The random draws are the JAX
module's, in the same order; the OpenCV calls there are replaced by
``utils.image.resize`` (INTER_CUBIC), ``utils.image.gaussian_blur`` and
``homographies_ondevice.fill_ellipse``. OpenCV fills an ellipse as a
72-sided polygon and this module fills the ellipse itself: the blur that
follows hides the difference on its edge."""

from __future__ import annotations

import numpy as np

from ..utils.image import gaussian_blur, resize
from .homographies_ondevice import fill_ellipse


def _value_noise(rng: np.random.Generator, w: int, h: int, octaves: int = 5) -> np.ndarray:
    """Multi-octave bicubically-upsampled value noise in [0, 1]."""
    img = np.zeros((h, w), np.float32)
    amp_total = 0.0
    for o in range(octaves):
        n = 2 ** (o + 2) + 1
        grid = rng.uniform(0.0, 1.0, (n, n)).astype(np.float32)
        layer = resize(grid, (w, h), "cubic")
        amp = 0.55 ** o
        img += amp * layer
        amp_total += amp
    return np.clip(img / amp_total, 0.0, 1.0)


def _dead_leaves(rng: np.random.Generator, img: np.ndarray, n_disks: int) -> None:
    """Occluding disks with power-law radii and radial shading, in place."""
    h, w = img.shape
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    for _ in range(n_disks):
        # power-law radius distribution (scale-invariant occlusions)
        r = float(np.clip(4.0 / rng.uniform(0.04, 1.0) ** 0.7, 4.0, min(h, w) / 3.0))
        cx, cy = rng.uniform(0, w), rng.uniform(0, h)
        base = float(rng.uniform(0.05, 0.95))
        grad = float(rng.uniform(-0.35, 0.35))
        x0, x1 = int(max(0, cx - r - 1)), int(min(w, cx + r + 2))
        y0, y1 = int(max(0, cy - r - 1)), int(min(h, cy + r + 2))
        if x0 >= x1 or y0 >= y1:
            continue
        d = np.hypot(xx[y0:y1, x0:x1] - cx, yy[y0:y1, x0:x1] - cy) / r
        inside = d <= 1.0
        shade = np.clip(base + grad * d, 0.0, 1.0)
        patch = img[y0:y1, x0:x1]
        patch[inside] = shade[inside]


def _voronoi_mosaic(rng: np.random.Generator, img: np.ndarray) -> None:
    """Fill a random subregion with a Voronoi cell mosaic, in place."""
    h, w = img.shape
    rw = int(rng.uniform(0.35, 0.8) * w)
    rh = int(rng.uniform(0.35, 0.8) * h)
    x0 = int(rng.uniform(0, w - rw))
    y0 = int(rng.uniform(0, h - rh))
    n_cells = int(rng.integers(8, 28))
    seeds = np.stack(
        [rng.uniform(0, rw, n_cells), rng.uniform(0, rh, n_cells)], -1
    ).astype(np.float32)
    tones = rng.uniform(0.1, 0.9, n_cells).astype(np.float32)
    yy, xx = np.mgrid[0:rh, 0:rw].astype(np.float32)
    d2 = (
        (xx[..., None] - seeds[None, None, :, 0]) ** 2
        + (yy[..., None] - seeds[None, None, :, 1]) ** 2
    )
    lab = np.argmin(d2, axis=-1)
    # soft alpha blend at the region border so the mosaic doesn't add an
    # axis-aligned rectangle edge (that would be a family-A primitive)
    alpha = np.minimum.reduce([
        np.minimum(xx, rw - 1 - xx) / max(rw * 0.08, 1.0),
        np.minimum(yy, rh - 1 - yy) / max(rh * 0.08, 1.0),
    ])
    alpha = np.clip(alpha, 0.0, 1.0)
    region = img[y0:y0 + rh, x0:x0 + rw]
    img[y0:y0 + rh, x0:x0 + rw] = (1 - alpha) * region + alpha * tones[lab]


def _grating(rng: np.random.Generator, img: np.ndarray) -> None:
    """Blend an oriented sinusoidal grating into a soft elliptical window."""
    h, w = img.shape
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    theta = rng.uniform(0, np.pi)
    freq = rng.uniform(0.05, 0.25)
    phase = rng.uniform(0, 2 * np.pi)
    wave = 0.5 + 0.5 * np.sin(
        freq * (np.cos(theta) * xx + np.sin(theta) * yy) + phase
    )
    cx, cy = rng.uniform(0.2 * w, 0.8 * w), rng.uniform(0.2 * h, 0.8 * h)
    ax, ay = rng.uniform(0.1, 0.3) * w, rng.uniform(0.1, 0.3) * h
    win = np.exp(-(((xx - cx) / ax) ** 2 + ((yy - cy) / ay) ** 2))
    a = float(rng.uniform(0.4, 0.9))
    img[:] = (1 - a * win) * img + a * win * wave


def generate_textured_scene(
    rng: np.random.Generator, size: tuple[int, int]
) -> np.ndarray:
    """Family-B scene: (h, w) float32 grayscale in [0, 1]."""
    w, h = size
    img = _value_noise(rng, w, h)
    _dead_leaves(rng, img, n_disks=int(rng.integers(50, 140)))
    if rng.uniform() < 0.85:
        _voronoi_mosaic(rng, img)
    if rng.uniform() < 0.7:
        _grating(rng, img)
    # smooth global illumination field
    light = _value_noise(rng, w, h, octaves=2)
    img = img * (0.6 + 0.55 * light)
    img = img + rng.normal(0, 0.012, img.shape).astype(np.float32)
    return np.clip(img, 0.0, 1.0).astype(np.float32)


def photometric_view(rng: np.random.Generator, img: np.ndarray) -> np.ndarray:
    """HPatches-"i_"-style illumination variant of a base scene (identity
    geometry): gamma + gain/bias, soft elliptical additive shade, vignette,
    optional slight blur, sensor noise. img (h, w) float32 [0, 1]."""
    h, w = img.shape
    out = img.astype(np.float32)
    gamma = rng.uniform(0.45, 1.9)
    gain = rng.uniform(0.55, 1.45)
    bias = rng.uniform(-0.12, 0.12)
    out = np.clip(gain * out ** gamma + bias, 0.0, 1.0)
    # soft elliptical shadows/highlights
    mask = np.zeros((h, w), np.float32)
    for _ in range(int(rng.integers(2, 7))):
        ax = int(rng.integers(w // 8, w // 2))
        ay = int(rng.integers(h // 8, h // 2))
        x = int(rng.integers(0, w))
        y = int(rng.integers(0, h))
        fill_ellipse(mask, (x, y), (ax, ay), float(rng.uniform(0, 180)), 1.0)
    k = (int(max(h, w) * 0.12) | 1)
    mask = gaussian_blur(mask, k)
    t = rng.uniform(-0.45, 0.45)
    out = np.clip(out * (1.0 - t * mask), 0.0, 1.0)
    # vignette
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    r2 = ((xx - w / 2) / (w / 2)) ** 2 + ((yy - h / 2) / (h / 2)) ** 2
    v = rng.uniform(0.0, 0.35)
    out = out * (1.0 - v * r2)
    if rng.uniform() < 0.3:
        out = gaussian_blur(out, 3)
    out = out + rng.normal(0, rng.uniform(0.005, 0.03), out.shape)
    return np.clip(out, 0.0, 1.0).astype(np.float32)
