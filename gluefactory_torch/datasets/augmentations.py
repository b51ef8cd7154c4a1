"""Photometric augmentations of the host homography dataset
(gluefactory_tpu/datasets/augmentations.py): ``identity``, ``lg`` (hue and
saturation, brightness and contrast, gamma, blur, elliptical shade, noise)
and ``dark``, on float32 HWC images in [0, 1]. Each draws the same numbers
from the same ``numpy`` generator in the same order as the JAX package's;
its OpenCV calls are ``utils/image``'s numpy counterparts (HSV, Gaussian
blur) and ``fill_ellipse`` (OpenCV's filled ellipse)."""

from __future__ import annotations

import numpy as np

from ..utils.image import gaussian_blur, hsv_to_rgb, rgb_to_hsv
from .homographies_ondevice import fill_ellipse


def _rand(rng, lo, hi):
    return float(rng.uniform(lo, hi))


def random_brightness_contrast(img, rng, brightness=0.2, contrast=0.2, p=0.5):
    if rng.uniform() > p:
        return img
    alpha = 1.0 + _rand(rng, -contrast, contrast)
    beta = _rand(rng, -brightness, brightness)
    return np.clip(img * alpha + beta, 0.0, 1.0)


def random_gamma(img, rng, gamma=(0.5, 2.0), p=0.3):
    if rng.uniform() > p:
        return img
    g = _rand(rng, *gamma)
    return np.clip(np.power(np.clip(img, 1e-6, 1.0), g), 0.0, 1.0)


def _blur(img, k):
    """``cv2.GaussianBlur(img, (k, k), 0)``, keeping a trailing channel axis."""
    return gaussian_blur(img, k).astype(img.dtype)


def random_blur(img, rng, max_ksize=3, p=0.25):
    if rng.uniform() > p:
        return img
    return _blur(img, 2 * int(rng.integers(1, max_ksize + 1)) + 1)


def random_noise(img, rng, std=0.02, p=0.5):
    if rng.uniform() > p:
        return img
    return np.clip(img + rng.normal(0.0, std, size=img.shape).astype(img.dtype), 0.0, 1.0)


def random_additive_shade(img, rng, nb_ellipses=10, transparency=(-0.5, 0.8), p=0.3):
    """Soft elliptical shading: filled ellipses on a mask, blurred by a kernel
    a tenth of the image's larger side."""
    if rng.uniform() > p:
        return img
    h, w = img.shape[:2]
    mask = np.zeros((h, w), np.float32)
    for _ in range(nb_ellipses):
        ax = int(max(rng.integers(5, max(6, w // 4)), 1))
        ay = int(max(rng.integers(5, max(6, h // 4)), 1))
        x = int(rng.integers(ax, max(w - ax, ax + 1)))
        y = int(rng.integers(ay, max(h - ay, ay + 1)))
        fill_ellipse(mask, (x, y), (ax, ay), _rand(rng, 0, 90), 255.0)
    t = _rand(rng, *transparency)
    mask = _blur(mask, int(max(h, w) * 0.1) | 1) / 255.0
    shaded = img * (1.0 - t * mask[..., None] if img.ndim == 3 else 1.0 - t * mask)
    return np.clip(shaded, 0.0, 1.0)


def random_hue_saturation(img, rng, hue=10, sat=0.3, p=0.3):
    if rng.uniform() > p or img.ndim != 3 or img.shape[2] != 3:
        return img
    hsv = rgb_to_hsv((img * 255).astype(np.uint8)).astype(np.float32)
    hsv[..., 0] = (hsv[..., 0] + _rand(rng, -hue, hue)) % 180
    hsv[..., 1] = np.clip(hsv[..., 1] * (1 + _rand(rng, -sat, sat)), 0, 255)
    return hsv_to_rgb(hsv.astype(np.uint8)).astype(np.float32) / 255.0


class IdentityAugmentation:
    def __call__(self, img: np.ndarray, rng) -> np.ndarray:
        return img


class LGAugmentation(IdentityAugmentation):
    """LightGlue's training pipeline."""

    def __call__(self, img, rng):
        img = random_hue_saturation(img, rng)
        img = random_brightness_contrast(img, rng)
        img = random_gamma(img, rng)
        img = random_blur(img, rng)
        img = random_additive_shade(img, rng)
        img = random_noise(img, rng)
        return img.astype(np.float32)


class DarkAugmentation(IdentityAugmentation):
    """Aggressive low light."""

    def __call__(self, img, rng):
        img = random_gamma(img, rng, gamma=(1.5, 3.0), p=0.9)
        img = random_brightness_contrast(img, rng, brightness=0.4, contrast=0.4, p=0.9)
        img = random_noise(img, rng, std=0.05, p=0.8)
        img = random_blur(img, rng, p=0.4)
        return img.astype(np.float32)


augmentations = {
    "identity": IdentityAugmentation,
    "lg": LGAugmentation,
    "dark": DarkAugmentation,
}
