"""Photometric augmentation of image batches on the device
(gluefactory_tpu/ops/photometric.py): contrast, brightness, gamma,
low-frequency shading, Gaussian blur and additive noise, each applied to an
image with its own probability and amplitude.

Split in two so that tests can feed another generator's numbers:
``photometric_draws`` makes every random number from a ``torch.Generator``
(uniforms in [0, 1) and the noise), ``photometric_apply`` is deterministic
given them. A uniform u becomes max(lo, u * (hi - lo) + lo) in float32 and a
coin with probability p is u < p, as jax.random does."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _range(u: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    lo_t = torch.tensor(lo, dtype=u.dtype, device=u.device)
    hi_t = torch.tensor(hi, dtype=u.dtype, device=u.device)
    return torch.maximum(lo_t, u * (hi_t - lo_t) + lo_t)


def _separable_blur(images: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """5-tap Gaussian blur (B, H, W, C) with a per-image sigma (B,), edges
    repeated."""
    offs = torch.arange(-2, 3, dtype=torch.float32, device=images.device)
    w = torch.exp(-0.5 * (offs[None, :] / sigma[:, None].clamp_min(1e-3)) ** 2)
    w = w / w.sum(dim=1, keepdim=True)

    def blur_axis(x, axis):
        n = x.shape[axis]
        idx = torch.arange(-2, n + 2, device=x.device).clamp(0, n - 1)
        xp = x.index_select(axis, idx)
        out = torch.zeros_like(x)
        for i in range(5):
            out = out + xp.narrow(axis, i, n) * w[:, i].reshape(-1, 1, 1, 1)
        return out

    return blur_axis(blur_axis(images, 1), 2)


def photometric_draws(generator: torch.Generator, shape: tuple[int, ...]) -> dict:
    """Every random number ``photometric_apply`` needs for images of ``shape``
    (B, H, W, C), drawn on the generator's device."""
    b = shape[0]

    def rand(*s):
        return torch.rand(*s, generator=generator, device=generator.device)

    draws = {f"apply_{name}": rand(b)
             for name in ("contrast", "bright", "gamma", "shade", "blur", "noise")}
    draws.update(contrast=rand(b, 1, 1, 1), bright=rand(b, 1, 1, 1), gamma=rand(b, 1, 1, 1),
                 shade=rand(b, 4, 4, 1), blur=rand(b), noise_amp=rand(b, 1, 1, 1),
                 noise=torch.randn(*shape, generator=generator, device=generator.device))
    return draws


def photometric_apply(images: torch.Tensor, draws: dict, p: float = 0.95,
                      strength: float = 1.0) -> torch.Tensor:
    """Jitter images (B, H, W, C) in [0, 1] with the numbers of
    ``photometric_draws``. ``strength`` scales every amplitude; ``p`` is the
    probability of each transform (0.6 p for shading, 0.3 p for blur)."""
    b = images.shape[0]
    s = strength

    def coin(name, prob):
        return (draws[f"apply_{name}"] < prob).reshape(b, 1, 1, 1)

    x = images
    contrast = torch.where(coin("contrast", p), _range(draws["contrast"], 1 - 0.4 * s,
                                                       1 + 0.4 * s), 1.0)
    mean = x.mean(dim=(1, 2, 3), keepdim=True)
    x = mean + (x - mean) * contrast
    x = x + torch.where(coin("bright", p), _range(draws["bright"], -0.15 * s, 0.15 * s), 0.0)
    gamma = torch.where(coin("gamma", p), _range(draws["gamma"], 1 - 0.3 * s, 1 + 0.3 * s), 1.0)
    x = x.clamp(1e-4, 1.0) ** gamma
    field = _range(draws["shade"], 1 - 0.5 * s, 1.0).permute(0, 3, 1, 2)
    field = F.interpolate(field, size=x.shape[1:3], mode="bilinear",
                          align_corners=False).permute(0, 2, 3, 1)
    x = x * torch.where(coin("shade", p * 0.6), field, 1.0)
    blurred = _separable_blur(x, _range(draws["blur"], 0.2, 1.3 * s + 0.2))
    x = torch.where(coin("blur", 0.3 * p), blurred, x)
    amp = _range(draws["noise_amp"], 0.0, 0.04 * s)
    x = x + torch.where(coin("noise", p), draws["noise"] * amp, 0.0)
    return x.clamp(0.0, 1.0)


def photometric_augment(generator: torch.Generator, images: torch.Tensor, p: float = 0.95,
                        strength: float = 1.0) -> torch.Tensor:
    """Random photometric jitter of a batch (B, H, W, C) in [0, 1]."""
    return photometric_apply(images, photometric_draws(generator, images.shape), p, strength)
