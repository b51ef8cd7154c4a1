"""SIFT (gluefactory_tpu/models/extractors/sift.py): OpenCV's detector and
descriptor, computed by PyTorch on the tensor's device.

The JAX package calls ``cv2.SIFT_create(nfeatures=k, contrastThreshold=c)``
on the host. The port computes the same thing itself, in float32, step for
step as OpenCV does, batched and with static shapes:

- the grey image of the JAX wrapper (its weighted sum as XLA compiles it:
  fused multiply-adds), truncated to uint8;
- the base image doubled by bilinear resize (half-pixel centres) and blurred
  to sigma 1.6 (``firstOctave = -1``); octaves of 3 layers, each next octave
  every second pixel of the layer of twice the base sigma;
- Gaussian blurs with OpenCV's kernels (``getGaussianKernel`` in double,
  cast to float32), reflect-101 borders, the row pass a chain of fused
  multiply-adds and the column pass symmetric tap pairs, as OpenCV's vector
  code runs them (a fused multiply-add is one float64 multiply-add rounded
  to float32, exact on the CPU and on the card alike): the blurs equal
  ``cv2.GaussianBlur``'s bit for bit;
- extrema of the difference of Gaussians over 26 neighbours (non-strict),
  above ``floor(0.5 c / 3 * 255)``, 5 pixels from the border;
- OpenCV's sub-pixel refinement: up to 5 Newton steps on the 3x3 Hessian
  (Cramer's rule in float32), the contrast and edge (r = 10) tests. Every
  position of the scale space takes its step once, densely; the extrema
  then follow the positions' steps, so no candidate list is needed. Two
  extrema that converge to one position give one keypoint, as
  ``removeDuplicatedSorted`` leaves one;
- the keypoints with the ``k`` largest responses (``retainBest`` before the
  descriptors), each location's orientations from its 36-bin histogram
  (radius ``round(4.5 sigma)``, [1, 4, 6, 4, 1] smoothing, peaks at 0.8 of
  the largest with a parabolic fit, OpenCV's ``fastAtan2``);
- the 4x4x8 descriptor with trilinear weights, clipped at 0.2 of its norm,
  scaled by 512 and rounded to integers; then RootSIFT.

Slots are sorted by response; ``keypoint_valid`` marks the filled ones and
the others hold zeros, as in the JAX wrapper. ``keypoints`` are OpenCV's
``pt`` (pixel centres at integers), ``scales`` its ``size`` and ``oris`` its
``angle`` in radians."""

from __future__ import annotations

import math
from typing import ClassVar

import numpy as np
import torch
import torch.nn.functional as F

from ..base_model import BaseModel

LAYERS = 3  # OpenCV's nOctaveLayers
SIGMA = 1.6
INIT_SIGMA = 0.5
BORDER = 5
MAX_STEPS = 5
EDGE = 10.0
ORI_BINS = 36
ORI_MAX_RADIUS = 16  # round(4.5 * 1.6 * 2^(3.5 / 3)): the largest orientation window
DESC_WIDTH = 4
DESC_BINS = 8
DESC_MAX_RADIUS = 38  # round(3 * sqrt(2) * 2.5 * 1.6 * 2^(3.5 / 3))
GRAY = (0.299, 0.587, 0.114)
CHUNK = 128  # keypoints whose windows are gathered at once

_F32 = np.float32
IMG_SCALE = float(_F32(1) / _F32(255))
DERIV_SCALE = float(_F32(IMG_SCALE) * _F32(0.5))
CROSS_SCALE = float(_F32(IMG_SCALE) * _F32(0.25))
FLT_EPSILON = float(np.finfo(np.float32).eps)
INT_MAX_3 = float(_F32(2**31 - 1) // 3)  # (float)(INT_MAX / 3)
# OpenCV's fastAtan2 coefficients, in degrees
_DEG = float(_F32(180 / math.pi))
ATAN_P = [float(_F32(c) * _F32(_DEG)) for c in (0.9997878412794807, -0.3258083974640975,
                                                 0.1555786518463281, -0.04432655554792128)]


def _fma(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as a fused multiply-add: the
    product is exact in float64."""
    b = b.double() if isinstance(b, torch.Tensor) else b
    return (a.double() * b + c.double()).float()


def gaussian_kernel(sigma: float) -> np.ndarray:
    """``cv2.getGaussianKernel(ksize, sigma, CV_32F)`` with GaussianBlur's
    size for a float image, ``round(8 sigma + 1) | 1``."""
    n = int(np.rint(sigma * 8 + 1)) | 1
    x = np.arange(n) - (n - 1) * 0.5
    t = np.exp(-0.5 / (sigma * sigma) * x * x)
    total = 0.0
    for v in t:  # OpenCV's sequential double sum
        total += float(v)
    return (t * (1.0 / total)).astype(np.float32)


def _reflect101(n: int, r: int, device) -> torch.Tensor:
    """Source indices of ``-r .. n + r - 1`` with BORDER_REFLECT_101."""
    i = torch.arange(-r, n + r, device=device)
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    i = i.abs() % period
    return torch.where(i >= n, period - i, i)


def _taps(xp: torch.Tensor, k: list, n: int, fused: bool, symmetric: bool) -> torch.Tensor:
    """A 1-D filter along the last axis of the padded ``xp`` (n outputs): the
    taps in order (``s = x0 k0; s += xj kj``) or, ``symmetric``, the centre
    first and then mirrored pairs (``s += (x-j + x+j) kj``, the pair summed in
    float32); each step a fused multiply-add (``add`` of a float64 operand in
    float64, where the product is exact, then rounded to float32) or a
    product and a sum in float32."""
    r = len(k) // 2
    if not symmetric:
        xs = xp.double() if fused else xp
        s = xp[..., 0:n] * k[0]
        for j in range(1, len(k)):
            s = torch.add(s, xs[..., j:j + n], alpha=k[j]).float() if fused else (
                s + xp[..., j:j + n] * k[j])
        return s
    s = xp[..., r:r + n] * k[r]
    for j in range(1, r + 1):
        pair = xp[..., r - j:r - j + n] + xp[..., r + j:r + j + n]
        s = torch.add(s, pair.double(), alpha=k[r + j]).float() if fused else s + pair * k[r + j]
    return s


def gaussian_blur(x: torch.Tensor, sigma: float) -> torch.Tensor:
    """``cv2.GaussianBlur(x, (0, 0), sigma)`` of float32 images (..., H, W),
    bit for bit: OpenCV's row pass runs fused multiply-adds in its vector
    loops over the first multiple of 4 of a row's pixels and a product and a
    sum per tap over the rest; its column pass (symmetric pairs) fuses over
    the first multiple of 8."""
    k = [float(v) for v in gaussian_kernel(sigma)]
    r = len(k) // 2
    h, w = x.shape[-2:]
    xp = x.index_select(-1, _reflect101(w, r, x.device))
    vec = w // 4 * 4
    rows = torch.cat([_taps(xp[..., :vec + 2 * r], k, vec, True, False),
                      _taps(xp[..., vec:], k, w - vec, False, False)], -1)
    xp = rows.index_select(-2, _reflect101(h, r, x.device)).transpose(-1, -2)
    vec = w // 8 * 8
    cols = torch.cat([_taps(xp[..., :vec, :], k, h, True, True),
                      _taps(xp[..., vec:, :], k, h, False, True)], -2)
    return cols.transpose(-1, -2).contiguous()


def upsample2(x: torch.Tensor) -> torch.Tensor:
    """``cv2.resize`` to twice the size, INTER_LINEAR: weights 1/4 and 3/4,
    edges clamped; exact in float32 for uint8 values."""
    def along(t: torch.Tensor, dim: int) -> torch.Tensor:
        dim = dim % t.ndim
        n = t.shape[dim]
        idx = torch.arange(n, device=t.device)
        lo = t.index_select(dim, (idx - 1).clamp_min(0))
        hi = t.index_select(dim, (idx + 1).clamp_max(n - 1))
        even = lo * 0.25 + t * 0.75
        odd = t * 0.75 + hi * 0.25
        first = t.narrow(dim, 0, 1)
        last = t.narrow(dim, n - 1, 1)
        even = torch.cat([first, even.narrow(dim, 1, n - 1)], dim)
        odd = torch.cat([odd.narrow(dim, 0, n - 1), last], dim)
        return torch.stack([even, odd], dim + 1).flatten(dim, dim + 1)

    return along(along(x, -1), -2)


def layer_sigmas() -> list[float]:
    """The blur between consecutive layers of an octave (OpenCV's ``sig``)."""
    k = 2.0 ** (1.0 / LAYERS)
    sig = [SIGMA]
    for i in range(1, LAYERS + 3):
        prev = k ** (i - 1) * SIGMA
        total = prev * k
        sig.append(math.sqrt(total * total - prev * prev))
    return sig


def octave_count(h: int, w: int) -> int:
    """OpenCV's octave count for an image of (h, w), from the doubled base."""
    return int(np.rint(np.log(min(2 * h, 2 * w)) / np.log(2.0) - 2)) + 1


def gaussian_pyramid(gray: torch.Tensor) -> list[list[torch.Tensor]]:
    """The octaves of uint8-valued float images (B, H, W), 6 layers each, for
    every octave whose interior can hold an extremum."""
    f32 = _F32
    base_sigma = float(np.sqrt(max(f32(SIGMA) * f32(SIGMA) - f32(INIT_SIGMA * INIT_SIGMA * 4),
                                   f32(0.01))).astype(f32))
    base = gaussian_blur(upsample2(gray), base_sigma)
    sig = layer_sigmas()
    octaves = []
    for o in range(octave_count(*gray.shape[-2:])):
        if o:
            prev = octaves[-1][LAYERS]
            h, w = prev.shape[-2] // 2, prev.shape[-1] // 2
            base = prev[..., 0:2 * h:2, 0:2 * w:2]
        if min(base.shape[-2:]) <= 2 * BORDER:
            break
        layers = [base]
        for i in range(1, LAYERS + 3):
            layers.append(gaussian_blur(layers[-1], sig[i]))
        octaves.append(layers)
    return octaves


def _shift(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """``out[..., r, c] = x[..., r + dy, c + dx]``, zeros past the border."""
    h, w = x.shape[-2:]
    p = F.pad(x, (1, 1, 1, 1))
    return p[..., 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]


def _solve3(a, b):
    """OpenCV's ``Matx33f::solve`` (Cramer's rule in float32): x with
    ``a x = b``, zeros where the determinant is 0. ``a`` is a 3x3 nested
    list of tensors, ``b`` a list of 3."""
    det = (a[0][0] * (a[1][1] * a[2][2] - a[2][1] * a[1][2])
           - a[0][1] * (a[1][0] * a[2][2] - a[2][0] * a[1][2])
           + a[0][2] * (a[1][0] * a[2][1] - a[2][0] * a[1][1]))
    ok = det != 0
    d = 1 / torch.where(ok, det, torch.ones_like(det))
    x0 = d * (b[0] * (a[1][1] * a[2][2] - a[1][2] * a[2][1])
              - a[0][1] * (b[1] * a[2][2] - a[1][2] * b[2])
              + a[0][2] * (b[1] * a[2][1] - a[1][1] * b[2]))
    x1 = d * (a[0][0] * (b[1] * a[2][2] - a[1][2] * b[2])
              - b[0] * (a[1][0] * a[2][2] - a[1][2] * a[2][0])
              + a[0][2] * (a[1][0] * b[2] - b[1] * a[2][0]))
    x2 = d * (a[0][0] * (a[1][1] * b[2] - b[1] * a[2][1])
              - a[0][1] * (a[1][0] * b[2] - b[1] * a[2][0])
              + b[0] * (a[1][0] * a[2][1] - a[1][1] * a[2][0]))
    zero = torch.zeros_like(det)
    return [torch.where(ok, x, zero) for x in (x0, x1, x2)]


def octave_keypoints(dog: torch.Tensor, contrast: float) -> dict:
    """The keypoint locations of one octave: dog (B, 5, H, W), layers 1-3
    searched. Returns dense maps over (B, 3, H, W), the layers 1-3 at each
    integer position: ``keep`` (a keypoint converged there), ``response``,
    and the offsets ``xc``, ``xr``, ``xi`` of OpenCV's last step."""
    b, _, h, w = dog.shape
    prev, cur, nxt = dog[:, 0:3], dog[:, 1:4], dog[:, 2:5]
    threshold = math.floor(0.5 * contrast / LAYERS * 255)

    # extrema over 26 neighbours, non-strict, 5 pixels from the border
    def pool(x, sign):
        return sign * F.max_pool2d(sign * x, 3, stride=1, padding=1)

    around = [_shift(cur, dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1) if dy or dx]
    hi = torch.maximum(torch.stack(around).amax(0),
                       torch.maximum(pool(prev, 1), pool(nxt, 1)))
    lo = torch.minimum(torch.stack(around).amin(0),
                       torch.minimum(pool(prev, -1), pool(nxt, -1)))
    rr = torch.arange(h, device=dog.device)[:, None]
    cc = torch.arange(w, device=dog.device)[None, :]
    inside = (rr >= BORDER) & (rr < h - BORDER) & (cc >= BORDER) & (cc < w - BORDER)
    extremum = ((cur.abs() > threshold) & inside
                & (((cur > 0) & (cur >= hi)) | ((cur < 0) & (cur <= lo))))

    # one Newton step at every position (OpenCV's adjustLocalExtrema)
    c_r, c_l = _shift(cur, 0, 1), _shift(cur, 0, -1)
    c_d, c_u = _shift(cur, 1, 0), _shift(cur, -1, 0)
    d_d = [(c_r - c_l) * DERIV_SCALE, (c_d - c_u) * DERIV_SCALE, (nxt - prev) * DERIV_SCALE]
    v2 = cur * 2
    dxx = (c_r + c_l - v2) * IMG_SCALE
    dyy = (c_d + c_u - v2) * IMG_SCALE
    dss = (nxt + prev - v2) * IMG_SCALE
    dxy = (_shift(cur, 1, 1) - _shift(cur, 1, -1) - _shift(cur, -1, 1)
           + _shift(cur, -1, -1)) * CROSS_SCALE
    dxs = (_shift(nxt, 0, 1) - _shift(nxt, 0, -1) - _shift(prev, 0, 1)
           + _shift(prev, 0, -1)) * CROSS_SCALE
    dys = (_shift(nxt, 1, 0) - _shift(nxt, -1, 0) - _shift(prev, 1, 0)
           + _shift(prev, -1, 0)) * CROSS_SCALE
    x = _solve3([[dxx, dxy, dxs], [dxy, dyy, dys], [dxs, dys, dss]], d_d)
    xc, xr, xi = -x[0], -x[1], -x[2]
    converged = (xi.abs() < 0.5) & (xr.abs() < 0.5) & (xc.abs() < 0.5)
    finite = torch.isfinite(xi) & torch.isfinite(xr) & torch.isfinite(xc)
    small = (xi.abs() <= INT_MAX_3) & (xr.abs() <= INT_MAX_3) & (xc.abs() <= INT_MAX_3)
    t = d_d[0] * xc + d_d[1] * xr + d_d[2] * xi
    contr = cur * IMG_SCALE + t * 0.5
    tr = dxx + dyy
    det = dxx * dyy - dxy * dxy
    accept = (converged & (contr.abs() * LAYERS >= float(_F32(contrast)))
              & (det > 0) & (tr * tr * EDGE < (EDGE + 1) * (EDGE + 1) * det))

    # where a position that did not converge steps to (flat index; n = nowhere)
    n = 3 * h * w
    layer = torch.arange(3, device=dog.device)[:, None, None]

    def step(v):
        return torch.where(finite & small, v, 0.0).round().clamp(-4 * n, 4 * n).long()

    nl, nr, nc = layer + step(xi), rr + step(xr), cc + step(xc)
    ok = (finite & small & (nl >= 0) & (nl < 3) & (nr >= BORDER) & (nr < h - BORDER)
          & (nc >= BORDER) & (nc < w - BORDER))
    to = torch.where(ok, (nl * h + nr) * w + nc, n).reshape(b, n)
    sentinel = torch.full((b, 1), n, dtype=torch.long, device=dog.device)
    to = torch.cat([to, sentinel], 1)
    conv = torch.cat([converged.reshape(b, n),
                      torch.zeros((b, 1), dtype=torch.bool, device=dog.device)], 1)

    # each extremum follows the steps until a position converges (at most 4 moves)
    at = torch.where(extremum.reshape(b, n), torch.arange(n, device=dog.device), n)
    at = torch.cat([at, sentinel], 1)
    final = torch.full_like(at, n)
    for _ in range(MAX_STEPS):
        here = conv.gather(1, at)
        final = torch.where(here, at, final)
        at = torch.where(here, n, to.gather(1, at))
    keep = torch.zeros((b, n + 1), dtype=torch.bool, device=dog.device)
    keep.scatter_(1, final, True)
    keep = keep[:, :n].reshape(b, 3, h, w) & accept
    return {"keep": keep, "response": contr.abs(), "xc": xc, "xr": xr, "xi": xi}


def fast_atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """OpenCV's ``fastAtan2`` in degrees, [0, 360), as its vector code runs."""
    ax, ay = x.abs(), y.abs()
    c = torch.minimum(ax, ay) / (torch.maximum(ax, ay) + float(_F32(np.finfo(np.float64).eps)))
    cc = c * c
    a = _fma(_fma(_fma(cc, ATAN_P[3], torch.full_like(cc, ATAN_P[2])), cc,
                  torch.full_like(cc, ATAN_P[1])), cc, torch.full_like(cc, ATAN_P[0])) * c
    a = torch.where(ax >= ay, a, 90.0 - a)
    a = torch.where(x < 0, 180.0 - a, a)
    return torch.where(y < 0, 360.0 - a, a)


def _gather(flat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """flat (B, N) read at idx (B, ...)."""
    return flat.gather(1, idx.reshape(idx.shape[0], -1)).reshape(idx.shape)


def orientations(gauss: torch.Tensor, loc: dict) -> torch.Tensor:
    """The smoothed 36-bin gradient-orientation histogram of each location
    (B, K, 36) (OpenCV's calcOrientationHist). ``gauss`` (B, N) holds the
    Gaussian layers the locations index."""
    r = ORI_MAX_RADIUS
    offs = torch.arange(-r, r + 1, device=gauss.device)
    di, dj = offs[:, None].expand(-1, 2 * r + 1).reshape(-1), offs.repeat(2 * r + 1)
    scl = loc["scale"]  # (B, K)
    radius = torch.round(scl * 4.5).long()
    sigma = scl * 1.5
    expf_scale = -1.0 / (sigma * 2.0 * sigma)
    hists = []
    for k0 in range(0, scl.shape[1], CHUNK):
        sl = slice(k0, k0 + CHUNK)
        y = loc["r"][:, sl, None] + di
        x = loc["c"][:, sl, None] + dj
        h, w = loc["h"][:, sl, None], loc["w"][:, sl, None]
        rad = radius[:, sl, None]
        valid = ((di.abs() <= rad) & (dj.abs() <= rad) & (y > 0) & (y < h - 1)
                 & (x > 0) & (x < w - 1) & loc["valid"][:, sl, None])
        base = torch.where(valid, loc["offset"][:, sl, None] + y * w + x, 1)
        w1 = torch.where(valid, w, 0)
        dx = _gather(gauss, base + 1) - _gather(gauss, base - 1)
        dy = _gather(gauss, base - w1) - _gather(gauss, base + w1)
        weight = torch.exp((di * di + dj * dj).float() * expf_scale[:, sl, None])
        ori = fast_atan2(dy, dx)
        mag = torch.sqrt(dx * dx + dy * dy)
        bins = torch.round(ori * float(_F32(ORI_BINS / 360))).long()
        bins = torch.where(bins >= ORI_BINS, bins - ORI_BINS, bins)
        bins = torch.where(bins < 0, bins + ORI_BINS, bins)
        val = torch.where(valid, weight * mag, 0.0)
        onehot = F.one_hot(bins, ORI_BINS).float()
        hists.append(torch.einsum("bks,bksn->bkn", val, onehot))
    t = torch.cat(hists, 1)
    tp = torch.cat([t[..., -2:], t, t[..., :2]], -1)
    n = ORI_BINS
    return _fma(tp[..., 0:n] + tp[..., 4:n + 4], 1 / 16,
                _fma(tp[..., 1:n + 1] + tp[..., 3:n + 3], 4 / 16, tp[..., 2:n + 2] * (6 / 16)))


def peak_angles(hist: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(is a peak, OpenCV's ``angle`` in degrees) for each bin of each
    histogram (B, K, 36): local maxima at 0.8 of the largest, with a
    parabolic fit, as 360 - the fitted bin's angle."""
    n = ORI_BINS
    left, right = hist.roll(1, -1), hist.roll(-1, -1)
    thr = hist.amax(-1, keepdim=True) * 0.8
    peak = (hist > left) & (hist > right) & (hist >= thr)
    j = torch.arange(n, device=hist.device, dtype=hist.dtype)
    den = left - 2 * hist + right
    den = torch.where(peak, den, torch.ones_like(den))
    b = j + 0.5 * (left - right) / den
    b = torch.where(b < 0, n + b, torch.where(b >= n, b - n, b))
    angle = 360.0 - (360.0 / n) * b
    angle = torch.where(((angle - 360.0).abs() < FLT_EPSILON) | ~peak, 0.0, angle)
    return peak, angle


def descriptors(gauss: torch.Tensor, kp: dict) -> torch.Tensor:
    """OpenCV's ``calcSIFTDescriptor`` of each keypoint (B, K, 128), integer
    values 0-255."""
    d, n = DESC_WIDTH, DESC_BINS
    r = DESC_MAX_RADIUS
    offs = torch.arange(-r, r + 1, device=gauss.device)
    di = offs[:, None].expand(-1, 2 * r + 1).reshape(-1).float()
    dj = offs.repeat(2 * r + 1).float()
    ori = 360.0 - kp["angle"]
    ori = torch.where((ori - 360.0).abs() < FLT_EPSILON, 0.0, ori)
    rad = (ori * float(_F32(math.pi / 180))).double()
    cos_t, sin_t = torch.cos(rad).float(), torch.sin(rad).float()
    hist_width = kp["scale"] * 3.0
    radius = torch.round(hist_width * float(_F32(math.sqrt(2))) * (d + 1) * 0.5).long()
    radius = torch.minimum(radius, torch.sqrt((kp["w"] ** 2 + kp["h"] ** 2).double()).long())
    cos_t, sin_t = cos_t / hist_width, sin_t / hist_width
    out = []
    for k0 in range(0, ori.shape[1], CHUNK):
        sl = slice(k0, k0 + CHUNK)
        ct, st = cos_t[:, sl, None], sin_t[:, sl, None]
        c_rot = dj * ct - di * st
        r_rot = dj * st + di * ct
        rbin = r_rot + d // 2 - 0.5
        cbin = c_rot + d // 2 - 0.5
        y = kp["py"][:, sl, None] + di.long()
        x = kp["px"][:, sl, None] + dj.long()
        h, w = kp["h"][:, sl, None], kp["w"][:, sl, None]
        rd = radius[:, sl, None]
        valid = ((di.abs() <= rd) & (dj.abs() <= rd) & (rbin > -1) & (rbin < d)
                 & (cbin > -1) & (cbin < d) & (y > 0) & (y < h - 1) & (x > 0) & (x < w - 1)
                 & kp["valid"][:, sl, None])
        base = torch.where(valid, kp["offset"][:, sl, None] + y * w + x, 1)
        w1 = torch.where(valid, w, 0)
        dx = _gather(gauss, base + 1) - _gather(gauss, base - 1)
        dy = _gather(gauss, base - w1) - _gather(gauss, base + w1)
        weight = torch.exp((c_rot * c_rot + r_rot * r_rot) * (-1.0 / (d * d * 0.5)))
        obin = (fast_atan2(dy, dx) - ori[:, sl, None]) * float(_F32(n / 360))
        mag = torch.where(valid, torch.sqrt(dx * dx + dy * dy) * weight, 0.0)
        r0, c0, o0 = rbin.floor(), cbin.floor(), obin.floor()
        rf, cf, of = rbin - r0, cbin - c0, obin - o0
        o0 = o0.long()
        o0 = torch.where(o0 < 0, o0 + n, torch.where(o0 >= n, o0 - n, o0))
        r0 = torch.where(valid, r0, 0).long()
        c0 = torch.where(valid, c0, 0).long()
        wr = F.one_hot(r0 + 1, d + 2) * (1 - rf)[..., None] + F.one_hot(r0 + 2, d + 2) * rf[..., None]
        wc = F.one_hot(c0 + 1, d + 2) * (1 - cf)[..., None] + F.one_hot(c0 + 2, d + 2) * cf[..., None]
        wo = F.one_hot(o0, n + 2) * (1 - of)[..., None] + F.one_hot(o0 + 1, n + 2) * of[..., None]
        spatial = (mag[..., None, None] * wr[..., :, None] * wc[..., None, :]).flatten(-2)
        hist = torch.einsum("bksp,bkso->bkpo", spatial, wo).reshape(
            *mag.shape[:2], d + 2, d + 2, n + 2)[:, :, 1:d + 1, 1:d + 1]
        hist = torch.cat([hist[..., 0:2] + hist[..., n:n + 2], hist[..., 2:n]], -1)
        out.append(hist.reshape(*mag.shape[:2], d * d * n))
    dst = torch.cat(out, 1)
    thr = torch.sqrt((dst * dst).sum(-1, keepdim=True)) * 0.2
    dst = torch.minimum(dst, thr)
    scale = 512.0 / torch.sqrt((dst * dst).sum(-1, keepdim=True)).clamp_min(FLT_EPSILON)
    return torch.round(dst * scale).clamp(0, 255)


def root_sift(desc: torch.Tensor) -> torch.Tensor:
    """RootSIFT (the JAX wrapper's ``sift_to_rootsift``)."""
    desc = desc / desc.abs().sum(-1, keepdim=True).clamp_min(1e-8)
    desc = torch.sqrt(desc.clamp_min(0))
    return desc / torch.linalg.vector_norm(desc, dim=-1, keepdim=True).clamp_min(1e-8)


def scale_space(gray: torch.Tensor, contrast: float) -> tuple[dict, list]:
    """The pyramid and the keypoint locations of uint8-valued float images
    (B, H, W), flat over (octave, layer 1-3, row, column): ``gauss`` the
    Gaussian layers, ``response`` (-1 where no keypoint converged), ``xc``,
    ``xr``, ``xi`` the offsets of the last Newton step; ``shapes`` the
    octaves' (H, W)."""
    b = gray.shape[0]
    maps, shapes, gauss = [], [], []
    for layers in gaussian_pyramid(gray):
        dog = torch.stack([layers[i + 1] - layers[i] for i in range(LAYERS + 2)], 1)
        maps.append(octave_keypoints(dog, contrast))
        shapes.append(tuple(dog.shape[-2:]))
        gauss.append(torch.stack(layers[1:LAYERS + 1], 1).reshape(b, -1))
    out = {"gauss": torch.cat(gauss, 1),
           "response": torch.cat([torch.where(m["keep"], m["response"], -1.0).reshape(b, -1)
                                  for m in maps], 1)}
    for key in ("xc", "xr", "xi"):
        out[key] = torch.cat([m[key].reshape(b, -1) for m in maps], 1)
    return out, shapes


# CUDA graphs of ``scale_space``, by (device, image shape, contrast threshold); the
# oldest is dropped past MAX_GRAPHS (each holds its intermediates' memory)
_GRAPHS: dict = {}
MAX_GRAPHS = 4


def scale_space_on_device(gray: torch.Tensor, contrast: float) -> tuple[dict, list]:
    """``scale_space`` as inference tensors. On the card it replays a CUDA
    graph captured at the first call for the image shape (some ten thousand
    small kernels, which the host would otherwise launch one by one); the
    outputs are the graph's buffers, valid until the next call."""
    with torch.inference_mode():
        if gray.device.type != "cuda":
            return scale_space(gray, contrast)
        key = (gray.device, tuple(gray.shape), contrast)
        if key not in _GRAPHS:
            if len(_GRAPHS) >= MAX_GRAPHS:
                del _GRAPHS[next(iter(_GRAPHS))]
            static = gray.clone()
            stream = torch.cuda.Stream(gray.device)
            stream.wait_stream(torch.cuda.current_stream(gray.device))
            with torch.cuda.stream(stream):
                scale_space(static, contrast)  # warm-up: the allocator's blocks
            torch.cuda.current_stream(gray.device).wait_stream(stream)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                out = scale_space(static, contrast)
            _GRAPHS[key] = (graph, static, out)
        graph, static, out = _GRAPHS[key]
        static.copy_(gray)
        graph.replay()
        return out


def detect_and_compute(gray: torch.Tensor, k: int, contrast: float) -> dict:
    """OpenCV's SIFT of uint8-valued float images (B, H, W): the ``k``
    keypoints of largest response, sorted, in static slots."""
    b = gray.shape[0]
    space, shapes = scale_space_on_device(gray, contrast)
    gauss, resp = space["gauss"], space["response"]
    sizes = [3 * h * w for h, w in shapes]
    starts = np.concatenate([[0], np.cumsum(sizes)])
    top, idx = resp.topk(min(k, resp.shape[1]), dim=1)
    # the locations (then the keypoints) past the largest count in the batch
    # are empty: one host read each, so that no work is done for them
    n_loc = max(1, int((top >= 0).sum(1).max()))
    top, idx = top[:, :n_loc], idx[:, :n_loc].contiguous()
    dev = gray.device
    starts_t = torch.as_tensor(starts[:-1], device=dev)
    octave = torch.searchsorted(starts_t, idx, right=True) - 1
    hs = torch.as_tensor([h for h, _ in shapes], device=dev)[octave]
    ws = torch.as_tensor([w for _, w in shapes], device=dev)[octave]
    local = idx - starts_t[octave]
    layer = local // (hs * ws) + 1
    r, c = (local % (hs * ws)) // ws, local % ws

    def pick(key):
        return space[key].gather(1, idx)

    xc, xr, xi = pick("xc"), pick("xr"), pick("xi")
    scale_o = (2 ** octave).float()
    size = (((layer.float() + xi) / LAYERS).double().exp2().float() * SIGMA) * scale_o * 2
    loc = {"r": r, "c": c, "h": hs, "w": ws, "valid": top >= 0,
           "offset": starts_t[octave] + (layer - 1) * hs * ws,
           "scale": size * 0.5 / scale_o}
    peak, angle = peak_angles(orientations(gauss, loc))

    # every peak of every location is a keypoint; keep the k of largest response
    score = torch.where(peak & loc["valid"][..., None], top[..., None], -1.0).reshape(b, -1)
    order = torch.sort(score, dim=1, descending=True, stable=True).indices[:, :k]
    valid = score.gather(1, order) >= 0
    n_kp = max(1, int(valid.sum(1).max()))
    order, valid = order[:, :n_kp], valid[:, :n_kp]
    which = order // ORI_BINS
    kp = {key: loc[key].gather(1, which) for key in ("r", "c", "h", "w", "offset", "scale")}
    kp["valid"] = valid
    kp["angle"] = angle.reshape(b, -1).gather(1, order)
    # the descriptor's window centre: the keypoint in octave pixels, rounded
    kp["px"] = torch.round(c.float() + xc).long().gather(1, which)
    kp["py"] = torch.round(r.float() + xr).long().gather(1, which)
    pt_x = ((c.float() + xc) * scale_o * 0.5).gather(1, which)
    pt_y = ((r.float() + xr) * scale_o * 0.5).gather(1, which)
    out = {
        "keypoints": torch.stack([pt_x, pt_y], -1),
        "keypoint_scores": top.gather(1, which),
        "scales": (size * 0.5).gather(1, which),
        "oris": (kp["angle"].double() * (math.pi / 180)).float(),
        "descriptors": descriptors(gauss, kp),
    }
    out = {key: torch.where(valid.view(*valid.shape, *([1] * (v.ndim - 2))), v, 0.0)
           for key, v in out.items()}
    out["keypoint_valid"] = valid
    pad = k - valid.shape[1]
    return {key: F.pad(v, (0, 0, 0, pad) if v.ndim == 3 else (0, pad)) if pad else v
            for key, v in out.items()}


class SIFT(BaseModel):
    default_conf: ClassVar[dict] = {
        "max_num_keypoints": 2048,
        "contrast_threshold": 0.04,
        "rootsift": True,
        "trainable": False,
    }
    required_data_keys: ClassVar[list] = ["image"]

    def _forward(self, data: dict) -> dict:
        image = data["image"]
        if image.shape[-1] == 3:  # as XLA fuses the JAX wrapper's weighted sum
            image = _fma(image[..., 2], float(_F32(GRAY[2])),
                         _fma(image[..., 1], float(_F32(GRAY[1])), image[..., 0] * GRAY[0]))
        else:
            image = image[..., 0]
        gray = torch.clamp(image * 255.0, 0, 255).floor()
        with torch.no_grad():
            out = detect_and_compute(gray.float(), int(self.conf["max_num_keypoints"]),
                                     float(self.conf["contrast_threshold"]))
        desc = out["descriptors"]
        if self.conf["rootsift"]:
            desc = root_sift(desc)
        else:
            desc = desc / torch.linalg.vector_norm(desc, dim=-1, keepdim=True).clamp_min(1e-8)
        out["descriptors"] = torch.where(out["keypoint_valid"][..., None], desc, 0.0)
        return out

    def loss(self, pred, data):
        raise NotImplementedError


__main_model__ = SIFT
