"""Image files and the image operations of the benchmark path, in numpy
(gluefactory_tpu/utils/image.py). The JAX package does these with OpenCV,
which the GPU machine does not have; each function here reproduces the OpenCV
call it replaces (named in its docstring) on float32 or uint8 images:

- binary PPM/PGM files (P6/P5, maxval 255), read as RGB like
  ``cv2.imread`` + ``cvtColor(BGR2RGB)``;
- ``resize``: INTER_AREA (fractional area weights), INTER_LINEAR (half-pixel
  centres) and INTER_CUBIC (a = -0.75, border replicate), as separable
  float64 weight matrices;
- ``gaussian_blur``: ``GaussianBlur`` with the sigma OpenCV derives from the
  kernel size and BORDER_REFLECT_101;
- ``warp_perspective``: ``warpPerspective`` with INTER_LINEAR and a
  constant-0 border, on uint8 (within one level of OpenCV's rounding),
  float64 (coordinates on OpenCV's 1/32 table) or float32 (OpenCV 5 samples
  float32 images at unquantised coordinates);
- ``rgb_to_hsv``/``hsv_to_rgb``: ``cvtColor`` RGB<->HSV on uint8 (H in
  0..179), bit for bit: OpenCV's division tables one way, its float32
  sectors with a fused multiply-add and truncation the other.

``ImagePreprocessor`` resizes and pads an image onto a static canvas and
returns the transform that maps original pixels onto it."""

from __future__ import annotations

import functools
import math
from pathlib import Path

import numpy as np

from ..core.config import merge

# --- files ---------------------------------------------------------------------


def _pnm_header(data: bytes) -> tuple[str, list[int], int]:
    """(magic, [width, height, maxval], offset of the pixels); skips comments."""
    fields, pos = [], 0
    while len(fields) < 4:
        while data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":
            pos = data.index(b"\n", pos) + 1
            continue
        end = pos
        while end < len(data) and not data[end:end + 1].isspace():
            end += 1
        fields.append(data[pos:end].decode("ascii"))
        pos = end
    return fields[0], [int(f) for f in fields[1:]], pos + 1  # one whitespace byte


def read_image(path: str | Path, grayscale: bool = False) -> np.ndarray:
    """A binary PPM (P6) or PGM (P5) file as uint8 RGB (H, W, 3), or (H, W)
    when ``grayscale`` (OpenCV's BGR-to-gray weights on a colour file)."""
    data = Path(path).read_bytes()
    if data[:2] not in (b"P5", b"P6"):
        raise IOError(f"Could not read image at {path}: a {Path(path).suffix or 'suffix-less'} "
                      "file that is not a binary PPM/PGM (the only formats read)")
    magic, (w, h, maxval), offset = _pnm_header(data)
    if maxval != 255:
        raise IOError(f"Could not read image at {path}: not an 8-bit binary PPM/PGM")
    channels = 3 if magic == "P6" else 1
    image = np.frombuffer(data, np.uint8, h * w * channels, offset).reshape(h, w, channels)
    if grayscale:
        if channels == 1:
            return image[..., 0].copy()
        r, g, b = (image[..., i].astype(np.int32) for i in range(3))
        return ((r * 4899 + g * 9617 + b * 1868 + 8192) >> 14).astype(np.uint8)
    return np.repeat(image, 3, axis=-1) if channels == 1 else image.copy()


def write_image(path: str | Path, image: np.ndarray) -> None:
    """uint8 RGB (H, W, 3) as P6, or (H, W) as P5, as ``cv2.imwrite`` of the
    BGR image writes them."""
    image = np.ascontiguousarray(image, np.uint8)
    magic = "P6" if image.ndim == 3 else "P5"
    header = f"{magic}\n{image.shape[1]} {image.shape[0]}\n255\n".encode("ascii")
    Path(path).write_bytes(header + image.tobytes())


def numpy_image_to_float(image: np.ndarray) -> np.ndarray:
    """uint8 HWC/HW -> float32 HWC in [0, 1]."""
    if image.ndim == 2:
        image = image[..., None]
    if image.dtype == np.uint8:
        image = image.astype(np.float32) / 255.0
    return image.astype(np.float32)


# --- resampling ------------------------------------------------------------------


def _area_weights(src: int, dst: int) -> np.ndarray:
    """INTER_AREA for a downscale: each output pixel averages the input
    pixels its footprint covers, the partly covered ones by their share."""
    scale = src / dst
    weights = np.zeros((dst, src))
    for d in range(dst):
        f0 = d * scale
        f1 = f0 + scale
        s0, s1 = int(np.ceil(f0)), int(np.floor(f1))
        cell = min(scale, src - f0)
        if s0 - f0 > 1e-3:
            weights[d, s0 - 1] = (s0 - f0) / cell
        weights[d, s0:s1] = 1.0 / cell
        if f1 - s1 > 1e-3 and s1 < src:
            weights[d, s1] = min(f1 - s1, 1.0, cell) / cell
    return weights


def _linear_weights(src: int, dst: int) -> np.ndarray:
    """INTER_LINEAR: half-pixel centres, clamped at the border."""
    weights = np.zeros((dst, src))
    for d in range(dst):
        f = (d + 0.5) * src / dst - 0.5
        s = int(np.floor(f))
        f -= s
        if s < 0:
            s, f = 0, 0.0
        if s >= src - 1:
            s, f = src - 1, 0.0
        weights[d, s] += 1.0 - f
        if f:
            weights[d, s + 1] += f
    return weights


def _cubic_weights(src: int, dst: int, a: float = -0.75) -> np.ndarray:
    """INTER_CUBIC: Keys' kernel with a = -0.75 on 4 taps, taps past the
    border replicate the edge pixel."""
    weights = np.zeros((dst, src))
    for d in range(dst):
        f = (d + 0.5) * src / dst - 0.5
        s = int(np.floor(f))
        x = f - s
        c0 = ((a * (x + 1) - 5 * a) * (x + 1) + 8 * a) * (x + 1) - 4 * a
        c1 = ((a + 2) * x - (a + 3)) * x * x + 1
        c2 = ((a + 2) * (1 - x) - (a + 3)) * (1 - x) * (1 - x) + 1
        for tap, c in zip(range(s - 1, s + 3), (c0, c1, c2, 1.0 - c0 - c1 - c2)):
            weights[d, min(max(tap, 0), src - 1)] += c
    return weights


_WEIGHTS = {"area": _area_weights, "linear": _linear_weights, "cubic": _cubic_weights}


@functools.lru_cache(maxsize=64)
def _operator(kind: str, src: int, dst: int) -> tuple[np.ndarray | None, np.ndarray]:
    """A filter along one axis, from ``src`` to ``dst`` samples, built once
    for each size (a benchmark resizes every image alike): a resize ('area',
    'linear', 'cubic') as (columns, weights) of the few taps of each output
    sample; a Gaussian blur ('gaussian<ksize>') as (None, its dense matrix).
    The arrays are read-only: every caller shares them."""
    if kind.startswith("gaussian"):
        ksize, _, sigma = kind[8:].partition("_")
        out = (None, _reflect101_filter(src, _gaussian_kernel(int(ksize), float(sigma or 0))))
    else:
        weights = _WEIGHTS[kind](src, dst)
        taps = int((weights != 0).sum(1).max())
        cols = np.zeros((dst, taps), np.int64)
        vals = np.zeros((dst, taps))
        for i, row in enumerate(weights):
            nz = np.flatnonzero(row)
            cols[i, :len(nz)], vals[i, :len(nz)] = nz, row[nz]
        out = (cols, vals)
    for array in out:
        if array is not None:
            array.flags.writeable = False
    return out


def _apply(kind: str, x: np.ndarray, axis: int, dst: int) -> np.ndarray:
    """The ``kind`` filter along ``axis`` of ``x``, to ``dst`` samples."""
    cols, vals = _operator(kind, x.shape[axis], dst)
    x = np.moveaxis(x, axis, 0)
    if cols is None:
        out = np.tensordot(vals, x, axes=(1, 0))
    else:
        out = sum(vals[:, k].reshape((-1,) + (1,) * (x.ndim - 1)) * x[cols[:, k]]
                  for k in range(cols.shape[1]))
    return np.moveaxis(out, 0, axis)


def _separable(image: np.ndarray, kind: str, size: tuple[int, int],
               dtype=np.float32) -> np.ndarray:
    """The ``kind`` filter along rows and columns of each channel, in float64,
    ``dtype`` out; ``size`` is (w, h) out."""
    x = _apply(kind, np.asarray(image, np.float64), 0, size[1])
    return _apply(kind, x, 1, size[0]).astype(dtype)


@functools.lru_cache(maxsize=64)
def _area_table(src: int, dst: int) -> tuple[np.ndarray, np.ndarray]:
    """OpenCV's INTER_AREA table (computeResizeAreaTab) as (sources, weights),
    each (dst, taps): the source samples of each output sample in OpenCV's
    order, weights in float32, padded with weight 0."""
    scale = src / dst
    rows = []
    for d in range(dst):
        f0 = d * scale
        f1 = f0 + scale
        cell = min(scale, src - f0)
        s1, s2 = math.ceil(f0), math.floor(f1)
        s2 = min(s2, src - 1)
        s1 = min(s1, s2)
        row = [(s1 - 1, (s1 - f0) / cell)] if s1 - f0 > 1e-3 else []
        row += [(s, 1.0 / cell) for s in range(s1, s2)]
        if f1 - s2 > 1e-3:
            row.append((s2, min(min(f1 - s2, 1.0), cell) / cell))
        rows.append(row)
    taps = max(len(row) for row in rows)
    cols = np.zeros((dst, taps), np.int64)
    vals = np.zeros((dst, taps), np.float32)
    for d, row in enumerate(rows):
        for t, (col, weight) in enumerate(row):
            cols[d, t], vals[d, t] = col, weight
    cols.flags.writeable = vals.flags.writeable = False
    return cols, vals


def _resize_area_f32(image: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """``cv2.resize(..., INTER_AREA)`` of a float32 image by a factor that is
    not an integer, bit for bit: each source row summed along x in the
    table's order (``buf += S * alpha``), then the rows of each output row
    (``sum = beta * buf`` for the first, ``sum += beta * buf`` after), in
    float32."""
    w, h = size
    xc, xv = _area_table(image.shape[1], w)
    yc, yv = _area_table(image.shape[0], h)
    extra = (1,) * (image.ndim - 2)
    buf = np.zeros((image.shape[0], w) + image.shape[2:], np.float32)
    for t in range(xc.shape[1]):
        buf += image[:, xc[:, t]] * xv[:, t].reshape(1, w, *extra)
    out = buf[yc[:, 0]] * yv[:, 0].reshape(h, 1, *extra)
    for t in range(1, yc.shape[1]):
        out += buf[yc[:, t]] * yv[:, t].reshape(h, 1, *extra)
    return out


def resize(image: np.ndarray, size: tuple[int, int], interpolation: str) -> np.ndarray:
    """``cv2.resize(image, size, interpolation=INTER_AREA | INTER_LINEAR |
    INTER_CUBIC)`` of a float image (H, W) or (H, W, C); ``size`` is (w, h).
    'area' is for downscaling, as the preprocessor uses it; a float32 image
    shrunk by a factor that is not an integer takes OpenCV's own float32
    arithmetic (``_resize_area_f32``), the rest are filtered in float64."""
    integral = image.shape[1] % size[0] == 0 and image.shape[0] % size[1] == 0
    if interpolation == "area" and image.dtype == np.float32 and not integral:
        return _resize_area_f32(image, size)
    return _separable(image, interpolation, size)


def _gaussian_kernel(ksize: int, sigma: float = 0.0) -> np.ndarray:
    """``cv2.getGaussianKernel(ksize, sigma)``: for sigma <= 0 the fixed small
    kernels up to 9 taps, else sigma = 0.3 * ((ksize - 1) / 2 - 1) + 0.8."""
    if sigma > 0:
        x = np.arange(ksize) - (ksize - 1) / 2
        kernel = np.exp(-0.5 / (sigma * sigma) * x * x)
        return kernel / kernel.sum()
    small = {1: [1.0], 3: [0.25, 0.5, 0.25], 5: [0.0625, 0.25, 0.375, 0.25, 0.0625],
             7: [0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125],
             9: [v / 256 for v in (4, 13, 30, 51, 60, 51, 30, 13, 4)]}
    if ksize in small:
        return np.array(small[ksize])
    sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    x = np.arange(ksize) - (ksize - 1) / 2
    kernel = np.exp(-x * x / (2 * sigma * sigma))
    return kernel / kernel.sum()


def _reflect101_filter(n: int, kernel: np.ndarray) -> np.ndarray:
    """The (n, n) matrix of a 1-D filter with BORDER_REFLECT_101 (dcb|abcd|cba)."""
    r = len(kernel) // 2
    taps = np.arange(n)[:, None] + np.arange(-r, r + 1)[None]
    period = 2 * (n - 1) if n > 1 else 1
    taps = np.abs(taps) % period
    taps = np.where(taps >= n, period - taps, taps)
    matrix = np.zeros((n, n))
    np.add.at(matrix, (np.repeat(np.arange(n), len(kernel)), taps.ravel()),
              np.tile(kernel, n))
    return matrix


def gaussian_blur(image: np.ndarray, ksize: int, sigma: float = 0.0) -> np.ndarray:
    """``cv2.GaussianBlur(image, (ksize, ksize), sigma)`` of a float image, in
    its own type (float64 stays float64, anything else is float32)."""
    dtype = np.float64 if image.dtype == np.float64 else np.float32
    kind = f"gaussian{ksize}" + (f"_{float(sigma)!r}" if sigma > 0 else "")
    return _separable(image, kind, (image.shape[1], image.shape[0]), dtype)


def warp_perspective(image: np.ndarray, H: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """``cv2.warpPerspective(image, H, size, flags=INTER_LINEAR)`` of a uint8,
    float32 or float64 image (H, W) or (H, W, C): out(x) = image(H^-1 x) for
    integer pixel coordinates x, bilinear, 0 outside the source; ``size`` is
    (w, h). A uint8 image is rounded back to uint8; a float64 one is sampled
    where OpenCV samples it, at coordinates rounded to 1/32 of a pixel (its
    fixed-point table), a float32 one at the exact coordinates (OpenCV 5's
    float path)."""
    w, h = size
    src_h, src_w = image.shape[:2]
    M = np.linalg.inv(np.asarray(H, np.float64))
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    den = M[2, 0] * xs + M[2, 1] * ys + M[2, 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        X = (M[0, 0] * xs + M[0, 1] * ys + M[0, 2]) / den
        Y = (M[1, 0] * xs + M[1, 1] * ys + M[1, 2]) / den
    inside = np.isfinite(X) & np.isfinite(Y) & (np.abs(X) < 1e6) & (np.abs(Y) < 1e6)
    X, Y = np.where(inside, X, -10.0), np.where(inside, Y, -10.0)
    if image.dtype == np.float64:
        X, Y = np.round(X * 32) / 32, np.round(Y * 32) / 32
    x0, y0 = np.floor(X), np.floor(Y)
    fx, fy = (X - x0)[..., None], (Y - y0)[..., None]
    # a zero border of 2 pixels: a tap clamped into it reads 0, as OpenCV's
    # constant border gives
    stride = src_w + 4
    padded = np.zeros((src_h + 4, stride, image.size // (src_h * src_w)), image.dtype)
    padded[2:-2, 2:-2] = image.reshape(src_h, src_w, -1)
    flat = padded.reshape(-1, padded.shape[-1])
    idx = ((np.clip(y0, -2, src_h).astype(np.int64) + 2) * stride
           + np.clip(x0, -2, src_w).astype(np.int64) + 2)
    top = flat[idx] * (1 - fx) + flat[idx + 1] * fx
    bottom = flat[idx + stride] * (1 - fx) + flat[idx + stride + 1] * fx
    out = top * (1 - fy) + bottom * fy
    if image.dtype == np.uint8:
        out = np.clip(np.rint(out), 0, 255).astype(np.uint8)
    elif image.dtype != np.float64:
        out = out.astype(np.float32)
    return out.reshape((h, w) + image.shape[2:])


# --- colour ----------------------------------------------------------------------

_HSV_SHIFT = 12
_SDIV = np.zeros(256, np.int64)  # OpenCV's tables: round((255 << 12) / i), round((180 << 12) / 6i)
_HDIV = np.zeros(256, np.int64)
_SDIV[1:] = np.rint((255 << _HSV_SHIFT) / np.arange(1.0, 256.0))
_HDIV[1:] = np.rint((180 << _HSV_SHIFT) / (6.0 * np.arange(1.0, 256.0)))
# the (b, g, r) entries of (v, v(1-s), v(1-sf), v(1-s(1-f))) in each hue sector
_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])


def rgb_to_hsv(image: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(image, COLOR_RGB2HSV)`` of uint8 RGB: H in 0..179,
    S and V in 0..255, in OpenCV's 12-bit fixed point."""
    rgb = image.astype(np.int64)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    v = np.maximum(np.maximum(b, g), r)
    diff = v - np.minimum(np.minimum(b, g), r)
    half = 1 << (_HSV_SHIFT - 1)
    s = (diff * _SDIV[v] + half) >> _HSV_SHIFT
    h = np.where(v == r, g - b, np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * _HDIV[diff] + half) >> _HSV_SHIFT
    h = np.where(h < 0, h + 180, h)
    return np.stack([h, s, v], -1).astype(np.uint8)


HSV_VECTOR_PIXELS = 32  # pixels a pass of OpenCV's vector loop (8 float lanes x 4)


def hsv_to_rgb(image: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(image, COLOR_HSV2RGB)`` of uint8 HSV (H in 0..179):
    float32 sectors, ``1 - s * x`` as one fused multiply-add. OpenCV converts
    row by row; its vector loop truncates to uint8, its scalar loop over the
    last ``w % HSV_VECTOR_PIXELS`` pixels of a row rounds."""
    f32, one = np.float32, np.float32(1.0)
    h = image[..., 0].astype(f32) * f32(6.0 / 180.0)
    s = image[..., 1].astype(f32) * f32(1.0 / 255.0)
    v = image[..., 2].astype(f32) * f32(1.0 / 255.0)
    whole = np.trunc(h)
    frac = h - whole
    sector = whole.astype(np.int64) % 6

    def fused(x):  # round(1 - s * x) once: exact in float64 for float32 inputs
        return (1.0 - s.astype(np.float64) * x.astype(np.float64)).astype(f32)

    tab = np.stack([v, v * (one - s), v * fused(frac), v * fused(one - frac)], -1)
    pick = _SECTORS[sector]
    rgb = np.stack([np.take_along_axis(tab, pick[..., k:k + 1], -1)[..., 0]
                    for k in (2, 1, 0)], -1)
    rgb = np.where((s == 0)[..., None], v[..., None], rgb) * f32(255.0)
    w = image.shape[-2] if image.ndim > 2 else image.shape[0]
    scalar = (np.arange(w) >= w // HSV_VECTOR_PIXELS * HSV_VECTOR_PIXELS)[:, None]
    return np.clip(np.where(scalar, np.rint(rgb), np.trunc(rgb)), 0, 255).astype(np.uint8)


# --- preprocessing ----------------------------------------------------------------


class ImagePreprocessor:
    """Resize keeping the aspect ratio, then pad onto a static canvas.

    Returns numpy arrays:
      image       (H', W', C) float32, zero-padded
      image_size  (2,) float32, the valid (w, h) inside the canvas
      orig_size   (2,) float32, the original (w, h)
      scales      (2,) float32, the (sx, sy) of the resize
      transform   (3, 3) float32, original pixel coordinates -> canvas
      valid_mask  (H', W') bool, True on image pixels
    """

    default_conf = {
        "resize": None,  # target size (int) or None
        "edge_divisible_by": None,
        "side": "long",  # resize so this side == resize: short | long | vert | horz
        "interpolation": "bilinear",
        "align_corners": None,
        "antialias": True,
        "square_pad": True,  # pad to a (resize, resize) canvas
        "add_padding_mask": True,
        "grayscale": False,
    }

    def __init__(self, conf: dict | None = None):
        self.conf = merge(self.default_conf, conf)

    def __call__(self, image: np.ndarray) -> dict:
        conf = self.conf
        image = numpy_image_to_float(image)
        h, w = image.shape[:2]
        sx = sy = 1.0
        if conf["resize"] is not None:
            target = int(conf["resize"])
            scale = {"short": target / min(h, w), "long": target / max(h, w),
                     "vert": target / h}.get(conf["side"], target / w)
            nw, nh = max(1, round(w * scale)), max(1, round(h * scale))
            if conf["edge_divisible_by"]:
                d = int(conf["edge_divisible_by"])
                nw, nh = (nw // d) * d, (nh // d) * d
            mode = "area" if (scale < 1 and conf["antialias"]) else "linear"
            image = resize(image, (nw, nh), mode)
            sx, sy = nw / w, nh / h
        nh, nw = image.shape[:2]
        if conf["square_pad"] and conf["resize"] is not None:
            ch = cw = int(conf["resize"])
        else:
            ch, cw = nh, nw
        padded = np.zeros((ch, cw, image.shape[2]), dtype=np.float32)
        padded[:nh, :nw] = image[:ch, :cw]
        valid = np.zeros((ch, cw), dtype=bool)
        valid[:min(nh, ch), :min(nw, cw)] = True
        if conf["grayscale"] and padded.shape[2] == 3:
            padded = padded.mean(axis=2, keepdims=True)
        return {
            "image": padded,
            "image_size": np.array([min(nw, cw), min(nh, ch)], dtype=np.float32),
            "orig_size": np.array([w, h], dtype=np.float32),
            "scales": np.array([sx, sy], dtype=np.float32),
            "transform": np.array([[sx, 0.0, 0.0], [0.0, sy, 0.0], [0.0, 0.0, 1.0]],
                                  dtype=np.float32),
            "valid_mask": valid,
        }
