"""LSD line segments (gluefactory_tpu/models/lines/lsd.py).

The JAX package runs OpenCV's ``createLineSegmentDetector(LSD_REFINE_STD)``
on the host; the port runs its own copy of that detector,
``csrc/lsd.cpp``, host C++ built at first use with the host compiler (see
``ops/kernels``) and loaded with ctypes: the same segments as OpenCV 5,
bit for bit, in the same order. As in JAX, the image becomes grey (the JAX
wrapper's weighted sum, as XLA fuses it) and uint8 (``clip(x * 255)``,
truncated); segments shorter than ``min_length`` are dropped, each scored
sqrt(length), ordered by ``np.argsort(-scores)`` and cut to
``max_num_lines`` slots with a ``valid_lines`` mask. The detector runs on
the host whatever the model's device, the images of a batch on threads (the
C++ call releases the GIL; each image's segments and their order are its
own); its outputs go to the image's device. ``describe: 'lbd'`` adds LBD
descriptors of the segments (``lines/lbd.py``), computed on the image's
device from the float grey image."""

from __future__ import annotations

import ctypes
import os
from concurrent.futures import ThreadPoolExecutor
from typing import ClassVar

import numpy as np
import torch

from ...ops import kernels
from ..base_model import BaseModel
from ..extractors.sift import GRAY, _fma

SOURCE = "lsd.cpp"
_F32 = np.float32


def _library() -> ctypes.CDLL:
    lib = kernels.load(SOURCE)
    lib.lsd_detect.restype = ctypes.c_void_p
    lib.lsd_detect.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                               ctypes.POINTER(ctypes.c_int)]
    lib.lsd_take.restype = None
    lib.lsd_take.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    return lib


def detect_segments(image_u8: np.ndarray) -> np.ndarray:
    """All LSD segments of a (H, W) uint8 image, in the detector's order:
    (N, 5) float32 rows of x1, y1, x2, y2 and the width."""
    image = np.ascontiguousarray(image_u8, dtype=np.uint8)
    if image.ndim != 2:
        raise ValueError(f"LSD takes one grey image (H, W), got shape {image.shape}")
    lib = _library()
    count = ctypes.c_int()
    handle = lib.lsd_detect(image.ctypes.data, image.shape[1], image.shape[0],
                            ctypes.byref(count))
    out = np.empty((count.value, 5), np.float32)
    lib.lsd_take(handle, out.ctypes.data)
    return out


def detect_lsd_np(image_u8: np.ndarray, max_lines: int, min_length: float):
    """image (H, W) uint8 -> (lines (max, 2, 2) f32, scores (max,), valid)."""
    segs = detect_segments(image_u8)[:, :4].reshape(-1, 2, 2)
    lines = np.zeros((max_lines, 2, 2), np.float32)
    sc = np.zeros((max_lines,), np.float32)
    valid = np.zeros((max_lines,), bool)
    if len(segs) == 0:
        return lines, sc, valid
    lengths = np.linalg.norm(segs[:, 1] - segs[:, 0], axis=-1)
    keep = lengths >= min_length
    segs, lengths = segs[keep], lengths[keep]
    scores = np.sqrt(lengths)
    order = np.argsort(-scores)[:max_lines]
    k = len(order)
    lines[:k], sc[:k], valid[:k] = segs[order], scores[order], True
    return lines, sc, valid


def grey_float(image: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) float images -> (B, H, W) float grey, as the JAX
    wrappers compute it."""
    if image.shape[-1] == 3:  # as XLA fuses the JAX wrapper's weighted sum
        return _fma(image[..., 2], float(_F32(GRAY[2])),
                    _fma(image[..., 1], float(_F32(GRAY[1])), image[..., 0] * GRAY[0]))
    return image[..., 0]


def grey_u8(image: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) float images in [0, 1] -> (B, H, W) uint8, as the JAX
    wrapper computes them."""
    return torch.clamp(grey_float(image) * 255.0, 0, 255).to(torch.uint8)


class LSD(BaseModel):
    default_conf: ClassVar[dict] = {
        "max_num_lines": 250,
        "min_length": 15.0,
        "describe": None,  # 'lbd' appends LBD line descriptors
        "lbd": {"n_bands": 9, "band_width": 7.0, "n_samples": 32},
        "trainable": False,
    }
    required_data_keys: ClassVar[list] = ["image"]

    def _forward(self, data: dict) -> dict:
        image = data["image"]
        m, min_length = int(self.conf["max_num_lines"]), float(self.conf["min_length"])
        grey = grey_float(image)
        greys = torch.clamp(grey * 255.0, 0, 255).to(torch.uint8).cpu().numpy()
        _library()  # built and loaded before the threads start
        with ThreadPoolExecutor(max(1, min(len(greys), os.cpu_count() or 1))) as pool:
            outs = list(pool.map(lambda g: detect_lsd_np(g, m, min_length), greys))
        pred = {key: torch.from_numpy(np.stack([o[j] for o in outs])).to(image.device)
                for j, key in enumerate(("lines", "line_scores", "valid_lines"))}
        if self.conf["describe"] == "lbd":
            from .lbd import lbd_describe

            lbd = self.conf["lbd"]
            pred["line_descriptors"] = lbd_describe(
                grey, pred["lines"], pred["valid_lines"], n_bands=int(lbd["n_bands"]),
                band_width=float(lbd["band_width"]), n_samples=int(lbd["n_samples"]))
        return pred


__main_model__ = LSD
