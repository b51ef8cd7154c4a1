"""ELSED-class line segments (gluefactory_tpu/models/lines/elsed.py).

The detector is host C++, ``csrc/elsed.cpp`` (the port's copy of the JAX
package's native detector), built at first use by ``ops.kernels`` and loaded
with ctypes: the same segments as the JAX package's library, bit for bit. It
takes the float grey image (the JAX wrapper's weighted sum, as XLA fuses it)
and fills ``max_num_lines`` static slots, strongest first, with a
``valid_lines`` mask. It runs on the host whatever the model's device, the
images of a batch on threads (the C++ call releases the GIL); its outputs go
to the image's device. A library that fails to build or load raises (the JAX
package returns no lines then)."""

from __future__ import annotations

import ctypes
import os
from concurrent.futures import ThreadPoolExecutor
from typing import ClassVar

import numpy as np
import torch

from ...ops import kernels
from ..base_model import BaseModel
from .lsd import grey_float

SOURCE = "elsed.cpp"


def _library() -> ctypes.CDLL:
    lib = kernels.load(SOURCE)
    lib.elsed_detect.restype = ctypes.c_int
    lib.elsed_detect.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                                 ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                                 ctypes.c_void_p]
    return lib


def detect_elsed_np(image: np.ndarray, max_lines: int, grad_th: float = 0.06,
                    dev_tol: float = 1.2, min_length: int = 15):
    """image (H, W) float32 in [0, 1] -> (lines (max, 2, 2) f32, scores
    (max,), valid (max,))."""
    img = np.ascontiguousarray(image, np.float32)
    segs = np.zeros((max_lines, 4), np.float32)
    scores = np.zeros((max_lines,), np.float32)
    n = _library().elsed_detect(img.ctypes.data, img.shape[0], img.shape[1], grad_th, dev_tol,
                                int(min_length), int(max_lines), segs.ctypes.data,
                                scores.ctypes.data)
    valid = np.zeros((max_lines,), bool)
    valid[:n] = True
    return segs.reshape(max_lines, 2, 2), scores, valid


class ELSED(BaseModel):
    default_conf: ClassVar[dict] = {
        "max_num_lines": 250,
        "grad_th": 0.06,
        "dev_tol": 1.2,
        "min_length": 15,
        "trainable": False,
    }
    required_data_keys: ClassVar[list] = ["image"]

    def _forward(self, data: dict) -> dict:
        image = data["image"]
        conf = self.conf
        greys = grey_float(image).float().cpu().numpy()
        _library()  # built and loaded before the threads start

        def detect(g):
            return detect_elsed_np(g, int(conf["max_num_lines"]), float(conf["grad_th"]),
                                   float(conf["dev_tol"]), int(conf["min_length"]))

        with ThreadPoolExecutor(max(1, min(len(greys), os.cpu_count() or 1))) as pool:
            outs = list(pool.map(detect, greys))
        return {key: torch.from_numpy(np.stack([o[j] for o in outs])).to(image.device)
                for j, key in enumerate(("lines", "line_scores", "valid_lines"))}


__main_model__ = ELSED
