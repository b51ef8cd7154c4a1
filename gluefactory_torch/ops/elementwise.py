"""Elementwise ``x + y`` on float32 (kernel K3, the toolchain probe's kernel
in gluefactory_tpu/scripts/pallas_probe.py).

``add_plain`` is the plain PyTorch version; ``add_cuda`` checks its inputs and
launches the hand-written kernel of ``csrc/elementwise.cu`` on CUDA tensors,
counting each launch in ``launches``. Given CPU tensors it runs the plain
version instead.
"""

from __future__ import annotations

import ctypes

import torch

from . import kernels

SOURCE = "elementwise.cu"

# launches of the CUDA kernel in this process
launches = {"add": 0}


def reset_launches() -> None:
    launches["add"] = 0


def add_plain(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return x + y


def _library() -> ctypes.CDLL:
    lib = kernels.load(SOURCE)
    if lib.gf_add_f32.argtypes is None:
        p = ctypes.c_void_p
        lib.gf_add_f32.argtypes = [p, p, p, ctypes.c_longlong, p]
        lib.gf_add_f32.restype = ctypes.c_int
    return lib


def add_cuda(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Kernel K3: ``x + y`` for two contiguous float32 tensors of one shape."""
    if x.device.type == "cpu":
        return add_plain(x, y)
    if x.device.type != "cuda":
        raise ValueError(f"the add kernel runs on CUDA tensors, got {x.device}")
    for name, t in (("x", x), ("y", y)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: dtype {t.dtype}, the kernel takes float32")
        if t.device != x.device:
            raise ValueError(f"{name}: on {t.device}, expected {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the kernel takes contiguous tensors only")
    if x.shape != y.shape:
        raise ValueError(f"shapes differ: {tuple(x.shape)} and {tuple(y.shape)}")
    out = torch.empty_like(x)
    lib = _library()
    with torch.cuda.device(x.device):
        rc = lib.gf_add_f32(x.data_ptr(), y.data_ptr(), out.data_ptr(), x.numel(),
                            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"CUDA kernel add failed to launch: error {rc}")
    launches["add"] += 1
    return out
