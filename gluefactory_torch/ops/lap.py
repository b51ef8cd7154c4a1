"""The exact batched linear assignment of the line benchmarks
(gluefactory_tpu/ops/lap.py): ``csrc/lap.cpp``, a Jonker-Volgenant solver in
host C++, built at first use by ``ops.kernels`` and loaded with ctypes. The
JAX package falls back to scipy where its library does not build; the port
has no fallback: a library that fails to build or load raises."""

from __future__ import annotations

import ctypes

import numpy as np

from . import kernels

SOURCE = "lap.cpp"


def _library() -> ctypes.CDLL:
    lib = kernels.load(SOURCE)
    lib.batch_lap.restype = None
    lib.batch_lap.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                              ctypes.c_void_p]
    return lib


def batch_linear_assignment(costs: np.ndarray) -> np.ndarray:
    """costs (B, N, M) with N <= M, as float32 -> row_to_col (B, N) int32:
    each row's column, distinct within a problem, at the least total cost
    (-1 where a row has no column). Pairs that must not match carry a large
    finite cost; the caller rejects them afterwards."""
    costs = np.ascontiguousarray(costs, dtype=np.float32)
    b, n, m = costs.shape
    if n > m:
        raise ValueError(f"the assignment takes N <= M rows, got {n} rows and {m} columns")
    out = np.full((b, n), -1, dtype=np.int32)
    _library().batch_lap(costs.ctypes.data, b, n, m, out.ctypes.data)
    return out
