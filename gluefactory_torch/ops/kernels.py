"""Build and load the port's CUDA kernels.

Each source in ``gluefactory_torch/csrc`` is compiled by one plain ``nvcc``
call into a shared library with a C interface (no PyTorch headers, so a
build takes seconds, not minutes) and loaded with ``ctypes``. Libraries go to
``gluefactory_torch/_build/`` under a name that holds a hash of the source
and the flags, so a changed source is rebuilt and an unchanged one is loaded
as it is. Nothing is built at import time: the first launch builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
# seconds each library took to build in this process (0.0 = loaded as built)
build_seconds: dict[str, float] = {}


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(nvcc).exists():
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return nvcc


def library_path(source: str) -> Path:
    src = (CSRC_DIR / source).read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{Path(source).stem}_{digest}.so"


def build(source: str) -> Path:
    """Compile ``csrc/<source>`` unless a library for its hash exists."""
    out = library_path(source)
    if out.exists():
        build_seconds.setdefault(source, 0.0)
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    # build under a temporary name, then rename: a concurrent loader never
    # sees a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC_DIR / source)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    log = proc.stdout + proc.stderr
    out.with_suffix(".log").write_text(log)
    if proc.returncode != 0:
        Path(tmp).unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {source}:\n{log}")
    os.replace(tmp, out)
    build_seconds[source] = time.perf_counter() - t0
    print(f"[gluefactory_torch] built {out.name} in {build_seconds[source]:.1f} s",
          flush=True)
    return out


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>``, built at first use."""
    with _lock:
        lib = _loaded.get(source)
        if lib is None:
            lib = ctypes.CDLL(str(build(source)))
            _loaded[source] = lib
        return lib
