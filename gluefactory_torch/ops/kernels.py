"""Build and load the port's CUDA kernels and host libraries.

Each source in ``gluefactory_torch/csrc`` is compiled by one plain compiler
call into a shared library with a C interface (no PyTorch headers, so a
build takes seconds, not minutes) and loaded with ``ctypes``: a ``.cu``
source by ``nvcc`` for sm_90a, a ``.cpp`` source (host code, such as the
LSD line detector) by the host C++ compiler with ``-O2 -ffp-contract=off``
and no fast-math, so every host computes the same bits. Libraries go to
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
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

HOST_FLAGS = ("-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
# seconds each library took to build in this process (0.0 = loaded as built)
build_seconds: dict[str, float] = {}


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(nvcc).exists():
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return nvcc


def find_host_compiler() -> str:
    for name in ("c++", "g++"):
        path = shutil.which(name)
        if path:
            return path
    raise RuntimeError("no host C++ compiler (c++ or g++) found: the host libraries need one")


def _flags(source: str) -> tuple[str, ...]:
    return HOST_FLAGS if source.endswith(".cpp") else NVCC_FLAGS


def library_path(source: str) -> Path:
    src = (CSRC_DIR / source).read_bytes()
    digest = hashlib.sha256(src + " ".join(_flags(source)).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{Path(source).stem}_{digest}.so"


def build(source: str) -> Path:
    """Compile ``csrc/<source>`` unless a library for its hash exists; a
    failed build raises with the compiler's log."""
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
    compiler = find_host_compiler() if source.endswith(".cpp") else find_nvcc()
    cmd = [compiler, *_flags(source), "-o", tmp, str(CSRC_DIR / source)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    log = proc.stdout + proc.stderr
    out.with_suffix(".log").write_text(log)
    if proc.returncode != 0:
        Path(tmp).unlink(missing_ok=True)
        raise RuntimeError(f"{Path(compiler).name} failed on {source}:\n{log}")
    os.replace(tmp, out)
    build_seconds[source] = time.perf_counter() - t0
    print(f"[gluefactory_torch] built {out.name} in {build_seconds[source]:.1f} s",
          flush=True)
    return out


def build_all(sources: list[str]) -> None:
    """Compile several sources at once, one compiler process each."""
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        for future in [pool.submit(build, source) for source in sources]:
            future.result()


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>``, built at first use."""
    with _lock:
        lib = _loaded.get(source)
        if lib is None:
            lib = ctypes.CDLL(str(build(source)))
            _loaded[source] = lib
        return lib
