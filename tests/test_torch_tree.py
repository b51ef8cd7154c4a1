"""What the port and chip_smoke.py read at run time is committed: a checkout
holds only what git tracks, and the GPU run starts from a checkout."""

import subprocess
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT_BASE = "75eb9210661add3b1244d8fe621252a999ce539e"  # last commit before the port
RUNTIME_FILES = ["chip_smoke.py", "weights/lg_tpu_stage2.f16.msgpack",
                 "weights/lg5_init_spsoft.f16.msgpack"]


def _git(*args: str) -> subprocess.CompletedProcess:
    return subprocess.run(["git", *args], cwd=ROOT, capture_output=True, text=True,
                          timeout=60)


@pytest.fixture(scope="module")
def tracked() -> set[str]:
    if _git("rev-parse", "--is-inside-work-tree").returncode != 0:
        pytest.skip("not a git checkout")
    return set(_git("ls-files").stdout.splitlines())


def test_runtime_files_are_tracked(tracked):
    package = sorted(str(p.relative_to(ROOT)) for p in (ROOT / "gluefactory_torch").rglob("*")
                     if p.is_file() and "_build" not in p.parts
                     and "__pycache__" not in p.parts)
    assert {"gluefactory_torch/csrc/attention.cu",
            "gluefactory_torch/csrc/elementwise.cu"} <= set(package)
    for path in RUNTIME_FILES + package:
        assert path in tracked, f"{path} is read at run time but not tracked"
        assert _git("check-ignore", "-q", path).returncode != 0, f"{path} is gitignored"


def test_build_products_are_ignored(tracked):
    for product in ("libattention_0.so", "libelementwise_0.so", "kernel_probe.json"):
        assert _git("check-ignore", "-q", f"gluefactory_torch/_build/{product}").returncode == 0
    assert not any(p.startswith("gluefactory_torch/_build/") for p in tracked)


def test_port_adds_no_large_binary_or_data_files(tracked):
    if _git("cat-file", "-e", f"{PORT_BASE}^{{commit}}").returncode != 0:
        pytest.skip("the commit before the port is not in this checkout")
    before = set(_git("ls-tree", "-r", "--name-only", PORT_BASE).stdout.splitlines())
    added = sorted(tracked - before)
    assert added
    for path in added:
        assert not path.startswith(("weights/", "outputs/", "data/")), path
        data = (ROOT / path).read_bytes()
        assert len(data) <= 200_000, f"{path}: {len(data)} bytes"
        assert b"\0" not in data[:8192], f"{path} is binary"
