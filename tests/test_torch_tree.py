"""What the port and chip_smoke.py read at run time is committed: a checkout
holds only what git tracks, and the GPU run starts from a checkout."""

import subprocess
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT_BASE = "75eb9210661add3b1244d8fe621252a999ce539e"  # last commit before the port
RUNTIME_FILES = ["chip_smoke.py", "chip_smoke_gluestick.py", "chip_smoke_lines.py",
                 "chip_smoke_jpldd.py", "chip_smoke_loftr.py", "chip_smoke_sfm.py",
                 "chip_smoke_aliked.py",
                 "weights/loftr_tpu_stage0.f16.msgpack", "weights/loftr_tpu_stage0b.f16.msgpack",
                 "weights/jpldd_tpu_stage0.f16.msgpack",
                 "weights/jpldd_tpu_stage1_desc.f16.msgpack",
                 "weights/jpldd_tpu_structured.f16.msgpack",
                 "weights/jpldd_tpu_structured_descB.f16.msgpack",
                 "weights/lg_tpu_stage2.f16.msgpack",
                 "weights/lg5_init_spsoft.f16.msgpack", "weights/sp_tpu_stage0b.f16.msgpack",
                 "weights/sg_sift_stage1.f16.msgpack", "weights/lg_sift_stage2.f16.msgpack",
                 "weights/lg_sift_stage1.f16.msgpack", "weights/sp_tpu_stage0.f16.msgpack",
                 "weights/gluestick_tpu_stage0.f16.msgpack", "weights/sold2_tpu_stage0.f16.msgpack"]


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
    assert {"gluefactory_torch/csrc/attention.cu", "gluefactory_torch/csrc/elementwise.cu",
            "gluefactory_torch/csrc/lsd.cpp", "gluefactory_torch/csrc/lap.cpp",
            "gluefactory_torch/csrc/elsed.cpp"} <= set(package)
    for path in RUNTIME_FILES + package:
        assert path in tracked, f"{path} is read at run time but not tracked"
        assert _git("check-ignore", "-q", path).returncode != 0, f"{path} is gitignored"


def test_build_products_are_ignored(tracked):
    for product in ("libattention_0.so", "libelementwise_0.so", "liblsd_0.so", "liblap_0.so",
                    "libelsed_0.so", "kernel_probe.json"):
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


def test_runtime_files_are_sent_to_the_gpu_machine():
    """``.chiprunignore`` keeps files out of the copy sent to the GPU machine:
    none of them is one the port reads there."""
    ignored = [line.strip().rstrip("/") for line in
               (ROOT / ".chiprunignore").read_text().splitlines()
               if line.strip() and not line.startswith("#")]
    for path in RUNTIME_FILES:
        assert not any(path == pattern or path.startswith(pattern + "/")
                       for pattern in ignored), f"{path} is kept off the GPU machine"


def _chip_recipes() -> list[str]:
    """The recipes of gluefactory_torch.recipes that chip_smoke.py runs (its
    GlueStick phases from chip_smoke_gluestick.py, its line benchmarks from
    chip_smoke_lines.py, JPLDD from chip_smoke_jpldd.py, LoFTR from
    chip_smoke_loftr.py, the trajectory benchmark from chip_smoke_sfm.py)."""
    import re

    from gluefactory_torch import recipes

    text = "".join((ROOT / name).read_text() for name in ("chip_smoke.py",
                                                          "chip_smoke_gluestick.py",
                                                          "chip_smoke_lines.py",
                                                          "chip_smoke_jpldd.py",
                                                          "chip_smoke_loftr.py",
                                                          "chip_smoke_sfm.py"))
    return sorted({name for name in re.findall(r"\b(\w+_conf)\(\)", text)
                   if callable(getattr(recipes, name, None))})


@pytest.mark.parametrize("recipe", _chip_recipes())
def test_chip_recipes_read_blobs_the_gpu_machine_gets(recipe, tracked):
    """Each recipe that chip_smoke.py runs (phase 17's ETH3D and AdaLAM ones
    among them) names only weight blobs that are tracked and sent to the
    GPU machine: its ``checkpoint`` and its trainer's ``load_experiment``."""
    from gluefactory_torch import recipes

    conf = getattr(recipes, recipe)()
    blobs = [conf.get("checkpoint"), conf.get("train", {}).get("load_experiment")]
    for blob in blobs:
        for path in str(blob).split(",") if blob else []:
            path = str(Path(path).relative_to(ROOT)) if Path(path).is_absolute() else path
            if path.startswith("weights/"):
                assert path in RUNTIME_FILES and path in tracked, f"{recipe}: {path}"


def _line_confs() -> list[str]:
    from gluefactory_torch.recipes import LINE_CONFS

    return [f"{bench}/{name}" for bench, confs in LINE_CONFS.items() for name in confs]


@pytest.mark.parametrize("name", _line_confs())
def test_line_confs_read_blobs_the_gpu_machine_gets(name, tracked):
    """Each line benchmark's conf (phases 20 and 21 run them or read their
    blobs) names only blobs that are tracked and sent to the GPU machine:
    SOLD2's and JPLDD's among them."""
    from gluefactory_torch.recipes import line_conf

    path = line_conf(*name.split("/")).get("checkpoint")
    if path:
        assert path in RUNTIME_FILES and path in tracked, f"{name}: {path}"


@pytest.mark.parametrize("name", sorted(__import__("gluefactory_torch.recipes",
                                                   fromlist=["LOFTR_CONFS"]).LOFTR_CONFS))
def test_loftr_confs_read_blobs_the_gpu_machine_gets(name, tracked):
    """Each committed LoFTR HPatches conf (phase 22 runs three of them) names a
    blob that is tracked and sent to the GPU machine."""
    from gluefactory_torch.recipes import hpatches_loftr_conf

    path = hpatches_loftr_conf(name)["checkpoint"]
    assert path in RUNTIME_FILES and path in tracked, f"{name}: {path}"


@pytest.mark.parametrize("name", sorted(__import__("gluefactory_torch.recipes",
                                                   fromlist=["TRAJECTORY_CONFS"]).TRAJECTORY_CONFS))
def test_trajectory_confs_read_blobs_the_gpu_machine_gets(name, tracked):
    """Each trajectory run (phase 23 runs the three) names a blob that is
    tracked and sent to the GPU machine."""
    from gluefactory_torch.recipes import trajectory_conf

    path = trajectory_conf(name)["checkpoint"]
    assert path in RUNTIME_FILES and path in tracked, f"{name}: {path}"
