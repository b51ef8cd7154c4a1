"""Benchmarks (gluefactory_tpu/eval): HPatches homography estimation and its
extended (points and lines) form, MegaDepth-1500 relative pose and its
extended form, ScanNet-1500 relative pose, ETH3D matching AP, the line
benchmarks (HPatches lines, RDNIM lines, Wireframe), and the
registry that the trainer's end-of-epoch benchmarks go through."""

from __future__ import annotations

import importlib


BENCHMARKS = {  # name: (module, pipeline class)
    "hpatches": ("hpatches", "HPatchesPipeline"),
    "megadepth1500": ("megadepth1500", "MegaDepth1500Pipeline"),
    "scannet1500": ("scannet1500", "ScanNet1500Pipeline"),
    "eth3d": ("eth3d", "ETH3DPipeline"),
    "hpatches_extended": ("hpatches_extended", "HPatchesExtendedPipeline"),
    "megadepth1500_extended": ("megadepth1500_extended", "MegaDepth1500ExtendedPipeline"),
    "hpatches_lines": ("hpatches_lines", "HPatchesLinesPipeline"),
    "rdnim_lines": ("rdnim_lines", "RDNIMLinesPipeline"),
    "wireframe": ("wireframe", "WireframePipeline"),
}


def get_benchmark(name: str):
    """The pipeline class of benchmark ``name``."""
    if name not in BENCHMARKS:
        raise NotImplementedError(f"benchmark {name!r} is not ported (ported: "
                                  f"{', '.join(BENCHMARKS)})")
    module, cls = BENCHMARKS[name]
    return getattr(importlib.import_module(f"{__name__}.{module}"), cls)


def run_benchmark(name: str, conf: dict, exp_dir, model=None, device="cuda"):
    """Run benchmark ``name`` with ``conf`` over its defaults on ``model`` (the
    live model the trainer passes, so a cache in ``exp_dir`` is never reused),
    results under ``exp_dir``. Returns (summaries, per-pair results)."""
    pipeline = get_benchmark(name)(conf, device=device)
    return pipeline.run(exp_dir, model=model, overwrite=True)
