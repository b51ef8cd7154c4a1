"""Benchmarks (gluefactory_tpu/eval): HPatches homography estimation, and the
registry that the trainer's end-of-epoch benchmarks go through."""

from __future__ import annotations


def get_benchmark(name: str):
    """The pipeline class of benchmark ``name``; only hpatches is ported."""
    if name != "hpatches":
        raise NotImplementedError(f"benchmark {name!r} is not ported (ported: hpatches)")
    from .hpatches import HPatchesPipeline

    return HPatchesPipeline


def run_benchmark(name: str, conf: dict, exp_dir, model=None, device="cuda"):
    """Run benchmark ``name`` with ``conf`` over its defaults on ``model`` (the
    live model the trainer passes, so a cache in ``exp_dir`` is never reused),
    results under ``exp_dir``. Returns (summaries, per-pair results)."""
    pipeline = get_benchmark(name)(conf, device=device)
    return pipeline.run(exp_dir, model=model, overwrite=True)
