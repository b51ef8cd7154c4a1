"""Benchmarks (gluefactory_tpu/eval): HPatches homography estimation."""
