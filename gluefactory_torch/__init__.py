"""PyTorch/CUDA port of gluefactory_tpu: deep feature matching on NVIDIA GPUs.

The JAX package ``gluefactory_tpu`` is the reference this package is held
against; module names mirror it. Nothing here imports JAX.
"""
