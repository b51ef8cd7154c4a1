"""flax's default initialisation for the port's layers: the JAX package
builds every ``nn.Dense`` and ``nn.Conv`` with flax's defaults, so a model
trained from scratch starts from the same distribution here.

Kernels are ``lecun_normal``, flax's ``variance_scaling(1, "fan_in",
"truncated_normal")``: a normal truncated at two standard deviations,
rescaled so that the truncated draw has standard deviation 1/sqrt(fan_in);
fan_in is the input width of a dense layer and kh*kw*c_in of a
convolution. Biases start at zero. A layer built with
``kernel_init=zeros`` starts at zero (``zeros_reset_``), and a parameter
drawn from ``normal(stddev)`` is a plain normal of that standard deviation
(``normal_``)."""

from __future__ import annotations

import math

import torch

# the standard deviation of a unit normal truncated to [-2, 2] (flax's constant)
TRUNCATED_STD = 0.87962566103423978


# the unit normal's CDF at -2 and 2, the bounds of the uniform draw (as 2 CDF - 1)
_CDF_BOUND = math.erf(2.0 / math.sqrt(2.0))


def lecun_normal_(weight: torch.Tensor) -> torch.Tensor:
    """Fill a PyTorch weight ((out, in) or (out, in, kh, kw); fan_in is the
    size of one output's slice) in place as flax's ``lecun_normal``, drawn as
    ``jax.random.truncated_normal`` draws: the inverse CDF of a uniform
    between the bounds' CDFs, clipped to the bounds (one pass, where
    rejection sampling redraws the tensor until every value falls inside)."""
    std = 1.0 / math.sqrt(weight[0].numel()) / TRUNCATED_STD
    with torch.no_grad():
        weight.uniform_(-_CDF_BOUND, _CDF_BOUND).erfinv_().mul_(std * math.sqrt(2.0))
        return weight.clamp_(-2.0 * std, 2.0 * std)


def flax_reset_(layer: torch.nn.Module) -> None:
    """A ``Linear`` or ``Conv2d`` as flax initialises its counterpart."""
    lecun_normal_(layer.weight)
    if layer.bias is not None:
        with torch.no_grad():
            layer.bias.zero_()


def zeros_reset_(layer: torch.nn.Module) -> None:
    """A ``Linear`` or ``Conv2d`` whose flax counterpart has
    ``kernel_init=zeros``: kernel and bias zero."""
    with torch.no_grad():
        layer.weight.zero_()
        if layer.bias is not None:
            layer.bias.zero_()


def normal_(weight: torch.Tensor, stddev: float) -> torch.Tensor:
    """Fill ``weight`` in place as flax's ``initializers.normal(stddev)``."""
    with torch.no_grad():
        return weight.normal_(0.0, stddev)
