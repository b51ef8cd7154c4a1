"""The port initialises its parameters as flax does (fault F3): every weight
of SuperPoint and LightGlue at full width is drawn like flax's ``lecun_normal``
kernels (a normal truncated at 2 standard deviations, std 1/sqrt(fan_in)),
biases start at zero, and LayerNorm and the channel affines at ones and
zeros.

The standard deviations are those of the distributions: each weight is
redrawn (its layer's ``reset_parameters``) and each flax layer of the same
shape initialised under many keys until 2^17 values are pooled, so the
sampling error of a std is ~0.2% against the 3% tolerance."""

import math

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gluefactory_torch.models import build_model
from gluefactory_torch.models.utils.init import TRUNCATED_STD

torch.set_num_threads(2)

SAMPLES = 1 << 17
STD_RTOL = 0.03
MODELS = {
    "extractors.superpoint": {},
    "matchers.lightglue": {"n_layers": 2},  # every layer holds the same kinds of weight
}


def _layers(model):
    """(name, layer) of every Linear and Conv2d of ``model``."""
    return [(n, m) for n, m in model.named_modules()
            if isinstance(m, (torch.nn.Linear, torch.nn.Conv2d))]


def _port_draws(layer) -> np.ndarray:
    torch.manual_seed(0)
    n = max(1, math.ceil(SAMPLES / layer.weight.numel()))
    draws = []
    for _ in range(n):
        layer.reset_parameters()
        draws.append(layer.weight.detach().numpy().ravel().copy())
    return np.concatenate(draws)


def _flax_draws(layer) -> np.ndarray:
    """Kernels of the flax layer of the same shape, under many keys."""
    w = layer.weight
    if w.ndim == 4:
        flax_layer = nn.Conv(w.shape[0], w.shape[2:], use_bias=layer.bias is not None)
        x = jnp.zeros((1, 8, 8, w.shape[1]))
    else:
        flax_layer = nn.Dense(w.shape[0], use_bias=layer.bias is not None)
        x = jnp.zeros((1, w.shape[1]))
    n = max(1, math.ceil(SAMPLES / w.numel()))
    keys = jax.random.split(jax.random.key(0), n)
    kernels = jax.vmap(lambda k: flax_layer.init(k, x)["params"]["kernel"])(keys)
    return np.asarray(kernels).ravel()


@pytest.mark.parametrize("name", sorted(MODELS))
def test_weights_are_drawn_as_flax_draws_them(name):
    model = build_model(name, MODELS[name], device="cpu")
    layers = _layers(model)
    assert len(layers) >= (12 if name.endswith("superpoint") else 20)
    for lname, layer in layers:
        fan_in = layer.weight[0].numel()
        std = 1.0 / math.sqrt(fan_in)
        w = layer.weight.detach().numpy()
        # the model's own draw: inside the truncation, biases zero
        assert np.abs(w).max() <= 2.0 * std / TRUNCATED_STD * (1 + 1e-6), lname
        if layer.bias is not None:
            assert not layer.bias.detach().numpy().any(), lname
        port = _port_draws(layer)
        jax_std = _flax_draws(layer).std()
        assert abs(port.std() / std - 1.0) <= STD_RTOL, (lname, port.std(), std)
        assert abs(port.std() / jax_std - 1.0) <= STD_RTOL, (lname, port.std(), jax_std)
        assert abs(port.mean()) <= 0.02 * std, lname


def test_norms_and_affines_start_at_ones_and_zeros():
    for name, conf in (("matchers.lightglue", {"n_layers": 2}),
                       ("extractors.superpoint", {"post_relu_affine": True})):
        model = build_model(name, conf, device="cpu")
        for pname, p in model.named_parameters():
            if ".ffn.1." in pname or "affine" in pname:
                want = 1.0 if pname.endswith(("weight", "scale")) else 0.0
                assert np.all(p.detach().numpy() == want), pname


def test_trainer_draws_under_its_seed():
    """The draws stay under Trainer's seeded ``fork_rng``: the same seed gives
    the same parameters, and the global generator is left as it was."""
    from gluefactory_torch.recipes import sp_stage0_conf
    from gluefactory_torch.train import Trainer

    conf = sp_stage0_conf()
    conf["data"].update(pool_size=1, source_size=[96, 96])
    torch.manual_seed(123)
    before = torch.random.get_rng_state()
    a = Trainer(conf, device="cpu").model.state_dict()
    assert torch.equal(torch.random.get_rng_state(), before)
    b = Trainer(conf, device="cpu").model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    conf["train"]["seed"] = 8
    c = Trainer(conf, device="cpu").model.state_dict()
    assert not torch.equal(a["extractor.convPa.weight"], c["extractor.convPa.weight"])
