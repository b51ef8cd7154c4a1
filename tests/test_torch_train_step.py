"""Training steps of the port against the JAX trainer on the CPU, on the tiny
flagship pipeline (``__graft_entry__._flagship_conf(tiny=True)``: SuperPoint
frozen, 2-layer LightGlue, homography ground truth in the forward pass).

JAX initialises the parameters and the port loads them; both take the same
batch of the JAX engine. Compared: the loss, every LightGlue gradient, the
global gradient norm (frozen SuperPoint included), and the parameters after
two clipped Adam/AdamW steps (optax on the JAX side, the port's Optimizer on
the other), the second at a tenth of the learning rate."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import __graft_entry__
from gluefactory_tpu.core.config import Config
from gluefactory_tpu.datasets.homographies_ondevice import OnDeviceHomographyDataset as JEngine
from gluefactory_tpu.models import build_model as jax_build_model
from gluefactory_tpu.train import default_train_conf as jax_train_conf
from gluefactory_tpu.train import make_optimizer as jax_make_optimizer
from gluefactory_tpu.utils.experiments import state_to_flat_dict
from gluefactory_torch.models import build_model
from gluefactory_torch.train import global_norm, make_optimizer, train_step
from gluefactory_torch.utils.weights import load_state_strict, params_from_flat

torch.set_num_threads(2)

ENGINE_CONF = {"pool_size": 2, "source_size": [96, 96], "image_size": 64, "max_gt_points": 48,
               "train_batch_size": 2, "seed": 1}


@pytest.fixture(scope="module")
def jax_side():
    """The batch, the JAX parameters and a jitted (loss, grads) of them."""
    engine = JEngine(ENGINE_CONF)
    pool = jax.tree.map(jnp.asarray, engine.build_pool("train"))
    batch = jax.tree.map(np.asarray, engine.make_batch(pool, jax.random.key(4)))
    conf = __graft_entry__._flagship_conf(tiny=True)
    model = jax_build_model("two_view_pipeline", conf)
    jbatch = jax.tree.map(jnp.asarray, batch)
    params = jax.jit(partial(model.init, method=model.forward_and_loss))(
        jax.random.key(0), jbatch)

    def loss_fn(params):
        pred = model.apply(params, jbatch)
        losses, _ = model.apply(params, pred, jbatch, method=model.loss)
        return jnp.mean(losses["total"])

    return conf, batch, params, jax.jit(jax.value_and_grad(loss_fn))


def _flat(tree):
    return {k: np.asarray(v) for k, v in state_to_flat_dict(tree).items()}


def _matcher_params(model):
    return {f"matcher.{k}": p for k, p in model.matcher.named_parameters()}


@pytest.mark.parametrize("attention", ["xla", "auto"])
@pytest.mark.parametrize("optimizer,options,clip", [("adam", {}, 1.0),
                                                    ("adamw", {"eps": 1e-3}, 0.05)])
def test_two_steps_match_jax(jax_side, attention, optimizer, options, clip):
    conf, batch, params, value_and_grad = jax_side
    train_conf = {"optimizer": optimizer, "optimizer_options": options, "lr": 1e-3,
                  "clip_grad": clip, "lr_schedule": {"type": "exp", "start": 0, "exp_div_10": 1}}
    tx, _ = jax_make_optimizer(Config(jax_train_conf).merge(train_conf), params, Config(conf))
    opt_state = tx.init(params)

    port_conf = {**conf, "matcher": {**conf["matcher"], "attention": attention}}
    model = build_model("two_view_pipeline", port_conf, device="cpu", train=True)
    load_state_strict(model, params_from_flat(_flat(params), {"matcher": 2}))
    optimizer_ = make_optimizer({**jax_train_conf, **train_conf}, model, port_conf)
    data = jax.tree.map(lambda x: torch.from_numpy(np.array(x)), batch)
    assert {id(p) for p in optimizer_.params} == {id(p) for p in model.matcher.parameters()}

    tiny = {}  # elements whose gradient was ever at rounding level
    for step in range(2):
        loss, grads = value_and_grad(params)
        jgrads = params_from_flat(_flat(grads), {"matcher": 2})
        # the step's gradients, before the clip changes them in place
        model.zero_grad(set_to_none=True)
        pred = model(data)
        model.loss(pred, data)[0]["total"].mean().backward()
        for name, p in _matcher_params(model).items():
            jg = jgrads[name].numpy()
            scale = max(np.abs(jg).max(), 1e-12)
            # relative to the tensor's largest gradient: float32 sums in
            # another order through two attention layers and the loss
            np.testing.assert_allclose(p.grad.numpy() / scale, jg / scale, atol=2e-4,
                                       err_msg=name)
            tiny[name] = tiny.get(name, False) | (np.abs(jg) < 1e-5 * scale)
        norm = float(optax.global_norm(grads))
        all_grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in model.parameters()]
        assert float(global_norm(all_grads)) == pytest.approx(norm, rel=1e-4)

        scalars = train_step(model, optimizer_, data)
        assert scalars["skipped"] == 0.0
        assert scalars["loss/total"] == pytest.approx(float(loss), rel=2e-5)
        assert scalars["grad_norm"] == pytest.approx(norm, rel=1e-4)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)

        new = params_from_flat(_flat(params), {"matcher": 2})
        for name, p in model.state_dict().items():
            # an element whose gradient is at rounding level may take the
            # other sign in Adam's first, sign-like update: 2 lr apart at most
            atol = 2e-6 + 2.2e-3 * tiny.get(name, False)
            diff = np.abs(p.numpy() - new[name].numpy())
            assert (diff <= atol).all(), (name, step, float(diff.max()),
                                          float((diff - atol).max()))
    assert optimizer_.count == 2


def test_a_non_finite_step_changes_nothing(jax_side):
    """A NaN loss skips the update, the optimizer's count and its state; the
    next finite step is the first update."""
    conf, batch, params, _ = jax_side
    model = build_model("two_view_pipeline", conf, device="cpu", train=True)
    load_state_strict(model, params_from_flat(_flat(params), {"matcher": 2}))
    optimizer = make_optimizer({**jax_train_conf, "lr": 1e-3}, model, conf)
    data = jax.tree.map(lambda x: torch.from_numpy(np.array(x)), batch)
    bad = {**data, "view0": {**data["view0"], "image": data["view0"]["image"] * np.nan}}
    before = {k: v.clone() for k, v in model.state_dict().items()}
    scalars = train_step(model, optimizer, bad)
    assert scalars["skipped"] == 1.0 and optimizer.count == 0
    assert not optimizer.inner.state
    for name, value in model.state_dict().items():
        assert torch.equal(value, before[name]), name
    assert train_step(model, optimizer, data)["skipped"] == 0.0 and optimizer.count == 1
    # the frozen extractor is not in the optimizer and does not move
    for name, value in model.extractor.state_dict().items():
        assert torch.equal(value, before[f"extractor.{name}"])
