"""SuperPoint training of the port against the JAX package, on the CPU: the
cell labels, the keypoint and descriptor losses, ``SuperPoint.loss`` under
the three recipes' loss confs with the carried stage-0b weights, the
switches (``dense_outputs``, ``training_outputs``, ``has_detector``,
``has_descriptor``), the recipes against their YAML files, and the trainer
with an extractor-only pipeline."""

import argparse
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from gluefactory_tpu.geometry import kp_losses as jkp
from gluefactory_tpu.models import build_model as jax_build_model
from gluefactory_tpu.models.extractors import superpoint as jsp
from gluefactory_tpu.models.utils import desc_losses as jdesc
from gluefactory_tpu.utils.experiments import restore_from_flat_dict as jax_restore
from gluefactory_tpu.utils.experiments import state_to_flat_dict
from gluefactory_torch.datasets import get_dataset
from gluefactory_torch.datasets.homographies_ondevice import upload_pool
from gluefactory_torch.geometry import kp_losses as tkp
from gluefactory_torch.models import build_model
from gluefactory_torch.models.extractors import superpoint as tsp
from gluefactory_torch.models.utils import desc_losses as tdesc
from gluefactory_torch.recipes import (
    SP_STAGE0B_WEIGHTS,
    sp_soft_conf,
    sp_stage0_conf,
    sp_stage1_conf,
)
from gluefactory_torch.settings import ROOT_PATH
from gluefactory_torch.train import Trainer, training
from gluefactory_torch.utils.experiments import restore_from_flat_dict
from gluefactory_torch.utils.weights import (
    decode_msgpack,
    flat_from_params,
    load_weight_blob,
)

torch.set_num_threads(2)

RECIPES = {"stage0": sp_stage0_conf, "stage1": sp_stage1_conf, "soft": sp_soft_conf}
YAMLS = {"stage0": "superpoint_train_ondevice.yaml", "stage1": "superpoint_stage1_r3.yaml",
         "soft": "superpoint_stage2_soft_r4.yaml"}
# the recipes cut to the CPU: a pool of 2 small images, batch 2, 64 keypoints
CUTS = {"data": {"pool_size": 2, "val_pool_size": 2, "source_size": [128, 128],
                 "image_size": 96, "max_gt_points": 32, "train_batch_size": 2,
                 "val_batch_size": 2, "val_steps": 1},
        "model": {"extractor": {"max_num_keypoints": 64}}}
LOSS_RTOL = 1e-4  # each loss term, relative
GRAD_RTOL = 1e-3  # each gradient, of its tensor's largest


def _cut(conf, **train):
    from gluefactory_torch.core.config import merge

    return merge(conf, {**CUTS, "train": train})


def _t(x):
    return torch.from_numpy(np.array(x))


# --- cell labels ---------------------------------------------------------------------

def _corners(seed, b=2, k=48, hc=4, wc=5):
    """Corners on cell borders, on pixel borders, two in one cell, coincident
    ones, and some outside the map or invalid."""
    rng = np.random.default_rng(seed)
    h, w = hc * 8, wc * 8
    kp = rng.uniform(-3.0, 1.0, (b, k, 2)) + np.array([w + 2, h + 2]) * rng.uniform(
        0, 1, (b, k, 2))
    kp[:, :8] = rng.integers(0, 6, (b, 8, 2)) * 8.0  # cell corners
    kp[:, 8:16] = rng.integers(0, 40, (b, 8, 2)) + 0.5  # pixel borders in the heatmap frame
    kp[:, 16:20] = kp[:, 24:28] + 0.25  # two corners in one cell
    kp[:, 20:22] = kp[:, 22:24]  # coincident
    valid = rng.uniform(size=(b, k)) > 0.1
    return kp.astype(np.float32), valid, hc, wc


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cell_labels_match_jax(seed):
    kp, valid, hc, wc = _corners(seed)
    jhard = np.asarray(jsp._cell_labels(jnp.asarray(kp), jnp.asarray(valid), hc, wc))
    hard = tsp.cell_labels(_t(kp), _t(valid), hc, wc).numpy()
    np.testing.assert_array_equal(hard, jhard)
    assert (hard < 64).sum() > 10
    jsoft = np.asarray(jsp._cell_labels_soft(jnp.asarray(kp), jnp.asarray(valid), hc, wc))
    soft = tsp.cell_labels_soft(_t(kp), _t(valid), hc, wc).numpy()
    np.testing.assert_allclose(soft, jsoft, atol=1e-6, rtol=0)
    assert (soft[..., :64] > 0).any(axis=-1).sum() > 10


# --- keypoint and descriptor losses ----------------------------------------------------

def _heat_inputs(seed, b=2, k=24, h=24, w=32):
    rng = np.random.default_rng(seed)
    heat = rng.gamma(0.3, 0.05, (b, h, w)).astype(np.float32)
    kp = rng.uniform(-1.5, 1.0, (b, k, 2)) + np.array([w, h]) * rng.uniform(0, 1, (b, k, 2))
    kp[:, :4] = np.round(kp[:, :4]) + 0.5  # halves: JAX rounds to even
    gt = kp + rng.normal(0, 1.5, kp.shape)
    valid = rng.uniform(size=(b, k)) > 0.2
    return heat, kp.astype(np.float32), gt.astype(np.float32), valid


KP_LOSSES = {
    "peaky": (lambda m, h, kp, gt, v: m.peaky_loss(h, kp, v, radius=2)),
    "gt_softargmax": (lambda m, h, kp, gt, v: m.gt_anchored_loc_loss(h, gt, v, radius=2)),
    "gt_com": (lambda m, h, kp, gt, v: m.gt_anchored_loc_loss(h, gt, v, radius=2, mode="com")),
    "detections": (lambda m, h, kp, gt, v: m.soft_argmax_loc_loss(h, kp, gt, v, radius=2,
                                                                   max_dist=4.0)),
}


@pytest.mark.parametrize("name", sorted(KP_LOSSES))
def test_kp_losses_match_jax(name):
    fn = KP_LOSSES[name]
    heat, kp, gt, valid = _heat_inputs(4)
    jval, jgrad = jax.value_and_grad(
        lambda h: fn(jkp, h, jnp.asarray(kp), jnp.asarray(gt), jnp.asarray(valid)).sum())(
        jnp.asarray(heat))
    theat = _t(heat).requires_grad_()
    val = fn(tkp, theat, _t(kp), _t(gt), _t(valid))
    val.sum().backward()
    np.testing.assert_allclose(val.detach().numpy(),
                               np.asarray(fn(jkp, jnp.asarray(heat), jnp.asarray(kp),
                                             jnp.asarray(gt), jnp.asarray(valid))),
                               rtol=1e-5, atol=1e-6)
    assert abs(float(val.detach().sum()) - float(jval)) <= 1e-5 * abs(float(jval))
    np.testing.assert_allclose(theat.grad.numpy(), np.asarray(jgrad), atol=1e-5)


def _warp_np(points, H):
    from gluefactory_tpu.geometry.homography import warp_points_np

    return warp_points_np(points, H)


def _unit(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def test_desc_losses_match_jax():
    rng = np.random.default_rng(7)
    b, n, m, d = 2, 20, 24, 16
    d0 = _unit(rng.normal(size=(b, n, d))).astype(np.float32)
    d1 = _unit(rng.normal(size=(b, m, d))).astype(np.float32)
    gt = np.where(rng.uniform(size=(b, n)) > 0.3, rng.integers(0, m, (b, n)), -1)
    valid0 = rng.uniform(size=(b, n)) > 0.1

    def nll(mod, a, c):
        return mod.nll_desc_loss(a, c, gt_t if mod is tdesc else jnp.asarray(gt),
                                 temperature=0.1,
                                 valid0=_t(valid0) if mod is tdesc else jnp.asarray(valid0))

    gt_t = _t(gt)
    jv, jg = jax.value_and_grad(lambda a: nll(jdesc, a, jnp.asarray(d1)).sum())(jnp.asarray(d0))
    a = _t(d0).requires_grad_()
    v = nll(tdesc, a, _t(d1))
    v.sum().backward()
    np.testing.assert_allclose(v.detach().numpy(), np.asarray(nll(jdesc, jnp.asarray(d0),
                                                                   jnp.asarray(d1))), rtol=1e-5)
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(jg), atol=1e-5)

    # mutual nearest detections under a homography, with invalid slots
    kp0 = rng.uniform(0, 64, (b, n, 2)).astype(np.float32)
    H = np.tile(np.array([[1.02, 0.03, 2.0], [-0.02, 0.99, -1.5], [1e-4, 0.0, 1.0]],
                         np.float32), (b, 1, 1))
    near = _warp_np(kp0[:, :12], H) + rng.normal(0, 0.5, (b, 12, 2))
    kp1 = np.concatenate([near, rng.uniform(0, 64, (b, m - 12, 2))], 1).astype(np.float32)
    v1 = rng.uniform(size=(b, m)) > 0.1
    jm = jdesc.mutual_detected_matches(*(jnp.asarray(x) for x in (kp0, kp1, valid0, v1, H)))
    tm = tdesc.mutual_detected_matches(*(_t(x) for x in (kp0, kp1, valid0, v1, H)))
    for x, y in zip(tm, jm):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    assert (tm[0].numpy() >= 0).sum() >= 8

    # CAPS: some reprojections outside the map, one whole window clamped
    dmap = _unit(rng.normal(size=(b, 8, 10, d))).astype(np.float32)
    pts = rng.uniform(-2, 11, (b, n, 2)).astype(np.float32)
    pts[:, 0] = [-30.0, -30.0]

    def caps(mod, a, f):
        return mod.caps_window_loss(a, pts if mod is jdesc else _t(pts), f, window=3.0,
                                    temperature=0.07,
                                    valid0=jnp.asarray(valid0) if mod is jdesc else _t(valid0))

    jv, jg = jax.value_and_grad(lambda a, f: caps(jdesc, a, f).sum(), argnums=(0, 1))(
        jnp.asarray(d0), jnp.asarray(dmap))
    a, f = _t(d0).requires_grad_(), _t(dmap).requires_grad_()
    v = caps(tdesc, a, f)
    v.sum().backward()
    assert abs(float(v.detach().sum()) - float(jv)) <= 1e-5 * abs(float(jv))
    for got, want in ((a.grad, jg[0]), (f.grad, jg[1])):
        assert torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


# --- SuperPoint.loss, port against JAX ----------------------------------------------

@pytest.fixture(scope="module")
def engine_batch():
    """One batch of the port's engine (batch 2, 96x96, 32 GT points), numpy."""
    conf = _cut(sp_stage1_conf())
    dataset = get_dataset("homographies_ondevice")(conf["data"])
    pool = upload_pool(dataset.build_pool("train"), "cpu")
    batch = dataset.make_batch(pool, 5)
    return jax.tree.map(lambda x: x.numpy(), batch)


def _jax_losses(conf, batches, flat):
    """For each batch: (loss terms, metrics, flat gradients) of the JAX
    pipeline ``conf`` holding the blob ``flat`` (one compile for all)."""
    model = jax_build_model("two_view_pipeline", conf)
    data = jax.tree.map(jnp.asarray, batches[0])
    params = jax_restore(model.init(jax.random.key(0), data), flat)

    def loss_fn(p, data):
        pred = model.apply(p, data)
        losses, metrics = model.apply(p, pred, data, method=model.loss)
        return jnp.mean(losses["total"]), (losses, metrics)

    step = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    out = []
    for batch in batches:
        (_, (losses, metrics)), grads = step(params, jax.tree.map(jnp.asarray, batch))
        out.append((jax.tree.map(np.asarray, losses), jax.tree.map(np.asarray, metrics),
                    {k: np.asarray(v) for k, v in state_to_flat_dict(grads).items()}))
    return out


def _untied(batch):
    """The batch with both images scaled by 1 + 2^-23 (a change of one ulp).
    XLA's convolutions give identical patches of flat image regions identical
    outputs, and the first max-pool then meets exact ties, whose gradient
    JAX routes otherwise than to the element a 1-ulp change selects; the
    port's convolutions do not tie there (measured: the port against JAX
    differs by up to 1.6e-3 of the largest gradient in the two convolutions
    under the first max-pool, exactly as JAX against itself on this batch;
    against JAX here it is within 4e-6)."""
    batch = jax.tree.map(np.copy, batch)
    for view in ("view0", "view1"):
        batch[view]["image"] = (batch[view]["image"] * np.float32(1 + 2**-23)).astype(np.float32)
    return batch


@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_superpoint_loss_matches_jax(recipe, engine_batch):
    """The loss terms within LOSS_RTOL and the metrics against JAX on the
    batch, and every gradient within GRAD_RTOL of its tensor's largest
    against JAX on the untied batch (``_untied``), from the stage-0b
    weights."""
    conf = _cut(RECIPES[recipe]())["model"]
    flat, _, _ = load_weight_blob(SP_STAGE0B_WEIGHTS)
    (jlosses, jmetrics, _), (_, _, jgrads) = _jax_losses(
        conf, [engine_batch, _untied(engine_batch)], flat)
    model = build_model("two_view_pipeline", conf, device="cpu", train=True)
    restore_from_flat_dict(model, flat)
    batch = jax.tree.map(torch.from_numpy, engine_batch)
    pred = model(batch)
    losses, metrics = model.loss(pred, batch)
    losses["total"].mean().backward()
    assert losses.keys() == jlosses.keys() and metrics.keys() == jmetrics.keys()
    for k, v in losses.items():
        np.testing.assert_allclose(v.detach().numpy(), jlosses[k], rtol=LOSS_RTOL, atol=1e-7,
                                   err_msg=k)
    for k, v in metrics.items():
        np.testing.assert_allclose(v.numpy(), jmetrics[k], rtol=1e-4, atol=1e-6, err_msg=k)
    grads = flat_from_params({n: p.grad for n, p in model.named_parameters()})
    assert grads.keys() == jgrads.keys()
    for k, g in grads.items():
        scale = np.abs(jgrads[k]).max()
        assert np.abs(g - jgrads[k]).max() <= GRAD_RTOL * scale, (k, scale)


# --- the switches ----------------------------------------------------------------------

@pytest.mark.parametrize("switch", [{"dense_outputs": True}, {"training_outputs": True},
                                    {"has_detector": False}, {"has_descriptor": False}])
def test_switches_match_jax(switch, engine_batch):
    """The output keys and values of each switch, with the two-head stage-0b
    blob restored into the model as each package restores a checkpoint
    (a head the model lacks is skipped)."""
    conf = {"name": "extractors.superpoint", "max_num_keypoints": 64,
            "detection_threshold": 0.0005, "refinement_radius": 2, **switch}
    flat, _, _ = load_weight_blob(SP_STAGE0B_WEIGHTS)
    flat = {k.replace("['extractor']", "", 1): v for k, v in flat.items()}
    view = {k: engine_batch["view0"][k] for k in ("image", "image_size")}
    jmodel = jax_build_model("extractors.superpoint", conf)
    jdata = jax.tree.map(jnp.asarray, view)
    jpred = jax.tree.map(np.asarray, dict(jmodel.apply(
        jax_restore(jmodel.init(jax.random.key(0), jdata), flat), jdata)))
    model = build_model("extractors.superpoint", conf, device="cpu")
    restore_from_flat_dict(model, flat)
    with torch.inference_mode():
        pred = {k: v.numpy() for k, v in model(jax.tree.map(torch.from_numpy, view)).items()}
    assert pred.keys() == jpred.keys()
    tolerance = {"keypoints": 1e-4, "cell_logits": 1e-4, "keypoint_scores": 1e-6,
                 "heatmap": 1e-6}
    for k, v in pred.items():
        if v.dtype == bool:
            np.testing.assert_array_equal(v, jpred[k])
        else:
            np.testing.assert_allclose(v, jpred[k], atol=tolerance.get(k, 1e-5), err_msg=k)


def test_loss_needs_training_outputs(engine_batch):
    """Without ``training_outputs`` SuperPoint's loss raises
    NotImplementedError, which the pipeline's loss skips, as in JAX."""
    conf = {"name": "two_view_pipeline",
            "extractor": {"name": "extractors.superpoint", "max_num_keypoints": 64}}
    model = build_model("two_view_pipeline", conf, device="cpu")
    batch = jax.tree.map(torch.from_numpy, engine_batch)
    with torch.inference_mode():
        pred = model(batch)
        with pytest.raises(NotImplementedError, match="training_outputs"):
            model.extractor.loss(pred, {**pred, **batch})
        losses, metrics = model.loss(pred, batch)
    assert losses == {"total": 0} and metrics == {}


# --- recipes and the trainer -------------------------------------------------------------

@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_recipe_matches_the_yaml(recipe):
    path = ROOT_PATH / "gluefactory_tpu/configs" / YAMLS[recipe]
    assert RECIPES[recipe]() == yaml.safe_load(path.read_text())


@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_recipe_trainer_step(recipe):
    """One CPU step of each recipe, cut small: every loss and norm finite, not
    skipped; stage 1 starts from the stage-0b blob (load_experiment)."""
    trainer = Trainer(_cut(RECIPES[recipe]()), device="cpu")
    if recipe == "stage1":
        flat, _, _ = load_weight_blob(SP_STAGE0B_WEIGHTS)
        state = flat_from_params(trainer.model.state_dict())
        assert state.keys() == flat.keys()
        assert all(np.array_equal(state[k], flat[k]) for k in flat)
    scalars = trainer.step(11)
    assert scalars["skipped"] == 0.0
    assert all(np.isfinite(v) for v in scalars.values()), scalars
    assert scalars["grad_norm/extractor"] > 0
    terms = {"stage0": 3, "stage1": 9, "soft": 7}[recipe]  # loss/* keys besides total
    assert sum(k.startswith("loss/") for k in scalars) == terms + 1


def test_extractor_only_training_evaluates_checkpoints_and_restores(tmp_path):
    """``training`` with an extractor-only pipeline: validation without
    ``match_AP``, checkpoint_best by loss/total (min), and a --restore that
    gives back the parameters and the next step's loss."""
    conf = _cut(sp_stage0_conf(), epochs=2, eval_every_iter=2, log_every_iter=1)
    conf["data"]["steps_per_epoch"] = 2
    run = tmp_path / "run"
    _, history = training(conf, run, device="cpu")
    records = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    keys = set().union(*records)
    assert {"val/loss/total", "val/metric/kp_precision0", "val/metric/desc_pos_sim"} <= keys
    assert "val/match_AP" not in keys
    val = [r["val/loss/total"] for r in records if "val/loss/total" in r]
    best = decode_msgpack((run / "checkpoint_best.ckpt").read_bytes())
    assert len(val) == 2 and best["epoch"] == int(np.argmin(val))
    assert sorted(p.name for p in run.glob("checkpoint_*.ckpt")) == [
        "checkpoint_0_2.ckpt", "checkpoint_1_4.ckpt", "checkpoint_best.ckpt"]
    resumed = tmp_path / "resumed"
    resumed.mkdir()
    shutil.copy(run / "checkpoint_0_2.ckpt", resumed)
    shutil.copy(run / "config.yaml", resumed)
    trainer, again = training(conf, resumed, argparse.Namespace(restore=True), device="cpu",
                              steps=1)
    assert again[0]["loss/total"] == history[2]["loss/total"]
