"""LoFTR in the port against the JAX package on the CPU: a narrow LoFTR
(widths 16/20/32, 2 coarse and 1 fine layer pairs, 4 heads) on the same flax
parameters at 64x64 and at 76x60 (whose maps, 38 -> 19 -> 10, upsample at a
ratio that is not 2): the coarse confidence, the match slots, the refined
keypoints, the loss and every gradient; ``loftr_tpu_stage0b`` at full width
from its blob; the sine encoding, the GroupNorm's groups and the FPN's
bilinear upsampling alone; both blobs' strict load; the HPatches CLI on the
committed confs by name; and a training step of each recipe.

Bounds: the confidence within CONF_TOL (each package's float32 confidence
lies about 1e-5 from a float64 evaluation of the same model at these
inputs: the temperature of 0.1 multiplies the tokens' rounding by about 10,
so the two packages part by up to twice that), the valid slots equal as sets of
(view-0 cell, view-1 cell) pairs, the refined keypoints within KP_TOL px,
the loss within LOSS_RTOL relative, each gradient within GRAD_RTOL of its
tensor's largest value."""

import functools
import math

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gluefactory_torch.datasets.homographies_ondevice import generate_structured_scene
from gluefactory_torch.models import build_model
from gluefactory_torch.models.matchers import loftr as L
from gluefactory_torch.recipes import LOFTR_WEIGHTS
from gluefactory_torch.settings import ROOT_PATH
from gluefactory_torch.utils.weights import load_blob_into, load_state_strict, params_from_flat
from gluefactory_tpu.core.config import Config
from gluefactory_tpu.eval.io import load_model as jax_load_model
from gluefactory_tpu.eval.io import restore_params
from gluefactory_tpu.models import build_model as jax_build_model
from gluefactory_tpu.models.matchers import loftr as JL
from gluefactory_tpu.utils.experiments import state_to_flat_dict

torch.set_num_threads(2)

CONF_TOL = 3e-5
KP_TOL = 1e-4
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
BLOCK_TOL = 1e-5
NARROW = {"name": "matchers.loftr", "initial_dim": 16, "block_dims": [16, 20, 32],
          "coarse_dim": 32, "fine_dim": 16, "coarse_layers": 2, "fine_layers": 1, "heads": 4,
          "match_threshold": 0.01, "max_matches": 64}


def _t(x):
    return torch.from_numpy(np.array(x))


def _pair_data(h: int, w: int, seed: int = 0) -> dict:
    """A structured scene and its crop shifted by (dx, dy) = (5, 9): view 1
    sees view 0's point (x, y) at (x - 5, y - 9)."""
    side = max(h, w) + 16
    scene = generate_structured_scene(np.random.default_rng(seed), (side, side),
                                      max_points=4)[0].astype(np.float32)
    view0, view1 = scene[None, :h, :w], scene[None, 9:9 + h, 5:5 + w]
    H = np.array([[[1, 0, -5], [0, 1, -9], [0, 0, 1]]], np.float32)
    return {"view0": {"image": np.repeat(view0, 3, -1)}, "view1": {"image": view1},
            "H_0to1": H}


def _jnp(tree):
    return jax.tree.map(jnp.asarray, tree)


def _torch(tree):
    return {k: _torch(v) if isinstance(v, dict) else _t(v) for k, v in tree.items()}


@functools.lru_cache(maxsize=None)
def _jax_case(h: int, w: int):
    """JAX's narrow LoFTR on the pair at (h, w): (flat params, data, prediction,
    loss, flat gradients of the mean total loss), numpy."""
    data = _pair_data(h, w)
    model = jax_build_model("matchers.loftr", Config(NARROW))
    params = jax.jit(model.init)(jax.random.key(3), _jnp(data))

    def loss_fn(p, d):
        pred = model.apply(p, d)
        losses, _ = model.apply(p, pred, d, method=model.loss)
        return jnp.mean(losses["total"]), pred

    (loss, pred), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params, _jnp(data))
    flat = {k: np.asarray(v) for k, v in state_to_flat_dict(params).items()}
    gflat = {k: np.asarray(v) for k, v in state_to_flat_dict(grads).items()}
    return flat, data, {k: np.asarray(v) for k, v in pred.items()}, float(loss), gflat


def _port_case(h: int, w: int):
    flat, data, _, _, _ = _jax_case(h, w)
    model = build_model("matchers.loftr", NARROW, device="cpu", train=True)
    load_state_strict(model, params_from_flat(flat))
    pred = model(_torch(data))
    losses, _ = model.loss(pred, _torch(data))
    loss = losses["total"].mean()
    loss.backward()
    return model, pred, float(loss)


def _slots(pred: dict) -> dict:
    """{(view-0 cell centre, view-1 cell): refined keypoint 1} of the valid
    slots (the coarse cell of a refined keypoint is its slot's cell)."""
    v = np.asarray(pred["keypoint_valid0"][0])
    kp0 = np.asarray(pred["keypoints0"][0])[v]
    kp1 = np.asarray(pred["keypoints1"][0])[v]
    score = np.asarray(pred["matching_scores0"][0])[v]
    return {tuple(k0.round().astype(int)): (k1, s) for k0, k1, s in zip(kp0, kp1, score)}


def _hold_slots(ours: dict, ref: dict, min_valid: int) -> None:
    np.testing.assert_allclose(ours["coarse_confidence"], ref["coarse_confidence"], atol=CONF_TOL,
                               rtol=0)
    a, b = _slots(ours), _slots(ref)
    assert a.keys() == b.keys() and len(a) >= min_valid, (len(a), len(b))
    for cell, (k1, s) in b.items():
        np.testing.assert_allclose(a[cell][0], k1, atol=KP_TOL, rtol=0, err_msg=str(cell))
        np.testing.assert_allclose(a[cell][1], s, atol=CONF_TOL, rtol=0)
    m = np.asarray(ours["matches0"][0])
    v = np.asarray(ours["keypoint_valid0"][0])
    assert (m[v] == np.flatnonzero(v)).all() and (m[~v] == -1).all()
    assert not np.asarray(ours["keypoints1"][0])[~v].any()


@pytest.mark.parametrize("h,w", [(64, 64), (76, 60)])
def test_narrow_loftr_forward_is_jaxs(h, w):
    _, _, ref, _, _ = _jax_case(h, w)
    _, pred, _ = _port_case(h, w)
    ours = {k: v.detach().numpy() for k, v in pred.items()}
    assert ours["coarse_confidence"].shape == (1, math.ceil(h / 8) * math.ceil(w / 8),
                                               math.ceil(h / 8) * math.ceil(w / 8))
    np.testing.assert_array_equal(ours["coarse_shapes"], ref["coarse_shapes"])
    _hold_slots(ours, ref, min_valid=8)
    # the refinement moved the keypoints off the cell centres
    v = ours["keypoint_valid0"][0]
    assert np.abs((ours["keypoints1"][0][v] - 4.0) % 8.0).max() > 0.01


@pytest.mark.parametrize("h,w", [(64, 64), (76, 60)])
def test_narrow_loftr_loss_and_gradients_are_jaxs(h, w):
    _, _, _, ref_loss, ref_grads = _jax_case(h, w)
    model, _, loss = _port_case(h, w)
    assert abs(loss - ref_loss) <= LOSS_RTOL * abs(ref_loss), (loss, ref_loss)
    ref = params_from_flat(ref_grads)
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert grads.keys() == ref.keys()
    fine = 0.0
    for name, g in ref.items():
        scale = float(g.abs().max())
        assert float((grads[name] - g).abs().max()) <= GRAD_RTOL * max(scale, 1e-30), name
        fine += float(g.square().sum()) if name.startswith(("fself", "fcross", "fine_proj")) else 0
    assert fine > 0  # the fine branch is trained


def test_stage0b_blob_at_full_width_is_jaxs():
    """``loftr_tpu_stage0b`` loaded strictly (217 arrays), on a 96x96 pair, as
    the HPatches confs run it (1024 slots)."""
    path = ROOT_PATH / LOFTR_WEIGHTS["stage0b"]
    conf = {"name": "matchers.loftr", "max_matches": 1024}
    data = _pair_data(96, 96, seed=5)
    model = build_model("matchers.loftr", conf, device="cpu")
    model_conf, _ = load_blob_into(model, path)
    assert len(model.state_dict()) == 217 and model_conf["max_matches"] == 512
    with torch.inference_mode():
        ours = {k: v.numpy() for k, v in model(_torch(data)).items()}
    jmodel, flat = jax_load_model(Config(conf), str(path))
    params = restore_params(jax.jit(jmodel.init)(jax.random.key(0), _jnp(data)), flat)
    ref = {k: np.asarray(v) for k, v in jax.jit(jmodel.apply)(params, _jnp(data)).items()}
    _hold_slots(ours, ref, min_valid=40)


@pytest.mark.parametrize("blob", sorted(LOFTR_WEIGHTS))
def test_each_blob_loads_strictly(blob):
    model = build_model("matchers.loftr", {}, device="cpu")
    model_conf, meta = load_blob_into(model, ROOT_PATH / LOFTR_WEIGHTS[blob])
    assert len(model.state_dict()) == 217 and meta["experiment"] == f"loftr_tpu_{blob}"
    assert model_conf["max_matches"] == 512


@pytest.mark.parametrize("h,w,dim", [(60, 60, 256), (10, 8, 32), (45, 60, 256), (1, 1, 4)])
def test_sine_pos_encoding_is_jaxs(h, w, dim):
    """The frequencies in float32, each within an ulp of XLA's (their exp
    differs in the last bit on some; float64's rounded would differ on most),
    and so the encoding within two ulps of its largest argument."""
    q = dim // 4
    ref_freq = np.asarray(jnp.exp(jnp.arange(q) * (-math.log(10000.0) / max(q - 1, 1))))
    freq = L.sine_frequencies(q).numpy()
    assert freq.dtype == np.float32
    np.testing.assert_allclose(freq, ref_freq, rtol=2.0**-23, atol=0)
    ref = np.asarray(JL.sine_pos_encoding(h, w, dim))
    out = L.sine_pos_encoding(h, w, dim).numpy()
    assert out.dtype == ref.dtype == np.float32
    np.testing.assert_allclose(out, ref, atol=2.0**-22 * max(h, w), rtol=0)


@pytest.mark.parametrize("channels,groups", [(16, 8), (20, 4), (32, 8), (128, 8), (196, 4),
                                             (256, 8)])
def test_group_norm_is_flaxs(channels, groups):
    """``_gn``'s group count (``gcd(8, C)``), epsilon and statistics against
    flax's GroupNorm with a drawn scale and bias."""
    rng = np.random.default_rng(channels)
    x = (rng.normal(size=(2, 7, 9, channels)) * 3 + 1).astype(np.float32)
    port = L._gn(channels)
    assert port.num_groups == groups and port.eps == 1e-6
    layer = fnn.GroupNorm(num_groups=math.gcd(8, channels))
    params = layer.init(jax.random.key(0), jnp.asarray(x))
    params = jax.tree.map(lambda p: jnp.asarray(rng.normal(size=p.shape), jnp.float32), params)
    load_state_strict(port, params_from_flat(
        {k: np.asarray(v) for k, v in state_to_flat_dict(params).items()}))
    ref = np.asarray(layer.apply(params, jnp.asarray(x)))
    out = port(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).detach().numpy()
    np.testing.assert_allclose(out, ref, atol=BLOCK_TOL, rtol=0)


@pytest.mark.parametrize("src,dst", [((60, 60), (120, 120)), ((120, 120), (240, 240)),
                                     ((10, 8), (19, 15)), ((19, 15), (38, 30)), ((1, 1), (1, 1))])
def test_fpn_upsampling_is_jax_image_resize(src, dst):
    """The FPN's upsampling against ``jax.image.resize`` ('bilinear'): the
    exact 2x of a 480-pixel view and the 10 -> 19 of a 76-pixel side."""
    x = np.random.default_rng(3).normal(size=(2, *src, 5)).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (2, *dst, 5), "bilinear"))
    like = torch.zeros(1, 1, *dst)
    out = L._upsample(_t(x).permute(0, 3, 1, 2), like).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(out, ref, atol=BLOCK_TOL, rtol=0)


def test_hpatches_cli_runs_the_committed_confs_by_name(tmp_path, monkeypatch):
    """``eval.hpatches --conf <LOFTR_CONFS name>`` on one rendered sequence at
    128 pixels: the bare matcher and the pipeline with no extractor and the
    refiner, from the blob; both export the validity masks, and the refiner
    moves some of the matcher's keypoints."""
    from gluefactory_torch.eval import hpatches
    from gluefactory_torch.scripts.generate_eval_set import render_sequence

    render_sequence(tmp_path / "set" / "v_cli", np.random.default_rng((616161, 0)), (240, 180),
                    "a")
    monkeypatch.setattr(hpatches, "EVAL_PATH", tmp_path / "out")
    preds = {}
    for name in ("loftr_stage0b", "loftr_stage0b_refine"):
        summaries = hpatches.main(["--conf", name, "--device", "cpu", "--tag", name,
                                   f"data.data_dir={tmp_path / 'set'}",
                                   "data.preprocessing.resize=128", "eval.ransac_th=2.0"])
        assert summaries["mnum_matches"] > 20
        with np.load(tmp_path / "out" / "hpatches" / name / "predictions.npz") as f:
            preds[name] = {k: f[k] for k in f.files}
    bare, refined = preds["loftr_stage0b"], preds["loftr_stage0b_refine"]
    np.testing.assert_array_equal(bare["keypoint_valid0"], refined["keypoint_valid0"])
    np.testing.assert_array_equal(bare["keypoints0"], refined["keypoints0"])
    v = bare["keypoint_valid0"]
    moved = np.abs(bare["keypoints1"] - refined["keypoints1"]).max(-1)[v]
    assert (moved > 0.01).mean() > 0.2


@pytest.mark.parametrize("recipe", ["loftr_ondevice_conf", "loftr_finetune_fine_conf",
                                    "loftr_homography_conf"])
def test_each_training_recipe_takes_a_step(recipe, tmp_path):
    """Each recipe through ``train.training`` for one step on the CPU at 64
    pixels: the engine's or the host dataset's batches, ``clip_grad``, the exp
    schedule, and stage 0's blob loaded whole for the fine-tuning."""
    from gluefactory_torch import recipes
    from gluefactory_torch.core.config import merge
    from gluefactory_torch.train import training

    conf = merge(getattr(recipes, recipe)(), {
        "data": {"image_size": 64, "train_batch_size": 2, "pool_size": 2, "val_pool_size": 1,
                 "source_size": [96, 96], "num_workers": 1, "train_size": 4, "val_size": 2}})
    trainer, history = training(conf, tmp_path / "run", device="cpu", steps=1)
    assert len(history) == 1 and not history[0]["skipped"]
    assert np.isfinite(history[0]["loss/total"]) and history[0]["grad_norm"] > 0
    if recipe == "loftr_finetune_fine_conf":
        assert trainer.conf["model"]["loss"]["fine_weight"] == 2.0


if __name__ == "__main__":
    import argparse
    import json
    import sys
    from pathlib import Path

    parser = argparse.ArgumentParser(
        description="chip_smoke.py phase 22's reference numbers: the JAX package's summaries "
                    "(or the port's on the CPU) of its LoFTR runs on phase 8's sets rendered "
                    "under --root/hpatches (--render renders them), one JSON line a (run, "
                    "RANSAC seed)")
    parser.add_argument("--root", type=Path, required=True)
    parser.add_argument("--out", type=Path, required=True)
    parser.add_argument("--render", action="store_true")
    parser.add_argument("--side", choices=("jax", "port"), default="jax")
    parser.add_argument("--runs", nargs="*")
    parser.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    args = parser.parse_args()
    import chip_smoke

    sys.modules.setdefault("chip_smoke", chip_smoke)
    import chip_smoke_loftr as CL
    import test_torch_lines_eval as LE

    if args.render:
        chip_smoke.render_sets(args.root / "hpatches")
    if args.side == "jax":
        jax.config.update("jax_platforms", "cpu")
    for run, family in CL.LOFTR_RUNS:
        if not args.runs or run in args.runs:
            conf = CL.run_conf(args.root, run, family)
            for row in LE.reference(args.side, run, "hpatches", conf, args.out, args.seeds):
                print(json.dumps(row), flush=True)
