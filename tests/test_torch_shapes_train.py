"""The synthetic-shapes data and the line models' training in the port
against the JAX package on the CPU: ``draw_scene`` (numpy drawing against
cv2's), ``exact_df_af``, the host dataset's items, both on-device engines'
batches on JAX's draws (both scene families), SOLD2's loss (one view and a
pair, an 8x8 cell that two endpoints share) and JPLDD's loss (heatmap BCE
and focal, DF, AF, the two-view InfoNCE, distillation) with their gradients
against ``jax.grad``, the phase-B freeze of ``jpldd_desc_stage*.yaml``, the
seven JPLDD and SOLD2 training recipes against their YAMLs, and a few
trainer steps of each recipe cut to a tiny size.

Bounds: images within IMAGE_TOL and the warped geometry within GEOM_TOL px
(the homographies of the same draws differ in the last bits), so the
batch's heatmap and distance field, whose slopes are at most 1 a pixel, are
held within GEOM_TOL; on JAX's own warped geometry the port's heatmap,
distance and angle fields are within FIELD_TOL (a tie between segments
goes to the first in both); losses within LOSS_RTOL relative, each
gradient within GRAD_RTOL of its tensor's largest."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from gluefactory_torch import recipes as R
from gluefactory_torch.datasets import get_dataset
from gluefactory_torch.datasets import synthetic_shapes as S
from gluefactory_torch.datasets import synthetic_shapes_ondevice as E
from gluefactory_torch.datasets.homographies_ondevice import upload_pool
from gluefactory_torch.eval.io import CONFIGS_DIR
from gluefactory_torch.models import build_model
from gluefactory_torch.train import lr_scales
from gluefactory_torch.utils.weights import _flax_path, flax_key, load_state_strict, params_from_flat
from gluefactory_tpu.core.config import Config
from gluefactory_tpu.datasets import synthetic_shapes as JS
from gluefactory_tpu.datasets import synthetic_shapes_ondevice as JE
from gluefactory_tpu.models import build_model as jax_build_model
from gluefactory_tpu.utils.experiments import state_to_flat_dict

torch.set_num_threads(2)

IMAGE_TOL = 2e-3
FIELD_TOL = 1e-5
GEOM_TOL = 2e-3
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(t, j, atol, err_msg="", rtol=0.0):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=atol, rtol=rtol,
                               err_msg=err_msg)


# --- the shapes pool -----------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_draw_scene_is_jaxs(seed):
    """Same draws: the segments and vertices equal, under 2% of the pixels
    apart, and those on shapes' edges (within 3 px of a segment: the polygons are
    filled at truncated vertices, the lines 2 px wide)."""
    img, segs, verts = S.draw_scene(np.random.default_rng((0, seed)), 160, 32)
    jimg, jsegs, jverts = JS.draw_scene(np.random.default_rng((0, seed)), 160, 32)
    np.testing.assert_array_equal(segs, jsegs)
    np.testing.assert_array_equal(verts, jverts)
    assert img.dtype == jimg.dtype == np.float32 and img.shape == jimg.shape == (160, 160, 3)
    apart = np.abs(img - jimg).max(-1) > 1e-6
    assert apart.mean() < 0.02, apart.mean()
    df, _ = JS.exact_df_af(jsegs.astype(np.float32), 160)
    assert (df[apart] <= 3.0).all(), df[apart].max()


def test_exact_df_af_is_jaxs():
    _, segs, _ = JS.draw_scene(np.random.default_rng(5), 96, 32)
    for ours, ref in zip(S.exact_df_af(segs, 96), JS.exact_df_af(segs, 96)):
        np.testing.assert_allclose(ours, ref, atol=1e-6, rtol=0)


def test_host_dataset_items_are_jaxs():
    """Validation items (no photometric draw): the heatmap (the blurred
    vertices), fields and segments of JAX's item."""
    conf = {"image_size": 96, "max_segments": 16}
    ours = get_dataset("synthetic_shapes")(conf).get_dataset("val")
    ref = JS.SyntheticShapesDataset(conf).get_dataset("val")
    assert len(ours) == len(ref) == 200
    for idx in (0, 3):
        a, b = ours[idx], ref[idx]
        assert a.keys() == b.keys()
        for key in ("gt_heatmap", "gt_distance_field", "gt_angle_field", "gt_segments",
                    "image_size"):
            np.testing.assert_allclose(a[key], b[key], atol=FIELD_TOL, rtol=0, err_msg=key)
        np.testing.assert_array_equal(a["gt_segment_valid"], b["gt_segment_valid"])
        assert (np.abs(a["image"] - b["image"]).max(-1) > 1e-6).mean() < 0.02
    train = get_dataset("synthetic_shapes")({**conf, "photometric": {"p": 1.0}}).get_dataset("train")
    item = train.getitem(1, np.random.default_rng(0))
    assert item["image"].shape == (96, 96, 3) and 0 <= item["image"].min() <= item["image"].max() <= 1


# --- the on-device engines on JAX's draws --------------------------------------------

ENGINE = {"pool_size": 3, "val_pool_size": 2, "source_size": [128, 128], "image_size": 64,
          "max_segments": 24, "max_vertices": 32, "train_batch_size": 3, "seed": 2}


def _jax_homography_draws(key, b):
    kp, ks, ka, kt = jax.random.split(key, 4)
    return {"pert": jax.random.uniform(kp, (b, 4, 2)), "shrink": jax.random.uniform(ks, (b, 4, 1)),
            "angle": jax.random.uniform(ka, (b,)), "trans": jax.random.uniform(kt, (b, 2))}


def _jax_photometric_draws(key, shape):
    b = shape[0]
    keys = jax.random.split(key, 7)
    u = jax.random.uniform
    draws = {}
    for i, (name, vshape) in enumerate([("contrast", (b, 1, 1, 1)), ("bright", (b, 1, 1, 1)),
                                        ("gamma", (b, 1, 1, 1)), ("shade", (b, 4, 4, 1)),
                                        ("blur", (b,))]):
        k_apply, k_val = jax.random.split(keys[i])
        draws[f"apply_{name}"], draws[name] = u(k_apply, (b,)), u(k_val, vshape)
    k_apply, k_amp, k_noise = jax.random.split(keys[5], 3)
    draws.update(apply_noise=u(k_apply, (b,)), noise_amp=u(k_amp, (b, 1, 1, 1)),
                 noise=jax.random.normal(k_noise, shape))
    return draws


def _to_torch(tree):
    return jax.tree.map(_t, tree)


def _check_view(ours: dict, ref: dict, suffix: str, segs_key: str, valid_key: str,
                sigma: float = 1.0, clip: float = 16.0):
    _close(ours["image"], ref["image"], IMAGE_TOL, "image")
    for key in (segs_key, "gt_keypoints" + suffix):  # points warped far out: relative
        _close(ours[key], ref[key], GEOM_TOL, key, rtol=1e-4)
    for key in ("gt_heatmap" + suffix, "gt_distance_field" + suffix):
        _close(ours[key], ref[key], GEOM_TOL, key)
    for key in (valid_key, "gt_keypoint_valid" + suffix):
        np.testing.assert_array_equal(ours[key].numpy(), np.asarray(ref[key]), err_msg=key)
    # the fields of JAX's own warped geometry
    segs, valid = np.asarray(ref[segs_key]), np.asarray(ref[valid_key])
    s = ours["gt_angle_field" + suffix].shape[-1]
    heat = E.splat_heatmap(_t(ref["gt_keypoints" + suffix]), _t(ref["gt_keypoint_valid" + suffix]),
                           s, sigma)
    _close(heat, ref["gt_heatmap" + suffix], FIELD_TOL, "heatmap")
    df, af = E.df_af_from_segments(_t(segs), _t(valid), s, clip)
    _close(df, ref["gt_distance_field" + suffix], FIELD_TOL, "distance field")
    _close(af, ref["gt_angle_field" + suffix], FIELD_TOL, "angle field")
    assert 0 <= af.min() and af.max() < np.pi


@pytest.mark.parametrize("family", ["shapes", "structured"])
def test_engine_batch_is_jaxs(family):
    conf = {**ENGINE, "scene_family": family}
    jengine = JE.OnDeviceSyntheticShapesDataset(conf)
    pool = jengine.build_pool("train")
    engine = E.OnDeviceSyntheticShapesDataset(conf)
    ours_pool = engine.build_pool("train")
    for key in ("segments", "segment_valid", "vertices", "vertex_valid"):
        np.testing.assert_array_equal(ours_pool[key], pool[key], err_msg=key)
    assert (ours_pool["images"] != pool["images"]).any(-1).mean() < 0.02
    key = jax.random.key(4)
    jbatch = jengine.make_batch(jax.tree.map(jnp.asarray, pool), key)
    k_idx, k_h, k_p = jax.random.split(key, 3)
    draws = {"idx": jax.random.randint(k_idx, (3,), 0, 3), "h": _jax_homography_draws(k_h, 3),
             "p": _jax_photometric_draws(k_p, (3, 64, 64, 3))}
    batch = engine.make_batch_from_draws(upload_pool(pool, "cpu"), _to_torch(draws))
    assert batch.keys() == jbatch.keys()
    _check_view(batch, jbatch, "", "gt_segments", "gt_segment_valid")
    assert int(batch["gt_keypoint_valid"].sum()) > 3


def test_pairs_engine_batch_is_jaxs():
    conf = {**ENGINE, "scene_family": "structured", "right_only": True}
    jengine = JE.OnDeviceSyntheticShapesPairsDataset(conf)
    pool = jengine.build_pool("train")
    key = jax.random.key(8)
    jbatch = jengine.make_batch(jax.tree.map(jnp.asarray, pool), key)
    k_idx, k_h0, k_h1, k_p0, k_p1 = jax.random.split(key, 5)
    shape = (3, 64, 64, 3)
    draws = {"idx": jax.random.randint(k_idx, (3,), 0, 3),
             "h0": _jax_homography_draws(k_h0, 3), "h1": _jax_homography_draws(k_h1, 3),
             "p0": _jax_photometric_draws(k_p0, shape), "p1": _jax_photometric_draws(k_p1, shape)}
    engine = get_dataset("synthetic_shapes_ondevice_pairs")(conf)
    batch = engine.make_batch_from_draws(upload_pool(pool, "cpu"), _to_torch(draws))
    assert batch.keys() == jbatch.keys()
    scale = np.abs(np.asarray(jbatch["H_0to1"])).max(axis=(1, 2), keepdims=True)
    _close(batch["H_0to1"] / _t(scale), np.asarray(jbatch["H_0to1"]) / scale, 1e-4)
    for i in "01":
        view = {**batch, **batch[f"view{i}"]}
        ref = {**jbatch, **jbatch[f"view{i}"]}
        _check_view(view, ref, i, f"lines{i}", f"valid_lines{i}")


# --- the losses against jax.grad -------------------------------------------------------

def _flat(tree):
    return {k: np.asarray(v) for k, v in state_to_flat_dict(tree).items()}


def _jax_losses_and_grads(name, conf, batch, key=0, x64=False):
    """JAX's model ``name`` initialised on ``batch``: (params, mean loss terms,
    gradients of the mean total as the port's state_dict); ``x64``: the
    losses and gradients in float64 from the float32 parameters."""
    jmodel = jax_build_model(name, conf)
    params = jax.jit(jmodel.init)(jax.random.key(key), batch)

    def loss_fn(p, data):
        losses, _ = jmodel.apply(p, jmodel.apply(p, data), data, method=jmodel.loss)
        losses = {k: jnp.mean(v) for k, v in losses.items()}
        return losses["total"], losses

    def run(p, data):
        (_, losses), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(p, data)
        return {k: float(v) for k, v in losses.items()}, params_from_flat(_flat(grads))

    if not x64:
        return params, *run(params, batch)
    def wide(x):
        x = np.asarray(x)
        return jnp.asarray(x, jnp.float64) if x.dtype == np.float32 else jnp.asarray(x)

    with jax.enable_x64(True):
        losses, grads = run(jax.tree.map(wide, params), jax.tree.map(wide, batch))
    return params, losses, {k: v.float() for k, v in grads.items()}


def _port_losses_and_grads(name, conf, params, batch):
    model = build_model(name, conf, device="cpu", train=True)
    load_state_strict(model, params_from_flat(_flat(params)))
    data = jax.tree.map(_t, batch)
    losses, _ = model.loss(model(data), data)
    losses = {k: v.mean() for k, v in losses.items()}
    losses["total"].backward()
    return ({k: float(v.detach()) for k, v in losses.items()},
            {n: p.grad for n, p in model.named_parameters() if p.grad is not None})


def _check_losses_and_grads(losses, grads, jlosses, jgrads):
    """Every loss term, and every gradient (a parameter that the loss does
    not reach has none in the port and zeros in JAX)."""
    assert losses.keys() == jlosses.keys()
    for key, value in losses.items():
        assert abs(value - jlosses[key]) <= LOSS_RTOL * abs(jlosses[key]), (key, value, jlosses[key])
    assert grads.keys() <= jgrads.keys()
    for name in jgrads.keys() - grads.keys():
        assert not jgrads[name].any(), name
    for name, g in grads.items():
        jg = jgrads[name].numpy()
        scale = max(np.abs(jg).max(), 1e-12)
        np.testing.assert_allclose(g.numpy() / scale, jg / scale, atol=GRAD_RTOL, rtol=0,
                                   err_msg=name)


def _collision_segments():
    """Segments (2, 6, 2, 2) on a 64x64 view whose endpoints share 8x8 cells
    at distinct in-cell positions (the later endpoint's index is the target),
    plus an invalid segment whose endpoint lies in a used cell."""
    segs = np.array([[[3.2, 3.6], [40.0, 41.0]], [[5.0, 6.0], [60.4, 20.0]],
                     [[41.6, 46.0], [7.0, 1.0]], [[60.0, 22.0], [12.0, 50.0]],
                     [[13.0, 52.0], [30.0, 30.0]], [[2.0, 2.0], [62.0, 62.0]]], np.float32)
    valid = np.array([True, True, True, True, True, False])
    return np.stack([segs, segs[::-1] + 0.3]), np.stack([valid, valid[::-1]])


def test_sold2_single_view_loss_with_cell_collisions_is_jaxs():
    segs, valid = _collision_segments()
    g = 8
    ends = np.round(segs.reshape(2, -1, 2)).astype(int)
    cells = [(e[:, 1] // g) * 8 + e[:, 0] // g for e in ends]
    inner = [(e[:, 1] % g) * g + e[:, 0] % g for e in ends]
    for c, i, v in zip(cells, inner, np.repeat(valid, 2, axis=1)):
        shared = [k for k in set(c[v]) if len(set(i[v][c[v] == k])) > 1]
        assert len(shared) >= 2  # cells that two valid endpoints write differently
    image = np.random.default_rng(0).uniform(size=(2, 64, 64, 1)).astype(np.float32)
    batch = {"image": image, "gt_segments": segs, "gt_segment_valid": valid}
    conf = {"sparse_outputs": False, "loss": {"pos_weight": 100.0}}
    params, jlosses, jgrads = _jax_losses_and_grads("lines.sold2", conf, batch)
    losses, grads = _port_losses_and_grads("lines.sold2", conf, params, batch)
    _check_losses_and_grads(losses, grads, jlosses, jgrads)


def test_sold2_pairs_loss_is_jaxs():
    """``sold2_train_pairs``'s model (two views, the descriptor InfoNCE) on the
    pairs engine's JAX batch."""
    data_conf = {**R.sold2_train_pairs_conf()["data"], **ENGINE, "train_batch_size": 2}
    jengine = JE.OnDeviceSyntheticShapesPairsDataset(data_conf)
    pool = jax.tree.map(jnp.asarray, jengine.build_pool("train"))
    batch = jax.jit(jengine.make_batch)(pool, jax.random.key(1))
    conf = R.sold2_train_pairs_conf()["model"]
    params, jlosses, jgrads = _jax_losses_and_grads("two_view_pipeline", conf, batch)
    losses, grads = _port_losses_and_grads("two_view_pipeline", conf, params, batch)
    assert {"junction_ce0", "heatmap_bce1", "desc_nll", "total"} <= set(losses)
    _check_losses_and_grads(losses, grads, jlosses, jgrads)


@pytest.mark.parametrize("heatmap", ["weighted_bce", "focal"])
def test_jpldd_single_view_loss_is_jaxs(heatmap):
    """JPLDD at full width (64 keypoints) on the shapes engine's JAX batch:
    heatmap, DF, AF and distillation terms and every gradient."""
    jengine = JE.OnDeviceSyntheticShapesDataset({**ENGINE, "train_batch_size": 2})
    pool = jax.tree.map(jnp.asarray, jengine.build_pool("train"))
    batch = dict(jax.jit(jengine.make_batch)(pool, jax.random.key(2)))
    ref = np.random.default_rng(3).normal(size=(2, 64, 128)).astype(np.float32)
    batch["ref_descriptors"] = ref / np.linalg.norm(ref, axis=-1, keepdims=True)
    conf = {"max_num_keypoints": 64, "detection_threshold": 0.0,
            "loss": {"heatmap": heatmap, "pos_weight": 100.0}}
    name = "extractors.joint_point_line_extractor"
    params, jlosses, jgrads = _jax_losses_and_grads(name, conf, batch)
    losses, grads = _port_losses_and_grads(name, conf, params, batch)
    assert set(losses) == {"heatmap", "df", "af", "desc_distill", "total"}
    _check_losses_and_grads(losses, grads, jlosses, jgrads)


# --- the recipes and the phase-B freeze ------------------------------------------------

RECIPES = {
    "jpldd_ondevice": lambda: R.jpldd_ondevice_conf(),
    "jpldd_ondevice_structured": lambda: R.jpldd_ondevice_conf(structured=True),
    "jpldd_desc_stage": lambda: R.jpldd_desc_stage_conf(),
    "jpldd_desc_stage_structured": lambda: R.jpldd_desc_stage_conf(structured=True),
    "jpldd_train_synthetic": R.jpldd_train_synthetic_conf,
    "jpldd_eval": R.jpldd_eval_conf,
    "sold2_train_pairs": R.sold2_train_pairs_conf,
}


@pytest.mark.parametrize("name", sorted(RECIPES))
def test_recipe_is_its_yaml(name):
    """Each recipe is its YAML, but for ``jpldd_desc_stage``'s uncommitted
    run ``jpldd_tpu_stage0``, which the recipe reads from that run's blob."""
    conf = yaml.safe_load((CONFIGS_DIR / f"{name}.yaml").read_text())
    if name == "jpldd_desc_stage":
        assert conf["train"]["load_experiment"] == "jpldd_tpu_stage0"
        conf["train"]["load_experiment"] = R.JPLDD_WEIGHTS["stage0"]
    assert RECIPES[name]() == conf


def test_phase_b_freezes_jaxs_parameters():
    """``lr_scaling`` of ``jpldd_desc_stage*.yaml`` matches, in the port's flax
    paths, exactly the parameters it matches in JAX's tree: everything but
    ``desc_head``."""
    conf = R.jpldd_desc_stage_conf(structured=True)
    model = build_model("two_view_pipeline", conf["model"], device="cpu")
    names = [n for n, _ in model.named_parameters()]
    scales, used = lr_scales(names, conf["train"]["lr_scaling"])
    assert used == 1
    frozen = {n for n, s in zip(names, scales) if s == 0.0}
    assert frozen == {n for n in names if not n.startswith("extractor.desc_head.")}
    jmodel = jax_build_model("two_view_pipeline", Config(conf["model"]))
    view = {"image": jnp.zeros((1, 32, 32, 1)), "image_size": jnp.full((1, 2), 32.0)}
    params = jax.jit(jmodel.init)(jax.random.key(0), {"view0": view, "view1": view})
    patterns = conf["train"]["lr_scaling"][0][1]
    jax_paths = {"/".join(_flax_path(k)) for k in state_to_flat_dict(params)}
    jax_frozen = {p for p in jax_paths if any(pattern in p for pattern in patterns)}
    assert jax_frozen == {"/".join(_flax_path(flax_key(n))) for n in frozen}
    assert len(jax_paths - jax_frozen) == 5  # desc_head: agg, offset, offset_hidden


def test_jpldd_two_view_descriptor_loss_is_jaxs():
    """Phase B's model (grey views tiled to 3 channels, 64 keypoints) on the
    homography engine's JAX batch: the InfoNCE over mutual detections within
    3 px under ``H_0to1`` and every gradient, against JAX in float64: JAX's
    float32 gradient of the first block parts from its own float64 one by
    1.2e-3 of its largest (XLA's CPU convolution), the port's by 2e-6."""
    from gluefactory_tpu.datasets.homographies_ondevice import OnDeviceHomographyDataset

    jengine = OnDeviceHomographyDataset({"pool_size": 3, "source_size": [96, 96],
                                         "image_size": 64, "train_batch_size": 2})
    pool = jax.tree.map(jnp.asarray, jengine.build_pool("train"))
    batch = jax.jit(jengine.make_batch)(pool, jax.random.key(5))
    conf = R.jpldd_desc_stage_conf()["model"]
    conf["extractor"]["max_num_keypoints"] = 64
    params, jlosses, jgrads = _jax_losses_and_grads("two_view_pipeline", conf, batch, x64=True)
    losses, grads = _port_losses_and_grads("two_view_pipeline", conf, params, batch)
    assert set(losses) == {"desc_nll", "total"} and losses["total"] > 0
    _check_losses_and_grads(losses, grads, jlosses, jgrads)
