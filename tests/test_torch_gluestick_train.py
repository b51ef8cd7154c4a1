"""GlueStick training in the port against the JAX package, on the CPU at small
size: the wireframe pool (``scripts/extract_pool_features.py``), the
cached-wireframe engine's batch on JAX's draws, GlueStick's loss and
gradients at step 0 (with and without ``checkpointed``), two Adam steps,
checkpoints both ways, the three GlueStick recipes against their YAMLs and
the config sweep's counts.

The matcher is cut to 2 layers of width 32 with ``inter_supervision: [1]``
on flax-initialised parameters that the port loads; it runs on JAX's batch.
Bounds: the loss within LOSS_RTOL relative, each gradient within GRAD_RTOL
of its tensor's largest; the batch's points and line endpoints within
BATCH_PX (the homographies of the same draws in another order of float32
operations)."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from gluefactory_torch import recipes as R
from gluefactory_torch import settings
from gluefactory_torch.datasets import get_dataset
from gluefactory_torch.datasets import homographies_ondevice as tengine
from gluefactory_torch.eval.io import CONFIGS_DIR
from gluefactory_torch.models import build_model
from gluefactory_torch.scripts import extract_pool_features as X
from gluefactory_torch.scripts.config_sweep import sweep
from gluefactory_torch.settings import ROOT_PATH
from gluefactory_torch.train import make_optimizer, train_step
from gluefactory_torch.utils import experiments as texp
from gluefactory_torch.utils.weights import load_state_strict, params_from_flat
from gluefactory_tpu import settings as jsettings
from gluefactory_tpu.core.config import Config
from gluefactory_tpu.datasets import homographies_ondevice as jengine
from gluefactory_tpu.models import build_model as jax_build_model
from gluefactory_tpu.scripts import export_weights as jax_export
from gluefactory_tpu.scripts import extract_pool_features as jax_extract
from gluefactory_tpu.train import default_train_conf as jax_train_conf
from gluefactory_tpu.train import make_optimizer as jax_make_optimizer
from gluefactory_tpu.utils import experiments as jexp

torch.set_num_threads(2)

LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
BATCH_PX = 2e-3
N_LINES, N_KPTS, DIM = 8, 24, 32
DATA = {"pool_size": 3, "val_pool_size": 2, "source_size": [128, 96], "image_size": 96,
        "train_batch_size": 2, "val_batch_size": 2, "desc_dropout": 0.2}
MATCHER = {"n_layers": 2, "input_dim": DIM, "descriptor_dim": DIM, "inter_supervision": [1]}


def _pool(seed=0, m=3):
    """A wireframe pool: 2 N_LINES junction slots (endpoints of one line in
    three shared with the next line's) then N_KPTS keypoints, descriptors
    of width DIM, random validity."""
    rng = np.random.default_rng(seed)
    n = 2 * N_LINES + N_KPTS
    ends = rng.uniform([0, 0], [128, 96], (m, N_LINES, 2, 2))
    junc = np.tile(np.arange(2 * N_LINES), (m, 1))
    junc[:, 1:-1:6] = junc[:, 2::6]  # a line's second endpoint is the next line's first
    ends.reshape(m, -1, 2)[:, 1:-1:6] = ends.reshape(m, -1, 2)[:, 2::6]
    kpts = np.concatenate([ends.reshape(m, -1, 2), rng.uniform([0, 0], [128, 96],
                                                              (m, N_KPTS, 2))], 1)
    used = np.zeros((m, n), bool)
    np.put_along_axis(used, junc, True, 1)
    desc = rng.normal(size=(m, n, DIM))
    return {"keypoints": kpts.astype(np.float32),
            "descriptors": (desc / np.linalg.norm(desc, axis=-1, keepdims=True)).astype(
                np.float16),
            "keypoint_scores": rng.uniform(size=(m, n)).astype(np.float32),
            "keypoint_valid": used | (np.arange(n) >= 2 * N_LINES) & (rng.uniform(size=(m, n))
                                                                      > 0.1),
            "lines": ends.astype(np.float32),
            "line_scores": rng.uniform(1, 8, (m, N_LINES)).astype(np.float32),
            "valid_lines": rng.uniform(size=(m, N_LINES)) > 0.1,
            "lines_junc_idx": junc.astype(np.int32),
            "n_junctions": np.full(m, 2 * N_LINES, np.int32),
            "source_size": np.asarray([128, 96], np.float32)}


def _homography_draws(key, b):
    kp, ks, ka, kt = jax.random.split(key, 4)
    return {"pert": jax.random.uniform(kp, (b, 4, 2)), "shrink": jax.random.uniform(ks, (b, 4, 1)),
            "angle": jax.random.uniform(ka, (b,)), "trans": jax.random.uniform(kt, (b, 2))}


def _to_torch(tree):
    return jax.tree.map(lambda x: torch.from_numpy(np.array(x)), tree)


def _flat(tree):
    return {k: np.asarray(v) for k, v in jexp.state_to_flat_dict(tree).items()}


@pytest.fixture(scope="module")
def jax_side():
    """JAX's batch of the recipe's engine on a wireframe pool and the draws
    it took, the cut pipeline's flax parameters and its jitted (loss terms,
    gradients)."""
    conf = R.gluestick_cached_conf()
    data_conf = {**conf["data"], **DATA}
    model_conf = {**conf["model"], "matcher": {**conf["model"]["matcher"], **MATCHER}}
    pool, key = _pool(), jax.random.key(3)
    jbatch = jax.jit(jengine.OnDeviceCachedWireframeDataset(data_conf).make_batch)(
        {k: jnp.asarray(v) for k, v in pool.items()}, key)
    keys = jax.random.split(key, 7)
    b, (m, n, d) = DATA["train_batch_size"], pool["descriptors"].shape
    draws = {"idx": jax.random.randint(keys[0], (b,), 0, m),
             "h0": _homography_draws(keys[1], b), "h1": _homography_draws(keys[2], b),
             "n0": jax.random.normal(keys[3], (b, n, d)),
             "n1": jax.random.normal(keys[4], (b, n, d)),
             "d0": jax.random.uniform(keys[5], (b, n)), "d1": jax.random.uniform(keys[6], (b, n))}
    jmodel = jax_build_model("two_view_pipeline", model_conf)
    params = jax.jit(lambda k, x: jmodel.init(k, x, method=jmodel.forward_and_loss))(
        jax.random.key(0), jbatch)

    def loss_fn(p):
        losses, _ = jmodel.apply(p, jmodel.apply(p, jbatch), jbatch, method=jmodel.loss)
        losses = {k: jnp.mean(v) for k, v in losses.items()}
        return losses["total"], losses

    value_and_grad = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    return {"data_conf": data_conf, "model_conf": model_conf, "pool": pool, "jbatch": jbatch,
            "draws": _to_torch(draws), "params": params, "value_and_grad": value_and_grad}


def _port_model(side, **matcher):
    conf = {**side["model_conf"],
            "matcher": {**side["model_conf"]["matcher"], **matcher}}
    model = build_model("two_view_pipeline", conf, device="cpu", train=True)
    load_state_strict(model, params_from_flat(_flat(side["params"])))
    return model, conf


def test_cached_wireframe_batch_is_jaxs(jax_side):
    """``make_batch_from_draws`` on JAX's draws: node positions and line
    endpoints on the canvas within BATCH_PX (off it, 1e-4 relative: the
    homography's float32 error grows with the distance), descriptors within
    1e-5, the node and line validity (crop, dropout, both junctions kept)
    equal."""
    dataset = get_dataset("homographies_ondevice_cached_wireframe")(jax_side["data_conf"])
    assert isinstance(dataset, tengine.OnDeviceCachedWireframeDataset)
    batch = dataset.make_batch_from_draws(tengine.upload_pool(jax_side["pool"], "cpu"),
                                          jax_side["draws"])
    ref = jax.tree.map(np.asarray, jax_side["jbatch"])
    np.testing.assert_allclose(batch["H_0to1"].numpy(), ref["H_0to1"], rtol=1e-4, atol=1e-4)
    for view in ("view0", "view1"):
        ours, theirs = batch[view]["cache"], ref[view]["cache"]
        assert ours.keys() == theirs.keys()
        for key in ("keypoints", "lines"):
            a, r = ours[key].numpy(), theirs[key]
            on = ((r >= 0) & (r <= DATA["image_size"] - 1)).all(-1)  # on the canvas
            np.testing.assert_allclose(a[on], r[on], atol=BATCH_PX, rtol=0, err_msg=key)
            np.testing.assert_allclose(a, r, atol=BATCH_PX, rtol=1e-4, err_msg=key)
        np.testing.assert_allclose(ours["descriptors"].numpy(), theirs["descriptors"], atol=1e-5)
        for key in ("keypoint_valid", "valid_lines", "lines_junc_idx", "line_scores",
                    "keypoint_scores"):
            np.testing.assert_array_equal(ours[key].numpy(), theirs[key], err_msg=key)
        # some lines lose a junction to the dropout or an endpoint to the crop
        assert 0 < ours["valid_lines"].sum() < (jax_side["pool"]["valid_lines"][
            np.asarray(jax_side["draws"]["idx"])]).sum()
    np.testing.assert_array_equal(batch["view0"]["image_size"].numpy(), ref["view0"]["image_size"])


def _step0(model, data):
    model.zero_grad(set_to_none=True)
    losses, _ = model.loss(model(data), data)
    losses = {k: v.mean() for k, v in losses.items()}
    losses["total"].backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}
    return {k: float(v.detach()) for k, v in losses.items()}, grads


def test_step0_loss_and_gradients_are_jaxs(jax_side):
    """On JAX's batch, with the line ground truth of the homography matcher:
    every loss term (the inter-supervision head's ``line_nll_1`` included)
    within LOSS_RTOL of JAX's and every matcher gradient within GRAD_RTOL of
    its largest (the key biases', rounding in both, within 1e-6 of the
    largest gradient); ``checkpointed`` (each layer recomputed in the backward
    pass) gives the same loss and gradients bit for bit."""
    (_, jlosses), jgrads = jax_side["value_and_grad"](jax_side["params"])
    jgrads = params_from_flat(_flat(jgrads))
    data = _to_torch(jax_side["jbatch"])
    runs = {remat: _step0(_port_model(jax_side, checkpointed=remat)[0], data)
            for remat in (False, True)}
    losses, grads = runs[False]
    assert set(losses) == {"assignment_nll", "nll_pos", "nll_neg", "line_nll", "line_nll_1",
                           "total"} == set(jlosses)
    for key, value in losses.items():
        assert abs(value - float(jlosses[key])) <= LOSS_RTOL * abs(float(jlosses[key])), key
    assert grads.keys() == {f"matcher.{k}" for k, _ in
                            _port_model(jax_side)[0].matcher.named_parameters()}
    largest = max(float(g.abs().max()) for g in jgrads.values())
    for name, g in grads.items():
        jg = jgrads[name].numpy()
        if name.endswith(".k.bias"):
            # a key bias adds one constant to a query's logits, which the
            # softmax removes: both gradients are rounding, held near zero
            assert max(np.abs(jg).max(), float(g.abs().max())) <= 1e-6 * largest, name
            continue
        scale = max(np.abs(jg).max(), 1e-12)
        np.testing.assert_allclose(g.numpy() / scale, jg / scale, atol=GRAD_RTOL, rtol=0,
                                   err_msg=name)
    assert runs[True][0] == losses
    for name, g in grads.items():
        assert torch.equal(runs[True][1][name], g), name


def test_two_adam_steps_are_jaxs(jax_side):
    """Two clipped Adam steps of the recipe's optimizer (optax on the JAX
    side): the loss of each step and every parameter after it."""
    params, value_and_grad = jax_side["params"], jax_side["value_and_grad"]
    model, conf = _port_model(jax_side)
    train_conf = {**jax_train_conf, **R.gluestick_cached_conf()["train"], "lr": 1e-3}
    tx, _ = jax_make_optimizer(Config(train_conf), params, Config(conf))
    opt_state = tx.init(params)
    optimizer = make_optimizer(train_conf, model, conf)
    data = _to_torch(jax_side["jbatch"])

    @jax.jit
    def update(grads, opt_state, params):
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, optax.global_norm(grads)

    tiny = {}  # elements whose gradient was ever at rounding level
    for step in range(2):
        (loss, _), grads = value_and_grad(params)
        for name, g in params_from_flat(_flat(grads)).items():
            rounding = name.endswith(".k.bias") or np.abs(g.numpy()) < 1e-5 * np.abs(
                g.numpy()).max()  # a key bias's gradient is rounding throughout
            tiny[name] = tiny.get(name, False) | rounding
        scalars = train_step(model, optimizer, data)
        params, opt_state, norm = update(grads, opt_state, params)
        assert scalars["skipped"] == 0.0
        assert scalars["loss/total"] == pytest.approx(float(loss), rel=LOSS_RTOL)
        assert scalars["grad_norm"] == pytest.approx(float(norm), rel=1e-4)
        for name, value in params_from_flat(_flat(params)).items():
            # Adam's first update is sign-like: an element whose gradient is
            # at rounding level may move the other way, 2 lr apart at most
            atol = 2e-6 + 2.2e-3 * tiny.get(name, False)
            diff = np.abs(model.state_dict()[name].numpy() - value.numpy())
            assert (diff <= atol).all(), (name, step, float(diff.max()))
    assert optimizer.count == 2


def test_checkpoints_cross_both_ways(jax_side, tmp_path):
    """A port checkpoint (parameters, Adam state) restores into JAX's
    templates with the same keys and values; JAX's checkpoint of the same
    state restores into the port exactly."""
    params = jax_side["params"]
    model, conf = _port_model(jax_side)
    train_conf = {**jax_train_conf, "lr": 1e-3}
    optimizer = make_optimizer(train_conf, model, conf)
    assert train_step(model, optimizer, _to_torch(jax_side["jbatch"]))["skipped"] == 0.0
    full = {"model": conf, "train": train_conf}
    texp.save_experiment(tmp_path / "port", {"params": model, "opt_state": optimizer}, full,
                         epoch=0, iteration=1)
    blob, _ = jexp.load_experiment(tmp_path / "port" / "checkpoint_0_1.ckpt")
    tx, _ = jax_make_optimizer(Config(train_conf), params, Config(conf))
    for template, flat in ((params, blob["state"]["params"]),
                           (tx.init(params), blob["state"]["opt_state"])):
        template_flat = jexp.state_to_flat_dict(template)
        assert set(flat) == set(template_flat), set(flat) ^ set(template_flat)
        restored = jexp.state_to_flat_dict(jexp.restore_from_flat_dict(template, flat))
        for key, value in restored.items():
            assert value.dtype == template_flat[key].dtype, key
            np.testing.assert_array_equal(value, flat[key], err_msg=key)
    jstate = {"params": jexp.restore_from_flat_dict(params, blob["state"]["params"]),
              "opt_state": jexp.restore_from_flat_dict(tx.init(params),
                                                       blob["state"]["opt_state"])}
    jexp.save_experiment(tmp_path / "jax", jax.tree.map(np.asarray, jstate), Config(full), 0, 1)
    again, _ = texp.load_experiment(tmp_path / "jax" / "checkpoint_0_1.ckpt")
    restored = build_model("two_view_pipeline", conf, device="cpu", train=True)
    texp.restore_from_flat_dict(restored, again["state"]["params"])
    for name, value in model.state_dict().items():
        assert torch.equal(restored.state_dict()[name], value), name
    other = make_optimizer(train_conf, restored, conf)
    texp.restore_from_flat_dict(other, again["state"]["opt_state"])
    for key, value in texp.state_to_flat_dict(optimizer).items():
        np.testing.assert_array_equal(texp.state_to_flat_dict(other)[key], value, err_msg=key)


WIREFRAME = {"point_extractor": {"name": "extractors.superpoint", "max_num_keypoints": 32,
                                 "channels": [8, 8, 16, 16, 32, 32, 32, 32], "head_channels": 32,
                                 "descriptor_dim": 32, "dense_outputs": True},
             "line_extractor": {"name": "lines.lsd", "max_num_lines": 16}}
# the recipes' wireframe at the blob's widths, and a remap of the blob that the JAX
# worker's filter (OLD a prefix of the key) matches, as the recipes' matches in the port
BLOB_WIREFRAME = {"point_extractor": {"name": "extractors.superpoint", "max_num_keypoints": 32,
                                      "detection_threshold": 0.0005, "dense_outputs": True},
                  "line_extractor": {"name": "lines.lsd", "max_num_lines": 16}}
JAX_REMAP = "['params']['extractor']=['params']['point_extractor']"


@pytest.mark.parametrize("blob", [False, True], ids=["flax_init", "blob_remapped"])
def test_wireframe_pool_is_jaxs(tmp_path, monkeypatch, blob):
    """``extract_pool_features`` of a SuperPoint + LSD wireframe on 4
    procedural images at 128x128, 2 a forward, against JAX's worker run in
    this process on the same images and parameters: a narrow SuperPoint on
    flax parameters, or the recipes' SuperPoint from the stage-0b blob (the
    port under the recipes' ``remap``, JAX under JAX_REMAP). The same keys
    (every batched output), the same validity, segments, junction indices
    and slots; positions within 1e-4 px; descriptors within one float16 ulp
    (or 5e-7 near zero, where float16's spacing is finer than the float32
    error of unit descriptors)."""
    source = tengine.OnDeviceHomographyDataset(
        {"pool_size": 4, "source_size": [128, 128], "seed": 2}).build_pool("train")
    images = source["images"]
    np.savez(tmp_path / "pool.npz", images=images)
    conf = BLOB_WIREFRAME if blob else WIREFRAME
    argv = ["extract_pool_features", "--images", str(tmp_path / "pool.npz"),
            "--out", str(tmp_path / "jax.npz"), "--extractor", "lines.wireframe",
            "--conf", __import__("json").dumps(conf), "--batch", "2"]
    if blob:
        argv += ["--weights", str(R.SP_STAGE0B_WEIGHTS), "--remap", JAX_REMAP]
    monkeypatch.setattr(sys, "argv", argv)
    jax_extract.main()
    with np.load(tmp_path / "jax.npz") as out:
        ref = {k: out[k] for k in out.files}
    if blob:
        remap = R.gluestick_cached_conf()["data"]["features_from"]["remap"]
        model = X.build_extractor("lines.wireframe", conf, "cpu",
                                  weights=R.SP_STAGE0B_WEIGHTS.name, remap=remap)
    else:  # the worker's parameters: the wireframe initialised from key 0 on one image
        jmodel = jax_build_model("lines.wireframe", conf)
        size = jnp.asarray([[128.0, 128.0]], jnp.float32)
        image = jnp.asarray(images[:1].astype(np.float32) / 255.0)
        params = jax.jit(jmodel.init)(jax.random.key(0), {"image": image, "image_size": size})
        model = build_model("lines.wireframe", conf, device="cpu")
        load_state_strict(model, params_from_flat(_flat(params)))
    pool = X.extract_pool_features(images, model.eval(), 2, "cpu")
    assert pool.keys() == ref.keys() == {"keypoints", "descriptors", "keypoint_scores",
                                         "keypoint_valid", "lines", "line_scores",
                                         "valid_lines", "lines_junc_idx", "n_junctions"}
    for key in ("keypoint_valid", "valid_lines", "lines_junc_idx", "n_junctions"):
        np.testing.assert_array_equal(pool[key], ref[key], err_msg=key)
    assert pool["valid_lines"].sum() > 20 and pool["keypoint_valid"].sum() > 100
    for key in ("keypoints", "lines"):
        np.testing.assert_allclose(pool[key], ref[key], atol=1e-4, rtol=0, err_msg=key)
    np.testing.assert_allclose(pool["line_scores"], ref["line_scores"], rtol=1e-6)
    np.testing.assert_allclose(pool["keypoint_scores"], ref["keypoint_scores"], atol=1e-6)
    assert pool["descriptors"].dtype == np.float16
    ulps = np.abs(pool["descriptors"].view(np.int16).astype(int)
                  - ref["descriptors"].view(np.int16).astype(int))
    error = np.abs(pool["descriptors"].astype(np.float32) - ref["descriptors"])
    assert ((ulps <= 1) | (error <= 5e-7)).all(), (ulps.max(), error[ulps > 1].max())


RECIPES = {"gluestick_cached_conf": "gluestick_cached",
           "gluestick_stage1_conf": "gluestick_stage1",
           "gluestick_train_homography_conf": "gluestick_train_homography"}


@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_recipe_is_its_yaml(recipe, tmp_path, monkeypatch):
    """Each recipe equals its YAML key for key (stage 1 starts from the
    committed export of the run its YAML names) and builds; the cached
    recipes' pool files are named as JAX names them where both packages load
    the same parameters, one each."""
    conf = getattr(R, recipe)()
    yaml_conf = yaml.safe_load((CONFIGS_DIR / f"{RECIPES[recipe]}.yaml").read_text())
    if recipe == "gluestick_stage1_conf":
        assert yaml_conf["train"]["load_experiment"] == "gluestick_tpu_stage0"
        assert conf["train"]["load_experiment"] == "weights/gluestick_tpu_stage0.f16.msgpack"
        assert (ROOT_PATH / conf["train"]["load_experiment"]).exists()
        yaml_conf["train"]["load_experiment"] = conf["train"]["load_experiment"]
    assert conf == yaml_conf
    model = build_model("two_view_pipeline", conf["model"], device="cpu", train=True)
    dataset = get_dataset(conf["data"]["name"])(conf["data"])
    if recipe == "gluestick_train_homography_conf":
        assert model.matcher.conf["n_layers"] == 9 and not dataset.device_engine
        return
    monkeypatch.setattr(settings, "DATA_PATH", tmp_path / "port")
    monkeypatch.setattr(jsettings, "DATA_PATH", tmp_path / "jax")
    # the recipes' remap loads the blob in the port alone (the JAX worker's filter keeps
    # none of it), so the port's pool takes a name of its own; under JAX_REMAP both
    # packages load the blob and name the pool alike
    jdataset = jengine.OnDeviceCachedWireframeDataset(conf["data"])
    fconf = {**conf["data"]["features_from"], "remap": JAX_REMAP}
    both = {**conf["data"], "features_from": fconf}
    assert X.remap_is_ports_own(conf["data"]["features_from"])
    assert not X.remap_is_ports_own(fconf)
    for split in ("train", "val"):
        assert dataset.pool_cache_path(split).name != jdataset._pool_cache_path(split).name
        assert get_dataset(both["name"])(both).pool_cache_path(split).name == \
            jengine.OnDeviceCachedWireframeDataset(both)._pool_cache_path(split).name
    other = R.gluestick_stage1_conf() if recipe == "gluestick_cached_conf" else \
        R.gluestick_cached_conf()
    assert get_dataset(other["data"]["name"])(other["data"]).pool_cache_path("train") != \
        dataset.pool_cache_path("train")
    if recipe == "gluestick_stage1_conf":
        texp.restore_components(model, conf["train"]["load_experiment"])
        flat, _, _ = jax_export.load_weight_blob(R.GLUESTICK_WEIGHTS)
        expected = params_from_flat({k: v for k, v in flat.items() if "['matcher']" in k})
        for name, value in model.state_dict().items():
            assert torch.equal(value, expected[name]), name


def test_remap_loads_the_blobs_extractor():
    """The recipes' ``remap`` rewrites the scope after ``['params']``, so the
    wireframe's SuperPoint is the blob's, key for key as JAX_REMAP rewrites
    it; the JAX worker's filter, which tests the key with ``['params']`` on,
    keeps no key of the blob under the recipes' remap."""
    flat, _, _ = jax_export.load_weight_blob(R.SP_STAGE0B_WEIGHTS)
    remap = R.gluestick_cached_conf()["data"]["features_from"]["remap"]
    old = remap.split("=")[0]
    assert not [k for k in flat if k.startswith(old)]  # JAX's filter
    ours = X.remap_keys(flat, remap)
    jold, jnew = JAX_REMAP.split("=", 1)
    assert ours.keys() == {k.replace(jold, jnew) for k in flat if k.startswith(jold)}
    assert len(ours) == len(flat) and ours == X.remap_keys(flat, JAX_REMAP)


def test_config_sweep_reads_49_0_8():
    """Every GlueStick training YAML builds, model and dataset, and so do the
    three line cards of the line benchmarks, JPLDD's six YAMLs, SOLD2's
    training config, LoFTR's four and ALIKED's four; the 8 refused name a
    model the port lacks (DISK, superpoint_open, DeepLSD, KeyNet, XFeat)."""
    groups = sweep(CONFIGS_DIR)
    assert {k: len(v) for k, v in groups.items()} == {"both": 49, "model_only": 0,
                                                       "neither": 8}
    built = {name for name, _ in groups["both"]}
    assert {f"{name}.yaml" for name in RECIPES.values()} <= built
    assert {"lsd+lbd.yaml", "elsed_lines_eval.yaml", "sold2+wunsch.yaml"} <= built
    assert {f"{name}.yaml" for name in (
        "sold2_train_pairs", "jpldd_eval", "jpldd_desc_stage", "jpldd_desc_stage_structured",
        "jpldd_ondevice", "jpldd_ondevice_structured", "jpldd_train_synthetic", "loftr",
        "loftr_ondevice", "loftr_homography", "loftr_finetune_fine", "aliked+lightglue",
        "aliked+lightglue_homography", "aliked+nn", "aliked_official_compat")} <= built
    refused = dict(groups["neither"])
    assert "'extractors.disk'" in refused["disk+nn.yaml"]
