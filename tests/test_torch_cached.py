"""The cached-feature engine (``homographies_ondevice_cached``), the
engine's ``data_dir`` pool and the overfit loaders of the port against the
JAX package, on the CPU at small sizes.

The port extracts the pool from the JAX engine's own source images (the two
packages draw their procedural scenes with different rasterisers); the
batch is compared on JAX's random numbers fed to ``make_batch_from_draws``,
as the image engine's is (tests/test_torch_train.py)."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gluefactory_tpu.datasets import homographies_ondevice as jengine
from gluefactory_tpu.models import build_model as jax_build_model
from gluefactory_tpu.utils.experiments import state_to_flat_dict
from gluefactory_torch import settings
from gluefactory_torch.core.config import collect_defaults
from gluefactory_torch.datasets import get_dataset
from gluefactory_torch.datasets import homographies_ondevice as tengine
from gluefactory_torch.datasets.homographies import generate_structured_image
from gluefactory_torch.models import build_model
from gluefactory_torch.recipes import stage4_conf
from gluefactory_torch.utils.image import write_image
from gluefactory_torch.utils.weights import load_state_strict, params_from_flat

torch.set_num_threads(2)

CACHED = {"pool_size": 4, "val_pool_size": 2, "source_size": [128, 96], "image_size": 96,
          "train_batch_size": 2, "val_batch_size": 2, "seed": 3,
          "features_from": {"experiment": "weights/sp_tpu_stage0b.f16.msgpack",
                            "max_num_keypoints": 64, "refinement_radius": 2,
                            "refinement_mode": "com", "batch": 2},
          "desc_noise": 0.02, "desc_dropout": 0.3, "kp_noise": 0.5,
          "homography": {"difficulty": 0.8, "translation": 0.35, "max_angle": 60.0}}


@pytest.fixture(scope="module")
def jax_pool(tmp_path_factory):
    """The JAX engine's source images and the feature pool it extracts from
    them, with its cache file (written under a temporary DATA_PATH)."""
    import gluefactory_tpu.settings as jsettings

    data = tmp_path_factory.mktemp("jax_data")
    original = jsettings.DATA_PATH
    jsettings.DATA_PATH = data
    try:
        dataset = jengine.OnDeviceCachedFeatureDataset(CACHED)
        base = jengine.OnDeviceHomographyDataset.build_pool(dataset, "train")
        dataset._pools.clear()
        pool = dataset.build_pool("train")
        path = dataset._pool_cache_path("train")
    finally:
        jsettings.DATA_PATH = original
    return base, pool, path


def test_cached_pool_matches_jax(jax_pool, tmp_path, monkeypatch):
    """Extracted from the same images by the stage-0b SuperPoint with the CoM
    readout: keypoints within 1e-4 px (the CoM sums in another order),
    descriptors within 1 float16 ulp, scores and validity alike."""
    base, jpool, _ = jax_pool
    monkeypatch.setattr(settings, "DATA_PATH", tmp_path)
    monkeypatch.setattr(tengine.OnDeviceHomographyDataset, "build_pool",
                        lambda self, split="train", device="cpu": base)
    pool = tengine.OnDeviceCachedFeatureDataset({**CACHED, "pool_cache": False}).build_pool(
        "train", "cpu")
    assert pool.keys() == jpool.keys()
    assert pool["descriptors"].dtype == np.float16 and pool["descriptors"].shape == (4, 64, 256)
    np.testing.assert_array_equal(pool["keypoint_valid"], jpool["keypoint_valid"])
    assert pool["keypoint_valid"].sum() > 100
    np.testing.assert_allclose(pool["keypoints"], jpool["keypoints"], atol=1e-4)
    np.testing.assert_allclose(pool["keypoint_scores"], jpool["keypoint_scores"], atol=1e-5)
    # 1 float16 ulp, or 2e-7 near zero, where float16's spacing (down to 6e-8
    # in its subnormals) is finer than the float32 descriptors' own error
    ulps = np.abs(pool["descriptors"].view(np.int16).astype(int)
                  - jpool["descriptors"].view(np.int16).astype(int))
    error = np.abs(pool["descriptors"].astype(np.float32) - jpool["descriptors"])
    assert ((ulps <= 1) | (error <= 2e-7)).all(), (ulps.max(), error[ulps > 1].max())
    np.testing.assert_array_equal(pool["source_size"], [128, 96])
    assert not list(tmp_path.iterdir())  # pool_cache: False writes nothing


def test_the_port_reads_the_jax_pool_cache(jax_pool, tmp_path, monkeypatch):
    """One conf names one file in both packages; the port reads the JAX
    package's file without extracting, and writes its own atomically."""
    _, jpool, jpath = jax_pool
    monkeypatch.setattr(settings, "DATA_PATH", tmp_path)
    dataset = tengine.OnDeviceCachedFeatureDataset(CACHED)
    path = dataset.pool_cache_path("train")
    assert path.name == jpath.name and path.parent == tmp_path / "engine_pool_cache"
    assert dataset.pool_cache_path("val").name != path.name
    path.write_bytes(jpath.read_bytes())
    monkeypatch.setattr(tengine.OnDeviceCachedFeatureDataset, "extract_pool", None)
    pool = dataset.build_pool("train", "cpu")
    for key, value in jpool.items():
        np.testing.assert_array_equal(pool[key], value)
    assert dataset.build_pool("train", "cpu") is pool


def _jax_homography_draws(key, b):
    kp, ks, ka, kt = jax.random.split(key, 4)
    return {"pert": jax.random.uniform(kp, (b, 4, 2)), "shrink": jax.random.uniform(ks, (b, 4, 1)),
            "angle": jax.random.uniform(ka, (b,)), "trans": jax.random.uniform(kt, (b, 2))}


def _synthetic_pool(m=5, k=64, d=256, seed=0):
    rng = np.random.default_rng(seed)
    desc = rng.normal(size=(m, k, d)).astype(np.float32)
    return {"keypoints": (rng.uniform(0, 96, (m, k, 2)) * [128 / 96, 1]).astype(np.float32),
            "descriptors": (desc / np.linalg.norm(desc, axis=-1, keepdims=True)).astype(
                np.float16),
            "keypoint_scores": rng.uniform(size=(m, k)).astype(np.float32),
            "keypoint_valid": rng.uniform(size=(m, k)) > 0.1,
            "source_size": np.asarray([128, 96], np.float32)}


def _jax_batch_and_draws(conf, pool, key):
    """JAX's batch and the numbers it drew, in the port's layout."""
    jdataset = jengine.OnDeviceCachedFeatureDataset(conf)
    jpool = {k: jnp.asarray(v) for k, v in pool.items()}
    jbatch = jdataset.make_batch(jpool, key)
    keys = jax.random.split(key, 9)
    b, (m, k, d) = int(conf["train_batch_size"]), pool["descriptors"].shape
    # a bernoulli draw is a uniform below p
    assert bool((jax.random.bernoulli(keys[5], 0.3, (b, k))
                 == (jax.random.uniform(keys[5], (b, k)) < 0.3)).all())
    draws = {"idx": jax.random.randint(keys[0], (b,), 0, m),
             "h0": _jax_homography_draws(keys[1], b), "h1": _jax_homography_draws(keys[2], b),
             "n0": jax.random.normal(keys[3], (b, k, d)),
             "n1": jax.random.normal(keys[4], (b, k, d)),
             "d0": jax.random.uniform(keys[5], (b, k)), "d1": jax.random.uniform(keys[6], (b, k)),
             "j0": jax.random.normal(keys[7], (b, k, 2)),
             "j1": jax.random.normal(keys[8], (b, k, 2))}
    return jbatch, jax.tree.map(lambda x: torch.from_numpy(np.array(x)), draws)


def test_make_batch_from_draws_matches_jax():
    """JAX's draws through the port: keypoints within 2e-3 px (the homography
    solve in float32, as the image engine's), descriptors within 1e-5,
    validity equal."""
    pool = _synthetic_pool()
    jbatch, draws = _jax_batch_and_draws(CACHED, pool, jax.random.key(7))
    tpool = tengine.upload_pool(pool, "cpu")
    batch = tengine.OnDeviceCachedFeatureDataset(CACHED).make_batch_from_draws(tpool, draws)
    for view in ("view0", "view1"):
        ours, theirs = batch[view]["cache"], jbatch[view]["cache"]
        np.testing.assert_allclose(ours["keypoints"].numpy(), theirs["keypoints"], atol=2e-3)
        np.testing.assert_allclose(ours["descriptors"].numpy(), theirs["descriptors"], atol=1e-5)
        np.testing.assert_array_equal(ours["keypoint_scores"].numpy(), theirs["keypoint_scores"])
        np.testing.assert_array_equal(ours["keypoint_valid"].numpy(), theirs["keypoint_valid"])
        np.testing.assert_array_equal(batch[view]["image_size"].numpy(), jbatch[view]["image_size"])
        valid = ours["keypoint_valid"].numpy()
        assert 0.05 < valid.mean() < 0.9  # some kept, some dropped or outside
    scale = np.abs(np.asarray(jbatch["H_0to1"])).max(axis=(1, 2), keepdims=True)
    np.testing.assert_allclose(batch["H_0to1"].numpy() / scale,
                               np.asarray(jbatch["H_0to1"]) / scale, atol=1e-4)
    dataset = tengine.OnDeviceCachedFeatureDataset(CACHED)
    a, b = dataset.make_batch(tpool, 5), dataset.make_batch(tpool, 5)
    assert torch.equal(a["view1"]["cache"]["descriptors"], b["view1"]["cache"]["descriptors"])


def test_stage4_step0_matches_jax():
    """The stage-4 recipe cut to 2 layers, batch 2, 64 keypoints: the
    matcher-only pipeline's loss on JAX's batch from the same parameters,
    within 1e-4 relative."""
    recipe = stage4_conf()
    conf = {**recipe["data"], **CACHED, "features_from": recipe["data"]["features_from"]}
    model_conf = {**recipe["model"], "matcher": {**recipe["model"]["matcher"], "n_layers": 2}}
    pool = _synthetic_pool(seed=1)
    jbatch, _ = _jax_batch_and_draws(conf, pool, jax.random.key(2))
    jmodel = jax_build_model("two_view_pipeline", model_conf)
    params = jax.jit(partial(jmodel.init, method=jmodel.forward_and_loss))(jax.random.key(0),
                                                                          jbatch)
    pred = jax.jit(jmodel.apply)(params, jbatch)
    jloss = float(jnp.mean(jax.jit(partial(jmodel.apply, method=jmodel.loss))(
        params, pred, jbatch)[0]["total"]))

    model = build_model("two_view_pipeline", model_conf, device="cpu", train=True)
    assert model.extractor is None
    load_state_strict(model, params_from_flat(
        {k: np.asarray(v) for k, v in state_to_flat_dict(params).items()}, {"matcher": 4}))
    batch = jax.tree.map(lambda x: torch.from_numpy(np.array(x)), jbatch)
    losses, _ = model.loss(model(batch), batch)
    loss = float(losses["total"].mean().detach())
    assert abs(loss - jloss) <= 1e-4 * abs(jloss), (loss, jloss)


@pytest.mark.parametrize("cls", ["OnDeviceHomographyDataset", "OnDeviceCachedFeatureDataset"])
def test_overfit_loaders_match_jax(cls):
    """The engines' overfit loader: one step an epoch, the seed of step 0."""
    conf = {"seed": 11, "steps_per_epoch": 7}
    ours = getattr(tengine, cls)(conf).get_overfit_loader("train")
    theirs = getattr(jengine, cls)(conf).get_overfit_loader("train")
    for epoch in (0, 3):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        assert list(ours) == [int(x["seed"]) for x in theirs] == [11]


def test_data_dir_pool_matches_jax(tmp_path):
    """A pool from a folder of port-written PPM files: the shared permutation
    (train from its head, val from its tail), the mean over RGB, INTER_AREA
    and uint8 truncation; within one uint8 level of JAX's pool, no ground
    truth."""
    rng = np.random.default_rng(4)
    for i in range(6):
        image = generate_structured_image(rng, (150 + 7 * i, 120 + 3 * i))
        write_image(tmp_path / f"im{i}.ppm", (image * 255).astype(np.uint8))
    conf = {"data_dir": str(tmp_path), "pool_size": 4, "val_pool_size": 2,
            "source_size": [96, 80], "seed": 5}
    ours, theirs = tengine.OnDeviceHomographyDataset(conf), jengine.OnDeviceHomographyDataset(conf)
    for split in ("train", "val"):
        pool, jpool = ours.build_pool(split), theirs.build_pool(split)
        assert pool["images"].shape == jpool["images"].shape
        diff = np.abs(pool["images"].astype(int) - jpool["images"].astype(int))
        assert diff.max() <= 1 and diff.mean() < 0.05, (diff.max(), diff.mean())
        assert not pool["point_valid"].any() and not jpool["point_valid"].any()
    assert get_dataset("homographies_ondevice_cached") is tengine.OnDeviceCachedFeatureDataset


@pytest.mark.parametrize("name", ["homographies_ondevice", "homographies_ondevice_cached",
                                  "homographies"])
def test_dataset_defaults_are_jax_key_for_key(name):
    """Every default of the dataset (its class's, its bases' and the base
    dataset's loader keys) at the JAX dataset's value."""
    from gluefactory_tpu.core.config import Config
    from gluefactory_tpu.datasets import get_dataset as jax_get_dataset

    jcls = jax_get_dataset(name)
    theirs: dict = {}
    for klass in reversed(jcls.__mro__):
        for attr in ("base_default_conf", "default_conf"):
            if klass.__dict__.get(attr):
                theirs = Config(theirs).merge(klass.__dict__[attr]).to_dict()
    assert collect_defaults(get_dataset(name)) == theirs
