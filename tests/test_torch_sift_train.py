"""SIFT-feature training in the port against the JAX package, on the CPU at
small sizes: the cached engine's ``on_host`` SIFT pool and its cache file,
``features_from.weights``/``remap`` and the extraction CLI, step 0 of
SIFT+LightGlue and SuperGlue (losses and every parameter's gradient against
``jax.grad`` of the JAX pipeline, on JAX's pool and draws) and the gradient
of the Sinkhorn assignment.

The port extracts the pool from the JAX engine's own source images (the two
packages draw their procedural scenes with different rasterisers). Slots are
sorted by response in both; where two keypoints tie (one location, two
orientations) JAX's unstable sort and the port's may order them either way,
so the pools are compared keypoint by keypoint: each of JAX's to the port's
at the same position with the nearest orientation, as tests/test_torch_sift.py
compares SIFT with OpenCV.

Run as a script, it prints the validation numbers of the trained SIFT
matchers: the JAX package's on its own val pools (``--side jax``), those
``chip_smoke.py`` phase 16(d) holds the port to; the port's on its own, on
the CPU (``--side port``), from which the phase's margin is set; and each
package's model on the other's val pool (``--side cross``):

    JAX_PLATFORMS=cpu PYTHONPATH=.:tests python tests/test_torch_sift_train.py \
        [--side jax|port|cross] [--seeds 0 1 2]
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gluefactory_tpu.settings as jsettings
from gluefactory_torch import recipes as R
from gluefactory_torch import settings
from gluefactory_torch.datasets import homographies_ondevice as tengine
from gluefactory_torch.models import build_model
from gluefactory_torch.ops.assignment import log_optimal_transport
from gluefactory_torch.scripts import extract_pool_features as X
from gluefactory_torch.utils.weights import load_state_strict, params_from_flat
from gluefactory_tpu.datasets import homographies_ondevice as jengine
from gluefactory_tpu.models import build_model as jax_build_model
from gluefactory_tpu.ops.assignment import log_optimal_transport as jax_log_optimal_transport
from gluefactory_tpu.utils.experiments import state_to_flat_dict
from test_torch_cached import _jax_batch_and_draws

torch.set_num_threads(2)

# tests/test_cached_features.py:66's engine, a SIFT pool extracted on_host
SIFT_POOL = {"pool_size": 6, "val_pool_size": 4, "source_size": [160, 160],
             "image_size": 128, "max_gt_points": 64, "train_batch_size": 4,
             "val_batch_size": 4,
             "features_from": {"name": "extractors.sift", "max_num_keypoints": 64,
                               "contrast_threshold": 0.01, "batch": 4, "on_host": True}}
POOL_KEYS = {"keypoints", "descriptors", "keypoint_scores", "keypoint_valid", "scales", "oris",
             "source_size"}
SLOT_SHARE = 1e-3  # slots whose validity may differ
KP_PX = 1e-3  # every keypoint of JAX's, against the port's
KP_EXACT = 0.95  # of the keypoints at OpenCV's float32 position bit for bit (measured 0.971)
ORI_DEG = 1.0  # orientations within a degree, on RECALL of the keypoints (as against cv2)
RECALL = 0.95
DESC_ULP_SHARE = 0.99  # descriptor entries within one float16 ulp (measured 0.995)
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4  # of each parameter's largest gradient


@pytest.fixture(scope="module")
def pools(tmp_path_factory):
    """(the JAX engine's source images, JAX's on_host pool and its cache
    file, the port's pool of the same images on the CPU and its cache file)."""
    data = tmp_path_factory.mktemp("jax_data")
    original = jsettings.DATA_PATH
    jsettings.DATA_PATH = data
    try:
        jdataset = jengine.OnDeviceCachedFeatureDataset(SIFT_POOL)
        base = jengine.OnDeviceHomographyDataset.build_pool(jdataset, "train")
        jdataset._pools.clear()
        jpool = jdataset.build_pool("train")
        jpath = jdataset._pool_cache_path("train")
    finally:
        jsettings.DATA_PATH = original
    ours = tmp_path_factory.mktemp("port_data")
    draw, original = tengine.OnDeviceHomographyDataset.build_pool, settings.DATA_PATH
    tengine.OnDeviceHomographyDataset.build_pool = lambda self, split="train", device="cpu": base
    settings.DATA_PATH = ours
    try:
        dataset = tengine.OnDeviceCachedFeatureDataset(SIFT_POOL)
        pool = dataset.build_pool("train", "cpu")
        path = dataset.pool_cache_path("train")
    finally:
        tengine.OnDeviceHomographyDataset.build_pool, settings.DATA_PATH = draw, original
    return base, jpool, jpath, pool, path


def test_on_host_pool_matches_jax(pools):
    """The port's SIFT pool against JAX's (OpenCV's SIFT in a CPU worker):
    the same keys and dtypes, validity, and for each of JAX's keypoints the
    port's at the same position (KP_PX, KP_EXACT) with the nearest
    orientation, its descriptor within one float16 ulp (DESC_ULP_SHARE)."""
    _, jpool, _, pool, _ = pools
    assert pool.keys() == jpool.keys() == POOL_KEYS
    for key, value in jpool.items():
        assert pool[key].dtype == value.dtype and pool[key].shape == value.shape, key
    valid, jvalid = pool["keypoint_valid"], jpool["keypoint_valid"]
    assert (valid != jvalid).mean() <= SLOT_SHARE and jvalid.sum() > 300
    exact, angle_ok, ulps = [], [], []
    for b in range(len(valid)):
        pj, pt = jpool["keypoints"][b][jvalid[b]], pool["keypoints"][b][valid[b]]
        dist = np.linalg.norm(pj[:, None] - pt[None], axis=-1)
        dang = (np.rad2deg(jpool["oris"][b][jvalid[b]][:, None]
                           - pool["oris"][b][valid[b]][None]) + 180) % 360 - 180
        j = (dist + 1e-3 * np.abs(dang)).argmin(1)
        rows = np.arange(len(j))
        assert len(set(j)) == len(j) and dist[rows, j].max() <= KP_PX, b
        exact.append(dist[rows, j] == 0)
        angle_ok.append(np.abs(dang[rows, j]) < ORI_DEG)
        np.testing.assert_allclose(pool["scales"][b][valid[b]][j], jpool["scales"][b][jvalid[b]],
                                   rtol=1e-5)
        ulps.append(np.abs(pool["descriptors"][b][valid[b]][j].view(np.int16).astype(int)
                           - jpool["descriptors"][b][jvalid[b]].view(np.int16).astype(int)))
    assert np.concatenate(exact).mean() >= KP_EXACT, np.concatenate(exact).mean()
    assert np.concatenate(angle_ok).mean() >= RECALL, np.concatenate(angle_ok).mean()
    share = np.mean(np.concatenate([u.ravel() for u in ulps]) <= 1)
    assert share >= DESC_ULP_SHARE, share
    np.testing.assert_array_equal(pool["source_size"], [160, 160])


def test_pool_cache_files_are_interchangeable(pools, tmp_path, monkeypatch):
    """One conf names one file in both packages; each package reads the
    other's file without extracting."""
    _, jpool, jpath, pool, path = pools
    assert path.name == jpath.name
    monkeypatch.setattr(settings, "DATA_PATH", tmp_path / "port")
    monkeypatch.setattr(tengine.OnDeviceCachedFeatureDataset, "extract_pool", None)
    dataset = tengine.OnDeviceCachedFeatureDataset(SIFT_POOL)
    dataset.pool_cache_path("train").write_bytes(jpath.read_bytes())
    read = dataset.build_pool("train", "cpu")
    assert read.keys() == jpool.keys()
    for key, value in jpool.items():
        np.testing.assert_array_equal(read[key], value)

    monkeypatch.setattr(jsettings, "DATA_PATH", tmp_path / "jax")
    monkeypatch.setattr(jengine.OnDeviceCachedFeatureDataset, "_build_pool_uncached", None)
    jdataset = jengine.OnDeviceCachedFeatureDataset(SIFT_POOL)
    jdataset._pool_cache_path("train").write_bytes(path.read_bytes())
    read = jdataset.build_pool("train")
    assert read.keys() == pool.keys()
    for key, value in pool.items():
        assert read[key].dtype == value.dtype and np.array_equal(read[key], value), key


@pytest.mark.parametrize("remap", [None, "['params']['extractor']=['params']"])
def test_on_host_weights_remap_and_the_cli(pools, tmp_path, monkeypatch, remap):
    """``features_from.weights`` (with ``remap``) loads the extractor of an
    on_host pool as ``experiment`` does on the engine's own path; the CLI
    writes what the engine's function returns."""
    base = {"images": pools[0]["images"][:2]}
    monkeypatch.setattr(tengine.OnDeviceHomographyDataset, "build_pool",
                        lambda self, split="train", device="cpu": base)
    features = {"name": "extractors.superpoint", "max_num_keypoints": 32, "batch": 2}
    blob = "sp_tpu_stage0b.f16.msgpack"  # under WEIGHTS_PATH
    conf = {**SIFT_POOL, "pool_cache": False}
    ours = tengine.OnDeviceCachedFeatureDataset(
        {**conf, "features_from": {**features, "on_host": True, "weights": blob,
                                   "remap": remap}}).build_pool("train", "cpu")
    ref = tengine.OnDeviceCachedFeatureDataset(
        {**conf, "features_from": {**features, "experiment": f"weights/{blob}"}}
    ).build_pool("train", "cpu")
    assert ours.keys() == ref.keys() and ref["keypoint_valid"].sum() > 20
    for key, value in ref.items():
        np.testing.assert_array_equal(ours[key], value)
    if remap:
        with pytest.raises(KeyError, match="are in none of"):  # a remap that keeps nothing
            X.build_extractor("extractors.superpoint", {}, "cpu", weights=blob,
                              remap="['params']['matcher']=['params']")
        return
    np.savez(tmp_path / "pool.npz", images=base["images"])
    X.main(["--images", str(tmp_path / "pool.npz"), "--out", str(tmp_path / "feats.npz"),
            "--extractor", "extractors.sift", "--conf", '{"max_num_keypoints": 64, '
            '"contrast_threshold": 0.01}', "--batch", "2", "--device", "cpu"])
    with np.load(tmp_path / "feats.npz") as out:
        assert set(out.files) == POOL_KEYS - {"source_size"}
        for key in out.files:
            np.testing.assert_array_equal(out[key], pools[3][key][:2])


def _carried(jmodel_conf, jbatch):
    """(JAX parameters of ``jmodel_conf``'s pipeline, its loss and gradients
    on ``jbatch``, the port's pipeline holding the same parameters)."""
    jmodel = jax_build_model("two_view_pipeline", jmodel_conf)
    params = jax.jit(partial(jmodel.init, method=jmodel.forward_and_loss))(
        jax.random.key(0), jbatch)

    def loss_fn(p):
        pred = jmodel.apply(p, jbatch)
        return jnp.mean(jmodel.apply(p, pred, jbatch, method=jmodel.loss)[0]["total"])

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    model = build_model("two_view_pipeline", jmodel_conf, device="cpu", train=True)

    def state(tree):
        return params_from_flat({k: np.asarray(v) for k, v in state_to_flat_dict(tree).items()},
                                {"matcher": 4})

    load_state_strict(model, state(params))
    return float(loss), state(grads), model


@pytest.mark.parametrize("recipe", ["sift_lg_cached_conf", "sift_sg_cached_conf"])
def test_step0_matches_jax(pools, recipe):
    """Step 0 of the recipe on JAX's SIFT pool and draws, the matcher cut to
    2 layers (SuperGlue: 64 channels, Sinkhorn 50): the loss within LOSS_RTOL
    and every parameter's gradient (SuperGlue's ``bin_score`` included)
    within GRAD_RTOL of its largest, against jax.grad."""
    conf = getattr(R, recipe)()
    cut = {"n_layers": 2, **({"descriptor_dim": 64} if "sg" in recipe else {})}
    model_conf = {**conf["model"], "matcher": {**conf["model"]["matcher"], **cut}}
    data_conf = {**conf["data"], **SIFT_POOL}
    jpool = pools[1]
    jbatch, draws = _jax_batch_and_draws(data_conf, jpool, jax.random.key(5))
    jloss, jgrads, model = _carried(model_conf, jbatch)
    batch = tengine.OnDeviceCachedFeatureDataset(data_conf).make_batch_from_draws(
        tengine.upload_pool(jpool, "cpu"), draws)
    losses, _ = model.loss(model(batch), batch)
    loss = losses["total"].mean()
    loss.backward()
    loss = float(loss.detach())
    assert abs(loss - jloss) <= LOSS_RTOL * abs(jloss), (loss, jloss)
    named = dict(model.named_parameters())
    assert named.keys() == jgrads.keys()
    largest = max(float(g.abs().max()) for g in jgrads.values())
    for name, p in named.items():
        jg = jgrads[name].numpy()
        if name.endswith(".k.bias"):
            # SuperGlue's key bias adds one constant to a query's logits, which
            # the softmax removes: both gradients are rounding, held near zero
            assert max(np.abs(jg).max(), float(p.grad.abs().max())) <= 1e-6 * largest, name
            continue
        scale = max(np.abs(jg).max(), 1e-12)
        np.testing.assert_allclose(p.grad.numpy() / scale, jg / scale, atol=GRAD_RTOL,
                                   rtol=0, err_msg=name)
    if "sg" in recipe:
        assert abs(float(named["matcher.bin_score"].grad)) > 0


def test_superglue_checkpoints_cross_both_ways(pools, tmp_path):
    """A matcher-only SuperGlue run (``bin_score`` a scalar) checkpoints in
    the JAX format: JAX's ``load_experiment`` restores the port's parameters
    and Adam state into its own templates with the same keys and values,
    and the port restores JAX's checkpoint of the same state exactly."""
    from gluefactory_tpu.core.config import Config
    from gluefactory_tpu.train import default_train_conf as jax_train_conf
    from gluefactory_tpu.train import make_optimizer as jax_make_optimizer
    from gluefactory_tpu.utils import experiments as jexp
    from gluefactory_torch import train as T
    from gluefactory_torch.utils import experiments as texp

    conf = R.sift_sg_cached_conf()
    model_conf = {**conf["model"], "matcher": {**conf["model"]["matcher"], "n_layers": 1,
                                               "descriptor_dim": 32, "sinkhorn_iterations": 5}}
    jbatch, _ = _jax_batch_and_draws({**conf["data"], **SIFT_POOL}, pools[1], jax.random.key(1))
    _, _, model = _carried(model_conf, jbatch)
    jmodel = jax_build_model("two_view_pipeline", model_conf)
    params = jax.jit(partial(jmodel.init, method=jmodel.forward_and_loss))(
        jax.random.key(0), jbatch)
    train_conf = {**T.default_train_conf, "lr": 1e-3}
    optimizer = T.make_optimizer(train_conf, model, model_conf)
    batch = jax.tree.map(lambda x: torch.from_numpy(np.array(x)), jbatch)
    assert T.train_step(model, optimizer, batch)["skipped"] == 0.0
    full = {"model": model_conf, "train": train_conf}
    texp.save_experiment(tmp_path / "port", {"params": model, "opt_state": optimizer}, full,
                         epoch=0, iteration=1)
    blob, _ = jexp.load_experiment(tmp_path / "port" / "checkpoint_0_1.ckpt")
    tx, _ = jax_make_optimizer(Config(jax_train_conf).merge({"lr": 1e-3}), params,
                               Config(model_conf))
    for template, flat in ((params, blob["state"]["params"]),
                           (tx.init(params), blob["state"]["opt_state"])):
        template_flat = jexp.state_to_flat_dict(template)
        assert set(flat) == set(template_flat), set(flat) ^ set(template_flat)
        restored = jexp.state_to_flat_dict(jexp.restore_from_flat_dict(template, flat))
        for key, value in restored.items():
            assert value.dtype == template_flat[key].dtype, key
            np.testing.assert_array_equal(value, flat[key], err_msg=key)
    assert "['params']['matcher']['bin_score']" in blob["state"]["params"]

    jstate = {"params": jexp.restore_from_flat_dict(params, blob["state"]["params"]),
              "opt_state": jexp.restore_from_flat_dict(tx.init(params),
                                                       blob["state"]["opt_state"])}
    jexp.save_experiment(tmp_path / "jax", jax.tree.map(np.asarray, jstate), Config(full), 0, 1)
    again, _ = texp.load_experiment(tmp_path / "jax" / "checkpoint_0_1.ckpt")
    restored = build_model("two_view_pipeline", model_conf, device="cpu", train=True)
    texp.restore_from_flat_dict(restored, again["state"]["params"])
    for name, value in model.state_dict().items():
        assert torch.equal(restored.state_dict()[name], value), name
    other = T.make_optimizer(train_conf, restored, model_conf)
    texp.restore_from_flat_dict(other, again["state"]["opt_state"])
    for key, value in texp.state_to_flat_dict(optimizer).items():
        np.testing.assert_array_equal(texp.state_to_flat_dict(other)[key], value, err_msg=key)


def test_sift_lightglue_ood_gate(tmp_path):
    """The JAX gate tests/test_trained_quality.py:477 (lg_sift_stage2 on the
    family-B pairs that no training pool draws from) through the port's
    pipeline on the CPU, held to the gate's bounds (recipes.GATE_BOUNDS)."""
    from gluefactory_torch.flagship import RANSAC_CONF, pair_quality
    from gluefactory_torch.robust_estimators import load_estimator
    from gluefactory_torch.utils.weights import load_blob_into
    from test_trained_quality import render_pairs

    name = "sift_lightglue_ood"
    assert R.GATE_FAMILY[name] == "b"
    conf, blob = R.gate_conf(name)
    model = build_model("two_view_pipeline", conf, device="cpu")
    load_blob_into(model, blob, {"matcher": 4})
    estimator = load_estimator("homography", "ransac")(RANSAC_CONF)
    stats = {k: [] for k in ("matches", "prec1", "prec3", "h_err")}
    for img0, img1, H in render_pairs(tmp_path, family="b"):
        size = torch.tensor([[img0.shape[1], img0.shape[0]]], dtype=torch.float32)
        data = {"view0": {"image": torch.from_numpy(img0)[None], "image_size": size},
                "view1": {"image": torch.from_numpy(img1)[None], "image_size": size}}
        with torch.inference_mode():
            quality = pair_quality(model(data), torch.from_numpy(H), size[0], estimator)
        for key in stats:
            stats[key].append(quality[key])
    med = {k: float(np.median(v)) for k, v in stats.items()}
    for key, bound in R.GATE_BOUNDS[name].items():
        assert (med[key] < bound) if key == "h_err" else (med[key] > bound), (key, med)


def test_log_optimal_transport_gradient_matches_jax():
    """The gradient of Sinkhorn (50 iterations) with ragged masks, as
    SuperGlue's loss reads the log-assignment, against JAX's: the masked rows
    and columns get zero gradient, nothing is NaN."""
    rng = np.random.default_rng(3)
    b, n, m = 3, 40, 56
    sim = rng.normal(size=(b, n, m)).astype(np.float32) * 3
    mask0, mask1 = rng.uniform(size=(b, n)) > 0.3, rng.uniform(size=(b, m)) > 0.2
    mask0[0, 10:] = False
    mask1[2, :] = False  # an item without keypoints on one side
    weights = rng.normal(size=(b, n + 1, m + 1)).astype(np.float32)
    keep = np.concatenate([mask0, np.ones((b, 1), bool)], 1)[:, :, None] & np.concatenate(
        [mask1, np.ones((b, 1), bool)], 1)[:, None]

    def jloss(s, bins):
        z = jax_log_optimal_transport(s, bins, 50, jnp.asarray(mask0), jnp.asarray(mask1))
        return jnp.sum(jnp.where(keep, z * weights, 0.0))

    jv, (jg_sim, jg_bin) = jax.value_and_grad(jloss, argnums=(0, 1))(jnp.asarray(sim),
                                                                     jnp.float32(1.0))
    s = torch.from_numpy(sim).requires_grad_()
    bins = torch.tensor(1.0, requires_grad=True)
    z = log_optimal_transport(s, bins, 50, torch.from_numpy(mask0), torch.from_numpy(mask1))
    value = torch.where(torch.from_numpy(keep), z * torch.from_numpy(weights), 0.0).sum()
    value.backward()
    assert abs(float(value.detach()) - float(jv)) <= 1e-5 * abs(float(jv))
    g = s.grad.numpy()
    assert np.isfinite(g).all() and np.isfinite(float(bins.grad))
    scale = np.abs(np.asarray(jg_sim)).max()
    np.testing.assert_allclose(g / scale, np.asarray(jg_sim) / scale, atol=GRAD_RTOL, rtol=0)
    assert abs(float(bins.grad) - float(jg_bin)) <= GRAD_RTOL * abs(float(jg_bin))
    pair = mask0[:, :, None] & mask1[:, None]
    assert (g[~pair] == 0).all()


VAL_KEYS = ("loss/total", "metric/match_recall", "metric/match_precision")
VAL_RECIPES = (("superglue", R.sift_sg_cached_conf, R.SG_SIFT_WEIGHTS),
               ("lightglue", R.sift_lg_stage2_conf, R.LG_SIFT_WEIGHTS))


def _jax_side(recipe, blob, seed: int, pool=None) -> dict:
    """The JAX trainer's validation (``train.do_evaluation`` of the engine's
    val loader) of ``blob`` in ``recipe`` at data seed ``seed``, on the
    engine's own val pool or on ``pool``."""
    from gluefactory_tpu.datasets import get_dataset as jax_get_dataset
    from gluefactory_tpu.scripts.export_weights import load_weight_blob
    from gluefactory_tpu.train import do_evaluation, make_eval_forward
    from gluefactory_tpu.utils.experiments import restore_from_flat_dict

    model = jax_build_model("two_view_pipeline", recipe["model"])
    dataset = jax_get_dataset(recipe["data"]["name"])({**recipe["data"], "seed": seed,
                                                       "pool_cache": False})
    pool = jax.tree.map(jnp.asarray, dataset.build_pool("val") if pool is None else pool)
    batch = dataset.make_batch(pool, jax.random.key(0), split="val")
    params = restore_from_flat_dict(jax.eval_shape(model.init, jax.random.key(0), batch),
                                    load_weight_blob(blob)[0])  # every parameter
    results = do_evaluation(model, params, dataset.get_data_loader("val"),
                            make_eval_forward(model, dataset.make_batch), pool=pool)
    return {k: float(results[k]) for k in VAL_KEYS}


def _port_side(recipe, blob, seed: int, pool=None) -> dict:
    """chip_smoke.validate_blob (phase 16(d)) on the CPU at data seed
    ``seed``, on the port's own val pool or on ``pool``."""
    import chip_smoke

    conf = {**recipe, "data": {**recipe["data"], "seed": seed, "pool_cache": False}}
    if pool is None:
        pool = tengine.OnDeviceCachedFeatureDataset(conf["data"]).build_pool("val", "cpu")
    pool = tengine.upload_pool(pool, "cpu")
    return chip_smoke.validate_blob(conf, blob, torch.device("cpu"),
                                    {"train": pool, "val": pool})


def validation(side: str, seeds=(0, 1, 2)) -> dict:
    """{model: {seed: {key: value}}}: sg_sift_stage1 in the SuperGlue recipe
    and lg_sift_stage2 in the LightGlue stage-2 one, validated by the JAX
    package (``side`` 'jax') or the port ('port') on its own val pool of
    each data seed (4 batches of 32), or (``side`` 'cross') each package's
    model on the other package's val pool of each seed. No pool is cached:
    the two packages' cache files of one conf share their name."""
    out: dict = {}
    for name, recipe, blob in VAL_RECIPES:
        for seed in seeds:
            if side == "cross":
                conf = {**recipe()["data"], "seed": seed, "pool_cache": False}
                jdataset = jengine.OnDeviceCachedFeatureDataset(conf)
                jpool = {k: np.asarray(v) for k, v in jdataset.build_pool("val").items()}
                pool = tengine.OnDeviceCachedFeatureDataset(conf).build_pool("val", "cpu")
                value = {"port_model_jax_pool": _port_side(recipe(), blob, seed, jpool),
                         "jax_model_port_pool": _jax_side(recipe(), blob, seed, pool),
                         "keypoints_per_image": {
                             "jax": float(jpool["keypoint_valid"].sum(1).mean()),
                             "port": float(pool["keypoint_valid"].sum(1).mean())}}
            else:
                value = (_jax_side if side == "jax" else _port_side)(recipe(), blob, seed)
            out.setdefault(name, {})[seed] = value
            print(side, name, seed, value, flush=True)
    return out


if __name__ == "__main__":
    import argparse
    import json

    parser = argparse.ArgumentParser()
    parser.add_argument("--side", choices=["jax", "port", "cross"], default="jax")
    parser.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    args = parser.parse_args()
    print(json.dumps(validation(args.side, args.seeds)))
