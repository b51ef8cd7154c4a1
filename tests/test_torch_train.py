"""The port's training path (gluefactory_torch: attention backward, losses,
metrics, ground truth, the on-device data engine, the recipe, the schedule)
against the JAX package on the same numpy inputs, on the CPU.

Random streams differ between jax.random and torch.Generator, so the engine
is compared on JAX's own draws, fed to the port's deterministic halves
(``*_from_draws``, ``photometric_apply``, ``make_batch_from_draws``); the
port's generators are tested for their distribution only.

Tolerances are float32 ones (1e-5 or tighter) unless a line says why."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import __graft_entry__
from gluefactory_tpu.core.config import Config
from gluefactory_tpu.datasets.homographies_ondevice import OnDeviceHomographyDataset as JEngine
from gluefactory_tpu.datasets.homographies_ondevice import _SeedLoader as JSeedLoader
from gluefactory_tpu.datasets.homographies_ondevice import (
    generate_structured_scene as jax_scene,
)
from gluefactory_tpu.geometry import gt_generation as jgt
from gluefactory_tpu.geometry import homography as jhomography
from gluefactory_tpu.models import build_model as jax_build_model
from gluefactory_tpu.models.utils import losses as jlosses
from gluefactory_tpu.models.utils import metrics as jmetrics
from gluefactory_tpu.ops import attention as jattention
from gluefactory_tpu.ops import photometric as jphotometric
from gluefactory_tpu.ops import warp as jwarp
from gluefactory_tpu.train import default_train_conf as jax_train_conf
from gluefactory_tpu.train import make_lr_schedule as jax_lr_schedule
from gluefactory_tpu.utils.experiments import state_to_flat_dict
from gluefactory_torch.datasets.homographies_ondevice import (
    OnDeviceHomographyDataset,
    SeedLoader,
    generate_structured_scene,
    upload_pool,
)
from gluefactory_torch.geometry import gt_generation as tgt
from gluefactory_torch.geometry import homography as thomography
from gluefactory_torch.models import build_model
from gluefactory_torch.models.utils import losses as tlosses
from gluefactory_torch.models.utils import metrics as tmetrics
from gluefactory_torch.ops import attention as tattention
from gluefactory_torch.ops import photometric as tphotometric
from gluefactory_torch.ops import warp as twarp
from gluefactory_torch.recipes import stage2_conf
from gluefactory_torch.train import Trainer, make_lr_schedule, training
from gluefactory_torch.utils.weights import load_state_strict, params_from_flat

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(t, j, atol, rtol=0.0):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=atol, rtol=rtol)


# --- attention backward ---------------------------------------------------------

def _attention_inputs(rng, masked, b=2, h=2, n=24, d=64):
    q, k, v, g = (rng.normal(size=(b, h, n, d)).astype(np.float32) for _ in range(4))
    theta = rng.normal(size=(b, n, d // 2)).astype(np.float32) * 3
    cos = np.repeat(np.cos(theta), 2, -1)
    sin = np.repeat(np.sin(theta), 2, -1)
    mask = rng.uniform(size=(b, n)) > 0.3 if masked else None
    if masked:
        mask[1] = False  # a fully-masked batch item
    return q, k, v, g, cos, sin, mask


@pytest.mark.parametrize("masked", [False, True])
def test_attention_backward_matches_jax(masked):
    """Autograd through the kernel's Function (plain forward on the CPU) gives
    JAX ``_attention_bwd``'s gradients; so does ``attention_bwd`` itself."""
    q, k, v, g, _, _, mask = _attention_inputs(np.random.default_rng(0), masked)
    jm = None if mask is None else jnp.asarray(mask)
    jgrads = jattention._attention_bwd(
        (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jm), jnp.asarray(g))[:3]
    tm = None if mask is None else _t(mask)
    leaves = [_t(x).requires_grad_(True) for x in (q, k, v)]
    tattention.attention(*leaves, kv_mask=tm, implementation="auto").backward(_t(g))
    direct = tattention.attention_bwd(_t(q), _t(k), _t(v), tm, _t(g))
    for leaf, d, jd in zip(leaves, direct, jgrads):
        _close(leaf.grad, jd, atol=1e-5)
        _close(d, jd, atol=1e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_rotary_attention_backward_matches_jax(masked):
    """The rotary Function's gradients, dcos and dsin included (summed over
    heads), against JAX ``_sar_bwd``."""
    q, k, v, g, cos, sin, mask = _attention_inputs(np.random.default_rng(1), masked)
    jm = None if mask is None else jnp.asarray(mask)
    jgrads = jattention._sar_bwd(tuple(jnp.asarray(x) if x is not None else None
                                       for x in (q, k, v, cos, sin, mask)), jnp.asarray(g))
    leaves = [_t(x).requires_grad_(True) for x in (q, k, v, cos, sin)]
    tm = None if jm is None else _t(mask)
    tattention.self_attention_rotary(*leaves, kv_mask=tm, implementation="auto").backward(_t(g))
    for leaf, jd in zip(leaves, jgrads[:5]):
        assert leaf.grad.shape == jd.shape
        _close(leaf.grad, jd, atol=2e-5)  # dcos/dsin sum 2 heads of products


def test_kernel_functions_match_plain_autograd():
    """The Functions' recomputed gradients equal autograd through the plain
    versions (the plain path LightGlue takes with attention='xla')."""
    q, k, v, g, cos, sin, mask = _attention_inputs(np.random.default_rng(2), True)
    for fn, inputs in ((tattention.self_attention_rotary, (q, k, v, cos, sin)),
                       (tattention.attention, (q, k, v))):
        grads = {}
        for impl in ("auto", "xla"):
            leaves = [_t(x).requires_grad_(True) for x in inputs]
            fn(*leaves, kv_mask=_t(mask), implementation=impl).backward(_t(g))
            grads[impl] = [leaf.grad for leaf in leaves]
        for a, b in zip(grads["auto"], grads["xla"]):
            torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


# --- losses, metrics, ground truth -----------------------------------------------

def _match_codes(rng, b, n, m):
    return rng.integers(-2, m, size=(b, n)).astype(np.int32)


def test_nll_losses_match_jax():
    rng = np.random.default_rng(3)
    b, n, m = 3, 20, 17
    scores = rng.normal(size=(b, n, m)).astype(np.float32)
    scores[0, :, 5] = -1e9  # a masked column after the -inf replacement
    z0, z1 = rng.normal(size=(b, n)).astype(np.float32), rng.normal(size=(b, m)).astype(np.float32)
    gt0, gt1 = _match_codes(rng, b, n, m), _match_codes(rng, b, m, n)
    gt0[2] = -2  # an item with nothing supervised
    gt1[2] = -2
    out = tlosses.nll_loss_no_bins(*map(_t, (scores, z0, z1, gt0, gt1)))
    jout = jlosses.nll_loss_no_bins(*map(jnp.asarray, (scores, z0, z1, gt0, gt1)))
    for t, j in zip(out, jout):
        _close(t, j, atol=1e-5, rtol=1e-6)
    bins = rng.normal(size=(b, n + 1, m + 1)).astype(np.float32)
    for balance in (True, False):
        out = tlosses.nll_loss(_t(bins), _t(gt0), _t(gt1), balance=balance)
        jout = jlosses.nll_loss(jnp.asarray(bins), jnp.asarray(gt0), jnp.asarray(gt1),
                                balance=balance)
        for t, j in zip(out, jout):
            _close(t, j, atol=1e-5, rtol=1e-6)


def test_matcher_metrics_match_jax():
    """Quantised scores make ties: the ranking keeps JAX's stable order."""
    rng = np.random.default_rng(4)
    b, n, m = 3, 40, 30
    pred = {"matches0": rng.integers(-1, m, size=(b, n)).astype(np.int32),
            "matching_scores0": (rng.integers(0, 5, size=(b, n)) / 4).astype(np.float32)}
    gt = _match_codes(rng, b, n, m)
    gt[:, :10] = pred["matches0"][:, :10]
    out = tmetrics.matcher_metrics({k: _t(v) for k, v in pred.items()},
                                   {"gt_matches0": _t(gt)})
    jout = jmetrics.matcher_metrics({k: jnp.asarray(v) for k, v in pred.items()},
                                    {"gt_matches0": jnp.asarray(gt)})
    assert out.keys() == jout.keys()
    for key in out:
        _close(out[key], jout[key], atol=1e-6)


def test_gt_matches_from_homography_match_jax():
    rng = np.random.default_rng(5)
    b, n, m = 2, 60, 50
    H = np.array([[[1.02, 0.05, 4.0], [-0.03, 0.98, -6.0], [1e-4, 2e-4, 1.0]],
                  [[0.9, -0.1, 20.0], [0.08, 1.1, 3.0], [-2e-4, 1e-4, 1.0]]], np.float32)
    kp0 = rng.uniform(0, 100, (b, n, 2)).astype(np.float32)
    hp = np.concatenate([kp0, np.ones((b, n, 1), np.float32)], -1) @ H.transpose(0, 2, 1)
    kp1 = rng.uniform(0, 100, (b, m, 2)).astype(np.float32)
    kp1[:, :30] = hp[:, :30, :2] / hp[:, :30, 2:] + rng.normal(0, 1.5, (b, 30, 2))
    v0, v1 = rng.uniform(size=(b, n)) > 0.1, rng.uniform(size=(b, m)) > 0.1
    size = np.array([[100.0, 90.0], [80.0, 100.0]], np.float32)
    args = (kp0, kp1, H)
    kwargs = dict(image_size0=size, image_size1=size[::-1].copy(), valid0=v0, valid1=v1)
    out = tgt.gt_matches_from_homography(*map(_t, args), **{k: _t(v) for k, v in kwargs.items()})
    jout = jgt.gt_matches_from_homography(*map(jnp.asarray, args),
                                          **{k: jnp.asarray(v) for k, v in kwargs.items()})
    assert out.keys() == jout.keys()
    assert (out["matches0"].numpy() >= 0).sum() > 20
    for key in out:
        if out[key].dtype in (torch.float32,):
            _close(out[key], jout[key], atol=1e-4)  # pixels, after a 3x3 inverse
        else:
            np.testing.assert_array_equal(out[key].numpy(), np.asarray(jout[key]), err_msg=key)


# --- the on-device engine ------------------------------------------------------------

def _jax_homography_draws(key, b):
    kp, ks, ka, kt = jax.random.split(key, 4)
    return {"pert": jax.random.uniform(kp, (b, 4, 2)), "shrink": jax.random.uniform(ks, (b, 4, 1)),
            "angle": jax.random.uniform(ka, (b,)), "trans": jax.random.uniform(kt, (b, 2))}


def _jax_photometric_draws(key, shape):
    """The numbers ``gluefactory_tpu.ops.photometric.photometric_augment``
    draws from ``key``, in the port's layout (a coin is a uniform < p)."""
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
    return jax.tree.map(lambda x: _t(x), tree)


@pytest.mark.parametrize("difficulty,max_angle,atol", [(0.7, 45.0, 2e-3), (1.0, 90.0, 1e-2)])
def test_homography_from_draws_matches_jax(difficulty, max_angle, atol):
    key, b = jax.random.key(11), 16
    jH, jquad = jhomography.sample_homography_batch(key, b, (448, 400), (320, 320),
                                                    difficulty=difficulty, max_angle=max_angle)
    H, quad = thomography.homography_from_draws(
        _to_torch(_jax_homography_draws(key, b)), (448, 400), (320, 320),
        difficulty=difficulty, max_angle=max_angle)
    _close(quad, jquad, atol=1e-3)  # source pixels, float32
    # points of the source quad (bilinear in its corners) land on the canvas;
    # the two 9x9 float32 eigensolves differ in the last bits, more so for
    # the strongest warps
    u, v = (w.reshape(1, -1, 1) for w in np.meshgrid(np.linspace(0, 1, 5), np.linspace(0, 1, 5)))
    c = np.asarray(jquad)[:, :, None, :]
    grid = ((1 - u) * (1 - v) * c[:, 0] + u * (1 - v) * c[:, 1] + u * v * c[:, 2]
            + (1 - u) * v * c[:, 3]).astype(np.float32)
    _close(thomography.warp_points(_t(grid), H),
           jhomography.warp_points(jnp.asarray(grid), jH), atol=atol)


def test_homography_sampler_draws_valid_homographies():
    gen = torch.Generator().manual_seed(0)
    H, quad = thomography.sample_homography_batch(gen, 64, (448, 448), (320, 320))
    again = thomography.sample_homography_batch(torch.Generator().manual_seed(0), 64,
                                                (448, 448), (320, 320))
    torch.testing.assert_close(H, again[0], rtol=0, atol=0)
    assert float(quad.min()) >= -1e-3 and float(quad.max()) <= 448 + 1e-3
    assert bool(thomography._convex(quad / 448).all())
    corners = torch.tensor([[0.0, 0.0], [320.0, 0.0], [320.0, 320.0], [0.0, 320.0]])
    torch.testing.assert_close(thomography.warp_points(quad, H), corners.expand(64, 4, 2),
                               atol=2e-2, rtol=0)
    draws = thomography.homography_draws(torch.Generator().manual_seed(1), 4096)
    u = draws["pert"]
    assert float(u.min()) >= 0 and float(u.max()) < 1 and abs(float(u.mean()) - 0.5) < 0.01


def test_warp_image_matches_jax():
    rng = np.random.default_rng(6)
    img = rng.uniform(size=(3, 96, 112, 1)).astype(np.float32)
    jH, _ = jhomography.sample_homography_batch(jax.random.key(2), 3, (112, 96), (64, 64))
    out = twarp.warp_image(_t(img), _t(jH), (64, 64))
    jout = jwarp.warp_image(jnp.asarray(img), jH, (64, 64))
    # 3x3 inverses differ in the last bits, which moves the bilinear weights
    _close(out, jout, atol=5e-4)
    assert float((out == 0).float().mean()) < 0.9


def test_photometric_apply_matches_jax():
    rng = np.random.default_rng(7)
    img = rng.uniform(size=(8, 40, 48, 1)).astype(np.float32)
    key = jax.random.key(5)
    jout = jphotometric.photometric_augment(key, jnp.asarray(img), p=0.8, strength=1.2)
    out = tphotometric.photometric_apply(_t(img), _to_torch(_jax_photometric_draws(key, img.shape)),
                                         p=0.8, strength=1.2)
    _close(out, jout, atol=1e-5)


def test_photometric_generator_distribution():
    rng = np.random.default_rng(8)
    img = _t(rng.uniform(0.01, 1.0, size=(64, 16, 16, 1)).astype(np.float32))
    out = tphotometric.photometric_augment(torch.Generator().manual_seed(0), img)
    again = tphotometric.photometric_augment(torch.Generator().manual_seed(0), img)
    torch.testing.assert_close(out, again, rtol=0, atol=0)
    assert float(out.min()) >= 0 and float(out.max()) <= 1
    assert float((out - img).abs().mean()) > 0.02
    # with probability 0 no transform applies: only the gamma clip at 1e-4 is left
    none = tphotometric.photometric_augment(torch.Generator().manual_seed(0), img, p=0.0)
    torch.testing.assert_close(none, img.clamp(1e-4, 1.0), atol=1e-6, rtol=0)
    draws = tphotometric.photometric_draws(torch.Generator().manual_seed(2), (4096, 4, 4, 1))
    assert abs(float(draws["noise"].std()) - 1.0) < 0.02
    assert abs(float((draws["apply_blur"] < 0.3).float().mean()) - 0.3) < 0.03


_ENGINE_CONF = {"pool_size": 3, "source_size": [96, 80], "image_size": 64, "max_gt_points": 48,
                "train_batch_size": 4, "seed": 3}


def test_make_batch_matches_jax_engine():
    """The JAX engine's own pool and random numbers through the port's
    ``make_batch_from_draws``."""
    jengine = JEngine(_ENGINE_CONF)
    pool = jengine.build_pool("train")
    key = jax.random.key(9)
    jbatch = jengine.make_batch(jax.tree.map(jnp.asarray, pool), key)
    k_idx, k_h0, k_h1, k_p0, k_p1 = jax.random.split(key, 5)
    shape = (4, 64, 64, 1)
    draws = {"idx": jax.random.randint(k_idx, (4,), 0, 3),
             "h0": _jax_homography_draws(k_h0, 4), "h1": _jax_homography_draws(k_h1, 4),
             "p0": _jax_photometric_draws(k_p0, shape), "p1": _jax_photometric_draws(k_p1, shape)}
    engine = OnDeviceHomographyDataset(_ENGINE_CONF)
    batch = engine.make_batch_from_draws(upload_pool(pool, "cpu"), _to_torch(draws))
    for view in ("view0", "view1"):
        assert batch[view]["image"].shape == shape
        # warps differ by < 2e-4 (see the warp test); gamma and contrast
        # scale that by at most a few
        _close(batch[view]["image"], jbatch[view]["image"], atol=2e-3)
        _close(batch[view]["image_size"], jbatch[view]["image_size"], atol=0)
    scale = np.abs(np.asarray(jbatch["H_0to1"])).max(axis=(1, 2), keepdims=True)
    _close(batch["H_0to1"] / _t(scale), np.asarray(jbatch["H_0to1"]) / scale, atol=1e-4)
    for i in "01":
        _close(batch[f"gt_keypoints{i}"], jbatch[f"gt_keypoints{i}"], atol=2e-3)
        np.testing.assert_array_equal(batch[f"gt_keypoint_valid{i}"].numpy(),
                                      np.asarray(jbatch[f"gt_keypoint_valid{i}"]))


def test_make_batch_from_seed_is_deterministic():
    engine = OnDeviceHomographyDataset(_ENGINE_CONF)
    pool = upload_pool(engine.build_pool("train"), "cpu")
    a, b, c = (engine.make_batch(pool, s) for s in (4, 4, 5))
    torch.testing.assert_close(a["view1"]["image"], b["view1"]["image"], rtol=0, atol=0)
    assert not torch.equal(a["view1"]["image"], c["view1"]["image"])
    assert pool["images"].dtype == torch.uint8
    assert int(a["gt_keypoint_valid0"].sum()) > 0


def test_scene_generator_draws_the_jax_scenes():
    """Same random draws as the cv2 version: the corner ground truth is
    identical, the pixels differ only on the edges of shapes (numpy fills vs
    cv2's rasteriser)."""
    for i in range(4):
        img, pts, valid = generate_structured_scene(np.random.default_rng((0, i)), (448, 400), 192)
        jimg, jpts, jvalid = jax_scene(np.random.default_rng((0, i)), (448, 400), 192)
        np.testing.assert_array_equal(pts, jpts)
        np.testing.assert_array_equal(valid, jvalid)
        assert valid.sum() > 10
        assert img.shape == jimg.shape == (400, 448, 1)
        assert img.min() >= 0.0 and img.max() <= 1.0
        diff = np.abs(img - jimg)
        assert diff.mean() < 0.01 and (diff > 0.05).mean() < 0.02, (diff.mean(), (diff > 0.05).mean())
        again = generate_structured_scene(np.random.default_rng((0, i)), (448, 400), 192)
        np.testing.assert_array_equal(img, again[0])


def test_seed_loader_matches_jax():
    for split in ("train", "val"):
        loader, jloader = SeedLoader(7, split, 5), JSeedLoader(7, split, 5)
        loader.set_epoch(3)
        jloader.set_epoch(3)
        assert list(loader) == [int(x["seed"]) for x in jloader]


# --- recipe, schedule, trainer --------------------------------------------------------

def test_stage2_conf_matches_the_yaml():
    path = ROOT / "gluefactory_tpu/configs/superpoint+lightglue_stage2.yaml"
    assert stage2_conf() == yaml.safe_load(path.read_text())


@pytest.mark.parametrize("sched", [{"type": "exp", "start": 3, "exp_div_10": 4},
                                   {"type": "factor", "start": 2, "factor": 0.3},
                                   {"type": None}])
def test_lr_schedule_matches_jax(sched):
    conf = {"lr": 2.5e-4, "lr_schedule": sched}
    jsched = jax_lr_schedule(Config(jax_train_conf).merge(conf))
    ours = make_lr_schedule(conf)
    for step in range(10):
        assert ours(step) == pytest.approx(float(jsched(step)), rel=1e-6)


def test_lightglue_loss_matches_jax():
    """Deep supervision and token confidence on the tiny LightGlue, with
    masked slots (the -1e30 scores) and all three match codes."""
    conf = {k: v for k, v in __graft_entry__._flagship_conf(tiny=True)["matcher"].items()
            if k != "flash"}
    conf.update(n_layers=3, attention="xla")
    rng = np.random.default_rng(10)
    b, n, m, dim = 2, 20, 18, 32

    def view(k):
        kp = rng.uniform(0, 60, (b, k, 2)).astype(np.float32)
        desc = rng.normal(size=(b, k, dim)).astype(np.float32)
        return kp, desc / np.linalg.norm(desc, axis=-1, keepdims=True), rng.uniform(size=(b, k)) > 0.2

    (kp0, d0, v0), (kp1, d1, v1) = view(n), view(m)
    size = np.full((b, 2), 64.0, np.float32)
    data = {"keypoints0": kp0, "keypoints1": kp1, "descriptors0": d0, "descriptors1": d1,
            "keypoint_valid0": v0, "keypoint_valid1": v1, "view0": {"image_size": size},
            "view1": {"image_size": size}, "gt_matches0": _match_codes(rng, b, n, m),
            "gt_matches1": _match_codes(rng, b, m, n)}
    jdata = jax.tree.map(jnp.asarray, data)
    jmodel = jax_build_model("matchers.lightglue", conf)
    params = jmodel.init(jax.random.key(3), jdata, method=jmodel.forward_and_loss)
    jpred = jmodel.apply(params, jdata)
    jlosses_, jmetrics_ = jmodel.apply(params, jpred, jdata, method=jmodel.loss)
    model = build_model("matchers.lightglue", conf, device="cpu", train=True)
    load_state_strict(model, params_from_flat(state_to_flat_dict(params), {"": 2}))
    tdata = jax.tree.map(_t, data)
    pred = model(tdata)
    assert pred["desc_layers0"].shape == (3, b, n, dim)
    losses, metrics = model.loss(pred, tdata)
    assert losses.keys() == jlosses_.keys() and metrics.keys() == jmetrics_.keys()
    for key in losses:
        _close(losses[key], jlosses_[key], atol=2e-5, rtol=1e-5)
    for key in metrics:
        _close(metrics[key], jmetrics_[key], atol=1e-6)


def _tiny_training_conf(**train):
    return {"data": {"name": "homographies_ondevice", **_ENGINE_CONF, "train_batch_size": 2},
            "model": __graft_entry__._flagship_conf(tiny=True),
            "train": {"lr": 1e-3, **train}}


def test_pipeline_loss_runs_ground_truth_and_skips_frozen_slots():
    """With ``run_gt_in_forward`` off, ``loss`` runs the ground-truth slot
    itself and gives the same losses; the frozen extractor adds no loss."""
    trainer = Trainer(_tiny_training_conf(), device="cpu")
    data = trainer.dataset.make_batch(trainer.pool, 0)
    model = trainer.model
    with torch.no_grad():
        pred = model(data)
        losses, _ = model.loss(pred, data)
        model.conf["run_gt_in_forward"] = False
        pred_no_gt = model(data)
        assert "gt_matches0" not in pred_no_gt and "gt_matches0" in pred
        losses_late, _ = model.loss(pred_no_gt, data)
    for key in losses:
        torch.testing.assert_close(losses[key], losses_late[key])
    # only the matcher's losses: the frozen extractor is skipped
    assert set(losses) == {"nll_pos", "nll_neg", "assignment_nll", "confidence", "total"}


def test_trainer_and_probe_need_cuda_unless_asked_for_the_cpu(tmp_path):
    """The trainer, the probe and the step trace run on the card; only the
    first two take ``device='cpu'``."""
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    from gluefactory_torch.scripts import kernel_probe, trace_train_step

    with pytest.raises(RuntimeError, match="device='cpu'"):
        training(_tiny_training_conf(), tmp_path, steps=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trace_train_step.main([])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(_tiny_training_conf())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        kernel_probe.main(["--out", "unused.json"])
    # an experiment that is not there (stage 2's start is not committed)
    with pytest.raises(FileNotFoundError, match="lg_r2_sp0b"):
        Trainer(dict(_tiny_training_conf(), train={"load_experiment": "lg_r2_sp0b"}),
                device="cpu")


def test_checkpointed_layers_give_the_same_gradients():
    """``checkpointed`` recomputes each layer in the backward pass (the JAX
    package's nn.remat): same loss and gradients."""
    trainer = Trainer(_tiny_training_conf(), device="cpu")
    data = trainer.dataset.make_batch(trainer.pool, 1)
    model = trainer.model
    grads = []
    for checkpointed in (False, True):
        model.matcher.conf["checkpointed"] = checkpointed
        model.zero_grad(set_to_none=True)
        model.loss(model(data), data)[0]["total"].mean().backward()
        grads.append({k: p.grad.clone() for k, p in model.matcher.named_parameters()})
    for name, g in grads[0].items():
        torch.testing.assert_close(grads[1][name], g, rtol=1e-5, atol=1e-7, msg=name)


def test_views_with_a_cache_skip_the_extractor_when_allowed():
    """A view's ``cache`` of features replaces the extractor's run when
    ``allow_no_extract`` is set; without it the extractor runs and the cache
    overrides the keys it holds."""
    trainer = Trainer(_tiny_training_conf(), device="cpu")
    model = trainer.model
    data = trainer.dataset.make_batch(trainer.pool, 2)
    with torch.no_grad():
        pred = model(data)
        cached = {f"view{i}": {**data[f"view{i}"], "cache": {
            k: pred[k + i] for k in ("keypoints", "keypoint_valid", "descriptors")}}
            for i in "01"}
        cached["view1"]["cache"]["descriptors"] = cached["view1"]["cache"]["descriptors"] * 0
        model.conf["allow_no_extract"] = True
        skipped = model({**data, **cached})
        model.conf["allow_no_extract"] = False
        extracted = model({**data, **cached})
    assert "keypoint_scores1" not in skipped and "keypoint_scores1" in extracted
    for out in (skipped, extracted):
        assert torch.equal(out["descriptors1"], cached["view1"]["cache"]["descriptors"])
    torch.testing.assert_close(skipped["log_assignment"], extracted["log_assignment"])


# --- the optimizer's plateau and lr_scaling, validation, the stage-5 recipe ----

def test_plateau_controller_matches_jax():
    """The same validation values through both controllers: the same scale
    after each, with patience, min_scale and NaN values."""
    from gluefactory_tpu.train import PlateauController as JPlateau
    from gluefactory_torch.train import PlateauController

    sched = {"type": "plateau", "factor": 0.5, "patience": 2, "min_scale": 0.1}
    values = [3.0, 2.5, 2.6, 2.7, 2.4, 2.4, 2.5, float("nan"), 2.6, 2.6, 2.7, 2.8, 2.9, 3.0,
              3.1, 3.2, 3.3]
    ours, theirs = PlateauController(sched), JPlateau(Config(sched))
    for value in values:
        assert ours.update(value) == theirs.update(value)
        assert ours.scale == theirs.scale and ours.bad == theirs.bad
    assert ours.scale == 0.1
    off = PlateauController({"type": "exp"})
    assert not any(off.update(v) for v in values) and off.scale == 1.0


def test_metric_accumulators_match_jax():
    """AverageMetric and MedianMetric over batches with NaN values (left out)
    and over nothing (NaN)."""
    from gluefactory_tpu.utils import tools as jtools
    from gluefactory_torch.utils import tools

    rng = np.random.default_rng(5)
    batches = [rng.normal(size=7), np.array([np.nan, 1.5]), rng.normal(size=(2, 3))]
    for name in ("AverageMetric", "MedianMetric"):
        ours, theirs = getattr(tools, name)(), getattr(jtools, name)()
        assert np.isnan(ours.compute()) and np.isnan(theirs.compute())
        for batch in batches:
            ours.update(batch)
            theirs.update(batch)
        assert ours.compute() == theirs.compute()


def test_lr_scaling_matches_jax_masks():
    """``lr_scaling`` selects the parameters whose flax path holds a
    substring, as JAX's masks do; an entry that matches nothing is dropped;
    the scales of two matching entries multiply."""
    from gluefactory_tpu.train import lr_scaling_masks
    from gluefactory_torch.train import lr_scales
    from gluefactory_torch.utils.weights import flax_key

    conf = __graft_entry__._flagship_conf(tiny=True)
    jmodel = jax_build_model("two_view_pipeline", conf)
    engine = JEngine({**_ENGINE_CONF, "train_batch_size": 1})
    pool = jax.tree.map(jnp.asarray, engine.build_pool("train"))
    params = jmodel.init(jax.random.key(0), engine.make_batch(pool, jax.random.key(1)),
                         method=jmodel.forward_and_loss)
    scaling = [[0.1, ["log_assignment", "posenc"]], [3.0, ["self_attn/Wqkv"]],
               [0.5, ["log_assignment_1"]], [7.0, ["no_such_module"]]]
    masks = lr_scaling_masks(params, scaling)
    model = build_model("two_view_pipeline", conf, device="cpu")
    names = [n for n, _ in model.named_parameters()]
    scales, used = lr_scales(names, scaling)
    assert used == len(masks) == 3
    expected = {k: 1.0 for k in state_to_flat_dict(params)}
    for scale, mask in masks:
        for key, hit in state_to_flat_dict(mask).items():
            if bool(hit):
                expected[key] *= scale
    assert {flax_key(n): s for n, s in zip(names, scales)} == expected
    assert {s for s in scales} == {1.0, 0.1, 3.0, 0.05}


def test_pr_counts_and_match_ap_match_jax():
    """Binned match confidences by correctness over three batches and the
    average precision from them: the port's ``_pr_counts`` and
    ``do_evaluation`` against JAX's, fed the same predictions."""
    from gluefactory_tpu.train import _pr_counts as jax_pr_counts
    from gluefactory_tpu.train import do_evaluation as jax_do_evaluation
    from gluefactory_torch.train import _pr_counts, do_evaluation

    rng = np.random.default_rng(7)
    batches = []
    for _ in range(3):
        b, n, m = 2, 40, 36
        gt = _match_codes(rng, b, n, m)
        m0 = np.where(rng.uniform(size=(b, n)) < 0.7, gt, rng.integers(-1, m, (b, n)))
        m0 = np.where(m0 < 0, -1, m0)
        scores = np.where(m0 >= 0, rng.uniform(size=(b, n)), 0.0).astype(np.float32)
        scores[0, :3] = [0.0, 1.0, 0.5]  # the edges of the bins
        batches.append(({"matches0": m0, "matching_scores0": scores},
                        {"gt_matches0": gt}, rng.uniform(size=b).astype(np.float32)))
    for pred, data, _ in batches:
        ours = _pr_counts(jax.tree.map(_t, pred), jax.tree.map(_t, data))
        theirs = jax_pr_counts(jax.tree.map(jnp.asarray, pred), jax.tree.map(jnp.asarray, data))
        for key in ("correct", "incorrect", "num_pos"):
            np.testing.assert_array_equal(ours[key].numpy(), np.asarray(theirs[key]))

    def jax_forward(params, pool, seed):
        pred, data, loss = batches[seed]
        return ({"total": loss}, {"recall": loss * 2},
                jax_pr_counts(jax.tree.map(jnp.asarray, pred), jax.tree.map(jnp.asarray, data)))

    def forward(pool, seed):
        pred, data, loss = batches[seed]
        return ({"total": _t(loss)}, {"recall": _t(loss * 2)},
                _pr_counts(jax.tree.map(_t, pred), jax.tree.map(_t, data)))

    ours = do_evaluation(torch.nn.Module(), range(3), forward, pool={})
    theirs = jax_do_evaluation(None, None, [{"seed": i} for i in range(3)], jax_forward,
                               pool=object())
    assert ours.keys() == theirs.keys() == {"loss/total", "metric/recall", "match_AP"}
    for key, value in theirs.items():
        assert ours[key] == pytest.approx(value, rel=1e-12), key
    assert 0.1 < ours["match_AP"] < 1.0


def test_stage5_recipe_is_the_yaml():
    from gluefactory_torch.recipes import STAGE5_WEIGHTS, stage5_conf

    path = ROOT / "gluefactory_tpu/configs/superpoint+lightglue_stage5_r4.yaml"
    assert stage5_conf() == yaml.safe_load(path.read_text())
    assert (ROOT / stage5_conf()["train"]["load_experiment"]) == STAGE5_WEIGHTS
    assert STAGE5_WEIGHTS.exists()
