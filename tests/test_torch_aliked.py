"""ALIKED and ALIKED-light in the port against the JAX package on the CPU, on
the same flax parameters (``params_from_flat``; the zero-initialised offset
kernels drawn at 0.3 so that the deformable paths do real work): the
zero-padded sampler past every border, the ``align_corners=True`` resize,
the official graph's blocks (offsets that reach the max(h, w)/4 clamp,
keypoints within k of the border for SDDH's corner clamp), both ALIKED
paths on a 70x90 image with and without ``image_size`` for aliked-t16 and
aliked-n32, ALIKED-light, the official-checkpoint converter on a
synthesised state dict, a small aliked+lightglue pipeline, and one step of
the aliked+lightglue_homography recipe at a small size (loss, LightGlue's
gradients, the checkpoint read by the other package).

Bounds: blocks and dense maps within BLOCK_TOL (the maps of the model
relative to their largest magnitude), keypoints within KP_TOL px,
descriptors and scores within BLOCK_TOL, matches equal, LightGlue's
gradients within GRAD_TOL of each tensor's largest."""

import functools
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_weight_converters import _rand_state_aliked

from gluefactory_torch import train as T
from gluefactory_torch.models import build_model
from gluefactory_torch.models.extractors import aliked as A
from gluefactory_torch.ops.interpolate import bilinear_sample_zeros
from gluefactory_torch.recipes import ALIKED_CONFS, aliked_lightglue_homography_conf
from gluefactory_torch.utils import experiments as texp
from gluefactory_torch.utils.weights import load_state_strict, params_from_flat
from gluefactory_tpu.core.config import Config
from gluefactory_tpu.datasets.base_dataset import collate as jax_collate
from gluefactory_tpu.datasets.homographies import HomographyDataset as JHomographies
from gluefactory_tpu.models import build_model as jax_build_model
from gluefactory_tpu.models.extractors import aliked as JA
from gluefactory_tpu.train import default_train_conf as jax_train_conf
from gluefactory_tpu.train import make_optimizer as jax_make_optimizer
from gluefactory_tpu.ops.interpolate import bilinear_sample_zeros as jax_sample_zeros
from gluefactory_tpu.utils import experiments as jexp

torch.set_num_threads(2)

BLOCK_TOL = 1e-5
KP_TOL = 1e-4
GRAD_TOL = 2e-4
ALIKED = "extractors.aliked"


def _t(x):
    return torch.from_numpy(np.array(x))


def _flat(tree):
    return {k: np.asarray(v) for k, v in jexp.state_to_flat_dict(tree).items()}


def _perturbed(params, rng, scale=0.3):
    """Every all-zero array (the offset kernels and the biases) drawn at ``scale``."""
    def fill(x):
        x = np.asarray(x)
        return x if x.any() else rng.normal(0, scale, x.shape).astype(np.float32)
    return jax.tree.map(fill, params)


def _nchw(x):
    return _t(x).permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1).detach().numpy()


# --- the sampler and the resize -------------------------------------------------------

def test_bilinear_sample_zeros_past_every_border():
    """Points past each side and corner, on the border, on integers and one
    pixel out: every tap outside the map contributes zero, as in JAX."""
    rng = np.random.default_rng(0)
    fmap = rng.normal(size=(2, 7, 9, 5)).astype(np.float32)
    pts = rng.uniform([-2.5, -2.5], [10.5, 8.5], (2, 200, 2)).astype(np.float32)
    pts[:, :8] = [[-1, -1], [8, 6], [-0.5, 3], [8.5, 3], [4, -0.25], [4, 6.75], [-1, 6], [9, 7]]
    ref = np.asarray(jax.jit(jax_sample_zeros)(fmap, pts))
    out = bilinear_sample_zeros(_t(fmap), _t(pts)).numpy()
    np.testing.assert_allclose(out, ref, atol=BLOCK_TOL, rtol=0)
    outside = (pts[..., 0] <= -1) | (pts[..., 0] >= 9) | (pts[..., 1] <= -1) | (pts[..., 1] >= 7)
    assert outside.sum() >= 20 and not out[outside].any()


@pytest.mark.parametrize("src", [(1, 1), (1, 5), (4, 1), (7, 9)])
def test_resize_align_corners_is_jaxs(src):
    """``F.interpolate(align_corners=True)`` against JAX's interpolation
    matrices, a side of 1 included (repeated)."""
    x = np.random.default_rng(1).normal(size=(2, *src, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(JA._resize_align_corners, static_argnums=(1, 2))(x, 64, 96))
    out = _nhwc(A._resize_align_corners(_nchw(x), 64, 96))
    np.testing.assert_allclose(out, ref, atol=BLOCK_TOL, rtol=0)


# --- the official graph's blocks ------------------------------------------------------

def _init(jblock, rng, *args, scale_offsets=1.0):
    params = jax.jit(jblock.init)(jax.random.key(1), *map(jnp.asarray, args))

    def scale(path, x):
        names = [getattr(p, "key", "") for p in path]
        return x * scale_offsets if any(n.startswith("offset") for n in names) else x
    return _perturbed(jax.tree_util.tree_map_with_path(scale, params), rng)


def test_compat_dcn_clamps_offsets():
    """Offsets of many pixels: a share of them reaches the +-max(h, w)/4
    clamp, and the samples fall outside the map (zero padding)."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 10, 13, 6)).astype(np.float32)
    jblock = JA.CompatDCN(8)
    params = _init(jblock, rng, x, scale_offsets=40.0)
    port = A.CompatDCN(6, 8)
    load_state_strict(port, params_from_flat(_flat(params)))
    raw = port.offset(_nchw(x)).detach().abs()
    assert (raw > 13 / 4).float().mean() > 0.2  # the clamp at max(h, w)/4 binds
    ref = np.asarray(jax.jit(jblock.apply)(params, jnp.asarray(x)))
    np.testing.assert_allclose(_nhwc(port(_nchw(x))), ref, atol=BLOCK_TOL, rtol=0)


@pytest.mark.parametrize("deformable", [True, False])
def test_compat_res_block_is_flaxs(deformable):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 11, 9, 6)).astype(np.float32)
    jblock = JA.CompatResBlock(8, deformable=deformable)
    params = _init(jblock, rng, x, scale_offsets=10.0)
    port = A.CompatResBlock(6, 8, deformable=deformable)
    load_state_strict(port, params_from_flat(_flat(params)))
    ref = np.asarray(jax.jit(jblock.apply)(params, jnp.asarray(x)))
    np.testing.assert_allclose(_nhwc(port(_nchw(x))), ref, atol=BLOCK_TOL, rtol=0)


def test_compat_sddh_is_flaxs():
    """Keypoints within k of every border (the patch corner clamped to
    [0, w-1-k]) and offsets that reach the clamp and leave the map."""
    rng = np.random.default_rng(4)
    fmap = rng.normal(size=(2, 12, 15, 16)).astype(np.float32)
    kpts = rng.uniform([0, 0], [15, 12], (2, 24, 2)).astype(np.float32)
    kpts[:, :6] = [[0.2, 0.7], [14.6, 11.9], [1.5, 10.2], [13.1, 2.5], [11.9, 8.4], [0.0, 11.0]]
    jblock = JA.CompatSDDH(24, k=3, M=16)
    params = _init(jblock, rng, fmap, kpts, scale_offsets=5.0)
    port = A.CompatSDDH(16, 24, k=3, M=16)
    load_state_strict(port, params_from_flat(_flat(params)))
    hidden = torch.nn.functional.selu(port.offset1(torch.randn(500, 9 * 16)))
    assert (port.offset2(hidden).abs() > 15 / 4).float().mean() > 0.1  # the clamp binds
    ref = np.asarray(jax.jit(jblock.apply)(params, jnp.asarray(fmap), jnp.asarray(kpts)))
    out = port(_t(fmap), _t(kpts)).detach().numpy()
    np.testing.assert_allclose(out, ref, atol=BLOCK_TOL, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(out, axis=-1), 1.0, atol=1e-5)


# --- the model, both paths ----------------------------------------------------------------

IMAGE_HW = (70, 90)  # neither side a multiple of 32
IMAGE_SIZE = [83.0, 61.0]  # (w, h): a padded canvas


def _image(seed=5):
    rng = np.random.default_rng(seed)
    h, w = IMAGE_HW
    base = rng.uniform(0, 1, (1, h // 5 + 1, w // 5 + 1, 3))
    img = np.repeat(np.repeat(base, 5, 1), 5, 2)[:, :h, :w]
    return (0.7 * img + 0.3 * rng.uniform(0, 1, (1, h, w, 3))).astype(np.float32)


SLOTS = 64


@functools.lru_cache(maxsize=None)
def _jax_model(model_name: str, compat: bool):
    """JAX's ALIKED (dense outputs, SLOTS slots) on perturbed flax parameters:
    (its parameters, a jitted function of the parameters, the image and
    ``image_size`` giving the outputs without and with ``image_size``, the
    port's model on the same parameters)."""
    conf = {"model_name": model_name, "compat": compat, "max_num_keypoints": SLOTS,
            "dense_outputs": True}
    jmodel = jax_build_model(ALIKED, Config({"name": ALIKED, **conf}))
    params = _perturbed(jax.jit(jmodel.init)(jax.random.key(0),
                                             {"image": jnp.asarray(_image())}),
                        np.random.default_rng(6))
    port = build_model(ALIKED, conf, device="cpu")
    load_state_strict(port, params_from_flat(_flat(params)))

    @jax.jit
    def both(params, image, size):  # one compilation for both cases
        return (jmodel.apply(params, {"image": image}),
                jmodel.apply(params, {"image": image, "image_size": size}))
    return params, both, port


def _jax_outputs(model_name: str, compat: bool, params, image: np.ndarray) -> tuple:
    _, both, _ = _jax_model(model_name, compat)
    return tuple({k: np.asarray(v) for k, v in out.items()}
                 for out in both(params, jnp.asarray(image), jnp.float32([IMAGE_SIZE])))


def _port_outputs(port, data: dict) -> dict:
    with torch.inference_mode():
        return {k: v.numpy() for k, v in port({k: _t(v) for k, v in data.items()}).items()}


def _hold(ours: dict, ref: dict, compat: bool) -> None:
    """Dense maps and scores within BLOCK_TOL of their largest magnitude,
    slots equal, keypoints within KP_TOL px, descriptors within BLOCK_TOL;
    DKD's dispersity within BLOCK_TOL times the scores' largest magnitude
    over its temperature 0.1 (it reads exp(score / 0.1), which carries the
    scores' rounding that far)."""
    assert ours.keys() == ref.keys()
    for key in ("descriptors_dense", "score_map", "keypoint_scores"):
        scale = np.abs(ref[key]).max()
        np.testing.assert_allclose(ours[key] / scale, ref[key] / scale, atol=BLOCK_TOL, rtol=0,
                                   err_msg=key)
    np.testing.assert_array_equal(ours["keypoint_valid"], ref["keypoint_valid"])
    assert ref["keypoint_valid"].sum() >= 16
    np.testing.assert_allclose(ours["keypoints"], ref["keypoints"], atol=KP_TOL, rtol=0)
    np.testing.assert_allclose(ours["descriptors"], ref["descriptors"], atol=BLOCK_TOL, rtol=0)
    if compat:
        np.testing.assert_allclose(ours["score_dispersity"], ref["score_dispersity"], rtol=0,
                                   atol=BLOCK_TOL * np.abs(ref["score_map"]).max() / 0.1)


@pytest.mark.parametrize("with_size", [False, True])
@pytest.mark.parametrize("compat", [False, True])
@pytest.mark.parametrize("model_name", ["aliked-t16", "aliked-n32"])
def test_aliked_is_jaxs(model_name, compat, with_size):
    params, _, port = _jax_model(model_name, compat)
    image = _image()
    ref = _jax_outputs(model_name, compat, params, image)[int(with_size)]
    data = {"image": image, **({"image_size": np.float32([IMAGE_SIZE])} if with_size else {})}
    _hold(_port_outputs(port, data), ref, compat)
    if with_size:  # every valid keypoint inside the canvas, away from its border
        kp = ref["keypoints"][ref["keypoint_valid"]]
        assert (kp[:, 0] < IMAGE_SIZE[0] - 1).all() and (kp[:, 1] < IMAGE_SIZE[1] - 1).all()


def test_aliked_takes_three_channels():
    """block1 is built for RGB (flax infers it from the first image): a grey
    image is refused, but tiled by the official graph, as JAX tiles it."""
    image = torch.rand(1, 40, 48, 1)
    with pytest.raises(ValueError, match="3"):
        build_model(ALIKED, {"model_name": "aliked-t16"}, device="cpu")({"image": image})
    model = build_model(ALIKED, {"model_name": "aliked-t16", "compat": True,
                                 "max_num_keypoints": 16}, device="cpu")
    with torch.inference_mode():
        grey, rgb = model({"image": image}), model({"image": image.expand(-1, -1, -1, 3)})
    torch.testing.assert_close(grey["descriptors"], rgb["descriptors"], rtol=0, atol=0)
    with pytest.raises(NotImplementedError, match="ALIKED is used pretrained"):
        model.loss({}, {})


def test_recompute_keeps_gradients_and_spares_jpldd():
    """ALIKED's and ALIKED-light's trunks recompute their deformable gathers
    and aggregation in the backward pass, with the gradients of the kept
    graph; JPLDD's trunk keeps its graph."""
    from chip_smoke_aliked import perturb_zero_kernels_

    def recomputing(model):
        return [m.recompute for m in model.modules() if hasattr(m, "recompute")]

    model = build_model(ALIKED, {"model_name": "aliked-t16"}, device="cpu")
    perturb_zero_kernels_(model, torch.Generator().manual_seed(1), 0.3)
    image = torch.rand(2, 40, 48, 3, generator=torch.Generator().manual_seed(2))
    grads = []
    for recompute in (True, False):
        for m in model.modules():
            if hasattr(m, "recompute"):
                m.recompute = recompute
        model.zero_grad(set_to_none=True)
        features, scores = model.extract_dense_map(image)
        ((features * features.detach().roll(1, -1)).sum() + (scores ** 2).sum()).backward()
        grads.append({n: p.grad for n, p in model.named_parameters() if p.grad is not None})
    assert grads[0].keys() == grads[1].keys() == {
        n for n, _ in model.named_parameters() if not n.startswith("desc_head.")}
    for name, g in grads[0].items():
        torch.testing.assert_close(g, grads[1][name], rtol=1e-6, atol=1e-7, msg=name)
    light = build_model("extractors.aliked_light", {"model_name": "aliked-t16"}, device="cpu")
    jpldd = build_model("extractors.joint_point_line_extractor", {}, device="cpu")
    fresh = build_model(ALIKED, {"model_name": "aliked-t16"}, device="cpu")
    assert recomputing(fresh) == recomputing(light) == [True] * 5
    assert recomputing(jpldd) == [False] * 5


def test_perturbed_offsets_are_the_zero_kernels():
    """chip_smoke_aliked's ``perturb_zero_kernels_`` draws exactly the flax
    zero-initialised kernels: the deformable convolutions' offsets and SDDH's
    offset layer."""
    from chip_smoke_aliked import perturb_zero_kernels_

    model = build_model(ALIKED, {"model_name": "aliked-t16"}, device="cpu")
    zero = {n for n, p in model.named_parameters() if n.endswith("weight") and not p.any()}
    gen = torch.Generator().manual_seed(0)
    assert perturb_zero_kernels_(model, gen, 0.3) == len(zero) == 5
    assert zero == {f"block{b}.dcn{i}.offset.weight" for b in (3, 4) for i in (1, 2)} | {
        "desc_head.offset.weight"}
    for name, p in model.named_parameters():
        if name in zero:
            assert abs(float(p.detach().std()) - 0.3) < 0.05, name


def test_aliked_light_is_jaxs():
    """On aliked-t16's parameters without the score head (the same tree)."""
    rng = np.random.default_rng(7)
    image = _image(8)
    kpts = rng.uniform([0, 0], [90, 70], (1, 40, 2)).astype(np.float32)
    conf = {"model_name": "aliked-t16"}
    jmodel = jax_build_model("extractors.aliked_light",
                             Config({"name": "extractors.aliked_light", **conf}))
    params = _jax_model("aliked-t16", False)[0]
    params = {"params": {k: v for k, v in params["params"].items() if not k.startswith("sh")}}
    port = build_model("extractors.aliked_light", conf, device="cpu")
    load_state_strict(port, params_from_flat(_flat(params)))
    ref = np.asarray(jax.jit(jmodel.apply)(params, {"image": jnp.asarray(image),
                                                    "keypoints": jnp.asarray(kpts)})
                     ["descriptors"])
    out = _port_outputs(port, {"image": image, "keypoints": kpts})["descriptors"]
    np.testing.assert_allclose(out, ref, atol=BLOCK_TOL, rtol=0)
    with pytest.raises(NotImplementedError):
        port.loss({}, {})


def test_converter_on_an_official_state_dict():
    """A synthesised Shiaoming/ALIKED aliked-t16 state dict (BatchNorms, DCN
    offset and regular convolutions, SDDH): JAX's converter and JAX's
    official graph against the port's converter and the port's graph."""
    torch.manual_seed(3)
    sd = _rand_state_aliked()
    jparams = JA.torch_weight_converter({k: v.numpy() for k, v in sd.items()})
    state = A.torch_weight_converter(sd)
    expected = params_from_flat(_flat(jparams))
    assert state.keys() == expected.keys()
    for name, value in state.items():
        torch.testing.assert_close(value, expected[name], rtol=0, atol=0, msg=name)
    port = build_model(ALIKED, {"model_name": "aliked-t16", "compat": True,
                                "max_num_keypoints": SLOTS, "dense_outputs": True}, device="cpu")
    load_state_strict(port, state)
    image = _image(9)
    ref = _jax_outputs("aliked-t16", True, jparams, image)[0]
    assert ref["keypoint_valid"].all()
    _hold(_port_outputs(port, {"image": image}), ref, compat=True)


# --- the confs and the pipelines -------------------------------------------------------

# aliked+lightglue_homography cut to a small size: aliked-t16 at 64 keypoints on 96-pixel
# views, 2 LightGlue layers on its 64-dimensional descriptors, batch 2
SMALL = {"extractor": {"model_name": "aliked-t16", "max_num_keypoints": 64},
         "matcher": {"input_dim": 64, "n_layers": 2}}


def _merge(base: dict, over: dict) -> dict:
    return {**base, **{k: _merge(base[k], v) if isinstance(v, dict) and isinstance(
        base.get(k), dict) else v for k, v in over.items()}}


@pytest.mark.parametrize("name", sorted(ALIKED_CONFS) + ["aliked+lightglue_homography"])
def test_recipes_are_the_yamls(name):
    """The model cards and the training recipe as dicts equal the committed
    YAML files; the eval CLIs read the cards by name without ``yaml``."""
    import yaml

    from gluefactory_torch.eval.io import CONFIGS_DIR, read_named_conf

    ref = yaml.safe_load((CONFIGS_DIR / f"{name}.yaml").read_text())
    ours = (aliked_lightglue_homography_conf() if name.endswith("homography")
            else read_named_conf(name))
    assert ours == ref


def _jit_model(name: str, conf: dict):
    model = jax_build_model(name, Config({"name": name, **conf}))
    return model, jax.jit(model.apply)


@functools.lru_cache(maxsize=None)
def _recipe_side():
    """The recipe cut to SMALL, the first two items of JAX's host homography
    dataset as a batch, the flax parameters of the pipeline (aliked-t16's
    of the tests above, LightGlue's from its own flax initialisation) and
    JAX's components (the pipeline composed of them: two compilations of
    the JAX pipeline cost tier-1 ~30 s): the views' ALIKED outputs, the
    ground truth, and LightGlue's jitted apply and (loss, gradients)."""
    conf = aliked_lightglue_homography_conf()
    conf["model"] = _merge(conf["model"], SMALL)
    mconf = conf["model"]
    data = JHomographies({**conf["data"], "image_size": 96,
                          "synthetic_source_size": [128, 96]}).get_dataset("train")
    batch = jax_collate([data[i] for i in range(2)])
    batch = jax.tree.map(jnp.asarray, {k: v for k, v in batch.items() if k not in ("name", "idx")})
    _, extract = _jit_model(ALIKED, mconf["extractor"])
    ext_params = _jax_model("aliked-t16", False)[0]
    pred = {f"{k}{i}": v for i in "01" for k, v in extract(ext_params, batch[f"view{i}"]).items()}
    gt_model, gt = _jit_model(mconf["ground_truth"]["name"], mconf["ground_truth"])
    pred.update({k if k.startswith("gt_") else f"gt_{k}": v
                 for k, v in gt({}, {**batch, **pred}).items()})
    lg, lg_apply = _jit_model("matchers.lightglue", mconf["matcher"])
    inputs = {**batch, **pred}
    lg_params = jax.jit(lg.init)(jax.random.key(1), inputs)
    params = {"params": {"extractor": ext_params["params"], "matcher": lg_params["params"]}}

    def loss_fn(lg_params):
        losses, _ = lg.apply(lg_params, lg.apply(lg_params, inputs), inputs, method=lg.loss)
        return jnp.mean(losses["total"])

    return conf, batch, params, inputs, partial(lg_apply, lg_params, inputs), jax.jit(
        jax.value_and_grad(loss_fn)), lg_params


def _port_pipeline(model_conf: dict, params, train: bool = False):
    model = build_model("two_view_pipeline", model_conf, device="cpu", train=train)
    load_state_strict(model, params_from_flat(_flat(params), {"matcher": 4}))
    return model


def test_aliked_lightglue_pipeline_matches_are_jaxs():
    """aliked+lightglue (its model card cut to SMALL, and its filter at 0,
    since initialised weights score no match above 0.1) on the recipe's
    batch: the keypoints and the matches of both views equal JAX's."""
    _, batch, params, inputs, _, _, lg_params = _recipe_side()
    conf = _merge(ALIKED_CONFS["aliked+lightglue"]["model"],
                  _merge(SMALL, {"matcher": {"filter_threshold": 0.0}}))
    _, lg_apply = _jit_model("matchers.lightglue", conf["matcher"])
    ref = {**inputs, **lg_apply(lg_params, inputs)}
    with torch.inference_mode():
        ours = _port_pipeline(conf, params)(jax.tree.map(_t, batch))
    for i in "01":
        np.testing.assert_allclose(ours[f"keypoints{i}"].numpy(), ref[f"keypoints{i}"],
                                   atol=KP_TOL, rtol=0)
        np.testing.assert_array_equal(ours[f"matches{i}"].numpy(), ref[f"matches{i}"])
        np.testing.assert_allclose(ours[f"matching_scores{i}"].numpy(),
                                   ref[f"matching_scores{i}"], atol=BLOCK_TOL, rtol=0)
    assert (np.asarray(ref["matches0"]) >= 0).sum() >= 2  # mutual nearest neighbours


def test_homography_recipe_step_is_jaxs(tmp_path):
    """One step of the recipe (cut to SMALL) on JAX's batch: the loss and
    every LightGlue gradient against ``jax.value_and_grad``; the port's
    checkpoint after its step restored by JAX's ``load_experiment`` into
    JAX's parameter and optax templates, and JAX's checkpoint after optax's
    step restored by the port, equal to the port's own step."""
    conf, batch, params, _, _, value_and_grad, lg_params = _recipe_side()
    loss, lg_grads = value_and_grad(lg_params)
    grads = {"params": {"extractor": jax.tree.map(jnp.zeros_like, params["params"]["extractor"]),
                        "matcher": lg_grads["params"]}}
    model = _port_pipeline(conf["model"], params, train=True)
    data = jax.tree.map(_t, batch)
    model.zero_grad(set_to_none=True)
    model.loss(model(data), data)[0]["total"].mean().backward()
    jgrads = params_from_flat(_flat(lg_grads), {"": 4})
    for name, p in model.matcher.named_parameters():
        jg = jgrads[name].numpy()
        scale = max(np.abs(jg).max(), 1e-12)
        np.testing.assert_allclose(p.grad.numpy() / scale, jg / scale, atol=GRAD_TOL,
                                   err_msg=name)

    train_conf = {**T.default_train_conf, **conf["train"]}
    optimizer = T.make_optimizer(train_conf, model, conf["model"])
    scalars = T.train_step(model, optimizer, data)
    assert scalars["skipped"] == 0.0
    assert scalars["loss/total"] == pytest.approx(float(loss), rel=2e-5)
    full = {"model": conf["model"], "train": train_conf}
    texp.save_experiment(tmp_path / "port", {"params": model, "opt_state": optimizer}, full,
                         epoch=0, iteration=1)
    blob, jconf = jexp.load_experiment(tmp_path / "port" / "checkpoint_0_1.ckpt")
    assert jconf.model.matcher.n_layers == 2 and not jconf.model.extractor.trainable
    tx, _ = jax_make_optimizer(Config(jax_train_conf).merge(conf["train"]), params,
                               Config(conf["model"]))
    opt_state = tx.init(params)
    for template, flat in ((params, blob["state"]["params"]),
                           (opt_state, blob["state"]["opt_state"])):
        assert set(flat) == set(jexp.state_to_flat_dict(template))
        jexp.restore_from_flat_dict(template, flat)

    @jax.jit  # eager optax over the tree costs ~13 s here
    def update(grads, opt_state, params):
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    stepped, opt_state = update(grads, opt_state, params)
    jexp.save_experiment(tmp_path / "jax", {"params": jax.tree.map(np.asarray, stepped),
                                            "opt_state": jax.tree.map(np.asarray, opt_state)},
                         Config(full), 0, 1)
    blob, _ = texp.load_experiment(tmp_path / "jax" / "checkpoint_0_1.ckpt")
    restored = build_model("two_view_pipeline", conf["model"], device="cpu", train=True)
    texp.restore_from_flat_dict(restored, blob["state"]["params"])
    restored_optimizer = T.make_optimizer(train_conf, restored, conf["model"])
    texp.restore_from_flat_dict(restored_optimizer, blob["state"]["opt_state"])
    assert restored_optimizer.count == optimizer.count == 1
    ours = model.state_dict()
    for name, value in restored.state_dict().items():
        # one Adam step from the same gradients: lr apart where a gradient is at
        # rounding level and takes the other sign
        torch.testing.assert_close(value, ours[name], rtol=0, atol=2.5e-4, msg=name)
