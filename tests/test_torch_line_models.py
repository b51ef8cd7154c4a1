"""The line models of the line benchmarks against the JAX package on the CPU:
LBD descriptors (``lbd_describe``, LSD's ``describe: 'lbd'``) and their
matcher, ELSED (``csrc/elsed.cpp`` against JAX's ctypes library), SOLD2's
inference from the strictly loaded ``sold2_tpu_stage0`` blob at 240 pixels
(and at odd sizes, where its strided 1x1 projections take flax's 'SAME'
padding), the Wunsch matcher (``nw_scores`` and the match codes, from dense
descriptors and from given samples), the ground-truth line matcher, the line
recipes and the benchmark CLIs by ``--conf`` name.

Bounds: LBD within LBD_TOL, its matcher's codes equal on the same
descriptors; ELSED's segments equal bit for bit; SOLD2's heads within
HEAD_TOL and its valid lines, compared slot by slot as a set (the top-k
ranks thousands of pairs, most of them tied at 0), equal; ``nw_scores``
within NW_TOL and the Wunsch codes equal; the ground-truth codes equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gluefactory_torch.datasets.homographies_ondevice import generate_structured_scene
from gluefactory_torch.models import build_model
from gluefactory_torch.models.lines import lbd as LBD
from gluefactory_torch.models.lines import sold2 as S
from gluefactory_torch.models.lines.elsed import detect_elsed_np
from gluefactory_torch.models.matchers import wunsch_line_matcher as W
from gluefactory_torch.recipes import LINE_CONFS, SOLD2_WEIGHTS
from gluefactory_torch.settings import ROOT_PATH
from gluefactory_torch.utils.weights import load_blob_into
from gluefactory_tpu.models import build_model as jax_build_model
from gluefactory_tpu.models.lines import lbd as JLBD
from gluefactory_tpu.models.lines.elsed import detect_elsed_np as jax_detect_elsed_np
from gluefactory_tpu.models.matchers import wunsch_line_matcher as JW

torch.set_num_threads(2)

LBD_TOL = 1e-5
HEAD_TOL = 1e-4
NW_TOL = 1e-5


def _scene(seed, size=(320, 240)) -> np.ndarray:
    """A structured scene as a float RGB batch of one (1, H, W, 3)."""
    img = generate_structured_scene(np.random.default_rng(seed), size, max_points=4)[0]
    return np.repeat(img.astype(np.float32), 3, axis=-1)[None]


def _lines(seed, n, size=(320, 240)) -> np.ndarray:
    """Segments inside and across the image border, and degenerate ones."""
    rng = np.random.default_rng(seed)
    lines = rng.uniform([-20, -20], [size[0] + 20, size[1] + 20], (1, n, 2, 2))
    lines[:, :3, 1] = lines[:, :3, 0]
    return lines.astype(np.float32)


def _jax_apply(name, conf, data):
    model = jax_build_model(name, conf)
    data = {k: jnp.asarray(v) for k, v in data.items()}
    out = jax.jit(model.apply)(jax.jit(model.init)(jax.random.key(0), data), data)
    return {k: np.asarray(v) for k, v in out.items()}


def test_lbd_descriptors_are_jaxs():
    img, lines = _scene(1)[..., 0], _lines(2, 40)
    valid = np.random.default_rng(3).uniform(size=(1, 40)) > 0.1
    ours = LBD.lbd_describe(*map(torch.from_numpy, (img, lines, valid)))
    ref = jax.jit(JLBD.lbd_describe)(*map(jnp.asarray, (img, lines, valid)))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=LBD_TOL, rtol=0)
    assert (ours[~torch.from_numpy(valid)] == 0).all()
    described = torch.from_numpy(valid)[0, 3:]  # the first 3 segments have no length
    assert torch.allclose(ours[0, 3:][described].norm(dim=-1), torch.tensor(1.0))


def test_lbd_matcher_codes_are_jaxs():
    """The same descriptors (JAX's, of noisy copies of the segments) through
    both matchers: view 0's codes gated by score_th, view 1's not."""
    img = _scene(4)[..., 0]
    lines0 = _lines(5, 48)
    rng = np.random.default_rng(6)
    lines1 = (lines0[:, rng.permutation(48)] + rng.normal(0, 1.0, lines0.shape))[:, :44]
    data = {}
    for i, (lines, p) in enumerate(((lines0, 0.1), (lines1.astype(np.float32), 0.15))):
        valid = rng.uniform(size=lines.shape[:2]) > p
        data[f"line_descriptors{i}"] = np.asarray(jax.jit(JLBD.lbd_describe)(
            jnp.asarray(img), jnp.asarray(lines), jnp.asarray(valid)))
        data[f"valid_lines{i}"] = valid
    conf = {"score_th": 0.97}
    with torch.inference_mode():
        ours = build_model("matchers.line_matcher_lbd", conf, device="cpu")(
            {k: torch.from_numpy(v) for k, v in data.items()})
    ref = _jax_apply("matchers.line_matcher_lbd", conf, data)
    for key in ("line_matches0", "line_matches1"):
        np.testing.assert_array_equal(ours[key].numpy(), ref[key])
    for key in ("line_matching_scores0", "line_matching_scores1"):
        np.testing.assert_allclose(ours[key].numpy(), ref[key], atol=1e-6, rtol=1e-6)
    gated = (ours["line_matches0"] > -1).sum()
    assert 3 < gated < (ours["line_matches1"] > -1).sum()  # view 0's only are gated


def test_lsd_lbd_is_jaxs():
    """LSD with ``describe: 'lbd'``: LSD's segments equal, the descriptors
    within LBD_TOL."""
    image = _scene(7)
    conf = {"max_num_lines": 96, "describe": "lbd"}
    with torch.inference_mode():
        ours = build_model("lines.lsd", conf, device="cpu")({"image": torch.from_numpy(image)})
    ref = _jax_apply("lines.lsd", conf, {"image": image})
    for key in ("lines", "line_scores", "valid_lines"):
        np.testing.assert_array_equal(ours[key].numpy(), ref[key])
    np.testing.assert_allclose(ours["line_descriptors"].numpy(), ref["line_descriptors"],
                               atol=LBD_TOL, rtol=0)
    assert ours["valid_lines"].sum() > 30


@pytest.mark.parametrize("seed", [8, 9, 10])
def test_elsed_segments_are_jaxs_bit_for_bit(seed):
    rng = np.random.default_rng(seed)
    grey = _scene(seed, (320, 240))[0, ..., 0]
    grey = np.clip(grey + rng.normal(0, 0.01 * (seed - 8), grey.shape), 0, 1).astype(np.float32)
    ours = detect_elsed_np(grey, 200)
    ref = jax_detect_elsed_np(grey, 200)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)
    assert ours[2].sum() > 20


def test_elsed_model_is_jaxs():
    image = _scene(11)
    with torch.inference_mode():
        ours = build_model("lines.elsed", {"max_num_lines": 128}, device="cpu")(
            {"image": torch.from_numpy(image)})
    ref = _jax_apply("lines.elsed", {"max_num_lines": 128}, {"image": image})
    for key in ours:
        np.testing.assert_array_equal(ours[key].numpy(), ref[key])


def _sold2_pair(conf, image):
    """The port's SOLD2 (strictly loaded from the blob through the rename
    table, inside a pipeline as the blob holds it) and JAX's, on ``image``."""
    from gluefactory_tpu.core.config import Config
    from gluefactory_tpu.eval.io import load_model as jax_load_model
    from gluefactory_tpu.eval.io import restore_params

    pipeline = build_model("two_view_pipeline", {"extractor": {"name": "lines.sold2", **conf}},
                           device="cpu")
    load_blob_into(pipeline, ROOT_PATH / SOLD2_WEIGHTS)
    h, w = image.shape[1:3]
    data = {"image": image, "image_size": np.float32([[w, h]])}
    with torch.inference_mode():
        ours = pipeline.extractor({k: torch.from_numpy(v) for k, v in data.items()})
    jmodel, flat = jax_load_model(Config({"name": "lines.sold2", **conf}),
                                  str(ROOT_PATH / SOLD2_WEIGHTS))
    jdata = {k: jnp.asarray(v) for k, v in data.items()}
    params = restore_params(jax.jit(jmodel.init)(jax.random.key(0), jdata), flat)
    ref = jax.jit(jmodel.apply)(params, jdata)
    return ({k: v.numpy() for k, v in ours.items()}, {k: np.asarray(v) for k, v in ref.items()})


HEADS = ("junction_map", "junction_logits", "line_heatmap", "descriptors_dense")


def test_sold2_is_jaxs_from_the_blob():
    """At 240 pixels (320x240): the heads within HEAD_TOL, the junctions
    equal, the valid lines equal as sets of slots."""
    ours, ref = _sold2_pair({"max_num_lines": 512, "max_num_junctions": 250}, _scene(12))
    for key in HEADS:
        np.testing.assert_allclose(ours[key], ref[key], atol=HEAD_TOL, rtol=0, err_msg=key)
    for key in ("junctions", "junction_valid"):
        np.testing.assert_array_equal(ours[key], ref[key])
    valid = ours["valid_lines"][0]
    assert valid.sum() == ref["valid_lines"][0].sum() > 50
    as_set = [{tuple(l.reshape(-1)) for l in p["lines"][0][p["valid_lines"][0]]}
              for p in (ours, ref)]
    assert as_set[0] == as_set[1]
    assert (ours["lines"][0][~valid] == 0).all()


@pytest.mark.parametrize("size", [(237, 181), (250, 203)])
def test_sold2_heads_at_odd_sizes_are_jaxs(size):
    """Odd sizes: the strided 1x1 projections pad as flax's 'SAME' (none)."""
    ours, ref = _sold2_pair({"sparse_outputs": False}, _scene(13, size))
    for key in HEADS:
        assert ours[key].shape == ref[key].shape, key
        np.testing.assert_allclose(ours[key], ref[key], atol=HEAD_TOL, rtol=0, err_msg=key)


def test_sold2_unshuffles_cells_in_jaxs_channel_order():
    """Pixel (y, x) of a cell map is channel (y % g) * g + x % g of cell
    (y // g, x // g), as JAX's reshape and transpose put it."""
    g, hc, wc = 4, 2, 3
    x = np.arange(hc * wc * g * g, dtype=np.float32).reshape(1, hc, wc, g * g)
    ours = S.unshuffle(torch.from_numpy(x), g).numpy()[0]
    ref = x.reshape(1, hc, wc, g, g).transpose(0, 1, 3, 2, 4).reshape(hc * g, wc * g)
    np.testing.assert_array_equal(ours, ref)
    for y in range(hc * g):
        for xx in range(wc * g):
            assert ours[y, xx] == x[0, y // g, xx // g, (y % g) * g + xx % g]


def test_sold2_loss_is_refused_naming_its_slice():
    """SOLD2's loss is ported (tests/test_torch_shapes_train.py holds it to
    JAX's): its keys build, and of SOLD2's conf only the base ``timeit`` is
    still refused."""
    model = build_model("lines.sold2", {"loss": {"desc_nll_weight": 1.0}}, device="cpu")
    assert model.conf["loss"]["desc_nll_weight"] == 1.0
    with pytest.raises(NotImplementedError, match="timeit=True"):
        build_model("lines.sold2", {"timeit": True}, device="cpu")


def test_nw_scores_are_jaxs():
    sim = np.random.default_rng(14).uniform(-1, 1, (3, 50, 8, 8)).astype(np.float32)
    ours = W.nw_scores(torch.from_numpy(sim), 0.1)
    ref = jax.jit(JW.nw_scores, static_argnums=1)(jnp.asarray(sim), 0.1)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=NW_TOL, rtol=0)
    rev = W.nw_scores(torch.from_numpy(sim).flip(-1), 0.1)
    rev_ref = jax.jit(JW.nw_scores, static_argnums=1)(jnp.asarray(sim)[..., ::-1], 0.1)
    np.testing.assert_allclose(rev.numpy(), np.asarray(rev_ref), atol=NW_TOL, rtol=0)


@pytest.mark.parametrize("source", ["descriptors_dense", "line_desc_samples"])
def test_wunsch_codes_are_jaxs(source):
    rng = np.random.default_rng(15)
    lines0 = _lines(16, 40)
    lines1 = (lines0[:, rng.permutation(40)] + rng.normal(0, 1.5, lines0.shape))[:, :36]
    data = {"lines0": lines0, "lines1": lines1.astype(np.float32),
            "valid_lines0": rng.uniform(size=(1, 40)) > 0.1,
            "valid_lines1": rng.uniform(size=(1, 36)) > 0.1}
    if source == "descriptors_dense":
        dense = rng.normal(size=(1, 60, 80, 16)).astype(np.float32)
        dense = dense / np.linalg.norm(dense, axis=-1, keepdims=True)
        data.update(descriptors_dense0=dense, descriptors_dense1=dense)
    else:
        for i, n in ((0, 40), (1, 36)):
            data[f"line_desc_samples{i}"] = rng.normal(size=(1, n, 6, 16)).astype(np.float32)
    conf = {"min_score": 0.2}
    with torch.inference_mode():
        ours = build_model("matchers.wunsch_line_matcher", conf, device="cpu")(
            {k: torch.from_numpy(v) for k, v in data.items()})
    ref = _jax_apply("matchers.wunsch_line_matcher", conf, data)
    for key in ("line_matches0", "line_matches1"):
        np.testing.assert_array_equal(ours[key].numpy(), ref[key])
    for key in ("line_matching_scores0", "line_matching_scores1"):
        np.testing.assert_allclose(ours[key].numpy(), ref[key], atol=NW_TOL, rtol=0)
    assert (ours["line_matches0"] > -1).sum() > (5 if source == "descriptors_dense" else 0)


def test_gt_line_matcher_is_jaxs():
    rng = np.random.default_rng(17)
    H = np.array([[[1.03, 0.02, -7.0], [-0.01, 0.99, 5.0], [1e-4, 0.0, 1.0]]], np.float32)
    lines0 = _lines(18, 30)
    w = np.c_[lines0.reshape(-1, 2), np.ones(60)] @ H[0].T
    lines1 = (w[:, :2] / w[:, 2:]).reshape(1, 30, 2, 2) + rng.normal(0, 0.5, (1, 30, 2, 2))
    data = {"lines0": lines0, "lines1": lines1.astype(np.float32), "H_0to1": H,
            "valid_lines0": rng.uniform(size=(1, 30)) > 0.1}
    with torch.inference_mode():
        ours = build_model("matchers.line_matcher", {}, device="cpu")(
            {k: torch.from_numpy(v) for k, v in data.items()})
    ref = _jax_apply("matchers.line_matcher", {}, data)
    assert ours.keys() == ref.keys() == {"gt_line_matches0", "gt_line_matches1",
                                         "gt_line_assignment"}
    for key in ours:
        np.testing.assert_array_equal(ours[key].numpy(), ref[key])
    assert (ours["gt_line_matches0"] > -1).sum() > 15


@pytest.mark.parametrize("name", [f"{b}/{n}" for b, confs in LINE_CONFS.items() for n in confs])
def test_line_recipes_build(name):
    from gluefactory_torch.eval.io import load_model
    from gluefactory_torch.recipes import line_conf

    conf = line_conf(*name.split("/"))
    model = load_model(conf["model"], conf.get("checkpoint") and str(ROOT_PATH / conf["checkpoint"]),
                       "cpu")
    if conf.get("checkpoint"):  # SOLD2 and GlueStick, restored from their blobs
        assert sum(p.numel() for p in model.parameters()) > 1e5


@pytest.mark.parametrize("conf,extra,min_lines", [
    ("lsd+lbd", [], 5), ("elsed_lines_eval", [], 5),
    ("sold2+wunsch", [], 0),  # the YAML names no checkpoint: flax's initialisation
    ("sold2_wunsch", [f"--checkpoint={SOLD2_WEIGHTS}"], 5)])
def test_hpatches_lines_cli_takes_conf_by_name(conf, extra, min_lines, tmp_path, monkeypatch):
    """The benchmark's CLI by config name (the three YAMLs) and by recipe
    name, on one rendered sequence at 160 pixels."""
    from gluefactory_torch.eval import hpatches_lines
    from gluefactory_torch.scripts.generate_eval_set import render_sequence

    render_sequence(tmp_path / "set" / "v_cli", np.random.default_rng((616161, 0)), (240, 180),
                    "a")
    monkeypatch.setattr(hpatches_lines, "EVAL_PATH", tmp_path / "out")
    torch.manual_seed(0)
    summaries = hpatches_lines.main(
        ["--conf", conf, *extra, "--device", "cpu", "--tag", "t",
         f"data.data_dir={tmp_path / 'set'}", "data.preprocessing.resize=160"])
    assert summaries["mnum_lines0"] >= min_lines
    out = tmp_path / "out" / "hpatches_lines" / "t"
    assert (out / "summaries.json").exists()
    with np.load(out / "predictions.npz") as f:  # the matcher ran where the conf has one
        assert ("line_matches0" in f.files) == (conf != "elsed_lines_eval")


@pytest.mark.parametrize("name", [f"{b}/{n}" for b, confs in LINE_CONFS.items() for n in confs])
def test_line_recipe_is_its_committed_conf(name):
    """Each line conf over its pipeline's defaults is the committed
    outputs/results/<benchmark>/<name>/conf.yaml."""
    import yaml

    from gluefactory_torch.core.config import collect_defaults, merge
    from gluefactory_torch.eval import get_benchmark
    from gluefactory_torch.recipes import line_conf

    bench, conf_name = name.split("/")
    conf = merge(collect_defaults(get_benchmark(bench)), line_conf(bench, conf_name))
    committed = ROOT_PATH / "outputs" / "results" / bench / conf_name / "conf.yaml"
    assert conf == yaml.safe_load(committed.read_text())
