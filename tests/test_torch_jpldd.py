"""JPLDD in the port against the JAX package on the CPU: the ALIKED blocks
(``ConvBlock`` at stride 2 on even and odd sizes, ``DeformableConv`` in
``ResBlock`` with offsets that reach past the border, ``SDDH``) on the same
flax parameters, the trunk's bilinear upsampling against
``jax.image.resize``, JPLDD's forward from its blobs at full width (points,
fields, descriptors, POLD2's lines and their SDDH samples), POLD2 on
candidates of equal length, the NN point-line matcher, and the strict load
of the four blobs.

Bounds: blocks and the resize within BLOCK_TOL; from a blob the trunk's
features within HEAD_TOL of their largest magnitude, the heads' outputs (heatmap, the normalised distance field, the angle field's sin/cos)
within HEAD_TOL, the distance field in pixels within 5 HEAD_TOL (it is
the normalised one times ``line_neighborhood`` = 5), the angle within
HEAD_TOL over the length of its sin/cos pair (atan2 amplifies the pair's
error by the inverse length), keypoints within KP_TOL px,
descriptors within HEAD_TOL, and the line slots equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gluefactory_torch.datasets.homographies_ondevice import generate_structured_scene
from gluefactory_torch.models import build_model
from gluefactory_torch.models.extractors import aliked as A
from gluefactory_torch.recipes import JPLDD_WEIGHTS
from gluefactory_torch.settings import ROOT_PATH
from gluefactory_torch.utils.weights import load_blob_into, load_state_strict, params_from_flat
from gluefactory_tpu.core.config import Config
from gluefactory_tpu.eval.io import load_model as jax_load_model
from gluefactory_tpu.eval.io import restore_params
from gluefactory_tpu.models import build_model as jax_build_model
from gluefactory_tpu.models.extractors import aliked as JA
from gluefactory_tpu.utils.experiments import state_to_flat_dict

torch.set_num_threads(2)

BLOCK_TOL = 1e-5
HEAD_TOL = 1e-5
KP_TOL = 1e-4
JPLDD = "extractors.joint_point_line_extractor"


def _t(x):
    return torch.from_numpy(np.array(x))


def _flat(tree):
    return {k: np.asarray(v) for k, v in state_to_flat_dict(tree).items()}


def _perturbed(params, rng, scale=0.3):
    """Every zero-initialised kernel (the offsets) drawn at ``scale`` instead."""
    def fill(x):
        x = np.asarray(x)
        return x if x.any() else rng.normal(0, scale, x.shape).astype(np.float32)
    return jax.tree.map(fill, params)


def _block_pair(jblock, port, x, rng, *extra):
    params = _perturbed(jax.jit(jblock.init)(jax.random.key(1), jnp.asarray(x), *extra), rng)
    load_state_strict(port, params_from_flat(_flat(params)))
    ref = np.asarray(jblock.apply(params, jnp.asarray(x), *extra))
    return port, ref


@pytest.mark.parametrize("h,w", [(16, 20), (15, 17)])
def test_conv_block_at_stride_2_is_flaxs(h, w):
    """flax's 'SAME' padding of a stride-2 3x3 convolution: none at the top
    and left of an even size."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, h, w, 5)).astype(np.float32)
    port, ref = _block_pair(JA.ConvBlock(8, stride=2), A.ConvBlock(5, 8, stride=2), x, rng)
    out = port(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert out.shape == ref.shape == (2, (h + 1) // 2, (w + 1) // 2, 8)
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=BLOCK_TOL, rtol=0)


@pytest.mark.parametrize("deformable", [True, False])
def test_res_block_is_flaxs(deformable):
    """With ``proj`` (6 -> 8 channels) and, deformable, offsets of a few
    pixels that sample past the border."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 11, 13, 6)).astype(np.float32)
    port, ref = _block_pair(JA.ResBlock(8, deformable=deformable),
                            A.ResBlock(6, 8, deformable=deformable), x, rng)
    out = port(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=BLOCK_TOL, rtol=0)


def test_sddh_is_flaxs():
    """Keypoints inside and near the border, offsets that leave the map."""
    rng = np.random.default_rng(2)
    fmap = rng.normal(size=(2, 12, 14, 16)).astype(np.float32)
    kpts = rng.uniform([-1, -1], [14, 12], (2, 9, 2)).astype(np.float32)
    jblock = JA.SDDH(24, k=3, M=16)
    params = _perturbed(jax.jit(jblock.init)(jax.random.key(1), jnp.asarray(fmap),
                                             jnp.asarray(kpts)), rng, scale=0.5)
    port = A.SDDH(16, 24)
    load_state_strict(port, params_from_flat(_flat(params)))
    ref = np.asarray(jblock.apply(params, jnp.asarray(fmap), jnp.asarray(kpts)))
    out = port(_t(fmap), _t(kpts)).detach().numpy()
    np.testing.assert_allclose(out, ref, atol=BLOCK_TOL, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(out, axis=-1), 1.0, atol=1e-5)


@pytest.mark.parametrize("src,dst", [((60, 80), (120, 160)), ((30, 40), (120, 160)),
                                     ((38, 50), (151, 201)), ((7, 9), (61, 77))])
def test_trunk_upsampling_is_jax_image_resize(src, dst):
    """``F.interpolate(align_corners=False)`` against ``jax.image.resize``
    ('bilinear'), the borders included: the upsampling of each trunk stage."""
    x = np.random.default_rng(3).normal(size=(2, *src, 4)).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (2, *dst, 4), "bilinear"))
    out = torch.nn.functional.interpolate(_t(x).permute(0, 3, 1, 2), size=dst, mode="bilinear",
                                          align_corners=False).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(out, ref, atol=BLOCK_TOL, rtol=0)
    # the border rows and columns, where half-pixel centres fall outside the source
    for ours, theirs in ((out[:, 0], ref[:, 0]), (out[:, -1], ref[:, -1]),
                         (out[:, :, 0], ref[:, :, 0]), (out[:, :, -1], ref[:, :, -1])):
        np.testing.assert_allclose(ours, theirs, atol=BLOCK_TOL, rtol=0)


def test_flax_initialisers_of_the_zero_and_normal_layers():
    """The deformable convolution's offset conv and SDDH's offset layer start
    at zero; SDDH's ``agg`` is drawn from normal(0.02) (tests/test_torch_init.py
    holds the draws' distribution)."""
    dcn = A.DeformableConv(8, 16)
    sddh = A.SDDH(128, 128)
    for layer in (dcn.offset, sddh.offset):
        assert not layer.weight.any() and not layer.bias.any()
    assert abs(float(sddh.agg.std()) - 0.02) < 0.001 and abs(float(sddh.agg.mean())) < 1e-3
    assert dcn.mix.weight.abs().max() <= 2 / 72 ** 0.5 / 0.8796 + 1e-6  # lecun_normal


# --- JPLDD from its blobs at full width ------------------------------------------------

def _scene(seed, size=(200, 150)):
    img = generate_structured_scene(np.random.default_rng(seed), size, max_points=4)[0]
    return np.repeat(img.astype(np.float32), 3, axis=-1)[None]


def _jpldd_pair(conf, blob, image):
    """The port's JPLDD (strictly loaded, inside a pipeline where the blob is
    a pipeline's) and JAX's, on ``image``."""
    path = ROOT_PATH / JPLDD_WEIGHTS[blob]
    h, w = image.shape[1:3]
    data = {"image": image, "image_size": np.float32([[w, h]])}
    pipeline_blob = blob.endswith("desc") or blob.endswith("descB")
    if pipeline_blob:
        model = build_model("two_view_pipeline", {"extractor": {"name": JPLDD, **conf}},
                            device="cpu")
        load_blob_into(model, path)
        model = model.extractor
    else:
        model = build_model(JPLDD, conf, device="cpu")
        load_blob_into(model, path)
    with torch.inference_mode():
        ours = model({k: _t(v) for k, v in data.items()})
    jmodel, flat = jax_load_model(Config({"name": JPLDD, **conf}), str(path))
    jdata = {k: jnp.asarray(v) for k, v in data.items()}
    params = restore_params(jax.jit(jmodel.init)(jax.random.key(0), jdata), flat)
    ref = jax.jit(jmodel.apply)(params, jdata)
    return {k: v.numpy() for k, v in ours.items()}, {k: np.asarray(v) for k, v in ref.items()}


CASES = {  # the benchmark confs' extractors, at fewer keypoints
    "structured_descB": {"max_num_keypoints": 256, "detection_threshold": 0.005,
                         "extract_lines": True, "line_desc_samples": 8, "input_channels": 3},
    "stage0": {"max_num_keypoints": 256, "detection_threshold": 0.003, "extract_lines": True,
               "line_extractor": {"fine_inlier_ratio": 0.85, "coarse_inlier_ratio": 0.8,
                                  "mean_df_th": 2.0, "df_inlier_th": 2.5,
                                  "use_angle_field": True}},
}


@pytest.mark.parametrize("blob", sorted(CASES))
def test_jpldd_from_its_blob_is_jaxs(blob):
    ours, ref = _jpldd_pair(CASES[blob], blob, _scene(3))
    assert ours.keys() == ref.keys()
    for key in ("heatmap", "heatmap_logits", "distance_field_norm", "angle_field_sincos",
                "keypoint_scores", "descriptors"):
        np.testing.assert_allclose(ours[key], ref[key], atol=HEAD_TOL, rtol=0, err_msg=key)
    scale = np.abs(ref["backbone_features"]).max()
    np.testing.assert_allclose(ours["backbone_features"] / scale, ref["backbone_features"] / scale,
                               atol=HEAD_TOL, rtol=0)
    np.testing.assert_allclose(ours["distance_field"], ref["distance_field"], atol=5 * HEAD_TOL,
                               rtol=0)
    norm = np.linalg.norm(ref["angle_field_sincos"], axis=-1)
    diff = np.abs(ours["angle_field"] - ref["angle_field"])
    diff = np.minimum(diff, np.pi - diff)  # mod pi
    assert (diff * norm).max() <= HEAD_TOL, (diff * norm).max()
    np.testing.assert_allclose(ours["keypoints"], ref["keypoints"], atol=KP_TOL, rtol=0)
    np.testing.assert_array_equal(ours["keypoint_valid"], ref["keypoint_valid"])
    np.testing.assert_array_equal(ours["valid_lines"], ref["valid_lines"])
    assert ours["valid_lines"].sum() >= 5
    np.testing.assert_allclose(ours["lines"], ref["lines"], atol=KP_TOL, rtol=0)
    np.testing.assert_allclose(ours["line_scores"], ref["line_scores"], atol=KP_TOL, rtol=0)
    if "line_desc_samples" in ref:
        np.testing.assert_allclose(ours["line_desc_samples"], ref["line_desc_samples"],
                                   atol=HEAD_TOL, rtol=0)


@pytest.mark.parametrize("blob", sorted(JPLDD_WEIGHTS))
def test_each_blob_loads_strictly(blob):
    """Every key of each blob is placed once, every parameter filled: the
    phase-A blobs into JPLDD, the phase-B ones into a pipeline's extractor."""
    conf = {"name": JPLDD, "input_channels": 3}
    if blob.endswith("desc") or blob.endswith("descB"):
        model = build_model("two_view_pipeline", {"extractor": conf}, device="cpu")
    else:
        model = build_model(JPLDD, conf, device="cpu")
    model_conf, meta = load_blob_into(model, ROOT_PATH / JPLDD_WEIGHTS[blob])
    assert len(model.state_dict()) == 57 and meta["iteration"] > 0


# --- POLD2 and the NN point-line matcher ------------------------------------------------

def _line_field(segs, h, w):
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    p = np.stack([xs, ys], -1)[:, :, None]
    a, b = segs[:, 0], segs[:, 1]
    ab = b - a
    t = np.clip(((p - a) * ab).sum(-1) / (ab * ab).sum(-1), 0, 1)
    return np.linalg.norm(p - (a + t[..., None] * ab), axis=-1).min(-1).astype(np.float32)


@pytest.mark.parametrize("nms", [True, False])
def test_pold2_with_length_ties_is_jaxs(nms):
    """A grid of keypoints on horizontal and vertical lines: many candidates
    of exactly equal length compete for fewer slots (``max_num_lines`` 12),
    so the slots follow the stable sort's pair order."""
    xs, ys = np.meshgrid(np.arange(10, 90, 20), np.arange(10, 70, 20))
    kpts = np.stack([xs, ys], -1).reshape(1, -1, 2).astype(np.float32)
    segs = np.array([[[10, y], [70, y]] for y in (10, 30, 50)]
                    + [[[x, 10], [x, 50]] for x in (10, 30, 50, 70)], np.float32)
    df = _line_field(segs, 64, 96)[None]
    valid = np.ones(kpts.shape[:2], bool)
    valid[0, 5] = False
    conf = {"max_num_lines": 12, "collinear_nms": nms, "min_length": 8.0}
    data = {"keypoints": kpts, "keypoint_valid": valid, "distance_field": df}
    ours = build_model("lines.pold2_extractor", conf, device="cpu")({k: _t(v) for k, v in data.items()})
    jmodel = jax_build_model("lines.pold2_extractor", Config(conf))
    jdata = {k: jnp.asarray(v) for k, v in data.items()}
    ref = jmodel.apply(jmodel.init(jax.random.key(0), jdata), jdata)
    lengths = np.linalg.norm(np.asarray(ref["lines"])[0, :, 1] - np.asarray(ref["lines"])[0, :, 0], axis=-1)
    assert len(set(lengths[:12].tolist())) < 12  # ties among the kept slots
    for key in ("lines", "line_scores", "valid_lines"):
        np.testing.assert_array_equal(ours[key].numpy(), np.asarray(ref[key]), err_msg=key)
    assert int(ours["valid_lines"].sum()) >= (3 if nms else 12)


@pytest.mark.parametrize("dense", [True, False])
def test_nn_point_line_is_jaxs(dense):
    rng = np.random.default_rng(4)

    def unit(*shape):
        d = rng.normal(size=shape).astype(np.float32)
        return d / np.linalg.norm(d, axis=-1, keepdims=True)

    data = {"descriptors0": unit(2, 30, 16), "descriptors1": unit(2, 25, 16),
            "keypoint_valid0": rng.uniform(size=(2, 30)) > 0.2,
            "keypoint_valid1": rng.uniform(size=(2, 25)) > 0.2}
    data["descriptors1"][:, :20] = data["descriptors0"][:, :20] + 0.1 * unit(2, 20, 16)
    if dense:
        lines = rng.uniform(0, 40, (2, 2, 12, 2, 2)).astype(np.float32)
        dmap = rng.normal(size=(2, 2, 32, 48, 16)).astype(np.float32)
        for i in "01":
            data[f"lines{i}"], data[f"descriptors_dense{i}"] = lines[int(i)], dmap[int(i)]
            data[f"valid_lines{i}"] = rng.uniform(size=(2, 12)) > 0.2
        data["lines1"][:, :6], data["descriptors_dense1"] = data["lines0"][:, :6, ::-1], dmap[0]
    ours = build_model("matchers.nn_point_line", {}, device="cpu")({k: _t(v) for k, v in data.items()})
    jmodel = jax_build_model("matchers.nn_point_line", Config({}))
    jdata = {k: jnp.asarray(v) for k, v in data.items()}
    ref = jmodel.apply(jmodel.init(jax.random.key(0), jdata), jdata)
    assert ours.keys() == ref.keys() and (("line_matches0" in ours) == dense)
    for key in ours:
        np.testing.assert_allclose(ours[key].numpy(), np.asarray(ref[key]), atol=1e-6, rtol=0,
                                   err_msg=key)
    assert (ours["matches0"] >= 0).sum() > 10
    if dense:
        assert (ours["line_matches0"] >= 0).sum() >= 4



@pytest.mark.parametrize("bench,conf", [("hpatches_extended", "jpldd_structured_descB"),
                                        ("hpatches_lines", "jpldd_structured_descB_wunsch")])
def test_benchmark_clis_take_jpldd_confs_by_name(bench, conf, tmp_path, monkeypatch):
    """Each benchmark's CLI runs a committed JPLDD conf by name from its blob,
    on one rendered sequence at 160 pixels: lines, and line matches where the
    matcher makes them (Wunsch on SDDH's samples; the NN point-line matcher
    matches no JPLDD line, JPLDD having no dense descriptors)."""
    import importlib

    from gluefactory_torch.scripts.generate_eval_set import render_sequence

    render_sequence(tmp_path / "set" / "v_cli", np.random.default_rng((616161, 0)), (240, 180),
                    "a")
    module = importlib.import_module(f"gluefactory_torch.eval.{bench}")
    monkeypatch.setattr(importlib.import_module("gluefactory_torch.eval.hpatches_lines"),
                        "EVAL_PATH", tmp_path / "out")
    summaries = module.main(["--conf", conf, "--device", "cpu", "--tag", "t",
                             f"data.data_dir={tmp_path / 'set'}",
                             "data.preprocessing.resize=160"])
    with np.load(tmp_path / "out" / bench / "t" / "predictions.npz") as f:
        assert {"lines0", "valid_lines0"} <= set(f.files) and f["valid_lines0"].sum() > 0
        assert ("line_matches0" in f.files) == (bench == "hpatches_lines")
    key = "mkp_repeatability" if bench == "hpatches_extended" else "mnum_line_matches"
    assert summaries[key] > 0

if __name__ == "__main__":
    import argparse
    import json
    from pathlib import Path

    parser = argparse.ArgumentParser(
        description="chip_smoke.py phase 21's reference numbers: the JAX package's summaries "
                    "(or the port's on the CPU) of its JPLDD runs on phase 8's famA rendered "
                    "under --root/hpatches, one JSON line a (run, RANSAC seed)")
    parser.add_argument("--root", type=Path, required=True)
    parser.add_argument("--out", type=Path, required=True)
    parser.add_argument("--side", choices=("jax", "port"), default="jax")
    parser.add_argument("--runs", nargs="*")
    parser.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    args = parser.parse_args()
    import chip_smoke_jpldd as CJ
    import test_torch_line_metrics as LM
    import test_torch_lines_eval as LE

    if args.side == "jax":
        jax.config.update("jax_platforms", "cpu")
    for run, bench, name, which in CJ.JPLDD_EXT_RUNS:
        if not args.runs or run in args.runs:
            conf = CJ.run_conf(args.root, bench, name, which)
            for row in LE.reference(args.side, run, bench, conf, args.out, args.seeds):
                print(json.dumps(row), flush=True)
    lines = [r for r in CJ.JPLDD_LINE_RUNS if not args.runs or r[0] in args.runs]
    if lines:
        LM.reference(args.side, args.root, args.out, [r[0] for r in lines], args.seeds,
                     table=lines)
