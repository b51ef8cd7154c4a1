"""SuperGlue and its Sinkhorn assignment, in the port against the JAX package
on the CPU: ``log_optimal_transport`` with ragged masks, SuperGlue with the
JAX initialisation carried over, SuperGlue from ``weights/sg_sift_stage1``
fed OpenCV's RootSIFT features of two rendered images, and SIFT+SuperGlue end
to end on one rendered pair against the JAX pipeline.

Run as a script, it prints the JAX package's HPatches summaries of a
committed benchmark conf on sets rendered by the port, the numbers
``chip_smoke.py`` phase 15 holds the port to, one JSON object a set:

    JAX_PLATFORMS=cpu PYTHONPATH=. GFTPU_EVAL_PATH=/tmp/jax_eval \\
        python tests/test_torch_superglue.py --conf sift_sg_stage1 \\
        --sets famA=/abs/famA famB=/abs/famB [--max_seqs 8] [--seed N --reuse]

``--conf`` names a folder of ``outputs/results/hpatches`` (its
``conf.yaml``); the sets are rendered as phase 8 renders them
(``chip_smoke.render_sets``: ``gluefactory_torch.scripts.generate_eval_set``
at 640x480, famA 20 sequences, famB 20 and 10 illumination sequences);
RANSAC seed 0."""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gluefactory_torch.models import build_model
from gluefactory_torch.ops.assignment import log_optimal_transport
from gluefactory_torch.recipes import SG_SIFT_WEIGHTS, gate_conf
from gluefactory_torch.scripts.generate_eval_set import render_sequence
from gluefactory_torch.utils.image import read_image
from gluefactory_torch.utils.weights import load_blob_into, load_state_strict, params_from_flat
from gluefactory_tpu.models import build_model as jax_build_model
from gluefactory_tpu.models.extractors.sift import detect_sift_np
from gluefactory_tpu.ops.assignment import log_optimal_transport as jax_log_optimal_transport
from gluefactory_tpu.scripts.export_weights import load_weight_blob
from gluefactory_tpu.utils.experiments import restore_from_flat_dict, state_to_flat_dict

torch.set_num_threads(2)

# |port - JAX| <= TOL (1 + |JAX|) on the log-assignment's valid rows and columns
# (dustbins included): float32 logsumexp sums in another order
OT_TOL = 1e-5
# SuperGlue: trained weights give log-probabilities of tens, where float32
# resolves ~1e-6, through 9 layers and 50 Sinkhorn steps
LOG_ASSIGNMENT_TOL = 1e-4
SCORE_ATOL = 1e-4  # matching scores (probabilities)
MATCH_SHARE = 0.999  # slots whose matches0 must agree
# SIFT+SuperGlue end to end: JAX's matches the port also makes (measured: 1.0
# with the grey image as XLA fuses it), and the match counts within 2%
END_TO_END_SHARE = 0.98


def _ragged(rng, b, n):
    valid = rng.uniform(size=(b, n)) > 0.25
    valid[0, n // 3:] = False  # one item mostly padding
    return valid


def _valid_region(z, mask0, mask1):
    """The entries of a (B, N+1, M+1) log-assignment on valid rows and
    columns, the dustbins included."""
    b = z.shape[0]
    rows = np.concatenate([mask0, np.ones((b, 1), bool)], 1)
    cols = np.concatenate([mask1, np.ones((b, 1), bool)], 1)
    return z[rows[:, :, None] & cols[:, None, :]]


@pytest.mark.parametrize("iters", [3, 50])
@pytest.mark.parametrize("masks", [True, False])
def test_log_optimal_transport_matches_jax(iters, masks):
    rng = np.random.default_rng(iters + masks)
    b, n, m = 3, 70, 55
    sim = rng.normal(size=(b, n, m)).astype(np.float32) * 3
    mask0 = _ragged(rng, b, n) if masks else np.ones((b, n), bool)
    mask1 = _ragged(rng, b, m)[::-1].copy() if masks else np.ones((b, m), bool)
    bin_score = np.float32(0.7)
    ref = np.asarray(jax_log_optimal_transport(jnp.asarray(sim), jnp.asarray(bin_score), iters,
                                               jnp.asarray(mask0), jnp.asarray(mask1)))
    ours = log_optimal_transport(torch.from_numpy(sim), torch.tensor(bin_score), iters,
                                 torch.from_numpy(mask0), torch.from_numpy(mask1)).numpy()
    ref_v, ours_v = _valid_region(ref, mask0, mask1), _valid_region(ours, mask0, mask1)
    assert np.isfinite(ours_v).all()
    np.testing.assert_allclose(ours_v, ref_v, atol=OT_TOL, rtol=OT_TOL)
    # padded slots are held at about NEG_INF in both
    assert ((ours <= -1e29) == (ref <= -1e29)).all()


def _matcher_data(seed, b=2, n=96, m=80, d=32):
    rng = np.random.default_rng(seed)
    return {
        "keypoints0": rng.uniform(0, 320, (b, n, 2)).astype(np.float32),
        "keypoints1": rng.uniform(0, 320, (b, m, 2)).astype(np.float32),
        "keypoint_scores0": rng.uniform(size=(b, n)).astype(np.float32),
        "keypoint_scores1": rng.uniform(size=(b, m)).astype(np.float32),
        "descriptors0": rng.normal(size=(b, n, d)).astype(np.float32),
        "descriptors1": rng.normal(size=(b, m, d)).astype(np.float32),
        "keypoint_valid0": _ragged(rng, b, n), "keypoint_valid1": _ragged(rng, b, m),
        "view0": {"image_size": np.full((b, 2), 320.0, np.float32)},
        "view1": {"image_size": np.tile(np.float32([[320.0, 240.0]]), (b, 1))},
    }


def _close_assignment(ours, ref, mask0, mask1):
    o, r = _valid_region(ours, mask0, mask1), _valid_region(ref, mask0, mask1)
    assert np.isfinite(o).all()
    np.testing.assert_allclose(o, r, atol=LOG_ASSIGNMENT_TOL, rtol=LOG_ASSIGNMENT_TOL)


@pytest.mark.parametrize("norm", ["layer", "none"])
@pytest.mark.parametrize("attention", ["xla", "auto"])
def test_superglue_matches_jax_with_flax_init(norm, attention):
    """2 layers from the JAX initialisation carried over as numpy (the
    'auto' path is the plain one on the CPU, through the kernel's wrapper)."""
    conf = {"input_dim": 32, "descriptor_dim": 64, "num_heads": 4, "n_layers": 2,
            "sinkhorn_iterations": 20, "filter_threshold": 0.0, "norm": norm}
    data = _matcher_data(len(norm))
    jdata = jax.tree.map(jnp.asarray, data)
    jmodel = jax_build_model("matchers.superglue", conf)
    params = jax.jit(jmodel.init)(jax.random.key(0), jdata)
    jpred = jax.tree.map(np.asarray, dict(jax.jit(jmodel.apply)(params, jdata)))
    model = build_model("matchers.superglue", {**conf, "attention": attention}, device="cpu")
    load_state_strict(model, params_from_flat(state_to_flat_dict(params)))
    with torch.inference_mode():
        tpred = {k: v.numpy() for k, v in model(jax.tree.map(torch.from_numpy, data)).items()}
    _close_assignment(tpred["log_assignment"], jpred["log_assignment"],
                      data["keypoint_valid0"], data["keypoint_valid1"])
    for key in ("matches0", "matches1"):
        np.testing.assert_array_equal(tpred[key], jpred[key])
    assert (tpred["matches0"] > -1).sum() > 20
    np.testing.assert_allclose(tpred["matching_scores0"], jpred["matching_scores0"],
                               atol=SCORE_ATOL, rtol=0)


def test_torch_weight_converter_matches_jax():
    """The port's converter of an official checkpoint (a random state dict of
    its layout, BatchNorms with non-trivial statistics) against the JAX
    package's: the same parameters, and the same forward with ``norm:
    'none'`` within 1e-5."""
    from gluefactory_torch.models.matchers.superglue import torch_weight_converter
    from gluefactory_tpu.models.matchers.superglue import (
        torch_weight_converter as jax_torch_weight_converter,
    )
    from test_weight_converters import _rand_state_superglue

    torch.manual_seed(0)
    official = _rand_state_superglue(d=64, h=4, L=2)
    conf = {"input_dim": 64, "descriptor_dim": 64, "num_heads": 4, "n_layers": 2,
            "sinkhorn_iterations": 20, "filter_threshold": 0.0, "norm": "none"}
    jparams = jax.tree.map(jnp.asarray, jax_torch_weight_converter(official, conf))
    state = torch_weight_converter(official, conf)
    expected = params_from_flat(state_to_flat_dict(jparams))
    assert state.keys() == expected.keys()
    for name, value in expected.items():
        assert state[name].dtype == value.dtype and torch.equal(state[name], value), name
    model = build_model("matchers.superglue", conf, device="cpu")
    load_state_strict(model, state)
    data = _matcher_data(5, d=64)
    jpred = jax.tree.map(np.asarray, dict(jax.jit(jax_build_model("matchers.superglue",
                                                                  conf).apply)(
        jparams, jax.tree.map(jnp.asarray, data))))
    with torch.inference_mode():
        tpred = {k: v.numpy() for k, v in model(jax.tree.map(torch.from_numpy, data)).items()}
    o, r = (_valid_region(x, data["keypoint_valid0"], data["keypoint_valid1"])
            for x in (tpred["log_assignment"], jpred["log_assignment"]))
    np.testing.assert_allclose(o, r, atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(tpred["matches0"], jpred["matches0"])


@pytest.fixture(scope="module")
def gate_pair(tmp_path_factory):
    """The JAX gate's first pair (sequence (424242, 0), views 1 and 2),
    rendered by the port: two (360, 480, 3) float images and H_0to1."""
    seq = tmp_path_factory.mktemp("sg") / "v_qa0"
    render_sequence(seq, np.random.default_rng((424242, 0)), (480, 360), family="a")
    load = (lambda p: read_image(p).astype(np.float32) / 255.0)
    return load(seq / "1.ppm"), load(seq / "2.ppm"), np.loadtxt(seq / "H_1_2").astype(np.float32)


def _sift_features(image, k=1024):
    gray = np.clip((image * np.float32([0.299, 0.587, 0.114])).sum(-1) * 255, 0, 255)
    pts, scales, oris, scores, descs, valid = detect_sift_np(gray.astype(np.uint8), k, 0.02, True)
    return pts, scores, descs, valid


def test_superglue_blob_on_opencv_features(gate_pair):
    """sg_sift_stage1 (9 layers, Sinkhorn 50) fed the same OpenCV RootSIFT
    features in both packages."""
    f0, f1 = _sift_features(gate_pair[0]), _sift_features(gate_pair[1])
    data = {"keypoints0": f0[0][None], "keypoint_scores0": f0[1][None],
            "descriptors0": f0[2][None], "keypoint_valid0": f0[3][None],
            "keypoints1": f1[0][None], "keypoint_scores1": f1[1][None],
            "descriptors1": f1[2][None], "keypoint_valid1": f1[3][None],
            "view0": {"image_size": np.float32([[480.0, 360.0]])},
            "view1": {"image_size": np.float32([[480.0, 360.0]])}}
    conf, _ = gate_conf("sift_superglue")
    jdata = jax.tree.map(jnp.asarray, data)
    jmodel = jax_build_model("matchers.superglue", conf["matcher"])
    flat, _, _ = load_weight_blob(SG_SIFT_WEIGHTS)
    params = restore_from_flat_dict(jax.eval_shape(jmodel.init, jax.random.key(0), jdata),
                                    {k.replace("['matcher']", ""): v for k, v in flat.items()})
    jpred = jax.tree.map(np.asarray, dict(jax.jit(jmodel.apply)(params, jdata)))
    model = build_model("two_view_pipeline", {"matcher": conf["matcher"]}, device="cpu")
    load_blob_into(model, SG_SIFT_WEIGHTS)
    with torch.inference_mode():
        tpred = {k: v.numpy() for k, v in
                 model.matcher(jax.tree.map(torch.from_numpy, data)).items()}
    agree = (tpred["matches0"] == jpred["matches0"]).mean()
    assert agree >= MATCH_SHARE, agree
    assert (jpred["matches0"] > -1).sum() > 60
    np.testing.assert_allclose(tpred["matching_scores0"], jpred["matching_scores0"],
                               atol=SCORE_ATOL, rtol=0)
    _close_assignment(tpred["log_assignment"], jpred["log_assignment"],
                      data["keypoint_valid0"], data["keypoint_valid1"])


def test_sift_superglue_end_to_end(gate_pair):
    """The JAX gate's SIFT+SuperGlue pipeline on one pair, the port's SIFT
    and SuperGlue against OpenCV's SIFT and the JAX SuperGlue: the same
    matched keypoint pairs (99%) and the same gate readings' bounds."""
    img0, img1, H = gate_pair
    conf, blob = gate_conf("sift_superglue")
    size = np.float32([[480.0, 360.0]])
    data = {"view0": {"image": img0[None], "image_size": size},
            "view1": {"image": img1[None], "image_size": size}}
    jdata = jax.tree.map(jnp.asarray, data)
    jmodel = jax_build_model("two_view_pipeline", conf)
    flat, _, _ = load_weight_blob(blob)
    params = restore_from_flat_dict(jax.eval_shape(jmodel.init, jax.random.key(0), jdata),
                                    flat)  # the blob holds every parameter
    jpred = jax.tree.map(np.asarray, dict(jax.jit(jmodel.apply)(params, jdata)))
    model = build_model("two_view_pipeline", conf, device="cpu")
    load_blob_into(model, blob)
    with torch.inference_mode():
        tpred = {k: v.numpy() for k, v in model(jax.tree.map(torch.from_numpy, data)).items()}
    for i in "01":
        assert tpred[f"keypoint_valid{i}"].sum() == jpred[f"keypoint_valid{i}"].sum()

    def pairs(pred):
        m0 = pred["matches0"][0]
        idx = np.nonzero(m0 > -1)[0]
        return np.concatenate([pred["keypoints0"][0][idx], pred["keypoints1"][0][m0[idx]]], 1)

    ours, ref = pairs(tpred), pairs(jpred)
    # each of JAX's matches among the port's, both keypoints within 0.05 px
    found = (np.abs(ref[:, None] - ours[None]).max(-1) < 0.05).any(1)
    assert len(ref) > 60 and abs(len(ours) - len(ref)) <= 0.02 * len(ref), (len(ours), len(ref))
    assert found.mean() >= END_TO_END_SHARE, found.mean()


def test_sift_lightglue_model_card_end_to_end(gate_pair):
    """``sift+lightglue.yaml`` (SIFT with 2048 slots, LightGlue with
    ``add_scale_ori``) cut to 2 layers from the JAX initialisation, every
    mutual match kept, on one gate pair against the JAX pipeline: the same keypoint counts, and JAX's
    matched keypoint pairs among the port's (END_TO_END_SHARE; slots of
    keypoints that tie in response may be ordered either way, which the
    matcher does not see)."""
    from gluefactory_torch.recipes import sift_lightglue_conf

    conf = sift_lightglue_conf()["model"]
    conf["matcher"].update(n_layers=2, attention="xla", filter_threshold=0.0)  # untrained
    img0, img1, _ = gate_pair
    size = np.float32([[480.0, 360.0]])
    data = {"view0": {"image": img0[None], "image_size": size},
            "view1": {"image": img1[None], "image_size": size}}
    jdata = jax.tree.map(jnp.asarray, data)
    jmodel = jax_build_model("two_view_pipeline", conf)
    params = jax.jit(jmodel.init)(jax.random.key(0), jdata)
    jpred = jax.tree.map(np.asarray, dict(jax.jit(jmodel.apply)(params, jdata)))
    model = build_model("two_view_pipeline", conf, device="cpu")
    load_state_strict(model, params_from_flat(state_to_flat_dict(params), {"matcher": 4}))
    assert model.matcher.posenc.Wr.weight.shape == (32, 4)
    with torch.inference_mode():
        tpred = {k: v.numpy() for k, v in model(jax.tree.map(torch.from_numpy, data)).items()}
    for i in "01":
        assert tpred[f"keypoint_valid{i}"].sum() == jpred[f"keypoint_valid{i}"].sum() > 100

    def pairs(pred):
        m0 = pred["matches0"][0]
        idx = np.nonzero(m0 > -1)[0]
        return np.concatenate([pred["keypoints0"][0][idx], pred["keypoints1"][0][m0[idx]]], 1)

    ours, ref = pairs(tpred), pairs(jpred)
    found = (np.abs(ref[:, None] - ours[None]).max(-1) < 0.05).any(1)
    assert len(ref) > 20 and abs(len(ours) - len(ref)) <= 0.02 * len(ref), (len(ours), len(ref))
    assert found.mean() >= END_TO_END_SHARE, found.mean()


def jax_hpatches_reference(conf_name: str, name: str, data_dir: str, max_seqs=None,
                           seed: int = 0, reuse: bool = False) -> dict:
    """The JAX HPatches pipeline with the conf of
    ``outputs/results/hpatches/<conf_name>`` on one set; ``reuse`` scores the
    predictions of an earlier run again (another RANSAC seed)."""
    from gluefactory_tpu.core.config import Config
    from gluefactory_tpu.eval.hpatches import HPatchesPipeline
    from gluefactory_tpu.settings import EVAL_PATH
    from gluefactory_torch.settings import ROOT_PATH

    conf = Config(HPatchesPipeline.default_conf).merge(
        Config.load(ROOT_PATH / "outputs/results/hpatches" / conf_name / "conf.yaml")).merge(
        {"data": {"data_dir": data_dir, "max_seqs": max_seqs}, "eval": {"seed": seed}})
    out = EVAL_PATH / "hpatches" / f"{conf_name}_{name}"
    again = reuse and (out / "predictions.h5").exists()
    summaries, _ = HPatchesPipeline(conf).run(out, overwrite=not again, overwrite_eval=again)
    keys = ("H_error_ransac_mAA", "mprec@1px", "mnum_keypoints", "mnum_matches")
    return {"conf": conf_name, "set": name, "max_seqs": max_seqs, "seed": seed,
            "summaries": {k: summaries[k] for k in keys}}


if __name__ == "__main__":
    import argparse
    import json

    parser = argparse.ArgumentParser()
    parser.add_argument("--conf", required=True)
    parser.add_argument("--sets", nargs="+", required=True, help="name=/abs/set_dir")
    parser.add_argument("--max_seqs", type=int, default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--reuse", action="store_true",
                        help="score the predictions of an earlier run with --seed")
    args = parser.parse_args()
    for spec in args.sets:
        print(json.dumps(jax_hpatches_reference(args.conf, *spec.split("=", 1),
                                                max_seqs=args.max_seqs, seed=args.seed,
                                                reuse=args.reuse)), flush=True)
