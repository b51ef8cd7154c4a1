"""Adaptive LightGlue (``depth_confidence``/``width_confidence`` > 0) of the
port against the JAX package on the CPU: a 3-layer LightGlue with the JAX
init carried over, in the cases of tests/test_adaptive_depth.py, and the
flagship's lg_tpu_stage2 matcher at 256 keypoints on one rendered pair.

Run as a script, it prints the JAX package's adaptive reference on HPatches
sets, the numbers ``chip_smoke.py`` phase 12 holds the port to (the
summaries, the histogram of exit layers over pairs, the mean pruned share),
one JSON object a set (~3 minutes for famA and famB on the CPU):

    JAX_PLATFORMS=cpu PYTHONPATH=. GFTPU_EVAL_PATH=/tmp/jax_eval \
        python tests/test_torch_adaptive.py \
        --sets famA=/abs/hpatches-a famB=/abs/hpatches-b

The sets are rendered by ``python -m gluefactory_tpu.scripts.generate_eval_set``
(famA with its defaults, famB with ``--family b --illum_seqs 10``); the conf
is ``outputs/results/hpatches/sp0b_lg2_com_refine/conf.yaml`` with the
adaptive card's 0.95 / 0.99, RANSAC seed 0."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gluefactory_tpu.models import build_model as jax_build_model
from gluefactory_tpu.scripts.export_weights import load_weight_blob
from gluefactory_tpu.scripts.generate_eval_set import render_sequence
from gluefactory_tpu.utils.experiments import restore_from_flat_dict, state_to_flat_dict
from gluefactory_tpu.utils.image import read_image
from gluefactory_torch.flagship import FLAGSHIP_WEIGHTS, flagship_conf
from gluefactory_torch.models import build_model
from gluefactory_torch.utils.weights import load_state_strict, params_from_flat

torch.set_num_threads(2)

BASE = dict(input_dim=32, descriptor_dim=32, n_layers=3, num_heads=2, flash=False,
            checkpointed=False, save_layer_outputs=False)
# |port - JAX| <= 1e-4 (1 + |JAX|): trained heads give log-probabilities of
# several hundred, where float32 resolves ~3e-5
LOG_ASSIGNMENT_TOL = 1e-4


def _data(seed=0, b=2, n=48, d=32):
    rng = np.random.default_rng(seed)
    valid = rng.uniform(size=(b, n)) > 0.15
    return {
        "keypoints0": rng.uniform(0, 128, (b, n, 2)).astype(np.float32),
        "keypoints1": rng.uniform(0, 128, (b, n, 2)).astype(np.float32),
        "descriptors0": rng.normal(size=(b, n, d)).astype(np.float32),
        "descriptors1": rng.normal(size=(b, n, d)).astype(np.float32),
        "keypoint_valid0": valid, "keypoint_valid1": valid[::-1].copy(),
        "view0": {"image_size": np.full((b, 2), 128.0, np.float32)},
        "view1": {"image_size": np.full((b, 2), 128.0, np.float32)},
    }


def _both(conf, data, params):
    """(JAX prediction, port prediction) of LightGlue ``conf`` with the JAX
    ``params`` on ``data``, as numpy."""
    jpred = jax_build_model("matchers.lightglue", conf).apply(
        params, jax.tree.map(jnp.asarray, data))
    model = build_model("matchers.lightglue", conf, device="cpu")
    load_state_strict(model, params_from_flat(state_to_flat_dict(params), {"": conf["num_heads"]}))
    with torch.inference_mode():
        tpred = model(jax.tree.map(torch.from_numpy, data))
    return (jax.tree.map(np.asarray, dict(jpred)),
            {k: v.numpy() for k, v in tpred.items()}, model)


def _init(data, seed=0):
    return jax_build_model("matchers.lightglue", BASE).init(
        jax.random.key(seed), jax.tree.map(jnp.asarray, data))


def _same_matches(jpred, tpred):
    assert int(tpred["exit_layer"]) == int(jpred["exit_layer"])
    np.testing.assert_array_equal(tpred["matches0"], jpred["matches0"])
    np.testing.assert_array_equal(tpred["matches1"], jpred["matches1"])
    finite = jpred["log_assignment"] > -1e29  # masked rows and columns are -inf-like
    np.testing.assert_array_equal(tpred["log_assignment"] > -1e29, finite)
    np.testing.assert_allclose(tpred["log_assignment"][finite], jpred["log_assignment"][finite],
                               atol=LOG_ASSIGNMENT_TOL, rtol=LOG_ASSIGNMENT_TOL)


def test_no_exit_equals_full_depth():
    """A depth threshold no share can pass exits at the last layer only: the
    port equals JAX and its own fixed-depth forward."""
    data = _data(0)
    params = _init(data)
    jpred, tpred, _ = _both(dict(BASE, depth_confidence=2.0), data, params)
    assert int(tpred["exit_layer"]) == BASE["n_layers"] - 1
    _same_matches(jpred, tpred)
    _, fixed, _ = _both(BASE, data, params)
    np.testing.assert_allclose(tpred["log_assignment"], fixed["log_assignment"], atol=1e-6)
    np.testing.assert_array_equal(tpred["matches0"], fixed["matches0"])


def test_exit_at_layer_0_scores_with_its_head():
    """A tiny depth threshold exits after layer 0, and layer 0's assignment
    head scores the matches: the port equals JAX and a 1-layer model of the
    same parameters."""
    data = _data(3)
    params = _init(data, seed=1)
    jpred, tpred, _ = _both(dict(BASE, depth_confidence=1e-6), data, params)
    assert int(tpred["exit_layer"]) == 0
    _same_matches(jpred, tpred)
    one = {"params": {k: v for k, v in params["params"].items()  # a 1-layer model has no
                      if k in ("input_proj", "posenc", "transformers_0", "log_assignment_0")}}
    _, trunc, _ = _both(dict(BASE, n_layers=1), data, one)
    np.testing.assert_allclose(tpred["log_assignment"], trunc["log_assignment"], atol=1e-6)


@pytest.mark.parametrize("depth", [-1, 0.9])
def test_width_pruning_masks_and_counters(depth):
    """Width pruning drops the same tokens as JAX (prune counters equal) and
    the matches follow. The heads are biased so that some tokens are
    confident and unmatchable: the token-confidence heads towards 1, the
    matchability head spread across 0.01."""
    data = _data(5)
    params = jax.tree.map(np.array, _init(data))
    p = params["params"]
    for i in range(BASE["n_layers"] - 1):
        p[f"token_confidence_{i}"]["token"]["bias"][:] = 3.0
        head = p[f"log_assignment_{i}"]["matchability"]
        head["kernel"] *= 8.0
        head["bias"][:] = -4.0
    conf = dict(BASE, width_confidence=0.99, depth_confidence=depth)
    jpred, tpred, _ = _both(conf, data, params)
    _same_matches(jpred, tpred)
    for i in "01":
        np.testing.assert_array_equal(tpred[f"prune{i}"], jpred[f"prune{i}"])
    # some tokens were pruned and some kept, at the first layer already
    first = tpred["prune0"] < 1 + min(int(tpred["exit_layer"]) + 1, BASE["n_layers"] - 1)
    assert 0 < (first & data["keypoint_valid0"]).sum() < data["keypoint_valid0"].sum()


def test_flagship_adaptive_matches_jax(tmp_path):
    """lg_tpu_stage2's 6-layer matcher with the adaptive card's 0.95 / 0.99 on
    JAX's SuperPoint keypoints (256) of one rendered pair: the same exit
    layer, prune counters and matches."""
    seq = tmp_path / "seq"
    render_sequence(seq, np.random.default_rng((424242, 1)), (480, 360), family="a")
    images = [read_image(seq / f"{k}.ppm").astype(np.float32)[None] / 255.0 for k in (1, 3)]
    size = np.array([[480.0, 360.0]], np.float32)
    conf = flagship_conf()
    conf.pop("filter")
    conf["extractor"]["max_num_keypoints"] = 256
    conf["matcher"].update(attention="xla", checkpointed=False, save_layer_outputs=False,
                           depth_confidence=0.95, width_confidence=0.99)
    data = {f"view{i}": {"image": jnp.asarray(img), "image_size": jnp.asarray(size)}
            for i, img in enumerate(images)}
    model = jax_build_model("two_view_pipeline", conf)
    flat, _, _ = load_weight_blob(FLAGSHIP_WEIGHTS)
    jpred = jax.tree.map(np.asarray, jax.jit(model.apply)(
        restore_from_flat_dict(model.init(jax.random.key(0), data), flat), data))
    matcher = build_model("matchers.lightglue", conf["matcher"], device="cpu")
    load_state_strict(matcher, params_from_flat(
        {k.replace("['matcher']", "", 1): v for k, v in flat.items() if "['matcher']" in k},
        {"": 4}))
    keys = ("keypoints", "descriptors", "keypoint_valid")
    tdata = {f"{k}{i}": torch.from_numpy(jpred[f"{k}{i}"].copy()) for k in keys for i in "01"}
    tdata.update({f"view{i}": {"image_size": torch.from_numpy(size)} for i in "01"})
    with torch.inference_mode():
        tpred = {k: v.numpy() for k, v in matcher(tdata).items()}
    _same_matches(jpred, tpred)
    for i in "01":
        np.testing.assert_array_equal(tpred[f"prune{i}"], jpred[f"prune{i}"])
    assert int(tpred["exit_layer"]) < 5  # the pair exits early


# --- the JAX package's reference for chip_smoke.py phase 12 ----------------------------

def pruned_share(pred: dict, n_layers: int) -> np.ndarray:
    """The share of each pair's valid keypoints (both views) that width
    pruning took out before the exit: a token never dropped counts
    1 + (the non-final layers that ran) in ``prune*``."""
    counted = np.minimum(np.asarray(pred["exit_layer"]) + 1, n_layers - 1)
    shares = []
    for b in range(pred["prune0"].shape[0]):
        dropped = valid = 0
        for i in "01":
            v = np.asarray(pred[f"keypoint_valid{i}"][b])
            dropped += int(((np.asarray(pred[f"prune{i}"][b]) < 1 + counted) & v).sum())
            valid += int(v.sum())
        shares.append(dropped / max(valid, 1))
    return np.asarray(shares, np.float32)


def jax_adaptive_reference(name: str, data_dir: str, seed: int = 0) -> dict:
    """The JAX HPatches pipeline with the adaptive card on one set, caching
    each pair's exit layer and pruned share beside its prediction."""
    import h5py

    from gluefactory_tpu.core.config import Config
    from gluefactory_tpu.eval.hpatches import HPatchesPipeline
    from gluefactory_tpu.eval.io import load_model, restore_params
    from gluefactory_tpu.settings import EVAL_PATH
    from gluefactory_tpu.train import filter_batch
    from gluefactory_tpu.utils.export_predictions import export_predictions
    from gluefactory_tpu.utils.tensor import map_tensor
    from gluefactory_torch.settings import ROOT_PATH

    class AdaptiveHPatches(HPatchesPipeline):
        def get_predictions(self, experiment_dir, model=None, params=None):
            pred_file = Path(experiment_dir) / "predictions.h5"
            model, params = load_model(Config(self.conf.model), self.conf.get("checkpoint"))
            n_layers = int(model.conf.matcher.n_layers)
            apply = jax.jit(model.apply)
            state = {}

            def apply_fn(batch):
                data = map_tensor(filter_batch(batch), jnp.asarray)
                if not state:
                    state["params"] = restore_params(model.init(jax.random.key(0), data),
                                                     params)
                pred = jax.device_get(dict(apply(state["params"], data)))
                b = pred["matches0"].shape[0]
                return {**pred, "exit_layer_b": np.full((b,), int(pred["exit_layer"]), np.int32),
                        "pruned_share": pruned_share(pred, n_layers)}

            export_predictions(self.get_dataloader(), apply_fn, pred_file,
                               keys=self.export_keys,
                               optional_keys=("keypoint_valid0", "keypoint_valid1",
                                              "exit_layer_b", "pruned_share"))
            return pred_file

    conf = Config(HPatchesPipeline.default_conf).merge(
        Config.load(ROOT_PATH / "outputs/results/hpatches/sp0b_lg2_com_refine/conf.yaml")).merge(
        {"model": {"matcher": {"depth_confidence": 0.95, "width_confidence": 0.99}},
         "data": {"data_dir": data_dir}, "eval": {"seed": seed}})
    out = EVAL_PATH / "hpatches" / f"adaptive_{name}"
    summaries, _ = AdaptiveHPatches(conf).run(out, overwrite=True)
    groups = []  # one group a pair, named <sequence>/<view>
    with h5py.File(out / "predictions.h5", "r") as f:
        f.visititems(lambda key, obj: groups.append(key)
                     if isinstance(obj, h5py.Group) and "exit_layer_b" in obj else None)
        exits = np.array([int(f[g]["exit_layer_b"][()]) for g in groups])
        pruned = np.array([float(f[g]["pruned_share"][()]) for g in groups])
    keys = ("H_error_ransac_mAA", "mprec@1px", "mnum_keypoints", "mnum_matches")
    return {"set": name, "summaries": {k: summaries[k] for k in keys},
            "exit_histogram": np.bincount(exits, minlength=conf.model.matcher.n_layers).tolist(),
            "mean_exit_layer": round(float(exits.mean()), 4),
            "mean_pruned_share": round(float(pruned.mean()), 4), "pairs": len(exits)}


if __name__ == "__main__":
    import argparse
    import json

    parser = argparse.ArgumentParser()
    parser.add_argument("--sets", nargs="+", required=True, help="name=/abs/set_dir")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    for spec in args.sets:
        print(json.dumps(jax_adaptive_reference(*spec.split("=", 1), seed=args.seed)), flush=True)
