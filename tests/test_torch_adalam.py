"""AdaLAM (gluefactory_torch/models/matchers/adalam.py) against the JAX
package's on the same inputs, with JAX's hypothesis draws fed in."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gluefactory_torch.models import build_model
from gluefactory_torch.models.matchers.adalam import AdaLAM, draw_hypotheses
from gluefactory_tpu.models import build_model as jax_build_model

torch.set_num_threads(2)


def putative_matches(seed: int, b: int = 2, n: int = 240, m: int = 260, outliers: float = 0.4):
    """Matches of two views related by a smooth non-affine warp, a share of
    them replaced by random targets; some slots unmatched. Numpy inputs of
    the filter slot."""
    rng = np.random.default_rng(seed)
    kp0 = rng.uniform(0, 640, (b, n, 2))
    kp1 = rng.uniform(0, 640, (b, m, 2))
    m0 = np.full((b, n), -1, np.int64)
    for i in range(b):
        tgt = rng.permutation(m)[:n]
        x, y = kp0[i, :, 0], kp0[i, :, 1]
        warped = np.stack([x * 1.03 + 0.02 * y + 12 + 8 * np.sin(y / 90),
                           y * 0.98 - 0.03 * x + 7 + 6 * np.cos(x / 110)], -1)
        warped += rng.normal(0, 0.8, warped.shape)
        bad = rng.uniform(size=n) < outliers
        warped[bad] = rng.uniform(0, 640, (bad.sum(), 2))
        kp1[i, tgt] = warped
        m0[i] = np.where(rng.uniform(size=n) < 0.9, tgt, -1)
    m1 = np.full((b, m), -1, np.int64)
    for i in range(b):
        sel = m0[i] >= 0
        m1[i, m0[i, sel]] = np.nonzero(sel)[0]
    scores = rng.uniform(0.1, 1.0, (b, n)) * (m0 >= 0)
    return {"keypoints0": kp0.astype(np.float32), "keypoints1": kp1.astype(np.float32),
            "matches0": m0.astype(np.int32), "matches1": m1.astype(np.int32),
            "matching_scores0": scores.astype(np.float32),
            "matching_scores1": (m1 >= 0).astype(np.float32),
            "view0": {"image_size": np.full((b, 2), 640.0, np.float32)}}


def jax_draws(data: dict, conf: dict, nb_ok: np.ndarray) -> np.ndarray:
    """JAX's hypothesis draws (gluefactory_tpu/models/matchers/adalam.py:125-132)
    on the neighbourhoods ``nb_ok``."""
    b, s, k = nb_ok.shape
    logits = jnp.where(jnp.asarray(nb_ok), 0.0, -1e9)
    return np.asarray(jax.random.categorical(
        jax.random.key(int(conf.get("seed", 0))), logits[:, :, None, None, :], axis=-1,
        shape=(b, s, int(conf.get("hypotheses", 16)), 3)))


def _neighbourhoods(model: AdaLAM, tdata: dict) -> np.ndarray:
    """The port's nb_ok, captured from its draw."""
    seen = {}

    def spy(nb_ok, hypotheses, seed):
        seen["nb_ok"] = nb_ok
        return draw_hypotheses(nb_ok, hypotheses, seed)

    import gluefactory_torch.models.matchers.adalam as mod
    orig, mod.draw_hypotheses = mod.draw_hypotheses, spy
    try:
        model(tdata)
    finally:
        mod.draw_hypotheses = orig
    return seen["nb_ok"].numpy()


@pytest.mark.parametrize("seed,conf", [
    (0, {}),
    (1, {"num_seeds": 16, "neighbors": 24, "hypotheses": 8, "min_inliers": 5, "seed": 3}),
    (2, {"r1": 0.1, "r2": 0.08, "inlier_th": 0.1}),
])
def test_adalam_matches_jax_with_its_draws(seed, conf):
    """Fed JAX's draws, the port keeps the same matches: the seeds, the keep
    mask, matches0/1, the scores and adalam_kept equal JAX's."""
    data = putative_matches(seed)
    tdata = jax.tree.map(torch.from_numpy, data)
    model = AdaLAM(conf)
    draws = jax_draws(data, conf, _neighbourhoods(model, tdata))
    pred = model({**tdata, "draws": torch.from_numpy(draws)})
    jdata = jax.tree.map(jnp.asarray, data)
    jmodel = jax_build_model("matchers.adalam", conf)
    jpred = jax.jit(jmodel.apply)(jax.jit(jmodel.init)(jax.random.key(0), jdata), jdata)
    for key in ("adalam_seeds", "adalam_kept", "matches0", "matches1"):
        np.testing.assert_array_equal(pred[key].numpy(), np.asarray(jpred[key]), err_msg=key)
    for key in ("matching_scores0", "matching_scores1"):
        np.testing.assert_array_equal(pred[key].numpy(), np.asarray(jpred[key]), err_msg=key)
    kept = pred["adalam_kept"].numpy()
    valid = (data["matches0"] >= 0).sum(-1)
    assert (kept > 0).all() and (kept < valid).all(), (kept, valid)


def test_adalam_own_draws_are_seeded_and_filter_outliers():
    """Without ``draws`` the port draws from its seeded generator: the same
    seed keeps the same matches, and the kept matches are mostly the true
    ones."""
    data = putative_matches(4, outliers=0.5)
    tdata = jax.tree.map(torch.from_numpy, data)
    model = build_model("matchers.adalam", {"seed": 7}, device="cpu")
    a, b = model(tdata), model(tdata)
    np.testing.assert_array_equal(a["matches0"].numpy(), b["matches0"].numpy())
    x, y = data["keypoints0"][..., 0], data["keypoints0"][..., 1]
    truth = np.stack([x * 1.03 + 0.02 * y + 12 + 8 * np.sin(y / 90),
                      y * 0.98 - 0.03 * x + 7 + 6 * np.cos(x / 110)], -1)
    m0 = a["matches0"].numpy()
    kept = m0 >= 0
    tgt = np.take_along_axis(data["keypoints1"], np.maximum(m0, 0)[..., None], 1)
    inlier = np.linalg.norm(tgt - truth, axis=-1) < 5
    assert inlier[kept].mean() > 0.95, inlier[kept].mean()
    before = inlier[data["matches0"] >= 0].mean()
    assert before < 0.6 and kept.sum() > 0.7 * (inlier & (data["matches0"] >= 0)).sum()


def jax_adalam_reference(data_dir: str, max_seqs: int, seed: int, reuse: bool = False) -> dict:
    """The JAX HPatches pipeline with the conf of
    ``outputs/results/hpatches/sift_nn_adalam`` on the set ``data_dir``, with
    ``seed`` as both AdaLAM's stream and RANSAC's; the mean ``adalam_kept`` is
    read from the predictions (every kept match is one of ``matches0``).
    ``reuse`` rescores the predictions of an earlier run of the same seed."""
    import h5py

    from gluefactory_tpu.core.config import Config
    from gluefactory_tpu.eval.hpatches import HPatchesPipeline
    from gluefactory_tpu.settings import EVAL_PATH
    from gluefactory_torch.settings import ROOT_PATH

    conf = Config(HPatchesPipeline.default_conf).merge(
        Config.load(ROOT_PATH / "outputs/results/hpatches/sift_nn_adalam/conf.yaml")).merge(
        {"data": {"data_dir": data_dir, "max_seqs": max_seqs},
         "model": {"filter": {"seed": seed}}, "eval": {"seed": seed}})
    out = EVAL_PATH / "hpatches" / f"sift_nn_adalam_seed{seed}"
    again = reuse and (out / "predictions.h5").exists()
    summaries, _ = HPatchesPipeline(conf).run(out, overwrite=not again, overwrite_eval=again)
    kept = []
    with h5py.File(out / "predictions.h5", "r") as f:
        f.visititems(lambda name, obj: kept.append(int((np.asarray(obj) > -1).sum()))
                     if name.endswith("/matches0") else None)
    keys = ("H_error_ransac_mAA", "mprec@1px", "mnum_keypoints", "mnum_matches")
    return {"seed": seed, "pairs": len(kept), "mean_adalam_kept": float(np.mean(kept)),
            "summaries": {k: summaries[k] for k in keys}}


if __name__ == "__main__":
    import argparse
    import json

    parser = argparse.ArgumentParser(
        description="the JAX package's sift_nn_adalam summaries on a set, for each seed")
    parser.add_argument("--set", required=True, help="an HPatches-layout set directory")
    parser.add_argument("--max_seqs", type=int, default=8)
    parser.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4])
    parser.add_argument("--reuse", action="store_true")
    args = parser.parse_args()
    for s in args.seeds:
        print(json.dumps(jax_adalam_reference(args.set, args.max_seqs, s, args.reuse)),
              flush=True)
