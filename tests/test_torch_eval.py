"""The port's HPatches benchmark (gluefactory_torch.eval, datasets.hpatches)
against the JAX package's, on the CPU: the per-pair evaluation on fixed
predictions, the dataset's items, and both pipelines end to end on one
rendered sequence."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gluefactory_tpu.datasets.hpatches import HPatchesDataset as JaxHPatchesDataset
from gluefactory_tpu.eval import utils as jax_eval
from gluefactory_tpu.eval.eval_pipeline import load_eval as jax_load_eval
from gluefactory_tpu.eval.hpatches import HPatchesPipeline as JaxHPatchesPipeline
from gluefactory_tpu.scripts.generate_eval_set import render_sequence
from gluefactory_tpu.utils.tools import AUCMetric as JaxAUCMetric
from gluefactory_torch.core.config import merge
from gluefactory_torch.datasets.hpatches import HPatchesDataset
from gluefactory_torch.eval import utils as port_eval
from gluefactory_torch.eval.hpatches import HPatchesPipeline
from gluefactory_torch.recipes import hpatches_flagship_conf
from gluefactory_torch.settings import ROOT_PATH
from gluefactory_torch.utils.tools import AUCMetric

torch.set_num_threads(2)

H_GT = np.array([[1.05, 0.04, -12.0], [-0.03, 0.97, 8.0], [2e-4, -1e-4, 1.0]], np.float32)


def _predictions(seed: int, n: int = 96, outliers: float = 0.3):
    """Keypoints of view 0, their H_GT images with 0.4 px noise in view 1
    (shuffled), a share of wrong matches, some unmatched, some padded slots."""
    rng = np.random.default_rng(seed)
    kp0 = rng.uniform([0, 0], [480, 360], (n, 2)).astype(np.float32)
    h = np.concatenate([kp0, np.ones((n, 1), np.float32)], 1) @ H_GT.T
    kp1_true = h[:, :2] / h[:, 2:] + rng.normal(0, 0.4, (n, 2))
    perm = rng.permutation(n)
    kp1 = np.empty_like(kp1_true)
    kp1[perm] = kp1_true
    m0 = perm.copy()
    wrong = rng.uniform(size=n) < outliers
    m0[wrong] = rng.integers(0, n, wrong.sum())
    m0[rng.uniform(size=n) < 0.1] = -1
    valid0 = np.ones(n, bool)
    valid0[-5:] = False
    m0[-5:] = -1
    return {"keypoints0": kp0, "keypoints1": kp1.astype(np.float32),
            "matches0": m0.astype(np.int32),
            "matching_scores0": np.where(m0 > -1, rng.uniform(0.2, 1.0, n), 0).astype(
                np.float32),
            "keypoint_valid0": valid0}


DATA = {"H_0to1": H_GT, "view0": {"image_size": np.array([480.0, 360.0], np.float32)}}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pair_evaluation_matches_jax(seed):
    """Within 1e-5, but the DLT's corner error within 1e-3 px: its three IRLS
    passes each solve a float32 9x9 eigenproblem of A^T A, and the two
    libraries' eigensolvers differ in the last bits (measured: up to 4.4e-5
    px), as in the refiner's IRLS homography (tests/test_torch_flagship.py)."""
    pred = _predictions(seed)
    ours = port_eval.eval_matches_homography(DATA, pred, device="cpu")
    ours.update(port_eval.eval_homography_dlt(DATA, pred, device="cpu"))
    ref = jax_eval.eval_matches_homography(DATA, pred)
    ref.update(jax_eval.eval_homography_dlt(DATA, pred))
    assert ours.keys() == ref.keys()
    for key in ours:
        atol = 1e-3 if key == "H_error_dlt" else 1e-5
        np.testing.assert_allclose(ours[key], ref[key], rtol=1e-5, atol=atol, err_msg=key)


@pytest.mark.parametrize("th", [0.5, 3.0])
def test_robust_evaluation_matches_jax_with_its_minimal_sets(th):
    """RANSAC with the minimal sets that JAX draws (jax.random.categorical
    over the valid matches under the estimator's seed): the same inliers,
    and the corner error within 1e-3 px, as the DLT's above (its LO steps
    solve float32 eigenproblems too; measured: up to 1.4e-4 px)."""
    pred = _predictions(3, n=128)
    conf = {"estimator": "ransac", "ransac_th": th, "num_hypotheses": 256, "seed": 0}
    valid = pred["matches0"] > -1
    logits = jnp.where(jnp.asarray(valid), 0.0, -1e9)
    keys = jax.random.split(jax.random.key(conf["seed"]), conf["num_hypotheses"])
    sample_idx = np.asarray(jax.vmap(lambda k: jax.random.categorical(k, logits, shape=(4,)))(
        keys))
    ours = port_eval.eval_homography_robust(DATA, pred, conf, device="cpu",
                                            sample_idx=sample_idx)
    ref = jax_eval.eval_homography_robust(DATA, pred, conf)
    assert ours["ransac_inl"] == ref["ransac_inl"]
    np.testing.assert_allclose(ours["H_error_ransac"], ref["H_error_ransac"], rtol=1e-5,
                               atol=1e-3)


def test_line_predictions_are_refused():
    pred = {**_predictions(0), "lines0": np.zeros((4, 2, 2)), "line_matches0": np.zeros(4)}
    for fn in (port_eval.eval_matches_homography, port_eval.eval_homography_dlt):
        with pytest.raises(NotImplementedError):
            fn(DATA, pred, device="cpu")
    with pytest.raises(NotImplementedError):
        port_eval.eval_homography_robust(DATA, pred, {"ransac_th": 1.0}, device="cpu")


def test_auc_and_threshold_choice_match_jax():
    rng = np.random.default_rng(4)
    errs = np.concatenate([rng.exponential(1.2, 90), [np.inf, np.nan, 40.0]])
    assert np.allclose(AUCMetric([1, 3, 5], errs).compute(),
                       JaxAUCMetric([1, 3, 5], errs).compute(), rtol=1e-5, atol=1e-5)
    assert np.isnan(AUCMetric([1, 3, 5]).compute())
    pose_results = {th: [{"H_error_ransac": float(e)} for e in rng.exponential(th, 40)]
                    for th in (0.5, 1.0, 2.0)}
    pose_results[1.0][3]["H_error_ransac"] = np.nan
    assert (port_eval.eval_poses(pose_results, [1, 3, 5], "H_error_ransac", "px")
            == jax_eval.eval_poses(pose_results, [1, 3, 5], "H_error_ransac", "px"))


@pytest.fixture(scope="module")
def sequence(tmp_path_factory):
    """One JAX-rendered 640x480 viewpoint sequence (5 pairs)."""
    root = tmp_path_factory.mktemp("hpatches")
    render_sequence(root / "v_synth000", np.random.default_rng((1_000_003, 0)), (640, 480), "a")
    return root


def test_dataset_items_match_jax(sequence):
    conf = {"data_dir": str(sequence)}
    ours, ref = HPatchesDataset(conf), JaxHPatchesDataset(conf)
    assert len(ours) == len(ref) == 5
    for i in range(5):
        a, b = ours[i], ref[i]
        assert a["name"] == b["name"] and a["idx"] == b["idx"]
        np.testing.assert_allclose(a["H_0to1"], b["H_0to1"], rtol=1e-5,
                                   atol=1e-5 * np.abs(b["H_0to1"]).max())
        for v in ("view0", "view1"):
            np.testing.assert_allclose(a[v]["image"], b[v]["image"], rtol=0, atol=1e-5)
            for key in ("image_size", "orig_size", "scales", "transform", "valid_mask"):
                np.testing.assert_array_equal(a[v][key], b[v][key], err_msg=key)
    batch = next(iter(ours.get_data_loader("test")))
    assert batch["name"] == [ours[0]["name"]] and batch["view0"]["image"].shape == (1, 480,
                                                                                    480, 3)


def test_pipeline_matches_jax(sequence, tmp_path):
    """Both HPatchesPipelines at 512 keypoints on the 5 pairs: per pair, the
    same matches within 1%, prec@1px within 0.02, and the DLT corner error
    within 0.05 px where it is under 5 px. (RANSAC draws from different
    random streams, so its errors are compared by test_robust_* above.)"""
    conf = merge(hpatches_flagship_conf(), {
        "data": {"data_dir": str(sequence), "num_workers": 1},
        "model": {"extractor": {"max_num_keypoints": 512}},
        "checkpoint": str(ROOT_PATH / hpatches_flagship_conf()["checkpoint"]),
    })
    ours = HPatchesPipeline(conf, device="cpu").run(tmp_path / "port")[1]
    _, ref = JaxHPatchesPipeline(conf).run(tmp_path / "jax")
    ref = jax_load_eval(tmp_path / "jax")[1]
    assert [str(n) for n in ours["names"]] == [
        n.decode() if isinstance(n, bytes) else str(n) for n in ref["names"]]
    np.testing.assert_allclose(ours["num_matches"], ref["num_matches"], rtol=0.01)
    assert (ref["num_matches"] > 150).all()
    np.testing.assert_allclose(ours["prec@1px"], ref["prec@1px"], rtol=0, atol=0.02)
    small = ref["H_error_dlt"] < 5
    assert small.sum() >= 3
    np.testing.assert_allclose(ours["H_error_dlt"][small], ref["H_error_dlt"][small], rtol=0,
                               atol=0.05)


def test_cached_results_refuse_another_conf(sequence, tmp_path):
    """The JAX pipeline's conf check: another model needs overwrite, another
    evaluation overwrite_eval."""
    conf = merge(hpatches_flagship_conf(), {"data": {"data_dir": str(sequence)}})
    HPatchesPipeline(conf, device="cpu").save_conf(tmp_path)
    other_eval = HPatchesPipeline(merge(conf, {"eval": {"num_hypotheses": 64}}), device="cpu")
    with pytest.raises(RuntimeError, match="overwrite_eval"):
        other_eval.save_conf(tmp_path)
    other_eval.save_conf(tmp_path, overwrite_eval=True)
    other_model = HPatchesPipeline(merge(conf, {"model": {"extractor": {
        "max_num_keypoints": 512}}}), device="cpu")
    for flags in ({}, {"overwrite_eval": True}):
        with pytest.raises(RuntimeError, match="overwrite=True"):
            other_model.save_conf(tmp_path, **flags)
    other_model.save_conf(tmp_path, overwrite=True)
