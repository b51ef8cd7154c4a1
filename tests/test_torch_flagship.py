"""The port's flagship pipeline (gluefactory_torch.flagship) against the JAX
flagship at full width, on the CPU: SuperPoint (512 keypoints, CoM readout)
-> 6-layer LightGlue -> ZNCC refiner -> LO-RANSAC, with the committed
lg_tpu_stage2 weights, on one rendered benchmark pair."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gluefactory_tpu.models import build_model as jax_build_model
from gluefactory_tpu.robust_estimators.homography.ransac import ransac_homography
from gluefactory_tpu.scripts.export_weights import load_weight_blob
from gluefactory_tpu.scripts.generate_eval_set import render_sequence
from gluefactory_tpu.utils.experiments import restore_from_flat_dict
from gluefactory_tpu.utils.image import read_image
from gluefactory_torch.flagship import (
    FLAGSHIP_WEIGHTS,
    GATE,
    RANSAC_CONF,
    flagship_conf,
    load_flagship,
    matched_keypoints,
    pair_quality,
    passes_gate,
)
from gluefactory_torch.geometry.homography import homography_corner_error
from gluefactory_torch.models.matchers.match_refiner import MatchRefiner
from test_trained_quality import render_pairs

torch.set_num_threads(2)


def _jax_flagship(data):
    """(JAX flagship prediction, the refiner's input in it)."""
    conf = flagship_conf()
    conf["matcher"].update(attention="xla", checkpointed=False, save_layer_outputs=False)
    refiner = jax_build_model("matchers.match_refiner", conf.pop("filter"))
    model = jax_build_model("two_view_pipeline", conf)
    params = model.init(jax.random.key(0), data)
    flat, _, _ = load_weight_blob(FLAGSHIP_WEIGHTS)
    pred = jax.jit(model.apply)(restore_from_flat_dict(params, flat), data)
    refined = refiner.apply({}, {**data, **pred})
    return (jax.tree.map(np.asarray, {**pred, **refined}),
            jax.tree.map(np.asarray, pred))


def test_flagship_matches_jax(tmp_path):
    seq = tmp_path / "seq"
    render_sequence(seq, np.random.default_rng((424242, 0)), (480, 360), family="a")
    img0 = read_image(seq / "1.ppm").astype(np.float32) / 255.0
    img1 = read_image(seq / "2.ppm").astype(np.float32) / 255.0
    H_gt = np.loadtxt(seq / "H_1_2").astype(np.float32)
    size = np.array([[480.0, 360.0]], np.float32)
    data = {"view0": {"image": img0[None], "image_size": size},
            "view1": {"image": img1[None], "image_size": size}}
    jpred, jmatched = _jax_flagship(jax.tree.map(jnp.asarray, data))
    model, estimator = load_flagship(device="cpu")
    tdata = jax.tree.map(torch.from_numpy, data)
    with torch.inference_mode():
        pred = model(tdata)

    m0, jm0 = pred["matches0"].numpy()[0], jpred["matches0"][0]
    # keypoints1 is refined where matched: compare the detections elsewhere
    unrefined1 = np.ones(m0.shape, bool)
    unrefined1[np.concatenate([m0[m0 > -1], jm0[jm0 > -1]])] = False
    for i, slots in (("0", slice(None)), ("1", unrefined1)):
        np.testing.assert_array_equal(pred[f"keypoint_valid{i}"].numpy(),
                                      jpred[f"keypoint_valid{i}"])
        # the same detections; the CoM readout sums conv outputs that the two
        # libraries compute in another order
        np.testing.assert_allclose(pred[f"keypoints{i}"].numpy()[0][slots],
                                   jpred[f"keypoints{i}"][0][slots], atol=1e-4)
    assert (jm0 > -1).sum() > 150
    assert (m0 == jm0).mean() >= 0.98

    # refined positions, 99% within 1e-3 px and all within 2e-3 px: the
    # shape-only IRLS homography comes from 9x9 float32 eigensolvers that
    # differ in the last bits between the libraries, which moves a rare ZNCC
    # peak by ~1e-3 px. First the refiner alone, on the JAX pipeline's own
    # keypoints and matches:
    shared = {k: torch.from_numpy(jmatched[k]) for k in
              ("keypoints0", "keypoints1", "matches0", "matching_scores0",
               "keypoint_valid0")}
    refined = MatchRefiner(flagship_conf()["filter"])({**tdata, **shared})["keypoints1"]
    err = np.abs(refined.numpy() - jpred["keypoints1"]).max(-1)
    assert np.quantile(err, 0.99) < 1e-3 and err.max() < 2e-3
    # then end to end, where both pipelines matched alike
    agree = (m0 == jm0) & (jm0 > -1)
    err = np.abs(pred["keypoints1"].numpy()[0][jm0[agree]]
                 - jpred["keypoints1"][0][jm0[agree]]).max(-1)
    assert np.quantile(err, 0.99) < 1e-3 and err.max() < 2e-3

    # RANSAC on the same matches with the minimal sets that JAX draws
    mk0, mk1 = matched_keypoints({k: torch.from_numpy(v) for k, v in jpred.items()})
    key, s = jax.random.key(0), RANSAC_CONF["num_hypotheses"]
    valid = jnp.ones(mk0.shape[0], bool)
    sample_idx = jax.vmap(lambda k: jax.random.categorical(
        k, jnp.zeros(mk0.shape[0]), shape=(4,)))(jax.random.split(key, s))
    jH, jinl, _ = ransac_homography(jnp.asarray(mk0.numpy()), jnp.asarray(mk1.numpy()),
                                    valid, key, th=RANSAC_CONF["ransac_th"],
                                    num_hypotheses=s, lo_iters=RANSAC_CONF["lo_iters"])
    out = estimator({"m_kpts0": mk0, "m_kpts1": mk1,
                     "sample_idx": torch.from_numpy(np.array(sample_idx)).long()})
    np.testing.assert_array_equal(out["inliers"].numpy(), np.asarray(jinl))
    wh = torch.from_numpy(size[0])
    assert float(homography_corner_error(out["M_0to1"], torch.from_numpy(np.asarray(jH)),
                                         wh)) < 1e-2
    # and the port's own pipeline and RANSAC recover the true homography
    own = estimator(dict(zip(("m_kpts0", "m_kpts1"), matched_keypoints(pred))))
    assert float(homography_corner_error(own["M_0to1"], torch.from_numpy(H_gt), wh)) < 1.5


def test_flagship_passes_the_jax_gate(tmp_path):
    """The JAX flagship gate (tests/test_trained_quality.py::
    test_trained_flagship_refined_quality) on the port: its 6 pairs, its
    RANSAC, its four bounds on the medians."""
    assert GATE == {"matches": 150, "prec1": 0.35, "prec3": 0.6, "h_err": 1.5}
    model, estimator = load_flagship(device="cpu")
    stats = {k: [] for k in GATE}
    for img0, img1, H in render_pairs(tmp_path):
        size = torch.tensor([[img0.shape[1], img0.shape[0]]], dtype=torch.float32)
        data = {"view0": {"image": torch.from_numpy(img0)[None], "image_size": size},
                "view1": {"image": torch.from_numpy(img1)[None], "image_size": size}}
        with torch.inference_mode():
            quality = pair_quality(model(data), torch.from_numpy(H), size[0], estimator)
        for k in GATE:
            stats[k].append(quality[k])
    assert len(stats["matches"]) == 6
    assert passes_gate(stats), stats
