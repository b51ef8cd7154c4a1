"""The wireframe's junction clustering (``ops/cluster.py``) and the wireframe
itself (``models/lines/wireframe.py``) against the JAX package on the CPU.

Bounds: cluster labels equal (integers), cluster means within 1e-5; the
wireframe of one rendered view with SuperPoint from sp_tpu_stage0b at 128
keypoints: every output within WIRE_TOL of JAX's, masks and junction
indices equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gluefactory_torch.models import build_model
from gluefactory_torch.ops.cluster import cluster_means, fixed_radius_clusters
from gluefactory_torch.recipes import SP_STAGE0B_WEIGHTS
from gluefactory_torch.scripts.generate_eval_set import render_sequence
from gluefactory_torch.utils.image import read_image
from gluefactory_torch.utils.weights import load_state_strict, load_weight_blob, params_from_flat
from gluefactory_tpu.models import build_model as jax_build_model
from gluefactory_tpu.ops.cluster import cluster_means as jax_cluster_means
from gluefactory_tpu.ops.cluster import fixed_radius_clusters as jax_fixed_radius_clusters
from gluefactory_tpu.utils.experiments import restore_from_flat_dict

torch.set_num_threads(2)

MEAN_TOL = 1e-5
WIRE_TOL = 1e-4


def _points(seed: int, b: int = 3, n: int = 96):
    """Clustered endpoints, a chain of 40 points 2.5 apart (more hops than
    the 16 rounds reach), isolated points, and invalid slots."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0, 200, (b, n, 2))
    centers = rng.uniform(20, 180, (b, 8, 2))
    pts[:, :32] = np.repeat(centers, 4, axis=1) + rng.normal(0, 1.0, (b, 32, 2))
    pts[:, 40:80] = np.stack([np.linspace(0, 97.5, 40) + 50, np.full(40, 100.0)], -1)
    pts[:, 40:80] = pts[:, 40:80][:, rng.permutation(40)]
    valid = rng.uniform(size=(b, n)) > 0.1
    valid[:, 40:80] = True
    return pts.astype(np.float32), valid


@pytest.mark.parametrize("eps", [3.0, 1.5])
def test_clusters_are_jaxs(eps):
    pts, valid = _points(int(eps * 2))
    ref = np.asarray(jax_fixed_radius_clusters(jnp.asarray(pts), jnp.asarray(valid), eps))
    ours = fixed_radius_clusters(torch.from_numpy(pts), torch.from_numpy(valid), eps).numpy()
    assert ours.dtype == np.int32
    np.testing.assert_array_equal(ours, ref)
    if eps == 3.0:  # the chain stays split after 16 rounds, as in JAX
        assert 1 < len(np.unique(ours[0, 40:80])) < 40
    weights = np.random.default_rng(1).uniform(size=valid.shape).astype(np.float32) * valid
    ref_m, ref_c = (np.asarray(x) for x in jax_cluster_means(
        jnp.asarray(pts), jnp.asarray(weights), jnp.asarray(ref)))
    m, c = cluster_means(torch.from_numpy(pts), torch.from_numpy(weights), torch.from_numpy(ours))
    np.testing.assert_allclose(c.numpy(), ref_c, atol=MEAN_TOL, rtol=MEAN_TOL)
    np.testing.assert_allclose(m.numpy(), ref_m, atol=MEAN_TOL, rtol=MEAN_TOL)


def test_wireframe_is_jaxs(tmp_path):
    render_sequence(tmp_path / "s", np.random.default_rng((424242, 1)), (320, 240), "a")
    image = (read_image(tmp_path / "s" / "1.ppm").astype(np.float32) / 255.0)[None]
    conf = {"point_extractor": {"name": "extractors.superpoint", "max_num_keypoints": 128,
                                "detection_threshold": 0.0, "dense_outputs": True},
            "line_extractor": {"name": "lines.lsd", "max_num_lines": 48, "min_length": 15},
            "nms_radius": 3.0}
    size = np.float32([[320.0, 240.0]])
    flat, _, _ = load_weight_blob(SP_STAGE0B_WEIGHTS)
    flat = {k.replace("['extractor']", "['point_extractor']", 1): v for k, v in flat.items()}

    jmodel = jax_build_model("lines.wireframe", conf)
    jdata = {"image": jnp.asarray(image), "image_size": jnp.asarray(size)}
    params = restore_from_flat_dict(jax.eval_shape(jmodel.init, jax.random.key(0), jdata),
                                    flat)  # the blob holds every parameter
    ref = jax.tree.map(np.asarray, dict(jax.jit(jmodel.apply)(params, jdata)))

    model = build_model("lines.wireframe", conf, device="cpu")
    load_state_strict(model, params_from_flat(flat))
    with torch.inference_mode():
        pred = {k: v.numpy() for k, v in model({"image": torch.from_numpy(image),
                                                "image_size": torch.from_numpy(size)}).items()}
    assert pred.keys() == ref.keys()
    for key in ("keypoint_valid", "valid_lines", "lines_junc_idx", "n_junctions"):
        np.testing.assert_array_equal(pred[key], ref[key], err_msg=key)
    for key in ("keypoints", "keypoint_scores", "lines", "line_scores", "descriptors"):
        np.testing.assert_allclose(pred[key], ref[key], atol=WIRE_TOL, rtol=WIRE_TOL,
                                   err_msg=key)
    # junctions were merged, and keypoints near them masked
    assert (pred["lines_junc_idx"][0] != np.arange(96)).sum() > 4
    assert pred["valid_lines"].sum() > 20 and (~pred["keypoint_valid"][0, 96:]).sum() > 0
