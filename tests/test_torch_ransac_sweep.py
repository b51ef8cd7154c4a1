"""A benchmark's RANSAC sweep in one batch (``BaseEstimator.sweep``, the
batched ``ransac_homography``, ``hybrid_ransac_homography`` and
``ransac_essential_sweep``) on the CPU: equal, bit for bit, to the same
estimator run once per threshold, as the benchmarks ran it; and, through
``eval_homography_robust_sweep`` on JAX's minimal sets, to the JAX package's
evaluation at each threshold of the sweep (the bounds of
tests/test_torch_eval.py: the same inliers, the corner error within 1e-3
px)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gluefactory_torch.core.config import merge
from gluefactory_torch.eval import utils as port_eval
from gluefactory_torch.eval.eval_pipeline import SWEEP
from gluefactory_torch.geometry.wrappers import Camera
from gluefactory_torch.robust_estimators import load_estimator
from gluefactory_tpu.eval import utils as jax_eval

torch.set_num_threads(2)

H_GT = np.array([[1.05, 0.04, -12.0], [-0.03, 0.97, 8.0], [2e-4, -1e-4, 1.0]])


def _homography_data(seed: int, n: int = 160, n_lines: int = 24) -> dict:
    """Matches and matched segments of H_GT at 640x480 with 0.8 px of noise,
    30% of the matches uniform, 10% of both invalid."""
    rng = np.random.default_rng(seed)

    def warp(p):
        q = np.c_[p, np.ones(len(p))] @ H_GT.T
        return q[:, :2] / q[:, 2:]

    p0 = rng.uniform([0, 0], [640, 480], (n, 2))
    p1 = warp(p0) + rng.normal(0, 0.8, (n, 2))
    bad = rng.uniform(size=n) < 0.3
    p1[bad] = rng.uniform([0, 0], [640, 480], (int(bad.sum()), 2))
    s0 = rng.uniform([0, 0], [640, 480], (n_lines, 2, 2))
    s1 = warp(s0.reshape(-1, 2)).reshape(n_lines, 2, 2) + rng.normal(0, 0.8, (n_lines, 2, 2))
    f = torch.float32
    return {"m_kpts0": torch.tensor(p0, dtype=f), "m_kpts1": torch.tensor(p1, dtype=f),
            "valid": torch.tensor(rng.uniform(size=n) > 0.1),
            "m_lines0": torch.tensor(s0, dtype=f), "m_lines1": torch.tensor(s1, dtype=f),
            "valid_lines": torch.tensor(rng.uniform(size=n_lines) > 0.1)}


def _pose_data(seed: int, n: int = 150) -> dict:
    """Matches of random points seen by two cameras (f = 500 px), 1 px of
    noise, 25% of them uniform."""
    rng = np.random.default_rng(seed)
    K = np.array([[500.0, 0, 320], [0, 500, 240], [0, 0, 1]])
    X = np.c_[rng.uniform(-2, 2, (n, 2)), rng.uniform(3, 8, n)]
    c, s = np.cos(0.1), np.sin(0.1)
    R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    t = np.array([1.0, 0.1, 0.2])

    def project(P):
        q = P @ K.T
        return q[:, :2] / q[:, 2:]

    p0, p1 = project(X), project(X @ R.T + t) + rng.normal(0, 1.0, (n, 2))
    bad = rng.uniform(size=n) < 0.25
    p1[bad] = rng.uniform([0, 0], [640, 480], (int(bad.sum()), 2))
    cam = Camera.from_calibration_matrix(torch.tensor(K, dtype=torch.float32))
    f = torch.float32
    return {"m_kpts0": torch.tensor(p0, dtype=f), "m_kpts1": torch.tensor(p1, dtype=f),
            "camera0": cam, "camera1": cam, "valid": torch.tensor(rng.uniform(size=n) > 0.1)}


CASES = {  # (estimator, its conf, the data)
    "ransac": (("homography", "ransac"), {"num_hypotheses": 256}, _homography_data),
    "ransac_fixed_sets": (("homography", "ransac"), {}, _homography_data),
    "hybrid_ransac": (("homography", "hybrid_ransac"), {"num_hypotheses": 256},
                      _homography_data),
    "hybrid_ransac_lines_only": (("homography", "hybrid_ransac"), {"num_hypotheses": 256},
                                 _homography_data),
    "relative_pose": (("relative_pose", "ransac"), {"num_hypotheses": 128, "lo_iters": 6},
                      _pose_data),
}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", list(CASES))
def test_sweep_in_one_batch_is_one_threshold_a_run(case, seed):
    (kind, name), conf, make = CASES[case]
    data = make(seed)
    if case == "ransac_fixed_sets":
        data["sample_idx"] = torch.randint(0, len(data["m_kpts0"]), (64, 4),
                                           generator=torch.Generator().manual_seed(seed))
    if case == "hybrid_ransac_lines_only":
        data.update(m_kpts0=data["m_kpts0"][:0], m_kpts1=data["m_kpts1"][:0],
                    valid=data["valid"][:0])
    cls = load_estimator(kind, name)
    batch = cls(conf).sweep(data, SWEEP)
    assert len(batch) == len(SWEEP)
    for th, ours in zip(SWEEP, batch):
        one = cls(merge(conf, {"ransac_th": th}))(data)
        assert ours.keys() == one.keys()
        for key, value in one.items():
            if key == "M_0to1" and kind == "relative_pose":
                assert torch.equal(ours[key].R, value.R) and torch.equal(ours[key].t, value.t)
            elif isinstance(value, torch.Tensor):
                assert torch.equal(ours[key], value), (th, key)
            else:
                assert ours[key] == value, (th, key)


def _predictions(seed: int, n: int = 128) -> dict:
    """Keypoints, shuffled H_GT matches with 0.4 px of noise, 30% wrong and
    10% unmatched (as tests/test_torch_eval.py makes them)."""
    rng = np.random.default_rng(seed)
    kp0 = rng.uniform([0, 0], [480, 360], (n, 2)).astype(np.float32)
    h = np.c_[kp0, np.ones(n, np.float32)] @ H_GT.T.astype(np.float32)
    kp1_true = h[:, :2] / h[:, 2:] + rng.normal(0, 0.4, (n, 2))
    perm = rng.permutation(n)
    kp1 = np.empty_like(kp1_true)
    kp1[perm] = kp1_true
    m0 = perm.copy()
    wrong = rng.uniform(size=n) < 0.3
    m0[wrong] = rng.integers(0, n, wrong.sum())
    m0[rng.uniform(size=n) < 0.1] = -1
    return {"keypoints0": kp0, "keypoints1": kp1.astype(np.float32),
            "matches0": m0.astype(np.int32),
            "matching_scores0": np.where(m0 > -1, rng.uniform(0.2, 1.0, n), 0).astype(
                np.float32)}


@pytest.mark.parametrize("seed", [3, 4])
def test_robust_evaluation_sweep_is_jaxs_at_each_threshold(seed):
    data = {"H_0to1": H_GT.astype(np.float32),
            "view0": {"image_size": np.array([480.0, 360.0], np.float32)}}
    pred = _predictions(seed)
    conf = {"estimator": "ransac", "num_hypotheses": 256, "seed": 0}
    logits = jnp.where(jnp.asarray(pred["matches0"] > -1), 0.0, -1e9)
    keys = jax.random.split(jax.random.key(conf["seed"]), conf["num_hypotheses"])
    sample_idx = np.asarray(jax.vmap(lambda k: jax.random.categorical(k, logits, shape=(4,)))(
        keys))
    ours = port_eval.eval_homography_robust_sweep(data, pred, conf, SWEEP, device="cpu",
                                                  sample_idx=sample_idx)
    assert list(ours) == SWEEP
    for th in SWEEP:
        ref = jax_eval.eval_homography_robust(data, pred, {**conf, "ransac_th": th})
        assert ours[th]["ransac_inl"] == ref["ransac_inl"], th
        np.testing.assert_allclose(ours[th]["H_error_ransac"], ref["H_error_ransac"],
                                   rtol=1e-5, atol=1e-3, err_msg=str(th))
        assert ours[th] == port_eval.eval_homography_robust(
            data, pred, {**conf, "ransac_th": th}, device="cpu", sample_idx=sample_idx)
