"""The port's ops (gluefactory_torch/ops, geometry) against their JAX
counterparts on the same numpy inputs, on the CPU.

Tolerances: float32 on both sides; 2e-5 for attention (as the JAX package
holds its Pallas kernels to its XLA path), 1e-5 or tighter elsewhere unless a
line says why."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gluefactory_tpu.geometry import homography as jhomography
from gluefactory_tpu.ops import assignment as jassignment
from gluefactory_tpu.ops import attention as jattention
from gluefactory_tpu.ops import interpolate as jinterpolate
from gluefactory_tpu.ops import nms as jnms
from gluefactory_torch.geometry import homography as thomography
from gluefactory_torch.ops import assignment as tassignment
from gluefactory_torch.ops import attention as tattention
from gluefactory_torch.ops import interpolate as tinterpolate
from gluefactory_torch.ops import nms as tnms

torch.set_num_threads(2)


def _rng(seed=0):
    return np.random.default_rng(seed)


def _close(t, j, atol, rtol=0.0):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=atol, rtol=rtol)


@pytest.mark.parametrize("radius", [0, 2, 4])
def test_simple_nms_matches_jax(radius):
    heat = _rng(1).uniform(size=(2, 40, 56)).astype(np.float32)
    heat[0, 10, 10:14] = 0.99  # a plateau: ties in the max-pool
    _close(tnms.simple_nms(torch.from_numpy(heat), radius),
           jnms.simple_nms(jnp.asarray(heat), radius), atol=0)


def test_top_k_breaks_ties_like_jax():
    """Quantized scores make many exact ties; the slot order must follow
    jax.lax.top_k (lower flat index first)."""
    rng = _rng(2)
    scores = (rng.integers(0, 6, size=(2, 32, 40)) / 5.0).astype(np.float32)
    size = np.array([[40.0, 32.0], [33.0, 27.0]], np.float32)
    t = tnms.select_top_k_keypoints(torch.from_numpy(scores), 64, threshold=0.3,
                                    border=3, image_size=torch.from_numpy(size))
    j = jnms.select_top_k_keypoints(jnp.asarray(scores), 64, threshold=0.3, border=3,
                                    image_size=jnp.asarray(size))
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_com_refinement_matches_jax():
    rng = _rng(3)
    heat = rng.uniform(size=(2, 30, 30)).astype(np.float32)
    kp = rng.integers(0, 30, size=(2, 20, 2)).astype(np.float32)  # borders included
    _close(tnms.com_refinement(torch.from_numpy(kp), torch.from_numpy(heat), 2),
           jnms.com_refinement(jnp.asarray(kp), jnp.asarray(heat), 2), atol=1e-5)


def test_cell_logits_to_heatmap_matches_jax():
    logits = _rng(4).normal(size=(2, 5, 7, 65)).astype(np.float32)
    _close(tinterpolate.cell_logits_to_heatmap(torch.from_numpy(logits)),
           jinterpolate.cell_logits_to_heatmap(jnp.asarray(logits)), atol=1e-6)


@pytest.mark.parametrize("mode", ["center", "torch"])
def test_sample_descriptors_matches_jax(mode):
    rng = _rng(5)
    dmap = rng.normal(size=(2, 6, 9, 16)).astype(np.float32)
    kp = rng.uniform(-4, 76, size=(2, 30, 2)).astype(np.float32)  # some outside
    _close(tinterpolate.sample_descriptors(torch.from_numpy(dmap), torch.from_numpy(kp),
                                           8, mode=mode),
           jinterpolate.sample_descriptors(jnp.asarray(dmap), jnp.asarray(kp), 8,
                                           mode=mode), atol=1e-6)


def test_bilinear_sample_matches_jax():
    rng = _rng(6)
    fmap = rng.normal(size=(1, 12, 17, 3)).astype(np.float32)
    pts = rng.uniform(-2, 19, size=(1, 50, 2)).astype(np.float32)
    _close(tinterpolate.bilinear_sample(torch.from_numpy(fmap), torch.from_numpy(pts)),
           jinterpolate.bilinear_sample(jnp.asarray(fmap), jnp.asarray(pts)), atol=1e-6)


@pytest.mark.parametrize("masked", [False, True])
def test_assignment_and_filter_match_jax(masked):
    rng = _rng(7)
    sim = rng.normal(size=(2, 12, 9)).astype(np.float32) * 3
    z0 = rng.normal(size=(2, 12)).astype(np.float32)
    z1 = rng.normal(size=(2, 9)).astype(np.float32)
    m0 = rng.uniform(size=(2, 12)) > 0.2 if masked else None
    m1 = rng.uniform(size=(2, 9)) > 0.2 if masked else None

    def t(x):
        return None if x is None else torch.from_numpy(x)

    def j(x):
        return None if x is None else jnp.asarray(x)

    st = tassignment.sigmoid_log_double_softmax(t(sim), t(z0), t(z1), t(m0), t(m1))
    sj = jassignment.sigmoid_log_double_softmax(j(sim), j(z0), j(z1), j(m0), j(m1))
    _close(st, sj, atol=1e-5)
    ft = tassignment.filter_matches(st, 0.05)
    fj = jassignment.filter_matches(sj, 0.05)
    for key in ("matches0", "matches1"):
        np.testing.assert_array_equal(ft[key].numpy(), np.asarray(fj[key]))
    for key in ("matching_scores0", "matching_scores1"):
        _close(ft[key], fj[key], atol=1e-6)


def _qkv(rng, b, h, n, m, d):
    return (rng.normal(size=(b, h, n, d)).astype(np.float32),
            rng.normal(size=(b, h, m, d)).astype(np.float32),
            rng.normal(size=(b, h, m, d)).astype(np.float32))


@pytest.mark.parametrize("masked", [False, True])
def test_attention_plain_matches_xla_and_pallas(masked):
    """K2's plain version at the unaligned shapes of the JAX package's own
    Pallas test, against attention_xla and the interpreted Pallas kernel."""
    rng = _rng(8)
    b, h, n, m, d = 2, 4, 100, 70, 64
    q, k, v = _qkv(rng, b, h, n, m, d)
    mask = rng.uniform(size=(b, m)) > 0.3 if masked else None
    if masked:
        mask[1] = False  # a fully-masked batch item: rows of zeros
    tm = None if mask is None else torch.from_numpy(mask)
    jm = None if mask is None else jnp.asarray(mask)
    out = tattention.attention_plain(*map(torch.from_numpy, (q, k, v)), tm)
    _close(out, jattention.attention_xla(*map(jnp.asarray, (q, k, v)), jm), atol=2e-5)
    _close(out, jattention.attention_pallas(*map(jnp.asarray, (q, k, v)), jm,
                                            interpret=True), atol=2e-5)
    # the dispatcher and the kernel wrapper take the plain version on the CPU
    for impl in ("auto", "pallas", "xla"):
        torch.testing.assert_close(
            tattention.attention(*map(torch.from_numpy, (q, k, v)), tm,
                                 implementation=impl), out, atol=0, rtol=0)


def test_rotary_attention_plain_matches_xla_and_pallas():
    """K1's plain version against the interpreted fused-rotary Pallas kernel
    and apply_rotary + attention_xla, at the JAX package's test shape."""
    rng = _rng(9)
    b, h, n, d = 1, 2, 50, 32
    q, k, v = _qkv(rng, b, h, n, n, d)
    theta = rng.normal(size=(b, n, d // 2)).astype(np.float32)
    cos = np.repeat(np.cos(theta), 2, -1)
    sin = np.repeat(np.sin(theta), 2, -1)
    mask = rng.uniform(size=(b, n)) > 0.2
    jq, jk, jv, jc, js, jmask = map(jnp.asarray, (q, k, v, cos, sin, mask))
    tq, tk, tv, tc, ts, tmask = map(torch.from_numpy, (q, k, v, cos, sin, mask))
    _close(tattention.apply_rotary(tk, tc, ts), jattention.apply_rotary(jk, jc, js),
           atol=1e-6)
    k_rot = tattention.apply_rotary(tk, tc, ts)
    out = tattention.attention_rotary_plain(tq, k_rot, tv, tc, ts, tmask)
    jk_rot = jattention.apply_rotary(jk, jc, js)
    _close(out, jattention.attention_pallas_rotary(jq, jk_rot, jv, jc, js, jmask,
                                                   interpret=True), atol=2e-5)
    ref = jattention.self_attention_rotary(jq, jk, jv, jc, js, jmask,
                                           implementation="xla")
    for impl in ("auto", "xla"):
        _close(tattention.self_attention_rotary(tq, tk, tv, tc, ts, tmask,
                                                implementation=impl), ref, atol=2e-5)


def test_kernel_wrappers_reject_what_the_kernel_does_not_take():
    """Off the CPU a wrapper launches or raises: never the plain version."""
    q = torch.empty(1, 4, 8, 64, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tattention.attention_cuda(q, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        tattention.attention_rotary_cuda(q, q, q, q[:, 0], q[:, 0])
    with pytest.raises(ValueError, match="implementation"):
        tattention.attention(q, q, q, implementation="ring")


def test_homography_ops_match_jax():
    rng = _rng(10)
    p0 = rng.uniform(0, 300, size=(3, 40, 2)).astype(np.float32)
    Hs = np.stack([np.eye(3, dtype=np.float32)] * 3)
    Hs[:, :2, :] += rng.normal(0, 0.02, size=(3, 2, 3)).astype(np.float32)
    Hs[:, :2, 2] += rng.normal(0, 10, size=(3, 2)).astype(np.float32)
    Hs[:, 2, :2] = rng.normal(0, 1e-4, size=(3, 2)).astype(np.float32)
    p1 = np.asarray(jhomography.warp_points(jnp.asarray(p0), jnp.asarray(Hs)))
    p1 = p1 + rng.normal(0, 0.5, size=p1.shape).astype(np.float32)
    w = rng.uniform(0.1, 1.0, size=(3, 40)).astype(np.float32)
    tH = thomography.compute_homography(*map(torch.from_numpy, (p0, p1, w)))
    jH = jhomography.compute_homography(*map(jnp.asarray, (p0, p1, w)))
    # the 9x9 eigensolvers of the two libraries differ in the last bits
    _close(tH, jH, atol=1e-4, rtol=1e-4)
    for inverse in (False, True):
        _close(thomography.warp_points(torch.from_numpy(p0), torch.from_numpy(Hs), inverse),
               jhomography.warp_points(jnp.asarray(p0), jnp.asarray(Hs), inverse),
               atol=1e-3, rtol=1e-5)
    _close(thomography.sym_homography_error(*map(torch.from_numpy, (p0, p1, Hs))),
           jhomography.sym_homography_error(*map(jnp.asarray, (p0, p1, Hs))), atol=1e-4)
    size = np.array([320.0, 240.0], np.float32)
    _close(thomography.homography_corner_error(tH, torch.from_numpy(Hs),
                                               torch.from_numpy(size)),
           jhomography.homography_corner_error(jnp.asarray(np.asarray(tH)),
                                               jnp.asarray(Hs), jnp.asarray(size)),
           atol=1e-4)

