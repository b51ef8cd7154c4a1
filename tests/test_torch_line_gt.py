"""The line ground truth (the ground-truth half of geometry/lines.py and the
``use_lines`` branches of matchers.homography_matcher and
matchers.depth_matcher) against the JAX package on the CPU: the match codes
(-1 unmatched, -2 ignored) and the assignment equal JAX's exactly, on
segments with invalid slots, segments leaving the image, a degenerate
segment, and duplicated segments whose costs tie exactly (both packages
take the first index)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gluefactory_torch.geometry import lines as L
from gluefactory_torch.models import build_model
from gluefactory_tpu.geometry import lines as JL
from gluefactory_tpu.models import build_model as jax_build_model
from test_torch_depth import _jax, _port, planar_scene

torch.set_num_threads(2)

SIZE = (160, 120)
KEYS = ("line_matches0", "line_matches1", "line_assignment")
# jitted once for the shapes of every case (eager JAX compiles op by op)
JAX_HOMOGRAPHY = jax.jit(JL.gt_line_matches_from_homography)
JAX_POSE_DEPTH = jax.jit(JL.gt_line_matches_from_pose_depth)


def _warp(H, pts):
    hp = np.concatenate([pts, np.ones_like(pts[..., :1])], -1) @ H.T
    return hp[..., :2] / hp[..., 2:]


def _lines(seed, H, b=2, n0=24):
    """Segments of view 0 (some leaving the image, one degenerate, one pair
    duplicated) and of view 1: view 0's carried by ``H`` (B, 3, 3), some
    shortened or moved by a pixel, distractors, duplicates of a partner
    (exact ties), shuffled; random validity with a fully invalid view-0
    item half."""
    rng = np.random.default_rng(seed)
    w, h = SIZE
    a = rng.uniform([-15, -15], [w + 15, h + 15], (b, n0, 2))
    angle = rng.uniform(0, 2 * np.pi, (b, n0))
    length = rng.uniform(10, 70, (b, n0))[..., None]
    lines0 = np.stack([a, a + length * np.stack([np.cos(angle), np.sin(angle)], -1)], -2)
    lines0[:, 1] = lines0[:, 0]  # a duplicated segment of view 0
    lines0[:, 2, 1] = lines0[:, 2, 0]  # a degenerate one
    lines1 = []
    for i in range(b):
        carried = _warp(H[i], lines0[i])
        carried[::3, 1] = 0.6 * carried[::3, 1] + 0.4 * carried[::3, 0]  # partial overlap
        carried[1::4] += rng.normal(0, 1.0, carried[1::4].shape)
        distractors = rng.uniform([0, 0], [w, h], (6, 2, 2))
        segs = np.concatenate([carried, distractors, carried[[4, 5, 6]]])  # exact ties
        lines1.append(segs[rng.permutation(len(segs))])
    lines1 = np.stack(lines1)
    valid0 = rng.uniform(size=(b, n0)) > 0.1
    valid0[1, n0 // 2:] = False
    valid1 = rng.uniform(size=lines1.shape[:2]) > 0.1
    return lines0.astype(np.float32), lines1.astype(np.float32), valid0, valid1


def _assert_equal(ours: dict, ref: dict):
    for key in KEYS:
        assert ours[key].dtype == (torch.bool if key == "line_assignment" else torch.int32), key
        np.testing.assert_array_equal(ours[key].numpy(), np.asarray(ref[key]), err_msg=key)
    m0 = ours["line_matches0"].numpy()
    # the cases are exercised: matches, unmatched and ignored segments
    assert (m0 >= 0).sum() >= 8 and (m0 == -1).any() and (m0 == -2).any(), m0


def test_greedy_assignment_ties_and_empty_rows_are_jaxs():
    """Exact ties pick the first index in both packages, rows and columns
    without a valid pair take index 0 and stay unmatched."""
    rng = np.random.default_rng(3)
    cost = rng.integers(0, 4, (2, 7, 9)).astype(np.float32)  # many exact ties
    valid = rng.uniform(size=cost.shape) > 0.3
    valid[0, 2] = False  # a row without a valid pair
    valid[1, :, 4] = False  # a column without one
    ours = L._greedy_mutual_assignment(torch.from_numpy(cost), torch.from_numpy(valid), 2.5)
    ref = JL._greedy_mutual_assignment(jnp.asarray(cost), jnp.asarray(valid), 2.5)
    for a, r in zip(ours, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(r))
    assert int(ours[2][0, 2]) == 0 and not bool(ours[0][0, 2])


@pytest.mark.parametrize("seed", [0, 1])
def test_gt_line_matches_from_homography_is_jaxs(seed):
    H = planar_scene(seed)["H"]
    lines0, lines1, valid0, valid1 = _lines(seed, H)
    args = (lines0, lines1, valid0, valid1, H)
    ours = L.gt_line_matches_from_homography(*map(torch.from_numpy, args))
    ref = JAX_HOMOGRAPHY(*map(jnp.asarray, args))
    _assert_equal(ours, ref)


@pytest.mark.parametrize("seed", [0, 1])
def test_gt_line_matches_from_pose_depth_is_jaxs(seed):
    scene = planar_scene(seed)
    lines0, lines1, valid0, valid1 = _lines(seed, scene["H"])
    t, c0, c1, T = _port(scene)
    jt, jc0, jc1, jT = _jax(scene)
    ours = L.gt_line_matches_from_pose_depth(
        *map(torch.from_numpy, (lines0, lines1, valid0, valid1)), t["depth0"], t["depth1"],
        c0, c1, T)
    ref = JAX_POSE_DEPTH(
        *map(jnp.asarray, (lines0, lines1, valid0, valid1)), jt["depth0"], jt["depth1"],
        jc0, jc1, jT)
    _assert_equal(ours, ref)


@pytest.mark.parametrize("name", ["matchers.homography_matcher", "matchers.depth_matcher"])
def test_ground_truth_matchers_with_lines_are_jaxs(name):
    """``use_lines`` with non-default thresholds: every ground-truth output,
    points and lines, equal to JAX's (the points' reprojections within 1e-4
    px); without ``valid_lines`` every line counts as valid, as in JAX."""
    scene = planar_scene(5)
    lines0, lines1, valid0, valid1 = _lines(5, scene["H"])
    conf = {"use_lines": True, "line_dist_th": 4.0, "line_overlap_th": 0.3}
    data = {"keypoints0": scene["kp0"], "keypoints1": scene["kp1"],
            "keypoint_valid0": scene["valid0"], "keypoint_valid1": scene["valid1"],
            "lines0": lines0, "lines1": lines1, "valid_lines0": valid0}
    if name.endswith("homography_matcher"):
        data.update(H_0to1=scene["H"], view0={"image_size": scene["size"]},
                    view1={"image_size": scene["size"]})
        ours_in = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else
                   {kk: torch.from_numpy(vv) for kk, vv in v.items()} for k, v in data.items()}
        ref_in = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else
                  {kk: jnp.asarray(vv) for kk, vv in v.items()} for k, v in data.items()}
    else:
        t, c0, c1, T = _port(scene)
        jt, jc0, jc1, jT = _jax(scene)
        ours_in = {**{k: torch.from_numpy(v) for k, v in data.items()}, "T_0to1": T,
                   "view0": {"depth": t["depth0"], "camera": c0},
                   "view1": {"depth": t["depth1"], "camera": c1}}
        ref_in = {**{k: jnp.asarray(v) for k, v in data.items()}, "T_0to1": jT,
                  "view0": {"depth": jt["depth0"], "camera": jc0},
                  "view1": {"depth": jt["depth1"], "camera": jc1}}
    ours = build_model(name, conf, device="cpu")(ours_in)
    jmodel = jax_build_model(name, conf)
    ref = jax.jit(jmodel.apply)({}, ref_in)  # no parameters
    assert ours.keys() == ref.keys() and "gt_line_assignment" in ours
    for key, value in ref.items():
        if ours[key].is_floating_point():  # the points' reprojections
            np.testing.assert_allclose(ours[key].numpy(), np.asarray(value), rtol=1e-6,
                                       atol=1e-4, err_msg=key)
        else:
            np.testing.assert_array_equal(ours[key].numpy(), np.asarray(value), err_msg=key)
    assert (ours["gt_line_matches0"] >= 0).sum() >= 8
    assert (ours["gt_line_matches1"] == -1).any()  # no valid_lines1: none ignored
    assert not (ours["gt_line_matches1"] == -2).any()
