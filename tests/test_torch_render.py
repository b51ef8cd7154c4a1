"""The port's benchmark renderer (gluefactory_torch.scripts.generate_eval_set)
and its numpy image operations against the JAX package's renderer and
OpenCV, on the CPU: same homographies, pixels within stated bounds."""

import cv2
import numpy as np
import pytest
import torch

from gluefactory_tpu.geometry.homography import (
    sample_homography_corners as jax_sample_homography_corners,
)
from gluefactory_tpu.scripts import generate_eval_set as jax_render
from gluefactory_torch.geometry.homography import sample_homography_corners
from gluefactory_torch.scripts import generate_eval_set as port_render
from gluefactory_torch.utils import image as I

torch.set_num_threads(2)


def test_homography_sampler_consumes_the_draws_of_jax():
    """Same generator state in, same homography out, and the same state after."""
    rng_j, rng_p = np.random.default_rng(11), np.random.default_rng(11)
    for k in range(40):
        kwargs = dict(difficulty=0.15 + 0.05 * (k % 15), translation=0.15,
                      max_angle=5.0 + 3.0 * (k % 9))
        Hj, cj = jax_sample_homography_corners((160, 120), (160, 120), rng=rng_j, **kwargs)
        Hp, cp = sample_homography_corners((160, 120), (160, 120), rng=rng_p, **kwargs)
        np.testing.assert_array_equal(Hp, Hj)
        np.testing.assert_array_equal(cp, cj)
    assert rng_p.uniform() == rng_j.uniform()


SEQUENCES = {  # name: (render function, family, (w, h), mean |diff| bound, share > 0.05 bound)
    "v_family_a_160x120": ("render_sequence", "a", (160, 120), 0.01, 0.02),
    "v_family_a_640x480": ("render_sequence", "a", (640, 480), 0.01, 0.02),
    "v_family_b_160x120": ("render_sequence", "b", (160, 120), 2e-3, None),
    "i_family_b_160x120": ("render_illumination_sequence", "b", (160, 120), 2e-3, None),
}


@pytest.mark.parametrize("name", list(SEQUENCES))
def test_sequence_matches_jax(tmp_path, name):
    """Sequences from one seed: H files equal; family b within 2e-3 on
    average. Family a draws its shapes with numpy where the JAX package uses
    OpenCV (datasets/homographies_ondevice.py), so pixels on shape edges
    differ: mean |diff| < 0.01 and < 2% of the pixels off by more than 0.05,
    as tests/test_torch_train.py holds the training pool, at 160x120 and at
    the benchmark's 640x480."""
    fn, family, size, mean_bound, share_bound = SEQUENCES[name]
    for lib, tag in ((jax_render, "jax"), (port_render, "port")):
        getattr(lib, fn)(tmp_path / tag, np.random.default_rng((1_000_003, 5)), size, family)
    for k in range(1, 7):
        ref = cv2.imread(str(tmp_path / "jax" / f"{k}.ppm"))[..., ::-1].astype(np.float32) / 255
        out = I.read_image(tmp_path / "port" / f"{k}.ppm").astype(np.float32) / 255
        diff = np.abs(out - ref)
        assert diff.mean() < mean_bound, (k, diff.mean())
        if share_bound is not None:
            assert (diff > 0.05).mean() < share_bound, (k, (diff > 0.05).mean())
        if k > 1:
            Hj = np.loadtxt(tmp_path / "jax" / f"H_1_{k}")
            Hp = np.loadtxt(tmp_path / "port" / f"H_1_{k}")
            np.testing.assert_allclose(Hp, Hj, rtol=1e-9, atol=1e-9 * np.abs(Hj).max())


def test_warped_views_are_opencv_warps_of_the_first(tmp_path):
    """Family a apart from the shapes: each view is warpPerspective of the
    port's own first view (within one level on >= 99% of pixels)."""
    port_render.render_sequence(tmp_path, np.random.default_rng((1_000_003, 5)), (160, 120),
                                "a")
    img = I.read_image(tmp_path / "1.ppm")
    for k in range(2, 7):
        H = np.loadtxt(tmp_path / f"H_1_{k}").astype(np.float32)
        ref = cv2.warpPerspective(img, H, (160, 120), flags=cv2.INTER_LINEAR)
        diff = np.abs(I.read_image(tmp_path / f"{k}.ppm").astype(int) - ref.astype(int))
        assert diff.max() <= 1 and (diff == 0).mean() >= 0.99, (k, (diff > 0).mean())


def test_sequence_names_and_seeds_match_jax(tmp_path):
    """generate() writes the JAX script's sequence names."""
    port_render.generate(tmp_path, 2, (64, 48), 0, family="b", illum_seqs=1)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["i_tex000", "v_tex000", "v_tex001"]
    rng = np.random.default_rng((jax_render.EVAL_SEED_SALT + jax_render.FAMILY_B_SALT, 1))
    jax_render.render_sequence(tmp_path / "ref", rng, (64, 48), "b")
    np.testing.assert_array_equal(np.loadtxt(tmp_path / "v_tex001" / "H_1_6"),
                                  np.loadtxt(tmp_path / "ref" / "H_1_6"))


# --- each OpenCV primitive against OpenCV on random inputs -----------------------

@pytest.mark.parametrize("case", ["area 640x480 -> 480x360", "linear 400x300 -> 533x401",
                                  "cubic 9x9 -> 640x480", "cubic 65x65 -> 160x120"])
def test_resize_matches_opencv(case):
    mode, src, _, dst = case.split()
    (sw, sh), (dw, dh) = (tuple(map(int, s.split("x"))) for s in (src, dst))
    rng = np.random.default_rng(len(case))
    shape = (sh, sw) if mode == "cubic" else (sh, sw, 3)
    x = rng.random(shape).astype(np.float32)
    flags = {"area": cv2.INTER_AREA, "linear": cv2.INTER_LINEAR, "cubic": cv2.INTER_CUBIC}
    ref = cv2.resize(x, (dw, dh), interpolation=flags[mode])
    np.testing.assert_allclose(I.resize(x, (dw, dh), mode), ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("ksize,shape", [(77, (480, 640)), (19, (120, 160)), (3, (120, 160))])
def test_gaussian_blur_matches_opencv(ksize, shape):
    rng = np.random.default_rng(ksize)
    x = ((rng.random(shape) > 0.7) * rng.random(shape)).astype(np.float32)
    ref = cv2.GaussianBlur(x, (ksize, ksize), 0)
    np.testing.assert_allclose(I.gaussian_blur(x, ksize), ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("channels", [1, 3])
def test_warp_perspective_matches_opencv(channels):
    """Within one level on >= 99% of pixels (OpenCV rounds its coordinates
    and weights its own way); measured: a few pixels in 10^4 off by one."""
    rng = np.random.default_rng(channels)
    img = cv2.GaussianBlur((rng.random((480, 640)) * 255).astype(np.uint8), (5, 5), 0)
    img = np.repeat(img[..., None], 3, axis=-1) if channels == 3 else img
    for k in range(2, 7):
        H, _ = sample_homography_corners((640, 480), (640, 480), difficulty=0.1 * k,
                                         translation=0.15, max_angle=6.0 * k, rng=rng)
        ref = cv2.warpPerspective(img, H, (640, 480), flags=cv2.INTER_LINEAR)
        diff = np.abs(I.warp_perspective(img, H, (640, 480)).astype(int) - ref.astype(int))
        assert diff.max() <= 1 and (diff == 0).mean() >= 0.99, (k, diff.max(),
                                                              (diff > 0).mean())


@pytest.mark.parametrize("grayscale", [False, True])
def test_read_image_matches_opencv(tmp_path, grayscale):
    rng = np.random.default_rng(3)
    bgr = rng.integers(0, 256, (37, 53, 3)).astype(np.uint8)
    cv2.imwrite(str(tmp_path / "x.ppm"), bgr)
    cv2.imwrite(str(tmp_path / "y.pgm"), bgr[..., 0])
    if grayscale:
        np.testing.assert_array_equal(I.read_image(tmp_path / "x.ppm", grayscale=True),
                                      cv2.imread(str(tmp_path / "x.ppm"), cv2.IMREAD_GRAYSCALE))
    else:
        np.testing.assert_array_equal(I.read_image(tmp_path / "x.ppm"), bgr[..., ::-1])
        np.testing.assert_array_equal(
            I.read_image(tmp_path / "y.pgm"),
            cv2.cvtColor(cv2.imread(str(tmp_path / "y.pgm")), cv2.COLOR_BGR2RGB))
    I.write_image(tmp_path / "z.ppm", bgr[..., ::-1])
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "z.ppm")), bgr)
