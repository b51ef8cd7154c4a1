"""The port's SIFT against OpenCV on the CPU. The JAX package's SIFT is
``cv2.SIFT_create`` itself (called through ``jax.pure_callback``), so the
port's extractor is held against the JAX extractor on the same images, and
its blur and upsampling against OpenCV's functions bit for bit.

Bounds (the acceptance bounds of the port's SIFT): at least 95% of OpenCV's
keypoints have a port keypoint within 0.05 px whose size is within 1% and
whose orientation is within 1 degree, and for those the RootSIFT
descriptors have a median dot product of at least 0.999. Measured on the
rendered images of these tests (famA and famB, contrast 0.02 and 0.04):
every keypoint of OpenCV's found (share 1.0), 99% at the same float32
position bit for bit, every count equal, 99.5-100% of the descriptors equal
as OpenCV's integers (the rest one unit apart in one entry); median dot
product 1.0."""


import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gluefactory_torch.models import build_model
from gluefactory_torch.models.extractors import sift as S
from gluefactory_torch.scripts.generate_eval_set import render_sequence
from gluefactory_torch.utils.image import read_image
from gluefactory_tpu.models import build_model as jax_build_model

torch.set_num_threads(2)

POS_PX = 0.05
SIZE_REL = 0.01
ANGLE_DEG = 1.0
RECALL = 0.95
MEDIAN_DOT = 0.999


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    """Two rendered 480x360 views, famA and famB, as float RGB in [0, 1]."""
    root = tmp_path_factory.mktemp("sift")
    out = {}
    for family, salt in (("a", 0), ("b", 777)):
        seq = root / family
        render_sequence(seq, np.random.default_rng((424242 + salt, 0)), (480, 360), family)
        out[family] = read_image(seq / "3.ppm").astype(np.float32) / 255.0
    return out


def _gray_u8(image: np.ndarray) -> np.ndarray:
    return np.clip((image * np.float32([0.299, 0.587, 0.114])).sum(-1) * 255, 0, 255).astype(
        np.uint8)


@pytest.mark.parametrize("sigma", S.layer_sigmas()[1:] + [1.2489996])
def test_blur_is_opencvs(images, sigma):
    """The pyramid's blurs (each layer's sigma and the base's) equal
    cv2.GaussianBlur on a float32 image bit for bit."""
    img = _gray_u8(images["b"])[40:250, 60:330].astype(np.float32)
    ref = cv2.GaussianBlur(img, (0, 0), sigma, sigma)
    ours = S.gaussian_blur(torch.from_numpy(img)[None], sigma)[0].numpy()
    np.testing.assert_array_equal(ours, ref)


def test_upsampling_is_opencvs(images):
    img = _gray_u8(images["a"]).astype(np.float32)[:101, :77]
    ref = cv2.resize(img, (2 * img.shape[1], 2 * img.shape[0]), interpolation=cv2.INTER_LINEAR)
    np.testing.assert_array_equal(S.upsample2(torch.from_numpy(img)[None])[0].numpy(), ref)


def _both(image: np.ndarray, conf: dict):
    """(JAX prediction, port prediction) of SIFT ``conf`` on one image, numpy;
    JAX's jitted, as its pipelines run it."""
    jmodel = jax_build_model("extractors.sift", conf)
    data = {"image": jnp.asarray(image)[None]}
    params = jax.jit(jmodel.init)(jax.random.key(0), data)
    jpred = jax.tree.map(np.asarray, dict(jax.jit(jmodel.apply)(params, data)))
    model = build_model("extractors.sift", conf, device="cpu")
    with torch.inference_mode():
        tpred = {k: v.numpy() for k, v in model({"image": torch.from_numpy(image)[None]}).items()}
    return jpred, tpred


def _found(jpred, tpred, b=0):
    """For each of OpenCV's keypoints: whether the port has one within the
    bounds, and the dot product of their descriptors."""
    jv, tv = jpred["keypoint_valid"][b], tpred["keypoint_valid"][b]
    pj, pt = jpred["keypoints"][b][jv], tpred["keypoints"][b][tv]
    dist = np.linalg.norm(pj[:, None] - pt[None], axis=-1)
    dang = np.abs((np.rad2deg(jpred["oris"][b][jv])[:, None]
                   - np.rad2deg(tpred["oris"][b][tv])[None] + 180) % 360 - 180)
    j = (dist + 1e-3 * dang).argmin(1)
    rows = np.arange(len(pj))
    size_rel = np.abs(tpred["scales"][b][tv][j] / jpred["scales"][b][jv] - 1)
    ok = (dist[rows, j] < POS_PX) & (size_rel < SIZE_REL) & (dang[rows, j] < ANGLE_DEG)
    dots = (jpred["descriptors"][b][jv] * tpred["descriptors"][b][tv][j]).sum(-1)
    return ok, dots


@pytest.mark.parametrize("contrast", [0.02, 0.04])
@pytest.mark.parametrize("family", ["a", "b"])
def test_sift_matches_opencv(images, family, contrast):
    jpred, tpred = _both(images[family], {"max_num_keypoints": 1024,
                                          "contrast_threshold": contrast})
    ok, dots = _found(jpred, tpred)
    assert len(ok) > 100
    assert tpred["keypoint_valid"].sum() == jpred["keypoint_valid"].sum()
    assert ok.mean() >= RECALL, ok.mean()
    assert np.median(dots[ok]) >= MEDIAN_DOT, np.median(dots[ok])
    for key in ("keypoints", "scales", "oris", "keypoint_scores", "descriptors"):
        assert tpred[key].shape == jpred[key].shape
        assert (tpred[key][~tpred["keypoint_valid"]] == 0).all()
    # slots sorted by response, as the JAX wrapper sorts them
    scores = tpred["keypoint_scores"][0][tpred["keypoint_valid"][0]]
    assert (np.diff(scores) <= 0).all()


def test_sift_keeps_the_strongest_and_batches(images):
    """Fewer slots than keypoints keep those of largest response (OpenCV's
    retainBest before the descriptors); a batch of two images gives each
    image's own result."""
    conf = {"max_num_keypoints": 64, "contrast_threshold": 0.02}
    jpred, tpred = _both(images["b"], conf)
    ok, _ = _found(jpred, tpred)
    assert tpred["keypoint_valid"].all() and ok.mean() >= RECALL
    model = build_model("extractors.sift", conf, device="cpu")
    batch = torch.from_numpy(np.stack([images["a"], images["b"]]))
    with torch.inference_mode():
        both = model({"image": batch})
        single = model({"image": batch[1:]})
    for key, value in single.items():
        assert torch.equal(both[key][1:], value), key
