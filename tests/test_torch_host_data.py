"""The host homography dataset of the port (datasets/homographies.py), its
photometric augmentations (datasets/augmentations.py), the OpenCV calls they
need (utils/image.py) and the training loader (base_dataset.DataLoader)
against OpenCV and the JAX package, on the CPU at small sizes.

The procedural scenes and the shade's ellipses are drawn by numpy
rasterisers where JAX draws with cv2: pixels differ on shape edges only, and
the shade's blur spreads those. So the chains are compared on the same
source images and with OpenCV's ellipses, and the rasteriser on its own."""

import cv2
import numpy as np
import pytest
import torch

import __graft_entry__
from gluefactory_tpu.datasets import augmentations as jaug
from gluefactory_tpu.datasets.base_dataset import DataLoader as JDataLoader
from gluefactory_tpu.datasets.homographies import HomographyDataset as JHomographyDataset
from gluefactory_torch.datasets import augmentations as taug
from gluefactory_torch.datasets import get_dataset
from gluefactory_torch.datasets.base_dataset import DataLoader
from gluefactory_torch.datasets.homographies import HomographyDataset
from gluefactory_torch.train import training
from gluefactory_torch.utils.image import gaussian_blur, hsv_to_rgb, rgb_to_hsv, warp_perspective

torch.set_num_threads(2)

HOST = {"synthetic": True, "image_size": 96, "synthetic_source_size": [160, 120],
        "train_batch_size": 2, "val_batch_size": 2, "train_size": 6, "val_size": 2,
        "num_workers": 2, "seed": 3, "homography": {"difficulty": 0.7, "max_angle": 45.0},
        "photometric": {"name": "lg"}}


# --- OpenCV's calls ------------------------------------------------------------------

def test_hsv_conversions_match_opencv():
    """uint8 RGB->HSV on a million colours and HSV->RGB on every hue and
    saturation (a third of the values), bit for bit."""
    rgb = np.random.default_rng(0).integers(0, 256, (1000, 1000, 3)).astype(np.uint8)
    rgb[0, :256] = np.arange(256)[:, None]  # grays
    np.testing.assert_array_equal(rgb_to_hsv(rgb), cv2.cvtColor(rgb, cv2.COLOR_RGB2HSV))
    hsv = np.stack(np.meshgrid(np.arange(180), np.arange(256), np.arange(0, 256, 3),
                               indexing="ij"), -1).reshape(180 * 256, -1, 3).astype(np.uint8)
    np.testing.assert_array_equal(hsv_to_rgb(hsv), cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB))


@pytest.mark.parametrize("ksize", [3, 7, 9, 65])
def test_gaussian_blur_matches_opencv(ksize):
    """float32, the fixed kernels up to 9 taps and OpenCV's sigma above."""
    img = np.random.default_rng(ksize).uniform(size=(150, 170, 3)).astype(np.float32)
    mask = img[..., 0] * 255
    np.testing.assert_allclose(gaussian_blur(img, ksize), cv2.GaussianBlur(img, (ksize, ksize), 0),
                               atol=1e-6)
    np.testing.assert_allclose(gaussian_blur(mask, ksize),
                               cv2.GaussianBlur(mask, (ksize, ksize), 0), atol=2e-4)


@pytest.mark.parametrize("dtype,atol", [(np.float32, 2e-5), (np.float64, 1e-12)])
def test_float_warp_matches_opencv(dtype, atol):
    """float warpPerspective, INTER_LINEAR, constant-0 border: float32 at the
    exact coordinates (float32 arithmetic in OpenCV), float64 on the 1/32
    table."""
    img = np.random.default_rng(1).uniform(size=(120, 160, 3)).astype(dtype)
    H = np.array([[0.7, 0.12, 9.3], [-0.08, 0.8, 4.7], [3e-4, -2e-4, 1.0]])
    ours = warp_perspective(img, H, (96, 96))
    assert ours.dtype == dtype
    np.testing.assert_allclose(ours, cv2.warpPerspective(img, H, (96, 96), flags=cv2.INTER_LINEAR),
                               atol=atol)


# --- the augmentations -----------------------------------------------------------------

@pytest.fixture
def cv2_ellipses(monkeypatch):
    """The port's shade with OpenCV's filled ellipses (the numpy rasteriser is
    held to OpenCV in ``test_shade_ellipses_match_opencv``)."""

    def fill(mask, center, axes, angle, color):
        cv2.ellipse(mask, center, axes, angle, 0, 360, color, -1)

    monkeypatch.setattr(taug, "fill_ellipse", fill)


@pytest.mark.parametrize("name", ["identity", "lg", "dark"])
def test_augmentations_match_jax(name, cv2_ellipses):
    """The same generator state gives the same draws (the generators end
    equal) and the same image."""
    aug, jaug_ = taug.augmentations[name](), jaug.augmentations[name]()
    for seed in range(12):
        img = np.random.default_rng(100 + seed).uniform(size=(64, 80, 3)).astype(np.float32)
        rng, jrng = np.random.default_rng(seed), np.random.default_rng(seed)
        out, jout = aug(img.copy(), rng), jaug_(img.copy(), jrng)
        assert out.dtype == jout.dtype == np.float32 and out.shape == jout.shape
        assert rng.uniform() == jrng.uniform()
        np.testing.assert_allclose(out, jout, atol=1e-5, err_msg=f"seed {seed}")


def test_shade_ellipses_match_opencv():
    """The shade's filled ellipses (fractional angles) against cv2.ellipse:
    pixels differ on edges only, under 2% of the filled area."""
    rng = np.random.default_rng(0)
    differ = area = 0
    for _ in range(40):
        ax, ay = int(rng.integers(5, 20)), int(rng.integers(5, 16))
        x, y = int(rng.integers(ax, 80 - ax)), int(rng.integers(ay, 64 - ay))
        angle = float(rng.uniform(0, 90))
        ours, theirs = np.zeros((64, 80), np.float32), np.zeros((64, 80), np.float32)
        taug.fill_ellipse(ours, (x, y), (ax, ay), angle, 255.0)
        cv2.ellipse(theirs, (x, y), (ax, ay), angle, 0, 360, 255, -1)
        differ += int((ours != theirs).sum())
        area += int((theirs > 0).sum())
    assert differ < 0.02 * area, (differ, area)


def test_each_lg_step_matches_jax():
    """Every step of the ``lg`` chain forced on, one at a time."""
    img = np.random.default_rng(9).uniform(size=(48, 64, 3)).astype(np.float32)
    for fn in ("random_hue_saturation", "random_brightness_contrast", "random_gamma",
               "random_blur", "random_noise"):
        for seed in range(3):
            out = getattr(taug, fn)(img, np.random.default_rng(seed), p=1.0)
            jout = getattr(jaug, fn)(img, np.random.default_rng(seed), p=1.0)
            np.testing.assert_allclose(out, jout, atol=1e-6, err_msg=fn)
    out = taug.random_additive_shade(img, np.random.default_rng(0), p=1.0)
    jout = jaug.random_additive_shade(img, np.random.default_rng(0), p=1.0)
    assert np.abs(out - jout).mean() < 2e-3


# --- the dataset and the loader ------------------------------------------------------------

def test_getitem_matches_jax(cv2_ellipses):
    """Items at a small canvas from the same source images (the scenes'
    renderer is held to JAX's in tests/test_torch_train.py): images within
    one uint8 level but on under 2% of the pixels (a colour one level off
    before the HSV round trip), H_0to1 within 1e-5 relative, the same draws
    (the generators end equal)."""
    ours = HomographyDataset(HOST).get_dataset("train")
    theirs = JHomographyDataset(HOST).get_dataset("train")
    for idx in range(4):
        theirs._cache[idx] = ours.source_image(idx)
        rng, jrng = np.random.default_rng((3, 1, idx)), np.random.default_rng((3, 1, idx))
        item, jitem = ours.getitem(idx, rng), theirs.getitem(idx, jrng)
        assert rng.uniform() == jrng.uniform()
        assert item["name"] == jitem["name"] and item["idx"] == jitem["idx"]
        scale = np.abs(jitem["H_0to1"]).max()
        np.testing.assert_allclose(item["H_0to1"] / scale, jitem["H_0to1"] / scale, atol=1e-5)
        for view in ("view0", "view1"):
            a, b = item[view]["image"], jitem[view]["image"]
            assert a.shape == b.shape == (96, 96, 3) and a.dtype == np.float32
            assert (np.abs(a - b) > 1 / 255).mean() < 0.02
            np.testing.assert_array_equal(item[view]["image_size"], jitem[view]["image_size"])
    assert len(ours) == 6 and len(HomographyDataset(HOST).get_dataset("val")) == 2


class _Items:
    """A split whose items record their index and their stream's first draw."""

    def __len__(self):
        return 11

    def getitem(self, idx, rng):
        return {"idx": np.int64(idx), "draw": np.float64(rng.uniform())}


@pytest.mark.parametrize("kind", ["shuffled", "sharded", "overfit"])
def test_loader_matches_jax(kind):
    """Order and per-item streams of JAX's loader over two epochs: shuffled
    with the last partial batch dropped, one shard of two, and the overfit
    loop; read ahead in threads."""
    kwargs = {"shuffled": {"shuffle": True, "drop_last": True},
              "sharded": {"shuffle": True, "shard": 1, "num_shards": 2},
              "overfit": {"shuffle": False, "loop_items": 2}}[kind]
    loaders = [cls(_Items(), 3, seed=7, num_workers=2, **kwargs)
               for cls in (DataLoader, JDataLoader)]
    for epoch in (0, 1):
        batches = []
        for loader in loaders:
            loader.set_epoch(epoch)
            batches.append([(b["idx"].tolist(), b["draw"].tolist()) for b in loader])
        assert batches[0] == batches[1] and len(loaders[0]) == len(loaders[1])
    assert len(batches[0]) == {"shuffled": 3, "sharded": 2, "overfit": 200}[kind]


def test_host_training_and_overfit():
    """The trainer's host path: batches from the loader's threads, their
    strings dropped, the loader's wait reported; then ``train.overfit``,
    every epoch the first item. Every step finite."""
    conf = {"data": {"name": "homographies", **HOST, "image_size": 64},
            "model": __graft_entry__._flagship_conf(tiny=True),
            "train": {"epochs": 1, "eval_every_iter": 100, "log_every_iter": 1}}
    assert get_dataset("homographies") is HomographyDataset
    import tempfile
    from pathlib import Path

    with tempfile.TemporaryDirectory() as tmp:
        trainer, history = training(conf, Path(tmp) / "host", device="cpu")
        assert not trainer.engine and len(history) == 3
        conf["train"].update(overfit=True, epochs=2)
        trainer, overfit = training(conf, Path(tmp) / "overfit", device="cpu", steps=2)
    for h in history + overfit:
        assert np.isfinite(h["loss/total"]) and h["skipped"] == 0.0 and h["data_ms"] >= 0
    batch = next(iter(trainer.loader("train")))
    assert batch["name"] == ["synthetic/0", "synthetic/0"]
