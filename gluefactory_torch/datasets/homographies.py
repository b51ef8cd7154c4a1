"""The host homography dataset (gluefactory_tpu/datasets/homographies.py):
pairs of views of one source image under two random homographies, made on
the host by the training loader's threads (``base_dataset.DataLoader``),
for recipes that train on images too large or too many for the on-device
engine's pool (``superpoint+lightglue_homography.yaml``).

Each item draws its homographies (``sample_homography_corners``) and its
photometric augmentation (``augmentations``) from the generator the loader
gives it, as the JAX dataset does, and warps the source onto a static
``image_size`` canvas (``utils/image.warp_perspective`` in float32;
``right_only`` keeps view 0 a plain resize). The source is procedural
(``synthetic: true``: ``generate_structured_image``, the JAX scene drawn by
numpy rasterisers with the same random draws) or an image of ``data_dir``
(binary PPM/PGM, what ``utils/image.read_image`` reads). Cached features
(``load_features.do``, HDF5) are not ported."""

from __future__ import annotations

from pathlib import Path
from typing import ClassVar

import numpy as np

from .. import settings
from ..geometry.homography import sample_homography_corners
from ..utils.image import read_image, warp_perspective
from .augmentations import augmentations
from .base_dataset import BaseDataset
from .homographies_ondevice import draw_line, fill_ellipse, fill_polygon, fill_rectangle


def generate_structured_image(rng: np.random.Generator, size=(800, 600)) -> np.ndarray:
    """A float32 (h, w, 3) image in [0, 1] for ``size`` (w, h)."""
    w, h = size
    gx = np.linspace(0, 1, w, dtype=np.float32)[None, :]
    gy = np.linspace(0, 1, h, dtype=np.float32)[:, None]
    a, b, c = rng.uniform(0.1, 0.9, 3)
    img = (a * gx + b * gy + c) / (a + b + c + 1e-8)
    img = np.repeat(img[..., None], 3, axis=2)
    img *= rng.uniform(0.4, 1.0, size=(1, 1, 3)).astype(np.float32)
    img = np.ascontiguousarray(img)
    for _ in range(int(rng.integers(10, 30))):
        color = tuple(float(x) for x in rng.uniform(0, 1, 3))
        kind = rng.integers(0, 4)
        if kind == 0:  # polygon
            n_pts = int(rng.integers(3, 7))
            cx, cy = rng.uniform(0, w), rng.uniform(0, h)
            r = rng.uniform(10, min(w, h) / 4)
            ang = np.sort(rng.uniform(0, 2 * np.pi, n_pts))
            pts = np.stack([cx + r * np.cos(ang), cy + r * np.sin(ang)], -1).astype(np.int32)
            fill_polygon(img, pts.astype(np.float64), color)
        elif kind == 1:  # rectangle
            x0, y0 = rng.uniform(0, w - 20), rng.uniform(0, h - 20)
            x1, y1 = x0 + rng.uniform(10, w / 3), y0 + rng.uniform(10, h / 3)
            fill_rectangle(img, int(x0), int(y0), int(x1), int(y1), color)
        elif kind == 2:  # ellipse
            center = (int(rng.uniform(0, w)), int(rng.uniform(0, h)))
            axes = (int(rng.uniform(5, w / 6)), int(rng.uniform(5, h / 6)))
            fill_ellipse(img, center, axes, float(rng.uniform(0, 180)), color)
        else:  # line
            p0 = (int(rng.uniform(0, w)), int(rng.uniform(0, h)))
            p1 = (int(rng.uniform(0, w)), int(rng.uniform(0, h)))
            draw_line(img, p0, p1, color, int(rng.integers(1, 5)))
    img += rng.normal(0, 0.02, img.shape).astype(np.float32)
    return np.clip(img, 0.0, 1.0)


class HomographyDataset(BaseDataset):
    default_conf: ClassVar[dict] = {
        "name": "homographies",
        "data_dir": "revisitop1m",  # absolute, or under DATA_PATH
        "image_list": None,  # a text file of paths relative to data_dir
        "glob": ["*.jpg", "*.png", "*.jpeg"],
        "synthetic": False,
        "synthetic_size": 20000,
        "synthetic_source_size": [800, 600],
        "source_cache_size": 2048,  # source images kept in memory, per split
        "train_size": 100000,
        "val_size": 500,
        "image_size": 320,  # the square canvas of each view
        "right_only": False,  # view 0 a plain resize
        "homography": {"difficulty": 0.7, "translation": 0.3, "max_angle": 45.0,
                       "n_angles": 10},
        "photometric": {"name": "lg", "p": 0.95},
        "grayscale": False,
        "load_features": {"do": False, "path": "", "padding_length": 512,
                          "min_inside": 8},  # HDF5: not ported
    }

    def __init__(self, conf: dict | None = None):
        super().__init__(conf)
        conf = self.conf
        if conf["load_features"]["do"]:
            raise NotImplementedError("load_features (cached HDF5 features) is not ported")
        self.image_paths = None
        if not conf["synthetic"]:
            root = Path(conf["data_dir"])
            if not root.is_absolute():
                root = settings.DATA_PATH / root
            if conf["image_list"]:
                names = Path(conf["image_list"]).read_text().splitlines()
                self.image_paths = [root / n for n in names if n.strip()]
            else:
                self.image_paths = sorted(p for pat in conf["glob"] for p in root.glob("**/" + pat))
            if not self.image_paths:
                raise FileNotFoundError(f"No images found under {root}; set "
                                        "data.synthetic=true to train without downloads")
        self.photometric = augmentations[conf["photometric"]["name"]]()

    def get_dataset(self, split: str) -> "HomographySplit":
        return HomographySplit(self, split)


class HomographySplit:
    """The items of one split: ``getitem(idx, rng)``."""

    def __init__(self, parent: HomographyDataset, split: str):
        self.conf, self.parent, self.split = parent.conf, parent, split
        self._cache: dict = {}  # idx -> source image
        self._cache_cap = int(self.conf.get("source_cache_size", 2048))

    def __len__(self) -> int:
        conf = self.conf
        n = int(conf["synthetic_size"]) if conf["synthetic"] else len(self.parent.image_paths)
        return min(n, int(conf["val_size"] if self.split == "val" else conf["train_size"]))

    def source_image(self, idx: int) -> np.ndarray:
        """Source ``idx`` as float32 (h, w, 3) in [0, 1], kept in memory while
        the cache has room."""
        cached = self._cache.get(idx)
        if cached is not None:
            return cached
        if self.conf["synthetic"]:
            salt = 7919 if self.split == "val" else 0  # disjoint from train's
            rng = np.random.default_rng((int(self.conf["seed"]), idx + salt))
            img = generate_structured_image(rng, tuple(self.conf["synthetic_source_size"]))
        else:
            img = read_image(self.parent.image_paths[idx]).astype(np.float32) / 255.0
        if len(self._cache) < self._cache_cap:
            self._cache[idx] = img
        return img

    def warp_view(self, image: np.ndarray, rng: np.random.Generator,
                  identity: bool = False) -> dict:
        """One view: the source warped onto the canvas by a random homography
        (or resized), then augmented with probability ``photometric.p``."""
        conf = self.conf
        s = int(conf["image_size"])
        h, w = image.shape[:2]
        if identity:
            H = np.array([[s / w, 0, 0], [0, s / h, 0], [0, 0, 1]], dtype=np.float32)
        else:
            hconf = conf["homography"]
            H, _ = sample_homography_corners(
                (w, h), (s, s), difficulty=float(hconf["difficulty"]),
                translation=float(hconf["translation"]), max_angle=float(hconf["max_angle"]),
                n_angles=int(hconf["n_angles"]), rng=rng)
        warped = warp_perspective(image, H, (s, s))
        if warped.ndim == 2:
            warped = warped[..., None]
        if rng.uniform() < float(conf["photometric"]["p"]):
            warped = self.parent.photometric(warped, rng)
        if conf["grayscale"] and warped.shape[2] == 3:
            warped = warped.mean(axis=2, keepdims=True)
        return {"image": warped.astype(np.float32),
                "image_size": np.array([s, s], dtype=np.float32), "H_": H.astype(np.float32)}

    def getitem(self, idx: int, rng: np.random.Generator) -> dict:
        image = self.source_image(idx)
        view0 = self.warp_view(image, rng, identity=bool(self.conf["right_only"]))
        view1 = self.warp_view(image, rng)
        H0, H1 = view0.pop("H_"), view1.pop("H_")
        name = (f"synthetic/{idx}" if self.conf["synthetic"]
                else str(self.parent.image_paths[idx].name))
        return {"view0": view0, "view1": view1,
                "H_0to1": (H1 @ np.linalg.inv(H0)).astype(np.float32),
                "idx": np.int32(idx), "name": name}

    def __getitem__(self, idx: int) -> dict:
        return self.getitem(idx, np.random.default_rng(idx))


__main_dataset__ = HomographyDataset
