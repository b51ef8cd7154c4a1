"""A folder (or a text list) of images, one view an item
(gluefactory_tpu/datasets/image_folder.py): the input of feature export.

Items are ``ImagePreprocessor`` views (``image``, ``image_size``,
``orig_size``, ``scales``) with ``idx`` and ``name``, the path relative to
the folder. The port reads binary PPM/PGM only: another file that the
``glob`` patterns (JAX's list) match raises, naming its suffix."""

from __future__ import annotations

from pathlib import Path
from typing import ClassVar

import numpy as np

from ..settings import DATA_PATH
from ..utils.image import ImagePreprocessor, read_image
from .base_dataset import BaseDataset, read_ahead


class ImageFolderDataset(BaseDataset):
    default_conf: ClassVar[dict] = {
        "name": "image_folder",
        "images": "???",  # a directory, or a text file listing paths
        "root_folder": "/",  # the folder the listed paths are relative to
        "glob": ["*.jpg", "*.png", "*.jpeg", "*.ppm"],
        "preprocessing": {"resize": 1024, "side": "long", "square_pad": True},
        "grayscale": False,
        "test_batch_size": 1,
    }

    def __init__(self, conf: dict | None = None):
        super().__init__(conf)
        conf = self.conf
        src = Path(conf["images"])
        if not src.is_absolute():
            src = DATA_PATH / conf["images"]
        if src.is_dir():
            self.paths = sorted(p for pat in conf["glob"] for p in src.glob("**/" + pat))
            self.root = src
        elif src.exists():
            self.root = Path(conf["root_folder"])
            self.paths = [self.root / line for line in src.read_text().splitlines()
                          if line.strip()]
        else:
            raise FileNotFoundError(f"images source not found: {src}")
        if not self.paths:
            raise FileNotFoundError(f"no images under {src}")
        self.preprocessor = ImagePreprocessor(conf["preprocessing"])

    def get_dataset(self, split: str = "test"):
        return self

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, idx: int) -> dict:
        path = self.paths[idx]
        view = self.preprocessor(read_image(path, self.conf["grayscale"]))
        return {**view, "idx": np.int32(idx), "name": str(path.relative_to(self.root))}

    def get_data_loader(self, split: str = "test", shuffle=None, **kwargs):
        """Batches of ``test_batch_size`` items in order, collated, read ahead
        by ``num_workers`` threads."""
        return read_ahead(self, self.batch_size("test"), int(self.conf["num_workers"]))


__main_dataset__ = ImageFolderDataset
