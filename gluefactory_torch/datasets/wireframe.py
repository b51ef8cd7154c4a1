"""Wireframe: single images with ground-truth junctions and segments
(gluefactory_tpu/datasets/wireframe.py).

``<data_dir>/{train,test}/*.npz``, each holding ``image`` (H, W, 3) uint8 (or
floats in [0, 1]), ``junctions`` (J, 2) and ``lines`` (L, 2) pairs of
junction indices, as ``scripts/generate_wireframe_set.py`` writes them. An
item is the preprocessed view with the junctions scaled onto its canvas in
``max_junctions`` slots and the segments in ``max_lines`` slots, each with a
validity mask. Loaders go in file order ('val' reads the test split)."""

from __future__ import annotations

from pathlib import Path
from typing import ClassVar

import numpy as np

from ..settings import DATA_PATH
from ..utils.image import ImagePreprocessor
from .base_dataset import BaseDataset, read_ahead


class WireframeDataset(BaseDataset):
    default_conf: ClassVar[dict] = {
        "name": "wireframe",
        "data_dir": "wireframe",
        "max_junctions": 512,
        "max_lines": 512,
        "preprocessing": {"resize": 512, "side": "long", "square_pad": True},
        "train_batch_size": 4,
    }

    def __init__(self, conf: dict | None = None):
        super().__init__(conf)
        root = Path(self.conf["data_dir"])
        if not root.is_absolute():
            root = DATA_PATH / root
        if not root.exists():
            raise FileNotFoundError(f"wireframe data not found at {root}: render a set with "
                                    "python -m gluefactory_torch.scripts.generate_wireframe_set")
        self.root = root
        self.preprocessor = ImagePreprocessor(self.conf["preprocessing"])

    def get_dataset(self, split: str) -> "WireframeSplit":
        split_dir = self.root / ("test" if split in ("test", "val") else "train")
        files = sorted(split_dir.glob("*.npz"))
        if not files:
            raise FileNotFoundError(f"no npz files under {split_dir}")
        return WireframeSplit(self, files)

    def get_data_loader(self, split: str = "test", **_):
        """Batches of the split's images in order, collated, read ahead by
        ``num_workers`` threads."""
        return read_ahead(self.get_dataset(split), self.batch_size(split),
                          int(self.conf["num_workers"]))


class WireframeSplit:
    def __init__(self, parent: WireframeDataset, files: list[Path]):
        self.parent, self.conf, self.files = parent, parent.conf, files

    def __len__(self):
        return len(self.files)

    def __getitem__(self, idx: int) -> dict:
        with np.load(self.files[idx], allow_pickle=False) as blob:
            image, junctions, line_idx = blob["image"], blob["junctions"], blob["lines"]
        if image.dtype != np.uint8:
            image = (np.clip(image, 0, 1) * 255).astype(np.uint8)
        view = self.parent.preprocessor(image)
        junctions = junctions.astype(np.float32) * view["scales"]
        segments = junctions[line_idx.astype(np.int64)]
        n_j, n_l = int(self.conf["max_junctions"]), int(self.conf["max_lines"])

        def slots(x, n):
            out = np.zeros((n, *x.shape[1:]), np.float32)
            valid = np.zeros((n,), bool)
            k = min(len(x), n)
            out[:k], valid[:k] = x[:k], True
            return out, valid

        gt_j, gt_jv = slots(junctions, n_j)
        gt_l, gt_lv = slots(segments, n_l)
        return {**view, "gt_junctions": gt_j, "gt_junction_valid": gt_jv, "gt_segments": gt_l,
                "gt_segment_valid": gt_lv, "idx": np.int32(idx), "name": self.files[idx].stem}


__main_dataset__ = WireframeDataset
