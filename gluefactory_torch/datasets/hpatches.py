"""HPatches sequences benchmark (gluefactory_tpu/datasets/hpatches.py).

On disk: ``<root>/<seq>/{1..6}.ppm`` and the ground-truth homographies
``H_1_{2..6}``; 5 pairs a sequence (image 1 against 2..6). The 8 oversized
sequences of the real release are skipped, as in the JAX package. Each view
is resized and padded onto a static canvas (utils/image.ImagePreprocessor),
and the homography is composed with both views' resize transforms, so it maps
canvas coordinates of view 0 to those of view 1."""

from __future__ import annotations

from pathlib import Path
from typing import ClassVar

import numpy as np

from ..settings import DATA_PATH
from ..utils.image import ImagePreprocessor, read_image
from .base_dataset import BaseDataset, read_ahead

IGNORED_SCENES = (
    "i_contruction", "i_crownnight", "i_dc", "i_pencils", "i_whitebuilding",
    "v_artisans", "v_astronautis", "v_talent",
)


class HPatchesDataset(BaseDataset):
    default_conf: ClassVar[dict] = {
        "name": "hpatches",
        "data_dir": "hpatches-sequences-release",  # absolute, or under DATA_PATH
        "preprocessing": {"resize": 480, "side": "long", "square_pad": True},
        "subset": None,  # 'i' | 'v' | None
        "max_seqs": None,  # cap the number of sequences
        "ignore_large_images": True,
        "grayscale": False,
        "test_batch_size": 1,
        "num_workers": 2,  # threads that read and resize the next batches
    }

    def __init__(self, conf: dict | None = None):
        super().__init__(conf)
        conf = self.conf
        root = Path(conf["data_dir"])
        if not root.is_absolute():
            root = DATA_PATH / conf["data_dir"]
        if not root.exists():
            raise FileNotFoundError(
                f"HPatches not found at {root}: render a set with "
                "python -m gluefactory_torch.scripts.generate_eval_set")
        self.root = root
        sequences = sorted(p.name for p in root.iterdir() if p.is_dir())
        if conf["ignore_large_images"]:
            sequences = [s for s in sequences if s not in IGNORED_SCENES]
        if conf["subset"]:
            sequences = [s for s in sequences if s.startswith(conf["subset"])]
        if conf["max_seqs"]:
            sequences = sequences[:int(conf["max_seqs"])]
        self.sequences = sequences
        self.items = [(seq, i) for seq in sequences for i in range(2, 7)]
        self.preprocessor = ImagePreprocessor(conf["preprocessing"])

    def __len__(self):
        return len(self.items)

    def _read_view(self, seq: str, idx: int) -> dict:
        image = read_image(self.root / seq / f"{idx}.ppm", grayscale=self.conf["grayscale"])
        return self.preprocessor(image)

    def __getitem__(self, i: int) -> dict:
        seq, idx = self.items[i]
        view0 = self._read_view(seq, 1)
        view1 = self._read_view(seq, idx)
        H = np.loadtxt(self.root / seq / f"H_1_{idx}").astype(np.float32)
        # canvas1 <- orig1 <- orig0 <- canvas0
        H = view1["transform"] @ H @ np.linalg.inv(view0["transform"])
        return {"view0": view0, "view1": view1, "H_0to1": H.astype(np.float32),
                "idx": np.int32(i), "name": f"{seq}/{idx}"}

    def get_data_loader(self, split: str = "test"):
        """Batches of ``test_batch_size`` items in order, collated, read
        ahead by ``num_workers`` threads."""
        if split != "test":
            raise ValueError(f"HPatches has only a test split, not {split!r}")
        return read_ahead(self, int(self.conf["test_batch_size"]), int(self.conf["num_workers"]))


__main_dataset__ = HPatchesDataset
