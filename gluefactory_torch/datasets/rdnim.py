"""RDNIM, the Rotated Day-Night Image Matching pairs (gluefactory_tpu/datasets/rdnim.py).

``<data_dir>/<reference>/`` (reference 'day' or 'night') holds, in any
folder below it, ``H_<stem>`` (the homography from the reference image to
the query) beside ``<stem>_ref.ppm`` and ``<stem>_query.ppm``, as
``scripts/generate_rdnim_set.py`` writes them. The port reads PPM/PGM only:
a release whose pairs are JPEG (``<stem>_ref.jpg``) is refused with an error
that names the missing decoder; no other file is read in its place. Items
are in the order of the sorted ``H_*`` paths, each view resized and padded
by ``preprocessing``, with H mapped onto the two canvases."""

from __future__ import annotations

from pathlib import Path
from typing import ClassVar

import numpy as np

from ..settings import DATA_PATH
from ..utils.image import ImagePreprocessor, read_image
from .base_dataset import BaseDataset, read_ahead


class RDNIMDataset(BaseDataset):
    default_conf: ClassVar[dict] = {
        "name": "rdnim",
        "data_dir": "RDNIM",
        "reference": "day",
        "preprocessing": {"resize": 480, "side": "long", "square_pad": True},
        "test_batch_size": 1,
    }

    def __init__(self, conf: dict | None = None):
        super().__init__(conf)
        root = Path(self.conf["data_dir"])
        if not root.is_absolute():
            root = DATA_PATH / root
        ref_dir = root / self.conf["reference"]
        if not ref_dir.exists():
            raise FileNotFoundError(f"RDNIM reference dir not found: {ref_dir}: render a set "
                                    "with python -m gluefactory_torch.scripts.generate_rdnim_set")
        self.pairs = []
        for h_file in sorted(ref_dir.glob("**/H_*")):
            stem = h_file.name[2:]
            ref, query = (h_file.parent / f"{stem}_{v}.ppm" for v in ("ref", "query"))
            if ref.exists() and query.exists():
                self.pairs.append((ref, query, h_file))
            elif (h_file.parent / f"{stem}_ref.jpg").exists():
                raise IOError(f"{h_file.parent}: the RDNIM pair {stem} is JPEG, and the port "
                              "has no JPEG decoder (it reads PPM/PGM only): render the set with "
                              "gluefactory_torch.scripts.generate_rdnim_set or convert it")
        if not self.pairs:
            raise FileNotFoundError(f"no RDNIM pairs under {ref_dir}")
        self.preprocessor = ImagePreprocessor(self.conf["preprocessing"])

    def __len__(self):
        return len(self.pairs)

    def __getitem__(self, idx: int) -> dict:
        ref, query, h_file = self.pairs[idx]
        view0 = self.preprocessor(read_image(ref))
        view1 = self.preprocessor(read_image(query))
        H = np.loadtxt(h_file).astype(np.float32).reshape(3, 3)
        H = view1["transform"] @ H @ np.linalg.inv(view0["transform"])
        return {"view0": view0, "view1": view1, "H_0to1": H.astype(np.float32),
                "idx": np.int32(idx), "name": f"{h_file.parent.name}/{h_file.name}"}

    def get_data_loader(self, split: str = "test"):
        """Batches of ``test_batch_size`` pairs in order, collated, read
        ahead by ``num_workers`` threads."""
        return read_ahead(self, int(self.conf["test_batch_size"]), int(self.conf["num_workers"]))


__main_dataset__ = RDNIMDataset
