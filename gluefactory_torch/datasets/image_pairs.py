"""A list of image pairs for the benchmarks (gluefactory_tpu/datasets/image_pairs.py).

Each line of ``pairs``:
  - ``im0 im1``                   no geometry;
  - ``im0 im1 h11 ... h33``       9 numbers: the homography of the pair;
  - ``im0 im1 K0(9) K1(9) T(16)`` a calibrated pair, the MegaDepth-1500
    format: both intrinsics and the 4x4 T_0to1, row-major.

Each view is resized and padded onto a static canvas
(``utils.image.ImagePreprocessor``); the homography is composed with both
views' resize transforms and the cameras are scaled with them, so the
ground truth is in canvas pixels. Cameras and poses stay on the host."""

from __future__ import annotations

from pathlib import Path
from typing import ClassVar

import numpy as np

from ..geometry.wrappers import Camera, Pose
from ..settings import DATA_PATH
from ..utils.image import ImagePreprocessor, read_image
from .base_dataset import BaseDataset, read_ahead


def parse_camera(elems: list[str]) -> np.ndarray:
    return np.array([float(x) for x in elems], dtype=np.float32).reshape(3, 3)


def _under_data(path: str) -> Path:
    return Path(path) if Path(path).is_absolute() else DATA_PATH / path


class ImagePairsDataset(BaseDataset):
    default_conf: ClassVar[dict] = {
        "name": "image_pairs",
        "pairs": "???",  # the pairs file, absolute or under DATA_PATH
        "root": "",  # the folder the image paths are relative to
        "preprocessing": {"resize": 1024, "side": "long", "square_pad": True},
        "grayscale": False,
        "test_batch_size": 1,
        "num_workers": 2,  # threads that read and resize the next batches
    }

    def __init__(self, conf: dict | None = None):
        super().__init__(conf)
        pairs_path = _under_data(self.conf["pairs"])
        if not pairs_path.exists():
            raise FileNotFoundError(
                f"pairs file not found: {pairs_path}; render a pose set with "
                "python -m gluefactory_torch.scripts.generate_pose_eval_set")
        self.root = _under_data(self.conf["root"])
        self.pairs = [line.split() for line in pairs_path.read_text().splitlines()
                      if line.strip()]
        self.preprocessor = ImagePreprocessor(self.conf["preprocessing"])

    def __len__(self):
        return len(self.pairs)

    def __getitem__(self, i: int) -> dict:
        name0, name1, *rest = self.pairs[i]
        view0, view1 = (self.preprocessor(read_image(self.root / n, self.conf["grayscale"]))
                        for n in (name0, name1))
        data = {
            "view0": view0,
            "view1": view1,
            "idx": np.int32(i),
            # the relative paths, not the stems: scenes reuse file names
            "name": "_".join(str(Path(n).with_suffix("")).replace("/", "-")
                             for n in (name0, name1)),
        }
        if len(rest) == 9:
            H = np.array([float(x) for x in rest], np.float32).reshape(3, 3)
            H = view1["transform"] @ H @ np.linalg.inv(view0["transform"])
            data["H_0to1"] = H.astype(np.float32)
        elif len(rest) >= 34:
            data["camera0"], data["camera1"] = (
                Camera.from_calibration_matrix(parse_camera(k), size=view["orig_size"])
                .scale(view["scales"])
                for k, view in ((rest[0:9], view0), (rest[9:18], view1)))
            data["T_0to1"] = Pose.from_4x4mat(
                np.array([float(x) for x in rest[18:34]], np.float32).reshape(4, 4))
        return data

    def get_data_loader(self, split: str = "test"):
        """Batches of ``test_batch_size`` pairs in order, collated (cameras and
        poses as lists), read ahead by ``num_workers`` threads."""
        return read_ahead(self, int(self.conf["test_batch_size"]), int(self.conf["num_workers"]))


__main_dataset__ = ImagePairsDataset
