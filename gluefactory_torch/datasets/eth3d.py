"""ETH3D two-view pairs for the matching AP benchmark
(gluefactory_tpu/datasets/eth3d.py): the undistorted ETH3D training scenes,
or the set that ``scripts/generate_eth3d_set.py`` renders, on disk as

    <root>/<scene>/images/<name>
    <root>/<scene>/dslr_calibration_undistorted/{cameras,images}.txt

(COLMAP's text model). The pairs of a scene are its images that share at
least ``min_covisible`` 3-D points; a scene with more than
``max_pairs_per_scene`` keeps that many, drawn by ``rng.choice`` from one
``default_rng(seed)`` over the scenes in order, as the JAX package draws
them. Each view is preprocessed onto the canvas with its camera scaled
alike; ``T_0to1`` maps camera 0 to camera 1. ``read_depth`` is kept for
the conf's sake: the JAX dataset reads no depth whatever its value, and
neither does this one."""

from __future__ import annotations

import logging
from pathlib import Path
from typing import ClassVar

import numpy as np

from ..geometry.wrappers import Camera, Pose
from ..settings import DATA_PATH
from ..utils.image import ImagePreprocessor, read_image
from .base_dataset import BaseDataset, read_ahead

logger = logging.getLogger(__name__)


def qvec2rotmat(q) -> np.ndarray:
    """COLMAP (w, x, y, z) quaternion -> rotation matrix."""
    w, x, y, z = q
    return np.array([
        [1 - 2 * y**2 - 2 * z**2, 2 * x * y - 2 * z * w, 2 * x * z + 2 * y * w],
        [2 * x * y + 2 * z * w, 1 - 2 * x**2 - 2 * z**2, 2 * y * z - 2 * x * w],
        [2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w, 1 - 2 * x**2 - 2 * y**2],
    ])


def read_colmap_model_text(model_dir: Path) -> tuple[dict, dict]:
    """(cameras {id: (model, w, h, params)}, images {id: {R, t, camera_id,
    name, p3d_ids}}) of a COLMAP text model; ``p3d_ids`` are the ids of the
    3-D points an image sees."""
    cameras = {}
    for line in (model_dir / "cameras.txt").read_text().splitlines():
        if line.startswith("#") or not line.strip():
            continue
        el = line.split()
        cameras[int(el[0])] = (el[1], int(el[2]), int(el[3]), [float(x) for x in el[4:]])
    lines = [line for line in (model_dir / "images.txt").read_text().splitlines()
             if not line.startswith("#") and line.strip()]
    images = {}
    for i in range(0, len(lines), 2):
        el = lines[i].split()
        p3d_ids = np.array([int(x) for x in lines[i + 1].split()[2::3]], np.int64)
        images[int(el[0])] = {
            "R": qvec2rotmat([float(x) for x in el[1:5]]),
            "t": np.array([float(x) for x in el[5:8]]), "camera_id": int(el[8]),
            "name": el[9], "p3d_ids": p3d_ids[p3d_ids >= 0],
        }
    return cameras, images


class ETH3DDataset(BaseDataset):
    default_conf: ClassVar[dict] = {
        "name": "eth3d",
        "data_dir": "ETH3D_undistorted",  # absolute, or under DATA_PATH
        "min_covisible": 500,
        "max_pairs_per_scene": 50,
        "preprocessing": {"resize": 1024, "side": "long", "square_pad": True},
        "read_depth": False,  # not read, as in the JAX package
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
                f"ETH3D not found at {root}: render a set with "
                "python -m gluefactory_torch.scripts.generate_eth3d_set")
        self.root = root
        self.items = []
        rng = np.random.default_rng(int(conf["seed"]))
        for scene_dir in sorted(root.iterdir()):
            model_dir = scene_dir / "dslr_calibration_undistorted"
            if not model_dir.exists():
                continue
            cameras, images = read_colmap_model_text(model_dir)
            ids = sorted(images)
            pairs = []
            for a_i, a in enumerate(ids):
                for b in ids[a_i + 1:]:
                    cov = len(np.intersect1d(images[a]["p3d_ids"], images[b]["p3d_ids"]))
                    if cov >= int(conf["min_covisible"]):
                        pairs.append((a, b))
            if len(pairs) > int(conf["max_pairs_per_scene"]):
                sel = rng.choice(len(pairs), int(conf["max_pairs_per_scene"]), replace=False)
                pairs = [pairs[i] for i in sel]
            self.items += [(scene_dir.name, cameras, images, a, b) for a, b in pairs]
        logger.info("[eth3d] %d covisible pairs", len(self.items))
        self.preprocessor = ImagePreprocessor(conf["preprocessing"])

    def get_dataset(self, split: str = "test"):
        return self

    def __len__(self):
        return len(self.items)

    def _view(self, scene: str, cameras: dict, im: dict) -> dict:
        view = self.preprocessor(read_image(self.root / scene / "images" / im["name"]))
        model, w, h, params = cameras[im["camera_id"]]
        if model in ("PINHOLE", "OPENCV"):
            f, c = np.array(params[0:2]), np.array(params[2:4])
        else:  # SIMPLE_PINHOLE / SIMPLE_RADIAL
            f, c = np.array([params[0], params[0]]), np.array(params[1:3])
        view["camera"] = Camera.from_fc(size=np.array([w, h], np.float32),
                                        f=f.astype(np.float32),
                                        c=c.astype(np.float32)).scale(view["scales"])
        return view

    def __getitem__(self, idx: int) -> dict:
        scene, cameras, images, a, b = self.items[idx]
        im0, im1 = images[a], images[b]
        T0 = Pose.from_Rt(im0["R"].astype(np.float32), im0["t"].astype(np.float32))
        T1 = Pose.from_Rt(im1["R"].astype(np.float32), im1["t"].astype(np.float32))
        return {
            "view0": self._view(scene, cameras, im0),
            "view1": self._view(scene, cameras, im1),
            "T_0to1": T1.compose(T0.inv()),
            "idx": np.int32(idx),
            "name": f"{scene}/{a}_{b}",
        }

    def get_data_loader(self, split: str = "test", shuffle=None, **kwargs):
        """Batches of ``test_batch_size`` pairs in order, collated (cameras
        and poses as lists), read ahead by ``num_workers`` threads."""
        return read_ahead(self, self.batch_size("test"), int(self.conf["num_workers"]))


__main_dataset__ = ETH3DDataset
