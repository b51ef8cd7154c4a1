"""Cache local features of a dataset's single views
(gluefactory_tpu/scripts/export_features.py): an extractor runs over every
item on the device and its keypoints (original-image pixels), scores,
descriptors (float16), validity and, where the extractor has them, scales
and orientations are written to one ``.npz`` cache
(``utils.export_predictions``), optionally with the depth at each keypoint
(``get_kp_depth``, for items that carry a ``depth`` map). ``CacheLoader``
reads it back; a ``TwoViewPipeline`` with ``allow_no_extract`` then matches
from the views' ``cache``.

The JAX script writes HDF5 and leaves keypoints on the canvas of the
preprocessed image (its export rescales only two-view keys); here they are
in original-image pixels, as its docstring states.

Usage: python -m gluefactory_torch.scripts.export_features --dataset image_folder
    --method extractors.superpoint --output sp.npz [--weights blob]
    [--with_depth] [--device cuda] [data.images=... model.max_num_keypoints=1024 ...]
(a relative --output goes under DATA_PATH/exports)."""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from ..core.config import dotlist_to_dict
from ..datasets import get_dataset
from ..eval.eval_pipeline import to_model_input
from ..geometry.depth import sample_depth
from ..models.cache_loader import CacheLoader
from ..settings import DATA_PATH
from ..utils.device import resolve_device
from ..utils.export_predictions import export_predictions
from .extract_pool_features import build_extractor

EXPORT_KEYS = ["keypoints", "keypoint_scores", "descriptors", "keypoint_valid", "scales", "oris"]


def get_kp_depth(pred: dict, batch: dict) -> dict:
    """The depth map of each item sampled at its (canvas) keypoints, and
    where that depth is valid; nothing for items without ``depth``."""
    depth = batch.get("depth")
    if depth is None:
        return {}
    d, valid = sample_depth(torch.as_tensor(pred["keypoints"]), torch.as_tensor(depth))
    return {"depth_keypoints": d.numpy(), "valid_depth_keypoints": valid.numpy()}


def export_features(dataset, model: torch.nn.Module, output: Path, device="cuda",
                    with_depth: bool = False, keys=EXPORT_KEYS, split: str = "test") -> Path:
    """Run ``model`` over ``dataset``'s loader of ``split`` in order on
    ``device`` and write ``keys`` of each item to ``output``; returns the
    path."""
    device = resolve_device(device)
    model = model.to(device).eval()

    def predict(batch):
        with torch.inference_mode():
            return model(to_model_input(batch, device))

    loader = dataset.get_data_loader(split, shuffle=False)
    return export_predictions(loader, predict, output, keys=keys,
                              callback_fn=get_kp_depth if with_depth else None)


def view_cache(loader: CacheLoader, name: str, scales, device,
               keys=("keypoints", "keypoint_scores", "descriptors", "keypoint_valid")) -> dict:
    """The cached features of one image, batched as one view's ``cache`` of
    a ``TwoViewPipeline`` with ``allow_no_extract``: float32 on ``device``,
    keypoints back on the view's canvas (``loader`` given its ``scales``)."""
    row = loader({"name": [name], "scales": np.asarray(scales, np.float32)})
    return {k: torch.from_numpy(np.asarray(row[k]))[None].to(device) for k in keys if k in row}


def main(argv: list[str] | None = None) -> Path:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--dataset", type=str, required=True)
    parser.add_argument("--method", type=str, required=True)
    parser.add_argument("--output", type=str, required=True)
    parser.add_argument("--split", type=str, default="test")
    parser.add_argument("--with_depth", action="store_true")
    parser.add_argument("--weights", default=None, help="a committed weights blob")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("dotlist", nargs="*")
    args = parser.parse_intermixed_args(argv)
    cli = dotlist_to_dict(args.dotlist)
    device = resolve_device(args.device)
    dataset = get_dataset(args.dataset)(cli.get("data", {}))
    model = build_extractor(args.method, cli.get("model", {}), device, weights=args.weights)
    out = Path(args.output)
    if not out.is_absolute():
        out = DATA_PATH / "exports" / out
    export_features(dataset, model, out, device, args.with_depth, split=args.split)
    with np.load(out) as f:
        print(f"exported the features of {len(f['names'])} images to {out}")
    return out


if __name__ == "__main__":
    main()
