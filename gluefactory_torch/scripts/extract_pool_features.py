"""Extract the features of an image pool, the cached-feature engine's
``features_from.on_host`` path (gluefactory_tpu/scripts/extract_pool_features.py).

The JAX package runs this in a CPU subprocess because its TPU backend cannot
trace the host callbacks (cv2's SIFT) of those extractors. The port's
extractors are PyTorch on any device, so ``on_host`` here means that the
features are extracted outside the training step, before the pool is
uploaded, on the engine's device (the card unless the caller asks for the
CPU); the engine calls ``extract_pool_features`` in its own process and this
CLI is a thin wrapper around it. The output holds what the JAX worker
writes: every batched output of the extractor but the ``*_dense`` maps
(SIFT: keypoints, descriptors, keypoint_scores, keypoint_valid, scales,
oris), descriptors as float16, so a pool written by either package feeds
the other.

Usage: python -m gluefactory_torch.scripts.extract_pool_features \\
    --images pool.npz --out feats.npz --extractor extractors.sift \\
    --conf '{"max_num_keypoints": 512}' [--batch 16] [--experiment exp] \\
    [--weights blob] [--remap OLD=NEW] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from ..models import build_model
from ..settings import WEIGHTS_PATH
from ..utils.device import resolve_device
from ..utils.experiments import load_experiment, require_restored, restore_from_flat_dict
from ..utils.weights import load_weight_blob


PARAMS_SCOPE = "['params']"  # begins every key of a weights blob


def remap_keys(flat: dict, remap: str) -> dict:
    """The entries of ``flat`` whose key starts with OLD, or with OLD after
    its ``['params']`` scope, that prefix rewritten to NEW (``remap`` is
    ``OLD=NEW``). The JAX worker takes only the first form, so the recipes'
    ``['extractor']=['point_extractor']`` matches no key of a committed blob
    there and its extractor keeps its initialisation (with a warning a
    parameter); here it loads the blob's extractor, as the recipes name it
    (``remap_is_ports_own``)."""
    old, new = remap.split("=", 1)
    out = {}
    for key, value in flat.items():
        if key.startswith(old):
            out[new + key[len(old):]] = value
        elif key.startswith(PARAMS_SCOPE + old):
            out[PARAMS_SCOPE + new + key[len(PARAMS_SCOPE + old):]] = value
    return out


def remap_is_ports_own(features_from: dict) -> bool:
    """Whether the blob of an ``on_host`` ``features_from`` is loaded through
    ``remap_keys``' second form: its OLD lacks the ``['params']`` scope that
    begins every key of a blob, so the JAX worker's filter keeps none of the
    blob and extracts another pool from the same conf."""
    remap = features_from.get("remap")
    return bool(features_from.get("on_host") and features_from.get("weights") and remap
                and not str(remap).split("=", 1)[0].startswith(PARAMS_SCOPE))


def build_extractor(name: str, conf: dict, device, experiment=None, weights=None,
                    remap: str | None = None) -> torch.nn.Module:
    """The extractor ``name`` with ``conf`` on ``device`` in inference mode,
    initialised from seed 0 (the JAX engine initialises from key 0). Its
    parameters come from ``experiment`` (a run's last checkpoint, a ``.ckpt``
    or a blob; a pipeline's ``['extractor']`` scope is stripped) and then
    from ``weights`` (a blob, under WEIGHTS_PATH where the path is not
    there, its flat keys rewritten by ``remap`` ``OLD=NEW``: ``remap_keys``),
    each restoring every parameter."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = build_model(name, conf, device=device)
    if experiment:
        blob, _ = load_experiment(str(experiment), best=False)
        flat = {k.replace("['extractor']", ""): v for k, v in blob["state"]["params"].items()}
        require_restored(restore_from_flat_dict(model, flat), [experiment])
    if weights:
        path = Path(str(weights))
        if not path.exists():
            path = WEIGHTS_PATH / str(weights)
        flat, _, _ = load_weight_blob(path)
        if remap:
            flat = remap_keys(flat, str(remap))
        require_restored(restore_from_flat_dict(model, flat), [path])
    return model.eval()


def extract_pool_features(images: np.ndarray, model: torch.nn.Module, batch: int,
                          device) -> dict:
    """Every batched output of ``model`` but the ``*_dense`` maps, over the
    uint8 pool ``images`` (n, h, w, c), ``batch`` images a forward; host
    arrays, descriptors as float16."""
    n, h, w = images.shape[:3]
    size = torch.tensor([[float(w), float(h)]], device=device)
    out: dict[str, list] = {}
    with torch.inference_mode():
        for i in range(0, n, batch):
            chunk = torch.from_numpy(images[i:i + batch]).to(device).float() / 255.0
            pred = model({"image": chunk, "image_size": size.expand(chunk.shape[0], 2)})
            for key, value in pred.items():
                if (key.endswith("_dense") or not isinstance(value, torch.Tensor)
                        or value.ndim == 0 or value.shape[0] != chunk.shape[0]):
                    continue
                value = value.cpu().numpy()
                out.setdefault(key, []).append(
                    value.astype(np.float16) if key == "descriptors" else value)
    return {key: np.concatenate(parts) for key, parts in out.items()}


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--images", required=True, help="an .npz holding 'images'")
    parser.add_argument("--out", required=True)
    parser.add_argument("--extractor", default="extractors.superpoint")
    parser.add_argument("--conf", default="{}", help="the extractor's conf as JSON")
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--experiment", default=None)
    parser.add_argument("--weights", default=None, help="a committed weights blob")
    parser.add_argument("--remap", default=None, help="flat-key prefix rewrite OLD=NEW")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    with np.load(args.images) as blob:
        images = blob["images"]
    model = build_extractor(args.extractor, json.loads(args.conf), device, args.experiment,
                            args.weights, args.remap)
    out = extract_pool_features(images, model, args.batch, device)
    np.savez(args.out, **out)
    print(f"extracted {len(images)} pool images ({sorted(out)}) -> {args.out}")


if __name__ == "__main__":
    main()
