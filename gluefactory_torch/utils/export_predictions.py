"""Run a model over a loader and cache its predictions
(gluefactory_tpu/utils/export_predictions.py), as one ``.npz`` file: a
``names`` array and, for each key, the rows of every name stacked in the
same order. Keypoints and lines go back to original-image pixels (divided by
their view's ``scales``: ``view0``/``view1`` for two-view keys, the item's
own for single-view ``keypoints``/``lines``); float32 is stored as float16.
The JAX package writes one HDF5 group a name; the GPU machine has no HDF5
library."""

from __future__ import annotations

from collections import defaultdict
from pathlib import Path

import numpy as np
import torch


def _scales(batch: dict, key: str, i: int):
    """The scales that map ``key`` of item ``i`` to the canvas, or None."""
    for base in ("keypoints", "lines"):
        if key == base:
            scales = batch.get("scales")
        elif key in (f"{base}0", f"{base}1"):
            scales = batch.get(f"view{key[-1]}", {}).get("scales")
        else:
            continue
        return None if scales is None else np.asarray(scales[i])
    return None


def export_predictions(loader, predict, output_file: Path, keys="*", callback_fn=None,
                       optional_keys=("keypoint_valid0", "keypoint_valid1")) -> Path:
    """``predict(batch)`` -> a dict of batched tensors for each batch of
    ``loader`` (which carries ``name``); ``callback_fn(pred, batch)`` adds
    numpy arrays computed from the canvas-frame predictions. Writes the
    ``keys`` (with ``optional_keys``; ``"*"`` for all) to ``output_file``."""
    output_file = Path(output_file)
    output_file.parent.mkdir(parents=True, exist_ok=True)
    cache = defaultdict(list)
    for batch in loader:
        pred = {k: v.detach().cpu().numpy() for k, v in predict(batch).items()
                if isinstance(v, torch.Tensor)}
        if callback_fn is not None:
            pred = {**pred, **callback_fn(pred, batch)}
        if keys != "*":
            pred = {k: v for k, v in pred.items() if k in set(keys) | set(optional_keys)}
        for i, name in enumerate(batch["name"]):
            cache["names"].append(str(name))
            for key, value in pred.items():
                value = value[i]
                scales = _scales(batch, key, i)
                if scales is not None:
                    value = value / scales
                if value.dtype == np.float32:
                    value = value.astype(np.float16)
                cache[key].append(value)
    np.savez(output_file, **{k: np.stack(v) if k != "names" else np.array(v)
                             for k, v in cache.items()})
    return output_file
