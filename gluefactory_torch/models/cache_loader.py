"""Cached per-sample predictions (gluefactory_tpu/models/cache_loader.py):
the rows of a prediction cache by sample name, as the benchmarks' second
phase and cached-feature matching read them.

A cache is the ``.npz`` file of ``utils.export_predictions`` (and of
``EvalPipeline.get_predictions``): a ``names`` array and each key's rows in
that order, float32 stored as float16, keypoints and lines in
original-image pixels. ``path`` may hold ``{scene}``, filled with the part
of the name before its first ``/``. The writer divides a single view's
``keypoints``/``lines`` by the item's own ``scales``; given ``data['scales']``
the loader multiplies them back, where JAX's loader scales only the two-view
keys."""

from __future__ import annotations

from typing import ClassVar

import numpy as np

from ..core.config import merge
from ..datasets.base_dataset import collate


def pad_to_length(x: np.ndarray, length: int):
    """``x`` padded with zeros (or cut) to ``length`` rows, and the mask of
    its own rows."""
    n = x.shape[0]
    valid = np.zeros(length, dtype=bool)
    valid[:min(n, length)] = True
    if n >= length:
        return x[:length], valid
    return np.pad(x, [(0, length - n)] + [(0, 0)] * (x.ndim - 1)), valid


def pad_local_features(pred: dict, seq_l: int) -> dict:
    """The local features of each view (``0``, ``1`` or a single view)
    padded to ``seq_l`` slots, with their ``keypoint_valid`` masks."""
    out = dict(pred)
    for vid in ("0", "1", ""):
        kk = f"keypoints{vid}"
        if kk not in pred:
            continue
        out[kk], out[f"keypoint_valid{vid}"] = pad_to_length(pred[kk], seq_l)
        for key in (f"keypoint_scores{vid}", f"descriptors{vid}", f"scales{vid}",
                    f"oris{vid}", f"depth_keypoints{vid}"):
            if key in pred:
                out[key], _ = pad_to_length(pred[key], seq_l)
    return out


class CacheLoader:
    """A callable, not a model: cached features have no parameters.
    ``loader(data)`` reads the row of each of ``data['name']``, keeps
    ``data_keys`` (all when None), casts float16 to ``numeric_type``,
    multiplies the keys named by ``scale`` (with the view's suffix, 0 or 1,
    or none) by ``data['view0'|'view1']['scales']`` (``data['scales']``)
    back onto the canvas, pads to ``padding_length`` and collates (one name
    gives its dict)."""

    default_conf: ClassVar[dict] = {
        "path": "???",  # may contain {scene}
        "data_keys": None,  # None: all
        "collate": True,
        "scale": ["keypoints", "lines"],
        "padding_length": None,
        "numeric_type": "float32",
    }

    def __init__(self, conf: dict | None = None):
        self.conf = merge(self.default_conf, conf)
        self._files: dict[str, tuple[dict, dict]] = {}

    def _file(self, path: str) -> tuple[dict, dict]:
        """(each key's rows, the row of each name) of a cache, read once."""
        if path not in self._files:
            with np.load(path) as f:
                arrays = {k: f[k] for k in f.files}
            rows = {str(n): i for i, n in enumerate(arrays.pop("names"))}
            self._files[path] = arrays, rows
        return self._files[path]

    def __call__(self, data: dict):
        names = data["name"]
        if isinstance(names, str):
            names = [names]
        conf = self.conf
        batch = []
        for i, name in enumerate(names):
            name = str(name)
            arrays, rows = self._file(
                str(conf["path"]).format(scene=name.split("/")[0] if "/" in name else ""))
            if name not in rows:
                raise KeyError(f"{name!r} is not in the cache {conf['path']}")
            pred = {k: v[rows[name]] for k, v in arrays.items()}
            if conf["data_keys"] is not None:
                pred = {k: v for k, v in pred.items() if k in list(conf["data_keys"])}
            if conf["numeric_type"]:
                pred = {k: v.astype(conf["numeric_type"]) if v.dtype == np.float16 else v
                        for k, v in pred.items()}
            for vid in ("0", "1", ""):
                scales = data.get(f"view{vid}", {}).get("scales") if vid else data.get("scales")
                if scales is None:
                    continue
                scales = np.asarray(scales)
                s = scales[i] if scales.ndim > 1 else scales
                for base in conf["scale"]:
                    if f"{base}{vid}" in pred:
                        pred[f"{base}{vid}"] = pred[f"{base}{vid}"] * s
            if conf["padding_length"]:
                pred = pad_local_features(pred, int(conf["padding_length"]))
            batch.append(pred)
        if not conf["collate"] or len(batch) == 1:
            return batch[0] if len(batch) == 1 else batch
        return collate(batch)

    def close(self):
        self._files.clear()

