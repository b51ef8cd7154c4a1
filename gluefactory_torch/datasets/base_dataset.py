"""Datasets (gluefactory_tpu/datasets/base_dataset.py), as far as the
on-device engines and the benchmarks need: a conf dict merged over the
``default_conf`` of the class and its bases, lookup by name, and the
benchmarks' collated loader that reads ahead in threads."""

from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import ClassVar

import numpy as np

from ..core.config import collect_defaults, merge
from ..core.registry import resolve_component


class BaseDataset:
    default_conf: ClassVar[dict] = {"name": None, "seed": 0}

    def __init__(self, conf: dict | None = None):
        self.conf = merge(collect_defaults(type(self)), conf)


def get_dataset(name: str) -> type[BaseDataset]:
    """The dataset class of module ``gluefactory_torch.datasets.<name>``."""
    return resolve_component(name, "gluefactory_torch.datasets", (), "__main_dataset__")


def collate(items: list[dict]) -> dict:
    """Stack numpy arrays along a new batch axis; other values become lists."""
    out = {}
    for key, value in items[0].items():
        if isinstance(value, dict):
            out[key] = collate([item[key] for item in items])
        elif isinstance(value, (np.ndarray, np.generic)):
            out[key] = np.stack([item[key] for item in items])
        else:
            out[key] = [item[key] for item in items]
    return out


def read_ahead(dataset, batch_size: int, workers: int):
    """Collated batches of ``dataset[i]`` in order, each of ``batch_size``
    items, read ahead by ``workers`` threads (numpy releases the interpreter
    lock in the resizes)."""
    batches = [range(s, min(s + batch_size, len(dataset)))
               for s in range(0, len(dataset), batch_size)]
    workers = max(workers, 1)
    with ThreadPoolExecutor(workers) as pool:
        pending = deque()
        for indices in batches:
            pending.append(pool.submit(lambda ids: collate([dataset[i] for i in ids]), indices))
            if len(pending) > 2 * workers:
                yield pending.popleft().result()
        while pending:
            yield pending.popleft().result()
