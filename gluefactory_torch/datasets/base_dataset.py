"""Datasets (gluefactory_tpu/datasets/base_dataset.py): a conf dict merged
over the ``default_conf`` of the class and its bases, lookup by name, the
training loader (``DataLoader``: JAX's per-epoch order and per-item random
streams, read ahead in worker processes) and the benchmarks' collated
loader (``read_ahead``)."""

from __future__ import annotations

import multiprocessing as mp
import os
from collections import deque
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from typing import ClassVar

import numpy as np

from ..core.config import collect_defaults, merge
from ..core.registry import resolve_component


class BaseDataset:
    device_engine: ClassVar[bool] = False  # True: batches made on the device from seeds
    default_conf: ClassVar[dict] = {
        "name": None,
        "num_workers": 4,  # worker processes of the training loader
        "train_batch_size": 2,
        "val_batch_size": 2,
        "test_batch_size": 1,
        "batch_size": None,  # overrides the per-split sizes when set
        "shuffle_training": True,
        "seed": 0,
        "prefetch": 2,  # batches read ahead
    }

    def __init__(self, conf: dict | None = None):
        self.conf = merge(collect_defaults(type(self)), conf)

    def get_dataset(self, split: str):
        """An indexable split with ``__len__`` and ``getitem(idx, rng)``."""
        raise NotImplementedError

    def batch_size(self, split: str) -> int:
        if self.conf.get("batch_size") is not None:
            return int(self.conf["batch_size"])
        return int(self.conf[f"{split}_batch_size"])

    def get_data_loader(self, split: str, shuffle: bool | None = None, shard: int = 0,
                        num_shards: int = 1, epoch: int = 0,
                        drop_last: bool | None = None) -> "DataLoader":
        """The training loader of ``split``: shuffled (train, with
        ``shuffle_training``), the last partial batch dropped on train."""
        if shuffle is None:
            shuffle = split == "train" and self.conf["shuffle_training"]
        if drop_last is None:
            drop_last = split == "train"
        return DataLoader(self.get_dataset(split), self.batch_size(split), shuffle,
                          int(self.conf["seed"]), int(self.conf["num_workers"]),
                          int(self.conf["prefetch"]), shard, num_shards, epoch, drop_last)

    def get_overfit_loader(self, split: str, num_items: int = 1) -> "DataLoader":
        """A loader over the first ``num_items`` items, repeated."""
        return DataLoader(self.get_dataset(split), self.batch_size(split), False,
                          int(self.conf["seed"]), 0, 0, loop_items=num_items)


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


class DataLoader:
    """Collated batches of a split's items, as the JAX package's loader
    makes them: the order is ``arange(len)`` shuffled by
    ``default_rng((seed, epoch))``, padded and strided for ``shard`` of
    ``num_shards``; item ``idx`` is ``getitem(idx, default_rng((seed, epoch,
    idx)))``; ``drop_last`` drops a partial last batch; ``loop_items`` loops
    over the first items (the overfit loader). ``num_workers`` forked
    processes make the items of the next ``prefetch`` batches while the
    caller uses the current one (0: in the caller). Processes, where the JAX
    loader has threads: a PyTorch training step launches each operation
    from Python, and loader threads that hold the interpreter lock between
    their numpy calls starve it (a stage-1 step took 9-11 s with 8 threads
    against 0.9 s of device work; PERF.md, PR 11); they run at a lower
    priority, so that on a host whose cores they fill the training process
    still launches its steps. Each process keeps a source cache of its own,
    where the JAX loader's threads share one."""

    def __init__(self, dataset, batch_size: int, shuffle: bool, seed: int,
                 num_workers: int = 4, prefetch: int = 2, shard: int = 0, num_shards: int = 1,
                 epoch: int = 0, drop_last: bool = False, loop_items: int | None = None):
        self.dataset, self.batch_size, self.shuffle, self.seed = dataset, batch_size, shuffle, seed
        self.num_workers, self.prefetch = num_workers, max(prefetch, 1)
        self.shard, self.num_shards, self.epoch = shard, num_shards, epoch
        self.drop_last, self.loop_items = drop_last, loop_items

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def indices(self) -> np.ndarray:
        n = len(self.dataset)
        if self.loop_items is not None:
            return np.tile(np.arange(min(self.loop_items, n)), max(self.batch_size * 100, 1))
        idx = np.arange(n)
        if self.shuffle:
            np.random.default_rng((self.seed, self.epoch)).shuffle(idx)
        if self.num_shards > 1:  # padded so that every shard has as many batches
            pad = -(-n // self.num_shards) * self.num_shards - n
            idx = np.concatenate([idx, idx[:pad]])[self.shard::self.num_shards]
        return idx

    def __len__(self) -> int:
        n = len(self.indices())
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def item(self, idx: int):
        return self.dataset.getitem(int(idx), np.random.default_rng((self.seed, self.epoch,
                                                                     int(idx))))

    def __iter__(self):
        indices = self.indices()
        batches = [indices[i * self.batch_size:(i + 1) * self.batch_size]
                   for i in range(len(self))]
        if self.num_workers <= 0:
            for b in batches:
                yield collate([self.item(i) for i in b])
            return
        # forked: the workers inherit this loader (its dataset, epoch and
        # seed); only indices go to them and items come back
        pool = ProcessPoolExecutor(self.num_workers, mp_context=mp.get_context("fork"),
                                   initializer=_adopt_loader, initargs=(self,))
        try:
            pending = deque()
            for b in batches:
                pending.append([pool.submit(_loader_item, int(i)) for i in b])
                if len(pending) > self.prefetch:
                    yield collate([f.result() for f in pending.popleft()])
            while pending:
                yield collate([f.result() for f in pending.popleft()])
        finally:
            pool.shutdown(wait=True, cancel_futures=True)


_LOADER: DataLoader | None = None  # the loader of a worker process


WORKER_NICENESS = 10  # workers yield the cores to the process that launches the steps


def _adopt_loader(loader: DataLoader) -> None:
    global _LOADER
    _LOADER = loader
    os.nice(WORKER_NICENESS)


def _loader_item(idx: int):
    return _LOADER.item(idx)


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
