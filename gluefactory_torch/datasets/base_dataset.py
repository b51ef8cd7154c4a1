"""Datasets (gluefactory_tpu/datasets/base_dataset.py), as far as the
on-device engines need: a conf dict merged over the ``default_conf`` of the
class and its bases, and lookup by name."""

from __future__ import annotations

from typing import ClassVar

from ..core.config import collect_defaults, merge
from ..core.registry import resolve_component


class BaseDataset:
    default_conf: ClassVar[dict] = {"name": None, "seed": 0}

    def __init__(self, conf: dict | None = None):
        self.conf = merge(collect_defaults(type(self)), conf)


def get_dataset(name: str) -> type[BaseDataset]:
    """The dataset class of module ``gluefactory_torch.datasets.<name>``."""
    return resolve_component(name, "gluefactory_torch.datasets", (), "__main_dataset__")
