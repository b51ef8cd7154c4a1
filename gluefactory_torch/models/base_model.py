"""Model framework (gluefactory_tpu/models/base_model.py): a model is an
``nn.Module`` built from a nested conf dict merged over the ``default_conf``
of its class and bases; ``model(data)`` maps a dict of batched tensors to a
dict of predictions, and ``model.loss(pred, data)`` to (losses, metrics),
dicts of (B,) tensors with the sum to minimise in ``losses["total"]``.
``trainable: False`` in a model's conf freezes its parameters: the trainer
leaves them out of the optimizer."""

from __future__ import annotations

from typing import ClassVar

import torch
from torch import nn

from ..core.config import collect_defaults, merge
from ..core.registry import resolve_component
from ..utils.device import resolve_device


class BaseModel(nn.Module):
    default_conf: ClassVar[dict] = {"name": None, "trainable": True}
    required_data_keys: ClassVar[list] = []

    def __init__(self, conf: dict | None = None):
        super().__init__()
        self.conf = merge(collect_defaults(type(self)), conf)

    def forward(self, data: dict) -> dict:
        for key in self.required_data_keys:
            if key not in data:
                raise KeyError(f"{type(self).__name__} requires data key {key!r}; "
                               f"got {list(data)}")
        return self._forward(data)

    def _forward(self, data: dict) -> dict:
        raise NotImplementedError

    def loss(self, pred: dict, data: dict) -> tuple[dict, dict]:
        raise NotImplementedError


def get_model(name: str) -> type[BaseModel]:
    """Resolve ``name`` under ``models``, ``models.extractors`` or
    ``models.matchers`` (e.g. ``"matchers.lightglue"``)."""
    return resolve_component(name, "gluefactory_torch.models",
                             ("extractors", "matchers"), "__main_model__")


def make_submodel(conf: dict) -> BaseModel:
    """A sub-model from a conf dict that holds its ``name``."""
    return get_model(conf["name"])(conf)


def build_model(name: str, conf: dict | None = None,
                device: str | torch.device = "cuda", train: bool = False) -> BaseModel:
    """Build a model on ``device`` (CUDA unless asked), in inference mode
    unless ``train``."""
    return get_model(name)(conf).to(resolve_device(device)).train(train)
