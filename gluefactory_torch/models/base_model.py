"""Model framework (gluefactory_tpu/models/base_model.py): a model is an
``nn.Module`` built from a nested conf dict merged over the ``default_conf``
of its class and bases; ``model(data)`` maps a dict of batched tensors to a
dict of predictions, and ``model.loss(pred, data)`` to (losses, metrics),
dicts of (B,) tensors with the sum to minimise in ``losses["total"]``.
``trainable: False`` in a model's conf freezes its parameters: the trainer
leaves them out of the optimizer.

Each model's defaults hold every key of the JAX model's, at JAX's value. A
key the port does not implement is listed in the class's ``unported_conf``
(collected over the bases, as the defaults are; a dotted key names a nested
one, a key of a nested dict covers each of its entries): set to anything but
its default, the model refuses to build (``NotImplementedError``) rather than
run another computation. Keys that no default holds are merged and ignored,
as in the JAX package."""

from __future__ import annotations

from typing import ClassVar

import torch
from torch import nn

from ..core.config import collect_defaults, lookup, merge
from ..core.registry import resolve_component
from ..utils.device import resolve_device


class BaseModel(nn.Module):
    default_conf: ClassVar[dict] = {"name": None, "trainable": True, "timeit": False}
    unported_conf: ClassVar[frozenset] = frozenset({"timeit"})
    # appended to a refusal: where the refused keys are to be ported
    unported_note: ClassVar[str] = ""
    required_data_keys: ClassVar[list] = []

    def __init__(self, conf: dict | None = None):
        super().__init__()
        defaults = collect_defaults(type(self))
        self.conf = merge(defaults, conf)
        refused = unported_settings(type(self), self.conf, defaults)
        if refused:
            raise NotImplementedError(
                f"{type(self).__name__} does not implement "
                + ", ".join(f"{key}={value!r}" for key, value in refused.items())
                + " (only the default values are ported)"
                + (f"; {self.unported_note}" if self.unported_note else ""))

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


def _leaves(value, prefix: str) -> dict:
    if not isinstance(value, dict):
        return {prefix: value}
    out = {}
    for key, sub in value.items():
        out.update(_leaves(sub, f"{prefix}.{key}"))
    return out


def unported_settings(cls: type, conf: dict, defaults: dict) -> dict:
    """The unported keys of ``cls`` (dotted) whose value in ``conf`` is not
    their default, with that value."""
    keys = set().union(*(klass.__dict__.get("unported_conf", ()) for klass in cls.__mro__))
    missing = object()
    refused = {}
    for key in sorted(keys):
        for leaf, default in _leaves(lookup(defaults, key, missing), key).items():
            value = lookup(conf, leaf, missing)
            if value != default:
                refused[leaf] = None if value is missing else value
    return refused


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
