"""Nested configuration dicts (gluefactory_tpu/core/config.py, without
OmegaConf): defaults are deep-merged with overrides into plain dicts."""

from __future__ import annotations

import copy


def merge(base: dict, override: dict | None) -> dict:
    """A new dict: ``base`` with ``override`` merged in recursively. A key
    whose value is a dict on both sides is merged; any other value replaces."""
    out = copy.deepcopy(base)
    for key, value in (override or {}).items():
        if isinstance(value, dict) and isinstance(out.get(key), dict):
            out[key] = merge(out[key], value)
        else:
            out[key] = copy.deepcopy(value)
    return out


def collect_defaults(cls: type) -> dict:
    """Merge the ``default_conf`` of ``cls`` and of its bases, base first."""
    conf: dict = {}
    for klass in reversed(cls.__mro__):
        conf = merge(conf, klass.__dict__.get("default_conf"))
    return conf
