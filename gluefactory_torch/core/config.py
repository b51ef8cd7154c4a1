"""Nested configuration dicts (gluefactory_tpu/core/config.py, without
OmegaConf): defaults are deep-merged with overrides into plain dicts, and
command lines give overrides as ``dot.key=value``."""

from __future__ import annotations

import copy
import json
from pathlib import Path


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


def lookup(conf: dict, dotted: str, missing):
    """``conf["a"]["b"]`` for ``dotted`` 'a.b', or ``missing`` where a key is absent."""
    for part in dotted.split("."):
        if not isinstance(conf, dict) or part not in conf:
            return missing
        conf = conf[part]
    return conf


def collect_defaults(cls: type) -> dict:
    """Merge the ``default_conf`` of ``cls`` and of its bases, base first."""
    conf: dict = {}
    for klass in reversed(cls.__mro__):
        conf = merge(conf, klass.__dict__.get("default_conf"))
    return conf


def parse_value(text: str):
    """A dotlist value: JSON where it parses (numbers, true/false/null,
    lists), else the string itself."""
    try:
        return json.loads(text)
    except json.JSONDecodeError:
        return text


def dotlist_to_dict(dotlist: list[str]) -> dict:
    """``["a.b=1", "c=x"]`` -> ``{"a": {"b": 1}, "c": "x"}``."""
    out: dict = {}
    for item in dotlist:
        key, sep, value = item.partition("=")
        if not sep:
            raise ValueError(f"expected key=value, got {item!r}")
        *parents, leaf = key.split(".")
        node = out
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = parse_value(value)
    return out


def load_conf(path: str | Path) -> dict:
    """A conf file: JSON (whatever its suffix: the port writes a run's
    ``config.yaml`` as JSON text), else YAML where the ``yaml`` package is
    installed (the GPU machine has none: give it JSON)."""
    path = Path(path)
    text = path.read_text()
    try:
        return json.loads(text)
    except json.JSONDecodeError:
        if path.suffix == ".json":
            raise
    try:
        import yaml
    except ImportError as e:
        raise ImportError(f"{path} is YAML and this machine has no yaml package: "
                          "give the conf as JSON") from e
    return yaml.safe_load(text) or {}
