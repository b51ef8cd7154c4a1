"""Component lookup by dotted name (gluefactory_tpu/core/registry.py):
``"extractors.superpoint"`` resolves to the module
``<package>.extractors.superpoint`` and its ``__main_model__`` (or
``__main_estimator__``) attribute."""

from __future__ import annotations

import importlib


def resolve_component(name: str, package: str, prefixes: tuple[str, ...],
                      attr: str) -> type:
    """Try ``package.name``, then ``package.<prefix>.name`` for each prefix."""
    candidates = [f"{package}.{name}"] + [f"{package}.{p}.{name}" for p in prefixes]
    for path in candidates:
        try:
            module = importlib.import_module(path)
        except ModuleNotFoundError as e:
            if e.name is not None and path.startswith(e.name):
                continue  # this candidate does not exist
            raise
        if hasattr(module, attr):
            return getattr(module, attr)
    raise ImportError(f"no component {name!r} under {package}; tried {candidates}")
