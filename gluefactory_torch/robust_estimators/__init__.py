"""Robust estimators by name (gluefactory_tpu/robust_estimators/__init__.py)."""

from ..core.registry import resolve_component
from .base_estimator import BaseEstimator


def load_estimator(type_: str, name: str) -> type[BaseEstimator]:
    """e.g. ``load_estimator("homography", "ransac")``."""
    return resolve_component(f"{type_}.{name}", "gluefactory_torch.robust_estimators",
                             (), "__main_estimator__")
