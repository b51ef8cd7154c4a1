"""Estimator contract (gluefactory_tpu/robust_estimators/base_estimator.py):
a dict with ``m_kpts0``, ``m_kpts1`` (and optionally ``valid``) in; a dict
with ``success``, ``M_0to1`` and ``inliers`` out. ``sweep`` gives one such
dict for each of several ``ransac_th``; an estimator overrides either
``_forward`` or ``sweep``, which then serves one threshold too."""

from __future__ import annotations

from ..core.config import collect_defaults, merge


class BaseEstimator:
    default_conf: dict = {"ransac_th": 3.0}

    def __init__(self, conf: dict | None = None):
        self.conf = merge(collect_defaults(type(self)), conf)

    def __call__(self, data: dict) -> dict:
        return self._forward(data)

    def _forward(self, data: dict) -> dict:
        return self.sweep(data, [self.conf["ransac_th"]])[0]

    def sweep(self, data: dict, thresholds) -> list[dict]:
        """The estimate at each of ``thresholds`` (``ransac_th``)."""
        return [type(self)(merge(self.conf, {"ransac_th": th}))._forward(data)
                for th in thresholds]
