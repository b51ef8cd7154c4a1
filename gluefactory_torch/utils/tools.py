"""Metric accumulators of training and the benchmarks (gluefactory_tpu/utils/tools.py)."""

from __future__ import annotations

from collections.abc import Iterable

import numpy as np


class AverageMetric:
    """The mean of every value seen, NaN values left out (NaN if none)."""

    def __init__(self, elements=None):
        self._sum = 0.0
        self._num = 0
        if elements is not None:
            self.update(elements)

    def update(self, x):
        x = np.asarray(x, dtype=np.float64).ravel()
        mask = ~np.isnan(x)
        self._sum += float(x[mask].sum())
        self._num += int(mask.sum())

    def compute(self):
        return np.nan if self._num == 0 else self._sum / self._num


class MedianMetric:
    """The median of every value seen, NaN values left out (NaN if none)."""

    def __init__(self, elements=None):
        self._elements = []
        if elements is not None:
            self.update(elements)

    def update(self, x):
        self._elements += np.asarray(x, dtype=np.float64).ravel().tolist()

    def compute(self):
        arr = np.array(self._elements)
        arr = arr[~np.isnan(arr)]
        return np.nan if arr.size == 0 else float(np.median(arr))


def cal_error_auc(errors, thresholds) -> list[float]:
    """The area under the recall-against-error curve up to each threshold,
    by the trapezoid rule, over the threshold."""
    errors = np.sort(np.asarray(errors, dtype=np.float64))
    if errors.size == 0:
        return [0.0] * len(thresholds)
    recall = (np.arange(len(errors)) + 1) / len(errors)
    errors = np.r_[0.0, errors]
    recall = np.r_[0.0, recall]
    aucs = []
    for t in thresholds:
        last = np.searchsorted(errors, t)
        r = np.r_[recall[:last], recall[last - 1]]
        e = np.r_[errors[:last], t]
        aucs.append(float((np.diff(e) * (r[1:] + r[:-1]) / 2.0).sum() / t))
    return aucs


class AUCMetric:
    def __init__(self, thresholds, elements=None):
        self._elements = []
        self.thresholds = thresholds if isinstance(thresholds, Iterable) else [thresholds]
        if elements is not None:
            self.update(elements)

    def update(self, x):
        self._elements += np.asarray(x, dtype=np.float64).ravel().tolist()

    def compute(self):
        if len(self._elements) == 0:
            return np.nan
        return cal_error_auc(self._elements, self.thresholds)
