"""Composite two-view pipeline (gluefactory_tpu/models/two_view_pipeline.py).

Slots ``extractor -> matcher -> filter -> solver -> ground_truth``, each an
optional sub-model named in its conf. The extractor runs on ``view0`` and
``view1`` with shared weights; its predictions are flattened into
``*0``/``*1`` keys for the later slots. ``run_gt_in_forward`` runs the
ground-truth matcher in the forward pass, so its ``gt_*`` keys come with the
predictions; otherwise ``loss`` runs it."""

from __future__ import annotations

from typing import ClassVar

from .base_model import BaseModel, make_submodel


class TwoViewPipeline(BaseModel):
    default_conf: ClassVar[dict] = {
        "extractor": {"name": None},
        "matcher": {"name": None},
        "filter": {"name": None},
        "solver": {"name": None},
        "ground_truth": {"name": None},
        "allow_no_extract": False,  # views that carry a 'cache' skip the extractor
        "run_gt_in_forward": False,
    }
    required_data_keys: ClassVar[list] = ["view0", "view1"]
    components: ClassVar[list] = ["extractor", "matcher", "filter", "solver", "ground_truth"]

    def __init__(self, conf: dict | None = None):
        super().__init__(conf)
        for comp in self.components:
            sub = self.conf.get(comp)
            model = make_submodel(sub) if sub and sub.get("name") else None
            setattr(self, comp, model)

    def extract_view(self, data: dict, i: str) -> dict:
        data_i = data[f"view{i}"]
        pred_i = data_i.get("cache", {})
        if self.extractor is not None and not (pred_i and self.conf["allow_no_extract"]):
            pred_i = {**self.extractor({**data_i, **pred_i}), **pred_i}
        return pred_i

    def _ground_truth(self, pred: dict, data: dict) -> dict:
        gt = self.ground_truth({**data, **pred})
        return {k if k.startswith("gt_") else f"gt_{k}": v for k, v in gt.items()}

    def _forward(self, data: dict) -> dict:
        pred0 = self.extract_view(data, "0")
        pred1 = self.extract_view(data, "1")
        pred = {**{k + "0": v for k, v in pred0.items()},
                **{k + "1": v for k, v in pred1.items()}}
        for comp in ("matcher", "filter", "solver"):
            model = getattr(self, comp)
            if model is not None:
                pred = {**pred, **model({**data, **pred})}
        if self.ground_truth is not None and self.conf["run_gt_in_forward"]:
            pred = {**pred, **self._ground_truth(pred, data)}
        return pred

    def loss(self, pred: dict, data: dict) -> tuple[dict, dict]:
        """The losses and metrics of every trainable slot that has a loss;
        ``total`` is the sum of theirs."""
        if self.ground_truth is not None and not self.conf["run_gt_in_forward"]:
            pred = {**pred, **self._ground_truth(pred, data)}
        losses, metrics, total = {}, {}, 0
        for comp in ("extractor", "matcher", "filter", "solver"):
            model = getattr(self, comp)
            if model is None or not model.conf.get("trainable", True):
                continue
            try:
                losses_i, metrics_i = model.loss(pred, {**pred, **data})
            except NotImplementedError:
                continue
            losses.update(losses_i)
            metrics.update(metrics_i)
            total = losses_i["total"] + total
        losses["total"] = total
        return losses, metrics


__main_model__ = TwoViewPipeline
