"""Composite two-view pipeline (gluefactory_tpu/models/two_view_pipeline.py).

Slots ``extractor -> matcher -> filter -> solver``, each an optional
sub-model named in its conf. The extractor runs on ``view0`` and ``view1``
with shared weights; its predictions are flattened into ``*0``/``*1`` keys
for the later slots."""

from __future__ import annotations

from typing import ClassVar

from .base_model import BaseModel, make_submodel


class TwoViewPipeline(BaseModel):
    default_conf: ClassVar[dict] = {
        "extractor": {"name": None},
        "matcher": {"name": None},
        "filter": {"name": None},
        "solver": {"name": None},
    }
    required_data_keys: ClassVar[list] = ["view0", "view1"]
    components: ClassVar[list] = ["extractor", "matcher", "filter", "solver"]

    def __init__(self, conf: dict | None = None):
        super().__init__(conf)
        for comp in self.components:
            sub = self.conf.get(comp)
            model = make_submodel(sub) if sub and sub.get("name") else None
            setattr(self, comp, model)

    def extract_view(self, data: dict, i: str) -> dict:
        return self.extractor(data[f"view{i}"]) if self.extractor is not None else {}

    def _forward(self, data: dict) -> dict:
        pred0 = self.extract_view(data, "0")
        pred1 = self.extract_view(data, "1")
        pred = {**{k + "0": v for k, v in pred0.items()},
                **{k + "1": v for k, v in pred1.items()}}
        for comp in ("matcher", "filter", "solver"):
            model = getattr(self, comp)
            if model is not None:
                pred = {**pred, **model({**data, **pred})}
        return pred


__main_model__ = TwoViewPipeline
