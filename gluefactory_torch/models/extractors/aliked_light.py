"""ALIKED-light (gluefactory_tpu/models/extractors/aliked_light.py): ALIKED's
trunk and SDDH without the score head, describing the keypoints it is given
(the +0.5 pixel-centre convention undone before sampling), as JPLDD's
descriptor teacher. Its trunk is ALIKED's (``aliked.ALIKEDTrunk``), with
the same parameter names."""

from __future__ import annotations

from typing import ClassVar

from ..base_model import BaseModel
from .aliked import SDDH, ALIKEDTrunk, _model_cfg, _rgb


class ALIKEDLight(BaseModel, ALIKEDTrunk):
    default_conf: ClassVar[dict] = {
        "model_name": "aliked-n16",
        "trainable": False,
    }
    required_data_keys: ClassVar[list] = ["image", "keypoints"]

    def __init__(self, conf: dict | None = None):
        super().__init__(conf)
        c1, c2, c3, c4, dim, k, M = _model_cfg(self.conf["model_name"])
        self._trunk(3, c1, c2, c3, c4, dim, recompute=True)
        self.desc_head = SDDH(dim, dim, k=k, M=M)

    def _forward(self, data: dict) -> dict:
        fmap = self.features(_rgb(data["image"], False)).permute(0, 2, 3, 1)
        return {"descriptors": self.desc_head(fmap, data["keypoints"] - 0.5)}

    def loss(self, pred: dict, data: dict):
        raise NotImplementedError


__main_model__ = ALIKEDLight
