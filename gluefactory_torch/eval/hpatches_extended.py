"""The extended HPatches benchmark: points and lines
(gluefactory_tpu/eval/hpatches_extended.py).

On top of the HPatches summaries (whose robust homography gets the matched
lines where the model makes them, as ``hybrid_ransac`` reads them), each
pair adds keypoint repeatability and localisation error (``rep_th_kp``),
line repeatability and localisation error (orthogonal distance,
``rep_th_line``), and, where lines were matched, the share of line matches
whose view-0 segment, warped by the true homography, lies within
``line_match_th`` of its partner (orthogonal distance), and their count.

    python -m gluefactory_torch.eval.hpatches_extended [--tag T] [--conf NAME]
        [--checkpoint C] [--device cuda|cpu] [--overwrite] [--overwrite_eval]
        [dot.key=value ...]

``--conf`` names a conf of ``recipes.LINE_CONFS['hpatches_extended']`` (the
committed ``outputs/results/hpatches_extended/<name>``: GlueStick's
``gluestick_stage0_hybrid``, the default, and JPLDD's ``jpldd_*``), a config
under ``gluefactory_tpu/configs`` or a file. Data default to
``data/hpatches-sequences-release``; results go to
``outputs/results/hpatches_extended/<tag>``."""

from __future__ import annotations

from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

from ..geometry.homography import warp_lines
from ..geometry.lines import orth_line_dist
from ..models.cache_loader import CacheLoader
from .eval_pipeline import unbatch
from .hpatches import HPatchesPipeline
from .hpatches_lines import run_lines
from .metrics import keypoint_repeatability, line_repeatability


class HPatchesExtendedPipeline(HPatchesPipeline):
    default_conf = {"eval": {"rep_th_kp": 3.0, "rep_th_line": 5.0, "line_match_th": 5.0}}
    export_keys = HPatchesPipeline.export_keys + [
        "lines0", "lines1", "valid_lines0", "valid_lines1",
        "line_matches0", "line_matching_scores0",
    ]

    def run_eval(self, loader, pred_file: Path):
        summaries, results = super().run_eval(loader, pred_file)
        conf = self.conf["eval"]
        cache_loader = CacheLoader({"path": str(pred_file), "collate": False})
        extra = defaultdict(list)

        def t(x, dtype=torch.float32):
            return torch.as_tensor(np.asarray(x), dtype=dtype, device=self.device)[None]

        for batch in self.get_dataloader():  # the loader is spent
            data, pred = unbatch(batch), cache_loader(batch)
            H, size1 = t(data["H_0to1"]), t(data["view1"]["image_size"])
            n0, n1 = len(pred["keypoints0"]), len(pred["keypoints1"])
            v0 = t(pred.get("keypoint_valid0", np.ones(n0, bool)), torch.bool)
            v1 = t(pred.get("keypoint_valid1", np.ones(n1, bool)), torch.bool)
            rep, loc = keypoint_repeatability(t(pred["keypoints0"]), t(pred["keypoints1"]),
                                              v0, v1, H, size1, th=conf["rep_th_kp"])
            extra["kp_repeatability"].append(float(rep[0]))
            extra["kp_loc_error"].append(float(loc[0]))
            if "lines0" not in pred:
                continue
            lines0, lines1 = t(pred["lines0"]), t(pred["lines1"])
            vl0 = t(pred.get("valid_lines0", np.ones(len(pred["lines0"]), bool)), torch.bool)
            vl1 = t(pred.get("valid_lines1", np.ones(len(pred["lines1"]), bool)), torch.bool)
            lrep, lloc = line_repeatability(lines0, lines1, vl0, vl1, H, size1,
                                            th=conf["rep_th_line"])
            extra["line_repeatability"].append(float(lrep[0]))
            extra["line_loc_error"].append(float(lloc[0]))
            if "line_matches0" not in pred:
                continue
            lm0 = np.asarray(pred["line_matches0"])
            matched = lm0 > -1
            if matched.any():
                warped0, _ = warp_lines(lines0, H, size1)
                d = orth_line_dist(warped0, lines1)[0].cpu().numpy()
                dm = d[np.arange(len(lm0)), np.clip(lm0, 0, None)]
                extra["line_match_precision"].append(
                    float((dm[matched] < conf["line_match_th"]).mean()))
                extra["num_line_matches"].append(int(matched.sum()))
        for k, v in extra.items():
            if v:
                summaries[f"m{k}"] = round(float(np.nanmean(v)), 4)
        return summaries, {**results, **extra}


def main(argv: list[str] | None = None):
    return run_lines(HPatchesExtendedPipeline, "hpatches_extended", "gluestick_stage0_hybrid",
                     argv)


if __name__ == "__main__":
    main()
