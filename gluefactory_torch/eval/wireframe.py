"""The Wireframe line-detection benchmark (gluefactory_tpu/eval/wireframe.py).

Single-view: a line extractor runs on each image; its valid segments are
matched one to one to the ground-truth segments (``eval.line_metrics``, the
exact assignment; rows and columns swapped where there are more detections
than ground truth) under the structural and the orthogonal distance. Each
gives repeatability (``rep``, which is the recall here), precision and
recall at ``rep_thresholds`` and localisation error at ``loc_thresholds``;
where the model makes ``junctions`` (or ``keypoints``), junction precision
and recall at ``junction_thresholds``. Summaries are means over images,
rounded to 3 places.

    python -m gluefactory_torch.eval.wireframe [--tag T] [--conf NAME]
        [--checkpoint C] [--device cuda|cpu] [dot.key=value ...]

``--conf`` takes ``lsd`` (the default) or ``sold2`` (``recipes.LINE_CONFS``),
a config name or a file; results go to ``outputs/results/wireframe/<tag>``."""

from __future__ import annotations

from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

from ..models.cache_loader import CacheLoader
from .eval_pipeline import EvalPipeline
from .hpatches_lines import run_lines
from .line_metrics import (
    match_segments_one_to_one,
    segment_distance_matrix,
    segment_localization_error,
    segment_repeatability,
)


class WireframePipeline(EvalPipeline):
    default_conf = {
        "data": {"name": "wireframe",
                 "preprocessing": {"resize": 512, "side": "long", "square_pad": True}},
        "model": {"name": "lines.lsd", "max_num_lines": 512},
        "eval": {"rep_thresholds": [1.0, 3.0, 5.0], "loc_thresholds": [3.0, 5.0],
                 "junction_thresholds": [2.0, 4.0], "min_overlap": 0.5},
        "checkpoint": None,
    }
    export_keys = ["lines", "valid_lines"]
    optional_export_keys = ["line_scores", "junctions", "junction_valid", "keypoints",
                            "keypoint_valid"]

    def _segment_metrics(self, det: np.ndarray, gt: np.ndarray, results) -> None:
        conf = self.conf["eval"]
        n0, n1 = np.asarray([len(det)]), np.asarray([len(gt)])
        ones0, ones1 = np.ones((1, len(det)), bool), np.ones((1, len(gt)), bool)
        det_t = torch.from_numpy(det[None]).to(self.device)
        gt_t = torch.from_numpy(gt[None]).to(self.device)
        for kind in ("struct", "orth"):
            D = segment_distance_matrix(det_t, gt_t, kind=kind,
                                        min_overlap=float(conf["min_overlap"]))
            D = D.cpu().numpy()
            # the assignment takes rows <= columns; the counts are symmetric
            if len(det) > len(gt):
                _, mdist = match_segments_one_to_one(D.swapaxes(1, 2), ones1, ones0)
            else:
                _, mdist = match_segments_one_to_one(D, ones0, ones1)
            for name, vals in segment_repeatability(mdist, n0, n1,
                                                    list(conf["rep_thresholds"])).items():
                th = name.split("@")[1]
                results[f"{kind}_{name}px"].append(float(vals[0]))
                ok = float((mdist[0] <= float(th)).sum())
                results[f"{kind}_prec@{th}px"].append(ok / len(det))
                results[f"{kind}_recall@{th}px"].append(ok / len(gt))
            for name, vals in segment_localization_error(mdist,
                                                         list(conf["loc_thresholds"])).items():
                results[f"{kind}_{name}px"].append(float(vals[0]))

    def run_eval(self, loader, pred_file: Path):
        conf = self.conf["eval"]
        cache_loader = CacheLoader({"path": str(pred_file), "collate": False})
        results = defaultdict(list)
        for batch in loader:
            # lines back onto the canvas of the ground truth
            pred = cache_loader({"name": batch["name"], "scales": batch["scales"]})
            lines = np.asarray(pred["lines"])
            lv = np.asarray(pred.get("valid_lines", np.ones(lines.shape[:1], bool))).reshape(-1)
            det = lines[lv]
            gt = np.asarray(batch["gt_segments"])[0][np.asarray(batch["gt_segment_valid"])[0]]
            results["num_lines"].append(float(len(det)))
            results["num_gt_lines"].append(float(len(gt)))
            if len(det) == 0 or len(gt) == 0:
                continue
            self._segment_metrics(det, gt, results)
            junc = pred.get("junctions", pred.get("keypoints"))
            if junc is None:
                continue
            jv = np.asarray(pred.get("junction_valid", pred.get(
                "keypoint_valid", np.ones(len(junc), bool)))).reshape(-1)
            j = np.asarray(junc)[jv]
            gj = np.asarray(batch["gt_junctions"])[0][np.asarray(batch["gt_junction_valid"])[0]]
            if len(j) and len(gj):
                d = np.linalg.norm(j[:, None] - gj[None], axis=-1)
                for th in conf["junction_thresholds"]:
                    results[f"junc_prec@{th:g}px"].append(float((d.min(1) < th).mean()))
                    results[f"junc_recall@{th:g}px"].append(float((d.min(0) < th).mean()))
        summaries = {f"m{k}": round(float(np.nanmean(v)), 3) for k, v in results.items()}
        return summaries, dict(results)


def main(argv: list[str] | None = None):
    return run_lines(WireframePipeline, "wireframe", "lsd", argv)


if __name__ == "__main__":
    main()
