"""ETH3D matching AP benchmark (gluefactory_tpu/eval/eth3d.py).

A match is correct when its symmetric epipolar distance under the
ground-truth pose (normalized coordinates, ``generalized_epi_dist`` with
``essential``) is below ``eval.correct_th``; ``AP`` is the average
precision of all pairs' matches ranked by their scores, in percent and
rounded to 2 digits, and ``mnum_matches`` the mean count a pair. Line
matches, where the cached predictions hold them, are scored by the mean
distance of their two endpoints under three times the threshold
(``AP_lines``). The cache is read back through ``CacheLoader``.

    python -m gluefactory_torch.eval.eth3d [--tag T] [--conf conf.json]
        [--checkpoint C] [--device cuda|cpu] [--overwrite] [--overwrite_eval]
        [dot.key=value ...]

Without ``--conf`` it runs the flagship with the refiner at 1024 keypoints
on the 1024-pixel canvas (``recipes.eth3d_flagship_conf``) on
``data/ETH3D_undistorted``; results go to ``outputs/results/eth3d/<tag>``."""

from __future__ import annotations

from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

from ..geometry.epipolar import generalized_epi_dist
from ..models.cache_loader import CacheLoader
from ..recipes import eth3d_flagship_conf
from .eval_pipeline import EvalPipeline, unbatch
from .megadepth1500 import run
from .utils import get_matches_scores


def average_precision(correct: np.ndarray, scores: np.ndarray) -> float:
    """The mean of the precision at each correct entry of the ranking by
    descending score (0 without a correct entry)."""
    order = np.argsort(-scores)
    correct = correct[order]
    if correct.sum() == 0:
        return 0.0
    precision = np.cumsum(correct) / (np.arange(len(correct)) + 1)
    return float(np.sum(precision * correct) / correct.sum())


class ETH3DPipeline(EvalPipeline):
    default_conf = {
        "data": {"name": "eth3d"},
        "model": {"name": None},
        "eval": {"correct_th": 1e-3},
        "checkpoint": None,
    }
    export_keys = [
        "keypoints0", "keypoints1", "matches0", "matches1",
        "matching_scores0", "matching_scores1",
        "lines0", "lines1", "line_matches0", "line_matches1",
        "line_matching_scores0", "line_matching_scores1",
    ]

    def _epi(self, pts0, pts1, data) -> np.ndarray:
        """Paired epipolar distances of (N, 2) pixels on ``self.device``."""
        dev = self.device
        return generalized_epi_dist(
            torch.as_tensor(pts0, dtype=torch.float32, device=dev)[None],
            torch.as_tensor(pts1, dtype=torch.float32, device=dev)[None],
            data["view0"]["camera"].to(dev), data["view1"]["camera"].to(dev),
            data["T_0to1"].to(dev), essential=True)[0].cpu().numpy()

    def run_eval(self, loader, pred_file: Path):
        th = float(self.conf["eval"]["correct_th"])
        cache_loader = CacheLoader({"path": str(pred_file), "collate": False})
        results = defaultdict(list)
        all_correct, all_scores, line_correct, line_scores = [], [], [], []
        for batch in loader:
            data, name = unbatch(batch), batch["name"][0]
            pred = cache_loader(batch)
            pts0, pts1, scores, valid = get_matches_scores(
                pred["keypoints0"], pred["keypoints1"], pred["matches0"],
                pred["matching_scores0"])
            correct = (self._epi(pts0, pts1, data) < th) & valid
            all_correct.append(correct[valid])
            all_scores.append(scores[valid])
            results["names"].append(name)
            results["num_matches"].append(int(valid.sum()))
            if "line_matches0" in pred and "lines0" in pred:
                lm0 = pred["line_matches0"]
                lvalid = lm0 > -1
                if lvalid.any():
                    e0 = pred["lines0"][lvalid].reshape(-1, 2)
                    e1 = pred["lines1"][np.clip(lm0[lvalid], 0, None)].reshape(-1, 2)
                    dl = self._epi(e0, e1, data).reshape(-1, 2).mean(-1)
                    line_correct.append(dl < th * 3)
                    line_scores.append(pred["line_matching_scores0"][lvalid])
        summaries = {
            "AP": round(average_precision(np.concatenate(all_correct),
                                          np.concatenate(all_scores)) * 100, 2)
            if all_correct else 0.0,
            "mnum_matches": float(np.mean(results["num_matches"])),
        }
        if line_correct:
            summaries["AP_lines"] = round(average_precision(
                np.concatenate(line_correct), np.concatenate(line_scores)) * 100, 2)
        return summaries, dict(results)


def main(argv: list[str] | None = None):
    return run(ETH3DPipeline, "eth3d", eth3d_flagship_conf(), argv)


if __name__ == "__main__":
    main()
