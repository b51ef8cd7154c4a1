"""The extended relative-pose benchmark: points and lines
(gluefactory_tpu/eval/megadepth1500_extended.py).

On top of the pose summaries of ``eval/megadepth1500.py``, the line matches
are scored under the ground-truth pose: ``line_samples`` points along each
matched view-0 segment give epipolar lines in view 1; a sample's distance is
0 where its line crosses the matched view-1 segment, else the nearer
endpoint's distance to it (normalised units); a match is correct where its
median sample lies within 1e-4, 5e-4 or 1e-3. ``num_line_matches`` counts
them.

    python -m gluefactory_torch.eval.megadepth1500_extended [--tag T]
        [--conf conf.json] [--checkpoint C] [--device cuda|cpu] [--overwrite]
        [--overwrite_eval] [dot.key=value ...]

Without ``--conf`` it runs GlueStick stage 0 on the SuperPoint + LSD
wireframe (``recipes.md1500_extended_gluestick_conf``: 1024 keypoints, 480
pixels) on the set of ``scripts/generate_pose_eval_set.py`` under
``data/pose-eval``; results go to
``outputs/results/megadepth1500_extended/<tag>``."""

from __future__ import annotations

from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

from ..geometry.epipolar import T_to_E
from ..geometry.lines import sample_points_on_lines
from ..models.cache_loader import CacheLoader
from ..recipes import md1500_extended_gluestick_conf
from .eval_pipeline import unbatch
from .megadepth1500 import MegaDepth1500Pipeline, run


class MegaDepth1500ExtendedPipeline(MegaDepth1500Pipeline):
    default_conf = {"eval": {"line_samples": 8}}
    optional_export_keys = [
        "lines0", "lines1", "valid_lines0", "valid_lines1",
        "line_scores0", "line_scores1",
        "line_matches0", "line_matches1",
        "line_matching_scores0", "line_matching_scores1",
    ]

    def run_eval(self, loader, pred_file: Path):
        summaries, results = super().run_eval(loader, pred_file)
        n_samples = int(self.conf["eval"]["line_samples"])
        cache_loader = CacheLoader({"path": str(pred_file), "collate": False})
        extra = defaultdict(list)
        dev = self.device
        for batch in self.get_dataloader():  # the loader is spent
            pred = cache_loader(batch)
            if "lines0" not in pred:
                continue
            lm0 = np.asarray(pred.get("line_matches0",
                                      -np.ones(len(pred["lines0"]), np.int64)))
            matched = lm0 > -1
            if not matched.any():
                extra["num_line_matches"].append(0)
                continue
            data = unbatch(batch)
            cam0, cam1 = data["camera0"].to(dev), data["camera1"].to(dev)
            E = T_to_E(data["T_0to1"].to(dev))
            segs0 = torch.as_tensor(pred["lines0"][matched], device=dev)
            segs1 = torch.as_tensor(pred["lines1"][np.clip(lm0, 0, None)[matched]], device=dev)
            n_m = segs0.shape[0]
            p0 = sample_points_on_lines(segs0, n_samples).reshape(-1, 2)
            r0 = cam0.image2cam(p0)
            # each sample's epipolar line against the whole matched segment:
            # points along a line correspond only up to their position on it
            lines1 = (r0 @ E.T).reshape(n_m, n_samples, 3)
            ends = cam1.image2cam(segs1.reshape(-1, 2)).reshape(n_m, 2, 3)
            nrm = torch.linalg.vector_norm(lines1[..., :2], dim=-1)
            sa = torch.einsum("nsk,nk->ns", lines1, ends[:, 0]) / nrm
            sb = torch.einsum("nsk,nk->ns", lines1, ends[:, 1]) / nrm
            d = torch.where(sa * sb <= 0, 0.0, torch.minimum(sa.abs(), sb.abs())).cpu().numpy()
            med = np.median(d, axis=1)
            for th in (1e-4, 5e-4, 1e-3):
                extra[f"line_epi_prec@{th:.0e}"].append(float((med < th).mean()))
            extra["num_line_matches"].append(int(matched.sum()))
        for k, v in extra.items():
            if v:
                summaries[f"m{k}"] = round(float(np.nanmean(v)), 4)
        return summaries, {**results, **extra}


def main(argv: list[str] | None = None):
    return run(MegaDepth1500ExtendedPipeline, "megadepth1500_extended",
               md1500_extended_gluestick_conf(), argv)


if __name__ == "__main__":
    main()
