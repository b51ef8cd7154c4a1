"""ScanNet-1500 indoor relative-pose benchmark (gluefactory_tpu/eval/scannet1500.py):
the MegaDepth-1500 pipeline with the indoor pair list and a 640-pixel canvas.

    python -m gluefactory_torch.eval.scannet1500 [--tag T] [--conf conf.json]
        [--device cuda|cpu] [--overwrite] [--overwrite_eval] [dot.key=value ...]

Without ``--conf`` it runs the model and sweep of ``recipes.pose_flagship_conf``
on the indoor defaults; results go to ``outputs/results/scannet1500/<tag>``."""

from __future__ import annotations

from ..recipes import pose_flagship_conf
from .megadepth1500 import MegaDepth1500Pipeline, run


class ScanNet1500Pipeline(MegaDepth1500Pipeline):
    default_conf = {
        "data": {
            "name": "image_pairs",
            "pairs": "scannet1500/pairs_calibrated.txt",
            "root": "scannet1500/images",
            "preprocessing": {"resize": 640, "side": "long", "square_pad": True},
            "test_batch_size": 1,
            "num_workers": 2,
        },
    }


def main(argv: list[str] | None = None):
    named = {k: v for k, v in pose_flagship_conf().items() if k != "data"}
    run(ScanNet1500Pipeline, "scannet1500", named, argv)


if __name__ == "__main__":
    main()
