"""The RDNIM line benchmark (gluefactory_tpu/eval/rdnim_lines.py): the
HPatches line metrics over the Rotated Day-Night pairs
(``datasets/rdnim.py``), ``data.reference`` day or night.

    python -m gluefactory_torch.eval.rdnim_lines [--tag T] [--conf NAME]
        [--checkpoint C] [--device cuda|cpu] [dot.key=value ...]

``--conf`` takes ``lsd_lbd`` (the default) or ``sold2_wunsch``
(``recipes.LINE_CONFS``), a config name or a file; results go to
``outputs/results/rdnim_lines/<tag>``."""

from __future__ import annotations

from .hpatches_lines import HPatchesLinesPipeline, run_lines


class RDNIMLinesPipeline(HPatchesLinesPipeline):
    default_conf = {
        "data": {"name": "rdnim", "reference": "day",
                 "preprocessing": {"resize": 480, "side": "long", "square_pad": True}},
    }


def main(argv: list[str] | None = None):
    return run_lines(RDNIMLinesPipeline, "rdnim_lines", "lsd_lbd", argv)


if __name__ == "__main__":
    main()
