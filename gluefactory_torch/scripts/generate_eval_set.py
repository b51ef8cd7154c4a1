"""Render a synthetic HPatches-format benchmark
(gluefactory_tpu/scripts/generate_eval_set.py), in numpy: procedural scenes
and five views each, written as

    <out>/<seq>/{1..6}.ppm  +  <out>/<seq>/H_1_{2..6}

so ``python -m gluefactory_torch.eval.hpatches`` reads it. View difficulty
ramps from 2 to 6 as in the real viewpoint sequences.

  - ``--family a``: the drawn scenes of the training pools
    (``datasets.homographies_ondevice.generate_structured_scene``), from a
    disjoint seed stream;
  - ``--family b``: the held-out textured scenes of
    ``datasets.scene_families``, with ``--illum_seqs`` illumination
    sequences (identity H, photometric variants: the HPatches i_ split).

The seeds, salts, draws and sequence names are the JAX script's, so both
render the same homographies; the pixels agree within the tolerances of
``tests/test_torch_render.py``.

Usage: python -m gluefactory_torch.scripts.generate_eval_set
          [--out data/hpatches-sequences-release] [--num_seqs 20]
          [--family a] [--illum_seqs 0] [--width 640] [--height 480] [--seed 0]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from ..datasets.homographies_ondevice import generate_structured_scene
from ..datasets.scene_families import generate_textured_scene, photometric_view
from ..geometry.homography import sample_homography_corners
from ..settings import DATA_PATH
from ..utils.image import warp_perspective, write_image

EVAL_SEED_SALT = 1_000_003  # disjoint from every training pool stream
FAMILY_B_SALT = 7_368_787  # family-b streams disjoint from family-a's


def _render_scene(rng, size, family: str) -> np.ndarray:
    """The base scene as uint8 (h, w, 3), gray in every channel."""
    w, h = size
    if family == "a":
        img, _pts, _valid = generate_structured_scene(rng, (w, h), max_points=4)
        img = img[..., 0]
    else:
        img = generate_textured_scene(rng, (w, h))
    img8 = np.clip(img * 255, 0, 255).astype(np.uint8)
    return np.repeat(img8[..., None], 3, axis=-1)


def render_sequence(seq_dir: Path, rng: np.random.Generator, size: tuple[int, int],
                    family: str = "a"):
    """Viewpoint sequence: 1.ppm and five H-warped views of ramping difficulty."""
    w, h = size
    img8 = _render_scene(rng, size, family)
    seq_dir.mkdir(parents=True, exist_ok=True)
    write_image(seq_dir / "1.ppm", img8)
    for k in range(2, 7):
        H, _ = sample_homography_corners(
            (w, h), (w, h), difficulty=0.15 + 0.1 * (k - 2), translation=0.15,
            max_angle=5.0 + 6.0 * (k - 2), rng=rng)
        warped = warp_perspective(img8[..., 0], H, (w, h))  # the channels are equal
        write_image(seq_dir / f"{k}.ppm", np.repeat(warped[..., None], 3, axis=-1))
        np.savetxt(seq_dir / f"H_1_{k}", H)


def render_illumination_sequence(seq_dir: Path, rng: np.random.Generator,
                                 size: tuple[int, int], family: str = "b"):
    """Illumination sequence: a fixed viewpoint (H = identity) and five
    photometric variants of the base scene."""
    img8 = _render_scene(rng, size, family)
    base = img8[..., 0].astype(np.float32) / 255.0
    seq_dir.mkdir(parents=True, exist_ok=True)
    write_image(seq_dir / "1.ppm", img8)
    for k in range(2, 7):
        view = np.clip(photometric_view(rng, base) * 255, 0, 255).astype(np.uint8)
        write_image(seq_dir / f"{k}.ppm", np.repeat(view[..., None], 3, axis=-1))
        np.savetxt(seq_dir / f"H_1_{k}", np.eye(3))


def sequence_jobs(num_seqs: int, seed: int, family: str = "a", illum_seqs: int = 0):
    """(name, render function, generator seed) of every sequence of a set."""
    salt = EVAL_SEED_SALT + (FAMILY_B_SALT if family == "b" else 0)
    tag = "synth" if family == "a" else "tex"
    jobs = [(f"v_{tag}{s:03d}", render_sequence, (salt + seed, s)) for s in range(num_seqs)]
    jobs += [(f"i_{tag}{s:03d}", render_illumination_sequence, (salt + seed, 500_000 + s))
             for s in range(illum_seqs)]
    return jobs


def render_job(out: Path, size: tuple[int, int], family: str, job) -> str:
    """Render one entry of ``sequence_jobs`` under ``out``; returns its name."""
    name, render, seed = job
    render(Path(out) / name, np.random.default_rng(seed), size, family)
    return name


def generate(out: Path, num_seqs: int, size: tuple[int, int], seed: int,
             family: str = "a", illum_seqs: int = 0):
    for job in sequence_jobs(num_seqs, seed, family, illum_seqs):
        render_job(out, size, family, job)
    print(f"wrote {num_seqs} v_ + {illum_seqs} i_ sequences to {out}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(DATA_PATH / "hpatches-sequences-release"))
    ap.add_argument("--num_seqs", type=int, default=20)
    ap.add_argument("--illum_seqs", type=int, default=0)
    ap.add_argument("--family", choices=["a", "b"], default="a")
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    generate(Path(args.out), args.num_seqs, (args.width, args.height), args.seed,
             family=args.family, illum_seqs=args.illum_seqs)


if __name__ == "__main__":
    main()
