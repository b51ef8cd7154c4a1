"""Render a Wireframe-format single-view evaluation set
(gluefactory_tpu/scripts/generate_wireframe_set.py): structured scenes whose
drawn edges are the ground truth. Each image's segment endpoints, rounded to
1/4 pixel, are its junctions, and each segment a pair of junction indices
(self-loops from the rounding dropped); ``<out>/test/img<i>.npz`` holds
``image`` (H, W, 3) uint8, ``junctions`` (J, 2) float32 and ``lines`` (L, 2)
int32, written by ``np.savez_compressed``.

    python -m gluefactory_torch.scripts.generate_wireframe_set
        [--out data/wireframe] [--num_images 30] [--width 512] [--height 512]
        [--seed 161803]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from ..datasets.homographies_ondevice import generate_structured_scene
from ..settings import DATA_PATH

WIREFRAME_SEED_SALT = 86_028_121  # the JAX renderer's: disjoint from the other sets


def render_image(test: Path, i: int, size: tuple[int, int], seed: int) -> None:
    """Image ``i`` of the set as ``test/img<i>.npz``."""
    rng = np.random.default_rng(seed + WIREFRAME_SEED_SALT + i)
    img, _, _, segs, seg_valid = generate_structured_scene(rng, size, max_points=4,
                                                           max_segments=64)
    endpoints = segs[seg_valid].reshape(-1, 2)
    junctions, inverse = np.unique(np.round(endpoints * 4) / 4, axis=0, return_inverse=True)
    lines = inverse.reshape(-1, 2).astype(np.int32)
    img8 = np.clip(img[..., 0] * 255, 0, 255).astype(np.uint8)
    np.savez_compressed(test / f"img{i:04d}.npz", image=np.repeat(img8[..., None], 3, axis=-1),
                        junctions=junctions.astype(np.float32),
                        lines=lines[lines[:, 0] != lines[:, 1]])


def generate(out: Path, num_images: int, size: tuple[int, int], seed: int) -> None:
    test = out / "test"
    test.mkdir(parents=True, exist_ok=True)
    for i in range(num_images):
        render_image(test, i, size, seed)
    print(f"wrote {num_images} wireframe test images to {test}")


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", type=Path, default=DATA_PATH / "wireframe")
    ap.add_argument("--num_images", type=int, default=30)
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument("--seed", type=int, default=161803)
    args = ap.parse_args(argv)
    generate(args.out, args.num_images, (args.width, args.height), args.seed)


if __name__ == "__main__":
    main()
