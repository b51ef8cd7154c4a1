"""Render an RDNIM-format day/night evaluation set
(gluefactory_tpu/scripts/generate_rdnim_set.py), in numpy.

Each pair is a structured scene (``generate_structured_scene``: segment-rich,
the line benchmark needs lines) by day, its night restyle (a strong gamma
and a low gain, a vignette, read-out noise) and a rotation-dominant
homography (|angle| ramping from 15 to 165 degrees over the pairs, a random
sign, then a mild perspective) applied to the other time of day:
``day/<stem>/``: the day image and the warped night one; ``night/<stem>/``:
the night image and the warped day one. Each folder holds ``H_<stem>`` (the
homography from the reference to the query, as ``np.savetxt`` writes it)
beside ``<stem>_ref.ppm`` and ``<stem>_query.ppm``. The JAX package writes
the same images as JPEG with OpenCV; the port reads and writes PPM only, so
its set is lossless (OpenCV's ``getRotationMatrix2D``, ``warpPerspective``
with INTER_LINEAR and GRAY2BGR are reproduced here).

    python -m gluefactory_torch.scripts.generate_rdnim_set [--out data/RDNIM]
        [--num_pairs 20] [--width 640] [--height 480] [--seed 314159]
"""

from __future__ import annotations

import argparse
import math
from pathlib import Path

import numpy as np

from ..datasets.homographies_ondevice import generate_structured_scene
from ..geometry.homography import sample_homography_corners
from ..settings import DATA_PATH
from ..utils.image import warp_perspective, write_image

RDNIM_SEED_SALT = 27_644_437  # the JAX renderer's: disjoint from the other sets


def night_view(rng: np.random.Generator, img: np.ndarray) -> np.ndarray:
    """The night restyle of a grey scene in [0, 1]."""
    h, w = img.shape
    out = np.clip(img.astype(np.float32) ** rng.uniform(1.6, 2.4) * rng.uniform(0.25, 0.45),
                  0.0, 1.0)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    cx, cy = rng.uniform(0.3, 0.7) * w, rng.uniform(0.3, 0.7) * h
    r2 = ((xx - cx) / w) ** 2 + ((yy - cy) / h) ** 2
    out = out * (0.4 + 0.6 * np.exp(-r2 * rng.uniform(2.0, 5.0)))
    out = out + rng.normal(0.0, rng.uniform(0.01, 0.03), (h, w))
    return np.clip(out, 0.0, 1.0).astype(np.float32)


def rotation_matrix_2d(center: tuple[float, float], angle: float, scale: float) -> np.ndarray:
    """``cv2.getRotationMatrix2D``: (2, 3), ``angle`` in degrees,
    counter-clockwise in image coordinates."""
    a = angle * math.pi / 180
    alpha, beta = math.cos(a) * scale, math.sin(a) * scale
    cx, cy = center
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def to_u8(x: np.ndarray) -> np.ndarray:
    """A grey float image in [0, 1] as 8-bit RGB with equal channels."""
    return np.repeat(np.clip(x * 255, 0, 255).astype(np.uint8)[..., None], 3, axis=-1)


def render_pair(out: Path, i: int, num_pairs: int, size: tuple[int, int], seed: int) -> None:
    """Pair ``i`` of the set under ``out`` (its day and night folders)."""
    w, h = size
    rng = np.random.default_rng(seed + RDNIM_SEED_SALT + i)
    day = generate_structured_scene(rng, (w, h), max_points=4)[0][..., 0].astype(np.float32)
    night = night_view(rng, day)
    angle = (15.0 + 150.0 * i / max(num_pairs - 1, 1)) * (-1.0 if rng.uniform() < 0.5 else 1.0)
    H_rot = np.vstack([rotation_matrix_2d((w / 2, h / 2), angle, 1.0), [0, 0, 1]])
    H_persp, _ = sample_homography_corners((w, h), (w, h), difficulty=0.1, translation=0.1,
                                           max_angle=0.0, rng=rng)
    H = H_persp @ H_rot  # reference -> query
    stem = f"scene{i:03d}"
    for ref_name, ref, query in (("day", day, night), ("night", night, day)):
        folder = out / ref_name / stem
        folder.mkdir(parents=True, exist_ok=True)
        write_image(folder / f"{stem}_ref.ppm", to_u8(ref))
        write_image(folder / f"{stem}_query.ppm",
                    to_u8(warp_perspective(query, H.astype(np.float32), (w, h))))
        np.savetxt(folder / f"H_{stem}", H)


def generate(out: Path, num_pairs: int, size: tuple[int, int], seed: int) -> None:
    for i in range(num_pairs):
        render_pair(out, i, num_pairs, size, seed)
    print(f"wrote {num_pairs} day + {num_pairs} night RDNIM pairs to {out}")


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", type=Path, default=DATA_PATH / "RDNIM")
    ap.add_argument("--num_pairs", type=int, default=20)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--seed", type=int, default=314159)
    args = ap.parse_args(argv)
    generate(args.out, args.num_pairs, (args.width, args.height), args.seed)


if __name__ == "__main__":
    main()
