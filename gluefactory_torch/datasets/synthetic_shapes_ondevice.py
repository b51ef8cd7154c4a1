"""The on-device synthetic-shapes engines
(gluefactory_tpu/datasets/synthetic_shapes_ondevice.py): single views
(``synthetic_shapes_ondevice``, JPLDD's phase A) and view pairs
(``synthetic_shapes_ondevice_pairs``, SOLD2's training) of drawn scenes with
their exact ground truth, made on the card.

The pool (uint8 RGB images, segments and vertices) is drawn once on the host
by ``synthetic_shapes.draw_scene`` or, under ``scene_family: structured``,
by ``homographies_ondevice.generate_structured_scene`` (the scenes every
benchmark renders), and uploaded. Each step gathers ``train_batch_size``
scenes, warps each by a random homography (the pairs engine: two, the
first milder with ``right_only``), jitters it photometrically and warps the
vertices and segments exactly (a homography maps a segment to the segment
of its warped endpoints). The supervision is recomputed from the warped
geometry: Gaussian splats of ``heatmap_sigma`` at the vertices inside the
view (the max over vertices), the exact distance to the nearest valid
segment (clipped at ``df_clip``) and that segment's orientation mod pi.
The pairs engine keeps a segment in a view only where both its ends are
inside the view. ``make_batch_from_draws`` is deterministic in its random
numbers (``batch_draws``), so the tests feed JAX's."""

from __future__ import annotations

import math
import multiprocessing as mp
import os
from concurrent.futures import ProcessPoolExecutor
from typing import ClassVar

import numpy as np
import torch

from ..geometry.homography import homography_draws, homography_from_draws, warp_points
from ..ops.photometric import photometric_apply, photometric_draws
from ..ops.warp import warp_image
from .homographies_ondevice import (
    POOL_PROCESS_MIN,
    OnDeviceHomographyDataset,
    generate_structured_scene,
)
from .synthetic_shapes import draw_scene

SPLAT_CHUNK = 32  # vertices a pass of the heatmap splat
SEGMENT_CHUNK = 16  # segments a pass of the distance field


def _pool_scene(job: tuple) -> tuple:
    """Scene ``i`` of a pool: (uint8 RGB image, segments, their validity,
    vertices, their validity)."""
    seed, i, w, h, n_seg, n_vert, structured = job
    g = np.random.default_rng((seed, i))
    if structured:
        img, pts, pval, segs, segv = generate_structured_scene(g, (w, h), n_vert,
                                                               max_segments=n_seg)
        return (np.clip(np.repeat(img, 3, axis=-1) * 255, 0, 255).astype(np.uint8),
                segs, segv, pts, pval)
    img, segs, verts = draw_scene(g, w, n_seg)
    segments = np.zeros((n_seg, 2, 2), np.float32)
    seg_valid = np.zeros((n_seg,), bool)
    segments[:len(segs)], seg_valid[:len(segs)] = segs, True
    if len(verts):
        verts = np.unique(np.round(verts).astype(np.float32), axis=0)[:n_vert]
    vertices = np.zeros((n_vert, 2), np.float32)
    vert_valid = np.zeros((n_vert,), bool)
    vertices[:len(verts)], vert_valid[:len(verts)] = verts, True
    return (np.clip(img * 255, 0, 255).astype(np.uint8), segments, seg_valid, vertices,
            vert_valid)


def splat_heatmap(pts: torch.Tensor, valid: torch.Tensor, s: int, sigma: float) -> torch.Tensor:
    """(B, K, 2) points -> (B, s, s): the max over the valid points of
    exp(-d^2 / (2 sigma^2))."""
    coords = torch.arange(s, dtype=torch.float32, device=pts.device)
    heat = torch.zeros(pts.shape[0], s, s, device=pts.device)
    for k0 in range(0, pts.shape[1], SPLAT_CHUNK):
        p, v = pts[:, k0:k0 + SPLAT_CHUNK], valid[:, k0:k0 + SPLAT_CHUNK]
        dx = coords[None, None, :, None] - p[:, None, None, :, 0]
        dy = coords[None, :, None, None] - p[:, None, None, :, 1]
        g = torch.exp(-(dx * dx + dy * dy) / (2.0 * sigma * sigma))
        heat = torch.maximum(heat, torch.where(v[:, None, None, :], g, 0.0).amax(dim=-1))
    return heat


def df_af_from_segments(segs: torch.Tensor, valid: torch.Tensor, s: int,
                        clip: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, L, 2, 2) segments -> the exact distance to the nearest valid
    segment (B, s, s), clipped at ``clip``, and its orientation mod pi (the
    first segment of the smallest distance)."""
    b = segs.shape[0]
    coords = torch.arange(s, dtype=torch.float32, device=segs.device)
    grid = torch.stack([coords[None, :].expand(s, s), coords[:, None].expand(s, s)],
                       dim=-1).reshape(1, -1, 1, 2)  # (1, P, 1, 2)
    ab_all = segs[:, :, 1] - segs[:, :, 0]
    ang_all = torch.remainder(torch.atan2(ab_all[..., 1], ab_all[..., 0]), math.pi)
    best = torch.full((b, s * s), float("inf"), device=segs.device)
    angle = torch.zeros(b, s * s, device=segs.device)
    for l0 in range(0, segs.shape[1], SEGMENT_CHUNK):
        a = segs[:, None, l0:l0 + SEGMENT_CHUNK, 0]  # (B, 1, l, 2)
        ab = ab_all[:, None, l0:l0 + SEGMENT_CHUNK]
        denom = (ab * ab).sum(-1) + 1e-8
        t = (((grid - a) * ab).sum(-1) / denom).clamp(0.0, 1.0)
        d = torch.linalg.vector_norm(grid - (a + t[..., None] * ab), dim=-1)  # (B, P, l)
        d = torch.where(valid[:, None, l0:l0 + SEGMENT_CHUNK], d, 1e9)
        d_min, arg = d.min(dim=-1)
        closer = d_min < best  # strict: the first segment of a tie keeps the pixel
        best = torch.where(closer, d_min, best)
        angle = torch.where(closer, ang_all[:, l0:l0 + SEGMENT_CHUNK].gather(1, arg), angle)
    return best.clamp_max(clip).reshape(b, s, s), angle.reshape(b, s, s)


class OnDeviceSyntheticShapesDataset(OnDeviceHomographyDataset):
    default_conf: ClassVar[dict] = {
        "name": "synthetic_shapes_ondevice",
        "pool_size": 512,
        "val_pool_size": 48,
        "source_size": [448, 448],
        "image_size": 320,
        "max_segments": 48,
        "max_vertices": 96,
        "train_batch_size": 8,
        "val_batch_size": 8,
        "batch_size": 8,
        "num_workers": 0,
        "steps_per_epoch": 500,
        "val_steps": 4,
        "seed": 0,
        "homography": {"difficulty": 0.6, "translation": 0.3, "max_angle": 35.0},
        "photometric": {"p": 0.9, "strength": 1.0},
        "heatmap_sigma": 1.0,
        "df_clip": 16.0,
        "scene_family": "shapes",
    }

    def __init__(self, conf: dict | None = None):
        super().__init__(conf)
        w, h = (int(x) for x in self.conf["source_size"])
        if w != h:
            raise ValueError("the shapes pool is drawn on a square canvas")
        if self.conf["scene_family"] not in ("shapes", "structured"):
            raise ValueError(f"unknown scene_family {self.conf['scene_family']!r}")

    def build_pool(self, split: str = "train", device: str | torch.device = "cpu") -> dict:
        """The pool as host arrays: uint8 images (n, h, w, 3), segments
        (n, L, 2, 2), vertices (n, K, 2) and their validity."""
        conf = self.conf
        n = int(conf["val_pool_size"] if split == "val" else conf["pool_size"])
        w, h = (int(x) for x in conf["source_size"])
        salt = 104729 if split == "val" else 0
        jobs = [(int(conf["seed"]) + salt, i, w, h, int(conf["max_segments"]),
                 int(conf["max_vertices"]), conf["scene_family"] == "structured")
                for i in range(n)]
        if n >= POOL_PROCESS_MIN:  # each scene has its own generator: any order gives one pool
            with ProcessPoolExecutor(min(os.cpu_count() or 1, 8),
                                     mp_context=mp.get_context("fork")) as ex:
                scenes = list(ex.map(_pool_scene, jobs, chunksize=8))
        else:
            scenes = [_pool_scene(job) for job in jobs]
        keys = ("images", "segments", "segment_valid", "vertices", "vertex_valid")
        return {k: np.stack([scene[i] for scene in scenes]) for i, k in enumerate(keys)}

    def batch_draws(self, generator: torch.Generator, pool: dict, split: str = "train") -> dict:
        bsz, s = self.batch_size(split), int(self.conf["image_size"])
        idx = torch.randint(0, pool["images"].shape[0], (bsz,), generator=generator,
                            device=generator.device)
        return {"idx": idx, "h": homography_draws(generator, bsz),
                "p": photometric_draws(generator, (bsz, s, s, 3))}

    def _gather(self, pool: dict, idx: torch.Tensor) -> tuple:
        return (pool["images"][idx].float() / 255.0, pool["segments"][idx],
                pool["segment_valid"][idx], pool["vertices"][idx], pool["vertex_valid"][idx])

    def _homography(self, draws: dict, pool: dict, mild: float = 1.0) -> torch.Tensor:
        hs, ws = pool["images"].shape[1:3]
        s = int(self.conf["image_size"])
        hconf = self.conf["homography"]
        return homography_from_draws(
            draws, (ws, hs), (s, s), difficulty=float(hconf["difficulty"]) * mild,
            translation=float(hconf["translation"]), max_angle=float(hconf["max_angle"]) * mild)[0]

    def _view(self, images, segs, seg_valid, verts, vert_valid, H, photo, pairs: bool) -> dict:
        conf = self.conf
        s = int(conf["image_size"])
        pconf = conf["photometric"]
        img = photometric_apply(warp_image(images, H, (s, s)), photo, float(pconf["p"]),
                                float(pconf["strength"]))
        w_verts = warp_points(verts, H)
        w_segs = warp_points(segs.reshape(segs.shape[0], -1, 2), H).reshape(segs.shape)
        vert_ok = vert_valid & ((w_verts >= 1.0) & (w_verts <= s - 2.0)).all(-1)
        if pairs:  # both ends inside the view
            seg_valid = seg_valid & ((w_segs >= 0.0) & (w_segs <= s - 1.0)).all(-1).all(-1)
        heat = splat_heatmap(w_verts, vert_ok, s, float(conf["heatmap_sigma"]))
        df, af = df_af_from_segments(w_segs, seg_valid, s, float(conf["df_clip"]))
        return {"image": img, "image_size": torch.full((images.shape[0], 2), float(s),
                                                       device=img.device),
                "segments": w_segs, "segment_valid": seg_valid, "keypoints": w_verts,
                "keypoint_valid": vert_ok, "heatmap": heat, "distance_field": df,
                "angle_field": af}

    def make_batch_from_draws(self, pool: dict, draws: dict) -> dict:
        """A training batch from the pool (tensors on the device) and draws."""
        view = self._view(*self._gather(pool, draws["idx"]), self._homography(draws["h"], pool),
                          draws["p"], pairs=False)
        return {"image": view["image"], "image_size": view["image_size"],
                "gt_heatmap": view["heatmap"], "gt_distance_field": view["distance_field"],
                "gt_angle_field": view["angle_field"], "gt_segments": view["segments"],
                "gt_segment_valid": view["segment_valid"], "gt_keypoints": view["keypoints"],
                "gt_keypoint_valid": view["keypoint_valid"]}


__main_dataset__ = OnDeviceSyntheticShapesDataset


class OnDeviceSyntheticShapesPairsDataset(OnDeviceSyntheticShapesDataset):
    """Two views of each scene under independent homographies, with each
    view's supervision and ``H_0to1``; the views' ``gt_keypoints`` are the
    same source vertices, so the correspondence is the identity where both
    are valid."""

    default_conf: ClassVar[dict] = {"name": "synthetic_shapes_ondevice_pairs",
                                    "right_only": False}

    def batch_draws(self, generator: torch.Generator, pool: dict, split: str = "train") -> dict:
        bsz, s = self.batch_size(split), int(self.conf["image_size"])
        idx = torch.randint(0, pool["images"].shape[0], (bsz,), generator=generator,
                            device=generator.device)
        return {"idx": idx,
                "h0": homography_draws(generator, bsz), "h1": homography_draws(generator, bsz),
                "p0": photometric_draws(generator, (bsz, s, s, 3)),
                "p1": photometric_draws(generator, (bsz, s, s, 3))}

    def make_batch_from_draws(self, pool: dict, draws: dict) -> dict:
        scene = self._gather(pool, draws["idx"])
        H0 = self._homography(draws["h0"], pool, 0.3 if self.conf["right_only"] else 1.0)
        H1 = self._homography(draws["h1"], pool)
        out = {"H_0to1": H1 @ torch.linalg.inv(H0)}
        for i, (H, photo) in enumerate(((H0, draws["p0"]), (H1, draws["p1"]))):
            view = self._view(*scene, H, photo, pairs=True)
            out[f"view{i}"] = {"image": view["image"], "image_size": view["image_size"]}
            out.update({f"lines{i}": view["segments"], f"valid_lines{i}": view["segment_valid"],
                        f"gt_keypoints{i}": view["keypoints"],
                        f"gt_keypoint_valid{i}": view["keypoint_valid"],
                        f"gt_heatmap{i}": view["heatmap"],
                        f"gt_distance_field{i}": view["distance_field"],
                        f"gt_angle_field{i}": view["angle_field"]})
        return out
