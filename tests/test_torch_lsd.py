"""The port's LSD (``csrc/lsd.cpp`` through ``models/lines/lsd.py``) against
OpenCV's ``createLineSegmentDetector(LSD_REFINE_STD)``, which the JAX
package calls, on rendered views, and the slotting against the JAX
package's ``detect_lsd_np`` and LSD model, on the CPU.

Bounds: the same segments as OpenCV, in the same order, endpoints within
ENDPOINT_PX (measured: every segment equal bit for bit on these views and on
blurred noise); widths within WIDTH_PX (OpenCV returns them in float64, the
port in float32). The slots, scores and masks of the JAX package's, equal."""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gluefactory_torch.models import build_model
from gluefactory_torch.models.lines import lsd as L
from gluefactory_torch.scripts.generate_eval_set import render_sequence
from gluefactory_torch.utils.image import read_image
from gluefactory_tpu.models import build_model as jax_build_model
from gluefactory_tpu.models.lines.lsd import detect_lsd_np as jax_detect_lsd_np

torch.set_num_threads(2)

ENDPOINT_PX = 1e-3
WIDTH_PX = 1e-5


@pytest.fixture(scope="module")
def views(tmp_path_factory):
    """A 240x240 famA view and a 480x360 famB view (HPatches' 480-pixel
    canvas), float RGB in [0, 1]."""
    root = tmp_path_factory.mktemp("lsd")
    out = {}
    for name, size, family, salt in (("a240", (240, 240), "a", 0), ("b480", (480, 360), "b", 777)):
        render_sequence(root / name, np.random.default_rng((424242 + salt, 0)), size, family)
        out[name] = read_image(root / name / "2.ppm").astype(np.float32) / 255.0
    return out


def _gray_u8(image: np.ndarray) -> np.ndarray:
    return L.grey_u8(torch.from_numpy(image)[None])[0].numpy()


@pytest.mark.parametrize("name", ["a240", "b480", "noise"])
def test_lsd_is_opencvs(views, name):
    if name == "noise":
        rng = np.random.default_rng(3)
        img = cv2.GaussianBlur(rng.integers(0, 256, (217, 251)).astype(np.uint8), (0, 0), 2.0)
    else:
        img = _gray_u8(views[name])
    ref_lines, ref_width = cv2.createLineSegmentDetector(cv2.LSD_REFINE_STD).detect(img)[:2]
    ours = L.detect_segments(img)
    assert len(ours) == len(ref_lines) > 50
    np.testing.assert_allclose(ours[:, :4], ref_lines.reshape(-1, 4), atol=ENDPOINT_PX, rtol=0)
    np.testing.assert_allclose(ours[:, 4], ref_width.ravel(), atol=WIDTH_PX, rtol=0)


def test_blur_and_subsampling_are_opencvs(views):
    """The image LSD works on: GaussianBlur (7x7, sigma 0.75) then resize by
    0.8 (INTER_LINEAR_EXACT), both uint8, bit for bit."""
    import ctypes

    lib = L._library()
    img = np.ascontiguousarray(_gray_u8(views["b480"])[:, :333])
    out = np.zeros(img.size, np.uint8)
    ow, oh = ctypes.c_int(), ctypes.c_int()
    lib.lsd_scaled_image(ctypes.c_void_p(img.ctypes.data), img.shape[1], img.shape[0],
                         ctypes.c_void_p(out.ctypes.data), ctypes.byref(ow), ctypes.byref(oh))
    ref = cv2.resize(cv2.GaussianBlur(img, (7, 7), 0.75), None, fx=0.8, fy=0.8,
                     interpolation=cv2.INTER_LINEAR_EXACT)
    assert (oh.value, ow.value) == ref.shape
    np.testing.assert_array_equal(out[:ref.size].reshape(ref.shape), ref)


def test_fast_atan2_is_opencvs():
    import ctypes

    lib = L._library()
    lib.lsd_fast_atan2.restype = ctypes.c_float
    lib.lsd_fast_atan2.argtypes = [ctypes.c_float, ctypes.c_float]
    rng = np.random.default_rng(0)
    pts = np.concatenate([rng.integers(-510, 511, (3000, 2)),
                          rng.normal(size=(3000, 2)) * rng.uniform(1e-2, 1e3, (3000, 1))])
    for y, x in pts.astype(np.float32):
        assert lib.lsd_fast_atan2(y, x) == np.float32(cv2.fastAtan2(float(y), float(x)))


@pytest.mark.parametrize("max_lines,min_length", [(250, 15.0), (128, 15.0), (20, 15.0),
                                                  (12, 40.0)])
def test_slotting_is_jaxs(views, max_lines, min_length):
    img = _gray_u8(views["b480"])
    ours = L.detect_lsd_np(img, max_lines, min_length)
    ref = jax_detect_lsd_np(img, max_lines, min_length)
    for a, b in zip(ours, ref):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=ENDPOINT_PX, rtol=0)
    assert ours[2].sum() == min(max_lines, ref[2].sum())


def test_model_is_jaxs(views):
    """The LSD model on a batch of two float RGB images (grey and uint8 as
    the JAX wrapper makes them under jit, as its benchmarks run it) against
    the JAX package's."""
    conf = {"max_num_lines": 128, "min_length": 15}
    batch = np.stack([views["b480"], views["b480"][::-1].copy()])
    jmodel = jax_build_model("lines.lsd", conf)
    jdata = {"image": jnp.asarray(batch)}
    jpred = jax.tree.map(np.asarray, dict(jax.jit(jmodel.apply)(
        jax.jit(jmodel.init)(jax.random.key(0), jdata), jdata)))
    with torch.inference_mode():
        pred = build_model("lines.lsd", conf, device="cpu")({"image": torch.from_numpy(batch)})
    for key in ("lines", "line_scores", "valid_lines"):
        np.testing.assert_allclose(pred[key].numpy(), jpred[key], atol=ENDPOINT_PX, rtol=0)
    assert pred["valid_lines"].sum() > 100


def test_lbd_descriptors_match_jax(views):
    """``describe: 'lbd'`` adds LBD descriptors of the segments, within 1e-5
    of the JAX package's LSD (the segments equal)."""
    batch = views["a240"][None]
    conf = {"max_num_lines": 64, "describe": "lbd"}
    jmodel = jax_build_model("lines.lsd", conf)
    jdata = {"image": jnp.asarray(batch)}
    jpred = jax.jit(jmodel.apply)(jax.jit(jmodel.init)(jax.random.key(0), jdata), jdata)
    with torch.inference_mode():
        pred = build_model("lines.lsd", conf, device="cpu")({"image": torch.from_numpy(batch)})
    np.testing.assert_array_equal(pred["lines"].numpy(), np.asarray(jpred["lines"]))
    np.testing.assert_allclose(pred["line_descriptors"].numpy(),
                               np.asarray(jpred["line_descriptors"]), atol=1e-5, rtol=0)
    assert pred["line_descriptors"].shape == (1, 64, 72)


def gate_view_segments(root) -> list[dict]:
    """OpenCV's LSD_REFINE_STD on the grey views of chip_smoke.py's gate
    pairs (3 famA sequences, views 1, 2 and 4): for each, the segment count,
    the sum of all endpoint coordinates (float64) and the first segment."""
    from pathlib import Path

    import chip_smoke

    chip_smoke.gate_pairs(Path(root), "cpu")
    out = []
    for s in range(chip_smoke.GATE_SEQS):
        for v in (1, 2, 4):
            name = f"v_qa{s}/{v}.ppm"
            image = read_image(Path(root) / name).astype(np.float32) / 255.0
            segs = cv2.createLineSegmentDetector(cv2.LSD_REFINE_STD).detect(
                _gray_u8(image))[0].reshape(-1, 4)
            out.append({"view": name, "count": len(segs),
                        "sum": float(segs.astype(np.float64).sum()),
                        "first": [float(x) for x in segs[0]]})
    return out


if __name__ == "__main__":
    import json
    import sys
    import tempfile

    # chip_smoke.py phase 18(e)'s constants: PYTHONPATH=. python tests/test_torch_lsd.py
    with tempfile.TemporaryDirectory() as tmp:
        json.dump(gate_view_segments(tmp), sys.stdout)
        print()
