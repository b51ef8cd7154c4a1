"""The ETH3D benchmark of the port (scripts/generate_eth3d_set.py,
datasets/eth3d.py, eval/eth3d.py) against the JAX package's on one small
scene that the port renders."""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from gluefactory_torch.core.config import merge
from gluefactory_torch.datasets.eth3d import ETH3DDataset
from gluefactory_torch.eval import get_benchmark
from gluefactory_torch.eval.eth3d import ETH3DPipeline, average_precision
from gluefactory_torch.recipes import eth3d_flagship_conf
from gluefactory_torch.scripts.generate_eth3d_set import render_eth3d_scene
from gluefactory_torch.utils.image import read_image

torch.set_num_threads(2)

SEED = (271828, 0)
SIZE = (320, 240)
DATA = {"name": "eth3d", "min_covisible": 300, "max_pairs_per_scene": 2,
        "preprocessing": {"resize": 320, "side": "long", "square_pad": True},
        "num_workers": 1}


@pytest.fixture(scope="module")
def eth3d_sets(tmp_path_factory):
    """One 320x240 scene of 3 views rendered by each package (JAX's with
    cv2, PNG), same seed."""
    from gluefactory_tpu.scripts.generate_eth3d_set import render_eth3d_scene as jax_render

    root = tmp_path_factory.mktemp("eth3d")
    render_eth3d_scene(root / "port" / "scene000", np.random.default_rng(SEED), size=SIZE,
                       n_views=3)
    jax_render(root / "jax" / "scene000", np.random.default_rng(SEED), size=SIZE, n_views=3)
    return root


def _text(root: Path, name: str) -> list[str]:
    return (root / "scene000" / "dslr_calibration_undistorted" / name).read_text().splitlines()


def test_renderer_matches_jax(eth3d_sets):
    """cameras.txt and points3D.txt equal JAX's text; each image line (id,
    pose, camera) equals JAX's but for the image's suffix; the visible point
    sets agree on at least 99% of their union; under 2% of the pixels
    differ (the scene is drawn in numpy, not cv2)."""
    import cv2

    port, ref = eth3d_sets / "port", eth3d_sets / "jax"
    assert _text(port, "cameras.txt") == _text(ref, "cameras.txt")
    assert _text(port, "points3D.txt") == _text(ref, "points3D.txt")
    ours, theirs = _text(port, "images.txt"), _text(ref, "images.txt")
    assert len(ours) == len(theirs) == 3 + 2 * 3
    assert ours[:3] == theirs[:3]
    for a, b in zip(ours[3::2], theirs[3::2]):
        assert a.replace(".ppm", ".png") == b
    for a, b in zip(ours[4::2], theirs[4::2]):
        ids_a, ids_b = set(a.split()[2::3]), set(b.split()[2::3])
        assert len(ids_a & ids_b) >= 0.99 * len(ids_a | ids_b) and len(ids_a) > 1000
        common = {i: xy for i, xy in zip(b.split()[2::3], zip(b.split()[0::3], b.split()[1::3]))}
        assert all(common[i] == xy for i, xy in
                   zip(a.split()[2::3], zip(a.split()[0::3], a.split()[1::3])) if i in common)
    for k in range(3):
        mine = read_image(port / "scene000" / "images" / f"view{k}.ppm").astype(int)
        jax_img = cv2.imread(str(ref / "scene000" / "images" / f"view{k}.png"))
        jax_img = cv2.cvtColor(jax_img, cv2.COLOR_BGR2RGB).astype(int)
        assert (np.abs(mine - jax_img).max(-1) > 0).mean() < 0.02


def test_dataset_matches_jax(eth3d_sets):
    """On the port's set: the same pairs (2 of the scene's 3, drawn by
    rng.choice), names, scaled cameras and T_0to1 within 1e-6."""
    from gluefactory_tpu.datasets import get_dataset as jax_get_dataset

    conf = {**DATA, "data_dir": str(eth3d_sets / "port")}
    ours = ETH3DDataset(conf)
    theirs = jax_get_dataset("eth3d")(conf)
    assert len(ours) == len(theirs) == 2
    for i in range(2):
        a, b = ours[i], theirs.get_dataset("test")[i]
        assert a["name"] == b["name"]
        for v in ("view0", "view1"):
            np.testing.assert_allclose(a[v]["image"], np.asarray(b[v]["image"]), atol=1e-6)
            for key in ("size", "f", "c", "dist"):
                np.testing.assert_allclose(getattr(a[v]["camera"], key).numpy(),
                                           np.asarray(getattr(b[v]["camera"], key)), atol=1e-6)
        np.testing.assert_allclose(a["T_0to1"].R.numpy(), np.asarray(b["T_0to1"].R), atol=1e-6)
        np.testing.assert_allclose(a["T_0to1"].t.numpy(), np.asarray(b["T_0to1"].t), atol=1e-6)


def test_average_precision_matches_jax():
    from gluefactory_tpu.eval.eth3d import average_precision as jax_ap

    rng = np.random.default_rng(0)
    for n in (1, 7, 300):
        correct = rng.uniform(size=n) < 0.6
        scores = rng.uniform(size=n).astype(np.float32)
        assert average_precision(correct, scores) == jax_ap(correct, scores)
    assert average_precision(np.zeros(5, bool), np.ones(5)) == 0.0


def _predictions(dataset: ETH3DDataset, seed: int = 0) -> dict:
    """Cached predictions of each pair in original-image pixels: the COLMAP
    points both views see (exact and with noise), random mismatches, padded
    slots, and lines joining consecutive shared points."""
    rng = np.random.default_rng(seed)
    out = {}
    for scene, _, images, a, b in dataset.items:
        pts = {}
        for im in (a, b):
            line = (dataset.root / scene / "dslr_calibration_undistorted" / "images.txt"
                    ).read_text().splitlines()[3 + 2 * (im - 1) + 1].split()
            pts[im] = {int(i): (float(x), float(y))
                       for x, y, i in zip(line[0::3], line[1::3], line[2::3])}
        shared = sorted(set(pts[a]) & set(pts[b]))[:200]
        kp0 = np.array([pts[a][i] for i in shared])
        kp1 = np.array([pts[b][i] for i in shared])
        kp1 += rng.normal(0, 0.3, kp1.shape) * (rng.uniform(size=(len(kp1), 1)) < 0.5)
        n = len(shared) + 20
        kp0 = np.concatenate([kp0, rng.uniform(0, 320, (20, 2))])
        kp1 = np.concatenate([kp1, rng.uniform(0, 240, (20, 2))])
        m0 = np.arange(n)
        m0[rng.uniform(size=n) < 0.1] = -1
        wrong = rng.uniform(size=n) < 0.15
        m0[wrong] = rng.integers(0, n, wrong.sum())
        lines0 = np.stack([kp0[:-1:2], kp0[1::2]], 1)[:40]
        lines1 = np.stack([kp1[:-1:2], kp1[1::2]], 1)[:40]
        lm0 = np.arange(40)
        lm0[rng.uniform(size=40) < 0.2] = -1
        wrong = rng.uniform(size=40) < 0.2
        lm0[wrong] = rng.integers(0, 40, wrong.sum())
        out[f"{scene}/{a}_{b}"] = {
            "keypoints0": kp0, "keypoints1": kp1, "matches0": m0,
            "matching_scores0": rng.uniform(size=n) * (m0 > -1),
            "lines0": lines0, "lines1": lines1, "line_matches0": lm0,
            "line_matching_scores0": rng.uniform(size=40) * (lm0 > -1)}
    return {name: {k: v.astype(np.float16) if v.dtype == np.float64 else v.astype(np.int32)
                   for k, v in p.items()} for name, p in out.items()}


def test_run_eval_matches_jax_on_the_same_cache(eth3d_sets, tmp_path):
    """The same cached predictions (the port's .npz, JAX's HDF5) give the
    same AP, AP_lines and mnum_matches."""
    import h5py

    from gluefactory_tpu.eval.eth3d import ETH3DPipeline as JaxETH3D

    conf = {"data": {**DATA, "data_dir": str(eth3d_sets / "port")}}
    pipeline = ETH3DPipeline(conf, device="cpu")
    preds = _predictions(pipeline.dataset)
    names = list(preds)
    h5 = tmp_path / "predictions.h5"
    with h5py.File(h5, "w") as f:
        for name, p in preds.items():
            grp = f.create_group(name)
            for k, v in p.items():
                grp.create_dataset(k, data=v)
    # the port's cache has a model's fixed slots: pad the rows to the longest
    longest = max(len(p["keypoints0"]) for p in preds.values())
    for p in preds.values():
        pad = longest - len(p["keypoints0"])
        for k in ("keypoints0", "keypoints1", "matching_scores0"):
            p[k] = np.concatenate([p[k], np.zeros((pad, *p[k].shape[1:]), p[k].dtype)])
        p["matches0"] = np.concatenate([p["matches0"], np.full(pad, -1, np.int32)])
    npz = tmp_path / "predictions.npz"
    np.savez(npz, names=np.array(names),
             **{k: np.stack([preds[n][k] for n in names]) for k in preds[names[0]]})
    ours, _ = pipeline.run_eval(pipeline.get_dataloader(), npz)
    theirs, _, _ = JaxETH3D(conf).run_eval(JaxETH3D(conf).get_dataloader(), h5)
    assert set(ours) == {"AP", "AP_lines", "mnum_matches"} == set(theirs)
    for key in ours:
        assert ours[key] == pytest.approx(theirs[key], abs=1e-9), key
    assert 20 < ours["AP"] < 100 and 20 < ours["AP_lines"] < 100


def test_get_benchmark_returns_the_port():
    assert get_benchmark("eth3d") is ETH3DPipeline


def test_entry_points_need_cuda_unless_asked_for_the_cpu(eth3d_sets, tmp_path):
    """ETH3DPipeline, export_features and measure_pipeline default to the
    card and raise without one."""
    from gluefactory_torch.datasets.image_folder import ImageFolderDataset
    from gluefactory_torch.eval.timing_measurement import measure_pipeline
    from gluefactory_torch.models import build_model
    from gluefactory_torch.scripts.export_features import export_features

    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    model = build_model("extractors.superpoint", {"max_num_keypoints": 8}, device="cpu")
    folder = ImageFolderDataset({"images": str(eth3d_sets / "port" / "scene000" / "images")})
    for call in (lambda: ETH3DPipeline({"data": {**DATA, "data_dir": str(eth3d_sets / "port")}}),
                 lambda: export_features(folder, model, tmp_path / "x.npz"),
                 lambda: measure_pipeline(model, 1, 32)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def jax_eth3d_reference(conf: dict, out: Path) -> dict:
    """The JAX ETH3D pipeline on the CPU with the port's recipe ``conf``
    (its ``data``, ``model``, ``eval`` and ``checkpoint``), results under
    ``out``."""
    from gluefactory_tpu.eval.eth3d import ETH3DPipeline as JaxETH3D

    summaries, _ = JaxETH3D(conf).run(out, overwrite=True)
    return {k: float(v) for k, v in summaries.items()}


def test_flagship_ap_matches_jax(eth3d_sets, tmp_path):
    """The flagship (CoM, LightGlue from lg_tpu_stage2, the refiner) at 256
    keypoints on the 320-pixel canvas: AP within 1.0 and the mean match
    count within 3% of JAX's on the same pairs."""
    conf = merge(eth3d_flagship_conf(), {
        "data": {**DATA, "data_dir": str(eth3d_sets / "port")},
        "model": {"extractor": {"max_num_keypoints": 256}}})
    ours, _ = ETH3DPipeline(conf, device="cpu").run(tmp_path / "port", overwrite=True)
    theirs = jax_eth3d_reference(conf, tmp_path / "jax")
    assert abs(ours["AP"] - theirs["AP"]) <= 1.0, (ours, theirs)
    assert abs(ours["mnum_matches"] - theirs["mnum_matches"]) <= 0.03 * theirs["mnum_matches"]
    assert ours["mnum_matches"] > 100


if __name__ == "__main__":
    import argparse
    import json

    from gluefactory_torch import recipes

    parser = argparse.ArgumentParser(
        description="the JAX package's ETH3D summaries of the port's recipes on a set")
    parser.add_argument("--set", required=True, help="a directory of ETH3D-layout scenes")
    parser.add_argument("--out", required=True)
    parser.add_argument("--recipes", nargs="+",
                        default=["eth3d_flagship_conf", "eth3d_sp_lg_stage2_conf"])
    args = parser.parse_args()
    jax.config.update("jax_platforms", "cpu")
    for name in args.recipes:
        conf = merge(getattr(recipes, name)(), {"data": {"data_dir": args.set}})
        print(json.dumps({"recipe": name, "summaries": jax_eth3d_reference(
            conf, Path(args.out) / name)}), flush=True)
