"""The feature cache of the port: models/cache_loader.py against the JAX
package's CacheLoader on the same content (the port's .npz, JAX's HDF5),
scripts/export_features.py over an image folder feeding a cached matcher
that equals the full pipeline, and eval/timing_measurement.py on the CPU."""


import numpy as np
import pytest
import torch

from gluefactory_torch.core.config import merge
from gluefactory_torch.datasets.image_folder import ImageFolderDataset
from gluefactory_torch.eval.eval_pipeline import to_model_input
from gluefactory_torch.eval.io import load_model
from gluefactory_torch.eval.timing_measurement import measure_pipeline
from gluefactory_torch.models import build_model
from gluefactory_torch.models.cache_loader import CacheLoader
from gluefactory_torch.recipes import SP_STAGE0B_WEIGHTS, STAGE2_WEIGHTS, eth3d_flagship_conf
from gluefactory_torch.scripts.export_features import export_features, get_kp_depth, view_cache
from gluefactory_torch.scripts.extract_pool_features import build_extractor
from gluefactory_torch.scripts.generate_eth3d_set import render_eth3d_scene
from gluefactory_torch.utils.export_predictions import export_predictions
from gluefactory_torch.utils.image import write_image

torch.set_num_threads(2)

SCENES = {"sceneA": ["img0", "img1", "img2"], "sceneB": ["img0", "img3"]}


def _rows(seed: int = 0, n: int = 30) -> dict:
    """{name: cached prediction} of every image of SCENES, float16 stored."""
    rng = np.random.default_rng(seed)
    rows = {}
    for scene, images in SCENES.items():
        for image in images:
            rows[f"{scene}/{image}"] = {
                "keypoints0": rng.uniform(0, 640, (n, 2)).astype(np.float16),
                "keypoints1": rng.uniform(0, 640, (n, 2)).astype(np.float16),
                "keypoint_scores0": rng.uniform(size=n).astype(np.float16),
                "descriptors0": rng.normal(size=(n, 8)).astype(np.float16),
                "lines0": rng.uniform(0, 640, (5, 2, 2)).astype(np.float16),
                "matches0": rng.integers(-1, n, n).astype(np.int32),
                "matching_scores0": rng.uniform(size=n).astype(np.float32),
            }
    return rows


@pytest.fixture(scope="module")
def caches(tmp_path_factory):
    """The same rows as one .npz (the port's layout) and one HDF5 (JAX's)
    per scene."""
    import h5py

    root = tmp_path_factory.mktemp("cache")
    rows = _rows()
    for scene in SCENES:
        names = [n for n in rows if n.startswith(scene + "/")]
        np.savez(root / f"{scene}.npz", names=np.array(names),
                 **{k: np.stack([rows[n][k] for n in names]) for k in rows[names[0]]})
        with h5py.File(root / f"{scene}.h5", "w") as f:
            for name in names:
                grp = f.create_group(name)
                for k, v in rows[name].items():
                    grp.create_dataset(k, data=v)
    return root


def _compare(ours, theirs):
    if isinstance(theirs, list):
        assert isinstance(ours, list) and len(ours) == len(theirs)
        for a, b in zip(ours, theirs):
            _compare(a, b)
        return
    assert set(ours) == set(theirs)
    for key, value in theirs.items():
        value = np.asarray(value)
        assert ours[key].dtype == value.dtype, key
        np.testing.assert_array_equal(ours[key], value, err_msg=key)


@pytest.mark.parametrize("conf", [
    {},
    {"collate": False},
    {"data_keys": ["keypoints0", "matches0", "lines0"]},
    {"numeric_type": None},
    {"numeric_type": "float64", "scale": ["keypoints"]},
    {"padding_length": 40},
    {"padding_length": 20, "collate": False},
])
def test_cache_loader_matches_jax(caches, conf):
    """Both loaders on two names of one scene and on one name alone, with
    the views' scales: the same arrays and dtypes."""
    from gluefactory_tpu.models.cache_loader import CacheLoader as JaxCacheLoader

    ours = CacheLoader({**conf, "path": str(caches / "{scene}.npz")})
    theirs = JaxCacheLoader({**conf, "path": str(caches / "{scene}.h5")})
    rng = np.random.default_rng(1)
    for names in (["sceneA/img2", "sceneA/img0"], ["sceneB/img3"]):
        data = {"name": names,
                "view0": {"scales": rng.uniform(0.5, 2, (len(names), 2)).astype(np.float32)},
                "view1": {"scales": rng.uniform(0.5, 2, (len(names), 2)).astype(np.float32)}}
        _compare(ours(data), theirs(data))
    data = {"name": "sceneB/img0", "view0": {"scales": np.array([1.5, 0.75], np.float32)}}
    _compare(ours(data), theirs(data))
    theirs.close()


def test_single_view_rows_come_back_on_the_canvas(tmp_path):
    """export_predictions divides a single view's keypoints by the item's
    own scales; CacheLoader given ``data['scales']`` multiplies them back
    (within float16's rounding), and without them leaves the stored rows."""
    rng = np.random.default_rng(3)
    kp = rng.uniform(0, 160, (2, 16, 2)).astype(np.float32)
    scales = np.array([[0.5, 0.5], [2.0, 1.5]], np.float32)
    out = export_predictions(
        [{"name": ["a", "b"], "scales": scales}],
        lambda batch: {"keypoints": torch.from_numpy(kp), "keypoint_scores": torch.ones(2, 16)},
        tmp_path / "c.npz")
    loader = CacheLoader({"path": str(out)})
    for i, name in enumerate(["a", "b"]):
        row = loader({"name": [name], "scales": scales[i]})
        stored = loader({"name": [name]})["keypoints"]
        assert row["keypoints"].dtype == stored.dtype == np.float32
        np.testing.assert_allclose(row["keypoints"], kp[i], rtol=1e-3)
        np.testing.assert_array_equal(row["keypoints"], stored * scales[i])
        np.testing.assert_array_equal(row["keypoint_scores"], 1.0)


def test_cache_loader_refuses_a_missing_name(caches):
    with pytest.raises(KeyError, match="sceneA/nope"):
        CacheLoader({"path": str(caches / "{scene}.npz")})({"name": ["sceneA/nope"]})


def test_get_kp_depth_matches_jax():
    from gluefactory_tpu.scripts.export_features import get_kp_depth as jax_get_kp_depth

    rng = np.random.default_rng(2)
    depth = rng.uniform(1, 5, (2, 40, 50)).astype(np.float32)
    depth[:, 10:20, 10:20] = 0
    pred = {"keypoints": rng.uniform(-2, 52, (2, 64, 2)).astype(np.float32)}
    ours = get_kp_depth(pred, {"depth": depth})
    theirs = jax_get_kp_depth(pred, {"depth": depth})
    assert set(ours) == set(theirs) == {"depth_keypoints", "valid_depth_keypoints"}
    np.testing.assert_array_equal(ours["valid_depth_keypoints"], theirs["valid_depth_keypoints"])
    np.testing.assert_allclose(ours["depth_keypoints"], theirs["depth_keypoints"], atol=1e-6)
    assert get_kp_depth(pred, {}) == {}


@pytest.fixture(scope="module")
def image_folder(tmp_path_factory):
    """Three views of one rendered scene (160x120 PPM)."""
    root = tmp_path_factory.mktemp("eth3d")
    render_eth3d_scene(root / "scene000", np.random.default_rng((271828, 0)), size=(160, 120),
                       n_views=3, n_points=200)
    return root / "scene000" / "images"


def test_image_folder_refuses_what_it_cannot_read(image_folder, tmp_path):
    dataset = ImageFolderDataset({"images": str(image_folder)})
    assert [str(p.name) for p in dataset.paths] == ["view0.ppm", "view1.ppm", "view2.ppm"]
    assert dataset[1]["name"] == "view1.ppm" and dataset[1]["image"].shape == (1024, 1024, 3)
    (tmp_path / "a.png").write_bytes(b"\x89PNG\r\n\x1a\n" + bytes(64))
    write_image(tmp_path / "b.ppm", np.zeros((4, 6, 3), np.uint8))
    dataset = ImageFolderDataset({"images": str(tmp_path)})
    assert len(dataset) == 2 and dataset[1]["image_size"].tolist() == [1024.0, 683.0]
    with pytest.raises(IOError, match=r"\.png"):
        dataset[0]
    (tmp_path / "list.txt").write_text("b.ppm\n")
    listed = ImageFolderDataset({"images": str(tmp_path / "list.txt"),
                                 "root_folder": str(tmp_path)})
    assert len(listed) == 1 and listed[0]["name"] == "b.ppm"


KEYPOINTS = 128
CANVAS = 160


def test_export_then_cached_matcher_equals_the_full_pipeline(image_folder, tmp_path):
    """SuperPoint (sp_tpu_stage0b) exported over the folder; LightGlue
    (lg_tpu_stage2) with allow_no_extract on the cached features of views 0
    and 1 (float16 descriptors) agrees with the full pipeline on at least
    99% of matches0; the cache holds keypoints in original-image pixels."""
    conf = {"resize": CANVAS, "side": "long", "square_pad": True}
    dataset = ImageFolderDataset({"images": str(image_folder), "preprocessing": conf})
    sp_conf = {**eth3d_flagship_conf()["model"]["extractor"], "max_num_keypoints": KEYPOINTS}
    sp = build_extractor("extractors.superpoint", sp_conf, "cpu", weights=SP_STAGE0B_WEIGHTS)
    out = export_features(dataset, sp, tmp_path / "sp.npz", device="cpu")
    with np.load(out) as f:
        assert list(f["names"]) == ["view0.ppm", "view1.ppm", "view2.ppm"]
        assert f["descriptors"].dtype == np.float16 and f["keypoints"].shape == (3, KEYPOINTS, 2)
        assert f["keypoints"].max() <= 160 and f["keypoints"].max() > 100  # 160x120 pixels

    model_conf = merge(eth3d_flagship_conf()["model"],
                       {"extractor": sp_conf, "filter": {"name": None}})
    # lg_tpu_stage2 holds sp_tpu_stage0b's extractor
    full = load_model(model_conf, str(STAGE2_WEIGHTS), "cpu")
    cached = load_model({**model_conf, "allow_no_extract": True}, str(STAGE2_WEIGHTS), "cpu")
    items = [dataset[0], dataset[1]]
    data = {f"view{i}": to_model_input({k: v[None] for k, v in item.items()
                                        if isinstance(v, np.ndarray)}, "cpu")
            for i, item in enumerate(items)}
    loader = CacheLoader({"path": str(out)})
    for i, item in enumerate(items):
        data[f"view{i}"]["cache"] = view_cache(loader, item["name"], item["scales"], "cpu")
    with torch.inference_mode():
        ref, ours = full(data), cached(data)
    m_ref, m_ours = ref["matches0"].numpy(), ours["matches0"].numpy()
    assert (m_ref > -1).sum() > 40
    assert (m_ref == m_ours).mean() >= 0.99, (m_ref != m_ours).sum()
    np.testing.assert_allclose(ours["keypoints0"].numpy(), ref["keypoints0"].numpy(), atol=0.05)


def test_measure_pipeline_runs_on_the_cpu():
    conf = merge(eth3d_flagship_conf()["model"],
                 {"extractor": {"max_num_keypoints": 32},
                  "matcher": {"n_layers": 2}})
    model = build_model("two_view_pipeline", conf, device="cpu")
    out = measure_pipeline(model, batch=2, size=64, iters=2, warmup=1, device="cpu")
    assert out["pairs_per_s"] > 0 and out["ms_per_pair"] == pytest.approx(
        1e3 / out["pairs_per_s"])
    assert (out["batch"], out["size"], out["device"]) == (2, 64, "cpu")
