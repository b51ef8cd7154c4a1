"""The port's relative-pose benchmark path against the JAX package, on the
CPU: the pose-set renderer (scripts/generate_pose_eval_set.py and
datasets/homographies.generate_structured_image), the calibrated-pairs
dataset (datasets/image_pairs.py) and the evaluation of the MegaDepth-1500
pipeline, run through its ScanNet-1500 subclass at 640 pixels."""

import h5py
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from gluefactory_tpu.core.config import Config as JaxConfig
from gluefactory_tpu.datasets.homographies import generate_structured_image as jax_structured
from gluefactory_tpu.datasets.image_pairs import ImagePairsDataset as JaxImagePairsDataset
from gluefactory_tpu.eval.scannet1500 import ScanNet1500Pipeline as JaxScanNet1500Pipeline
from gluefactory_tpu.eval.utils import eval_poses as jax_eval_poses
from gluefactory_tpu.eval.utils import (
    eval_relative_pose_robust as jax_eval_relative_pose_robust,
)
from gluefactory_tpu.scripts.generate_pose_eval_set import render_pose_scene as jax_render
from gluefactory_tpu.utils.image import read_image as jax_read_image
from gluefactory_torch.core.config import merge
from gluefactory_torch.datasets.homographies import generate_structured_image
from gluefactory_torch.datasets.image_pairs import ImagePairsDataset
from gluefactory_torch.eval import get_benchmark
from gluefactory_torch.eval.eval_pipeline import SWEEP, unbatch
from gluefactory_torch.eval.scannet1500 import ScanNet1500Pipeline
from gluefactory_torch.eval.utils import (
    eval_poses,
    eval_relative_pose_robust,
    get_matches_scores,
)
from gluefactory_torch.geometry import essential as port_essential
from gluefactory_torch.geometry.epipolar import relative_pose_error
from gluefactory_torch.models.cache_loader import CacheLoader
from gluefactory_torch.recipes import pose_flagship_conf
from gluefactory_torch.robust_estimators.relative_pose import ransac as port_ransac
from gluefactory_torch.scripts.generate_pose_eval_set import render_pose_scene
from gluefactory_torch.settings import ROOT_PATH
from gluefactory_torch.utils.image import read_image
from test_torch_pose import _jax_sample_idx

torch.set_num_threads(2)


def _close_images(ours, theirs):
    """The renderer's bounds for OpenCV's fill rule: mean |diff| < 0.01 and under 2%
    of the pixels beyond 0.05 (images in [0, 1])."""
    diff = np.abs(np.asarray(ours, np.float64) - np.asarray(theirs, np.float64))
    assert diff.mean() < 0.01 and (diff > 0.05).mean() < 0.02, (diff.mean(),
                                                               (diff > 0.05).mean())


def test_pose_recipe_is_the_yaml():
    path = ROOT_PATH / "outputs/results/megadepth1500/sp0b_lg2_com_refine_pose/conf.yaml"
    assert pose_flagship_conf() == yaml.safe_load(path.read_text())
    assert (ROOT_PATH / pose_flagship_conf()["checkpoint"]).exists()


def test_structured_image_matches_jax():
    for seed in range(3):
        ours = generate_structured_image(np.random.default_rng(seed), (320, 240))
        theirs = jax_structured(np.random.default_rng(seed), (320, 240))
        assert ours.shape == theirs.shape == (240, 320, 3)
        _close_images(ours, theirs)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """One 640x480 scene with 2 pairs, rendered by both packages: (root of
    the port's, its pairs lines, root of JAX's, JAX's lines)."""
    root = tmp_path_factory.mktemp("pose")
    lines = render_pose_scene(root / "scene000", np.random.default_rng((31415, 0)))
    jroot = tmp_path_factory.mktemp("pose_jax")
    jlines = jax_render(jroot / "scene000", np.random.default_rng((31415, 0)))
    (root / "pairs_calibrated.txt").write_text("\n".join(lines) + "\n")
    return root, lines, jroot, jlines


def test_pose_scene_matches_jax(scene):
    """The pairs lines equal JAX's but for the image format (K and T to
    %.8g), and every view within the fill-rule bounds."""
    root, lines, jroot, jlines = scene
    assert [line.replace(".ppm", ".png") for line in lines] == jlines
    for name in ("0", "1", "2"):
        _close_images(read_image(root / "scene000" / f"{name}.ppm") / 255.0,
                      jax_read_image(jroot / "scene000" / f"{name}.png") / 255.0)


def test_image_pairs_dataset_matches_jax(scene):
    """Both datasets on the port's files at the pose benchmark's 1600 pixels
    (the views upsampled 2.5x by OpenCV's linear resize): cameras scaled
    alike to 1e-6 relative, T equal, images within 1e-5."""
    root = scene[0]
    conf = {"pairs": str(root / "pairs_calibrated.txt"), "root": str(root),
            "preprocessing": {"resize": 1600, "side": "long", "square_pad": True}}
    ours, ref = ImagePairsDataset(conf), JaxImagePairsDataset(conf)
    assert len(ours) == len(ref) == 2
    a, b = ours[1], ref[1]
    assert a["name"] == b["name"] == "scene000-0_scene000-2"
    for cam in ("camera0", "camera1"):
        for key in ("size", "f", "c", "dist"):
            np.testing.assert_allclose(getattr(a[cam], key).numpy(),
                                       np.asarray(getattr(b[cam], key)), rtol=1e-6)
    np.testing.assert_allclose(a["camera0"].f.numpy(), [1440.0, 1440.0], rtol=1e-6)
    np.testing.assert_array_equal(a["T_0to1"].R.numpy(), np.asarray(b["T_0to1"].R))
    np.testing.assert_array_equal(a["T_0to1"].t.numpy(), np.asarray(b["T_0to1"].t))
    for v in ("view0", "view1"):
        assert a[v]["image"].shape == (1600, 1600, 3)
        np.testing.assert_allclose(a[v]["image"], b[v]["image"], rtol=0, atol=1e-5)
        for key in ("image_size", "orig_size", "scales", "transform", "valid_mask"):
            np.testing.assert_array_equal(a[v][key], np.asarray(b[v][key]), err_msg=key)

    # the homography form: 9 numbers, composed with both views' resizes
    H = np.array([[1.1, 0.05, -12.0], [-0.02, 0.95, 7.5], [1e-4, -2e-4, 1.0]])
    (root / "pairs_h.txt").write_text("scene000/0.ppm scene000/1.ppm "
                                      + " ".join(f"{x:.8g}" for x in H.ravel()) + "\n")
    conf = {"pairs": str(root / "pairs_h.txt"), "root": str(root),
            "preprocessing": {"resize": 320}}
    a, b = ImagePairsDataset(conf)[0], JaxImagePairsDataset(conf)[0]
    assert "camera0" not in a
    np.testing.assert_allclose(a["H_0to1"], b["H_0to1"], rtol=1e-6)


def _jax_draws_and_bases(monkeypatch):
    """Make the port's RANSAC draw JAX's minimal sets (jax.random.categorical
    over the valid matches, the estimator's key) and solve them on JAX's
    null-space bases (each SVD returns another basis of the 4-dimensional
    null space, and the candidates depend on it); float64 minimal sets keep
    the port's own bases, since JAX computes in float32."""
    port_bases = port_essential.null_space_basis

    def draws(valid, num_hypotheses, generator=None, size=4):
        return torch.from_numpy(_jax_sample_idx(valid.cpu().numpy(), 0, num_hypotheses, size))

    def bases(x0, x1):
        if x0.dtype == torch.float64:
            return port_bases(x0, x1)
        x0, x1 = (torch.cat([x, torch.ones_like(x[..., :1])], -1) for x in (x0, x1))
        a = (x1[..., :, None] * x0[..., None, :]).reshape(*x0.shape[:-2], 5, 9)
        vt = jnp.linalg.svd(jnp.asarray(a.numpy()), full_matrices=True)[2]
        return torch.from_numpy(np.array(vt[..., 5:, :])).reshape(*x0.shape[:-2], 4, 3, 3)

    monkeypatch.setattr(port_ransac, "sample_minimal_sets", draws)
    monkeypatch.setattr(port_essential, "null_space_basis", bases)


def test_pipeline_evaluation_matches_jax(scene, tmp_path, monkeypatch):
    """ScanNet1500Pipeline (MegaDepth-1500's evaluation at 640 pixels) with
    the flagship at 1024 keypoints and 256 hypotheses on the 2 pairs; its
    predictions go to JAX's pipeline too, and the port's RANSAC gets JAX's
    minimal sets and null-space bases. Matches equal, epipolar precision
    within 0.005; the pose error at each of the 6 thresholds within 1e-2
    degrees of JAX's on all but one of the 12 (pair, threshold), within 1
    degree on all. Where a (pair, threshold) differs by more than 1e-2
    degrees, float32 rounding decided it: an LO step's weighted 8-point
    (an eigh of the 9x9 normal matrix) scores on either side of the current
    model depending on the float32 implementation, and the port run in
    float64 from the same minimal sets is within 1e-2 degrees of JAX. The
    summaries are those of each side's errors, and the port's mAA is within
    what the error differences can move it: AUC@T moves by at most
    |de| / (T n) for an error that moves by de, so the mAA of a threshold by
    at most 100 sum |de| / (5 n), and so does the best threshold's, plus
    the rounding to 3 decimals."""
    assert get_benchmark("scannet1500") is ScanNet1500Pipeline
    root = scene[0]
    flagship = pose_flagship_conf()
    conf = merge({k: v for k, v in flagship.items() if k != "data"}, {
        "data": {"pairs": str(root / "pairs_calibrated.txt"), "root": str(root),
                 "num_workers": 1},
        "eval": {"num_hypotheses": 256},
        "checkpoint": str(ROOT_PATH / flagship["checkpoint"]),
    })
    if not torch.cuda.is_available():  # the entry point runs on the card unless asked
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ScanNet1500Pipeline(conf)
    _jax_draws_and_bases(monkeypatch)
    pipeline = ScanNet1500Pipeline(conf, device="cpu")
    summaries, results = pipeline.run(tmp_path / "port")
    assert len(pipeline.timings["ransac_sweep_ms"]) == 2

    pred_h5 = tmp_path / "predictions.h5"
    with np.load(tmp_path / "port" / "predictions.npz") as f, h5py.File(pred_h5, "w") as h:
        for i, name in enumerate(f["names"]):
            group = h.create_group(str(name))
            for key in f.files:
                if key != "names":
                    group.create_dataset(key, data=f[key][i])
    jpipeline = JaxScanNet1500Pipeline(conf)
    jsummaries, _, jresults = jpipeline.run_eval(jpipeline.get_dataloader(), pred_h5)
    np.testing.assert_array_equal(results["num_matches"], jresults["num_matches"])
    assert min(results["num_matches"]) > 200
    for key in ("epi_prec@1e-04", "epi_prec@5e-04", "epi_prec@1e-03"):
        np.testing.assert_allclose(results[key], jresults[key], atol=0.005)

    # each threshold of the sweep, as the pipelines run it
    cache_loader = CacheLoader({"path": str(tmp_path / "port" / "predictions.npz")})
    errors, jerrors, float64 = {}, {}, {}
    for batch, jbatch in zip(pipeline.get_dataloader(), jpipeline.get_dataloader()):
        data, pred = unbatch(batch), cache_loader(batch)
        jdata = {k: v[0] if k.startswith(("camera", "T_")) else v for k, v in jbatch.items()}
        for th in SWEEP:
            errors.setdefault(th, []).append(eval_relative_pose_robust(
                data, pred, merge(conf["eval"], {"ransac_th": th}), device="cpu"))
            jerrors.setdefault(th, []).append(jax_eval_relative_pose_robust(
                jdata, pred, JaxConfig(merge(conf["eval"], {"ransac_th": th}))))
            if abs(errors[th][-1]["rel_pose_error"] - jerrors[th][-1]["rel_pose_error"]) >= 1e-2:
                float64[(batch["name"][0], th)] = (
                    _float64_pose_error(data, pred, th, conf["eval"]),
                    jerrors[th][-1]["rel_pose_error"])
    diffs = np.array([[abs(e["rel_pose_error"] - j["rel_pose_error"])
                       for e, j in zip(errors[th], jerrors[th])] for th in SWEEP])
    assert (diffs < 1e-2).sum() >= diffs.size - 1 and diffs.max() < 1.0, diffs
    for case, (ours, theirs) in float64.items():
        assert abs(ours - theirs) < 1e-2, (case, ours, theirs)
    pose = eval_poses(errors, auc_ths=[5, 10, 20], key="rel_pose_error")
    assert {k: v for k, v in summaries.items() if k in pose} == pose
    jpose = jax_eval_poses(jerrors, auc_ths=[5, 10, 20], key="rel_pose_error")
    assert eval_poses(jerrors, auc_ths=[5, 10, 20], key="rel_pose_error") == jpose
    assert {k: v for k, v in jsummaries.items() if k in jpose} == jpose
    assert set(summaries) == set(jsummaries) and float(summaries["rel_pose_error_mAA"]) > 80
    bound = 100 * diffs.sum(1).max() / (5 * diffs.shape[1]) + 1e-3
    assert abs(float(summaries["rel_pose_error_mAA"])
               - float(jsummaries["rel_pose_error_mAA"])) <= bound
    for key in ("mnum_matches", "mepi_prec@1e-04", "mepi_prec@5e-04", "mepi_prec@1e-03"):
        assert abs(float(summaries[key]) - float(jsummaries[key])) <= (
            1e-3 if key == "mnum_matches" else 0.005 + 1e-3), key


def _float64_pose_error(data, pred, th, conf):
    """The pose error (degrees) of the port's RANSAC at ``th`` px in float64,
    from the minimal sets the estimator draws."""
    pts0, pts1, _, valid = get_matches_scores(pred["keypoints0"], pred["keypoints1"],
                                              pred["matches0"], pred["matching_scores0"])
    cams = [data[f"camera{i}"].to(dtype=torch.float64) for i in (0, 1)]
    rays = [c.image2cam(torch.from_numpy(p).double()[None])[0] for c, p in zip(cams, (pts0, pts1))]
    valid = torch.from_numpy(valid)
    idx = port_ransac.sample_minimal_sets(valid, conf["num_hypotheses"], None, 5)
    f_mean = float(torch.cat([c.f for c in cams]).mean())
    _, R, t, _, _ = port_ransac.ransac_essential(
        *rays, valid, th=th / f_mean, num_hypotheses=conf["num_hypotheses"],
        lo_iters=conf["lo_iters"], sample_idx=idx)
    r_err, t_err = relative_pose_error(data["T_0to1"].to(dtype=torch.float64), R, t)
    return float(torch.maximum(r_err, t_err))
