"""The refiner's static mode and its legacy direct taps
(gluefactory_torch/models/matchers/match_refiner.py) against the JAX
refiner's on the same inputs, and the static mode against the port's window
mode on a pair whose ground truth is known."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gluefactory_torch.models.matchers.match_refiner import MatchRefiner
from gluefactory_tpu.models import build_model as jax_build_model

torch.set_num_threads(2)

H_TRUE = np.array([[1.04, 0.05, -3.0], [-0.03, 0.97, 2.5], [2e-4, -1e-4, 1.0]])
SIZE = 112


def _texture(rng):
    """A smooth texture as a function of continuous pixel coordinates."""
    waves = [(rng.uniform(-k, k, 2) / SIZE * 2 * np.pi, rng.uniform(0.2, 1.0),
              rng.uniform(0, 6.3)) for k in (4, 9, 17) for _ in range(6)]

    def tex(x, y):
        img = sum(a * np.cos(f[0] * x + f[1] * y + ph) for f, a, ph in waves)
        return (img + 8.0) / 16.0

    return tex


def _warp(pts, H):
    hp = np.concatenate([pts, np.ones_like(pts[..., :1])], -1) @ H.T
    return hp[..., :2] / hp[..., 2:]


def homography_pair(seed: int = 5, n: int = 48):
    """Image 1 is image 0 seen through H_TRUE; kp1 are the true matches of
    kp0 with 1 px of noise. Returns (data as numpy, the true kp1 of each
    kp0)."""
    rng = np.random.default_rng(seed)
    tex = _texture(rng)
    yy, xx = np.meshgrid(np.arange(SIZE, dtype=np.float64), np.arange(SIZE, dtype=np.float64),
                         indexing="ij")
    img0 = tex(xx, yy)
    back = _warp(np.stack([xx, yy], -1), np.linalg.inv(H_TRUE))
    img1 = tex(back[..., 0], back[..., 1]) * 0.9 + 0.05
    kp0 = rng.uniform(18, SIZE - 22, (1, n, 2))
    true1 = _warp(kp0, H_TRUE)
    noisy1 = true1 + rng.normal(0, 1.0, true1.shape)
    matches0 = rng.permutation(n)[None]
    order = np.argsort(matches0[0])  # kp1[matches0[i]] is kp0[i]'s match
    matches0[0, :3] = -1
    valid0 = np.ones((1, n), bool)
    valid0[0, 5] = False
    data = {"view0": {"image": img0[None, :, :, None].astype(np.float32)},
            "view1": {"image": np.repeat(img1[None, :, :, None], 3, -1).astype(np.float32)},
            "keypoints0": kp0.astype(np.float32),
            "keypoints1": noisy1[:, order].astype(np.float32),
            "matches0": matches0.astype(np.int32),
            "matching_scores0": rng.uniform(0.2, 1.0, (1, n)).astype(np.float32),
            "keypoint_valid0": valid0}
    return data, true1


def _both(conf, data):
    jdata = jax.tree.map(jnp.asarray, data)
    jmodel = jax_build_model("matchers.match_refiner", conf)
    jpred = jax.jit(jmodel.apply)({}, jdata)  # the refiner has no parameters
    pred = MatchRefiner(conf)(jax.tree.map(torch.from_numpy, data))
    return pred, jpred


@pytest.mark.parametrize("conf", [
    {"window_sampling": "static"},
    {"window_sampling": "static", "affine_compensation": False},
    {"window_sampling": False},
    {"window_sampling": False, "affine_compensation": False},
    {"window_sampling": "static", "search_step": 0.5},  # falls back to the window mode
])
def test_refiner_mode_matches_jax(conf):
    """Each mode against JAX's on the homography pair: the same matches are
    refined and the refined keypoints agree within 1e-3 px (the IRLS
    homography's 9x9 eigensolvers differ in the last bits, as in window
    mode's test in tests/test_torch_models.py)."""
    data, _ = homography_pair()
    pred, jpred = _both(conf, data)
    np.testing.assert_array_equal(pred["refined1"].numpy(), np.asarray(jpred["refined1"]))
    moved = np.abs(pred["keypoints1"].numpy() - data["keypoints1"]).max(-1) > 0.05
    assert moved.sum() > 20
    np.testing.assert_allclose(pred["keypoints1"].numpy(), np.asarray(jpred["keypoints1"]),
                               atol=1e-3)


def _errors(pred, data, true1):
    """(refined, unrefined) distance to the truth of each refined match."""
    m0 = data["matches0"][0]
    ok = (m0 >= 0) & data["keypoint_valid0"][0]
    kp1 = pred["keypoints1"].numpy()[0, m0[ok]]
    before = data["keypoints1"][0, m0[ok]]
    truth = true1[0, ok]
    return np.linalg.norm(kp1 - truth, axis=-1), np.linalg.norm(before - truth, axis=-1)


def test_static_against_window_mode_on_a_known_homography():
    """The static formulation (template-side affine, constant-index reads)
    against the window mode: both bring the matches closer to the truth
    than the matcher left them, and their refined keypoints lie close to
    each other (they sample different images at the affinely mapped patch,
    so they are not equal)."""
    data, true1 = homography_pair(seed=7)
    tdata = jax.tree.map(torch.from_numpy, data)
    static = MatchRefiner({"window_sampling": "static"})(tdata)
    window = MatchRefiner({"window_sampling": True})(tdata)
    err_s, before = _errors(static, data, true1)
    err_w, _ = _errors(window, data, true1)
    assert np.median(before) > 0.8
    assert np.median(err_s) < 0.25 * np.median(before), (np.median(err_s), np.median(before))
    assert np.median(err_w) < 0.25 * np.median(before)
    assert err_s.mean() < before.mean() and err_w.mean() < before.mean()
    gap = np.linalg.norm(static["keypoints1"].numpy() - window["keypoints1"].numpy(), axis=-1)
    assert np.median(gap) < 0.05 and gap.max() < 0.2, (np.median(gap), gap.max())


def eth3d_refiner_readings(set_dir: str, pairs: int = 8) -> dict:
    """The flagship's matches of the first ``pairs`` pairs of an ETH3D set,
    computed by the port at full width on the CPU, refined by each package
    in static and in window mode on the same inputs: the port's static mode
    against JAX's, and each package's static-against-window spread."""
    from gluefactory_torch import recipes
    from gluefactory_torch.core.config import merge
    from gluefactory_torch.eval.eth3d import ETH3DPipeline
    from gluefactory_torch.eval.eval_pipeline import to_model_input
    from gluefactory_torch.eval.io import load_model

    conf = merge(recipes.eth3d_flagship_conf(), {"data": {"data_dir": set_dir}})
    model = load_model(conf["model"], conf["checkpoint"], "cpu")
    dataset = ETH3DPipeline(conf, device="cpu").dataset
    modes = {"static": "static", "window": True}
    jax_refiners = {name: jax_build_model("matchers.match_refiner", {"window_sampling": mode})
                    for name, mode in modes.items()}
    compared = {"port_static_vs_jax_static": ("port_static", "jax_static"),
                "port_window_vs_jax_window": ("port_window", "jax_window"),
                "port_static_vs_window": ("port_static", "port_window"),
                "jax_static_vs_window": ("jax_static", "jax_window")}
    gaps = {key: [] for key in compared}
    same_refined = True
    for i, batch in enumerate(dataset.get_data_loader("test")):
        if i == pairs:
            break
        data = to_model_input(batch, "cpu")
        with torch.inference_mode():
            pred = {}
            for v in ("0", "1"):
                pred.update({k + v: x for k, x in model.extract_view(data, v).items()})
            pred.update(model.matcher({**data, **pred}))
        inputs = {"view0": {"image": data["view0"]["image"].numpy()},
                  "view1": {"image": data["view1"]["image"].numpy()},
                  **{k: pred[k].numpy() for k in ("keypoints0", "keypoints1", "matches0",
                                                  "matching_scores0", "keypoint_valid0")}}
        out = {}
        for name, mode in modes.items():
            port = MatchRefiner({"window_sampling": mode})(jax.tree.map(torch.from_numpy, inputs))
            jdata = jax.tree.map(jnp.asarray, inputs)
            jmodel = jax_refiners[name]
            jpred = jmodel.apply(jmodel.init(jax.random.key(0), jdata), jdata)
            out[f"port_{name}"] = {k: np.asarray(port[k]) for k in ("keypoints1", "refined1")}
            out[f"jax_{name}"] = {k: np.asarray(jpred[k]) for k in ("keypoints1", "refined1")}
        for name in modes:
            same_refined &= bool((out[f"port_{name}"]["refined1"]
                                  == out[f"jax_{name}"]["refined1"]).all())
        moved = out["port_window"]["refined1"][0]
        m0 = inputs["matches0"][0][moved]
        for key, (a, b) in compared.items():
            gaps[key].append(np.linalg.norm(out[a]["keypoints1"][0][m0]
                                            - out[b]["keypoints1"][0][m0], axis=-1))
        print(f"pair {i}: {int(moved.sum())} refined", flush=True)
    report = {"pairs": pairs, "refined": int(sum(len(g) for g in gaps["jax_static_vs_window"])),
              "refined1_equal": same_refined}
    for key, values in gaps.items():
        g = np.concatenate(values)
        report[key] = {"within_1e-3px": float((g <= 1e-3).mean()),
                       "within_0.05px": float((g <= 0.05).mean()),
                       "median_px": float(np.median(g)), "p99_px": float(np.quantile(g, 0.99)),
                       "max_px": float(g.max())}
    return report


if __name__ == "__main__":
    import argparse
    import json

    parser = argparse.ArgumentParser(
        description="the refiner's static and window modes of both packages on the "
                    "flagship's matches of an ETH3D set (the port's chip_smoke REFINER_CPU)")
    parser.add_argument("--set", required=True,
                        help="a set of python -m gluefactory_torch.scripts.generate_eth3d_set")
    parser.add_argument("--pairs", type=int, default=8)
    args = parser.parse_args()
    jax.config.update("jax_platforms", "cpu")
    print(json.dumps(eth3d_refiner_readings(args.set, args.pairs)), flush=True)
