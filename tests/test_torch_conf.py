"""The port's model confs against the JAX models' defaults, the refusal of
what the port does not implement, and the attention kernels' layout plan,
on the CPU."""

import math

import numpy as np
import pytest
import torch

from gluefactory_torch.flagship import flagship_conf
from gluefactory_torch.models import build_model, get_model
from gluefactory_torch.models.base_model import unported_settings
from gluefactory_torch.ops import attention as A
from gluefactory_torch.recipes import stage2_conf
from gluefactory_torch.train import Trainer
from gluefactory_tpu.models import get_model as jax_get_model

torch.set_num_threads(2)

PORTED = ["extractors.superpoint", "matchers.lightglue", "matchers.homography_matcher",
          "matchers.match_refiner", "two_view_pipeline", "extractors.sift",
          "matchers.superglue", "matchers.nearest_neighbor_matcher", "matchers.adalam",
          "matchers.depth_matcher", "matchers.oracle_matcher", "lines.lsd", "lines.wireframe",
          "matchers.gluestick", "lines.sold2", "extractors.joint_point_line_extractor",
          "lines.pold2_extractor", "matchers.nn_point_line", "matchers.loftr",
          "extractors.aliked", "extractors.aliked_light"]


def _leaves(conf: dict, prefix: str = "") -> dict:
    out = {}
    for key, value in conf.items():
        if isinstance(value, dict) and value:
            out.update(_leaves(value, f"{prefix}{key}."))
        else:
            out[prefix + key] = value
    return out


def _set(conf: dict, dotted: str, value) -> dict:
    *parents, leaf = dotted.split(".")
    node = conf
    for part in parents:
        node = node.setdefault(part, {})
    node[leaf] = value
    return conf


def _other(value):
    """A value that differs from ``value`` and has its kind."""
    if isinstance(value, bool):
        return not value
    if value is None:
        return "lg_tpu_stage2.f16.msgpack"
    if isinstance(value, str):
        return "bf16" if value == "float32" else value + "_other"
    return value + 1


@pytest.mark.parametrize("name", PORTED)
def test_port_defaults_hold_every_jax_key_at_its_value(name):
    jax_defaults = _leaves(jax_get_model(name).collect_default_conf().to_dict())
    port_defaults = _leaves(build_model(name, device="cpu").conf)
    missing = sorted(set(jax_defaults) - set(port_defaults))
    assert not missing, f"{name}: JAX keys missing from the port: {missing}"
    differ = {k: (v, port_defaults[k]) for k, v in jax_defaults.items() if port_defaults[k] != v}
    assert not differ, f"{name}: defaults differ (JAX, port): {differ}"


@pytest.mark.parametrize("name", PORTED)
def test_unported_keys_refuse_any_other_value(name):
    cls = get_model(name)
    defaults = build_model(name, device="cpu").conf
    leaves = sorted(unported_settings(cls, {}, defaults))  # every unported leaf
    assert "timeit" in leaves
    for leaf in leaves:
        value = _other(_leaves(defaults)[leaf])
        with pytest.raises(NotImplementedError, match=leaf.replace(".", r"\.")):
            build_model(name, _set({}, leaf, value), device="cpu")
    # a key that neither package knows is merged and ignored, as in JAX
    assert build_model(name, {"not_a_key": 1}, device="cpu").conf["not_a_key"] == 1


@pytest.mark.parametrize("name,conf", [
    ("matchers.lightglue", {"dtype": "float16"}),  # float32 and bf16 are ported
    ("extractors.superpoint", {"dtype": "float16"}),
    # the switches and the loss are ported now; these cases hold the keys still refused
    ("extractors.superpoint", {"weights": "superpoint_v1.pth"}),
    ("extractors.superpoint", {"timeit": True}),
    ("extractors.superpoint", {"dtype": "float64"}),
    ("matchers.lightglue", {"loss": {"nll_balancing": 0.25}}),
    ("matchers.lightglue", {"loss": {"fn": "focal"}}),
    ("extractors.superpoint", {"dtype": "int8"}),
    # LBD and SOLD2's loss are ported (tests/test_torch_line_models.py,
    # tests/test_torch_shapes_train.py): timeit stays refused
    ("lines.sold2", {"timeit": True}),
    ("matchers.gluestick", {"timeit": True}),
])
def test_refused_settings_name_the_key(name, conf):
    key = next(iter(_leaves(conf)))
    with pytest.raises(NotImplementedError, match=key.replace(".", r"\.")):
        build_model(name, conf, device="cpu")


def test_pipeline_refuses_through_its_slots():
    conf = stage2_conf()["model"]
    conf["matcher"]["loss"] = {"fn": "focal"}
    with pytest.raises(NotImplementedError, match=r"LightGlue does not implement loss\.fn"):
        build_model("two_view_pipeline", conf, device="cpu")


def test_recipes_still_build():
    for conf in (stage2_conf()["model"], flagship_conf()):
        model = build_model("two_view_pipeline", conf, device="cpu")
        assert model.matcher.conf["dtype"] == "float32"


@pytest.mark.parametrize("name,conf", [
    ("extractors.superpoint", {"has_detector": False}),
    ("extractors.superpoint", {"has_descriptor": False}),
    ("extractors.superpoint", {"dense_outputs": True}),
    ("extractors.superpoint", {"training_outputs": True}),
    ("extractors.superpoint", {"loss": {"loc_weight": 1.0, "cell_labels": "soft"}}),
    ("matchers.lightglue", {"depth_confidence": 0.95, "width_confidence": 0.99}),
    ("matchers.superglue", {"norm": "none", "input_dim": 128}),
    ("matchers.nearest_neighbor_matcher", {"ratio_thresh": 0.8, "mutual_check": False}),
    ("extractors.sift", {"contrast_threshold": 0.02, "rootsift": False}),
    ("matchers.lightglue", {"add_scale_ori": True, "input_dim": 128}),
    ("matchers.match_refiner", {"window_sampling": "static"}),
    ("matchers.match_refiner", {"window_sampling": False, "affine_compensation": False}),
    ("matchers.depth_matcher", {"th_epi": 2.0, "use_points": False}),
    ("matchers.oracle_matcher", {"source": "depth"}),
    ("matchers.adalam", {"num_seeds": 32, "seed": 3}),
    ("matchers.depth_matcher", {"use_lines": True, "line_dist_th": 3.0}),
    ("matchers.homography_matcher", {"use_lines": True, "line_overlap_th": 0.3}),
    ("matchers.gluestick", {"checkpointed": True, "loss": {"inter_weight": 1.0}}),
    ("lines.sold2", {"loss": {"desc_nll_weight": 1.0}}),
    ("extractors.joint_point_line_extractor",
     {"extract_lines": True, "line_desc_samples": 8, "loss": {"heatmap": "focal"}}),
])
def test_ported_switches_build(name, conf):
    """The keys this slice ported left ``unported_conf`` and build."""
    model = build_model(name, conf, device="cpu")
    for key, value in _leaves(conf).items():
        assert _leaves(model.conf)[key] == value


def test_cached_engine_on_host_builds_and_weights_refuse_off_it(tmp_path, monkeypatch):
    """``features_from.on_host`` (the cached SIFT recipes) extracts its pool,
    with SIFT's scales and orientations; ``features_from.weights`` is read
    on_host (tests/test_torch_sift_train.py) and refused by the extractor
    off it, as SuperPoint refuses its unported ``weights`` key."""
    from gluefactory_torch import settings
    from gluefactory_torch.datasets import get_dataset
    from gluefactory_torch.recipes import sift_sg_cached_conf

    monkeypatch.setattr(settings, "DATA_PATH", tmp_path)
    conf = {**sift_sg_cached_conf()["data"], "pool_size": 2, "source_size": [96, 96],
            "pool_cache": False}
    pool = get_dataset(conf["name"])(conf).build_pool("train", "cpu")
    assert {"scales", "oris"} <= set(pool) and pool["descriptors"].shape == (2, 512, 128)
    conf["features_from"] = {"name": "extractors.superpoint", "max_num_keypoints": 16,
                             "weights": "sp_tpu_stage0b.f16.msgpack"}
    with pytest.raises(NotImplementedError, match="weights"):
        get_dataset(conf["name"])(conf).build_pool("train", "cpu")


def test_trainer_refuses_run_benchmarks():
    """A benchmark that the port does not have (every benchmark of the JAX
    package is ported now, so a name that neither package has), and an
    overlay that changes a parameter's shape (the JAX trainer's message), are
    refused before any step; hpatches with an overlay of keypoint counts is
    accepted."""
    conf = stage2_conf()
    conf["data"].update(pool_size=1, source_size=[96, 96])
    conf["train"]["load_experiment"] = None  # stage 2's start is not committed
    conf["train"]["run_benchmarks"] = [{"name": "megadepth1500_lines"}]
    with pytest.raises(NotImplementedError, match="megadepth1500_lines"):
        Trainer(conf, device="cpu")
    conf["train"]["run_benchmarks"] = [{"name": "hpatches",
                                        "model": {"matcher": {"descriptor_dim": 128}}}]
    with pytest.raises(ValueError, match=r"run_benchmarks\[hpatches\]\.model overlay changes"):
        Trainer(conf, device="cpu")
    conf["train"]["run_benchmarks"] = [{"name": "hpatches",
                                        "model": {"extractor": {"max_num_keypoints": 1024}}}]
    trainer = Trainer(conf, device="cpu")
    overlay = trainer.bench_models["hpatches"]
    assert overlay.extractor.conf["max_num_keypoints"] == 1024
    assert overlay.matcher.input_proj.weight is trainer.model.matcher.input_proj.weight


# --- the attention kernels' layout ---------------------------------------------

@pytest.mark.parametrize("sms", [A.DEFAULT_SMS, 16])
@pytest.mark.parametrize("shape", [(1, 4, 512, 512), (32, 4, 512, 512), (8, 4, 1024, 1024),
                                   (1, 4, 1000, 777), (2, 4, 300, 300), (1, 4, 64, 4000),
                                   (2, 1, 5, 3)])
def test_attention_plan_covers_every_row_and_key_once(shape, sms):
    b, h, nq, nk = shape
    plan = A.plan_attention(b, h, nq, nk, sms)
    assert plan.rows in (16, 32, 64) and plan.tiles_per_split >= 1 and plan.splits >= 1
    # block (x, bh, s): rows [x*rows, (x+1)*rows), key tiles [s*tps, (s+1)*tps)
    cover = np.zeros((nq, nk), np.int32)
    tile_keys = plan.tiles_per_split * A.KEY_TILE
    for x in range(math.ceil(nq / plan.rows)):
        for s in range(plan.splits):
            keys = slice(s * tile_keys, min(nk, (s + 1) * tile_keys))
            assert keys.start < keys.stop, f"split {s} of {plan} has no key"
            cover[x * plan.rows:(x + 1) * plan.rows, keys] += 1
    assert (cover == 1).all()
    blocks = b * h * math.ceil(nq / plan.rows)
    full_grid = 2 * sms  # every SM twice
    if blocks >= full_grid:  # enough work: one block walks all keys
        assert plan.splits == 1
    else:
        assert blocks * plan.splits >= min(full_grid, blocks * math.ceil(nk / A.KEY_TILE))


@pytest.mark.parametrize("shape,sms,splits", [((32, 4, 512, 512), 132, 1),
                                              ((8, 4, 1024, 1024), 132, 1),
                                              ((1, 4, 512, 512), 132, 8),
                                              ((1, 4, 512, 512), 16, 1)])
def test_attention_plan_splits_keys_only_where_work_is_scarce(shape, sms, splits):
    assert A.plan_attention(*shape, sms).splits == splits
