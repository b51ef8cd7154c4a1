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
          "matchers.match_refiner", "two_view_pipeline"]


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
    ("extractors.superpoint", {"has_detector": False}),
    ("extractors.superpoint", {"dense_outputs": True}),
    ("extractors.superpoint", {"training_outputs": True}),
    ("matchers.lightglue", {"loss": {"nll_balancing": 0.25}}),
    ("matchers.lightglue", {"loss": {"fn": "focal"}}),
    ("extractors.superpoint", {"loss": {"loc_weight": 1.0}}),
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


def test_trainer_refuses_run_benchmarks():
    """A benchmark that is not ported, and an overlay that changes a
    parameter's shape (the JAX trainer's message), are refused before any
    step; hpatches with an overlay of keypoint counts is accepted."""
    conf = stage2_conf()
    conf["data"].update(pool_size=1, source_size=[96, 96])
    conf["train"]["load_experiment"] = None  # stage 2's start is not committed
    conf["train"]["run_benchmarks"] = [{"name": "megadepth1500"}]
    with pytest.raises(NotImplementedError, match="megadepth1500"):
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
