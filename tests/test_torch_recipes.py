"""The recipes of the cached-feature engine, the host dataset and the
remaining SuperPoint+LightGlue YAMLs (gluefactory_torch/recipes.py): each
dict equal to its YAML, each start blob committed; and the trainer's
``load_experiment`` restore (utils/experiments.restore_components) whole
component by component, on the CPU."""

import logging

import pytest
import torch
import yaml

from gluefactory_torch import recipes as R
from gluefactory_torch.models import build_model
from gluefactory_torch.settings import ROOT_PATH
from gluefactory_torch.utils.experiments import restore_components
from gluefactory_torch.utils.weights import load_weight_blob, params_from_flat

torch.set_num_threads(2)

# recipe function -> (its YAML, the blob a run starts from)
RECIPES = {
    "stage4_conf": ("superpoint+lightglue_stage4_r3", R.STAGE2_WEIGHTS),
    "stage3_conf": ("superpoint+lightglue_stage3_r3", R.STAGE2_WEIGHTS),
    "lg_homography_conf": ("superpoint+lightglue_homography", R.SP_STAGE0B_WEIGHTS),
    "stage6_sp0b_conf": ("superpoint+lightglue_stage6_sp0b", R.STAGE2_WEIGHTS),
    "sp_finetune_loc_conf": ("superpoint_finetune_loc", R.SP_STAGE0_WEIGHTS),
    "sp_stage1b_conf": ("superpoint_stage1b_r3", R.SP_STAGE0B_WEIGHTS),
    "sp_stage1c_conf": ("superpoint_stage1c_r3", R.SP_STAGE0B_WEIGHTS),
    "lg_ondevice_conf": ("superpoint+lightglue_ondevice", R.SP_STAGE0_WEIGHTS),
    "lg_ondevice_r3_conf": ("superpoint+lightglue_ondevice_r3", R.LG_STAGE1_R2_WEIGHTS),
}


@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_recipe_is_its_yaml(recipe):
    name, start = RECIPES[recipe]
    path = ROOT_PATH / "gluefactory_tpu/configs" / f"{name}.yaml"
    assert getattr(R, recipe)() == yaml.safe_load(path.read_text())
    # the docstring names the committed blob a run starts from
    const = next(k for k in dir(R) if k.endswith("_WEIGHTS") and getattr(R, k) == start)
    assert start.exists() and const in getattr(R, recipe).__doc__
    assert R.SP_STAGE1C_WEIGHTS.exists()  # stage 3's features


# the SIFT recipes -> their YAML; sift_lg_stage2_conf starts from the export of the
# run its YAML names (lg_sift_stage1), which is not committed
SIFT_RECIPES = {"sift_lg_cached_conf": "sift+lightglue_cached",
                "sift_lg_stage2_conf": "sift+lightglue_stage2",
                "sift_sg_cached_conf": "sift+superglue_cached",
                "sift_lightglue_conf": "sift+lightglue"}


@pytest.mark.parametrize("recipe", sorted(SIFT_RECIPES))
def test_sift_recipe_is_its_yaml(recipe):
    path = ROOT_PATH / "gluefactory_tpu/configs" / f"{SIFT_RECIPES[recipe]}.yaml"
    conf, yaml_conf = getattr(R, recipe)(), yaml.safe_load(path.read_text())
    if recipe == "sift_lg_stage2_conf":
        assert yaml_conf["train"]["load_experiment"] == "lg_sift_stage1"
        assert conf["train"]["load_experiment"] == "weights/lg_sift_stage1.f16.msgpack"
        assert (ROOT_PATH / conf["train"]["load_experiment"]).exists()
        yaml_conf["train"]["load_experiment"] = conf["train"]["load_experiment"]
    assert conf == yaml_conf
    model = build_model("two_view_pipeline", conf["model"], device="cpu")
    if recipe == "sift_lg_stage2_conf":
        restore_components(model, conf["train"]["load_experiment"])
        expected = _blob_state(R.LG_SIFT_STAGE1_WEIGHTS, "matcher")
        for name, value in model.state_dict().items():
            assert torch.equal(value, expected[name]), name


def _blob_state(path, scope):
    flat, _, _ = load_weight_blob(path)
    return params_from_flat({k: v for k, v in flat.items() if f"['{scope}']" in k},
                            {"matcher": 4})


def test_stage4_starts_from_the_matcher_of_a_full_blob():
    """Stage 4's matcher-only pipeline from lg_tpu_stage2 (both halves): the
    extractor half dropped, every matcher parameter the blob's; a matcher
    that the blob holds in part (fewer layers) refused."""
    model = build_model("two_view_pipeline", R.stage4_conf()["model"], device="cpu")
    restore_components(model, R.stage4_conf()["train"]["load_experiment"])
    expected = _blob_state(R.STAGE2_WEIGHTS, "matcher")
    assert model.extractor is None and set(model.state_dict()) == set(expected)
    for name, value in model.state_dict().items():
        assert torch.equal(value, expected[name]), name
    conf = R.stage4_conf()["model"]
    conf["matcher"]["n_layers"] = 2
    with pytest.raises(KeyError, match="in part"):
        restore_components(build_model("two_view_pipeline", conf, device="cpu"),
                           R.STAGE2_WEIGHTS)


def test_stage1_and_stage6_starts(caplog):
    """Stage 1's extractor from the stage-0b blob, its 9-layer matcher left
    at its initialisation (logged); stage 6 from two blobs, the later one's
    extractor over the earlier one's."""
    conf = R.lg_homography_conf()["model"]
    torch.manual_seed(0)
    model = build_model("two_view_pipeline", conf, device="cpu")
    before = {k: v.clone() for k, v in model.matcher.state_dict().items()}
    with caplog.at_level(logging.WARNING):
        restore_components(model, str(R.SP_STAGE0B_WEIGHTS))
    assert "the matcher: it keeps its initialisation" in caplog.text
    assert model.matcher.conf["n_layers"] == 9 and model.matcher.conf["checkpointed"]
    for name, value in model.matcher.state_dict().items():
        assert torch.equal(value, before[name]), name
    extractor = _blob_state(R.SP_STAGE0B_WEIGHTS, "extractor")
    for name, value in model.extractor.state_dict().items():
        assert torch.equal(value, extractor[f"extractor.{name}"]), name

    model = build_model("two_view_pipeline", R.stage6_sp0b_conf()["model"], device="cpu")
    restore_components(model, f"{R.STAGE2_WEIGHTS},{R.SP_STAGE0B_WEIGHTS}")
    matcher = _blob_state(R.STAGE2_WEIGHTS, "matcher")
    for name, value in model.state_dict().items():
        ref = extractor[name] if name.startswith("extractor.") else matcher[name]
        assert torch.equal(value, ref), name


# benchmark recipe -> the folder of outputs/results whose conf.yaml it is
BENCHMARKS = {"hpatches_sift_superglue_conf": "hpatches/sift_sg_stage1",
              "hpatches_sift_nn_conf": "hpatches/sift_nn",
              "hpatches_sp_nn_conf": "hpatches/sp0b_nn_com",
              "hpatches_sift_nn_adalam_conf": "hpatches/sift_nn_adalam",
              "eth3d_flagship_conf": "eth3d/sp_lg2_com_refine",
              "eth3d_sp_lg_stage2_conf": "eth3d/sp_lg_stage2"}


@pytest.mark.parametrize("recipe", sorted(BENCHMARKS))
def test_benchmark_recipe_is_its_conf(recipe):
    path = ROOT_PATH / "outputs/results" / BENCHMARKS[recipe] / "conf.yaml"
    conf = getattr(R, recipe)()
    assert conf == yaml.safe_load(path.read_text())
    assert conf["checkpoint"] is None or (ROOT_PATH / conf["checkpoint"]).exists()


# the GlueStick benchmark recipes: (recipe, its arguments, its folder of outputs/results)
GLUESTICK_BENCHMARKS = [
    ("hpatches_gluestick_conf", {}, "hpatches/gluestick_stage0_com_refine"),
    ("hpatches_gluestick_famb_conf", {"refine": True}, "hpatches/gluestick_famb_com_refine"),
    ("hpatches_gluestick_famb_conf", {"refine": False}, "hpatches/gluestick_famb_com"),
    ("hpatches_extended_gluestick_conf", {}, "hpatches_extended/gluestick_stage0_hybrid"),
    ("eth3d_gluestick_conf", {}, "eth3d/gluestick_stage0"),
    ("md1500_extended_gluestick_conf", {}, "megadepth1500_extended/gluestick_pose"),
]


@pytest.mark.parametrize("recipe,kwargs,folder", GLUESTICK_BENCHMARKS,
                         ids=[f.split("/")[-1] for _, _, f in GLUESTICK_BENCHMARKS])
def test_gluestick_recipe_is_its_conf(recipe, kwargs, folder):
    path = ROOT_PATH / "outputs/results" / folder / "conf.yaml"
    conf = getattr(R, recipe)(**kwargs)
    assert conf == yaml.safe_load(path.read_text())
    assert ROOT_PATH / conf["checkpoint"] == R.GLUESTICK_WEIGHTS and R.GLUESTICK_WEIGHTS.exists()


@pytest.mark.parametrize("name", sorted(R.GATE_BOUNDS))
def test_gate_confs_build_and_load_their_blobs(name):
    """Each JAX gate's pipeline builds and takes its blob strictly (the
    blob's matcher, or its extractor, fills every parameter)."""
    from gluefactory_torch.utils.weights import load_blob_into

    conf, blob = R.gate_conf(name)
    model = build_model("two_view_pipeline", conf, device="cpu")
    load_blob_into(model, blob, {"matcher": 4})
    assert model.extractor.conf["max_num_keypoints"] in (512, 1024)
