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
