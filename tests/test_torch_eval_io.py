"""The benchmarks' model loading (gluefactory_torch/eval/io.py) against the
JAX package's, on the CPU: a run by name (its ``checkpoint_best``), a
``.ckpt`` path and a weights blob, each giving the predictions of the model
it was written from; a matcher-only run benchmarked with its extractor's
blob; ``--conf`` as a config name or a file."""

import json
from argparse import Namespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import __graft_entry__
from gluefactory_tpu.core.config import Config
from gluefactory_tpu.datasets.homographies_ondevice import OnDeviceHomographyDataset as JEngine
from gluefactory_tpu.models import build_model as jax_build_model
from gluefactory_tpu.utils import experiments as jexp
from gluefactory_torch.eval.io import CONFIGS_DIR, load_model, parse_eval_args
from gluefactory_torch.flagship import load_weights
from gluefactory_torch.models import build_model
from gluefactory_torch.recipes import SP_STAGE0B_WEIGHTS, STAGE2_WEIGHTS, hpatches_flagship_conf
from gluefactory_torch.train import training
from gluefactory_torch.utils import experiments as texp
from gluefactory_torch.utils.weights import load_weight_blob, params_from_flat

torch.set_num_threads(2)

ENGINE = {"name": "homographies_ondevice", "pool_size": 2, "val_pool_size": 2,
          "source_size": [96, 96], "image_size": 64, "max_gt_points": 48,
          "train_batch_size": 2, "val_batch_size": 2, "steps_per_epoch": 1, "val_steps": 1,
          "seed": 1}
TINY = __graft_entry__._flagship_conf(tiny=True)


@pytest.fixture(scope="module")
def batch():
    engine = JEngine(ENGINE)
    pool = jax.tree.map(jnp.asarray, engine.build_pool("train"))
    return jax.tree.map(np.asarray, engine.make_batch(pool, jax.random.key(4)))


def _torch(tree):
    return jax.tree.map(lambda x: torch.from_numpy(np.array(x)), tree)


def _predict(model, batch) -> dict:
    with torch.inference_mode():
        return model(_torch(batch))


def _same(a: dict, b: dict):
    assert a.keys() == b.keys()
    for key in a:
        torch.testing.assert_close(a[key], b[key], rtol=0, atol=0, msg=key)


def test_a_port_run_loads_by_name_and_by_ckpt(tmp_path, monkeypatch, batch):
    """A run that the port's ``train.training`` wrote, benchmarked by its name
    under TRAINING_PATH, by its folder and by its ``.ckpt``: each gives the
    trained model's predictions; the run's model conf lies under the
    benchmark's."""
    conf = {"data": ENGINE, "model": TINY, "train": {"epochs": 1, "eval_every_iter": 100,
                                                     "lr": 1e-3, "seed": 5}}
    monkeypatch.setattr(texp, "TRAINING_PATH", tmp_path)
    trainer, history = training(conf, tmp_path / "tiny_run", device="cpu")
    assert len(history) == 1 and (tmp_path / "tiny_run" / "checkpoint_best.ckpt").exists()
    live = _predict(trainer.model.eval(), batch)
    bench_conf = {"name": "two_view_pipeline", "ground_truth": {"th_positive": 3.0}}
    for checkpoint in ("tiny_run", str(tmp_path / "tiny_run"),
                       str(tmp_path / "tiny_run" / "checkpoint_best.ckpt")):
        model = load_model(bench_conf, checkpoint, "cpu")
        # the run's conf (its 2-layer matcher) under the benchmark's
        assert model.conf["matcher"]["n_layers"] == 2
        assert model.conf["ground_truth"]["th_positive"] == 3.0
        _same(_predict(model, batch), live)


def test_a_jax_run_loads_and_predicts_as_jax(tmp_path, batch):
    """A run written by JAX's ``save_experiment`` (YAML ``config.yaml``):
    the port's ``load_model`` by its folder gives JAX's predictions."""
    jmodel = jax_build_model("two_view_pipeline", TINY)
    params = jmodel.init(jax.random.key(3), jax.tree.map(jnp.asarray, batch))
    jexp.save_experiment(tmp_path / "jax_run", {"params": jax.tree.map(np.asarray, params)},
                         Config({"model": TINY}), 0, 7,
                         eval_results={"loss/total": np.float64(1.5)})
    model = load_model({"name": "two_view_pipeline"}, str(tmp_path / "jax_run"), "cpu")
    pred = _predict(model, batch)
    jpred = jmodel.apply(params, jax.tree.map(jnp.asarray, batch))
    np.testing.assert_allclose(pred["keypoints0"].numpy(), np.asarray(jpred["keypoints0"]),
                               atol=1e-4)
    np.testing.assert_allclose(pred["matching_scores0"].numpy(),
                               np.asarray(jpred["matching_scores0"]), atol=1e-4)
    np.testing.assert_array_equal(pred["gt_matches0"].numpy(), np.asarray(jpred["gt_matches0"]))


def test_a_blob_loads_as_before():
    """A committed blob: every parameter restored, as the strict blob load."""
    conf = hpatches_flagship_conf()
    model = load_model(conf["model"], conf["checkpoint"], "cpu")
    ref = build_model("two_view_pipeline", conf["model"], device="cpu")
    load_weights(ref, STAGE2_WEIGHTS)
    for (name, value), ref_value in zip(model.state_dict().items(), ref.state_dict().values()):
        assert torch.equal(value, ref_value), name


def test_a_matcher_only_run_needs_its_extractor_blob(tmp_path):
    """A run of a matcher-only pipeline (stages 3 and 4) holds no extractor:
    benchmarked with one, it refuses to keep the extractor's initial values;
    with the extractor's blob named after it, the extractor is the blob's and
    the matcher the run's."""
    run_conf = {"name": "two_view_pipeline", "extractor": {"name": None},
                "allow_no_extract": True,
                "matcher": {"name": "matchers.lightglue", "n_layers": 1}}
    torch.manual_seed(0)
    matcher_only = build_model("two_view_pipeline", run_conf, device="cpu")
    texp.save_experiment(tmp_path / "lg_run", {"params": matcher_only}, {"model": run_conf}, 0,
                         1, eval_results={"loss/total": 1.0})
    bench = {"name": "two_view_pipeline", "allow_no_extract": False,
             "extractor": {"name": "extractors.superpoint", "max_num_keypoints": 64}}
    run = str(tmp_path / "lg_run")
    with pytest.raises(KeyError, match="extractor"):
        load_model(bench, run, "cpu")
    model = load_model(bench, f"{run},{SP_STAGE0B_WEIGHTS}", "cpu")
    flat, _, _ = load_weight_blob(SP_STAGE0B_WEIGHTS)
    extractor = params_from_flat({k: v for k, v in flat.items() if "['extractor']" in k})
    for name, value in model.state_dict().items():
        ref = (extractor[name] if name.startswith("extractor.")
               else matcher_only.state_dict()[name])
        assert torch.equal(value, ref), name


@pytest.mark.parametrize("kind", ["name", "yaml", "json"])
def test_conf_takes_a_config_name_or_file(kind, tmp_path):
    """``--conf``: a config name under gluefactory_tpu/configs, a YAML path or
    a JSON path, as the JAX package's ``parse_config_path``."""
    name = "superpoint+lightglue_adaptive"
    expected = yaml.safe_load((CONFIGS_DIR / f"{name}.yaml").read_text())
    arg = {"name": name, "yaml": str(CONFIGS_DIR / f"{name}.yaml"),
           "json": str(tmp_path / "c.json")}[kind]
    (tmp_path / "c.json").write_text(json.dumps(expected))
    conf = parse_eval_args("hpatches", Namespace(conf=arg, dotlist=["eval.seed=3"],
                                                 checkpoint="run"), {"eval": {"seed": 0}}, {})
    assert conf["model"] == expected["model"] and conf["eval"]["seed"] == 3
    assert conf["checkpoint"] == "run"
    with pytest.raises(FileNotFoundError, match="available"):
        parse_eval_args("hpatches", Namespace(conf="no_such_config"), {}, {})
