"""Checkpoints and the training loop of the port (utils/experiments.py,
train.training) against the JAX package, on the CPU, at tiny sizes.

A checkpoint written by the port is read by JAX's ``load_experiment`` and
restored into JAX's own parameter and optax state templates with no key
missing or left over; a checkpoint written by JAX's ``save_experiment`` is
restored by the port; the msgpack encoder writes flax's bytes. Then the
loop: the end-of-epoch benchmark on a model overlay, ``checkpoint_best`` by
``best_mode``, keep-last and ``--restore``."""

import json
import os
import signal
from argparse import Namespace
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.serialization import msgpack_restore, msgpack_serialize

import __graft_entry__
from gluefactory_tpu.core.config import Config
from gluefactory_tpu.datasets.homographies_ondevice import OnDeviceHomographyDataset as JEngine
from gluefactory_tpu.models import build_model as jax_build_model
from gluefactory_tpu.train import default_train_conf as jax_train_conf
from gluefactory_tpu.train import make_optimizer as jax_make_optimizer
from gluefactory_tpu.utils import experiments as jexp
from gluefactory_torch import train as T
from gluefactory_torch.models import build_model
from gluefactory_torch.scripts.generate_eval_set import generate
from gluefactory_torch.utils import experiments as texp
from gluefactory_torch.utils.weights import (
    decode_msgpack,
    encode_msgpack,
    load_state_strict,
    params_from_flat,
)

torch.set_num_threads(2)

ENGINE_CONF = {"pool_size": 2, "source_size": [96, 96], "image_size": 64, "max_gt_points": 48,
               "train_batch_size": 2, "seed": 1}
# optimizers whose optax states differ in layout: multi_transform around a
# frozen extractor, clip on or off, an lr_scaling entry, adamw's extra state
OPTIMIZERS = {
    "adam_frozen_scaled": ({"optimizer": "adam", "clip_grad": 1.0,
                            "lr_scaling": [[0.1, ["log_assignment"]], [2.0, ["no_such"]]]},
                           False),
    "adamw_all_trainable": ({"optimizer": "adamw", "clip_grad": 0.0}, True),
}


@pytest.fixture(scope="module")
def jax_side():
    engine = JEngine(ENGINE_CONF)
    pool = jax.tree.map(jnp.asarray, engine.build_pool("train"))
    batch = jax.tree.map(np.asarray, engine.make_batch(pool, jax.random.key(4)))
    conf = __graft_entry__._flagship_conf(tiny=True)
    model = jax_build_model("two_view_pipeline", conf)
    params = jax.jit(partial(model.init, method=model.forward_and_loss))(
        jax.random.key(0), jax.tree.map(jnp.asarray, batch))
    return conf, batch, params


def _confs(conf, case):
    train_conf, trainable = OPTIMIZERS[case]
    train_conf = {**train_conf, "lr": 1e-3, "lr_schedule": {"type": "exp", "start": 0,
                                                             "exp_div_10": 10}}
    model_conf = {**conf, "extractor": {**conf["extractor"], "trainable": trainable}}
    return train_conf, model_conf


def _port_model(model_conf, params):
    model = build_model("two_view_pipeline", model_conf, device="cpu", train=True)
    load_state_strict(model, params_from_flat(jexp.state_to_flat_dict(params), {"matcher": 2}))
    return model


def test_encoder_writes_flax_bytes():
    """A checkpoint-like tree (float and int arrays, 0-d arrays, numpy and
    Python scalars, strings, nesting) encodes to flax's bytes and reads back
    through both decoders."""
    rng = np.random.default_rng(0)
    tree = {"state": {"params": {"['params']['a']['kernel']": rng.normal(size=(3, 70))
                                 .astype(np.float32)},
                      "opt_state": {"[1][0].count": np.asarray(7, np.int32),
                                    "[2].hyperparams['lr_scale']": np.asarray(0.5, np.float32)}},
            "epoch": 3, "iteration": -1, "losses": {}, "name": "x" * 40,
            "eval": {"loss/total": 0.25, "bench/h/mAA": np.float64(91.5), "n": 70000,
                     "flag": True, "none": None, "list": [1, 2.5, "s"]},
            "big": rng.integers(0, 255, 70000).astype(np.uint8)}
    data = encode_msgpack(tree)
    assert data == msgpack_serialize(tree)
    for restored in (msgpack_restore(data), decode_msgpack(data)):
        assert restored["eval"]["bench/h/mAA"] == 91.5 and restored["eval"]["n"] == 70000
        assert restored["eval"]["list"] == [1, 2.5, "s"] and restored["iteration"] == -1
        count = restored["state"]["opt_state"]["[1][0].count"]
        assert count.shape == () and count.dtype == np.int32 and int(count) == 7
        np.testing.assert_array_equal(restored["big"], tree["big"])
        np.testing.assert_array_equal(restored["state"]["params"]["['params']['a']['kernel']"],
                                      tree["state"]["params"]["['params']['a']['kernel']"])


@pytest.mark.parametrize("case", list(OPTIMIZERS))
def test_port_checkpoint_restores_in_jax(jax_side, case, tmp_path):
    """Two port steps, then ``save_experiment``: JAX's ``load_experiment``
    reads the file and its ``config.yaml``; the parameters and the optimizer
    state have exactly the keys of JAX's templates for the same conf, and
    ``restore_from_flat_dict`` gives back the port's values."""
    conf, batch, params = jax_side
    train_conf, model_conf = _confs(conf, case)
    model = _port_model(model_conf, params)
    optimizer = T.make_optimizer({**T.default_train_conf, **train_conf}, model, model_conf)
    optimizer.lr_scale = 0.25  # a plateau-scaled run
    data = jax.tree.map(lambda x: torch.from_numpy(np.array(x)), batch)
    for _ in range(2):
        assert T.train_step(model, optimizer, data)["skipped"] == 0.0
    full_conf = {"model": model_conf, "train": {**T.default_train_conf, **train_conf}}
    texp.save_experiment(tmp_path, {"params": model, "opt_state": optimizer}, full_conf,
                         epoch=1, iteration=2, eval_results={"loss/total": 1.5})
    path = tmp_path / "checkpoint_1_2.ckpt"
    blob, jconf = jexp.load_experiment(path)
    assert jconf.train.best_mode == "min" and jconf.model.matcher.n_layers == 2
    assert (blob["epoch"], blob["iteration"], blob["eval"]) == (1, 2, {"loss/total": 1.5})

    tx, _ = jax_make_optimizer(Config(jax_train_conf).merge(train_conf), params,
                               Config(model_conf))
    opt_template = tx.init(params)
    for name, template, flat in (("params", params, blob["state"]["params"]),
                                 ("opt_state", opt_template, blob["state"]["opt_state"])):
        template_flat = jexp.state_to_flat_dict(template)
        assert set(flat) == set(template_flat), (name, set(template_flat) ^ set(flat))
        restored = jexp.state_to_flat_dict(jexp.restore_from_flat_dict(template, flat))
        for key, value in restored.items():
            assert value.dtype == template_flat[key].dtype, key
            np.testing.assert_array_equal(value, flat[key], err_msg=key)
    ours = texp.state_to_flat_dict(optimizer)
    counts = [k for k in ours if k.endswith(".count")]
    assert len(counts) == 3 and all(int(ours[k]) == 2 for k in counts)
    np.testing.assert_array_equal(
        jexp.state_to_flat_dict(jexp.restore_from_flat_dict(params, blob["state"]["params"]))
        ["['params']['matcher']['input_proj']['kernel']"],
        model.matcher.input_proj.weight.detach().numpy().T)


@pytest.mark.parametrize("case", list(OPTIMIZERS))
def test_jax_checkpoint_restores_in_the_port(jax_side, case, tmp_path):
    """Two optax steps on random gradients, JAX's ``save_experiment``: the
    port's ``load_experiment`` reads it (its YAML conf too) and restores the
    parameters and the Adam state; its next update equals optax's."""
    conf, _, params = jax_side
    train_conf, model_conf = _confs(conf, case)
    tx, _ = jax_make_optimizer(Config(jax_train_conf).merge(train_conf), params,
                               Config(model_conf))
    opt_state = tx.init(params)
    rng = np.random.default_rng(3)

    def random_grads():
        return jax.tree.map(lambda x: jnp.asarray(rng.normal(size=x.shape), x.dtype) * 1e-2,
                            params)

    for _ in range(2):
        updates, opt_state = tx.update(random_grads(), opt_state, params)
        params = optax.apply_updates(params, updates)
    jconf = Config({"model": model_conf, "train": {**jax_train_conf, **train_conf}})
    jexp.save_experiment(tmp_path, {"params": jax.tree.map(np.asarray, params),
                                    "opt_state": jax.tree.map(np.asarray, opt_state)},
                         jconf, 4, 9, eval_results={"loss/total": np.float64(2.5)})
    blob, tconf = texp.load_experiment(tmp_path / "checkpoint_4_9.ckpt")
    assert tconf["model"]["matcher"]["n_layers"] == 2 and blob["iteration"] == 9
    assert blob["eval"]["loss/total"] == 2.5

    model = build_model("two_view_pipeline", model_conf, device="cpu", train=True)
    texp.restore_from_flat_dict(model, blob["state"]["params"])
    optimizer = T.make_optimizer({**T.default_train_conf, **train_conf}, model, model_conf)
    texp.restore_from_flat_dict(optimizer, blob["state"]["opt_state"])
    assert optimizer.count == 2
    expected = params_from_flat(jexp.state_to_flat_dict(params), {"matcher": 2})
    for name, value in model.state_dict().items():
        assert torch.equal(value, expected[name]), name
    # the next update from the restored state, on the same gradient
    grads = random_grads()
    updates, _ = tx.update(grads, opt_state, params)
    after = params_from_flat(jexp.state_to_flat_dict(optax.apply_updates(params, updates)),
                             {"matcher": 2})
    tgrads = params_from_flat(jexp.state_to_flat_dict(grads), {"matcher": 2})
    for name, p in model.named_parameters():
        p.grad = tgrads[name].clone()
    optimizer.step()
    for name, value in model.state_dict().items():
        torch.testing.assert_close(value, after[name], rtol=0, atol=2e-7, msg=name)


def test_a_blob_and_a_run_nested_one_level_off_restore(jax_side):
    """``load_experiment`` of a committed blob gives its params and model conf;
    a checkpoint of a standalone LightGlue restores into a pipeline's matcher
    (the ``['matcher']`` scope inserted, as JAX does)."""
    conf, _, params = jax_side
    blob, bconf = texp.load_experiment("weights/lg5_init_spsoft.f16.msgpack")
    assert len(blob["state"]["params"]) == 193 and bconf["model"]["matcher"]["n_layers"] == 6
    matcher_flat = {k.replace("['params']['matcher']", "['params']", 1): v
                    for k, v in jexp.state_to_flat_dict(params).items() if "['matcher']" in k}
    model = build_model("two_view_pipeline", conf, device="cpu")
    texp.restore_from_flat_dict(model, matcher_flat)
    expected = params_from_flat(jexp.state_to_flat_dict(params), {"matcher": 2})
    for name, value in model.matcher.state_dict().items():
        assert torch.equal(value, expected[f"matcher.{name}"]), name


# --- the training loop -----------------------------------------------------------

SCRIPTED_MAA = [10.0, 30.0, 20.0, 25.0]  # bench mAA by epoch, to pick checkpoint_best


@pytest.fixture(scope="module")
def bench_set(tmp_path_factory):
    root = tmp_path_factory.mktemp("hp")
    generate(root, 1, (128, 96), 0, family="a")
    return root


def _loop_conf(bench_set, epochs, best_mode):
    tiny = __graft_entry__._flagship_conf(tiny=True)
    return {
        "data": {"name": "homographies_ondevice", **ENGINE_CONF, "val_pool_size": 2,
                 "val_batch_size": 2, "steps_per_epoch": 2, "val_steps": 1},
        "model": {**tiny, "matcher": {**tiny["matcher"], "dtype": "bf16"}},
        "train": {"epochs": epochs, "lr": 1e-3, "eval_every_iter": 3, "log_every_iter": 1,
                  "keep_last_checkpoints": 1, "best_key": "bench/hpatches/H_error_ransac_mAA",
                  "best_mode": best_mode, "run_benchmarks": [{
                      "name": "hpatches",
                      "conf": {"data": {"data_dir": str(bench_set),
                                        "preprocessing": {"resize": 128}},
                               "eval": {"num_hypotheses": 64}},
                      "model": {"extractor": {"max_num_keypoints": 40},
                                "ground_truth": {"name": None}, "run_gt_in_forward": False}}]},
    }


@pytest.fixture
def scripted_bench(monkeypatch):
    """The real benchmark, its mAA replaced by SCRIPTED_MAA[epoch]."""
    real = T.run_benchmark

    def run(name, conf, exp_dir, **kwargs):
        summaries, results = real(name, conf, exp_dir, **kwargs)
        epoch = int(str(exp_dir).rsplit("e", 1)[1])
        return {**summaries, "H_error_ransac_mAA": SCRIPTED_MAA[epoch]}, results

    monkeypatch.setattr(T, "run_benchmark", run)


def _records(path):
    return [json.loads(line) for line in (path / "metrics.jsonl").read_text().splitlines()]


@pytest.mark.parametrize("best_mode,best_epoch", [("max", 1), ("min", 0)])
def test_training_benchmarks_pick_the_best_and_resume(bench_set, scripted_bench, tmp_path,
                                                      best_mode, best_epoch):
    """Three epochs of two steps: train, val (with match_AP) and bench keys in
    metrics.jsonl; the overlay's 40 keypoints in the benchmark (training
    uses 32); checkpoint_best at the epoch that best_mode picks; one other
    checkpoint kept. Then --restore with a fourth epoch continues from the
    last checkpoint: its steps equal an uninterrupted 4-epoch run's."""
    out = tmp_path / "run"
    trainer, history = T.training(_loop_conf(bench_set, 3, best_mode), out, device="cpu")
    assert len(history) == 6 and all(h["skipped"] == 0.0 for h in history)
    records = _records(out)
    keys = set().union(*records)
    assert {"loss/total", "grad_norm", "lr", "val/loss/total", "val/match_AP",
            "bench/hpatches/H_error_ransac_mAA", "bench/hpatches/mnum_matches",
            "bench/hpatches/seconds"} <= keys
    assert [r["step"] for r in records if "loss/total" in r] == list(range(1, 7))
    kps = [r["bench/hpatches/mnum_keypoints"] for r in records
           if "bench/hpatches/mnum_keypoints" in r]
    assert kps == [40.0] * 3
    assert trainer.bench_models["hpatches"].extractor.conf["max_num_keypoints"] == 40
    names = sorted(p.name for p in out.glob("*.ckpt"))
    assert names == ["checkpoint_2_6.ckpt", "checkpoint_best.ckpt"]
    best = decode_msgpack((out / "checkpoint_best.ckpt").read_bytes())
    assert best["epoch"] == best_epoch
    assert best["eval"]["bench/hpatches/H_error_ransac_mAA"] == SCRIPTED_MAA[best_epoch]
    assert "match_AP" in best["eval"]
    assert json.loads((out / "config.yaml").read_text())["train"]["best_mode"] == best_mode

    restored, resumed = T.training(_loop_conf(bench_set, 4, best_mode), out,
                                   Namespace(restore=True), device="cpu")
    assert len(resumed) == 2 and restored.optimizer.count == 8
    assert [r["step"] for r in _records(out) if "loss/total" in r][-2:] == [7, 8]
    _, straight = T.training(_loop_conf(bench_set, 4, best_mode), tmp_path / "straight",
                             device="cpu")
    for a, b in zip(resumed, straight[-2:]):
        assert a["loss/total"] == pytest.approx(b["loss/total"], rel=1e-6)


def test_train_cli_reads_json_and_the_dotlist(tmp_path, monkeypatch, bench_set):
    """``python -m gluefactory_torch.train <experiment> --conf c.json
    dot.key=value``: JSON read without yaml, the run under TRAINING_PATH. The
    benchmark's data is not there: it is skipped, as in JAX."""
    conf = _loop_conf(bench_set, 1, "max")
    conf["train"]["run_benchmarks"][0]["conf"]["data"]["data_dir"] = str(tmp_path / "absent")
    (tmp_path / "c.json").write_text(json.dumps(conf))
    monkeypatch.setattr(T, "TRAINING_PATH", tmp_path / "training")
    T.main(["exp", "--conf", str(tmp_path / "c.json"), "--device", "cpu",
            "train.epochs=2", "train.lr=0.002", "data.steps_per_epoch=1"])
    run = tmp_path / "training" / "exp"
    saved = json.loads((run / "config.yaml").read_text())
    assert saved["train"]["epochs"] == 2 and saved["train"]["lr"] == 0.002
    # keep_last_checkpoints 1; best_key is the bench's, which this run has not
    assert sorted(p.name for p in run.glob("*.ckpt")) == ["checkpoint_1_2.ckpt"]
    assert not any(k.startswith("bench/") for r in _records(run) for k in r)


def test_sigint_stops_after_the_step_with_an_interrupted_checkpoint(tmp_path, bench_set):
    """A SIGINT during step 1 ends the run after it, with an evaluation and a
    ``_interrupted`` checkpoint that --restore would take."""
    def interrupt(record):
        if record["step"] == 1:
            os.kill(os.getpid(), signal.SIGINT)

    handler = signal.getsignal(signal.SIGINT)
    _, history = T.training(_loop_conf(bench_set, 3, "max"), tmp_path, device="cpu",
                            log=interrupt)
    assert signal.getsignal(signal.SIGINT) is handler and len(history) == 1
    assert [p.name for p in tmp_path.glob("*.ckpt")] == ["checkpoint_0_1_interrupted.ckpt"]
    assert "val/loss/total" in _records(tmp_path)[-1]
    assert texp.get_last_checkpoint(str(tmp_path)).name == "checkpoint_0_1_interrupted.ckpt"
