"""Conf resolution and model loading of the benchmarks (gluefactory_tpu/eval/io.py).

A conf is the benchmark's defaults, then a named conf (``--conf``: a config
name under ``gluefactory_tpu/configs``, a YAML or a JSON file; the flagship's
recipe when none is given), then ``dot.key=value`` overrides, then
``--checkpoint``. A JSON file is read with the standard library, YAML where
the ``yaml`` package is installed (the GPU machine has none)."""

from __future__ import annotations

import argparse
import copy
from pathlib import Path

import torch

from ..core.config import dotlist_to_dict, load_conf, merge
from ..models import build_model
from ..recipes import ALIKED_CONFS
from ..settings import ROOT_PATH
from ..utils.experiments import (
    checkpoint_sources,
    load_experiment,
    require_restored,
    restore_from_flat_dict,
)

# the JAX package's configs, read as files (nothing of that package is imported)
CONFIGS_DIR = ROOT_PATH / "gluefactory_tpu" / "configs"


def parse_config_path(name_or_path: str) -> Path:
    """A conf file: the path as given, else ``<name>.yaml`` under CONFIGS_DIR."""
    path = Path(name_or_path)
    if path.exists():
        return path
    named = CONFIGS_DIR / f"{name_or_path}.yaml"
    if named.exists():
        return named
    raise FileNotFoundError(f"Config {name_or_path} not found; available: "
                            f"{sorted(c.stem for c in CONFIGS_DIR.glob('*.yaml'))}")


def read_named_conf(name_or_path: str) -> dict:
    """The conf ``--conf`` names: a model card of ``recipes.ALIKED_CONFS`` by
    its YAML's name (read without the ``yaml`` package), else the file of
    ``parse_config_path``."""
    if name_or_path in ALIKED_CONFS:
        return copy.deepcopy(ALIKED_CONFS[name_or_path])
    return load_conf(parse_config_path(name_or_path))


def parse_eval_args(benchmark: str, args, default_conf: dict, named_conf: dict) -> dict:
    """Defaults < named conf (``args.conf`` through ``read_named_conf``,
    else ``named_conf``; a section named after the benchmark is merged over
    the rest) < dotlist < ``args.checkpoint``."""
    named = read_named_conf(args.conf) if getattr(args, "conf", None) else named_conf
    named = merge(named, named.get(benchmark))
    conf = merge(default_conf, named)
    conf = merge(conf, dotlist_to_dict(getattr(args, "dotlist", None) or []))
    if getattr(args, "checkpoint", None):
        conf["checkpoint"] = args.checkpoint
    return conf


def load_model(model_conf: dict, checkpoint, device: str | torch.device = "cuda"
               ) -> torch.nn.Module:
    """The model of ``model_conf`` on ``device``, restored from
    ``checkpoint`` when one is given, as the JAX package's ``load_model`` and
    ``restore_params`` do. A source is a run (its name under TRAINING_PATH or
    its folder: ``checkpoint_best.ckpt``), a ``.ckpt`` file or a
    ``weights/*.msgpack`` blob, each read by ``load_experiment(best=True)``;
    the first source's model conf (a run's ``config.yaml``, a blob's
    ``model_conf``) lies under ``model_conf``. The sources are restored in
    order by flax key (``restore_from_flat_dict``: the
    ``['extractor']``/``['matcher']`` nesting adapts, keys the model lacks are
    ignored, a shape that differs raises), so a matcher-only run (stages 3
    and 4 train with ``extractor: {name: null}``) is benchmarked with an
    extractor by naming the extractor's blob after it:
    ``[run, "weights/sp_tpu_stage0b.f16.msgpack"]`` or ``"run,weights/..."``.
    A parameter that no source holds raises: where JAX keeps its random
    initial value with a warning, the port refuses to."""
    if not checkpoint:
        return build_model(model_conf["name"], model_conf, device=device)
    sources = checkpoint_sources(checkpoint)
    blobs = [load_experiment(source, best=True) for source in sources]
    model_conf = merge(blobs[0][1].get("model", {}), model_conf)
    model = build_model(model_conf["name"], model_conf, device=device)
    missing = None
    for blob, _ in blobs:
        left = restore_from_flat_dict(model, blob["state"]["params"], warn=False)
        missing = left if missing is None else [k for k in missing if k in left]
    require_restored(missing, sources)
    return model


def get_eval_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--tag", type=str, default="default")
    parser.add_argument("--conf", type=str, default=None,
                        help="a config name under gluefactory_tpu/configs, or a .yaml/.json file")
    parser.add_argument("--checkpoint", type=str, default=None,
                        help="a run, a .ckpt or a weights blob; several separated by commas")
    parser.add_argument("--overwrite", action="store_true")
    parser.add_argument("--overwrite_eval", action="store_true")
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("dotlist", nargs="*")
    return parser
