"""Conf resolution and model loading of the benchmarks (gluefactory_tpu/eval/io.py).

A conf is the benchmark's defaults, then a named conf (a JSON file, or the
flagship's recipe when none is given), then ``dot.key=value`` overrides, then
``--checkpoint``. YAML confs are not read here: the GPU machine has no YAML
library."""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

from ..core.config import dotlist_to_dict, merge
from ..models import build_model
from ..models.matchers.lightglue import head_counts
from ..settings import ROOT_PATH
from ..utils.weights import load_state_strict, load_weight_blob, params_from_flat


def parse_eval_args(benchmark: str, args, default_conf: dict, named_conf: dict) -> dict:
    """Defaults < named conf (``args.conf``, a JSON file, else ``named_conf``;
    a section named after the benchmark is merged over the rest) < dotlist <
    ``args.checkpoint``."""
    named = (json.loads(Path(args.conf).read_text()) if getattr(args, "conf", None)
             else named_conf)
    named = merge(named, named.get(benchmark))
    conf = merge(default_conf, named)
    conf = merge(conf, dotlist_to_dict(getattr(args, "dotlist", None) or []))
    if getattr(args, "checkpoint", None):
        conf["checkpoint"] = args.checkpoint
    return conf


def resolve_checkpoint(checkpoint: str | Path) -> Path:
    """A weights blob: the path as given, else relative to the repository."""
    path = Path(checkpoint)
    if not path.exists() and not path.is_absolute():
        path = ROOT_PATH / path
    if not path.exists():
        raise FileNotFoundError(f"no weights blob at {checkpoint}")
    return path


def load_model(model_conf: dict, checkpoint: str | Path | None,
               device: str | torch.device = "cuda") -> torch.nn.Module:
    """The model of ``model_conf`` on ``device``. With a checkpoint (a
    ``weights/*.msgpack`` blob), the blob's model conf lies under
    ``model_conf`` and its weights are loaded strictly."""
    if not checkpoint:
        return build_model(model_conf["name"], model_conf, device=device)
    flat, ckpt_conf, _ = load_weight_blob(resolve_checkpoint(checkpoint))
    model_conf = merge(ckpt_conf or {}, model_conf)
    model = build_model(model_conf["name"], model_conf, device=device)
    heads = head_counts(model)
    load_state_strict(model, params_from_flat(flat, heads))
    return model


def get_eval_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--tag", type=str, default="default")
    parser.add_argument("--conf", type=str, default=None, help="a JSON conf file")
    parser.add_argument("--checkpoint", type=str, default=None)
    parser.add_argument("--overwrite", action="store_true")
    parser.add_argument("--overwrite_eval", action="store_true")
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("dotlist", nargs="*")
    return parser
