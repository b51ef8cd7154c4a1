"""Checkpoints of training runs (gluefactory_tpu/utils/experiments.py), in
the JAX package's format, so that each package restores the other's.

A checkpoint ``checkpoint_<epoch>_<iteration>[_interrupted].ckpt`` is a flax
msgpack map {state: {params, opt_state}, epoch, iteration, losses, eval}.
``state.params`` holds the model's parameters under their flat flax keys
(``"['params']['matcher']['input_proj']['kernel']"``) in flax's layouts, and
``state.opt_state`` the optimizer's state under the keys that the JAX
package's ``state_to_flat_dict(opt_state)`` gives for the same training conf
(``train.Optimizer.flat_state``). ``config.yaml`` beside it holds the conf
as JSON, which is also YAML: the JAX package's ``Config.load`` reads it, and
the port reads it without a YAML library. The best checkpoint by
``train.best_key`` (``best_mode`` min or max) is copied to
``checkpoint_best.ckpt``; the last ``keep_last`` others are kept."""

from __future__ import annotations

import json
import logging
import re
import shutil
from pathlib import Path

import torch

from ..core.config import load_conf, lookup
from ..models.matchers.lightglue import head_counts
from ..settings import ROOT_PATH, TRAINING_PATH
from .weights import (
    decode_msgpack,
    encode_msgpack,
    flat_from_params,
    flax_key,
    load_weight_blob,
    params_from_flat,
)

logger = logging.getLogger(__name__)


def state_to_flat_dict(state) -> dict:
    """A model's parameters (every one, frozen ones included) under their
    flax keys, or a ``train.Optimizer``'s state under optax's keys; numpy
    arrays."""
    if isinstance(state, torch.nn.Module):
        return flat_from_params(state.state_dict(), head_counts(state))
    return state.flat_state()


def _adapt_nesting(flat: dict, target_keys: set) -> dict:
    """``flat`` with the ``['extractor']``/``['matcher']`` scope inserted or
    stripped when none of its keys fits and one of those changes does (a
    standalone model's checkpoint loaded into a pipeline, or the reverse)."""
    if not flat or target_keys & set(flat):
        return flat
    candidates = [{k.replace("['params']", f"['params']['{scope}']", 1): v
                   for k, v in flat.items()} for scope in ("extractor", "matcher")]
    candidates += [{k.replace(f"['params']['{scope}']", "['params']", 1): v
                    for k, v in flat.items()} for scope in ("extractor", "matcher")]
    best = max(candidates, key=lambda c: len(target_keys & set(c)))
    if target_keys & set(best):
        logger.info("Adapted checkpoint nesting level: %d/%d keys now match",
                    len(target_keys & set(best)), len(best))
        return best
    return flat


def restore_from_flat_dict(target, flat: dict, warn: bool = True) -> list[str]:
    """Load a flat checkpoint dict into ``target`` in place: a model (the
    inverse of ``state_to_flat_dict``; a parameter the checkpoint lacks keeps
    its value, with a warning where ``warn``, and keys the model lacks are
    ignored, as in JAX; a shape that differs raises), or a
    ``train.Optimizer`` (its
    ``load_flat_state``). Returns the flax keys of the model that the
    checkpoint lacks, for callers that refuse to keep initialised values
    (``require_restored``)."""
    if not isinstance(target, torch.nn.Module):
        target.load_flat_state(flat)
        return []
    own = target.state_dict()
    keys = {flax_key(name): name for name in own}
    flat = _adapt_nesting(flat, set(keys))
    missing = [key for key in keys if key not in flat]
    for key in missing if warn else ():
        logger.warning("Checkpoint missing %s; keeping initialized value", key)
    state = params_from_flat({k: v for k, v in flat.items() if k in keys},
                             head_counts(target))
    with torch.no_grad():
        for name, value in state.items():
            if tuple(value.shape) != tuple(own[name].shape):
                raise ValueError(f"{name}: checkpoint shape {tuple(value.shape)}, model "
                                 f"shape {tuple(own[name].shape)}")
            own[name].copy_(value.to(own[name].dtype))
    return missing


def checkpoint_sources(checkpoint) -> list[str]:
    """The sources of a ``checkpoint`` or ``load_experiment`` value: one
    string (several separated by commas) or a list of them."""
    if isinstance(checkpoint, (list, tuple)):
        return [str(c) for c in checkpoint]
    return [c for c in str(checkpoint).split(",") if c]


def _scope(key: str) -> str:
    """The component of a flax key: 'matcher' for ``['params']['matcher'][...]``."""
    parts = key.split("]")
    return parts[1].strip("[']") if len(parts) > 2 else ""


def restore_components(model: torch.nn.Module, sources) -> None:
    """Restore ``model`` from ``sources`` in order (each read by
    ``load_experiment``, a later one overriding the keys it holds), whole
    components at a time: each component of the model (``extractor``,
    ``matcher``, ...) that a source holds is restored from it entirely; a
    source that holds a component in part (a key missing, or a key the
    model's component lacks, such as a layer past ``n_layers``) raises, as
    does a shape that differs; keys of components the model lacks (a full
    pipeline's ``['extractor']`` half for a matcher-only model) are dropped.
    A component that no source holds keeps its initialisation, logged by
    name."""
    own = {flax_key(name) for name in model.state_dict()}
    have = {_scope(k) for k in own}
    missing = set(own)
    for source in checkpoint_sources(sources):
        flat = _adapt_nesting(load_experiment(source, best=False)[0]["state"]["params"], own)
        held = {_scope(k) for k in flat} & have
        part = sorted(k for k in own if _scope(k) in held and k not in flat)
        extra = sorted(k for k in flat if k not in own and _scope(k) in held)
        if part or extra:
            raise KeyError(f"{source} holds {sorted(held)} in part: missing {part[:3]} "
                           f"({len(part)}), not in the model {extra[:3]} ({len(extra)})")
        restore_from_flat_dict(model, {k: v for k, v in flat.items() if k in own}, warn=False)
        missing -= set(flat)
    for scope in sorted({_scope(k) for k in missing}):
        logger.warning("no source holds the %s: it keeps its initialisation", scope)


def require_restored(missing: list[str], sources) -> None:
    """Raise where a model kept initialised parameters after its restore:
    ``missing`` are the flax keys that none of ``sources`` held."""
    if missing:
        scopes = sorted({_scope(key) for key in missing})
        raise KeyError(f"{len(missing)} parameters of the model (under {scopes}, e.g. "
                       f"{missing[0]}) are in none of {list(sources)}: name a checkpoint or "
                       "weights blob that holds them")


def list_checkpoints(dir_: Path) -> list[Path]:
    """The checkpoints of a run folder, ordered by (epoch, iteration)."""
    checkpoints = []
    for p in Path(dir_).glob("checkpoint_*.ckpt"):
        numbers = re.findall(r"(\d+)", p.name)
        if not numbers:
            continue
        checkpoints.append((int(numbers[0]), int(numbers[1]) if len(numbers) > 1 else 0, p))
    return [p for _, _, p in sorted(checkpoints)]


def get_last_checkpoint(exp: str, allow_interrupted: bool = True) -> Path:
    """The last checkpoint of experiment ``exp`` (a name under TRAINING_PATH,
    or a folder's absolute path)."""
    ckpts = list_checkpoints(TRAINING_PATH / exp)
    if not allow_interrupted:
        ckpts = [p for p in ckpts if "_interrupted" not in p.name]
    if not ckpts:
        raise FileNotFoundError(f"No checkpoints in {TRAINING_PATH / exp}")
    return ckpts[-1]


def get_best_checkpoint(exp: str) -> Path:
    return TRAINING_PATH / exp / "checkpoint_best.ckpt"


def delete_old_checkpoints(dir_: Path, num_keep: int) -> None:
    """Keep the last ``num_keep`` checkpoints that are neither best nor
    interrupted."""
    ckpts = [p for p in list_checkpoints(dir_)
             if "_interrupted" not in p.name and "best" not in p.name]
    for p in ckpts[: max(0, len(ckpts) - num_keep)]:
        logger.info("Deleting checkpoint %s", p.name)
        p.unlink()


def save_conf(output_dir: Path, conf: dict) -> None:
    """``config.yaml`` as JSON text (JSON is YAML)."""
    (Path(output_dir) / "config.yaml").write_text(json.dumps(conf, indent=2) + "\n")


def save_experiment(output_dir: Path, state: dict, conf: dict, epoch: int, iteration: int,
                    losses: dict | None = None, eval_results: dict | None = None,
                    best_eval: float | None = None, cp_name: str | None = None,
                    keep_last: int = 5) -> float | None:
    """Write a checkpoint of ``state`` (a dict of models and optimizers, each
    flattened by ``state_to_flat_dict``), copy it to ``checkpoint_best.ckpt``
    when ``eval_results[train.best_key]`` beats ``best_eval`` (lower with
    ``best_mode: min``, higher with ``max``), keep the last ``keep_last``
    others. Returns the best value so far."""
    best_key = lookup(conf, "train.best_key", None) or "loss/total"
    mode = lookup(conf, "train.best_mode", None) or "min"
    cur = (eval_results or {}).get(best_key)

    def improved(c, b):
        return c is not None and (b is None or (c > b if mode == "max" else c < b))

    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    if cp_name is None:
        cp_name = f"checkpoint_{epoch}_{iteration}.ckpt"
    blob = {
        "state": {k: state_to_flat_dict(v) for k, v in state.items()},
        "epoch": epoch,
        "iteration": iteration,
        "losses": losses or {},
        "eval": eval_results or {},
    }
    path = output_dir / cp_name
    path.write_bytes(encode_msgpack(blob))
    save_conf(output_dir, conf)
    if improved(cur, best_eval):
        best_eval = float(cur)
        shutil.copy(path, output_dir / "checkpoint_best.ckpt")
        logger.info("New best checkpoint: %s=%.5f", best_key, best_eval)
    delete_old_checkpoints(output_dir, keep_last)
    return best_eval


def load_experiment(exp_or_path: str | Path, best: bool = False) -> tuple[dict, dict]:
    """(checkpoint blob, conf) by experiment name (under TRAINING_PATH, or a
    folder's absolute path: its best or last checkpoint), ``.ckpt`` path, or
    committed weight blob (``weights/*.msgpack``: its params under
    ``state.params``, its model conf under ``model``). A relative file path
    that is not there from the working directory is taken from the
    repository's root."""
    path = Path(exp_or_path)
    if path.suffix in (".msgpack", ".ckpt") and not path.exists() and not path.is_absolute():
        path = ROOT_PATH / path  # a committed blob named from the repository's root
    if path.suffix == ".msgpack":
        flat, model_conf, meta = load_weight_blob(path)
        return {"state": {"params": flat}, **meta}, ({"model": model_conf} if model_conf else {})
    if path.suffix != ".ckpt":
        path = (get_best_checkpoint(str(exp_or_path)) if best
                else get_last_checkpoint(str(exp_or_path)))
    blob = decode_msgpack(path.read_bytes())
    conf_path = path.parent / "config.yaml"
    return blob, (load_conf(conf_path) if conf_path.exists() else {})
