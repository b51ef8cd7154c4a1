"""Which of the JAX package's training and evaluation configs the port can
build: for each YAML of ``gluefactory_tpu/configs`` (read as files, with the
``yaml`` package), ``build_model`` of its ``model`` on the CPU and the
constructor of its ``data`` dataset (a config without ``data`` has none to
build). Building a dataset makes no pool and reads no image. Prints the
configs in three groups (both halves build, only the model, neither, each
with the first error) and a last JSON line of the counts.

    python -m gluefactory_torch.scripts.config_sweep [--configs DIR]
"""

from __future__ import annotations

import argparse
import json
import logging
from pathlib import Path

import torch

from ..datasets import get_dataset
from ..eval.io import CONFIGS_DIR
from ..models import build_model


def sweep(configs: Path) -> dict[str, list]:
    import yaml

    groups: dict[str, list] = {"both": [], "model_only": [], "neither": []}
    for path in sorted(Path(configs).glob("*.yaml")):
        conf = yaml.safe_load(path.read_text()) or {}
        try:
            model = conf.get("model", {})
            build_model(model["name"], model, device="cpu")
        except Exception as e:  # noqa: BLE001 - the sweep records what fails
            groups["neither"].append((path.name, f"model: {type(e).__name__}: {e}"[:160]))
            continue
        try:
            if "data" in conf:
                get_dataset(conf["data"]["name"])(conf["data"])
        except Exception as e:  # noqa: BLE001
            groups["model_only"].append((path.name, f"data: {type(e).__name__}: {e}"[:160]))
            continue
        groups["both"].append((path.name, ""))
    return groups


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--configs", default=str(CONFIGS_DIR))
    args = parser.parse_args(argv)
    logging.disable(logging.WARNING)
    torch.set_num_threads(2)
    groups = sweep(Path(args.configs))
    for name, items in groups.items():
        print(f"{name}: {len(items)}")
        for config, error in items:
            print(f"  {config}  {error}")
    print(json.dumps({name: len(items) for name, items in groups.items()}))


if __name__ == "__main__":
    main()
