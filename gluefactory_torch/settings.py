"""Repo-relative paths (gluefactory_tpu/settings.py)."""

from pathlib import Path

ROOT_PATH = Path(__file__).resolve().parent.parent
WEIGHTS_PATH = ROOT_PATH / "weights"
DATA_PATH = ROOT_PATH / "data"
EVAL_PATH = ROOT_PATH / "outputs" / "results"
TRAINING_PATH = ROOT_PATH / "outputs" / "training"  # one folder per experiment
