"""Device choice for the port's entry points: CUDA unless the caller asks
for another device. There is no silent fallback to the CPU."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "gluefactory_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch versions on the CPU")
    return device


def describe_device(device: torch.device) -> dict:
    """``{"name", "power_limit"}`` of a CUDA device as ``nvidia-smi`` reports
    them (the limit bounds the clocks under load, so a time goes with it);
    the CPU's name otherwise."""
    import platform
    import subprocess

    if device.type != "cuda":
        return {"name": platform.processor() or platform.machine(), "power_limit": None}
    index = device.index if device.index is not None else torch.cuda.current_device()
    smi = subprocess.run(["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=10, check=True).stdout.strip()
    name, limit = (field.strip() for field in smi.split(",", 1))
    return {"name": name, "power_limit": limit}
