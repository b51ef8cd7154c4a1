"""Where the device time of a training step goes: ``torch.profiler`` over a
few steps of the stage-2 recipe (float32, from the committed ``lg_tpu_stage2``
weights), the stage-5 recipe (bf16, from ``lg5_init_spsoft``) or a SuperPoint
recipe (``sp_stage0``, ``sp_stage1`` from ``sp_tpu_stage0b``, ``sp_soft``) at
its published widths (batch 32, 320x320, 512 keypoints, 6 layers), after
warm-up steps. Prints the host-clock step times, the device's busy and idle
shares, the device time under each kind of operation (forward operators,
the backward nodes of autograd, the attention Functions, the loss's forward,
the optimizer, the data engine) and the kernels that took the most device
time. Needs a CUDA device.

    python -m gluefactory_torch.scripts.trace_train_step
        [--recipe stage2|stage5|sp_stage0|sp_stage1|sp_soft]
        [--steps 2] [--warmup 2]
"""

from __future__ import annotations

import argparse
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from .. import recipes
from ..recipes import STAGE2_WEIGHTS
from ..train import Trainer, train_step
from ..utils.device import resolve_device


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--recipe", choices=["stage2", "stage5", "sp_stage0", "sp_stage1",
                                             "sp_soft"], default="stage2")
    parser.add_argument("--steps", type=int, default=2)
    parser.add_argument("--warmup", type=int, default=2)
    parser.add_argument("--pool", type=int, default=64, help="procedural pool images")
    parser.add_argument("--attention", default="auto", help="'auto' kernels, 'xla' plain")
    parser.add_argument("--rows", type=int, default=25)
    args = parser.parse_args(argv)
    device = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    conf = getattr(recipes, f"{args.recipe}_conf")()
    conf["data"]["pool_size"] = args.pool
    if "matcher" in conf["model"]:
        conf["model"]["matcher"]["attention"] = args.attention
    conf["train"]["run_benchmarks"] = []  # the step only
    # stage 2's load_experiment is not committed; the others' are blobs or none
    trainer = Trainer(conf, device=device,
                      weights=STAGE2_WEIGHTS if args.recipe == "stage2" else None)
    model_loss = trainer.model.loss

    def loss(pred, data):
        with record_function("loss"):
            return model_loss(pred, data)

    trainer.model.loss = loss
    for seed in range(args.warmup):
        trainer.step(seed)
    torch.cuda.synchronize()
    times = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for seed in range(args.warmup, args.warmup + args.steps):
            t0 = time.perf_counter()
            with record_function("engine"):
                data = trainer.dataset.make_batch(trainer.pool, seed)
            with record_function("train_step"):
                train_step(trainer.model, trainer.optimizer, data)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    events = prof.key_averages()
    # device-side events, less the device copies of the two ranges above
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
               and e.key not in ("engine", "train_step", "loss")]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / args.steps
    step_ms = sum(times) / len(times)
    print(f"{torch.cuda.get_device_name(device)}, {args.recipe}: {args.steps} steps of "
          f"{times} ms; "
          f"device busy {busy_ms:.1f} ms a step ({100 * busy_ms / step_ms:.1f}%), "
          f"idle {100 * (1 - busy_ms / step_ms):.1f}%")
    groups = {
        "engine (make_batch)": lambda k: k == "engine",
        "forward convolutions": lambda k: k == "aten::convolution",
        "forward linear layers": lambda k: k == "aten::linear",
        "attention Functions, forward": lambda k: k in ("AttentionFn", "SelfAttentionRotaryFn"),
        "loss, forward": lambda k: k == "loss",
        "backward nodes": lambda k: k.startswith("autograd::engine::evaluate_function"),
        "optimizer": lambda k: k.startswith("Optimizer.step"),
    }
    for name, match in groups.items():
        ms = sum(e.device_time_total for e in events if match(e.key)) / 1e3 / args.steps
        print(f"  {name:32s} {ms:9.2f} ms a step (device time, children included)")
    backward = sorted((e for e in events if groups["backward nodes"](e.key)),
                      key=lambda e: -e.device_time_total)
    for e in backward[:12]:
        print(f"    {e.key[len('autograd::engine::evaluate_function: '):]:40s} "
              f"{e.device_time_total / 1e3 / args.steps:9.2f} ms a step")
    print(f"  the {args.rows} kernels with the most device time:")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:args.rows]:
        print(f"    {e.self_device_time_total / 1e3 / args.steps:9.2f} ms  {e.count // args.steps:5d}x"
              f"  {e.key[:110]}")


if __name__ == "__main__":
    main()
