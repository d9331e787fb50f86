#!/usr/bin/env python3
"""Where ai-benchmark case 1.1's inference step spends its time on one
NVIDIA GPU (the port's ResNet-V2-50, batch 50, 346x346, bf16,
channels_last; the model and input of chip_smoke.py).

    python3 chip_profile.py [--steps N]

Traces N steady-state steps with torch.profiler and prints: the card
(nvidia-smi name and power limit), the step's wall time, the summed
device-kernel time and the device's idle share of the window, then the
PyTorch operators ranked by the device time of the kernels they launched,
and the top kernels. Exits non-zero without a GPU.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

from chip_smoke import build_case, card, time_steps
from vtpu_torch.models.train import make_infer_step


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--steps", type=int, default=5)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device", file=sys.stderr)
        return 1
    name = card()
    model, x = build_case(torch.bfloat16)
    step = make_infer_step(model)
    time_steps(step, x)  # warm-up (cuDNN algorithm choice, allocator)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step(x)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type.name == "CUDA"]
    busy_us = sum(e.self_device_time_total for e in kernels)
    print(f"card: {name}; torch {torch.__version__}")
    print(f"{args.steps} steps: wall {wall_us / args.steps / 1e3:.3f} ms/step,"
          f" device kernels {busy_us / args.steps / 1e3:.3f} ms/step, "
          f"device idle {max(0.0, 1 - busy_us / wall_us):.3%} of the window")
    if busy_us <= 0:
        print("chip_profile: the trace holds no device time",
              file=sys.stderr)
        return 1
    ops = sorted((e for e in events if e.device_type.name == "CPU"
                  and e.key.startswith("aten::")
                  and e.self_device_time_total > 0),
                 key=lambda e: -e.self_device_time_total)
    print("operator (self device time of its kernels):")
    for e in ops[:15]:
        print(f"  {e.key:40s} calls/step {e.count // args.steps:4d}  "
              f"{e.self_device_time_total / args.steps / 1e3:8.3f} ms/step "
              f"{e.self_device_time_total / busy_us:7.2%}")
    print("kernels:")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]:
        print(f"  {e.key[:90]:90s} "
              f"{e.self_device_time_total / args.steps / 1e3:8.3f} ms/step "
              f"{e.self_device_time_total / busy_us:7.2%}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
