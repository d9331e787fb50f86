#!/usr/bin/env python3
"""Where an ai-benchmark case's step spends its time on one NVIDIA GPU:
any case of the reference's matrix (``vtpu_torch.models.BENCH_CASES``,
1.1 by default: the port's ResNet-V2-50 inference at batch 50), at its
published batch and shape, bf16, channels_last, with the default SGD for
the training cases (the models and inputs of chip_smoke.py).

    python3 chip_profile.py [--case 1.1|1.2|2.1|...|5.2] [--steps N]
    python3 chip_profile.py --case 1.2 --allocators [--quota GIB]
        [--allocator default|expandable|async ...]
    python3 chip_profile.py --case 1.1 --sm-limit PCT

Traces N steady-state steps with torch.profiler and prints: the card
(nvidia-smi name and power limit), the step's wall time, the summed
device-kernel time and the device's idle share of the window, then the
PyTorch operators ranked by the device time of the kernels they launched,
and the top kernels.

With ``--allocators`` it times the case instead, in child processes, under
each of PyTorch's three allocators (or those named with ``--allocator``),
alone and under ``LD_PRELOAD=libvgpu.so``, in the order alone, interposed,
interposed, alone for each allocator, and prints each child's ms/step (CUDA
events), peak reserved memory and, interposed, how many times the
interposer trimmed a memory pool at the quota; then the medians. The quota
is the size of the card unless ``--quota`` sets it, so by default only the
hooks' cost is measured; near the case's peak it measures the enforcement
at work. A child that fails (out of memory under a tight quota) is
reported and the run goes on, then exits non-zero.

With ``--sm-limit PCT`` it times the case in child processes alone and under
``LD_PRELOAD=libvgpu.so`` with ``CUDA_DEVICE_SM_LIMIT=PCT``, in the order
alone, limited, limited, alone, 200 steps each, and prints each child's
ms/step (CUDA events around the timed steps, so the throttle's waits count)
and the medians' ratio. Exits non-zero without a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

from chip_smoke import (ALLOCATORS, CASES, STEPS, TRIM_LOG, build_model,
                        card, child_env, make_batch, run_case, time_steps)
from vtpu_torch.enforce import install
from vtpu_torch.models.train import make_infer_step, make_train_step

CARD_QUOTA = 80 << 30
# --sm-limit: enough steps that the bucket's burst (200 ms x the limit)
# is a small part of the timed window (~5 s of case 1.1 alone)
SM_LIMIT_STEPS = 200
ALLOCATOR_NAMES = dict(zip(("default", "expandable", "async"), ALLOCATORS))


def time_child(case_name: str, steps: int) -> None:
    """Runs in a child: the case's timed steps, as one JSON line."""
    interposed = install().interposed if "LD_PRELOAD" in os.environ \
        else False
    case = CASES[case_name]
    _, ms, _, img_s = run_case(case, build_model(case, torch.bfloat16),
                               steps)
    print(json.dumps({"ms": ms, "img_s": img_s, "interposed": interposed,
                      "max_reserved": torch.cuda.max_memory_reserved(),
                      "max_allocated": torch.cuda.max_memory_allocated()}),
          flush=True)


def compare_allocators(name: str, case_name: str, quota: int,
                       allocators) -> int:
    print(f"card: {name}; torch {torch.__version__}; case {case_name}, "
          f"{STEPS[case_name]} timed steps per child; quota {quota} B")
    failed = 0
    for alloc_conf in allocators:
        label = alloc_conf or "default allocator"
        times = {False: [], True: []}
        for shim in (False, True, True, False):
            tmp, _, env = child_env(alloc_conf, quota)
            if shim:
                env["LIBCUDA_LOG_LEVEL"] = "3"
            else:
                env = {k: v for k, v in env.items() if not k.startswith(
                    ("LD_PRELOAD", "CUDA_DEVICE_MEMORY"))}
            where = "libvgpu.so" if shim else "alone"
            try:
                proc = subprocess.run(
                    [sys.executable, os.path.abspath(__file__),
                     "--time-child", case_name, str(STEPS[case_name])],
                    env=env, text=True, capture_output=True, timeout=600)
            finally:
                shutil.rmtree(tmp, ignore_errors=True)
            trims = proc.stderr.count(TRIM_LOG)
            for line in [t for t in proc.stderr.splitlines()
                         if TRIM_LOG in t][:10]:
                print(f"    {line.split(TRIM_LOG)[1].strip(' ,')}")
            if proc.returncode != 0:
                failed += 1
                tail = " | ".join(
                    line.strip() for line in
                    proc.stderr.strip().splitlines()[-8:])
                print(f"  {label:26s} {where:10s} FAILED rc "
                      f"{proc.returncode} after {trims} pool trims: "
                      f"{tail[-800:]}", flush=True)
                continue
            report = json.loads(proc.stdout.strip().splitlines()[-1])
            if report["interposed"] != shim:
                print(f"chip_profile: child interposed="
                      f"{report['interposed']}, wanted {shim}",
                      file=sys.stderr)
                return 1
            times[shim].append(report["ms"])
            print(f"  {label:26s} {where:10s} {report['ms']:9.3f} ms/step "
                  f"{report['img_s']:8.1f} img/s, max_memory_reserved "
                  f"{report['max_reserved']} B, max_memory_allocated "
                  f"{report['max_allocated']} B, {trims} pool trims",
                  flush=True)
        if times[False] and times[True]:
            alone, shim = (statistics.median(times[k]) for k in (False, True))
            print(f"{label}: median alone {alone:.3f} ms/step, under "
                  f"libvgpu.so {shim:.3f} ms/step ({shim / alone - 1:+.2%}); "
                  f"on {name}", flush=True)
    return 1 if failed else 0


def compare_sm_limit(name: str, case_name: str, limit: int) -> int:
    print(f"card: {name}; torch {torch.__version__}; case {case_name}, "
          f"{SM_LIMIT_STEPS} timed steps per child; SM limit {limit}%")
    times = {False: [], True: []}
    for limited in (False, True, True, False):
        tmp, _, env = child_env("", CARD_QUOTA)
        if limited:
            env["CUDA_DEVICE_SM_LIMIT"] = str(limit)
        else:
            env = {k: v for k, v in env.items() if not k.startswith(
                ("LD_PRELOAD", "CUDA_DEVICE_MEMORY"))}
        try:
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--time-child",
                 case_name, str(SM_LIMIT_STEPS)], env=env, text=True,
                capture_output=True, timeout=600)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        if proc.returncode != 0:
            print(f"chip_profile: child failed, rc {proc.returncode}:\n"
                  f"{proc.stderr[-4000:]}", file=sys.stderr)
            return 1
        report = json.loads(proc.stdout.strip().splitlines()[-1])
        times[limited].append(report["ms"])
        where = f"{limit}% limit" if limited else "alone"
        print(f"  {where:10s} {report['ms']:9.3f} ms/step "
              f"{report['img_s']:8.1f} img/s", flush=True)
    alone, capped = (statistics.median(times[k]) for k in (False, True))
    print(f"median alone {alone:.3f} ms/step, at a {limit}% SM limit "
          f"{capped:.3f} ms/step: {alone / capped:.3f}x the throughput; on "
          f"{name}", flush=True)
    return 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--case", choices=sorted(CASES), default="1.1")
    parser.add_argument("--steps", type=int, default=5)
    parser.add_argument("--allocators", action="store_true")
    parser.add_argument("--quota", type=float, help="GiB (--allocators)")
    parser.add_argument("--allocator", action="append",
                        choices=sorted(ALLOCATOR_NAMES))
    parser.add_argument("--sm-limit", type=int, metavar="PCT")
    parser.add_argument("--time-child", nargs=2, help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.time_child:
        time_child(args.time_child[0], int(args.time_child[1]))
        return 0
    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device", file=sys.stderr)
        return 1
    name = card()
    if args.sm_limit is not None:
        return compare_sm_limit(name, args.case, args.sm_limit)
    if args.allocators:
        quota = int(args.quota * (1 << 30)) if args.quota else CARD_QUOTA
        allocators = [ALLOCATOR_NAMES[a] for a in args.allocator] \
            if args.allocator else ALLOCATORS
        return compare_allocators(name, args.case, quota, allocators)
    case = CASES[args.case]
    model = build_model(case, torch.bfloat16)
    x, y = make_batch(case, 0)
    if case.mode == "inference":
        infer = make_infer_step(model)

        def run(i):
            return infer(x)
    else:
        train, _ = make_train_step(model)

        def run(i):
            return train(x, y)
    time_steps(run, 3)  # warm-up (cuDNN algorithm choice, allocator)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(args.steps):
            run(i)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type.name == "CUDA"]
    busy_us = sum(e.self_device_time_total for e in kernels)
    print(f"card: {name}; torch {torch.__version__}; case {case.case} "
          f"({case.mode}, batch {case.batch})")
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
