"""Where the device memory a pod takes after its CUDA context arises:

    python -m vtpu_torch.northstar.split [--case 1.1]

What ``libvgpu.so`` must charge where NVML cannot tell processes apart
(the footprint's "context" mode, on a machine whose NVML lists every
process as one pid), split three ways on card 0:

- the case in a child without the interposer, under
  ``CUDA_MODULE_LOADING=LAZY`` (PyTorch's default) and ``EAGER``: the
  card's growth at the context, and past the context and
  ``memory_reserved()`` after the case's steps;
- the case in a child under ``libvgpu.so``, stage by stage (the context, a
  cuBLAS handle, a bf16 matmul, a cuDNN convolution, an elementwise op, the
  model built, its steps): the card's growth against the region's charge
  at each stage;
- the interposer's measured calls (first launches, module loads and
  look-ups) by entry point, from its ``LIBCUDA_LOG_LEVEL=3`` log;
- the residue past the charge by cause: each stage reads the context's
  limits (``cuCtxGetLimit``: the stack, the printf FIFO and the malloc
  heap, which the driver commits lazily), the case runs again with the
  FIFO and the heap set to their least before its first launch (without
  the interposer and under it), and the interposed child ends with
  allocations smaller than the card's 2 MiB page, its growth against
  their charge.

This process holds a CUDA context of its own throughout, as a node's
other pods do, so the interposed child measures in context mode. Exits
non-zero without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

from vtpu_torch import api

from .canary import Card
from .run import _pod_env

MEASURED = re.compile(r"first (\S+) of (.*): the card grew by (-?\d+) B at "
                      r"its load and (-?\d+) B across the call")
#: cuCtxGetLimit's limits read at each stage (CUlimit's values)
LIMITS = {"stack": 0, "printf_fifo": 1, "malloc_heap": 2}
#: the allocations smaller than a page the interposed child ends with
SMALL = (4096, 65536, 262144, 1 << 20)
STEPS = 5
QUOTA = 80 << 30  # no quota binds: only the charge is read


def child(mode: str, case_name: str, low: bool = False) -> None:
    """Runs in a child: the card's used memory (NVML), the region's charge
    and the context's limits at each stage, as one JSON line; ``low``: the
    printf FIFO and the malloc heap set to their least after the
    context."""
    import torch

    from vtpu_torch.enforce import install
    from vtpu_torch.models import BENCH_CASES, case_model
    from vtpu_torch.models.train import (init_model, make_infer_step,
                                         make_train_step)
    from vtpu_torch.plugin.nvml import NvmlLib

    nv = NvmlLib()
    enf = install()
    case = next(c for c in BENCH_CASES if c.case == case_name)
    cu = ctypes.CDLL("libcuda.so.1")
    rows = []

    def limits():
        out = {}
        for name, which in LIMITS.items():
            v = ctypes.c_size_t(0)
            rc = cu.cuCtxGetLimit(ctypes.byref(v), which)
            out[name] = v.value if rc == 0 else -rc
        return out

    def stage(label):
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        fp = enf.footprint()
        rows.append({"stage": label, "card": nv.memory(0)[2],
                     "region": enf.used(),
                     "reserved": torch.cuda.memory_reserved()
                     if torch.cuda.is_initialized() else 0,
                     "footprint": fp["bytes"],
                     "measured": fp["calls_measured"],
                     "objects": [fp["small_alloc_pages"], fp["stream_pages"],
                                 fp["page_charge"]],
                     "limits": limits() if torch.cuda.is_initialized()
                     else {}})

    stage("start")
    torch.empty(1, device="cuda")
    if low:
        # the least FIFO and heap the driver takes, before any launch
        for which in (LIMITS["printf_fifo"], LIMITS["malloc_heap"]):
            for size in (0, 4096, 1 << 20):
                if cu.cuCtxSetLimit(which, ctypes.c_size_t(size)) == 0:
                    break
    stage("context")
    if mode == "calls":
        streams = [torch.cuda.Stream() for _ in range(4)]
        stage("4 streams")
        events = [torch.cuda.Event(enable_timing=True) for _ in range(64)]
        for e in events:
            e.record(streams[0])
        stage("64 events")
        ptr = ctypes.c_uint64(0)
        for _ in range(16):
            cu.cuMemAlloc_v2(ctypes.byref(ptr), ctypes.c_size_t(2064))
        stage("16 cuMemAlloc of 2064 B")
        x = torch.randn(2, 16, 32, 32, device="cuda")
        w = torch.randn(16, 16, 3, 3, device="cuda")
        stage("two tensors")
        torch.backends.cudnn.version()
        stage("cuDNN loaded")
        torch.nn.functional.conv2d(x, w, padding=1)
        stage("f32 cuDNN convolution")
        torch.nn.functional.conv2d(x.bfloat16(), w.bfloat16(), padding=1)
        stage("bf16 cuDNN convolution")
        torch.cuda.current_blas_handle()
        stage("cuBLAS handle")
        print(json.dumps(rows), flush=True)
        return
    if mode == "stages":
        torch.cuda.current_blas_handle()
        stage("cuBLAS handle")
        a = torch.randn(256, 256, device="cuda", dtype=torch.bfloat16)
        a @ a
        stage("bf16 matmul")
        x = torch.randn(2, 16, 32, 32, device="cuda", dtype=torch.bfloat16)
        w = torch.randn(16, 16, 3, 3, device="cuda", dtype=torch.bfloat16)
        torch.nn.functional.conv2d(x, w, padding=1)
        stage("cuDNN convolution")
        torch.relu(x) + 1
        stage("elementwise")
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((case.batch,) + case.shape, generator=gen).cuda()
    model = case_model(case, torch.bfloat16, device="cuda")
    if len(case.shape) == 3:
        model = model.to(memory_format=torch.channels_last)
    init_model(model, x, gen)
    stage("model built")
    if case.mode == "inference":
        step = make_infer_step(model)
        for _ in range(STEPS):
            step(x)
    else:
        train, _ = make_train_step(model)
        labels = (case.batch,) + (case.shape[:2]
                                  if case.model == "deeplab_v3" else ())
        y = torch.randint(0, case.classes, labels, generator=gen).cuda()
        for _ in range(STEPS):
            train(x, y)
    stage("steps")
    if mode == "stages":
        # allocations smaller than the card's page, by the driver's own
        # call (charged by the interposer at the bytes asked)
        ptr = ctypes.c_uint64(0)
        for size in SMALL:
            rc = cu.cuMemAlloc_v2(ctypes.byref(ptr), ctypes.c_size_t(size))
            stage(f"cuMemAlloc {size} B" + ("" if rc == 0 else f" rc {rc}"))
    print(json.dumps(rows), flush=True)


def split(case_name: str) -> int:
    try:
        card = Card("cuda")  # this process's context, as a neighbour's
    except RuntimeError as e:
        print(f"split: {e}", file=sys.stderr)
        return 2
    name = card.describe()
    print(f"card: {name['name']}, {name['power_limit']}; case {case_name}",
          flush=True)
    root = tempfile.mkdtemp(prefix="vgpu_split_")
    try:
        residue = {}
        for run in ("LAZY", "EAGER", "LAZY low", "stages", "stages low"):
            cache = os.path.join(root, run.replace(" ", "_"), "vgpu.cache")
            os.makedirs(os.path.dirname(cache))
            env = _pod_env("cuda", cache, os.path.join(root, "locks"))
            env[api.ENV_DEVICE_MEMORY_LIMIT] = str(QUOTA)
            stages = run.startswith("stages")
            if stages:
                env[api.ENV_LOG_LEVEL] = "3"
            else:
                env = {k: v for k, v in env.items()
                       if not k.startswith(("LD_PRELOAD", "CUDA_DEVICE_"))}
                env["CUDA_MODULE_LOADING"] = run.split()[0]
            proc = subprocess.run(
                [sys.executable, "-m", "vtpu_torch.northstar.split",
                 "--child", "stages" if stages else "case",
                 "--case", case_name] + (["--low"] if "low" in run else []),
                env=env, text=True, capture_output=True, timeout=600)
            if proc.returncode != 0:
                print(f"split: child failed, rc {proc.returncode}:\n"
                      f"{proc.stderr[-4000:]}", file=sys.stderr)
                return 1
            rows = json.loads(proc.stdout.strip().splitlines()[-1])
            print(f"{run}: the context's limits {rows[1]['limits']} after "
                  f"it, {rows[-1]['limits']} at the end", flush=True)
            if not stages:
                first, ctx, last = rows[0], rows[1], rows[-1]
                beyond = last["card"] - ctx["card"] - last["reserved"]
                residue[run] = beyond
                print(f"without the interposer, CUDA_MODULE_LOADING={run}: "
                      f"the context {ctx['card'] - first['card']} B; after "
                      f"{STEPS} steps the card grew "
                      f"{last['card'] - first['card']} B, of it "
                      f"{last['reserved']} B memory_reserved and {beyond} B "
                      f"past it and the context", flush=True)
                continue
            steps = next(r for r in rows if r["stage"] == "steps")
            residue[run] = ((steps["card"] - rows[0]["card"])
                            - (steps["region"] - rows[0]["region"]))
            print(f"{run}: after the steps the card grew "
                  f"{steps['card'] - rows[0]['card']} B, the region's "
                  f"charge {steps['region'] - rows[0]['region']} B: "
                  f"{residue[run]} B unaccounted; the charge past the "
                  f"footprint and memory_reserved "
                  f"{steps['region'] - steps['footprint'] - steps['reserved']}"
                  f" B; the card grew {steps['objects'][0]} B across "
                  f"allocations that are not whole pages and "
                  f"{steps['objects'][1]} B across streams made, their "
                  f"pages charged {steps['objects'][2]} B", flush=True)
            for prev, row in zip(rows, rows[1:]):
                grew = row["card"] - prev["card"]
                charged = row["region"] - prev["region"]
                print(f"under libvgpu.so, {row['stage']}: the card grew "
                      f"{grew} B, the region's charge {charged} B "
                      f"(memory_reserved "
                      f"{row['reserved'] - prev['reserved']:+d} B, "
                      f"footprint {row['footprint']} B, "
                      f"{row['measured']} calls measured in all): "
                      f"unaccounted {grew - charged} B", flush=True)
            calls = {}
            for line in proc.stderr.splitlines():
                m = MEASURED.search(line)
                if m:
                    c = calls.setdefault(m.group(1), [0, 0, []])
                    grew = int(m.group(3)) + int(m.group(4))
                    c[0] += 1
                    c[1] += grew
                    if grew:
                        c[2].append((m.group(2)[:60], grew))
            for call, (n, grew, growers) in sorted(calls.items()):
                print(f"measured first {call}: {n} calls, the card grew "
                      f"{grew} B across them; growers {growers[:6]}",
                      flush=True)
        print("residue split: " + json.dumps({
            "unaccounted": residue["stages"],
            "fifo_and_heap": residue["stages"] - residue["stages low"],
            "fifo_and_heap_alone": residue["LAZY"] - residue["LAZY low"],
            "small_alloc_pages": steps["objects"][0],
            "stream_pages": steps["objects"][1],
            "page_charge": steps["objects"][2],
            "rest": residue["stages low"]}), flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return 0


def calls(case_name: str) -> int:
    """The interposed child's growth and charge call by call after its
    context (streams, events, small allocations, cuDNN's first
    convolutions, a cuBLAS handle), beside this process's context."""
    try:
        Card("cuda")
    except RuntimeError as e:
        print(f"split: {e}", file=sys.stderr)
        return 2
    root = tempfile.mkdtemp(prefix="vgpu_split_")
    try:
        cache = os.path.join(root, "calls", "vgpu.cache")
        os.makedirs(os.path.dirname(cache))
        env = _pod_env("cuda", cache, os.path.join(root, "locks"))
        env[api.ENV_DEVICE_MEMORY_LIMIT] = str(QUOTA)
        env[api.ENV_LOG_LEVEL] = "3"
        proc = subprocess.run(
            [sys.executable, "-m", "vtpu_torch.northstar.split", "--child",
             "calls", "--case", case_name], env=env, text=True,
            capture_output=True, timeout=600)
        if proc.returncode != 0:
            print(f"split: child failed, rc {proc.returncode}:\n"
                  f"{proc.stderr[-4000:]}", file=sys.stderr)
            return 1
        rows = json.loads(proc.stdout.strip().splitlines()[-1])
        for prev, row in zip(rows, rows[1:]):
            grew = row["card"] - prev["card"]
            charged = row["region"] - prev["region"]
            print(f"under libvgpu.so, {row['stage']}: the card grew {grew} "
                  f"B, the region's charge {charged} B ({row['measured']} "
                  f"calls measured in all): unaccounted {grew - charged} B",
                  flush=True)
        for line in proc.stderr.splitlines():
            if MEASURED.search(line) and " 0 B at its load and 0 B" not in \
                    line:
                print(line.strip()[:240], flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m vtpu_torch.northstar.split")
    ap.add_argument("--case", default="1.1")
    ap.add_argument("--child", choices=["case", "stages", "calls"],
                    help=argparse.SUPPRESS)
    ap.add_argument("--calls", action="store_true",
                    help="the residue call by call after the context")
    ap.add_argument("--low", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        child(args.child, args.case, args.low)
        return 0
    return calls(args.case) if args.calls else split(args.case)


if __name__ == "__main__":
    sys.exit(main())
