#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (vtpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path at full width, from a checkout with nothing
built:

1. prints the card (``nvidia-smi`` name and power limit) and the
   torch/CUDA versions;
2. builds the native libraries (vtpu_torch/native.py: libvgpucore.so,
   libvgpu.so) with gcc;
3. case 1.1 phase: ai-benchmark case 1.1, ResNet-V2-50 inference at batch
   50, 346x346x3, 1000 classes, bf16 compute with f32 parameters,
   channels_last, weights from a seeded generator. Warm-up, then timed
   steps (CUDA events); checks the logits' shape, type and finiteness and
   their relative L2 error against the port's own f32 forward of the same
   weights (TF32 off), within the bf16 tolerance of the CPU parity tests
   (5e-2); also runs ``vtpu_torch.entry()`` on the card;
4. case 1.2 phase: ResNet-V2-50 training at batch 20, 346x346x3, 1000
   classes, bf16 compute, the default SGD. Warm-up, then timed steps on
   distinct seeded batches; every loss finite. From the same weights and
   batch, one step three ways: bf16 and f32 (TF32 off) on the card, and
   f32 on the host CPU. The f32 step on the card holds the whole step to
   the CPU's (loss within 1e-4 relative, parameter update within relative
   L2 5e-2); the bf16 step's loss is within 5e-2 of the f32 step's. The
   bf16 update's distance from the f32 update is printed, not gated: at
   initialisation bf16 rounding moves the whole update by about its own
   size, in the JAX reference too (PERF.md). Prints ms/step, img/s and
   peak memory;
5. sharded phase: ``build_sharded_train_step`` on a 1x1 mesh over an NCCL
   group of one rank, from the same weights and batch as the plain step,
   in bf16 and in f32 (TF32 off): in f32 the loss within 1e-4 relative
   and the whole update within relative L2 5e-2 of the plain step's, in
   bf16 the loss within 5e-2; then ``vtpu_torch.dryrun_multichip(1)``;
6. quota phases, for case 1.1 (a 12 GiB quota) and case 1.2, each under
   the three PyTorch allocators (the default caching allocator,
   ``expandable_segments:True``, ``backend:cudaMallocAsync``). Case 1.2's
   quota under an allocator is its peak ``max_memory_reserved()`` alone
   under that allocator (phase 4 for the default one, a child without the
   interposer for the others) plus 25%, rounded up to whole GiB:
   a child started with ``LD_PRELOAD=libvgpu.so`` and its own region file
   calls ``vtpu_torch.enforce.install()`` and runs the case's steps; it
   checks that ``torch.cuda.mem_get_info()`` shows the quota, that the
   region's charge matches ``torch.cuda.memory_reserved()`` within a
   stated margin, and that one allocation past the quota raises
   ``torch.OutOfMemoryError`` and the case still runs after it. The
   parent reads the region as the node monitor does (``RegionView``): the
   child had a slot while it ran, and the region is clean after it exits;
   it also counts the times the interposer trimmed a memory pool at the
   quota (from its log);
7. compute-plane phases, each in children with their own region file
   (``--sm-child``, one JSON command and reply per line), every number
   printed on its own line:

   (a) launch visibility: under ``libvgpu.so`` with no SM limit, the
       region's launch count over one case 1.1 step is at least the number
       of kernels ``torch.profiler`` traces for it;
   (b) unthrottled cost: case 1.1 and case 1.2 ms/step alone, under
       ``libvgpu.so`` with no SM limit and with ``CUDA_DEVICE_SM_LIMIT=100``
       (where each launch's device time is still measured and charged);
       case 1.1 within 3% of alone (case 1.2's printed: host-bound, it
       spreads between processes);
   (c) solo throttle: case 1.1 at a 50% limit for 12 s, each step
       synchronised, runs at 0.40-0.60x its unthrottled img/s, and the
       device time the region was charged (the slot's ``launch_ns``) is
       0.8-1.1x the unthrottled CUDA-event step time over those steps;
   (d) two case 1.1 tenants at 70% and 30% at once for 12 s: img/s ratio
       in (1.7, 3.2), each below 0.9x and 0.55x of the solo rate; then,
       printed as their reference, two pods with no limit at once;
   (e) case 1.1's step captured with ``torch.cuda.CUDAGraph`` at a 50%
       limit: the capture succeeds, its logits match the eager step's, and
       replays run at 0.40-0.60x the unthrottled replays;
   (f) feedback: the parent sets ``recent_kernel = FEEDBACK_BLOCK`` on the
       30% tenant's region (priority 1): its region launch count stands
       still while blocked and moves after; ``utilization_switch = 1``
       lifts its throttle (above 0.8x solo);
   (g) gate: the parent lowers the 50% child's region limit to its usage;
       its next step raises an out-of-memory error from the refused
       launch, and after the limit is restored it runs on;
   (h) host ledger: pinned tensors up to a 1 GiB
       ``CUDA_HOST_MEMORY_LIMIT`` are charged to the region's host ledger,
       one past it raises and the process runs on, ``cudaHostRegister``
       and ``cudaHostUnregister`` charge and uncharge; each child's region
       is clean after it exits;
8. phase (i), the node agent (vtpu_torch/plugin): NVML enumerates the
   cards in this process (its time printed), each card's UUID, name and
   MiB equal to torch's and ``nvidia-smi``'s and its ``/dev/nvidia<minor>``,
   ``/dev/nvidiactl`` and ``/dev/nvidia-uvm`` present. The device plugin
   then runs in a child through its entry point
   (``vtpu_torch.plugin.__main__.main``) with an in-memory apiserver
   (``FakeKubeClient``) and temp dirs for kubelet's socket dir and the shim
   host dir; it registers with a fake kubelet, ListAndWatch gives
   10 x cards healthy replicas and the register annotation decodes to the
   NVML inventory. The script plays the scheduler (the assignment
   annotations of one card, ``gpumem`` 12288 MiB, ``gpucores`` 50, written
   with the port's codec at bind-phase ``allocating``) and kubelet
   (Allocate over the plugin's socket, its latency printed); bind-phase
   turns ``success``. The plugin process imported no torch and took no
   device memory or context. A case 1.1 ``--sm-child`` started with only
   the response's env and mounts (vtpu_torch/plugin/runtime.py) sees a
   12 GiB ``mem_get_info`` total, is refused one allocation past it and
   runs on, runs at 0.40-0.60x phase (c)'s unthrottled img/s for 12 s, and
   its region at the mount's host path carries the limit, the SM limit 50
   and its slot, and is clean after it exits;
9. phase (j), the node monitor (vtpu_torch/monitor) over phase (i)'s
   plugin: the monitor runs in a child through its entry point
   (``vtpu_torch.monitor.__main__.main``, ``--sweep-interval 1``) with an
   in-memory apiserver, over the plugin's containers directory, and pods
   are case 1.1 ``--sm-child`` children started from Allocate responses
   (``gpumem`` 12288 MiB). Pod H alone (priority 0, ``gpucores`` 50) is
   released (``utilization_switch`` 1) within 3 sweeps and runs at >= 0.8x
   phase (c)'s unthrottled img/s; the memory gauges match its quota, its
   ``memory_reserved()`` (within 256 MiB), NVML's capacity and the pods'
   sum; ``HostCoreUtilization`` over two scrapes 10 s apart is 0.8-1.1x
   its busy share (CUDA-event step time over wall time), and so it is for
   pod U with no SM limit alone. Pod L (priority 1, ``gpucores`` 50) joins
   while H runs: both throttled and L blocked within 3 sweeps, L's region
   launches stand still for 5 s, H runs at 0.40-0.60x. H exits: L is
   unblocked within 3 sweeps and, once H's directory is gone, released
   and at >= 0.8x. Pod F alone under ``GPU_CORE_UTILIZATION_POLICY=force``
   stays throttled at 0.40-0.60x. ``/nodeinfo`` lists each live pod with
   its limit and usage; the sweep latency is printed; the monitor took no
   context and no device memory; every region is clean after its pod
   exits; the phase takes under 120 s;
10. prints the port's native components (the JAX package has no TPU kernel,
   so ``kernels`` is empty) and, last, ``{"ok": true, "device": ...}``.

Any failed phase ends the run with a non-zero exit and no final line. So
does a machine without CUDA, or a directory without the repository.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import select
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent import futures

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from vtpu_torch import native  # noqa: E402
from vtpu_torch.enforce import install  # noqa: E402
from vtpu_torch.enforce.region import (  # noqa: E402
    FEEDBACK_BLOCK,
    FEEDBACK_IDLE,
    RegionView,
)
from vtpu_torch.models import BENCH_CASES, get_model  # noqa: E402
from vtpu_torch.models.train import (  # noqa: E402
    build_sharded_train_step,
    init_model,
    make_infer_step,
    make_mesh,
    make_train_step,
)

CASES = {c.case: c for c in BENCH_CASES if c.case in ("1.1", "1.2")}
GiB = 1 << 30
MiB = 1 << 20
INFER_QUOTA = 12 * GiB
ALLOCATORS = ("", "expandable_segments:True", "backend:cudaMallocAsync")
# bf16 against the f32 computation: the CPU parity tests' tolerance
BF16_REL = 5e-2
# two f32 implementations of one loss (card without TF32, host CPU)
F32_REL = 1e-4
# region charge minus torch.cuda.memory_reserved(): device memory that
# libraries in the process take with cuMemAlloc outside PyTorch's
# allocator, per thread that uses them. Measured on an H100 (PERF.md) at
# 67,266,308 B for inference and twice that for training, whose backward
# runs on autograd's own thread; the margin leaves room for library
# versions that take more.
RESERVED_MARGIN = 256 << 20
# case 1.2's quota under an allocator: its peak reserved memory alone under
# that allocator plus this share (a cudaMallocAsync pool reserves ~1.3x what
# the caching allocator does for the same steps, PERF.md)
TRAIN_HEADROOM = 0.25
# what libvgpu.so logs (LIBCUDA_LOG_LEVEL=3) when it trims a pool at the quota
TRIM_LOG = "memory pool at the quota, trimmed"
WARMUP = 3
STEPS = {"1.1": 10, "1.2": 10}
CHILD_TIMEOUT_S = 300


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


def make_batch(case, seed: int):
    """A seeded NHWC batch of ``case`` on the card, and its labels."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((case.batch,) + case.shape, generator=gen)
    y = torch.randint(0, case.classes, (case.batch,), generator=gen)
    return x.cuda(), y.cuda()


def build_model(case, dtype: torch.dtype, seed: int = 0):
    """``case``'s model on the card, channels_last, with weights from
    ``seed``."""
    model = get_model(case.model, num_classes=case.classes, dtype=dtype,
                      device="cuda").to(memory_format=torch.channels_last)
    init_model(model, make_batch(case, seed)[0],
               torch.Generator().manual_seed(seed + 1))
    return model


def time_steps(run, steps: int):
    """Warm up, then ``steps`` calls of ``run(i)``: (outputs of the timed
    calls, device ms per step from CUDA events, host ms per step)."""
    for i in range(WARMUP):
        run(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    outs = [run(WARMUP + i) for i in range(steps)]
    end.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / steps
    return outs, start.elapsed_time(end) / steps, host_ms


def run_case(case, model, steps: int):
    """The case's steps on its model: (last output, ms, host ms, img/s).
    Inference reuses one batch; training takes a distinct seeded batch
    each step and checks that every loss is finite."""
    if case.mode == "inference":
        x, _ = make_batch(case, 0)
        step = make_infer_step(model)
        outs, ms, host_ms = time_steps(lambda i: step(x), steps)
        check_logits(case, outs[-1])
    else:
        batches = [make_batch(case, 100 + i) for i in range(WARMUP + steps)]
        step, _ = make_train_step(model)
        outs, ms, host_ms = time_steps(lambda i: step(*batches[i]), steps)
        losses = torch.stack(outs)
        check(bool(torch.isfinite(losses).all()),
              f"case {case.case}: non-finite loss in {losses.tolist()}")
    return outs[-1], ms, host_ms, case.batch / (ms / 1e3)


def check_logits(case, out: torch.Tensor) -> None:
    check(tuple(out.shape) == (case.batch, case.classes),
          f"logits shape {tuple(out.shape)}")
    check(out.dtype == torch.float32, f"logits dtype {out.dtype}")
    check(bool(torch.isfinite(out).all()), "non-finite logits")


class NoTF32:
    def __enter__(self):
        self.saved = (torch.backends.cudnn.allow_tf32,
                      torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = self.saved


def rel_l2(got: torch.Tensor, ref: torch.Tensor) -> float:
    return float((got.double() - ref.double()).norm() / ref.double().norm())


def infer_phase(name: str) -> dict:
    case = CASES["1.1"]
    model = build_model(case, torch.bfloat16)
    torch.cuda.reset_peak_memory_stats()
    out, ms, host_ms, img_s = run_case(case, model, STEPS["1.1"])
    peak = torch.cuda.max_memory_allocated()
    x, _ = make_batch(case, 0)
    with NoTF32():
        ref_model = get_model(case.model, num_classes=case.classes,
                              dtype=torch.float32, device="cuda").to(
            memory_format=torch.channels_last)
        ref_model.load_state_dict(model.state_dict())
        ref = make_infer_step(ref_model)(x)
    rel = rel_l2(out, ref)
    check(rel <= BF16_REL, f"bf16 logits rel L2 {rel} > {BF16_REL}")

    import vtpu_torch
    fn, args = vtpu_torch.entry()
    eout = fn(*args)
    check(tuple(eout.shape) == (8, 1000)
          and bool(torch.isfinite(eout).all()), "entry() logits")

    print(f"case 1.1 native: ResNet-V2-50 bf16 batch {case.batch} "
          f"{case.shape[0]}x{case.shape[1]}: {ms:.3f} ms/step (CUDA events, "
          f"{STEPS['1.1']} steps), host {host_ms:.3f} ms/step, "
          f"{img_s:.1f} img/s, bf16-vs-f32 rel L2 {rel:.3e}, peak allocated "
          f"{peak} B; on {name}", flush=True)
    del model, ref_model, x, out, ref, fn, args, eout
    torch.cuda.empty_cache()
    return {"phase": "case 1.1 native", "step_ms": ms,
            "host_step_ms": host_ms, "img_s": img_s,
            "rel_l2_bf16_vs_f32": rel, "peak_allocated_bytes": peak}


def one_step(model, params, step, x, y):
    """(loss, {name: new - old}) of one ``step`` over ``params``."""
    def whole(p):
        p = p.detach()
        return p.full_tensor() if hasattr(p, "full_tensor") else p
    old = {n: whole(p).clone() for n, p in params.items()}
    loss = step(x, y)
    return float(loss), {n: whole(p) - old[n] for n, p in params.items()}


def flat(update: dict, names=None) -> torch.Tensor:
    return torch.cat([update[n].double().flatten()
                      for n in sorted(names or update)])


def train_phase(name: str) -> dict:
    case = CASES["1.2"]
    model = build_model(case, torch.bfloat16)
    torch.cuda.reset_peak_memory_stats()
    _, ms, host_ms, img_s = run_case(case, model, STEPS["1.2"])
    peak_alloc = torch.cuda.max_memory_allocated()
    peak_reserved = torch.cuda.max_memory_reserved()
    del model
    torch.cuda.empty_cache()

    # one step from the same weights and batch: bf16 and f32 (TF32 off) on
    # the card, and f32 on the host CPU as an independent implementation
    x, y = make_batch(case, 0)
    model = build_model(case, torch.bfloat16)
    with NoTF32():
        ref_model = get_model(case.model, num_classes=case.classes,
                              dtype=torch.float32, device="cuda").to(
            memory_format=torch.channels_last)
        ref_model.load_state_dict(model.state_dict())
        ref_loss, ref_up = one_step(ref_model,
                                    dict(ref_model.named_parameters()),
                                    make_train_step(ref_model)[0], x, y)
    del ref_model
    cpu_model = get_model(case.model, num_classes=case.classes,
                          dtype=torch.float32, device="cpu")
    cpu_model.load_state_dict(model.state_dict())
    t0 = time.perf_counter()
    cpu_loss, cpu_up = one_step(cpu_model, dict(cpu_model.named_parameters()),
                                make_train_step(cpu_model)[0], x.cpu(),
                                y.cpu())
    cpu_s = time.perf_counter() - t0
    del cpu_model
    loss, up = one_step(model, dict(model.named_parameters()),
                        make_train_step(model)[0], x, y)
    del model
    torch.cuda.empty_cache()
    cpu_up = {n: u.cuda() for n, u in cpu_up.items()}
    f32_loss_rel = abs(ref_loss - cpu_loss) / abs(cpu_loss)
    f32_up_rel = rel_l2(flat(ref_up), flat(cpu_up))
    loss_rel = abs(loss - ref_loss) / abs(ref_loss)
    head = ["head.weight", "head.bias"]
    head_rel = rel_l2(flat(up, head), flat(ref_up, head))
    whole_rel = rel_l2(flat(up), flat(ref_up))
    print(f"case 1.2 native: ResNet-V2-50 training bf16 batch {case.batch} "
          f"{case.shape[0]}x{case.shape[1]}, SGD momentum 0.9: {ms:.3f} "
          f"ms/step (CUDA events, {STEPS['1.2']} steps), host "
          f"{host_ms:.3f} ms/step, {img_s:.1f} img/s; "
          f"max_memory_allocated {peak_alloc} B, max_memory_reserved "
          f"{peak_reserved} B; on {name}", flush=True)
    print(f"case 1.2 one step, same weights and batch: f32 on the card (TF32 "
          f"off) vs f32 on the host CPU ({cpu_s:.1f} s): loss {ref_loss:.6f} "
          f"vs {cpu_loss:.6f} (rel {f32_loss_rel:.3e}), update rel L2 "
          f"{f32_up_rel:.3e}; bf16 vs f32 on the card: loss {loss:.6f} (rel "
          f"{loss_rel:.3e}), head update rel L2 {head_rel:.3e}, whole-model "
          f"update rel L2 {whole_rel:.3e}; on {name}", flush=True)
    check(all(bool(torch.isfinite(u).all()) for u in up.values()),
          "non-finite parameter update")
    check(f32_loss_rel <= F32_REL, f"f32 card vs CPU loss rel "
          f"{f32_loss_rel} > {F32_REL}")
    check(f32_up_rel <= BF16_REL, f"f32 card vs CPU update rel L2 "
          f"{f32_up_rel} > {BF16_REL}")
    check(loss_rel <= BF16_REL, f"bf16 vs f32 loss rel {loss_rel}")
    return {"phase": "case 1.2 native", "step_ms": ms,
            "host_step_ms": host_ms, "img_s": img_s,
            "peak_allocated_bytes": peak_alloc,
            "peak_reserved_bytes": peak_reserved,
            "f32_card_vs_cpu_loss_rel": f32_loss_rel,
            "f32_card_vs_cpu_update_rel_l2": f32_up_rel,
            "loss_rel_bf16_vs_f32": loss_rel,
            "head_update_rel_l2_bf16_vs_f32": head_rel,
            "update_rel_l2_bf16_vs_f32": whole_rel}


def sharded_phase(name: str) -> dict:
    """The sharded step on a 1x1 mesh (NCCL, one rank) against the plain
    step from the same weights and batch, in bf16 and in f32 (TF32 off),
    then dryrun_multichip(1). The f32 pair is held to the f32 tolerance
    of the loss and to 5e-2 on the whole update; the bf16 pair's loss to
    5e-2, its update printed (bf16 rounding, PERF.md)."""
    import torch.distributed as dist

    import vtpu_torch

    case = CASES["1.2"]
    x, y = make_batch(case, 0)
    dtypes = {"bf16": (torch.bfloat16, contextlib.nullcontext),
              "f32": (torch.float32, NoTF32)}
    plain, sharded = {}, {}
    for kind, (dtype, mode) in dtypes.items():
        with mode():
            model = build_model(case, dtype)
            plain[kind] = one_step(model, dict(model.named_parameters()),
                                   make_train_step(model)[0], x, y)
        del model
    tmp = tempfile.mkdtemp(prefix="vgpu-smoke-pg-")
    dist.init_process_group("nccl", init_method=f"file://{tmp}/pg",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh("cuda", dp=1, tp=1)
        for kind, (dtype, mode) in dtypes.items():
            with mode():
                model = get_model(case.model, num_classes=case.classes,
                                  dtype=dtype, device="cuda").to(
                    memory_format=torch.channels_last)
                step, (params, _, _) = build_sharded_train_step(
                    model, x, y, mesh, torch.Generator().manual_seed(1))
                sharded[kind] = one_step(model, params, step, x, y)
            del model, params, step
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    result = {"phase": "case 1.2 sharded 1x1"}
    for kind in dtypes:
        (s_loss, s_up), (loss, up) = sharded[kind], plain[kind]
        result[f"{kind}_loss_rel_vs_plain"] = abs(s_loss - loss) / abs(loss)
        result[f"{kind}_update_rel_l2_vs_plain"] = rel_l2(flat(s_up),
                                                          flat(up))
        print(f"case 1.2 sharded {kind}, 1x1 mesh over NCCL: loss "
              f"{s_loss:.6f} vs plain {loss:.6f} (rel "
              f"{result[f'{kind}_loss_rel_vs_plain']:.3e}), update rel L2 "
              f"{result[f'{kind}_update_rel_l2_vs_plain']:.3e}; on {name}",
              flush=True)
    t0 = time.perf_counter()
    vtpu_torch.dryrun_multichip(1)
    result["dryrun_multichip_1_s"] = time.perf_counter() - t0
    print(f"dryrun_multichip(1) passed in "
          f"{result['dryrun_multichip_1_s']:.1f} s; on {name}", flush=True)
    check(result["f32_loss_rel_vs_plain"] <= F32_REL,
          f"sharded vs plain f32 loss rel {result['f32_loss_rel_vs_plain']}")
    check(result["f32_update_rel_l2_vs_plain"] <= BF16_REL,
          f"sharded vs plain f32 update rel L2 "
          f"{result['f32_update_rel_l2_vs_plain']}")
    check(result["bf16_loss_rel_vs_plain"] <= BF16_REL,
          f"sharded vs plain bf16 loss rel {result['bf16_loss_rel_vs_plain']}")
    return result


def quota_child(case_name: str, quota: int) -> None:
    """Runs in the child under LD_PRELOAD=libvgpu.so."""
    case = CASES[case_name]
    enf = install()
    check(enf.interposed, "libvgpu.so is not active in the child")
    check(enf.limit() == quota, f"quota {enf.limit()} != {quota}")
    model = build_model(case, torch.bfloat16)
    out, ms, host_ms, img_s = run_case(case, model, STEPS[case_name])
    free, total = torch.cuda.mem_get_info()
    used = enf.used()
    reserved = torch.cuda.memory_reserved()
    check(total == quota, f"mem_get_info total {total} != quota {quota}")
    check(free == quota - used, f"mem_get_info free {free} != quota - "
          f"region used {quota - used}")
    check(0 <= used - reserved <= RESERVED_MARGIN,
          f"region used {used} vs memory_reserved {reserved}: gap "
          f"{used - reserved} B outside [0, {RESERVED_MARGIN}]")
    try:
        torch.empty(quota, dtype=torch.uint8, device="cuda")
        raise SmokeFailure("an allocation past the quota succeeded")
    except torch.OutOfMemoryError:
        pass
    after, _, _, _ = run_case(case, model, 1)
    torch.cuda.synchronize()
    if case.mode == "inference":
        drift = rel_l2(after, out)
        check(drift <= BF16_REL, f"logits moved by {drift} after the "
              f"refusal")
    print(json.dumps({"pid": os.getpid(), "step_ms": ms,
                      "host_step_ms": host_ms, "img_s": img_s,
                      "loss_after_refusal": float(after)
                      if case.mode == "training" else None,
                      "region_used": enf.used(),
                      "reserved_at_check": reserved,
                      "used_at_check": used,
                      "memory_reserved": torch.cuda.memory_reserved(),
                      "max_memory_reserved": torch.cuda.max_memory_reserved(),
                      "max_memory_allocated":
                          torch.cuda.max_memory_allocated()}),
          flush=True)
    sys.stdin.readline()  # the parent reads the region meanwhile


def peak_child(case_name: str) -> None:
    """Runs in a child, alone, under the allocator its env names: the
    case's steps, then its peak reserved memory as one JSON line."""
    case = CASES[case_name]
    run_case(case, build_model(case, torch.bfloat16), STEPS[case_name])
    print(json.dumps({"max_memory_reserved":
                      torch.cuda.max_memory_reserved()}), flush=True)


def alone_peak(case_name: str, alloc_conf: str) -> int:
    """``case_name``'s peak ``max_memory_reserved()`` under ``alloc_conf``
    (PYTORCH_CUDA_ALLOC_CONF), from a child without the interposer."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("CUDA_DEVICE_", "CUDA_DISABLE", "LD_PRELOAD",
                                "PYTORCH_CUDA_ALLOC_CONF"))}
    env.update({"PYTHONPATH": ROOT, "PYTORCH_CUDA_ALLOC_CONF": alloc_conf})
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--peak-child",
         case_name], env=env, capture_output=True, text=True,
        timeout=CHILD_TIMEOUT_S)
    check(proc.returncode == 0, f"case {case_name} peak child "
          f"({alloc_conf}) rc {proc.returncode}:\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])[
        "max_memory_reserved"]


def child_env(alloc_conf: str, quota: int):
    """(temp dir, region file, env) for a quota child: libvgpu.so
    preloaded, ``quota`` bytes, its own region file under
    .../containers/<pod uid>_0/, and ``alloc_conf`` as
    PYTORCH_CUDA_ALLOC_CONF ("" = PyTorch's default allocator)."""
    tmp = tempfile.mkdtemp(prefix="vgpu-smoke-")
    cache = os.path.join(tmp, "containers", "smoke-pod_0", "vgpu.cache")
    os.makedirs(os.path.dirname(cache))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("CUDA_DEVICE_", "CUDA_DISABLE",
                                "PYTORCH_CUDA_ALLOC_CONF"))}
    env.update({
        "LD_PRELOAD": native.interposer(),
        "CUDA_DEVICE_MEMORY_LIMIT": str(quota),
        "CUDA_DEVICE_MEMORY_SHARED_CACHE": cache,
        "PYTHONPATH": ROOT,
    })
    if alloc_conf:
        env["PYTORCH_CUDA_ALLOC_CONF"] = alloc_conf
    return tmp, cache, env


def check_clean(cache: str) -> None:
    with RegionView(cache) as view:
        check(view.procs() == [] and view.used(0) == 0,
              "region not clean after the child exited")


def quota_phase(name: str, case_name: str, quota: int,
                alloc_conf: str) -> dict:
    label = alloc_conf or "default allocator"
    tmp, cache, env = child_env(alloc_conf, quota)
    env["LIBCUDA_LOG_LEVEL"] = "3"
    free0, _ = torch.cuda.mem_get_info()
    errf = open(os.path.join(tmp, "child.err"), "w+")
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--quota-child",
         case_name, str(quota)],
        env=env, stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=errf,
        text=True)
    try:
        ready, _, _ = select.select([proc.stdout], [], [], CHILD_TIMEOUT_S)
        line = proc.stdout.readline() if ready else ""
        if not line:
            proc.kill()
            proc.wait(timeout=60)
            errf.seek(0)
            raise SmokeFailure(f"case {case_name} quota child ({label}) "
                               f"failed, rc {proc.returncode}:\n"
                               f"{errf.read()[-4000:]}")
        report = json.loads(line)
        free1, _ = torch.cuda.mem_get_info()
        footprint = free0 - free1  # the child's real device memory
        with RegionView(cache) as view:
            pids = [p.pid for p in view.procs()]
            check(pids == [proc.pid], f"region slots {pids}, child "
                  f"{proc.pid}")
            check(view.hbm_limit(0) == quota, "region limit")
            region_used = view.used(0)
            check(region_used == report["region_used"],
                  f"monitor reads {region_used} B, child charged "
                  f"{report['region_used']} B")
        proc.communicate("exit\n", timeout=CHILD_TIMEOUT_S)
        errf.seek(0)
        err = errf.read()
        check(proc.returncode == 0,
              f"quota child rc {proc.returncode}:\n{err[-4000:]}")
        check_clean(cache)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
        errf.close()
        shutil.rmtree(tmp, ignore_errors=True)
    result = dict(report, phase=f"case {case_name} quota ({label})",
                  quota_bytes=quota, device_footprint_bytes=footprint,
                  unaccounted_bytes=footprint - region_used,
                  pool_trims=err.count(TRIM_LOG))
    print(f"case {case_name} under libvgpu.so, {quota} B quota, {label}: "
          f"{report['step_ms']:.3f} ms/step (CUDA events), "
          f"{report['img_s']:.1f} img/s; region charge {region_used} B vs "
          f"memory_reserved {report['memory_reserved']} B (at the check: "
          f"{report['used_at_check']} vs {report['reserved_at_check']}); "
          f"child device footprint {footprint} B, of it not charged "
          f"{footprint - region_used} B; {result['pool_trims']} pool trims "
          f"at the quota; on {name}", flush=True)
    return result


# ------------------------------------------------------ the compute plane.
# Children answer one JSON command per line of stdin with one JSON line
# (--sm-child). Each has its own region file; all but "alone" run under
# libvgpu.so with a 12 GiB quota and the SM limit, priority and host limit
# of their phase.

SM_RUN_S = 12.0     # (c), (d): throttled runs, after warm-up
REF_RUN_S = 4.0     # the unthrottled run they are held to
GRAPH_RUN_S = 4.0   # (e)
SWITCH_RUN_S = 3.0  # (f)
BLOCK_S = 1.0       # (f): how long the block is held
HOST_LIMIT = 1 * GiB
PINNED = 256 << 20  # (h): pinned tensors of this size up to the limit
REGISTERED = 64 << 20
# (b): case 1.1 with no SM limit and at 100 against the same call's run
# alone
UNTHROTTLED_COST = 0.03


class SmChild:
    """A --sm-child process and its region file."""

    def __init__(self, label: str, interposed: bool = True, sm_limit=None,
                 priority=None, host_limit=None, given=None):
        """``given`` = (env, region file) replaces the env this class
        builds (phase (i): the env of an Allocate response)."""
        self.label = label
        if given is not None:
            env, self.cache = given
            self.tmp = tempfile.mkdtemp(prefix="vgpu-smoke-")
        else:
            self.tmp, self.cache, env = child_env("", INFER_QUOTA)
        if not interposed:
            env = {k: v for k, v in env.items() if not k.startswith(
                ("LD_PRELOAD", "CUDA_DEVICE_MEMORY"))}
        for key, value in (("CUDA_DEVICE_SM_LIMIT", sm_limit),
                           ("CUDA_TASK_PRIORITY", priority),
                           ("CUDA_HOST_MEMORY_LIMIT", host_limit)):
            if value is not None:
                env[key] = str(value)
        self.errf = open(os.path.join(self.tmp, "child.err"), "w+")
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--sm-child"],
            env=env, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=self.errf, text=True)

    def send(self, op: str, **args) -> None:
        self.proc.stdin.write(json.dumps(dict(args, op=op)) + "\n")
        self.proc.stdin.flush()

    def read(self) -> dict:
        ready, _, _ = select.select([self.proc.stdout], [], [],
                                    CHILD_TIMEOUT_S)
        line = self.proc.stdout.readline() if ready else ""
        if not line:
            self.errf.seek(0)
            raise SmokeFailure(f"{self.label} child gave no answer, rc "
                               f"{self.proc.poll()}:\n"
                               f"{self.errf.read()[-4000:]}")
        reply = json.loads(line)
        check("error" not in reply, f"{self.label} child: {reply.get('error')}")
        return reply

    def ask(self, op: str, **args) -> dict:
        self.send(op, **args)
        return self.read()

    def view(self) -> RegionView:
        return RegionView(self.cache)

    def close(self) -> None:
        try:
            if self.proc.poll() is None:
                self.proc.communicate("", timeout=CHILD_TIMEOUT_S)
            rc = self.proc.returncode
            self.errf.seek(0)
            err = self.errf.read()
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.wait(timeout=60)
            self.errf.close()
        check(rc == 0, f"{self.label} child rc {rc}:\n{err[-4000:]}")
        if os.path.exists(self.cache):
            check_clean(self.cache)
        shutil.rmtree(self.tmp, ignore_errors=True)


def sm_child() -> None:
    """Runs in a --sm-child process: one JSON reply per JSON command."""
    enf = install()
    models = {}

    def model(case_name):
        if case_name not in models:
            case = CASES[case_name]
            models[case_name] = build_model(case, torch.bfloat16)
        return models[case_name]

    def slot():
        """this process's slot in its region, everything published"""
        torch.cuda.synchronize()
        enf.flush_launches()
        with RegionView(enf.quota.cache_path) as view:
            (mine,) = [p for p in view.procs() if p.pid == os.getpid()]
        return mine

    def infer():
        case = CASES["1.1"]
        x, _ = make_batch(case, 0)
        return make_infer_step(model("1.1")), x

    def op_time(cmd):
        case = CASES[cmd["case"]]
        _, ms, host_ms, img_s = run_case(case, model(cmd["case"]),
                                         STEPS[cmd["case"]])
        return {"ms": ms, "host_ms": host_ms, "img_s": img_s}

    def op_profile(cmd):
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        step, x = infer()
        for _ in range(WARMUP):
            step(x)
        before = slot().launches
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            step(x)
            torch.cuda.synchronize()
        after = slot().launches
        kernels = sum(1 for e in prof.events()
                      if e.device_type == DeviceType.CUDA
                      and not e.name.startswith(("Memcpy", "Memset")))
        return {"region_launches": after - before,
                "profiler_kernels": kernels}

    def timed(fn, seconds):
        """fn() then a synchronisation, over and over for ``seconds``:
        (calls, wall s, the slot's launches and launch_ns over them)"""
        fn()
        torch.cuda.synchronize()
        first = slot() if enf.interposed else None
        n, t0 = 0, time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            fn()
            torch.cuda.synchronize()
            n += 1
        wall = time.perf_counter() - t0
        res = {"calls": n, "wall_s": wall}
        if first is not None:
            last = slot()
            res.update(launches=last.launches - first.launches,
                       launch_ns=last.launch_ns - first.launch_ns)
        return res

    def op_run(cmd):
        step, x = infer()
        for _ in range(WARMUP):
            step(x)
        res = timed(lambda: step(x), cmd["seconds"])
        res["img_s"] = res["calls"] * CASES["1.1"].batch / res["wall_s"]
        return res

    def op_graph(cmd):
        step, x = infer()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(WARMUP):
                step(x)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = step(x)
        ref = step(x)
        graph.replay()
        torch.cuda.synchronize()
        drift = rel_l2(out, ref)
        res = timed(graph.replay, cmd["seconds"])
        res.update(replays_s=res["calls"] / res["wall_s"],
                   replay_vs_eager_rel_l2=drift)
        return res

    def op_step(cmd):
        step, x = infer()
        try:
            out = step(x)
            torch.cuda.synchronize()
        except RuntimeError as e:
            return {"raised": str(e).splitlines()[0]}
        return {"finite": bool(torch.isfinite(out).all())}

    def op_host(cmd):
        res = {}
        pinned = []
        while (len(pinned) + 1) * PINNED <= HOST_LIMIT:
            pinned.append(torch.empty(PINNED, dtype=torch.uint8,
                                      pin_memory=True))
        res["pinned"] = len(pinned) * PINNED
        res["charged"] = enf.host_used()
        try:
            torch.empty(PINNED, dtype=torch.uint8, pin_memory=True)
            res["past_limit"] = "allocated"
        except RuntimeError as e:
            res["past_limit"] = str(e).splitlines()[0]
        # one pinned tensor less: the process runs on and pins again
        pinned.pop()
        torch._C._host_emptyCache()
        res["after_release"] = enf.host_used()
        small = torch.ones(1 << 20).pin_memory()
        res["runs_on"] = bool(small.cuda().sum().item() == (1 << 20))
        plain = torch.empty(REGISTERED, dtype=torch.uint8)
        cudart = torch.cuda.cudart()
        before = enf.host_used()
        check(int(cudart.cudaHostRegister(plain.data_ptr(), REGISTERED,
                                          0)) == 0, "cudaHostRegister")
        res["registered"] = enf.host_used() - before
        check(int(cudart.cudaHostUnregister(plain.data_ptr())) == 0,
              "cudaHostUnregister")
        res["unregistered"] = enf.host_used() - before
        return res

    def op_quota(cmd):
        """the quota as the process sees it, with the model and a step's
        memory charged; then one allocation of the whole quota, which
        cannot fit, and a step after it"""
        step, x = infer()
        step(x)
        torch.cuda.synchronize()
        free, total = torch.cuda.mem_get_info()
        try:
            torch.empty(total, dtype=torch.uint8, device="cuda")
            refused = None
        except torch.OutOfMemoryError as e:
            refused = ". ".join(str(e).split(". ")[:2])
        out = step(x)
        torch.cuda.synchronize()
        return {"total": total, "free": free, "refused": refused,
                "finite_after": bool(torch.isfinite(out).all()),
                "pid": os.getpid()}

    def op_mem(cmd):
        torch.cuda.synchronize()
        return {"reserved": torch.cuda.memory_reserved(), "pid": os.getpid()}

    ops = {"time": op_time, "profile": op_profile, "run": op_run,
           "graph": op_graph, "step": op_step, "host": op_host,
           "quota": op_quota, "mem": op_mem}
    for line in sys.stdin:
        cmd = json.loads(line)
        try:
            reply = ops[cmd["op"]](cmd)
        except Exception as e:  # reported to the parent, which fails
            reply = {"error": f"{type(e).__name__}: {e}"}
        print(json.dumps(reply), flush=True)


def compute_phases(name: str) -> list:
    """Phases (a)-(h) of the compute plane; see the module docstring."""
    children = {}
    phases = []

    def start(label, **kw):
        children[label] = SmChild(label, **kw)
        return children[label]

    try:
        alone = start("alone", interposed=False)
        free = start("no SM limit")
        full = start("SM limit 100", sm_limit=100)
        half = start("SM limit 50", sm_limit=50)
        hi = start("SM limit 70", sm_limit=70)
        lo = start("SM limit 30", sm_limit=30, priority=1)
        host = start("host limit", host_limit=HOST_LIMIT)

        # (b) unthrottled cost, then (a) launch visibility
        times = {}
        for case_name in ("1.1", "1.2"):
            for child in (alone, free, full):
                times[case_name, child.label] = child.ask(
                    "time", case=case_name)
        cost = {}
        for case_name in ("1.1", "1.2"):
            base = times[case_name, "alone"]["ms"]
            res = {"phase": f"(b) case {case_name} unthrottled cost"}
            for child in (alone, free, full):
                ms = times[case_name, child.label]["ms"]
                res[child.label] = ms
                res[f"{child.label} vs alone"] = ms / base - 1
            print(f"(b) case {case_name} ms/step (CUDA events, "
                  f"{STEPS[case_name]} steps): alone {base:.3f}; under "
                  f"libvgpu.so with no SM limit "
                  f"{res['no SM limit']:.3f} "
                  f"({res['no SM limit vs alone']:+.2%}), at 100 "
                  f"{res['SM limit 100']:.3f} "
                  f"({res['SM limit 100 vs alone']:+.2%}); on {name}",
                  flush=True)
            phases.append(res)
            cost[case_name] = res
        for label in ("no SM limit", "SM limit 100"):
            slower = cost["1.1"][f"{label} vs alone"]
            check(slower <= UNTHROTTLED_COST, f"(b) case 1.1 under "
                  f"libvgpu.so ({label}) {slower:+.2%} slower than alone")
        seen = free.ask("profile")
        print(f"(a) case 1.1, one step under libvgpu.so: "
              f"{seen['region_launches']} launches in the region, "
              f"{seen['profiler_kernels']} kernels traced by torch.profiler;"
              f" on {name}", flush=True)
        check(seen["region_launches"] >= seen["profiler_kernels"] > 0,
              "(a) launches escaped the interposer")
        phases.append(dict(seen, phase="(a) launch visibility"))

        # the unthrottled references, then (c) and (e) at 50%
        ref = free.ask("run", seconds=REF_RUN_S)
        ref_graph = free.ask("graph", seconds=GRAPH_RUN_S)
        solo = ref["img_s"]
        step_ms = times["1.1", "no SM limit"]["ms"]
        run = half.ask("run", seconds=SM_RUN_S)
        share = run["img_s"] / solo
        debit = run["launch_ns"] / 1e6 / (run["calls"] * step_ms)
        print(f"(c) case 1.1 at a 50% SM limit for {run['wall_s']:.1f} s: "
              f"{run['img_s']:.1f} img/s, {share:.3f}x the unthrottled "
              f"{solo:.1f} img/s; debited device time "
              f"{run['launch_ns'] / 1e6 / run['calls']:.3f} ms/step, "
              f"{debit:.3f}x the unthrottled CUDA-event step of "
              f"{step_ms:.3f} ms; on {name}", flush=True)
        phases.append({"phase": "(c) case 1.1 at 50%", "img_s": run["img_s"],
                       "unthrottled_img_s": solo, "share": share,
                       "debit_vs_event_time": debit, **run})
        check(0.40 <= share <= 0.60, f"(c) 50% ran at {share:.3f}x")
        check(0.8 <= debit <= 1.1, f"(c) debited {debit:.3f}x the step time")
        g = half.ask("graph", seconds=GRAPH_RUN_S)
        gshare = g["replays_s"] / ref_graph["replays_s"]
        print(f"(e) case 1.1 captured as a CUDA graph: replays at a 50% SM "
              f"limit {g['replays_s']:.2f}/s, {gshare:.3f}x the unthrottled "
              f"{ref_graph['replays_s']:.2f}/s; replay vs eager logits rel "
              f"L2 {g['replay_vs_eager_rel_l2']:.3e}; charged "
              f"{g['launch_ns'] / 1e6 / g['calls']:.3f} ms/replay over "
              f"{g['launches']} launches; on {name}", flush=True)
        phases.append({"phase": "(e) graph replay at 50%", "share": gshare,
                       "unthrottled_replays_s": ref_graph["replays_s"], **g})
        check(0.40 <= gshare <= 0.60, f"(e) 50% replays at {gshare:.3f}x")
        check(g["replay_vs_eager_rel_l2"] <= BF16_REL, "(e) replay logits")

        # (g) the gate
        ok = half.ask("step")
        with half.view() as view:
            gated = view.pressure()["near_limit_failures"]
            _, applied = view.set_limit_checked(1)
            refused = half.ask("step")
            gated = view.pressure()["near_limit_failures"] - gated
            view.set_limit_checked(INFER_QUOTA)
        again = half.ask("step")
        print(f"(g) limit lowered to the usage ({applied} B): the next step "
              f"raised \"{refused.get('raised')}\" after {gated} refused "
              f"launch(es); restored, the step ran (finite logits "
              f"{again.get('finite')}); on {name}", flush=True)
        phases.append({"phase": "(g) gate", "lowered_to": applied,
                       "raised": refused.get("raised"),
                       "gate_refusals": gated,
                       "finite_after": again.get("finite")})
        check(ok.get("finite") is True, "(g) step before the gate")
        check("out of memory" in refused.get("raised", "") and gated >= 1,
              f"(g) step past the lowered limit: {refused}, {gated} gate "
              f"refusals")
        check(again.get("finite") is True, "(g) step after the restore")

        # (d) two tenants at once
        for child in (hi, lo):
            child.send("run", seconds=SM_RUN_S)
        pair = {child.label: child.read() for child in (hi, lo)}
        r70, r30 = (pair[c.label]["img_s"] for c in (hi, lo))
        c70, c30 = (pair[c.label]["launch_ns"] / 1e9 / pair[c.label]["wall_s"]
                    for c in (hi, lo))
        ratio = r70 / r30
        print(f"(d) two case 1.1 tenants at once for {SM_RUN_S:.0f} s: 70% "
              f"{r70:.1f} img/s ({r70 / solo:.3f}x solo, charged {c70:.3f} "
              f"of wall time), 30% {r30:.1f} img/s ({r30 / solo:.3f}x solo, "
              f"charged {c30:.3f}), ratio {ratio:.3f}; on {name}",
              flush=True)
        phases.append({"phase": "(d) 70/30 pair", "img_s_70": r70,
                       "img_s_30": r30, "ratio": ratio, "solo_img_s": solo,
                       "charged_share_70": c70, "charged_share_30": c30})
        check(1.7 < ratio < 3.2, f"(d) ratio {ratio:.3f}")
        check(r70 < 0.9 * solo and r30 < 0.55 * solo, "(d) shares")
        # what the card gives two contexts with no limit: the pair's
        # reference (printed, not gated)
        for child in (free, full):
            child.send("run", seconds=REF_RUN_S)
        both = [child.read()["img_s"] / solo for child in (free, full)]
        print(f"(d) two case 1.1 pods with no SM limit at once for "
              f"{REF_RUN_S:.0f} s: {both[0]:.3f}x and {both[1]:.3f}x solo, "
              f"{sum(both):.3f} of one card together; on {name}", flush=True)
        phases[-1]["unlimited_pair_shares"] = both

        # (f) feedback on the 30% tenant (priority 1)
        with lo.view() as view:
            lo.send("run", seconds=3 * BLOCK_S)
            time.sleep(BLOCK_S / 2)
            view.set_recent_kernel(FEEDBACK_BLOCK)
            time.sleep(0.3)
            held = view.total_launches()
            time.sleep(BLOCK_S)
            still = view.total_launches()
            view.set_recent_kernel(FEEDBACK_IDLE)
            lo.read()
            resumed = view.total_launches()
            spins = view.pressure()["contention_spins"]
            limited = lo.ask("run", seconds=SWITCH_RUN_S)["img_s"]
            view.set_utilization_switch(1)
            lifted = lo.ask("run", seconds=SWITCH_RUN_S)["img_s"]
            view.set_utilization_switch(0)
        print(f"(f) priority-1 tenant blocked for {BLOCK_S:.1f} s: region "
              f"launches {held} -> {still} while blocked, {resumed} after; "
              f"{spins} contention spins; at 30% {limited:.1f} img/s, with "
              f"utilization_switch=1 {lifted:.1f} img/s "
              f"({lifted / solo:.3f}x solo); on {name}", flush=True)
        phases.append({"phase": "(f) feedback", "held": held,
                       "still": still, "resumed": resumed,
                       "img_s_30": limited, "img_s_switch": lifted})
        check(still == held and resumed > still, "(f) block did not hold")
        check(limited < 0.55 * solo and lifted > 0.8 * solo,
              "(f) utilization_switch did not lift the throttle")

        # (h) the host ledger
        h = host.ask("host")
        print(f"(h) {h['pinned']} B pinned under a {HOST_LIMIT} B host "
              f"limit, {h['charged']} B charged; one more raised "
              f"\"{h['past_limit']}\"; {h['after_release']} B charged "
              f"after one was released; cudaHostRegister charged "
              f"{h['registered']} B, unregister left {h['unregistered']} B; "
              f"on {name}", flush=True)
        phases.append(dict(h, phase="(h) host ledger"))
        check(h["charged"] == h["pinned"] == HOST_LIMIT // PINNED * PINNED,
              "(h) pinned memory not charged")
        check("out of memory" in h["past_limit"], "(h) past the limit")
        check(h["after_release"] == h["pinned"] - PINNED and h["runs_on"],
              "(h) release")
        check(h["registered"] == REGISTERED and h["unregistered"] == 0,
              "(h) register")
        for label in list(children):
            children.pop(label).close()
    finally:
        for child in children.values():
            if child.proc.poll() is None:
                child.proc.kill()
                child.proc.wait(timeout=60)
            child.errf.close()
            shutil.rmtree(child.tmp, ignore_errors=True)
    return phases


# ------------------------------------------------------ (i) the node agent.
# The device plugin runs in its own process, started through its entry
# point with an in-memory apiserver (FakeKubeClient) that this script reads
# and writes through the child's stdin/stdout (one JSON command and reply
# per line). The child imports vtpu_torch's plugin only: no torch.

PLUGIN_CHILD = r"""
import json, os, signal, sys, threading, time
from vtpu_torch.plugin.__main__ import main
from vtpu_torch.plugin.nvml import NvmlLib
from vtpu_torch.util.client import FakeKubeClient

node, sock_dir, shim_dir, split = sys.argv[1:5]
# NVML's cost in a process that never initialised CUDA, as the plugin's
t0 = time.perf_counter()
lib = NvmlLib()
t1 = time.perf_counter()
lib.enumerate()
t2 = time.perf_counter()
lib.close()
cold = {"init_ms": (t1 - t0) * 1e3, "enumerate_ms": (t2 - t1) * 1e3}
client = FakeKubeClient()
client.add_node(node)
out = sys.stdout
sys.stdout = sys.stderr  # the replies own the real stdout


def serve():
    for line in sys.stdin:
        cmd = json.loads(line)
        op = cmd["op"]
        if op == "stop":
            os.kill(os.getpid(), signal.SIGINT)
            return
        if op == "add_pod":
            reply = client.add_pod(cmd["pod"])
        elif op == "get_pod":
            reply = client.get_pod("default", cmd["name"])
        elif op == "get_node":
            reply = client.get_node(node)
        elif op == "patch_node":
            reply = client.patch_node_annotations(node, cmd["annos"])
        elif op == "nvml":
            reply = cold
        else:
            reply = {"modules": sorted(
                m for m in sys.modules
                if m.split(".")[0] in ("torch", "jax", "vtpu"))}
        out.write(json.dumps(reply) + "\n")
        out.flush()


threading.Thread(target=serve, daemon=True).start()
main(["--node-name", node, "--socket-dir", sock_dir, "--shim-host-dir",
      shim_dir, "--health-port", "-1", "--node-config-file", os.devnull,
      "--device-split-count", split, "-v"], client=client)
print("stopped", file=out, flush=True)
"""

NODE_NAME = "smoke-gpu-node"
SPLIT = 10                   # device_split_count, the plugin's default
NODE_QUOTA_MB = 12288        # (i): the pod's gpumem ...
NODE_SM_LIMIT = 50           # ... and gpucores
# a CUDA context holds ~0.6 GB of the card (PERF.md); the plugin process
# must not move the card's used memory by a fraction of that
CONTEXT_MARGIN_MB = 256


def smi(query: str) -> list:
    """One ``nvidia-smi --query-gpu`` field per card (no units)."""
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader,"
         "nounits"], check=True, capture_output=True, text=True,
        timeout=60).stdout
    return [line.strip() for line in out.strip().splitlines()]


def compute_apps() -> int:
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return len([line for line in out.splitlines() if line.strip()])


class PluginChild:
    """The device plugin process and its in-memory apiserver."""

    def __init__(self, tmp: str):
        self.sock_dir = os.path.join(tmp, "device-plugins")
        self.shim_dir = os.path.join(tmp, "vgpu")
        os.makedirs(self.sock_dir)
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("CUDA_", "LD_PRELOAD", "VGPU_"))}
        env["PYTHONPATH"] = ROOT
        self.errf = open(os.path.join(tmp, "plugin.err"), "w+")
        self.proc = subprocess.Popen(
            [sys.executable, "-c", PLUGIN_CHILD, NODE_NAME, self.sock_dir,
             self.shim_dir, str(SPLIT)],
            env=env, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=self.errf, text=True)

    def err(self) -> str:
        self.errf.seek(0)
        return self.errf.read()[-4000:]

    def ask(self, op: str, **args):
        self.proc.stdin.write(json.dumps(dict(args, op=op)) + "\n")
        self.proc.stdin.flush()
        ready, _, _ = select.select([self.proc.stdout], [], [], 60)
        line = self.proc.stdout.readline() if ready else ""
        if not line:
            raise SmokeFailure(f"plugin child gave no answer to {op}, rc "
                               f"{self.proc.poll()}:\n{self.err()}")
        return json.loads(line)

    def stop(self) -> str:
        try:
            self.proc.stdin.write(json.dumps({"op": "stop"}) + "\n")
            self.proc.stdin.flush()
            out, _ = self.proc.communicate(timeout=60)
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.wait(timeout=60)
        check(self.proc.returncode == 0 and out.strip() == "stopped",
              f"plugin child rc {self.proc.returncode}:\n{self.err()}")
        return out


def node_agent_phase(name: str, solo_img_s: float,
                     step_ms: float) -> list:
    """Phase (i): the device plugin enumerates the card through NVML,
    advertises its replicas to a fake kubelet, reports the inventory, and
    answers Allocate for a pod the script assigns as the scheduler would;
    a case 1.1 child started with that response's env alone runs under
    libvgpu.so at the granted quota and SM limit. Then phase (j), the node
    monitor, over the same plugin's pods."""
    import grpc

    from vtpu_torch import api
    from vtpu_torch.plugin import deviceplugin_pb2 as pb
    from vtpu_torch.plugin import dp_grpc, runtime
    from vtpu_torch.plugin.nvml import NvmlLib
    from vtpu_torch.plugin.rm import replica_id
    from vtpu_torch.util import codec, nodelock, podutil, types

    # enumeration, in this process, against torch and nvidia-smi
    start = t0 = time.perf_counter()
    nvml = NvmlLib()
    t1 = time.perf_counter()
    chips = nvml.enumerate()
    t2 = time.perf_counter()
    nvml.close()
    init_ms, enum_ms = (t1 - t0) * 1e3, (t2 - t1) * 1e3
    check(len(chips) == torch.cuda.device_count() >= 1,
          f"NVML sees {len(chips)} cards, torch "
          f"{torch.cuda.device_count()}")
    smi_mib, smi_uuid = smi("memory.total"), smi("uuid")
    for i, chip in enumerate(chips):
        props = torch.cuda.get_device_properties(i)
        torch_uuid = "GPU-" + str(props.uuid)
        check(chip.type == "NVIDIA-" + torch.cuda.get_device_name(i),
              f"card {i}: NVML type {chip.type!r}, torch name "
              f"{torch.cuda.get_device_name(i)!r}")
        check(chip.hbm_mb == int(smi_mib[i]), f"card {i}: NVML "
              f"{chip.hbm_mb} MiB, nvidia-smi {smi_mib[i]}")
        check(chip.uuid == smi_uuid[i], f"card {i}: NVML uuid {chip.uuid}, "
              f"nvidia-smi {smi_uuid[i]}")
        check(chip.uuid == torch_uuid, f"card {i}: NVML uuid {chip.uuid}, "
              f"torch {torch_uuid}")
        for path in chip.device_paths + ["/dev/nvidiactl",
                                         "/dev/nvidia-uvm"]:
            check(os.path.exists(path), f"{path} missing")
    cards = "; ".join(
        f"{c.type}, {c.hbm_mb} MiB, {c.device_paths[0]}, NUMA {c.numa}, "
        f"uuid {c.uuid}, as torch's and nvidia-smi's" for c in chips)
    print(f"(i) NVML in this process (CUDA initialised): {len(chips)} "
          f"card(s) in {enum_ms:.3f} ms (nvmlInit_v2 and binding "
          f"{init_ms:.3f} ms): {cards}; on {name}", flush=True)

    tmp = tempfile.mkdtemp(prefix="vgpu-smoke-node-")
    registered = []

    class FakeKubelet(dp_grpc.RegistrationServicer):
        def Register(self, request, context):
            registered.append(request)
            return pb.Empty()

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    used0, apps0 = int(smi("memory.used")[0]), compute_apps()
    kubelet = None
    plugin = None
    workload = None
    try:
        plugin = PluginChild(tmp)
        kubelet = grpc.server(futures.ThreadPoolExecutor(max_workers=2))
        dp_grpc.add_registration_servicer(kubelet, FakeKubelet())
        kubelet.add_insecure_port(
            f"unix://{plugin.sock_dir}/{dp_grpc.KUBELET_SOCKET}")
        kubelet.start()
        deadline = time.monotonic() + 120
        annos = {}
        while time.monotonic() < deadline and not (
                registered and api.NODE_REGISTER_ANNO in annos):
            time.sleep(0.1)
            annos = plugin.ask("get_node")["metadata"]["annotations"]
        check(bool(registered), f"no Register from the plugin:\n"
              f"{plugin.err()}")
        check(registered[0].resource_name == api.RESOURCE_GPU,
              f"registered {registered[0].resource_name}")
        sock = f"unix://{plugin.sock_dir}/{registered[0].endpoint}"

        # advertisement
        with grpc.insecure_channel(sock) as ch:
            first = next(dp_grpc.DevicePluginStub(ch).ListAndWatch(
                pb.Empty(), timeout=30))
        ids = sorted(d.ID for d in first.devices)
        check(ids == sorted(replica_id(c.uuid, r) for c in chips
                            for r in range(SPLIT)), f"ListAndWatch {ids}")
        check(all(d.health == "Healthy" for d in first.devices),
              "an unhealthy replica")
        inventory = codec.decode_node_devices(annos[api.NODE_REGISTER_ANNO])
        check([(d.id, d.count, d.devmem, d.devcore, d.type, d.health)
               for d in inventory] ==
              [(c.uuid, SPLIT, c.hbm_mb, 100, c.type, True) for c in chips],
              f"register annotation {annos[api.NODE_REGISTER_ANNO]}")

        # the assignment the scheduler's filter and bind would leave
        grant = types.ContainerDevice(uuid=chips[0].uuid,
                                      usedmem=NODE_QUOTA_MB,
                                      usedcores=NODE_SM_LIMIT)
        pod_annos = podutil.device_annotations(NODE_NAME, [[grant]])
        pod_annos[api.BIND_PHASE_ANNO] = types.BindPhase.ALLOCATING.value
        pod_annos[api.BIND_TIME_ANNO] = str(time.time_ns())
        plugin.ask("add_pod", pod={
            "metadata": {"name": "smoke-pod", "namespace": "default",
                         "uid": "smoke-uid", "annotations": pod_annos},
            "spec": {"nodeName": NODE_NAME, "containers": [{
                "name": "main", "resources": {"limits": {
                    api.RESOURCE_GPU: 1, api.RESOURCE_MEM: NODE_QUOTA_MB,
                    api.RESOURCE_CORES: NODE_SM_LIMIT}}}]},
            "status": {"phase": "Pending"}})
        plugin.ask("patch_node", annos={api.NODE_LOCK_ANNO:
                                        nodelock.now_str()})

        # Allocate, as kubelet calls it
        with grpc.insecure_channel(sock) as ch:
            stub = dp_grpc.DevicePluginStub(ch)
            t0 = time.perf_counter()
            resp = stub.Allocate(pb.AllocateRequest(container_requests=[
                pb.ContainerAllocateRequest(
                    devicesIDs=[replica_id(chips[0].uuid, 0)])]))
            alloc_ms = (time.perf_counter() - t0) * 1e3
        phase = plugin.ask("get_pod", name="smoke-pod")["metadata"][
            "annotations"][api.BIND_PHASE_ANNO]
        locked = api.NODE_LOCK_ANNO in plugin.ask("get_node")["metadata"][
            "annotations"]
        check(phase == "success" and not locked,
              f"after Allocate: bind-phase {phase}, node locked {locked}")
        (ctr,) = resp.container_responses
        print(f"(i) Allocate over the plugin's socket: {alloc_ms:.3f} ms; "
              f"bind-phase {phase}, node lock released; response env "
              f"{dict(sorted(ctr.envs.items()))}, "
              f"{len(ctr.mounts)} mounts, device nodes "
              f"{sorted(d.host_path for d in ctr.devices)}; on {name}",
              flush=True)

        # the plugin process holds no CUDA context: it imported no torch,
        # and the card's used memory and compute processes did not move
        # (NVML itself maps libcuda.so at nvmlInit_v2 with this driver, so
        # a mapping is no evidence of a context)
        modules = plugin.ask("modules")["modules"]
        cold = plugin.ask("nvml")
        with open(f"/proc/{plugin.proc.pid}/maps") as f:
            libcuda = sorted({line.split()[-1] for line in f
                              if "libcuda" in line})
        used1, apps1 = int(smi("memory.used")[0]), compute_apps()
        print(f"(i) plugin process: NVML without CUDA in the process: "
              f"nvmlInit_v2 and binding {cold['init_ms']:.3f} ms, "
              f"enumeration {cold['enumerate_ms']:.3f} ms; modules of "
              f"torch/jax/vtpu {modules}; "
              f"card memory used {used0} -> {used1} MiB, compute "
              f"processes {apps0} -> {apps1}; libcuda mapped "
              f"{libcuda or 'no'}; on {name}", flush=True)
        check(modules == [], f"the plugin imported {modules}")
        check(used1 - used0 < CONTEXT_MARGIN_MB and apps1 == apps0,
              "the plugin process took device memory or a context")

        # the workload: a case 1.1 child with only the response's env and
        # mounts applied (runtime.process_env: the host paths of the
        # libvgpu.so and region mounts, CUDA_VISIBLE_DEVICES =
        # NVIDIA_VISIBLE_DEVICES), over this machine's own environment
        # with every CUDA_/NVIDIA_/LD_PRELOAD key of it removed. Nothing
        # else is set by hand.
        env = {k: v for k, v in os.environ.items() if not k.startswith(
            ("CUDA_", "NVIDIA_", "LD_PRELOAD", "PYTORCH_CUDA_ALLOC_CONF"))}
        env["PYTHONPATH"] = ROOT
        env.update(runtime.process_env(ctr))
        cache = env[api.ENV_SHARED_CACHE]
        check(env["LD_PRELOAD"] == os.path.join(plugin.shim_dir,
                                                "libvgpu.so"),
              f"LD_PRELOAD {env.get('LD_PRELOAD')}")
        workload = SmChild("(i) Allocate's pod", given=(env, cache))
        q = workload.ask("quota")
        run = workload.ask("run", seconds=SM_RUN_S)
        share = run["img_s"] / solo_img_s
        with workload.view() as view:
            limit, core = view.hbm_limit(0), view.core_limit(0)
            pids = [p.pid for p in view.procs()]
        print(f"(i) case 1.1 started from the response alone: "
              f"mem_get_info total {q['total']} B; past it "
              f"\"{q['refused']}\", then the step ran (finite "
              f"{q['finite_after']}); {run['img_s']:.1f} img/s for "
              f"{run['wall_s']:.1f} s, {share:.3f}x the unthrottled "
              f"{solo_img_s:.1f}; region at {cache}: limit {limit} B, SM "
              f"limit {core}, slots {pids}; on {name}", flush=True)
        check(q["total"] == NODE_QUOTA_MB * MiB,
              f"mem_get_info total {q['total']}")
        check(q["refused"] is not None and q["finite_after"],
              "(i) allocation past the quota")
        check(0.40 <= share <= 0.60, f"(i) ran at {share:.3f}x")
        check(limit == NODE_QUOTA_MB * MiB and core == NODE_SM_LIMIT
              and pids == [q["pid"]], "(i) region")
        workload.close()   # checks the region is clean after the exit
        workload = None
        took = time.perf_counter() - start
        # the exited pod's region directory goes, as the monitor's GC
        # removes it 300 s after the pod is deleted
        shutil.rmtree(os.path.dirname(cache))
        monitor = monitor_phase(name, solo_img_s, step_ms, plugin, sock,
                                chips[0], tmp)
        plugin.stop()
        plugin = None
    finally:
        if workload is not None and workload.proc.poll() is None:
            workload.proc.kill()
            workload.proc.wait(timeout=60)
        if plugin is not None and plugin.proc.poll() is None:
            plugin.proc.kill()
            plugin.proc.wait(timeout=60)
        if kubelet is not None:
            kubelet.stop(0)
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"(i) the node-agent phase took {took:.1f} s; on {name}",
          flush=True)
    return [{"phase": "(i) node agent", "cards": len(chips),
            "nvml_init_ms": init_ms, "nvml_enumerate_ms": enum_ms,
            "plugin_nvml_init_ms": cold["init_ms"],
            "plugin_nvml_enumerate_ms": cold["enumerate_ms"],
            "phase_s": took,
            "allocate_ms": alloc_ms,
            "quota_bytes": q["total"], "img_s": run["img_s"],
            "unthrottled_img_s": solo_img_s, "share": share,
            "plugin_used_mib_delta": used1 - used0,
            "plugin_libcuda_mapped": bool(libcuda)}, monitor]


# ------------------------------------------------------ (j) the node monitor.
# The monitor runs in its own process through its entry point
# (vtpu_torch.monitor.__main__.main) with an in-memory apiserver this script
# writes through the child's stdin/stdout, over phase (i)'s plugin's
# containers directory. It holds no CUDA context: NVML only.

MONITOR_CHILD = r"""
import json, os, signal, sys, threading, time
from vtpu_torch.monitor import daemon
from vtpu_torch.monitor.__main__ import main
from vtpu_torch.util.client import FakeKubeClient

node, containers, metrics_port, info_port = sys.argv[1:5]
# each sweep's latency, for the report (the histogram's buckets are coarse)
sweeps = []
sweep_once = daemon.MonitorDaemon.sweep_once


def timed(self):
    t0 = time.perf_counter()
    sweep_once(self)
    sweeps.append(time.perf_counter() - t0)


daemon.MonitorDaemon.sweep_once = timed
client = FakeKubeClient()
client.add_node(node)
out = sys.stdout
sys.stdout = sys.stderr


def serve():
    for line in sys.stdin:
        cmd = json.loads(line)
        op = cmd["op"]
        if op == "stop":
            os.kill(os.getpid(), signal.SIGINT)
            return
        if op == "add_pod":
            reply = client.add_pod(cmd["pod"])
        elif op == "delete_pod":
            client.delete_pod("default", cmd["name"])
            reply = {}
        elif op == "sweeps":
            reply = {"sweeps": list(sweeps)}
        else:
            reply = {"modules": sorted(
                m for m in sys.modules
                if m.split(".")[0] in ("torch", "jax", "vtpu"))}
        out.write(json.dumps(reply) + "\n")
        out.flush()


threading.Thread(target=serve, daemon=True).start()
main(["--containers-dir", containers, "--node-name", node,
      "--sweep-interval", "1", "--metrics-port", metrics_port,
      "--info-port", info_port], client=client)
print("stopped", file=out, flush=True)
"""

SWEEP_S = 1.0          # the monitor's sweep interval in (j)
SWEEPS_TO_ACT = 3      # what the monitor must do, it does within 3 sweeps
UTIL_WINDOW_S = 10.0   # two scrapes this far apart give HostCoreUtilization
MONITOR_PHASE_S = 120.0


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class MonitorChild:
    """The node monitor process and its in-memory apiserver."""

    def __init__(self, tmp: str, containers: str):
        self.metrics_port, self.info_port = free_port(), free_port()
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("CUDA_", "LD_PRELOAD", "VGPU_"))}
        env["PYTHONPATH"] = ROOT
        self.errf = open(os.path.join(tmp, "monitor.err"), "w+")
        self.proc = subprocess.Popen(
            [sys.executable, "-c", MONITOR_CHILD, NODE_NAME, containers,
             str(self.metrics_port), str(self.info_port)],
            env=env, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=self.errf, text=True)

    def err(self) -> str:
        self.errf.seek(0)
        return self.errf.read()[-4000:]

    def ask(self, op: str, **args):
        self.proc.stdin.write(json.dumps(dict(args, op=op)) + "\n")
        self.proc.stdin.flush()
        ready, _, _ = select.select([self.proc.stdout], [], [], 60)
        line = self.proc.stdout.readline() if ready else ""
        if not line:
            raise SmokeFailure(f"monitor child gave no answer to {op}, rc "
                               f"{self.proc.poll()}:\n{self.err()}")
        return json.loads(line)

    def get(self, port: int, path: str) -> bytes:
        import urllib.request

        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=10) as resp:
            return resp.read()

    def wait_ready(self, timeout_s: float = 60.0) -> None:
        import urllib.error

        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            try:
                self.get(self.info_port, "/healthz")
                self.get(self.metrics_port, "/metrics")
                return
            except (urllib.error.URLError, ConnectionError, OSError):
                check(self.proc.poll() is None,
                      f"monitor child exited:\n{self.err()}")
                time.sleep(0.2)
        raise SmokeFailure(f"monitor not serving:\n{self.err()}")

    def scrape(self) -> dict:
        """family -> {frozenset(labels): value}, one GET /metrics"""
        from prometheus_client.parser import text_string_to_metric_families

        text = self.get(self.metrics_port, "/metrics").decode()
        return {f.name: {frozenset(s.labels.items()): s.value
                         for s in f.samples}
                for f in text_string_to_metric_families(text)}

    def nodeinfo(self) -> dict:
        return json.loads(self.get(self.info_port, "/nodeinfo"))

    def stop(self) -> None:
        try:
            self.proc.stdin.write(json.dumps({"op": "stop"}) + "\n")
            self.proc.stdin.flush()
            out, _ = self.proc.communicate(timeout=60)
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.wait(timeout=60)
        check(self.proc.returncode == 0 and out.strip() == "stopped",
              f"monitor child rc {self.proc.returncode}:\n{self.err()}")


def card_gauge(fams: dict, family: str, uuid: str) -> float:
    (value,) = [v for labels, v in fams[family].items()
                if dict(labels)["deviceuuid"] == uuid]
    return value


def pod_gauge(fams: dict, family: str, uid: str) -> float:
    (value,) = [v for labels, v in fams[family].items()
                if dict(labels)["poduid"] == uid]
    return value


def nvml_utilization(uuid: str):
    """NVML's own utilization of the card, in percent (printed beside
    HostCoreUtilization, not gated)."""
    import ctypes

    from vtpu_torch.plugin.nvml import NvmlLib

    class Rates(ctypes.Structure):
        _fields_ = [("gpu", ctypes.c_uint), ("memory", ctypes.c_uint)]

    lib = NvmlLib()
    try:
        lib.enumerate()
        rates = Rates()
        rc = lib._lib.nvmlDeviceGetUtilizationRates(
            ctypes.c_void_p(lib.handle(uuid)), ctypes.byref(rates))
        return rates.gpu if rc == 0 else f"NVML error {rc}"
    finally:
        lib.close()


def monitor_phase(name: str, solo_img_s: float, step_ms: float, plugin,
                  sock: str, chip, tmp: str) -> dict:
    """Phase (j): the node monitor over phase (i)'s plugin. Pods are case
    1.1 --sm-children started from Allocate responses (gpumem 12288 MiB);
    the monitor writes their feedback plane, exports the reference's
    families and serves /nodeinfo. Steps:

    1. pod H alone (priority 0, gpucores 50): released within 3 sweeps and
       runs at >= 0.8x unthrottled; the memory gauges; HostCoreUtilization
       over two scrapes 10 s apart within 0.8-1.1x H's busy share (its
       CUDA-event step time over wall time);
    2. pod U with no gpucores alone: the same utilization bound (busy time
       is charged on a card with no SM limit);
    3. pod L (priority 1, gpucores 50) joins while H runs: both throttled
       and L blocked within 3 sweeps; L's launches stand still for 5 s and
       H runs at 0.40-0.60x;
    4. H exits: L unblocked within 3 sweeps; once H's directory is gone,
       released and at >= 0.8x;
    5. pod F alone under GPU_CORE_UTILIZATION_POLICY=force: never released,
       0.40-0.60x;
    6. the monitor's /nodeinfo, sweep latency, no context and no device
       memory; every region clean after its pod exits; under 120 s."""
    import grpc

    from vtpu_torch import api
    from vtpu_torch.plugin import deviceplugin_pb2 as pb
    from vtpu_torch.plugin import dp_grpc, runtime
    from vtpu_torch.plugin.rm import replica_id
    from vtpu_torch.util import nodelock, podutil, types

    start = time.perf_counter()
    containers = os.path.join(plugin.shim_dir, "containers")
    quota = NODE_QUOTA_MB * MiB
    pods = {}
    replicas = iter(range(1, SPLIT))

    def allocate(label: str, cores: int, **env_extra) -> SmChild:
        """The pod, assigned as the scheduler would, allocated over the
        plugin's socket and started from the response (its container env
        adds only CUDA_TASK_PRIORITY and the policy, as a pod spec's
        would)."""
        pod_name, uid = f"smoke-{label.lower()}", f"smoke-uid-{label}"
        grant = types.ContainerDevice(uuid=chip.uuid, usedmem=NODE_QUOTA_MB,
                                      usedcores=cores)
        annos = podutil.device_annotations(NODE_NAME, [[grant]])
        annos[api.BIND_PHASE_ANNO] = types.BindPhase.ALLOCATING.value
        annos[api.BIND_TIME_ANNO] = str(time.time_ns())
        pod = {"metadata": {"name": pod_name, "namespace": "default",
                            "uid": uid, "annotations": annos},
               "spec": {"nodeName": NODE_NAME, "containers": [{
                   "name": "main", "resources": {"limits": {
                       api.RESOURCE_GPU: 1, api.RESOURCE_MEM: NODE_QUOTA_MB,
                       api.RESOURCE_CORES: cores}}}]},
               "status": {"phase": "Running"}}
        plugin.ask("add_pod", pod=pod)
        monitor.ask("add_pod", pod=pod)
        plugin.ask("patch_node", annos={api.NODE_LOCK_ANNO:
                                        nodelock.now_str()})
        with grpc.insecure_channel(sock) as ch:
            resp = dp_grpc.DevicePluginStub(ch).Allocate(pb.AllocateRequest(
                container_requests=[pb.ContainerAllocateRequest(
                    devicesIDs=[replica_id(chip.uuid, next(replicas))])]))
        (ctr,) = resp.container_responses
        env = {k: v for k, v in os.environ.items() if not k.startswith(
            ("CUDA_", "NVIDIA_", "LD_PRELOAD", "PYTORCH_CUDA_ALLOC_CONF"))}
        env["PYTHONPATH"] = ROOT
        env.update(runtime.process_env(ctr))
        env.update({k: str(v) for k, v in env_extra.items()})
        child = SmChild(f"(j) pod {label}", given=(env,
                                                   env[api.ENV_SHARED_CACHE]))
        child.uid, child.pod_name = uid, pod_name
        pods[label] = child
        return child

    def gone(label: str) -> None:
        """The exited pod deleted, and its region directory with it (what
        the monitor's GC does 300 s after the deletion)."""
        child = pods.pop(label)
        monitor.ask("delete_pod", name=child.pod_name)
        shutil.rmtree(os.path.dirname(child.cache))

    def feedback(child: SmChild):
        with child.view() as view:
            return (view.recent_kernel, view.utilization_switch,
                    view.total_launches())

    def within_sweeps(cond, what: str) -> float:
        """Seconds until cond() held; fails past SWEEPS_TO_ACT sweeps
        (and one sweep of slack for the interposer's 100 ms publish)."""
        t0 = time.monotonic()
        while not cond():
            check(time.monotonic() - t0 <= (SWEEPS_TO_ACT + 1) * SWEEP_S,
                  f"(j) {what}: not within {SWEEPS_TO_ACT} sweeps")
            time.sleep(0.05)
        return time.monotonic() - t0

    def utilization(child: SmChild, seconds: float):
        """HostCoreUtilization over two scrapes UTIL_WINDOW_S apart while
        child runs case 1.1 alone; (gauge share, the child's busy share,
        the run, NVML's utilization meanwhile)"""
        child.send("run", seconds=seconds)
        time.sleep(0.5)
        monitor.scrape()
        t0 = time.monotonic()
        time.sleep(UTIL_WINDOW_S / 2)
        nvml = nvml_utilization(chip.uuid)
        time.sleep(max(0.0, t0 + UTIL_WINDOW_S - time.monotonic()))
        gauge = card_gauge(monitor.scrape(), "HostCoreUtilization",
                           chip.uuid) / 100.0
        run = child.read()
        busy = run["calls"] * step_ms / 1e3 / run["wall_s"]
        return gauge, busy, run, nvml

    used0, apps0 = int(smi("memory.used")[0]), compute_apps()
    monitor = MonitorChild(tmp, containers)
    try:
        monitor.wait_ready()
        time.sleep(3 * SWEEP_S)
        used1, apps1 = int(smi("memory.used")[0]), compute_apps()
        modules = monitor.ask("modules")["modules"]
        check(modules == [], f"(j) the monitor imported {modules}")
        check(used1 - used0 < CONTEXT_MARGIN_MB and apps1 == apps0,
              f"(j) the monitor took device memory ({used0} -> {used1} "
              f"MiB) or a context ({apps0} -> {apps1} processes)")

        # 1. pod H alone
        h = allocate("H", NODE_SM_LIMIT, CUDA_TASK_PRIORITY=0)
        h.ask("step")
        lift_s = within_sweeps(lambda: feedback(h)[1] == 1,
                               "H alone released")
        gauge, busy, run, nvml = utilization(h, UTIL_WINDOW_S + 1.5)
        share = run["img_s"] / solo_img_s
        reserved = h.ask("mem")["reserved"]
        time.sleep(1.5 * SWEEP_S)
        fams = monitor.scrape()
        usage = pod_gauge(fams, "vGPU_device_memory_usage_in_bytes", h.uid)
        limit = pod_gauge(fams, "vGPU_device_memory_limit_in_bytes", h.uid)
        capacity = card_gauge(fams, "HostGPUMemoryCapacity", chip.uuid)
        host_usage = card_gauge(fams, "HostGPUMemoryUsage", chip.uuid)
        pod_usage = sum(fams["vGPU_device_memory_usage_in_bytes"].values())
        print(f"(j) 1. pod H alone (priority 0, gpucores 50): released "
              f"(utilization_switch 1) {lift_s:.2f} s after its first step; "
              f"{run['img_s']:.1f} img/s, {share:.3f}x the unthrottled "
              f"{solo_img_s:.1f}; HostCoreUtilization over "
              f"{UTIL_WINDOW_S:.0f} s {gauge:.4f} against its busy share "
              f"{busy:.4f} ({gauge / busy:.3f}x; NVML utilization {nvml}%); "
              f"usage {usage:.0f} B vs memory_reserved {reserved} B (+"
              f"{(usage - reserved) / MiB:.1f} MiB), limit {limit:.0f} B, "
              f"card capacity {capacity:.0f} B, HostGPUMemoryUsage "
              f"{host_usage:.0f} B; on {name}", flush=True)
        check(share >= 0.8, f"(j) H alone ran at {share:.3f}x")
        check(0.8 <= gauge / busy <= 1.1,
              f"(j) H's utilization {gauge:.4f} vs busy {busy:.4f}")
        check(limit == quota, f"(j) limit gauge {limit}")
        check(0 <= usage - reserved <= RESERVED_MARGIN,
              f"(j) usage gauge {usage} vs reserved {reserved}")
        check(capacity == chip.hbm_mb * MiB, f"(j) capacity {capacity}")
        check(host_usage == pod_usage, f"(j) HostGPUMemoryUsage "
              f"{host_usage} vs the pods' {pod_usage}")
        result = {"phase": "(j) node monitor", "h_release_s": lift_s,
                  "h_share": share, "h_util_gauge": gauge, "h_busy": busy,
                  "h_nvml_util": nvml, "h_usage_minus_reserved":
                  usage - reserved}

        # 2. pod U with no gpucores, alone (H idle)
        u = allocate("U", 0)
        u.ask("step")
        gauge, busy, run, nvml = utilization(u, UTIL_WINDOW_S + 1.5)
        print(f"(j) 2. pod U with no SM limit alone: HostCoreUtilization "
              f"over {UTIL_WINDOW_S:.0f} s {gauge:.4f} against its busy "
              f"share {busy:.4f} ({gauge / busy:.3f}x; NVML utilization "
              f"{nvml}%); {run['img_s']:.1f} img/s; on {name}", flush=True)
        check(0.8 <= gauge / busy <= 1.1,
              f"(j) U's utilization {gauge:.4f} vs busy {busy:.4f}")
        result.update(u_util_gauge=gauge, u_busy=busy, u_nvml_util=nvml)
        u.close()
        gone("U")

        # 3. pod L joins while H runs
        lo = allocate("L", NODE_SM_LIMIT, CUDA_TASK_PRIORITY=1)
        lo.ask("step")
        within_sweeps(lambda: feedback(h)[1] == 0 and feedback(lo)[1] == 0,
                      "H and L both throttled")
        h.send("run", seconds=12.0)
        block_s = within_sweeps(lambda: feedback(lo)[0] == FEEDBACK_BLOCK,
                                "L blocked while H runs")
        lo.send("run", seconds=4.0)
        time.sleep(0.5)
        held = feedback(lo)[2]
        info = {e["entry"]: e for e in monitor.nodeinfo()["containers"]}
        time.sleep(5.0)
        still = feedback(lo)[2]
        h_run = h.read()
        h_share = h_run["img_s"] / solo_img_s
        live = {os.path.basename(os.path.dirname(c.cache)): c
                for c in pods.values()}
        print(f"(j) 3. pod L (priority 1) joins while H runs: both "
              f"throttled, L blocked {block_s:.2f} s after H started; L's "
              f"region launches {held} -> {still} over 5 s; H at "
              f"{h_share:.3f}x; /nodeinfo "
              f"{[(e, info[e]['pod_name'], info[e]['hbm_limit'], info[e]['hbm_used']) for e in sorted(info)]}; "
              f"on {name}", flush=True)
        check(still == held, f"(j) L launched while blocked: {held} -> "
              f"{still}")
        check(0.40 <= h_share <= 0.60, f"(j) H beside L at {h_share:.3f}x")
        check(sorted(info) == sorted(live), f"(j) /nodeinfo lists "
              f"{sorted(info)}, live {sorted(live)}")
        for entry, child in live.items():
            check(info[entry]["pod_name"] == child.pod_name
                  and info[entry]["hbm_limit"] == [quota]
                  and info[entry]["hbm_used"][0] > 0,
                  f"(j) /nodeinfo entry {info[entry]}")
        result.update(l_block_s=block_s, h_share_beside_l=h_share)

        # 4. H exits
        h.close()
        unblock_s = within_sweeps(
            lambda: feedback(lo)[0] != FEEDBACK_BLOCK, "L unblocked")
        lo.read()
        moved = feedback(lo)[2]
        gone("H")
        release_s = within_sweeps(lambda: feedback(lo)[1] == 1,
                                  "L alone released")
        l_share = lo.ask("run", seconds=4.0)["img_s"] / solo_img_s
        print(f"(j) 4. H exits: L unblocked within {unblock_s:.2f} s, its "
              f"region launches {still} -> {moved}; with H's directory "
              f"gone, released within {release_s:.2f} s; L at "
              f"{l_share:.3f}x; on {name}", flush=True)
        check(moved > still, "(j) L did not launch after H exited")
        check(l_share >= 0.8, f"(j) L alone ran at {l_share:.3f}x")
        result.update(l_unblock_s=unblock_s, l_release_s=release_s,
                      l_share=l_share)
        lo.close()
        gone("L")

        # 5. pod F alone under the force policy
        f = allocate("F", NODE_SM_LIMIT,
                     GPU_CORE_UTILIZATION_POLICY="force")
        f.ask("step")
        f.send("run", seconds=8.0)
        switches = set()
        t0 = time.monotonic()
        while time.monotonic() - t0 < 7.0:
            switches.add(feedback(f)[1])
            time.sleep(0.25)
        f_share = f.read()["img_s"] / solo_img_s
        print(f"(j) 5. pod F alone under the force policy: "
              f"utilization_switch {sorted(switches)} over 7 s, "
              f"{f_share:.3f}x; on {name}", flush=True)
        check(switches == {0}, f"(j) F released: {switches}")
        check(0.40 <= f_share <= 0.60, f"(j) F at {f_share:.3f}x")
        result["f_share"] = f_share
        f.close()
        gone("F")

        # 6. the monitor process
        sweeps = sorted(monitor.ask("sweeps")["sweeps"])
        p50, top = sweeps[len(sweeps) // 2] * 1e3, sweeps[-1] * 1e3
        used2, apps2 = int(smi("memory.used")[0]), compute_apps()
        took = time.perf_counter() - start
        print(f"(j) 6. the monitor: {len(sweeps)} sweeps, latency p50 "
              f"{p50:.3f} ms, max {top:.3f} ms; card memory used {used0} -> "
              f"{used1} MiB with the monitor alone ({used2} at the end), "
              f"compute processes {apps0} -> {apps1}; no torch/jax/vtpu "
              f"module; every region clean after its pod exited; the phase "
              f"took {took:.1f} s; on {name}", flush=True)
        check(took < MONITOR_PHASE_S, f"(j) took {took:.1f} s")
        result.update(sweeps=len(sweeps), sweep_p50_ms=p50,
                      sweep_max_ms=top, monitor_used_mib_delta=used1 - used0,
                      phase_s=took)
        monitor.stop()
        monitor = None
    finally:
        for child in pods.values():
            if child.proc.poll() is None:
                child.proc.kill()
                child.proc.wait(timeout=60)
        if monitor is not None and monitor.proc.poll() is None:
            monitor.proc.kill()
            monitor.proc.wait(timeout=60)
    return result


NATIVE = [
    {"name": "libvgpu.so", "route": "gcc", "source":
     "vtpu_torch/csrc/libvgpu.c", "replaces": "lib/vtpu/libvtpu.c:1007",
     "hooks": ["dlsym", "cuGetProcAddress", "cuGetProcAddress_v2",
               "cuMemAlloc_v2", "cuMemAllocPitch_v2", "cuMemFree_v2",
               "cuMemCreate", "cuMemRelease", "cuMemGetInfo_v2",
               "cuMemAllocAsync", "cuMemAllocAsync_ptsz",
               "cuMemAllocFromPoolAsync", "cuMemAllocFromPoolAsync_ptsz",
               "cuMemFreeAsync", "cuMemFreeAsync_ptsz", "cuMemPoolTrimTo",
               "cuMemPoolDestroy", "cuLaunchKernel", "cuLaunchKernel_ptsz",
               "cuLaunchKernelEx", "cuLaunchKernelEx_ptsz",
               "cuLaunchCooperativeKernel", "cuLaunchCooperativeKernel_ptsz",
               "cuGraphLaunch", "cuGraphLaunch_ptsz", "cuMemHostAlloc",
               "cuMemAllocHost_v2", "cuMemFreeHost", "cuMemHostRegister_v2",
               "cuMemHostUnregister", "cuCtxSynchronize",
               "cuStreamSynchronize", "cuStreamSynchronize_ptsz"]},
    {"name": "libvgpucore.so", "route": "gcc", "source":
     "vtpu_torch/csrc/shared_region.c", "replaces":
     "lib/vtpu/shared_region.c:476"},
    {"name": "libnvidia-ml.so.1 (mock, CPU tests only)", "route": "gcc",
     "source": "vtpu_torch/csrc/mock_nvml.c", "replaces":
     "vtpu/plugin/tpulib.py:65"},
]


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] == "--quota-child":
        quota_child(sys.argv[2], int(sys.argv[3]))
        return 0
    if len(sys.argv) > 1 and sys.argv[1] == "--peak-child":
        peak_child(sys.argv[2])
        return 0
    if len(sys.argv) > 1 and sys.argv[1] == "--sm-child":
        sm_child()
        return 0
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    name = card()
    driver = subprocess.run(
        ["nvidia-smi", "--query-gpu=driver_version", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
        timeout=60).stdout.split()[0]
    print(f"card: {name}; driver {driver}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, cuDNN {torch.backends.cudnn.version()}, "
          f"{sys.executable}", flush=True)
    t0 = time.perf_counter()
    libs = native.build_all()
    print(f"built {sorted(libs)} in {time.perf_counter() - t0:.2f} s",
          flush=True)
    phases = [infer_phase(name), train_phase(name), sharded_phase(name)]
    for alloc_conf in ALLOCATORS:
        phases.append(quota_phase(name, "1.1", INFER_QUOTA, alloc_conf))
    for alloc_conf in ALLOCATORS:
        peak = phases[1]["peak_reserved_bytes"] if not alloc_conf \
            else alone_peak("1.2", alloc_conf)
        quota = math.ceil(peak * (1 + TRAIN_HEADROOM) / GiB) * GiB
        print(f"case 1.2 quota, {alloc_conf or 'default allocator'}: "
              f"max_memory_reserved alone {peak} B + {TRAIN_HEADROOM:.0%}, "
              f"rounded up to whole GiB: {quota} B", flush=True)
        phases.append(dict(quota_phase(name, "1.2", quota, alloc_conf),
                           max_memory_reserved_alone=peak))
    phases += compute_phases(name)
    (solo,) = [p["unthrottled_img_s"] for p in phases
               if p["phase"] == "(c) case 1.1 at 50%"]
    (step_ms,) = [p["no SM limit"] for p in phases
                  if p["phase"] == "(b) case 1.1 unthrottled cost"]
    phases += node_agent_phase(name, solo, step_ms)
    print(json.dumps({"card": name, "phases": phases}), flush=True)
    print(json.dumps({"kernels": [], "native": NATIVE}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        sys.exit(1)
