#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (vtpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path at full width, from a checkout with nothing
built:

1. prints the card (``nvidia-smi`` name and power limit) and the
   torch/CUDA versions;
2. builds the native libraries (vtpu_torch/native.py: libvgpucore.so,
   libvgpu.so) with gcc;
3. model phase: ai-benchmark case 1.1, ResNet-V2-50 inference at batch 50,
   346x346x3, 1000 classes, bf16 compute with f32 parameters, channels_last,
   weights from a seeded generator. Warm-up, then timed steps (CUDA
   events); checks the logits' shape, type and finiteness and their
   relative L2 error against the port's own f32 forward of the same weights
   (TF32 off), within the bf16 tolerance of the CPU parity tests (5e-2);
   also runs ``vtpu_torch.entry()`` on the card;
4. quota phase, twice (the default caching allocator, then
   ``expandable_segments:True``): a child process started with
   ``LD_PRELOAD=libvgpu.so``, a 12 GiB quota and its own region file calls
   ``vtpu_torch.enforce.install()`` and runs the same steps; it checks that
   ``torch.cuda.mem_get_info()`` shows the quota, that the region's charge
   matches ``torch.cuda.memory_reserved()`` within a stated margin, and that
   one allocation past the quota raises ``torch.OutOfMemoryError`` and the
   model still runs after it. The parent reads the region as the node
   monitor does (``RegionView``): the child had a slot while it ran, and the
   region is clean after it exits. A third child selects
   ``backend:cudaMallocAsync``, which the interposer does not enforce yet,
   and must stop at its first allocation;
5. prints the port's native components (the JAX package has no TPU kernel,
   so ``kernels`` is empty) and, last, ``{"ok": true, "device": ...}``.

Any failed phase ends the run with a non-zero exit and no final line. So
does a machine without CUDA, or a directory without the repository.
"""

from __future__ import annotations

import json
import os
import select
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from vtpu_torch import native  # noqa: E402
from vtpu_torch.enforce import install  # noqa: E402
from vtpu_torch.enforce.region import RegionView  # noqa: E402
from vtpu_torch.models import BENCH_CASES, get_model  # noqa: E402
from vtpu_torch.models.train import init_model, make_infer_step  # noqa: E402

CASE = next(c for c in BENCH_CASES if c.case == "1.1")
QUOTA = 12 << 30
QUOTA_ENV = "12g"
# bf16 logits against the f32 forward: the CPU parity tests' tolerance
BF16_REL_L2 = 5e-2
# region charge minus torch.cuda.memory_reserved(): device memory that
# libraries in the process take with cuMemAlloc outside PyTorch's caching
# allocator. Measured at 67,266,308 B on an H100 (PERF.md); the margin
# leaves room for library versions that take more.
RESERVED_MARGIN = 128 << 20
WARMUP, STEPS = 3, 20
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


def build_case(dtype: torch.dtype, seed: int = 0):
    """Case 1.1's model on the card with weights from ``seed``, and its
    NHWC input batch."""
    model = get_model(CASE.model, num_classes=CASE.classes, dtype=dtype,
                      device="cuda").to(memory_format=torch.channels_last)
    x = torch.randn((CASE.batch,) + CASE.shape,
                    generator=torch.Generator().manual_seed(seed)).cuda()
    init_model(model, x, torch.Generator().manual_seed(seed + 1))
    return model, x


def time_steps(step, x):
    """(last logits, device ms per step from CUDA events, host ms per
    step)."""
    for _ in range(WARMUP):
        out = step(x)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(STEPS):
        out = step(x)
    end.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / STEPS
    return out, start.elapsed_time(end) / STEPS, host_ms


def check_logits(out: torch.Tensor) -> None:
    check(tuple(out.shape) == (CASE.batch, CASE.classes),
          f"logits shape {tuple(out.shape)}")
    check(out.dtype == torch.float32, f"logits dtype {out.dtype}")
    check(bool(torch.isfinite(out).all()), "non-finite logits")


def model_phase(name: str) -> dict:
    model, x = build_case(torch.bfloat16)
    torch.cuda.reset_peak_memory_stats()
    out, ms, host_ms = time_steps(make_infer_step(model), x)
    check_logits(out)
    peak = torch.cuda.max_memory_allocated()

    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        ref_model = get_model(CASE.model, num_classes=CASE.classes,
                              dtype=torch.float32, device="cuda").to(
            memory_format=torch.channels_last)
        ref_model.load_state_dict(model.state_dict())
        ref = make_infer_step(ref_model)(x)
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = tf32
    rel = float((out - ref).norm() / ref.norm())
    check(rel <= BF16_REL_L2, f"bf16 logits rel L2 {rel} > {BF16_REL_L2}")

    import vtpu_torch
    fn, args = vtpu_torch.entry()
    eout = fn(*args)
    check(tuple(eout.shape) == (8, 1000)
          and bool(torch.isfinite(eout).all()), "entry() logits")

    img_s = CASE.batch / (ms / 1e3)
    print(f"case 1.1 native: ResNet-V2-50 bf16 batch {CASE.batch} "
          f"{CASE.shape[0]}x{CASE.shape[1]}: {ms:.3f} ms/step (CUDA events, "
          f"{STEPS} steps), host {host_ms:.3f} ms/step, {img_s:.1f} img/s, "
          f"bf16-vs-f32 rel L2 {rel:.3e}, peak allocated {peak} B; "
          f"on {name}", flush=True)
    del model, ref_model, x, out, ref
    torch.cuda.empty_cache()
    return {"phase": "native", "step_ms": ms, "host_step_ms": host_ms,
            "img_s": img_s, "rel_l2_bf16_vs_f32": rel,
            "peak_allocated_bytes": peak}


def quota_child() -> None:
    """Runs in the child under LD_PRELOAD=libvgpu.so."""
    enf = install()
    check(enf.interposed, "libvgpu.so is not active in the child")
    check(enf.limit() == QUOTA, f"quota {enf.limit()}")
    model, x = build_case(torch.bfloat16)
    out, ms, host_ms = time_steps(make_infer_step(model), x)
    check_logits(out)
    free, total = torch.cuda.mem_get_info()
    used = enf.used()
    reserved = torch.cuda.memory_reserved()
    check(total == QUOTA, f"mem_get_info total {total} != quota {QUOTA}")
    check(free == QUOTA - used, f"mem_get_info free {free} != quota - "
          f"region used {QUOTA - used}")
    check(0 <= used - reserved <= RESERVED_MARGIN,
          f"region used {used} vs memory_reserved {reserved}: gap "
          f"{used - reserved} B outside [0, {RESERVED_MARGIN}]")
    try:
        torch.empty(QUOTA, dtype=torch.uint8, device="cuda")
        raise SmokeFailure("an allocation past the quota succeeded")
    except torch.OutOfMemoryError:
        pass
    after = make_infer_step(model)(x)
    torch.cuda.synchronize()
    check_logits(after)
    drift = float((after - out).norm() / out.norm())
    check(drift <= BF16_REL_L2, f"logits moved by {drift} after the refusal")
    print(json.dumps({"pid": os.getpid(), "step_ms": ms,
                      "host_step_ms": host_ms,
                      "img_s": CASE.batch / (ms / 1e3),
                      "region_used": enf.used(),
                      "reserved_at_check": reserved,
                      "used_at_check": used,
                      "memory_reserved": torch.cuda.memory_reserved()}),
          flush=True)
    sys.stdin.readline()  # the parent reads the region meanwhile


def child_env(alloc_conf: str):
    """(temp dir, region file, env) for a quota child: libvgpu.so
    preloaded, the 12 GiB quota, its own region file under
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
        "CUDA_DEVICE_MEMORY_LIMIT": QUOTA_ENV,
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


def quota_phase(name: str, alloc_conf: str) -> dict:
    label = alloc_conf or "default allocator"
    tmp, cache, env = child_env(alloc_conf)
    free0, _ = torch.cuda.mem_get_info()
    errf = open(os.path.join(tmp, "child.err"), "w+")
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--quota-child"],
        env=env, stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=errf,
        text=True)
    try:
        ready, _, _ = select.select([proc.stdout], [], [], CHILD_TIMEOUT_S)
        line = proc.stdout.readline() if ready else ""
        if not line:
            proc.kill()
            proc.wait(timeout=60)
            errf.seek(0)
            raise SmokeFailure(f"quota child ({label}) failed, rc "
                               f"{proc.returncode}:\n{errf.read()[-4000:]}")
        report = json.loads(line)
        free1, _ = torch.cuda.mem_get_info()
        footprint = free0 - free1  # the child's real device memory
        with RegionView(cache) as view:
            pids = [p.pid for p in view.procs()]
            check(pids == [proc.pid], f"region slots {pids}, child "
                  f"{proc.pid}")
            check(view.hbm_limit(0) == QUOTA, "region limit")
            region_used = view.used(0)
            check(region_used == report["region_used"],
                  f"monitor reads {region_used} B, child charged "
                  f"{report['region_used']} B")
        proc.communicate("exit\n", timeout=CHILD_TIMEOUT_S)
        errf.seek(0)
        check(proc.returncode == 0,
              f"quota child rc {proc.returncode}:\n{errf.read()[-4000:]}")
        check_clean(cache)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
        errf.close()
        shutil.rmtree(tmp, ignore_errors=True)
    result = dict(report, phase=f"quota ({label})",
                  device_footprint_bytes=footprint,
                  unaccounted_bytes=footprint - region_used)
    print(f"case 1.1 under libvgpu.so, {QUOTA_ENV} quota, {label}: "
          f"{report['step_ms']:.3f} ms/step (CUDA events), "
          f"{report['img_s']:.1f} img/s; region charge {region_used} B vs "
          f"memory_reserved {report['memory_reserved']} B; child device "
          f"footprint {footprint} B, of it not charged "
          f"{footprint - region_used} B; on {name}", flush=True)
    return result


def async_refusal_phase() -> None:
    """The stream-ordered allocator is not enforced yet: a child that
    selects it must stop at its first pool allocation (exit 78) instead of
    running unenforced, and leave the region clean."""
    tmp, cache, env = child_env("backend:cudaMallocAsync")
    try:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--quota-child"],
            env=env, stdin=subprocess.DEVNULL, capture_output=True,
            text=True, timeout=CHILD_TIMEOUT_S)
        check(proc.returncode == 78 and "cudaMallocAsync" in proc.stderr,
              f"cudaMallocAsync child rc {proc.returncode}, expected 78:\n"
              f"{proc.stderr[-4000:]}")
        check_clean(cache)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print("backend:cudaMallocAsync under libvgpu.so: refused at the first "
          "pool allocation (exit 78), region clean", flush=True)


NATIVE = [
    {"name": "libvgpu.so", "route": "gcc", "source":
     "vtpu_torch/csrc/libvgpu.c", "replaces": "lib/vtpu/libvtpu.c:1007",
     "hooks": ["dlsym", "cuGetProcAddress", "cuGetProcAddress_v2",
               "cuMemAlloc_v2", "cuMemAllocPitch_v2", "cuMemFree_v2",
               "cuMemCreate", "cuMemRelease", "cuMemGetInfo_v2",
               "cuMemAllocAsync", "cuMemAllocFromPoolAsync"]},
    {"name": "libvgpucore.so", "route": "gcc", "source":
     "vtpu_torch/csrc/shared_region.c", "replaces":
     "lib/vtpu/shared_region.c:476"},
]


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] == "--quota-child":
        quota_child()
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
    phases = [model_phase(name)]
    for alloc_conf in ("", "expandable_segments:True"):
        phases.append(quota_phase(name, alloc_conf))
    async_refusal_phase()
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
