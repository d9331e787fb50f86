"""CUDA 13.0's synchronisation and the batch copies, through ``libvgpu.so``.

The H100's driver (580.159.03, CUDA 13.0) answers ``cuCtxSynchronize`` at
13000 with ``cuCtxSynchronize_v2``, which takes a context, and
``cuMemcpyBatchAsync`` / ``cuMemcpy3DBatchAsync`` with CUDA 12.8's
variants at 12080 and their ``_v2`` (no ``failIdx``) at 13000, each with a
``_ptsz`` twin (``python -m vtpu_torch.bench.abi``). A child runs as a pod
does (``libvgpu.so`` preloaded, its own region file, the node's lock
directory) and:

1. resolves ``cuCtxSynchronize`` at 13000: the interposer's
   ``cuCtxSynchronize_v2`` is handed out; one long kernel opens a span on
   the default stream (an f32 GEMM on the card, a 50 ms kernel on the mock)
   and stays uncharged until that call, which returns 0 and charges it
   within 0.8-1.25x of the kernel's time (a CUDA-event time on the card);
   twice, with the context named and with NULL (the current one);
2. copies through each batch variant at 12080 and 13000 (one copy of
   ``COPY_BYTES`` per call, a 3D batch of the same bytes) on a stream of
   its own, then a 3D batch with a flag set, which the driver refuses:
   every variant hooked, rc 0, on the card the bytes arrived, and the
   region's TRANSFER calls, errors and bytes grew by exactly those calls'.

    python -m vtpu_torch.bench.cuda13                 # card 0
    python -m vtpu_torch.bench.cuda13 --backend mock  # the mock driver

One JSON line; exit 0 when every gate holds, 1 when one fails, 2 with no
card (and no ``--backend mock``).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile
from typing import Dict, Optional

from .. import api, native

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
COPY_BYTES = 1 << 20
GEMM_N = 8192  # an f32 GEMM of 8192^3: tens of ms on an H100
MOCK_KERNEL_NS = 50_000_000
PTDS = 2  # CU_GET_PROC_ADDRESS_PER_THREAD_DEFAULT_STREAM
BATCH = ("cuMemcpyBatchAsync", "cuMemcpy3DBatchAsync")
VARIANTS = ((12080, 0, ""), (12080, PTDS, "_ptsz"), (13000, 0, "_v2"),
            (13000, PTDS, "_v2_ptsz"))


# ------------------------------------------------------------------ child

class _Loc(ctypes.Structure):
    _fields_ = [("type", ctypes.c_int), ("id", ctypes.c_int)]


class _Attr(ctypes.Structure):  # CUmemcpyAttributes
    _fields_ = [("order", ctypes.c_int), ("src", _Loc), ("dst", _Loc),
                ("flags", ctypes.c_uint)]


class _Ptr(ctypes.Structure):
    _fields_ = [("ptr", ctypes.c_uint64), ("rowLength", ctypes.c_size_t),
                ("layerHeight", ctypes.c_size_t), ("loc", _Loc)]


class _Arr(ctypes.Structure):
    _fields_ = [("array", ctypes.c_void_p),
                ("offset", ctypes.c_size_t * 3)]


class _OperandU(ctypes.Union):
    _fields_ = [("ptr", _Ptr), ("array", _Arr)]


class _Operand(ctypes.Structure):  # CUmemcpy3DOperand
    _fields_ = [("type", ctypes.c_int), ("op", _OperandU)]


class _Op(ctypes.Structure):  # CUDA_MEMCPY3D_BATCH_OP
    _fields_ = [("src", _Operand), ("dst", _Operand),
                ("extent", ctypes.c_size_t * 3), ("order", ctypes.c_int),
                ("flags", ctypes.c_uint)]


def _transfer(cache: str) -> list:
    from ..enforce.region import RegionView

    with RegionView(cache) as view:
        st = view.snapshot().prof["transfer"]
    return [st.calls, st.errors, st.bytes]


def child(backend: str) -> int:
    """Runs under ``libvgpu.so``: prints one JSON line of what it saw."""
    c = ctypes
    cu = c.CDLL("libcuda.so.1")
    vg = c.CDLL(os.environ["LD_PRELOAD"])
    gpa2 = c.CFUNCTYPE(c.c_int, c.c_char_p, c.POINTER(c.c_void_p), c.c_int,
                       c.c_uint64, c.POINTER(c.c_int))(
        c.cast(cu.cuGetProcAddress_v2, c.c_void_p).value)

    def via(base: str, version: int, flags: int = 0) -> int:
        p, st = c.c_void_p(), c.c_int(-1)
        rc = gpa2(base.encode(), c.byref(p), version, flags, c.byref(st))
        assert rc == 0 and st.value == 0 and p.value, (base, version, rc)
        return p.value

    def addr(name: str) -> int:
        return c.cast(getattr(vg, name), c.c_void_p).value

    out: Dict = {}
    span = (c.c_uint64 * 3)()

    def charged() -> int:
        return int(span[2]) if vg.vgpu_span_stream(None, span) else 0

    # 1. CUDA 13.0's synchronisation
    entry = via("cuCtxSynchronize", 13000)
    out["sync_hooked"] = entry == addr("cuCtxSynchronize_v2")
    if backend == "cuda":
        import torch

        torch.backends.cuda.matmul.allow_tf32 = False
        a = torch.randn(GEMM_N, GEMM_N, device="cuda")
        a @ a  # its kernels loaded and measured before the timed one
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        a @ a
        end.record()
        torch.cuda.synchronize()
        out["kernel_ms"] = start.elapsed_time(end)
        launch = lambda: a @ a  # noqa: E731
    else:
        launch_fn = c.CFUNCTYPE(c.c_int, c.c_void_p, *[c.c_uint] * 7,
                                c.c_void_p, c.c_void_p, c.c_void_p)(
            via("cuLaunchKernel", 12080))
        launch = lambda: launch_fn(None, 1, 1, 1, 1, 1, 1, 0,  # noqa: E731
                                   None, None, None)
        launch()
        c.CFUNCTYPE(c.c_int)(via("cuCtxSynchronize", 12080))()
        out["kernel_ms"] = MOCK_KERNEL_NS / 1e6
    ctx = c.c_void_p()
    assert cu.cuCtxGetCurrent(c.byref(ctx)) == 0
    sync = c.CFUNCTYPE(c.c_int, c.c_void_p)(entry)
    out.update(sync_rc=[], uncharged_while_open=[], sync_charged_ms=[])
    for named in (ctx, None):  # the context named, then NULL: the current
        before = charged()
        launch()
        opened = charged()
        out["sync_rc"].append(sync(named))
        out["uncharged_while_open"].append(opened == before)
        out["sync_charged_ms"].append((charged() - opened) / 1e6)

    # 2. the batch copies, on a stream of the child's own
    stream = c.c_void_p()
    assert cu.cuStreamCreate(c.byref(stream), 1) == 0
    if backend == "cuda":
        src = torch.arange(COPY_BYTES, device="cuda").to(torch.uint8)
        dsts = [torch.zeros(COPY_BYTES, dtype=torch.uint8, device="cuda")
                for _ in range(2 * len(VARIANTS))]
        torch.cuda.synchronize()
        src_ptr, dst_ptrs = src.data_ptr(), [d.data_ptr() for d in dsts]
    else:
        src_ptr = 0x10000000
        dst_ptrs = [0x20000000 + i * COPY_BYTES
                    for i in range(2 * len(VARIANTS))]
    cache = os.environ[api.ENV_SHARED_CACHE]
    vg.vgpu_flush_launches()
    t0 = _transfer(cache)
    attrs = (_Attr * 1)(_Attr(1, _Loc(0, 0), _Loc(0, 0), 0))
    idxs = (c.c_size_t * 1)(0)
    sizes = (c.c_size_t * 1)(COPY_BYTES)
    fail = c.c_size_t(0)
    srcs = (c.c_uint64 * 1)(src_ptr)
    args = (c.c_void_p, c.c_void_p, c.c_void_p, c.c_size_t, c.c_void_p,
            c.c_void_p, c.c_size_t)
    calls = {}
    for i, (version, flags, sym) in enumerate(VARIANTS):
        one, three = (via(base, version, flags) for base in BATCH)
        dst = (c.c_uint64 * 1)(dst_ptrs[2 * i])
        op = _Op()
        op.src.type = op.dst.type = 1  # CU_MEMCPY_OPERAND_TYPE_POINTER
        op.src.op.ptr.ptr, op.dst.op.ptr.ptr = src_ptr, dst_ptrs[2 * i + 1]
        op.extent[:] = (COPY_BYTES // 4, 4, 1)
        op.order = 1  # CU_MEMCPY_SRC_ACCESS_ORDER_STREAM
        ops = (_Op * 1)(op)
        if version < 13000:
            rc = c.CFUNCTYPE(c.c_int, *args, c.POINTER(c.c_size_t),
                             c.c_void_p)(one)(dst, srcs, sizes, 1, attrs,
                                              idxs, 1, c.byref(fail), stream)
            rc3 = c.CFUNCTYPE(c.c_int, c.c_size_t, c.c_void_p,
                              c.POINTER(c.c_size_t), c.c_ulonglong,
                              c.c_void_p)(three)(1, ops, c.byref(fail), 0,
                                                 stream)
        else:
            rc = c.CFUNCTYPE(c.c_int, *args, c.c_void_p)(one)(
                dst, srcs, sizes, 1, attrs, idxs, 1, stream)
            rc3 = c.CFUNCTYPE(c.c_int, c.c_size_t, c.c_void_p,
                              c.c_ulonglong, c.c_void_p)(three)(
                1, ops, 0, stream)
        calls[f"{version}{sym}"] = {
            "hooked": [one == addr(BATCH[0] + sym),
                       three == addr(BATCH[1] + sym)],
            "rc": [rc, rc3]}
    # a 3D batch with a flag set, which the driver refuses: an error
    out["refused_rc"] = c.CFUNCTYPE(c.c_int, c.c_size_t, c.c_void_p,
                                    c.c_ulonglong, c.c_void_p)(
        via(BATCH[1], 13000))(1, ops, 1, stream)
    assert cu.cuStreamSynchronize(stream) == 0
    vg.vgpu_flush_launches()
    t1 = _transfer(cache)
    if backend == "cuda":  # its comparisons copy too: after the reading
        out["copied"] = all(bool(torch.equal(d, src)) for d in dsts)
    out["batches"] = calls
    out["transfer"] = [b - a for a, b in zip(t0, t1)]
    print(json.dumps(out), flush=True)
    return 0


# ----------------------------------------------------------------- parent

def gates(res: Dict, backend: str) -> Dict[str, bool]:
    n = 2 * len(VARIANTS)
    charged = res.get("sync_charged_ms", [])
    g = {
        "sync_hooked": res.get("sync_hooked") is True,
        "sync_rc": res.get("sync_rc") == [0, 0],
        "span_open_until_the_sync":
            res.get("uncharged_while_open") == [True, True],
        "span_charged_at_the_sync": len(charged) == 2 and min(charged) > 0,
        "batches_hooked": all(all(v["hooked"]) for v in
                              res.get("batches", {}).values())
        and len(res.get("batches", {})) == len(VARIANTS),
        "batches_rc": all(v["rc"] == [0, 0]
                          for v in res.get("batches", {}).values()),
        "refused_batch_an_error": res.get("refused_rc", 0) != 0,
        # the eight batches with their bytes, and the refused one's error
        "transfer_counted":
            res.get("transfer") == [n + 1, 1, n * COPY_BYTES],
    }
    kernel = max(res.get("kernel_ms", 0), 1e-9)
    g["sync_charge_within_0.8_1.25"] = len(charged) == 2 and all(
        0.8 <= ms / kernel <= 1.25 for ms in charged)
    if backend == "cuda":
        g["copied"] = res.get("copied") is True
    return g


def run(backend: str = "cuda", lock_dir: Optional[str] = None) -> Dict:
    """The child under ``libvgpu.so`` on ``backend``; its report and
    gates."""
    root = tempfile.mkdtemp(prefix="vgpu-cuda13-")
    cache = os.path.join(root, "containers", "cuda13_0", api.CACHE_FILENAME)
    os.makedirs(os.path.dirname(cache))
    env = {k: v for k, v in os.environ.items() if not k.startswith(
        ("CUDA_DEVICE_", "CUDA_DISABLE", "LD_PRELOAD"))}
    if backend == "mock":
        env["LD_LIBRARY_PATH"] = native.mock_cuda_dir()
        env["MOCK_CUDA_KERNEL_NS"] = str(MOCK_KERNEL_NS)
    env.update({
        "LD_PRELOAD": native.interposer(),
        api.ENV_SHARED_CACHE: cache,
        api.ENV_DEVICE_MEMORY_LIMIT: str(8 << 30),
        api.ENV_LOCK_DIR: lock_dir or os.path.join(root, "locks"),
        "PYTHONPATH": os.pathsep.join(
            [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                      if p]),
    })
    proc = subprocess.run(
        [sys.executable, "-m", "vtpu_torch.bench.cuda13", "--child",
         "--backend", backend], env=env, capture_output=True, text=True,
        timeout=300)
    res: Dict = {"rc": proc.returncode}
    if proc.returncode == 0 and proc.stdout.strip():
        res.update(json.loads(proc.stdout.strip().splitlines()[-1]))
    else:
        res["stderr"] = proc.stderr[-4000:]
    res["gates"] = gates(res, backend)
    res["ok"] = proc.returncode == 0 and all(res["gates"].values())
    return res


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m vtpu_torch.bench.cuda13",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--backend", choices=["cuda", "mock"], default="cuda")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        return child(args.backend)
    if args.backend == "cuda":
        try:
            import torch

            if not torch.cuda.is_available():
                raise RuntimeError("no CUDA device")
        except (ImportError, RuntimeError) as e:
            print(f"cuda13: {e}", file=sys.stderr)
            return 2
    res = run(args.backend)
    print(json.dumps(res))
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
