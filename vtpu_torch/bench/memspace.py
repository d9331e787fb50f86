"""The memory-space probe on a GPU, the port of hack/memspace_probe.py.

The JAX probe asked three questions of a TPU through its shim
(docs/adr-oversubscription.md): can a pod place state in host memory, is
that placement kept off the device quota, and what does a host-to-device
round trip cost against staying on the device. On CUDA there are four
places to ask about besides the device: pinned host memory
(``cuMemHostAlloc``, what ``pin_memory=True`` reaches), pageable host
memory, registered host memory (``cuMemHostRegister``) and managed memory
(``cuMemAllocManaged``), the seam the reference's ``CUDA_OVERSUBSCRIBE``
used to promise more memory than the card has.

A child process runs as a pod does: ``libvgpu.so`` preloaded, its own
region file, a device quota of 4 GiB (the JAX probe's) and a host-memory
limit of 1 GiB. It calls ``vtpu_torch.enforce.install()`` and places 64 MiB
(16 Mi f32, the JAX size) in each kind. Gates, each exact:

- a pinned, pageable or registered placement charges 0 B of the device
  quota (the charge read less the footprint charge, after a warm-up: in
  context mode that charge moves at a function's first launch);
- pinned and registered placements charge their bytes to the host ledger,
  a pageable one 0 B, and a pinned allocation past the host limit is
  refused;
- managed memory is charged to the device quota, and a managed allocation
  that would pass it is refused with CUDA_ERROR_OUT_OF_MEMORY: managed
  memory gives no transparent oversubscription;
- every charge is back to 0 after the frees, and the region is clean
  after the child exits.

On the card the child also times, with CUDA events (the median of 20),
the in-device touch ``x + 0``, a pinned and a pageable
host-to-device copy and a device-to-host copy, each printed beside its
bound (HBM3's 3.35 TB/s, PCIe Gen5 x16's 64 GB/s each way). Timings are
printed, not gated.

    python -m vtpu_torch.bench.memspace                 # card 0
    python -m vtpu_torch.bench.memspace --out probe.json
    python -m vtpu_torch.bench.memspace --backend mock  # the mock driver

The result is one JSON line with every key of the JAX probe's output (same
meaning) and the other kinds' keys. Exit 0 when every gate holds, 1 when
one fails, 2 with no card (and no ``--backend mock``). This process imports
no torch; only the child does.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
from typing import Dict, Optional

from .. import api, native

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
MiB = 1 << 20
GiB = 1 << 30
#: one placement: 16 Mi f32, the JAX probe's size
PLACEMENT_BYTES = 64 * MiB
#: the JAX probe's device quota
QUOTA_BYTES = 4 * GiB
HOST_LIMIT_BYTES = 1 * GiB
#: timings of each transfer, the median kept
REPS = 20
CUDA_ERROR_OUT_OF_MEMORY = 2
CU_MEM_ATTACH_GLOBAL = 1
CU_DEVICE_ATTRIBUTE_MANAGED_MEMORY = 83
#: H100 SXM's HBM3 rate and the PCIe Gen5 x16 link's, each way (NVIDIA's
#: H100 datasheet: 3.35 TB/s; PCIe Gen5 128 GB/s both ways)
HBM_BYTES_PER_S = 3.35e12
PCIE_BYTES_PER_S = 64e9
#: the mock card for --backend mock (the caller's env wins)
MOCK_ENV = {"MOCK_CUDA_TOTAL": "16g", "MOCK_CUDA_CTX_BYTES": "64m"}
MOCK_UUID = "GPU-00000000-0000-0000-0000-000000000000"
CHILD_TIMEOUT_S = 300
#: the host kinds that must charge the device quota nothing
HOST_KINDS = ("pinned_host", "unpinned_host", "registered_host")


def gates(res: Dict) -> Dict[str, bool]:
    """The probe's gates over a result (the child's measurements and the
    parent's reading of the region after the child exited)."""
    b = res["placement_bytes"]
    return {
        "device_placement_charged": res["shim_used_device_bytes"] == b,
        "host_kinds_charge_no_device_quota": all(
            res[f"{k}_device_bytes"] == 0 for k in HOST_KINDS),
        "pinned_and_registered_ledger_exact": (
            res["pinned_host_ledger_bytes"] == b
            and res["registered_host_ledger_bytes"] == b),
        "pageable_ledger_zero": res["unpinned_host_ledger_bytes"] == 0,
        "pinned_past_host_limit_refused":
            res["pinned_past_host_limit"] != "allocated",
        "managed_charged_to_device_quota": (
            res["managed_device_bytes"] == b
            and res["managed_ledger_bytes"] == 0),
        "managed_past_quota_refused":
            res["managed_past_quota_rc"] == CUDA_ERROR_OUT_OF_MEMORY,
        "charges_back_to_zero": (res["device_bytes_after_free"] == 0
                                 and res["host_ledger_bytes_after_free"]
                                 == 0),
        "region_clean_after_exit": res["region_clean_after_exit"],
    }


def bounds(b: int = PLACEMENT_BYTES) -> Dict[str, float]:
    """the least time each timed transfer could take on an H100 SXM: the
    touch reads and writes ``b`` bytes of HBM, a copy moves ``b`` over
    the host link"""
    touch = 2 * b / HBM_BYTES_PER_S
    copy = b / PCIE_BYTES_PER_S
    return {"in_hbm_touch_bound_s": touch, "copy_bound_s": copy,
            "host_to_hbm_bound_s": copy + touch}


# ----------------------------------------------------------------- parent

def mock_env(root: str) -> Dict[str, str]:
    """the mock driver and NVML for the child"""
    native.build_all()
    env = {k: os.environ.get(k, v) for k, v in MOCK_ENV.items()}
    procs = os.path.join(root, "procs")
    os.makedirs(procs, exist_ok=True)
    fixture = os.path.join(root, "cards.json")
    with open(fixture, "w") as f:
        json.dump({"gpus": [{"uuid": MOCK_UUID,
                             "name": "NVIDIA H100 80GB HBM3",
                             "memory_mb": 81559, "minor": 0}]}, f)
    env.update({
        "MOCK_GPU_PROCS": os.environ.get("MOCK_GPU_PROCS", procs),
        "MOCK_NVML_FIXTURE": os.environ.get("MOCK_NVML_FIXTURE", fixture),
        "LD_LIBRARY_PATH": os.pathsep.join(
            [native.mock_cuda_dir(),
             os.path.dirname(native.mock_nvml_library())]
            + [p for p in os.environ.get("LD_LIBRARY_PATH", "").split(
                os.pathsep) if p]),
    })
    return env


class Probe:
    """The probe's child, a pod under ``libvgpu.so`` with its own region
    under ``root``. ``hold``: the child loads its interpreter and waits
    for :meth:`go` before it touches the card, so it can be started ahead
    of its turn. ``lock_dir``: the node's lock directory (default one of
    its own under ``root``)."""

    def __init__(self, root: str, backend: str = "cuda", hold: bool = False,
                 lock_dir: Optional[str] = None):
        self.cache = os.path.join(root, "containers", "memspace_0",
                                  api.CACHE_FILENAME)
        os.makedirs(os.path.dirname(self.cache), exist_ok=True)
        lock_dir = lock_dir or os.path.join(root, "locks")
        os.makedirs(lock_dir, exist_ok=True)
        env = {k: v for k, v in os.environ.items() if not k.startswith(
            ("CUDA_DEVICE_", "CUDA_HOST_", "CUDA_DISABLE", "LD_PRELOAD",
             "PYTORCH_CUDA_ALLOC_CONF"))}
        if backend == "mock":
            env.update(mock_env(root))
        env.update({
            "LD_PRELOAD": native.interposer(),
            api.ENV_SHARED_CACHE: self.cache,
            api.ENV_DEVICE_MEMORY_LIMIT: str(QUOTA_BYTES),
            api.ENV_HOST_MEMORY_LIMIT: str(HOST_LIMIT_BYTES),
            api.ENV_LOCK_DIR: lock_dir,
            "PYTHONPATH": os.pathsep.join(
                [REPO] + [p for p in env.get("PYTHONPATH", "").split(
                    os.pathsep) if p]),
        })
        argv = [sys.executable, "-m", "vtpu_torch.bench.memspace",
                "--child", backend]
        if hold:
            argv.append("--hold")
        self.proc = subprocess.Popen(
            argv, env=env, cwd=root, stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def go(self) -> None:
        self.proc.stdin.write("go\n")
        self.proc.stdin.flush()

    def finish(self) -> Dict:
        """the child's result with the region's state after its exit, the
        quota, the bounds and the gates; ``rc`` the child's exit code and
        ``error`` its stderr's tail when it gave no result"""
        from ..enforce.region import RegionView

        try:
            out, err = self.proc.communicate("", timeout=CHILD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            out, err = self.proc.communicate()
        lines = out.strip().splitlines()
        try:
            res = json.loads(lines[-1])
        except (IndexError, ValueError):
            return {"rc": self.proc.returncode, "error": err[-2000:],
                    "quota_bytes": QUOTA_BYTES, "ok": False}
        res["rc"] = self.proc.returncode
        with RegionView(self.cache) as view:
            res["region_clean_after_exit"] = (
                view.procs() == [] and view.used(0) == 0
                and view.host_used() == 0)
        res["quota_bytes"] = QUOTA_BYTES
        res["host_limit_bytes"] = HOST_LIMIT_BYTES
        res.update(bounds(res["placement_bytes"]))
        res["gates"] = gates(res)
        res["ok"] = res["rc"] == 0 and all(res["gates"].values())
        return res


def run(backend: str = "cuda") -> Dict:
    root = tempfile.mkdtemp(prefix="vgpu_memspace_")
    try:
        return Probe(root, backend).finish()
    finally:
        shutil.rmtree(root, ignore_errors=True)


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m vtpu_torch.bench.memspace",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="also write the result to this file")
    ap.add_argument("--backend", choices=["cuda", "mock"], default="cuda")
    ap.add_argument("--child", choices=["cuda", "mock"], default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--hold", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        return child(args.child, args.hold)
    res = run(args.backend)
    if res.get("rc") == 2 and "error" in res:
        print(res["error"].strip().splitlines()[-1], file=sys.stderr)
        return 2
    line = json.dumps(res)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
            f.write("\n")
    return 0 if res["ok"] else 1


# ------------------------------------------------------------------ child

class Driver:
    """The driver's entry points through ``cuGetProcAddress_v2``, as the
    CUDA 12 runtime resolves them (so the interposer's hooks answer)."""

    def __init__(self):
        import ctypes
        from ctypes import CFUNCTYPE, POINTER, byref, c_int, c_uint64

        self.ct = ctypes
        self.cu = ctypes.CDLL("libcuda.so.1")
        self.vg = ctypes.CDLL(os.environ["LD_PRELOAD"])
        # (the mock driver has neither call: it asks for CUDA 12.8's)
        version = c_int(12080)
        if hasattr(self.cu, "cuInit"):
            self.cu.cuInit(0)
            self.cu.cuDriverGetVersion(byref(version))
        self.version = version.value
        self._gpa = CFUNCTYPE(c_int, ctypes.c_char_p,
                              POINTER(ctypes.c_void_p), c_int, c_uint64,
                              POINTER(c_int))(ctypes.cast(
                                  self.cu.cuGetProcAddress_v2,
                                  ctypes.c_void_p).value)

    def address(self, base: str) -> int:
        ct = self.ct
        p, st = ct.c_void_p(), ct.c_int(-1)
        rc = self._gpa(base.encode(), ct.byref(p), self.version, 0,
                       ct.byref(st))
        if rc or st.value or not p.value:
            raise RuntimeError(f"cuGetProcAddress_v2({base}) rc {rc}, "
                               f"status {st.value}")
        return p.value

    def fn(self, base: str, *argtypes):
        return self.ct.CFUNCTYPE(self.ct.c_int, *argtypes)(self.address(base))

    def hooked(self, base: str, export: str) -> bool:
        return self.address(base) == self.ct.cast(
            getattr(self.vg, export), self.ct.c_void_p).value

    def managed(self):
        """(alloc(bytes) -> (rc, address), free(address) -> rc, hooked)"""
        ct = self.ct
        alloc = self.fn("cuMemAllocManaged", ct.POINTER(ct.c_uint64),
                        ct.c_size_t, ct.c_uint)
        free = self.fn("cuMemFree", ct.c_uint64)

        def allocate(n: int):
            p = ct.c_uint64()
            rc = alloc(ct.byref(p), n, CU_MEM_ATTACH_GLOBAL)
            return rc, p.value

        return allocate, free, self.hooked("cuMemAllocManaged",
                                           "cuMemAllocManaged")

    def managed_supported(self) -> bool:
        ct = self.ct
        get = getattr(self.cu, "cuDeviceGetAttribute", None)
        if get is None:
            return True
        v = ct.c_int(0)
        return get(ct.byref(v), CU_DEVICE_ATTRIBUTE_MANAGED_MEMORY, 0) != 0 \
            or v.value == 1


def child(backend: str, hold: bool) -> int:
    if hold and sys.stdin.readline() != "go\n":
        return 0  # started ahead, its turn never came
    from ..enforce import install

    enf = install()

    def charge() -> int:
        """the device charge less the footprint charge"""
        return enf.used(0) - enf.footprint()["bytes"]

    if backend == "mock":
        res = _mock_child(enf, charge)
    else:
        import torch
        if not torch.cuda.is_available():
            print("memspace: no CUDA device", file=sys.stderr)
            return 2
        res = _cuda_child(enf, charge)
    res["backend"] = backend
    res["placement_bytes"] = PLACEMENT_BYTES
    res["footprint_mode"] = enf.footprint()["mode"]
    enf.stop()
    print(json.dumps(res), flush=True)
    return 0


def _placed(res: Dict, kind: str, charge, host_used, place):
    """``place()`` one placement of ``kind``; its device charge and host
    ledger charge recorded; what it returned"""
    d0, h0 = charge(), host_used()
    out = place()
    res[f"{kind}_device_bytes"] = charge() - d0
    res[f"{kind}_ledger_bytes"] = host_used() - h0
    return out


def _cuda_child(enf, charge) -> Dict:
    import statistics

    import torch

    drv = Driver()
    n = PLACEMENT_BYTES // 4
    cuda = torch.device("cuda")
    res: Dict = {"memory_kinds": ["device", "pinned_host", "unpinned_host",
                                  "registered_host"]
                 + (["managed"] if drv.managed_supported() else [])}

    def settle():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch._C._host_emptyCache()

    # warm-up: every kernel and copy the probe runs, once, so that their
    # first launches move the footprint charge before any reading
    x = torch.ones(n, device=cuda)
    h = torch.empty(n, pin_memory=True)
    p = torch.empty(n)
    (x + 0).sum().item()
    h.copy_(x, non_blocking=True)
    x.copy_(h, non_blocking=True)
    p.copy_(x)
    x.copy_(p)
    del x, h, p
    settle()
    host_used = enf.host_used

    x = _placed(res, "device", charge, host_used,
                lambda: torch.ones(n, device=cuda))
    torch.cuda.synchronize()
    res["shim_used_device_bytes"] = res.pop("device_device_bytes")
    res.pop("device_ledger_bytes")
    h = _placed(res, "pinned_host", charge, host_used,
                lambda: torch.empty(n, pin_memory=True))
    res["host_put_ok"] = bool(h.is_pinned())
    h.copy_(x, non_blocking=True)
    torch.cuda.synchronize()
    res["host_copy_equal"] = bool(torch.equal(h, x.cpu()))
    res["shim_charged_for_host_copy_bytes"] = max(
        0, res["pinned_host_device_bytes"])
    p = _placed(res, "unpinned_host", charge, host_used,
                lambda: torch.empty(n))
    p.copy_(x)
    cudart = torch.cuda.cudart()
    r = torch.empty(n)
    rc = _placed(res, "registered_host", charge, host_used,
                 lambda: int(cudart.cudaHostRegister(
                     r.data_ptr(), PLACEMENT_BYTES, 0)))
    res["registered_rc"] = rc
    allocate, free, hooked = drv.managed()
    res["managed_hooked"] = hooked
    rc, m = _placed(res, "managed", charge, host_used,
                    lambda: allocate(PLACEMENT_BYTES))
    res["managed_rc"] = rc
    try:
        torch.empty(HOST_LIMIT_BYTES, dtype=torch.uint8, pin_memory=True)
        res["pinned_past_host_limit"] = "allocated"
    except RuntimeError as e:
        res["pinned_past_host_limit"] = str(e).splitlines()[0]
    rc_over, m_over = allocate(QUOTA_BYTES)
    res["managed_past_quota_rc"] = rc_over
    if rc_over == 0:
        free(m_over)

    def timed(fn) -> float:
        fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(REPS):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            ts.append(a.elapsed_time(b) / 1e3)
        return statistics.median(ts)

    d = torch.empty(n, device=cuda)
    res["in_hbm_touch_s"] = timed(lambda: x + 0)
    # the JAX key's meaning: the host array put on the device and touched
    res["host_to_hbm_64mb_s"] = timed(
        lambda: d.copy_(h, non_blocking=True) + 0)
    res["roundtrip_penalty_x"] = round(
        res["host_to_hbm_64mb_s"] / max(res["in_hbm_touch_s"], 1e-9), 1)
    res["pinned_to_hbm_copy_s"] = timed(lambda: d.copy_(h, non_blocking=True))
    res["unpinned_to_hbm_copy_s"] = timed(lambda: d.copy_(p))
    res["hbm_to_host_copy_s"] = timed(lambda: h.copy_(x, non_blocking=True))
    res["timing_reps"] = REPS
    res["copies_equal"] = bool(torch.equal(d, x))

    res["managed_free_rc"] = free(m)
    res["unregister_rc"] = int(cudart.cudaHostUnregister(r.data_ptr()))
    del x, h, p, r, d
    settle()
    res["device_bytes_after_free"] = charge()
    res["host_ledger_bytes_after_free"] = enf.host_used()
    return res


def _mock_child(enf, charge) -> Dict:
    """The same placements through the driver's entry points, on the mock
    driver (no timings: it moves no bytes over a link)."""
    import ctypes as ct

    drv = Driver()
    u64p, vpp = ct.POINTER(ct.c_uint64), ct.POINTER(ct.c_void_p)
    retain = drv.fn("cuDevicePrimaryCtxRetain", vpp, ct.c_int)
    alloc = drv.fn("cuMemAlloc", u64p, ct.c_size_t)
    free = drv.fn("cuMemFree", ct.c_uint64)
    host_alloc = drv.fn("cuMemHostAlloc", vpp, ct.c_size_t, ct.c_uint)
    free_host = drv.fn("cuMemFreeHost", ct.c_void_p)
    register = drv.fn("cuMemHostRegister", ct.c_void_p, ct.c_size_t,
                      ct.c_uint)
    unregister = drv.fn("cuMemHostUnregister", ct.c_void_p)
    h2d = drv.fn("cuMemcpyHtoD", ct.c_uint64, ct.c_void_p, ct.c_size_t)
    d2h = drv.fn("cuMemcpyDtoH", ct.c_void_p, ct.c_uint64, ct.c_size_t)
    ctx = ct.c_void_p()
    assert retain(ct.byref(ctx), 0) == 0
    b = PLACEMENT_BYTES
    res: Dict = {"memory_kinds": ["device", "pinned_host", "unpinned_host",
                                  "registered_host"]
                 + (["managed"] if drv.managed_supported() else [])}
    host_used = enf.host_used

    def device():
        p = ct.c_uint64()
        assert alloc(ct.byref(p), b) == 0
        return p.value

    def pinned():
        p = ct.c_void_p()
        rc = host_alloc(ct.byref(p), b, 0)
        return rc, p.value

    x = _placed(res, "device", charge, host_used, device)
    res["shim_used_device_bytes"] = res.pop("device_device_bytes")
    res.pop("device_ledger_bytes")
    rc, h = _placed(res, "pinned_host", charge, host_used, pinned)
    res["host_put_ok"] = rc == 0
    res["shim_charged_for_host_copy_bytes"] = max(
        0, res["pinned_host_device_bytes"])
    page = _placed(res, "unpinned_host", charge, host_used,
                   lambda: ct.create_string_buffer(b))
    res["copies_rc"] = [h2d(x, h, b), d2h(h, x, b),
                        h2d(x, ct.addressof(page), b),
                        d2h(ct.addressof(page), x, b)]
    reg = ct.create_string_buffer(b)
    res["registered_rc"] = _placed(
        res, "registered_host", charge, host_used,
        lambda: register(ct.addressof(reg), b, 0))
    allocate, mfree, res["managed_hooked"] = drv.managed()
    res["managed_rc"], m = _placed(res, "managed", charge, host_used,
                                   lambda: allocate(b))
    over = ct.c_void_p()
    if host_alloc(ct.byref(over), HOST_LIMIT_BYTES, 0) == 0:
        res["pinned_past_host_limit"] = "allocated"
        free_host(over)
    else:
        res["pinned_past_host_limit"] = "refused"
    rc_over, m_over = allocate(QUOTA_BYTES)
    res["managed_past_quota_rc"] = rc_over
    if rc_over == 0:
        mfree(m_over)
    for k in ("in_hbm_touch_s", "host_to_hbm_64mb_s", "roundtrip_penalty_x",
              "pinned_to_hbm_copy_s", "unpinned_to_hbm_copy_s",
              "hbm_to_host_copy_s"):
        res[k] = None  # not measured: the mock moves no bytes over a link
    res["managed_free_rc"] = mfree(m)
    res["unregister_rc"] = unregister(ct.addressof(reg))
    res["free_rcs"] = [free(x), free_host(h)]
    res["device_bytes_after_free"] = charge()
    res["host_ledger_bytes_after_free"] = enf.host_used()
    return res


if __name__ == "__main__":
    sys.exit(main())
