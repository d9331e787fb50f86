"""The code-memory probe: every driver entry point that loads code, under
``libvgpu.so``, against what the card holds.

The JAX shim charges a program's device memory where it is compiled or
deserialized, refuses one that does not fit, and releases the charge where
the program is destroyed (``lib/vtpu/libvtpu.c:2114-2250``). A CUDA pod
reaches the card's code through nine routes, which ``libvgpu.so`` measures
where NVML cannot tell processes apart (context mode, as on the measured
H100):

- the loads ``cuModuleLoad`` (a cubin's file), ``cuModuleLoadData`` (a
  cubin), ``cuModuleLoadDataEx`` (PTX, compiled by the driver),
  ``cuModuleLoadFatBinary`` (a fatbin), ``cuLibraryLoadData`` (a fatbin,
  its module looked up), ``cuLibraryLoadFromFile`` (a cubin's file);
- the look-ups ``cuLibraryGetKernel`` with ``cuKernelGetFunction``, the
  globals (``cuLibraryGetGlobal``, ``cuModuleGetGlobal_v2``), and a
  tenant's own ``cuFuncLoad`` before its first launch.

A child process runs as a pod does: ``libvgpu.so`` preloaded, its own
region file, a 2 GiB quota. It makes its context with the driver API alone
(no torch) and resolves every entry point through ``cuGetProcAddress_v2``,
as the CUDA 12 runtime does (``dlsym`` on libcuda's own handle would miss a
preloaded interposer). The module (``vtpu_torch/csrc/codemem_fixture.cu``,
built with nvcc for sm_90a by :func:`vtpu_torch.native.cuda_fixtures`)
holds 256 MiB of ``__device__`` globals and one kernel that writes them.
The phase, each step read by the parent off the card and the region:

1. each route loads the module, looks it up, launches the kernel once and
   unloads it: after the launch and after the unload the card's growth
   since the child started, against the region's charge, holds the F6
   bounds (at most 2% of the quota unaccounted, at most 5% over-charged),
   and the card grew by the module's 256 MiB at least; where each route's
   growth landed (the load, the look-ups, the launch) is printed;
2. 50 load/unload cycles on one route end within the same bounds, the
   charge within them of where it began;
3. a module of 3 GiB of globals, past the quota, is refused with
   ``CUDA_ERROR_OUT_OF_MEMORY``: the card back within 256 MiB, the charge
   unmoved, a later small load served;
4. a second child under ``ACTIVE_OOM_KILLER`` dies by SIGKILL at that load;
5. the first child's region is clean after it exits.

    python -m vtpu_torch.bench.codemem                  # card 0
    python -m vtpu_torch.bench.codemem --backend mock   # the mock driver

One JSON line; exit 0 when every gate holds, 1 when one fails, 2 with no
card (and no ``--backend mock``). The parent imports no torch; it reads the
card through NVML (on the mock: the mock driver's process files).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from typing import Callable, Dict, Optional

from .. import api, native
from .memspace import REPO, Driver, mock_env

MiB = 1 << 20
GiB = 1 << 30
QUOTA_BYTES = 2 * GiB
#: the fixture's globals, and the module past the quota
FIXTURE_BYTES = 256 * MiB
BIG_BYTES = 3 * GiB
CHURN_CYCLES = 50
#: the card after a refused load, against before it
CARD_BACK_BYTES = 256 * MiB
#: what the card shows past the region's charge, and the reverse, against
#: the quota: chip_smoke.py's F6 bounds
UNACCOUNTED_MAX = 0.02
OVER_CHARGE_MAX = 0.05
CUDA_ERROR_OUT_OF_MEMORY = 2
KERNEL = b"codemem_touch"
GLOBAL = b"codemem_data0"
#: a launch of the kernel: the card's 132 SMs, four blocks each
GRID, BLOCK = 528, 256
#: what the card holds for the run's processes: the least it shows over
#: this long (a host's probe outside every process list makes a context for
#: ~110 ms now and then, chip_smoke.py's CARD_READ_S)
CARD_READ_S = 0.25
CHILD_TIMEOUT_S = 300
#: the entry points as the CUDA 12.8 runtime asks for them (PyTorch's build
#: on the measured machine), with the signatures above: a CUDA 13 driver
#: answers cuCtxSynchronize with cuCtxSynchronize_v2, which takes a context
CUDA_VERSION = 12080

ROUTES = ("cuModuleLoad", "cuModuleLoadData", "cuModuleLoadDataEx",
          "cuModuleLoadFatBinary", "cuLibraryLoadData",
          "cuLibraryLoadFromFile", "cuLibraryGetKernel", "GetGlobal",
          "cuFuncLoad")
#: the routes whose load makes a library, not a module
LIBRARY_ROUTES = ("cuLibraryLoadData", "cuLibraryLoadFromFile",
                  "cuLibraryGetKernel", "GetGlobal")
CHURN_ROUTE = REFUSAL_ROUTE = "cuModuleLoadData"
#: vgpu_footprint's mode where NVML cannot tell processes apart
FP_CONTEXT = 3
#: each entry point the child calls: base name -> (libcuda's symbol, the
#: argument types after the result)
P = ctypes.POINTER
_V, _U, _S = ctypes.c_void_p, ctypes.c_uint, ctypes.c_char_p
_LIB_OPTS = (_V, _V, _U, _V, _V, _U)
ENTRY_POINTS = {
    "cuDevicePrimaryCtxRetain": ("cuDevicePrimaryCtxRetain",
                                 (P(_V), ctypes.c_int)),
    "cuModuleLoad": ("cuModuleLoad", (P(_V), _S)),
    "cuModuleLoadData": ("cuModuleLoadData", (P(_V), _V)),
    "cuModuleLoadDataEx": ("cuModuleLoadDataEx", (P(_V), _V, _U, _V, _V)),
    "cuModuleLoadFatBinary": ("cuModuleLoadFatBinary", (P(_V), _V)),
    "cuModuleUnload": ("cuModuleUnload", (_V,)),
    "cuModuleGetFunction": ("cuModuleGetFunction", (P(_V), _V, _S)),
    "cuModuleGetGlobal": ("cuModuleGetGlobal_v2",
                          (P(ctypes.c_uint64), P(ctypes.c_size_t), _V, _S)),
    "cuLibraryLoadData": ("cuLibraryLoadData", (P(_V), _V) + _LIB_OPTS),
    "cuLibraryLoadFromFile": ("cuLibraryLoadFromFile",
                              (P(_V), _S) + _LIB_OPTS),
    "cuLibraryUnload": ("cuLibraryUnload", (_V,)),
    "cuLibraryGetModule": ("cuLibraryGetModule", (P(_V), _V)),
    "cuLibraryGetKernel": ("cuLibraryGetKernel", (P(_V), _V, _S)),
    "cuLibraryGetGlobal": ("cuLibraryGetGlobal",
                           (P(ctypes.c_uint64), P(ctypes.c_size_t), _V, _S)),
    "cuKernelGetFunction": ("cuKernelGetFunction", (P(_V), _V)),
    "cuFuncLoad": ("cuFuncLoad", (_V,)),
    "cuLaunchKernel": ("cuLaunchKernel", (_V,) + (_U,) * 7 + (_V, _V, _V)),
    "cuCtxSynchronize": ("cuCtxSynchronize", ()),
}
#: the mock card (--backend mock): its context, a function's load and a
#: library's module (the caller's env wins); a load takes the fixture's
#: bytes (the child sets MOCK_CUDA_LOAD_BYTES at each)
MOCK_ENV = {"MOCK_CUDA_CTX_BYTES": "64m", "MOCK_CUDA_FUNC_BYTES": "2m",
            "MOCK_CUDA_MODULE_BYTES": "8m", "MOCK_GPU_PROCS_SHARED": "1"}


# ------------------------------------------------------------------ child

class Code:
    """The child's driver: its context made, the fixture's images read,
    every entry point resolved through ``cuGetProcAddress_v2`` (``direct``:
    by its symbol on libcuda's handle, as a program linked to libcuda
    reaches it)."""

    def __init__(self, backend: str, fixtures: str, direct: bool = False):
        self.backend = backend
        self.drv = Driver()
        self.drv.version = min(self.drv.version, CUDA_VERSION)
        ct = ctypes
        self.fns, self.hooked = {}, {}
        for base, (exact, argtypes) in ENTRY_POINTS.items():
            addr = (ct.cast(getattr(self.drv.cu, exact), _V).value if direct
                    else self.drv.address(base))
            self.fns[base] = ct.CFUNCTYPE(ct.c_int, *argtypes)(addr)
            ours = getattr(self.drv.vg, exact, None)
            self.hooked[base] = (ours is not None and addr
                                 == ct.cast(ours, _V).value)
        self.paths = {name: os.path.join(fixtures, name)
                      for name in native.FIXTURES}
        # the images, NUL-terminated (the PTX must be), kept alive
        self.images = {}
        for name, path in self.paths.items():
            with open(path, "rb") as f:
                self.images[name] = ct.create_string_buffer(f.read())
        self.vg = self.drv.vg
        self.vg.vgpu_footprint.argtypes = [ct.c_int, P(ct.c_uint64)]
        self.ctx = _V()
        self.call("cuDevicePrimaryCtxRetain", ct.byref(self.ctx), 0)
        if backend == "cuda":
            ct.CFUNCTYPE(ct.c_int, _V)(self.drv.address("cuCtxSetCurrent"))(
                self.ctx)
        self.held = None  # (handle, library) of the module open

    def call(self, base: str, *args) -> None:
        rc = self.fns[base](*args)
        if rc:
            raise RuntimeError(f"{base} returned {rc}")

    def footprint(self) -> list:
        fp = (ctypes.c_uint64 * 8)()
        self.vg.vgpu_footprint(0, fp)
        return list(fp)

    def charge(self) -> int:
        """the footprint charge: the context and what code took"""
        return self.footprint()[2]

    def counters(self) -> Dict:
        first, code = (ctypes.c_uint64 * 6)(), (ctypes.c_uint64 * 8)()
        self.vg.vgpu_footprint_launches(first)
        self.vg.vgpu_code_memory(code)
        return {"calls_measured": first[0], "load_bytes": first[1],
                "call_bytes": first[2], "shrank": first[3],
                "loads": code[0], "refused": code[1], "unloads": code[2],
                "released": code[3], "recorded": code[4],
                "recorded_bytes": code[5], "dropped": code[6],
                "unattributed": code[7]}

    def open(self, route: str, big: bool = False) -> Dict:
        """``route``'s load, look-ups and one launch, the module kept open;
        the footprint charge each stage added (rc != 0: the load refused)"""
        ct = ctypes
        cubin = "codemem_3g.cubin" if big else "codemem.cubin"
        stages, mark = {}, [self.charge()]

        def stage(name):
            now = self.charge()
            stages[name] = stages.get(name, 0) + now - mark[0]
            mark[0] = now

        h = _V()
        library = route in LIBRARY_ROUTES
        image = {"cuModuleLoadDataEx": "codemem.ptx",
                 "cuModuleLoadFatBinary": "codemem.fatbin",
                 "cuLibraryLoadData": "codemem.fatbin",
                 "GetGlobal": "codemem.fatbin"}.get(route, cubin)
        if self.backend == "mock":  # a stand-in names what it takes
            os.environ["MOCK_CUDA_LOAD_BYTES"] = (
                self.images[image].value.decode().split()[0])
        if route in ("cuModuleLoad", "cuLibraryLoadFromFile"):
            rc = self.fns[route](ct.byref(h), self.paths[image].encode(),
                                 *((None, None, 0) * 2 if library else ()))
        elif route == "cuModuleLoadDataEx":
            rc = self.fns[route](ct.byref(h), self.images[image], 0, None,
                                 None)
        elif library:
            rc = self.fns["cuLibraryLoadData"](ct.byref(h),
                                               self.images[image],
                                               None, None, 0, None, None, 0)
        else:
            load = ("cuModuleLoadFatBinary" if route == "cuModuleLoadFatBinary"
                    else "cuModuleLoadData")
            rc = self.fns[load](ct.byref(h), self.images[image])
        stage("load")
        if rc:
            return {"rc": rc, "charged": stages, "handle": h.value}
        self.held = (h.value, library)
        try:
            self._use(route, h, library, stage)
        except Exception:
            self.close()
            raise
        return {"rc": 0, "charged": stages, "handle": h.value}

    def _use(self, route: str, h, library: bool, stage) -> None:
        """the open module's look-ups and one launch of its kernel"""
        ct = ctypes
        f, mod, kernel = _V(), _V(), _V()
        ptr, size = ct.c_uint64(), ct.c_size_t()
        if route == "GetGlobal":
            self.call("cuLibraryGetGlobal", ct.byref(ptr), ct.byref(size), h,
                      GLOBAL)
            self.call("cuLibraryGetModule", ct.byref(mod), h)
            self.call("cuModuleGetGlobal", ct.byref(ptr), ct.byref(size), mod,
                      GLOBAL)
        if route in ("cuLibraryGetKernel", "GetGlobal"):
            self.call("cuLibraryGetKernel", ct.byref(kernel), h, KERNEL)
            self.call("cuKernelGetFunction", ct.byref(f), kernel)
        else:
            if library:
                self.call("cuLibraryGetModule", ct.byref(mod), h)
            self.call("cuModuleGetFunction", ct.byref(f),
                      mod if library else h, KERNEL)
        stage("lookup")
        if route == "cuFuncLoad":
            self.call("cuFuncLoad", f)
            stage("cuFuncLoad")
        self.call("cuLaunchKernel", f, GRID, 1, 1, BLOCK, 1, 1, 0, None,
                  None, None)
        self.call("cuCtxSynchronize")
        stage("launch")

    def close(self) -> Dict:
        """the open module unloaded: the charge it gave back"""
        handle, library = self.held
        self.held = None
        before = self.charge()
        rc = self.fns["cuLibraryUnload" if library else "cuModuleUnload"](
            handle)
        return {"rc": rc, "released": before - self.charge()}

    def churn(self, route: str, cycles: int) -> Dict:
        before, t0 = self.charge(), time.perf_counter()
        for _ in range(cycles):
            opened = self.open(route)
            closed = self.close()
            if opened["rc"] or closed["rc"]:
                raise RuntimeError(f"cycle: {opened} {closed}")
        return {"cycles": cycles, "before": before, "after": self.charge(),
                "seconds": time.perf_counter() - t0}


def child(backend: str, fixtures: str, hold: bool, direct: bool) -> int:
    """One JSON reply per JSON command (``open``, ``close``, ``churn``,
    ``counters``, ``footprint``), after a first line once the context is
    made."""
    if hold and sys.stdin.readline() != "go\n":
        return 0
    t0 = time.perf_counter()
    code = Code(backend, fixtures, direct)
    print(json.dumps({"ready": True, "footprint": code.footprint(),
                      "hooked": code.hooked, "pid": os.getpid(),
                      "context_ms": (time.perf_counter() - t0) * 1e3}),
          flush=True)
    ops = {"open": lambda c: code.open(c["route"], c.get("big", False)),
           "close": lambda c: code.close(),
           "churn": lambda c: code.churn(c["route"], c["cycles"]),
           "counters": lambda c: code.counters(),
           "footprint": lambda c: {"footprint": code.footprint()}}
    for line in sys.stdin:
        cmd = json.loads(line)
        try:
            reply = ops[cmd["op"]](cmd)
        except Exception as e:  # reported to the parent, which fails
            reply = {"error": f"{type(e).__name__}: {e}"}
        print(json.dumps(reply), flush=True)
    return 0


# ----------------------------------------------------------------- parent

def mock_fixtures(root: str, small: int = FIXTURE_BYTES,
                  big: int = BIG_BYTES) -> str:
    """stand-ins for the fixture's files on the mock driver, which reads no
    image: each holds the bytes its load takes (the child sets
    MOCK_CUDA_LOAD_BYTES to them), ``big`` the 3 GiB module's"""
    out = os.path.join(root, "fixtures")
    os.makedirs(out, exist_ok=True)
    for name, (_, parts, _) in native.FIXTURES.items():
        with open(os.path.join(out, name), "w") as f:
            f.write(f"{big if parts > 1 else small} bytes on the mock card "
                    f"for {name}\n")
    return out


def child_env(root: str, name: str, backend: str, lock_dir: str,
              killer: bool = False, env: Optional[Dict] = None):
    """(region file, environment) of a pod named ``name`` under ``root``:
    libvgpu.so preloaded, QUOTA_BYTES, the node's ``lock_dir``, ``killer``
    with ACTIVE_OOM_KILLER, on the mock the mock driver and NVML; ``env``
    added last (None: a name taken out)"""
    cache = os.path.join(root, "containers", f"{name}_0", api.CACHE_FILENAME)
    os.makedirs(os.path.dirname(cache), exist_ok=True)
    full = {k: v for k, v in os.environ.items() if not k.startswith(
        ("CUDA_DEVICE_", "CUDA_HOST_", "CUDA_DISABLE", "LD_PRELOAD",
         api.ENV_ACTIVE_OOM_KILLER))}
    if backend == "mock":
        full.update(mock_env(root))
        full.update({k: os.environ.get(k, v) for k, v in MOCK_ENV.items()})
    full.update({
        "LD_PRELOAD": native.interposer(),
        api.ENV_SHARED_CACHE: cache,
        api.ENV_DEVICE_MEMORY_LIMIT: str(QUOTA_BYTES),
        api.ENV_LOCK_DIR: lock_dir,
        "PYTHONPATH": os.pathsep.join(
            [REPO] + [p for p in full.get("PYTHONPATH", "").split(
                os.pathsep) if p]),
    })
    if killer:
        full[api.ENV_ACTIVE_OOM_KILLER] = "1"
    for key, value in (env or {}).items():
        if value is None:
            full.pop(key, None)
        else:
            full[key] = value
    return cache, full


class Child:
    """A probe child, a pod under ``libvgpu.so`` with its own region under
    ``root`` (:func:`child_env`). ``hold``: it loads its interpreter and
    waits for :meth:`go` before it touches the card."""

    def __init__(self, root: str, name: str, backend: str, fixtures: str,
                 lock_dir: str, hold: bool = False, killer: bool = False,
                 direct: bool = False, env: Optional[Dict] = None):
        self.name = name
        self.cache, full = child_env(root, name, backend, lock_dir, killer,
                                     env)
        argv = [sys.executable, "-m", "vtpu_torch.bench.codemem", "--child",
                backend, "--fixtures", fixtures]
        argv += ["--hold"] * hold + ["--direct"] * direct
        self.errf = open(os.path.join(root, f"{name}.err"), "w+")
        self.proc = subprocess.Popen(
            argv, env=full, cwd=root, stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, stderr=self.errf, text=True)

    def go(self) -> Dict:
        """a held child's turn; its first line (its context is made)"""
        self.proc.stdin.write("go\n")
        self.proc.stdin.flush()
        return self.read()

    def err(self) -> str:
        self.errf.seek(0)
        return self.errf.read()

    def read(self) -> Dict:
        line = self.proc.stdout.readline()
        if not line:
            self.proc.wait(timeout=CHILD_TIMEOUT_S)
            raise RuntimeError(f"{self.name} child gave no answer, rc "
                               f"{self.proc.returncode}:\n"
                               f"{self.err()[-3000:]}")
        reply = json.loads(line)
        if "error" in reply:
            raise RuntimeError(f"{self.name} child: {reply['error']}")
        return reply

    def send(self, op: str, **args) -> None:
        self.proc.stdin.write(json.dumps(dict(args, op=op)) + "\n")
        self.proc.stdin.flush()

    def ask(self, op: str, **args) -> Dict:
        self.send(op, **args)
        return self.read()

    def finish(self) -> int:
        """its exit code once its input is closed (its stderr kept in
        ``stderr``)"""
        try:
            self.proc.communicate("", timeout=CHILD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
        self.stderr = self.err()
        self.errf.close()
        return self.proc.returncode

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=60)
        if not self.errf.closed:
            self.errf.close()


def start(root: str, backend: str, lock_dir: str, hold: bool = True,
          fixtures: Optional[str] = None) -> Dict[str, Child]:
    """The phase's two children (the pod and the one under
    ACTIVE_OOM_KILLER), started and held: their interpreters load while
    another phase runs. ``fixtures``: the directory of the fixture's files
    (default: built with nvcc, or stand-ins on the mock)."""
    if fixtures is None:
        fixtures = (mock_fixtures(root) if backend == "mock" else
                    os.path.dirname(native.cuda_fixtures()["codemem.cubin"]))
    return {"pod": Child(root, "codemem", backend, fixtures, lock_dir, hold),
            "killer": Child(root, "codemem-killer", backend, fixtures,
                            lock_dir, hold, killer=True)}


def within(grew: int, charged: int) -> bool:
    """the card's growth against the region's charge: the F6 bounds"""
    return (grew - charged <= UNACCOUNTED_MAX * QUOTA_BYTES
            and charged - grew <= OVER_CHARGE_MAX * QUOTA_BYTES)


def phase(children: Dict[str, Child],
          card_used: Callable[[], int]) -> Dict:
    """The probe's steps over ``children`` (:func:`start`), the card read
    by ``card_used()`` (its used bytes, read while the children hold
    still); the result with its gates, ``ok`` when every gate holds. A step
    that raises fails its gate, its error kept, and the next step runs."""
    from ..enforce.region import RegionView

    pod, killer = children["pod"], children["killer"]
    t0 = time.perf_counter()
    base = card_used()
    ready = pod.go()
    gates = {"every entry point hooked": all(ready["hooked"].values()),
             "context mode": ready["footprint"][0] == FP_CONTEXT}
    res = {"quota_bytes": QUOTA_BYTES, "fixture_bytes": FIXTURE_BYTES,
           "footprint_mode": ready["footprint"][0],
           "context_charge": ready["footprint"][2],
           "context_ms": ready["context_ms"], "hooked": ready["hooked"],
           "routes": {}, "errors": {}}

    def held():
        """the card's growth since the pod started, and its region's
        charge"""
        grew = card_used() - base
        with RegionView(pod.cache) as view:
            return grew, view.used(0)

    def step(name: str, fn) -> None:
        try:
            gates[name] = bool(fn())
        except Exception as e:  # recorded; the phase fails on the gate
            gates[name] = False
            res["errors"][name] = f"{type(e).__name__}: {e}"

    def route_step(route: str, before: int) -> bool:
        opened = pod.ask("open", route=route)
        grew, charged = held()
        closed = pod.ask("close") if opened["rc"] == 0 else {"rc": None}
        grew2, charged2 = held()
        res["routes"][route] = {
            "rc": opened["rc"], "charged": opened["charged"],
            # the stage that added the most
            "lands": max(opened["charged"], key=opened["charged"].get),
            "card_grew": grew - before,
            "open": [grew, charged], "released": closed.get("released"),
            "closed": [grew2, charged2]}
        gates[f"{route}: released"] = (closed["rc"] == 0
                                       and within(grew2, charged2))
        return (opened["rc"] == 0 and grew - before >= FIXTURE_BYTES
                and within(grew, charged))

    for route in ROUTES:
        step(f"{route}: charged", lambda r=route: route_step(r, held()[0]))

    def churn_step() -> bool:
        grew0, charged0 = held()
        churn = pod.ask("churn", route=CHURN_ROUTE, cycles=CHURN_CYCLES)
        grew1, charged1 = held()
        res["churn"] = dict(churn, route=CHURN_ROUTE,
                            start=[grew0, charged0], end=[grew1, charged1])
        return (within(grew1, charged1)
                and -UNACCOUNTED_MAX * QUOTA_BYTES <= charged1 - charged0
                <= OVER_CHARGE_MAX * QUOTA_BYTES)

    def refusal_step() -> bool:
        grew1, charged1 = held()
        refused = pod.ask("open", route=REFUSAL_ROUTE, big=True)
        grew2, charged2 = held()
        if refused["rc"] == 0:
            pod.ask("close")
        later = pod.ask("open", route=REFUSAL_ROUTE)
        later_closed = pod.ask("close")
        res["refusal"] = {"rc": refused["rc"], "charged": refused["charged"],
                          "before": [grew1, charged1],
                          "after": [grew2, charged2],
                          "later_rc": [later["rc"], later_closed["rc"]]}
        return (refused["rc"] == CUDA_ERROR_OUT_OF_MEMORY
                and abs(grew2 - grew1) <= CARD_BACK_BYTES
                and charged2 == charged1
                and later["rc"] == 0 and later_closed["rc"] == 0)

    def counters_step() -> bool:
        res["counters"] = c = pod.ask("counters")
        return c["dropped"] == 0 and c["refused"] == 1

    def exit_step() -> bool:
        res["pod_rc"] = rc = pod.finish()
        with RegionView(pod.cache) as view:
            return rc == 0 and view.procs() == [] and view.used(0) == 0

    def killer_step() -> bool:
        killer.go()
        killer.send("open", route=REFUSAL_ROUTE, big=True)
        res["killer_rc"] = killer.finish()
        with RegionView(killer.cache) as view:
            res["killer_oom_events"] = view.snapshot().oom_events
        return res["killer_rc"] == -signal.SIGKILL

    step("churn ends where it began", churn_step)
    step("a load past the quota refused", refusal_step)
    step("no code memory dropped, one load refused", counters_step)
    step("region clean after exit", exit_step)
    step("killed at the load under ACTIVE_OOM_KILLER", killer_step)
    res["gates"] = gates
    res["ok"] = all(gates.values())
    if not res["ok"]:
        res["pod_stderr"] = getattr(pod, "stderr", "")[-4000:]
        res["killer_stderr"] = getattr(killer, "stderr", "")[-1000:]
    res["seconds"] = time.perf_counter() - t0
    return res


def mock_card_used(procs: str) -> Callable[[], int]:
    """the mock card's used bytes: its processes' files"""
    def used() -> int:
        total = 0
        for name in os.listdir(procs):
            if name.isdigit():
                with open(os.path.join(procs, name)) as f:
                    fields = f.read().split()
                total += int(fields[1]) if len(fields) == 2 else 0
        return total
    return used


def nvml_card_used() -> Callable[[], int]:
    """card 0's used bytes through NVML, the least over CARD_READ_S"""
    class Memory(ctypes.Structure):
        _fields_ = [("total", ctypes.c_ulonglong),
                    ("free", ctypes.c_ulonglong),
                    ("used", ctypes.c_ulonglong)]

    nvml = ctypes.CDLL("libnvidia-ml.so.1")
    handle = ctypes.c_void_p()
    if nvml.nvmlInit_v2() or nvml.nvmlDeviceGetHandleByIndex_v2(
            0, ctypes.byref(handle)):
        raise RuntimeError("NVML cannot read card 0")

    def used() -> int:
        least, until = None, time.perf_counter() + CARD_READ_S
        while True:
            mem = Memory()
            if nvml.nvmlDeviceGetMemoryInfo(handle, ctypes.byref(mem)):
                raise RuntimeError("NVML cannot read card 0's memory")
            least = mem.used if least is None else min(least, mem.used)
            if time.perf_counter() >= until:
                return least
            time.sleep(0.01)
    return used


def primary_context():
    """card 0's primary context made in this process, outside the
    interposer: a neighbour on the card, as chip_smoke.py's parent is. NVML
    lists every process of the measured machine as one pid, so a pod that
    is the card's only process is the one new entry in its list (PID mode),
    and one beside a neighbour is measured where it loads code (context
    mode). Its handle; the context lives until this process exits."""
    cu = ctypes.CDLL("libcuda.so.1")
    ctx = ctypes.c_void_p()
    if cu.cuInit(0) or cu.cuDevicePrimaryCtxRetain(ctypes.byref(ctx), 0):
        raise RuntimeError("cannot make card 0's primary context")
    return ctx


def run(backend: str = "cuda") -> Dict:
    """the whole probe in a temp dir: the children and the node's lock dir
    of their own"""
    root = tempfile.mkdtemp(prefix="vgpu_codemem_")
    children = {}
    try:
        locks = os.path.join(root, "locks")
        os.makedirs(locks)
        if backend == "mock":
            env = mock_env(root)
            procs = env["MOCK_GPU_PROCS"]
            # a neighbour already on the card: NVML lists every process
            # as one pid, so the pod's footprint is measured (context mode)
            with open(os.path.join(procs, str(os.getpid())), "w") as f:
                f.write(f"{os.getpid()} 0\n")
            card_used = mock_card_used(procs)
        else:
            card_used = nvml_card_used()
            neighbour = primary_context()  # noqa: F841 (held to the end)
        children = start(root, backend, locks)
        return phase(children, card_used)
    finally:
        for c in children.values():
            c.kill()
        shutil.rmtree(root, ignore_errors=True)


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m vtpu_torch.bench.codemem",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--backend", choices=["cuda", "mock"], default="cuda")
    ap.add_argument("--out", default=None,
                    help="also write the result to this file")
    ap.add_argument("--child", choices=["cuda", "mock"], default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--fixtures", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--hold", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--direct", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        return child(args.child, args.fixtures, args.hold, args.direct)
    if args.backend == "cuda":
        try:
            nvml_card_used()
        except (OSError, RuntimeError) as e:
            print(f"codemem: no card: {e}", file=sys.stderr)
            return 2
    res = run(args.backend)
    line = json.dumps(res)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
