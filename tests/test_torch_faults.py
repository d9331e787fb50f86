"""The interposer's repaired faults on the CPU: libvgpu.so LD_PRELOADed into
child processes that drive the mock libcuda.so.1 and the mock
libnvidia-ml.so.1 (vtpu_torch/csrc/mock_cuda.c, mock_nvml.c).

- The device footprint: memory the driver holds for a process that no
  allocation call reaches (the context, modules, graph memory) is charged
  to its slot, read from NVML, so the quota covers the whole process.
- Unified memory and CUDA arrays are charged before the driver allocates
  and refused past the quota, as cuMemAlloc_v2 is.
- A kernel's least measured time is keyed by its argument bytes too, but
  for addresses: one kernel at one shape doing different work is charged
  each call's own time.
- A stream with no SM limit is charged its own busy time, scaled by its
  own sampled busy fraction, beside a stream of another kind.

A released pod taking the no-limit path's spans is in
tests/test_torch_throttle.py."""

import fcntl
import json
import os
import select
import subprocess
import sys
import textwrap
import time

import pytest

from tests.torch_timing import exclusive, timed
from vtpu_torch import api, native
from vtpu_torch.enforce.region import RegionView, SharedRegionStruct

# each test of a heavy file takes tests/torch_timing.py's lock
pytest_plugins = ["tests.torch_timing"]

MiB = 1 << 20
MS = 1_000_000  # ns
UUID0 = "GPU-00000000-0000-0000-0000-000000000000"  # the mock's device 0

CHILD = textwrap.dedent(r"""
    import ctypes, json, os, sys, time
    from ctypes import (CFUNCTYPE, POINTER, byref, c_char_p, c_int,
                        c_size_t, c_uint, c_uint64, c_ulonglong, c_void_p)

    cu = ctypes.CDLL("libcuda.so.1")
    vg = ctypes.CDLL(os.environ["LD_PRELOAD"])
    cu.mock_cuda_busy_ns.restype = c_uint64
    cu.mock_cuda_hidden_alloc.argtypes = [c_size_t]
    GPA2 = CFUNCTYPE(c_int, c_char_p, POINTER(c_void_p), c_int, c_uint64,
                     POINTER(c_int))
    gpa2 = GPA2(ctypes.cast(cu.cuGetProcAddress_v2, c_void_p).value)
    u64p = POINTER(c_ulonglong)
    MiB = 1 << 20

    def via2(base, version=12080):
        p, st = c_void_p(), c_int(-1)
        rc = gpa2(base.encode(), byref(p), version, 0, byref(st))
        assert rc == 0 and st.value == 0, (base, rc, st.value)
        return p.value

    def hooked(base, exact):
        return via2(base) == ctypes.cast(getattr(vg, exact), c_void_p).value

    info = CFUNCTYPE(c_int, POINTER(c_size_t), POINTER(c_size_t))(
        via2("cuMemGetInfo"))
    alloc = CFUNCTYPE(c_int, u64p, c_size_t)(via2("cuMemAlloc"))
    free = CFUNCTYPE(c_int, c_ulonglong)(via2("cuMemFree"))

    def meminfo():
        f, t = c_size_t(), c_size_t()
        assert info(byref(f), byref(t)) == 0
        return [f.value, t.value]

    def footprint():
        fp = (c_uint64 * 8)()
        vg.vgpu_footprint(0, fp)
        return list(fp)

    def wait():
        print(json.dumps(out), flush=True)
        sys.stdin.readline()

    mode = sys.argv[1]
    if mode == "footprint":  # [create]
        # the first context, then 64 MiB at a time until refused
        ctx = c_void_p()
        if sys.argv[2:] == ["create"]:  # cuCtxCreate_v2, as CUDA 11.3 asks
            create = CFUNCTYPE(c_int, POINTER(c_void_p), c_uint, c_int)(
                via2("cuCtxCreate", 11030))
            out = {"hooked": via2("cuCtxCreate", 11030) == ctypes.cast(
                       vg.cuCtxCreate_v2, c_void_p).value,
                   "retain": create(byref(ctx), 0, 0)}
        else:
            retain = CFUNCTYPE(c_int, POINTER(c_void_p), c_int)(
                via2("cuDevicePrimaryCtxRetain"))
            out = {"hooked": hooked("cuDevicePrimaryCtxRetain",
                                    "cuDevicePrimaryCtxRetain"),
                   "retain": retain(byref(ctx), 0)}
        out.update(footprint=footprint(), info=meminfo())
        held, p = [], c_ulonglong()
        while True:
            rc = alloc(byref(p), 64 * MiB)
            if rc:
                out["refused"] = rc
                break
            held.append(p.value)
        out["filled"] = len(held) * 64 * MiB
        wait()
        # memory no hooked call reaches (a module load, a graph's memory)
        cu.mock_cuda_hidden_alloc(32 * MiB)
        time.sleep(0.5)
        out = {"footprint": footprint(), "info": meminfo()}
        wait()
        out = {"freed": [free(h) for h in held]}
        print(json.dumps(out), flush=True)
    elif mode == "arrays":
        class Desc(ctypes.Structure):
            _fields_ = [("width", c_size_t), ("height", c_size_t),
                        ("format", c_int), ("channels", c_uint)]

        class Desc3(ctypes.Structure):
            _fields_ = [("width", c_size_t), ("height", c_size_t),
                        ("depth", c_size_t), ("format", c_int),
                        ("channels", c_uint), ("flags", c_uint)]

        ENTRIES = [("cuMemAllocManaged", "cuMemAllocManaged"),
                   ("cuArrayCreate", "cuArrayCreate_v2"),
                   ("cuArray3DCreate", "cuArray3DCreate_v2"),
                   ("cuArrayDestroy", "cuArrayDestroy"),
                   ("cuMipmappedArrayCreate", "cuMipmappedArrayCreate"),
                   ("cuMipmappedArrayDestroy", "cuMipmappedArrayDestroy")]
        out = {"hooked": {b: hooked(b, e) for b, e in ENTRIES}}
        managed = CFUNCTYPE(c_int, u64p, c_size_t, c_uint)(
            via2("cuMemAllocManaged"))
        array = CFUNCTYPE(c_int, POINTER(c_void_p), POINTER(Desc))(
            via2("cuArrayCreate"))
        array3d = CFUNCTYPE(c_int, POINTER(c_void_p), POINTER(Desc3))(
            via2("cuArray3DCreate"))
        destroy = CFUNCTYPE(c_int, c_void_p)(via2("cuArrayDestroy"))
        mipmap = CFUNCTYPE(c_int, POINTER(c_void_p), POINTER(Desc3), c_uint)(
            via2("cuMipmappedArrayCreate"))
        mip_destroy = CFUNCTYPE(c_int, c_void_p)(
            via2("cuMipmappedArrayDestroy"))

        def used():
            f, t = meminfo()
            return t - f

        a, b = c_ulonglong(), c_ulonglong()
        out["managed"] = [managed(byref(a), 40 * MiB, 1), used()]
        out["managed_over"] = [managed(byref(b), 30 * MiB, 1), used()]
        out["managed_free"] = [free(a.value), used()]
        h2, h3, hm, hx = c_void_p(), c_void_p(), c_void_p(), c_void_p()
        # 1024 x 1024 float4: 16 MiB
        out["array"] = [array(byref(h2), byref(Desc(1024, 1024, 0x20, 4))),
                        used()]
        # 256 x 256 x 64 uint8: 4 MiB
        out["array3d"] = [array3d(byref(h3), byref(Desc3(
            256, 256, 64, 0x01, 1, 0))), used()]
        # 1024 x 1024 uint8, three levels: 1 MiB + 256 KiB + 64 KiB
        out["mipmap"] = [mipmap(byref(hm), byref(Desc3(
            1024, 1024, 0, 0x01, 1, 0)), 3), used()]
        # 1024 x 1024 x 64 uint8: 64 MiB, past the quota
        out["array_over"] = [array3d(byref(hx), byref(Desc3(
            1024, 1024, 64, 0x01, 1, 0))), used()]
        wait()
        out = {"destroyed": [destroy(h2), destroy(h3), mip_destroy(hm)],
               "used": used()}
        print(json.dumps(out), flush=True)
    elif mode == "args":  # SECONDS WARMUP [noise]: the argument kernel
        # at 1 and 10; with "noise", the kernel that also takes a word that
        # changes at every call and does not change its time
        launch = CFUNCTYPE(c_int, c_void_p, c_uint, c_uint, c_uint, c_uint,
                           c_uint, c_uint, c_uint, c_void_p,
                           POINTER(c_void_p), c_void_p)(via2("cuLaunchKernel"))
        sync = CFUNCTYPE(c_int, c_void_p)(via2("cuStreamSynchronize"))
        work, buf, noise = c_int(), c_uint64(), c_uint64()
        params = (c_void_p * 3)(ctypes.addressof(work),
                                ctypes.addressof(buf),
                                ctypes.addressof(noise))
        kernel = 0xa2 if sys.argv[4:] == ["noise"] else 0xa1
        n = {1: 0, 10: 0}

        def step(i):
            work.value = 1 if i % 2 == 0 else 10
            # a device address, new at every launch: not part of the key
            buf.value = 0x7f0000000000 + (i % 4096) * 4096
            # below 2^40, so no address: uninitialised padding, an offset
            noise.value = int.from_bytes(os.urandom(5), "little")
            assert launch(kernel, 1, 1, 1, 1, 1, 1, 0, None, params,
                          None) == 0
            assert sync(None) == 0
            n[work.value] += 1

        t, i = time.monotonic() + float(sys.argv[3]), 0
        while time.monotonic() < t:
            step(i)
            i += 1
        busy0 = cu.mock_cuda_busy_ns()
        vg.vgpu_flush_launches()
        out = {"warm": True}
        wait()
        t = time.monotonic() + float(sys.argv[2])
        while time.monotonic() < t:
            step(i)
            i += 1
        vg.vgpu_flush_launches()
        keys = (c_uint64 * 7)()
        vg.vgpu_kernel_keys(keys)
        out = {"busy_ns": cu.mock_cuda_busy_ns() - busy0, "launches": n,
               "keys": list(keys)}
        wait()
    elif mode == "first_launches":  # N: functions launched once each
        # the first context, 64 MiB allocated, then N functions launched
        # (each loaded lazily at its first launch, as PyTorch's are), twice,
        # and the modules of N / 4 libraries looked up (the runtime's way to
        # a lazily loaded library, PyTorch's own on the H100), twice
        retain = CFUNCTYPE(c_int, POINTER(c_void_p), c_int)(
            via2("cuDevicePrimaryCtxRetain"))
        get_module = CFUNCTYPE(c_int, POINTER(c_void_p), c_void_p)(
            via2("cuLibraryGetModule", 12000))
        launch = CFUNCTYPE(c_int, c_void_p, c_uint, c_uint, c_uint, c_uint,
                           c_uint, c_uint, c_uint, c_void_p, c_void_p,
                           c_void_p)(via2("cuLaunchKernel"))
        sync = CFUNCTYPE(c_int, c_void_p)(via2("cuStreamSynchronize"))
        ctx, p = c_void_p(), c_ulonglong()
        assert retain(byref(ctx), 0) == 0
        assert alloc(byref(p), 64 * MiB) == 0
        for _ in range(2):
            for i in range(int(sys.argv[2])):
                assert launch(0x1000 + 16 * i, 1, 1, 1, 1, 1, 1, 0, None,
                              None, None) == 0
        assert sync(None) == 0
        mod = c_void_p()
        for _ in range(2):
            for i in range(int(sys.argv[2]) // 4):
                assert get_module(byref(mod), 0x5000 + 16 * i) == 0
        first = (c_uint64 * 6)()
        if hasattr(vg, "vgpu_footprint_launches"):  # else none measured
            vg.vgpu_footprint_launches(first)
        out = {"footprint": footprint(), "first_launches": list(first),
               "info": meminfo(), "pid": os.getpid(),
               "hooked": hasattr(vg, "cuLibraryGetModule") and hooked(
                   "cuLibraryGetModule", "cuLibraryGetModule")}
        wait()
    elif mode == "objects":  # streams and small allocations, then freed
        # the first context, 64 MiB allocated, five streams (one with a
        # priority) and 16 allocations of 2,064 B; then the streams
        # destroyed and the small allocations freed
        retain = CFUNCTYPE(c_int, POINTER(c_void_p), c_int)(
            via2("cuDevicePrimaryCtxRetain"))
        create = CFUNCTYPE(c_int, POINTER(c_void_p), c_uint)(
            via2("cuStreamCreate"))
        create_prio = CFUNCTYPE(c_int, POINTER(c_void_p), c_uint, c_int)(
            via2("cuStreamCreateWithPriority"))
        destroy = CFUNCTYPE(c_int, c_void_p)(via2("cuStreamDestroy", 4000))
        ctx, p = c_void_p(), c_ulonglong()
        assert retain(byref(ctx), 0) == 0
        assert alloc(byref(p), 64 * MiB) == 0
        streams = [c_void_p() for _ in range(5)]
        for s in streams[:4]:
            assert create(byref(s), 1) == 0
        assert create_prio(byref(streams[4]), 1, -1) == 0
        small = []
        for _ in range(16):
            assert alloc(byref(p), 2064) == 0
            small.append(p.value)
        objs = (c_uint64 * 5)()

        def objects():
            vg.vgpu_objects(0, objs)
            return [int(x) if x < 1 << 63 else int(x) - (1 << 64)
                    for x in objs]

        out = {"hooked": [hooked(b, e) for b, e in (
                   ("cuStreamCreate", "cuStreamCreate"),
                   ("cuStreamCreateWithPriority",
                    "cuStreamCreateWithPriority"))],
               "footprint": footprint(), "objects": objects(),
               "pid": os.getpid()}
        wait()
        out = {"destroyed": [destroy(s) for s in streams],
               "freed": [free(h) for h in small],
               "footprint": footprint(), "objects": objects()}
        wait()
    elif mode == "streams":  # SECONDS WARMUP: two streams side by side
        import threading
        launch = CFUNCTYPE(c_int, c_void_p, c_uint, c_uint, c_uint, c_uint,
                           c_uint, c_uint, c_uint, c_void_p, c_void_p,
                           c_void_p)(via2("cuLaunchKernel"))
        create = CFUNCTYPE(c_int, POINTER(c_void_p), c_uint)(
            via2("cuStreamCreate"))
        sync = CFUNCTYPE(c_int, c_void_p)(via2("cuStreamSynchronize"))
        cu.mock_cuda_stream_busy_ns.restype = c_uint64
        cu.mock_cuda_stream_busy_ns.argtypes = [c_void_p]
        vg.vgpu_span_stream.argtypes = [c_void_p, c_void_p]
        streams = {"device_bound": c_void_p(), "host_bound": c_void_p()}
        for s in streams.values():
            assert create(byref(s), 0) == 0

        def run(name, seconds):
            # device-bound: back to back, the queue full; host-bound: the
            # host spends longer between two launches than the device on
            # each; neither synchronises until the end
            s, t = streams[name], time.monotonic() + seconds
            while time.monotonic() < t:
                assert launch(None, 1, 1, 1, 1, 1, 1, 0, s, None, None) == 0
                if name == "host_bound":
                    time.sleep(0.0003)
            assert sync(s) == 0

        def both(seconds):
            threads = [threading.Thread(target=run, args=(n, seconds))
                       for n in streams]
            for th in threads:
                th.start()
            for th in threads:
                th.join()
            vg.vgpu_flush_launches()

        def state():
            got = {}
            for name, s in streams.items():
                st = (c_uint64 * 3)()
                assert vg.vgpu_span_stream(s, st) == 1
                got[name] = {"busy_ns": cu.mock_cuda_stream_busy_ns(s),
                             "samples": st[0], "busy_millionths": st[1],
                             "charged_ns": st[2]}
            return got

        both(float(sys.argv[3]))
        before = state()
        out = {"warm": True}
        wait()
        both(float(sys.argv[2]))
        out = {"before": before, "after": state()}
        wait()
    elif mode == "steps":  # SECONDS WARMUP: steps of 32 spans each
        launch = CFUNCTYPE(c_int, c_void_p, c_uint, c_uint, c_uint, c_uint,
                           c_uint, c_uint, c_uint, c_void_p, c_void_p,
                           c_void_p)(via2("cuLaunchKernel"))
        create = CFUNCTYPE(c_int, POINTER(c_void_p), c_uint)(
            via2("cuStreamCreate"))
        sync = CFUNCTYPE(c_int, c_void_p)(via2("cuStreamSynchronize"))
        cu.mock_cuda_stream_busy_ns.restype = c_uint64
        cu.mock_cuda_stream_busy_ns.argtypes = [c_void_p]
        vg.vgpu_span_stream.argtypes = [c_void_p, c_void_p]
        s = c_void_p()
        assert create(byref(s), 0) == 0

        def steps(seconds):
            # a step of 32 parts, each one span (a synchronisation ends
            # it): the first 4 and the last 4 host-bound (two 0.2 ms
            # kernels with 0.5 ms of host between them, spun, since a
            # sleep that overran 2 ms would split the span), the 24 between
            # device-bound (one 1 ms kernel); so the stream's first span,
            # and every 32nd after it, is a host-bound one, and stays so
            # if a few spans split
            t = time.monotonic() + seconds
            while time.monotonic() < t:
                for part in range(32):
                    if part < 4 or part >= 28:
                        assert launch(None, 1, 1, 1, 1, 1, 1, 0, s, None,
                                      None) == 0
                        spin = time.perf_counter() + 0.0005
                        while time.perf_counter() < spin:
                            pass
                        assert launch(None, 1, 1, 1, 1, 1, 1, 0, s, None,
                                      None) == 0
                    else:
                        assert launch(None, 5, 1, 1, 1, 1, 1, 0, s, None,
                                      None) == 0
                    assert sync(s) == 0
            vg.vgpu_flush_launches()

        def state():
            st = (c_uint64 * 3)()
            assert vg.vgpu_span_stream(s, st) == 1
            return {"busy_ns": cu.mock_cuda_stream_busy_ns(s),
                    "samples": st[0], "busy_millionths": st[1],
                    "charged_ns": st[2]}

        steps(float(sys.argv[3]))
        before = state()
        out = {"warm": True}
        wait()
        steps(float(sys.argv[2]))
        out = {"before": before, "after": state()}
        wait()
    elif mode == "hostbound":  # SECONDS WARMUP: kernels with host gaps
        launch = CFUNCTYPE(c_int, c_void_p, c_uint, c_uint, c_uint, c_uint,
                           c_uint, c_uint, c_uint, c_void_p, c_void_p,
                           c_void_p)(via2("cuLaunchKernel"))
        ctx_sync = CFUNCTYPE(c_int)(via2("cuCtxSynchronize"))

        def run(seconds):
            # a host-bound stream: the host spends longer between two
            # launches than the device on each, and never synchronises
            t = time.monotonic() + seconds
            while time.monotonic() < t:
                assert launch(None, 1, 1, 1, 1, 1, 1, 0, None, None,
                              None) == 0
                time.sleep(0.0003)
            assert ctx_sync() == 0
            vg.vgpu_flush_launches()

        run(float(sys.argv[3]))
        busy0 = cu.mock_cuda_busy_ns()
        out = {"warm": True}
        wait()
        if sys.argv[4:] == ["device_bound"]:
            # then a device-bound phase: back to back, the queue full
            t = time.monotonic() + float(sys.argv[2])
            while time.monotonic() < t:
                assert launch(None, 1, 1, 1, 1, 1, 1, 0, None, None,
                              None) == 0
            assert ctx_sync() == 0
            vg.vgpu_flush_launches()
        else:
            run(float(sys.argv[2]))
        spans = (c_uint64 * 2)()
        vg.vgpu_span_busy(spans)
        out = {"busy_ns": cu.mock_cuda_busy_ns() - busy0,
               "spans": list(spans)}
        wait()
""")


@pytest.fixture(scope="module")
def libs():
    return native.build_all()


def child_env(tmp_path, **extra):
    cache = tmp_path / "containers" / "pod-uid_0" / "vgpu.cache"
    cache.parent.mkdir(parents=True, exist_ok=True)
    fixture = tmp_path / "cards.json"
    fixture.write_text(json.dumps({"gpus": [{
        "uuid": UUID0, "name": "NVIDIA H100 80GB HBM3", "memory_mb": 81559,
        "minor": 0}]}))
    procs = tmp_path / "procs"
    procs.mkdir(exist_ok=True)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("CUDA_", "LD_PRELOAD", "MOCK_", "VGPU_"))}
    env.update({
        "LD_PRELOAD": native.interposer(),
        "LD_LIBRARY_PATH": os.pathsep.join([
            native.mock_cuda_dir(),
            os.path.dirname(native.mock_nvml_library())]),
        "MOCK_CUDA_TOTAL": "4g",
        "MOCK_NVML_FIXTURE": str(fixture),
        "MOCK_GPU_PROCS": str(procs),
        api.ENV_LOCK_DIR: str(tmp_path / "locks"),
        api.ENV_SHARED_CACHE: str(cache),
    })
    env.update({k: str(v) for k, v in extra.items()})
    return env, str(cache)


def spawn(env, mode, *args):
    return subprocess.Popen([sys.executable, "-c", CHILD, mode,
                             *map(str, args)], env=env,
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def line(proc, timeout=60):
    ready, _, _ = select.select([proc.stdout], [], [], timeout)
    assert ready, f"no answer from the child in {timeout} s"
    text = proc.stdout.readline()
    assert text, proc.stderr.read()
    return json.loads(text)


def ask(proc):
    proc.stdin.write("\n")
    proc.stdin.flush()
    return line(proc)


def slot_used(cache):
    """the child's slot charge, the region's, its pressure counters and its
    unmeasured-footprint count"""
    with RegionView(cache) as view:
        (slot,) = view.procs()
        return (slot.hbm_used[0], view.used(0), view.pressure(),
                view.footprint_unmeasured)


def finish(proc):
    out, err = proc.communicate("\n", timeout=60)
    assert proc.returncode == 0, err
    return json.loads(out.strip().splitlines()[-1]), err


# mode name -> (extra env, the footprint mode the interposer reports (2 a
# pid of NVML's list, re-read; 3 the context's size at creation), whether
# memory taken later is charged)
FOOTPRINT = {
    # NVML lists the process under its own pid
    "own_pid": ({}, 2, True),
    # ... the first context made with cuCtxCreate, not the runtime's
    # primary context
    "own_pid_ctx_create": ({}, 2, True),
    # a container's pid namespace: NVML reports the host's pid, the one new
    # in the list across the context's creation
    "pid_namespace": ({"MOCK_GPU_PID_OFFSET": 100000}, 2, True),
    # every process reported as one pid holding their sum (a sandbox whose
    # processes reach the driver through one host process), beside a
    # neighbour: only the card's growth across the creation tells
    "one_host_process": ({"MOCK_GPU_PROCS_SHARED": 1}, 3, False),
}


@pytest.mark.parametrize("name", sorted(FOOTPRINT))
def test_context_footprint_is_inside_the_quota(tmp_path, libs, name):
    """A child at a 1 GiB quota whose context holds 200 MiB: after its
    first context cuMemGetInfo shows at most 824 MiB free, its 64 MiB
    allocations stop at the quota less the footprint, and its region slot
    carries the footprint beside the allocations; memory it takes later
    through no hooked call is charged within the next re-reads (where NVML
    tells the process apart); the slot goes at exit."""
    extra, mode, rereads = FOOTPRINT[name]
    env, cache = child_env(tmp_path, MOCK_CUDA_CTX_BYTES="200m",
                           **{api.ENV_DEVICE_MEMORY_LIMIT: "1g"}, **extra)
    neighbour = None
    if name == "one_host_process":
        # another process of the card, listed already
        neighbour = subprocess.Popen([sys.executable, "-c",
                                      "import sys; sys.stdin.read()"],
                                     stdin=subprocess.PIPE)
        with open(os.path.join(env["MOCK_GPU_PROCS"],
                               str(neighbour.pid)), "w") as f:
            f.write(f"1 {100 * MiB}\n")
    proc = spawn(env, "footprint",
                 *(["create"] if name.endswith("ctx_create") else []))
    try:
        first = line(proc)
        held, total, pressure, unmeasured = slot_used(cache)
        later = ask(proc)
        held_later, _, _, _ = slot_used(cache)
        done, err = finish(proc)
    finally:
        for p in (proc, neighbour):
            if p is not None and p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    assert first["hooked"] and first["retain"] == 0
    fp_mode, _, charged = first["footprint"][:3]
    assert (fp_mode, charged) == (mode, 200 * MiB), first["footprint"]
    assert first["info"] == [824 * MiB, 1024 * MiB]
    assert first["refused"] == 2  # CUDA_ERROR_OUT_OF_MEMORY
    assert first["filled"] == 768 * MiB  # 12 x 64 MiB fit in 824 MiB
    assert held == total == 968 * MiB
    # memory a context takes after its creation runs unaccounted where it
    # is not re-read, and the region's unmeasured-footprint count says so
    # (not the table drops, which mean a full table)
    assert unmeasured == (0 if rereads else 1)
    assert pressure["table_drops"] == 0
    grown = 232 * MiB if rereads else 200 * MiB
    assert later["footprint"][2] == grown
    assert held_later == 768 * MiB + grown
    assert later["info"][0] == max(0, 1024 * MiB - 768 * MiB - grown)
    assert done["freed"] == [0] * 12
    if rereads:
        assert later["footprint"][3] > 0  # re-reads, timed
    assert ("cannot tell this process apart" in err) == (not rereads)
    assert "NVML unavailable" not in err
    with RegionView(cache) as view:
        assert view.procs() == [] and view.used(0) == 0


def test_footprint_without_nvml_is_logged_and_counted(tmp_path, libs):
    """Where NVML will not load, the quota still holds for what the hooks
    reach, and the missing footprint is not silent: one log line whatever
    LIBCUDA_LOG_LEVEL says, and one in the region's unmeasured-footprint
    count (memory that runs unaccounted), not a table drop."""
    env, cache = child_env(tmp_path, MOCK_CUDA_CTX_BYTES="200m",
                           **{api.ENV_DEVICE_MEMORY_LIMIT: "1g",
                              api.ENV_LOG_LEVEL: 0})
    del env["MOCK_NVML_FIXTURE"]  # the mock NVML then fails its init
    proc = spawn(env, "footprint")
    try:
        first = line(proc)
        held, _, pressure, unmeasured = slot_used(cache)
        ask(proc)
        _, err = finish(proc)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    assert first["footprint"][0] == 4 and first["footprint"][2] == 0
    assert first["info"] == [1024 * MiB, 1024 * MiB]
    assert first["filled"] == held == 1024 * MiB
    assert unmeasured == 1 and pressure["table_drops"] == 0
    assert err.count("NVML unavailable") == 1, err


def test_managed_memory_and_arrays_are_charged(tmp_path, libs):
    """cuMemAllocManaged, cuArrayCreate_v2, cuArray3DCreate_v2 and
    cuMipmappedArrayCreate, each the interposer's hook through
    cuGetProcAddress, charged before the driver allocates (an array its
    width x height x depth x channels x format bytes, a mipmapped one over
    its levels) and refused past a 64 MiB quota with
    CUDA_ERROR_OUT_OF_MEMORY; cuMemFree_v2, cuArrayDestroy and
    cuMipmappedArrayDestroy uncharge, and the region is clean after."""
    env, cache = child_env(tmp_path, **{api.ENV_DEVICE_MEMORY_LIMIT: "64m"})
    proc = spawn(env, "arrays")
    try:
        out = line(proc)
        held, _, _, _ = slot_used(cache)
        done, _ = finish(proc)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    assert all(out["hooked"].values()), out["hooked"]
    assert out["managed"] == [0, 40 * MiB]
    assert out["managed_over"] == [2, 40 * MiB]
    assert out["managed_free"] == [0, 0]
    arrays = 16 * MiB + 4 * MiB + (1 << 20) + (1 << 18) + (1 << 16)
    assert out["array"] == [0, 16 * MiB]
    assert out["array3d"] == [0, 20 * MiB]
    assert out["mipmap"] == [0, arrays]
    assert out["array_over"] == [2, arrays]
    assert held == arrays
    assert done == {"destroyed": [0, 0, 0], "used": 0}
    with RegionView(cache) as view:
        assert view.procs() == [] and view.used(0) == 0


def test_kernels_are_charged_by_their_arguments(tmp_path, libs):
    """One kernel at one shape whose int argument sets its work (1 or 10
    units of 0.2 ms, alternating) at a 50% limit, while another process
    time-slices the device (every third kernel starts 2 ms late) and a
    device address among its arguments changes at every launch: each call
    is charged its own least time, 0.8-1.1x the mock's busy time. Keyed
    by shape alone both calls were charged the cheaper one's time (about
    0.18x); keyed with the address, no key would repeat, and a key seen
    once is charged its shape's least time, the cheaper call's again."""
    env, cache = child_env(tmp_path, MOCK_CUDA_ARG_NS=200_000,
                           MOCK_CUDA_STALL_NS=2 * MS, MOCK_CUDA_STALL_EVERY=3,
                           **{api.ENV_SM_LIMIT: 50})
    proc = spawn(env, "args", 1.5, 0.3)
    try:
        assert line(proc)["warm"]
        with RegionView(cache) as view:
            (before,) = view.procs()
            got = ask(proc)
            (after,) = view.procs()
        _, err = proc.communicate("\n", timeout=60)
        assert proc.returncode == 0, err
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    assert min(got["launches"].values()) >= 50, got
    charged = (after.launch_ns - before.launch_ns) / got["busy_ns"]
    assert 0.8 <= charged <= 1.1, (charged, got)
    seen, new, shape_only, full, known, unknown, left_out = got["keys"]
    assert known >= 1 and unknown == 0 and full == 0 and shape_only == 0
    assert seen > 10 * new, got["keys"]
    assert left_out == 0, got["keys"]  # the work's int varies, and stays


def test_argument_words_that_never_repeat_are_left_out(tmp_path, libs):
    """The kernel of the test above with a third argument, a 64-bit word
    that changes at every call and does not change its time (uninitialised
    padding, an RNG offset), while another process time-slices the device
    (every third kernel starts 2 ms late): its key learns to leave that word
    out, and only that word, so each call is charged its own least time
    again, 0.8-1.1x the mock's busy time, by keys seen before. With the word
    in the key no key repeated, and every call was charged the shape's least
    time, the cheaper call's (about 0.18x)."""
    env, cache = child_env(tmp_path, MOCK_CUDA_ARG_NS=200_000,
                           MOCK_CUDA_STALL_NS=2 * MS, MOCK_CUDA_STALL_EVERY=3,
                           **{api.ENV_SM_LIMIT: 50})
    proc = spawn(env, "args", 1.5, 0.5, "noise")
    try:
        assert line(proc)["warm"]
        with RegionView(cache) as view:
            (before,) = view.procs()
            got = ask(proc)
            (after,) = view.procs()
        _, err = proc.communicate("\n", timeout=60)
        assert proc.returncode == 0, err
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    assert min(got["launches"].values()) >= 50, got
    charged = (after.launch_ns - before.launch_ns) / got["busy_ns"]
    assert 0.8 <= charged <= 1.1, (charged, got)
    seen, new, shape_only, full, known, unknown, left_out = got["keys"]
    assert known >= 1 and unknown == 0 and full == 0 and shape_only == 0
    assert seen > 10 * new, got["keys"]
    # the noise word alone: the word that sets the work stays in the key
    assert left_out == 1, got["keys"]


def _first_launches(tmp_path, **extra):
    """a child in context mode (NVML lists every process as one pid) whose
    16 functions each take 4 MiB of the card at their first launch and
    whose 4 libraries' modules take 8 MiB each at their first look-up,
    beside this test process listed with 100 MiB: its report, its slot's
    charge and the region's, and the card's view of its memory"""
    env, cache = child_env(tmp_path, MOCK_CUDA_CTX_BYTES="200m",
                           MOCK_CUDA_FUNC_BYTES="4m",
                           MOCK_CUDA_MODULE_BYTES="8m",
                           MOCK_GPU_PROCS_SHARED=1,
                           **{api.ENV_DEVICE_MEMORY_LIMIT: "1g"}, **extra)
    # this test process as another process of the card, listed already
    mine = os.path.join(env["MOCK_GPU_PROCS"], str(os.getpid()))
    _hold(mine, 100 * MiB)
    proc = spawn(env, "first_launches", 16)
    try:
        got = line(proc)
        held, total, _, _ = slot_used(cache)
        with open(os.path.join(env["MOCK_GPU_PROCS"], str(got["pid"]))) as f:
            card = int(f.read().split()[1])  # the mock card's view
        _, err = proc.communicate("\n", timeout=60)
        assert proc.returncode == 0, err
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        os.unlink(mine)
    with RegionView(cache) as view:
        assert view.procs() == [] and view.used(0) == 0
    return got, held, total, card


def test_memory_taken_at_first_launches_is_charged(tmp_path, libs):
    """Where NVML lists every process as one pid (the footprint is measured
    at the context's creation, not re-read), a process whose 16 functions
    each take 4 MiB of the card at their first launch (lazily loaded
    modules), and whose 4 libraries' modules take 8 MiB each at their first
    look-up, is charged that too: each is measured under the node's lock,
    so the region's charge follows the card's growth within 2%. Measured at
    the context's creation alone, the 96 MiB they took ran uncharged (26%
    of the process's memory here)."""
    got, held, total, card = _first_launches(tmp_path)
    assert got["footprint"][0] == 3, got["footprint"]  # context mode
    assert card == 200 * MiB + 64 * MiB + 16 * 4 * MiB + 4 * 8 * MiB
    assert abs(held - card) <= 0.02 * card, (held, card)
    assert got["hooked"]
    assert held == total
    measured, at_load, at_launch, shrank = got["first_launches"][:4]
    # 16 launches (their loads) and 4 look-ups (at their "launch": the
    # call itself), each measured once
    assert (measured, at_load, at_launch, shrank) == \
        (20, 64 * MiB, 32 * MiB, 0)
    assert got["footprint"][2] == 200 * MiB + 64 * MiB + 32 * MiB
    assert got["info"][0] == 1024 * MiB - held


def test_pages_of_streams_and_small_allocations_are_charged(tmp_path,
                                                            libs):
    """F6's residue (case 1.1's child held 10,328,316 B past its charge on
    the H100: a cuDNN handle's four streams took a 2 MiB page each, and
    cuBLAS's small allocations a page they were charged 132,096 B of;
    PERF.md). Where NVML lists every process as one pid, a process that
    makes five streams (each takes 2 MiB of the mock card) and 16
    allocations of 2,064 B (carved from a 2 MiB page) is charged what the
    card grew by, exactly: each such call is measured under the node's
    lock, and the pages are charged past the small allocations' own
    charges. After the streams are destroyed and the small allocations
    freed, the charge is back where the card is. Before, the 12 MiB of
    pages ran uncharged less the 33,024 B of the allocations."""
    env, cache = child_env(tmp_path, MOCK_CUDA_CTX_BYTES="200m",
                           MOCK_CUDA_STREAM_BYTES="2m", MOCK_CUDA_PAGE="2m",
                           MOCK_GPU_PROCS_SHARED=1,
                           **{api.ENV_DEVICE_MEMORY_LIMIT: "1g"})
    mine = os.path.join(env["MOCK_GPU_PROCS"], str(os.getpid()))
    _hold(mine, 100 * MiB)
    proc = spawn(env, "objects")
    card_file = None
    try:
        made = line(proc)
        card_file = os.path.join(env["MOCK_GPU_PROCS"], str(made["pid"]))
        held_made = slot_used(cache)[0]
        with open(card_file) as f:
            card_made = int(f.read().split()[1])
        gone = ask(proc)
        held_gone = slot_used(cache)[0]
        with open(card_file) as f:
            card_gone = int(f.read().split()[1])
        _, err = proc.communicate("\n", timeout=60)
        assert proc.returncode == 0, err
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        os.unlink(mine)
    assert made["footprint"][0] == 3, made["footprint"]  # context mode
    assert made["hooked"] == [True, True]
    assert card_made == 200 * MiB + 64 * MiB + 5 * 2 * MiB + 2 * MiB
    assert held_made == card_made
    # 21 calls measured; the streams' 10 MiB and the page's 2 MiB; the
    # small allocations' 33,024 B live; the pages' charge past them
    assert made["objects"] == [21, 2 * MiB, 10 * MiB, 16 * 2064,
                               12 * MiB - 16 * 2064], made["objects"]
    assert gone["destroyed"] == [0] * 5 and gone["freed"] == [0] * 16
    assert card_gone == 200 * MiB + 64 * MiB
    assert held_gone == card_gone
    assert gone["objects"] == [42, 0, 0, 0, 0], gone["objects"]


def test_a_probe_outside_the_process_list_is_not_charged(tmp_path, libs):
    """The same process while a process NVML lists nowhere (a host's probe
    that makes a context for a moment: ~0.5 GB for ~110 ms every 120 s on
    the H100 host, PERF.md) takes 64 MiB more of the card at each of its
    first launches. The first launches are measured on the listed
    processes' memory, so the charge is the same as without the probe; on
    the card's used memory it held the probe's 1 GiB too, and the pod was
    refused memory it never took."""
    probe = tmp_path / "unlisted"
    got, held, total, card = _first_launches(
        tmp_path, MOCK_NVML_UNLISTED=str(probe),
        MOCK_CUDA_UNLISTED_AT_LOAD="64m")
    assert int(probe.read_text()) == 16 * 64 * MiB  # the probe grew
    assert got["footprint"][0] == 3, got["footprint"]
    assert card == 200 * MiB + 64 * MiB + 16 * 4 * MiB + 4 * 8 * MiB
    assert abs(held - card) <= 0.02 * card, (held, card)
    assert held == total
    measured, at_load, at_launch, shrank = got["first_launches"][:4]
    assert (measured, at_load, at_launch, shrank) == \
        (20, 64 * MiB, 32 * MiB, 0)
    assert got["footprint"][2] == 200 * MiB + 64 * MiB + 32 * MiB


@pytest.mark.parametrize("then", ["host_bound", "device_bound"])
def test_host_bound_pod_is_charged_its_device_time(tmp_path, libs, then):
    """A pod with no SM limit whose host spends longer between launches
    than the device on each (0.2 ms kernels, ~0.4 ms of host between
    them, never synchronised) is charged 0.8-1.1x the mock's busy time:
    one span in each 32, at a random place among them, records an event
    per launch and measures the fraction
    of its span the stream was busy, and every span's charge is scaled by
    the recent samples' fraction. Charged as whole spans, the host's gaps
    were charged too (about 2.5x). A pod that turns device-bound after
    that (kernels back to back) is charged its busy time too: the recent
    samples, not the host-bound phase's, set its fraction. Its host's
    delays are what it measures, so it runs beside no pinned core and no
    busy native harness (tests/torch_timing.py)."""
    with timed():
        charged, spans = _hostbound_charge(tmp_path, then)
    samples, busy_millionths = spans
    assert 0.8 <= charged <= 1.1, (charged, spans)
    assert samples >= 5, spans
    if then == "host_bound":
        assert 0 < busy_millionths < 800_000, spans
    else:
        assert busy_millionths > 900_000, spans


def test_a_drained_streams_wait_for_a_launch_is_not_charged(tmp_path, libs):
    """The host-bound pod above on a driver whose launch call spends 0.2 ms
    on the host before its kernel (0.2 ms) reaches the device is charged
    0.8-1.1x the mock's busy time: a run that starts on a drained stream
    is timed from an event the device reaches before the launch does, and
    the host's time from that event to the launch's return is taken off.
    With it kept, each sampled run held the launch call's time too and the
    pod was charged about twice its busy time."""
    charged, spans = _hostbound_charge(tmp_path, "host_bound",
                                       MOCK_CUDA_LAUNCH_NS=200_000)
    assert 0.8 <= charged <= 1.1, (charged, spans)
    assert spans[0] >= 5, spans


def test_a_drained_stream_on_a_shared_core_is_charged_its_busy_time(
        tmp_path, libs):
    """F9: the pod of the test above shares one core with three busy
    processes of this test (both pinned there by sched_setaffinity), so its
    host is delayed at random for whole time slices. Each of 4 runs is
    charged 0.8-1.1x the mock's busy time. With one span in 32 sampled on
    every stream, the ~27 samples a run took followed the host's delays
    badly: 0.837-1.116x over six runs, two past the bound; sampling one
    span in 8 of a stream busy less than half its time reads
    0.908-1.043x. Beside the suite's heavy files that was 0.848-1.093x:
    a sample's idle tail (the host descheduled past 2 ms after its last
    launch) diluted the busy fraction though no span is charged for it;
    capped in the sample as in the charge, 0.975-1.016x over 36 runs. The
    pinned window holds tests/torch_timing.py's lock, so no timed test of
    another worker runs beside it."""
    core = max(os.sched_getaffinity(0))
    with exclusive():
        spinners = [subprocess.Popen(
            [sys.executable, "-c", "while True: pass"]) for _ in range(3)]
        try:
            for p in spinners:
                os.sched_setaffinity(p.pid, {core})
            runs = [_hostbound_charge(tmp_path / f"run{i}", "host_bound",
                                      core=core,
                                      MOCK_CUDA_LAUNCH_NS=200_000)
                    for i in range(4)]
        finally:
            for p in spinners:
                p.kill()
                p.wait(timeout=30)
    for charged, spans in runs:
        assert 0.8 <= charged <= 1.1, runs
        assert spans[0] >= 5, runs


def _hostbound_charge(tmp_path, then, core=None, **extra):
    """the "hostbound" child (0.2 ms kernels, ~0.4 ms of host between
    them) then ``then``, pinned to ``core`` when one is given: (launch_ns
    charged over the mock's busy time, the sampled spans' count and busy
    fraction in millionths)"""
    tmp_path.mkdir(exist_ok=True)
    env, cache = child_env(tmp_path, MOCK_CUDA_KERNEL_NS=200_000, **extra)
    proc = spawn(env, "hostbound", 2.0, 0.5, then)
    try:
        if core is not None:
            os.sched_setaffinity(proc.pid, {core})
        assert line(proc)["warm"]
        with RegionView(cache) as view:
            (before,) = view.procs()
            got = ask(proc)
            (after,) = view.procs()
        _, err = proc.communicate("\n", timeout=60)
        assert proc.returncode == 0, err
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    return (after.launch_ns - before.launch_ns) / got["busy_ns"], got["spans"]


def _hold(path, nbytes):
    """this test process as the card's neighbour, holding nbytes"""
    with open(path + ".tmp", "w") as f:
        f.write(f"{os.getpid()} {nbytes}\n")
    os.replace(path + ".tmp", path)


def _when_locked(lock, timeout=30):
    """wait until another process holds the node's context lock"""
    t = time.monotonic() + timeout
    while not os.path.exists(lock):
        assert time.monotonic() < t, "the child never made the lock"
        time.sleep(0.001)
    with open(lock) as f:
        while True:
            try:
                fcntl.flock(f, fcntl.LOCK_EX | fcntl.LOCK_NB)
            except BlockingIOError:
                return
            fcntl.flock(f, fcntl.LOCK_UN)
            assert time.monotonic() < t, "the child never took the lock"
            time.sleep(0.001)


@pytest.mark.parametrize("neighbour", ["allocates", "frees"])
def test_neighbour_memory_is_not_charged_to_a_context(tmp_path, libs,
                                                      neighbour):
    """Where NVML lists every process as one pid, a process's footprint is
    the card's growth across its context's creation, and other processes
    allocate and free without the lock. A first, quiet measurement (200
    MiB) joins the node's record in the lock directory; a second process
    whose 0.4 s creation a neighbour's 1 GiB allocation or free lands in
    is charged the node's context size, 200 MiB, not the 1224 MiB (or
    nothing) the card moved by, says so once, and fills its quota to
    quota less 200 MiB as the first did."""
    env, cache = child_env(tmp_path, MOCK_CUDA_CTX_BYTES="200m",
                           MOCK_CUDA_CTX_MS=400, MOCK_GPU_PROCS_SHARED=1,
                           **{api.ENV_DEVICE_MEMORY_LIMIT: "1g"})
    mine = os.path.join(env["MOCK_GPU_PROCS"], str(os.getpid()))
    lock = os.path.join(env[api.ENV_LOCK_DIR], "vgpu-context.lock")
    before, during = (1024 * MiB, 0) if neighbour == "frees" else \
        (0, 1024 * MiB)
    _hold(mine, before)
    runs = []
    try:
        for disturbed in (False, True):
            proc = spawn(env, "footprint")
            try:
                if disturbed:
                    _when_locked(lock)
                    time.sleep(0.1)  # after the reads before the creation
                    _hold(mine, during)
                first = line(proc)
                ask(proc)
                _, err = finish(proc)
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait(timeout=30)
            runs.append((first, err))
    finally:
        os.unlink(mine)
    (quiet, quiet_err), (first, err) = runs
    assert quiet["footprint"][0] == 3 and quiet["footprint"][2] == 200 * MiB
    assert quiet["footprint"][6:] == [200 * MiB, 0], quiet["footprint"]
    assert "allocated or freed meanwhile" not in quiet_err
    grew = 1224 * MiB if neighbour == "allocates" else 0
    fp_mode, _, charged = first["footprint"][:3]
    assert (fp_mode, charged) == (3, 200 * MiB), first["footprint"]
    assert first["footprint"][6:] == [grew, 200 * MiB], first["footprint"]
    assert first["info"] == [824 * MiB, 1024 * MiB]
    assert first["filled"] == 768 * MiB
    assert err.count("allocated or freed meanwhile") == 1, err
    (record,) = [f for f in os.listdir(env[api.ENV_LOCK_DIR])
                 if f.endswith(".sizes")]
    assert record == f"vgpu-context-{UUID0}-12080.sizes"
    with RegionView(cache) as view:
        assert view.procs() == [] and view.used(0) == 0


def test_a_held_context_lock_is_not_waited_for_forever(tmp_path, libs):
    """A process that holds the node's context lock and hangs does not
    stall another's first context: the lock is waited for 5 s, then the
    context is measured unserialised (a warning) and charged all the
    same."""
    env, cache = child_env(tmp_path, MOCK_CUDA_CTX_BYTES="200m",
                           **{api.ENV_DEVICE_MEMORY_LIMIT: "1g",
                              api.ENV_LOG_LEVEL: 2})
    os.makedirs(env[api.ENV_LOCK_DIR])
    with open(os.path.join(env[api.ENV_LOCK_DIR], "vgpu-context.lock"),
              "w") as held:
        fcntl.flock(held, fcntl.LOCK_EX)
        t0 = time.monotonic()
        proc = spawn(env, "footprint")
        try:
            first = line(proc)
            waited = time.monotonic() - t0
            ask(proc)
            _, err = finish(proc)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
    assert 5 <= waited < 30, waited
    assert "held too long" in err and "measured unserialised" in err, err
    assert first["footprint"][:3] == [2, first["footprint"][1], 200 * MiB]
    assert first["info"] == [824 * MiB, 1024 * MiB]


def test_each_stream_is_charged_its_own_busy_time(tmp_path, libs):
    """Two streams of one process on a card with no SM limit, side by side:
    one device-bound (0.2 ms kernels back to back), one host-bound (~0.4
    ms of host between its 0.2 ms kernels). Each samples its own spans and
    is charged 0.8-1.1x its own busy time. With one estimate for the
    process, their mixed busy fraction scaled both: the device-bound
    stream was charged too little and the host-bound one too much."""
    env, cache = child_env(tmp_path, MOCK_CUDA_KERNEL_NS=200_000)
    proc = spawn(env, "streams", 1.5, 1.0)
    try:
        assert line(proc)["warm"]
        got = ask(proc)
        _, err = proc.communicate("\n", timeout=60)
        assert proc.returncode == 0, err
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    for name, after in got["after"].items():
        before = got["before"][name]
        busy = after["busy_ns"] - before["busy_ns"]
        charged = (after["charged_ns"] - before["charged_ns"]) / busy
        assert 0.8 <= charged <= 1.1, (name, charged, got)
        assert after["samples"] - before["samples"] >= 5, (name, got)
    assert got["after"]["host_bound"]["busy_millionths"] < 800_000, got
    assert got["after"]["device_bound"]["busy_millionths"] > 900_000, got


def test_periodic_steps_are_not_sampled_at_one_place(tmp_path, libs):
    """A stream whose steps hold 32 spans each (a synchronisation ends
    each), the first 4 and last 4 host-bound (busy ~0.5 of their time)
    and 24 device-bound, is charged 0.8-1.1x its busy time. Sampling the
    first span of every 32, the samples all fell on the host-bound ends of
    the steps and their fraction scaled every span: about 0.6x."""
    env, cache = child_env(tmp_path, MOCK_CUDA_KERNEL_NS=200_000)
    proc = spawn(env, "steps", 4.0, 0.5)
    try:
        assert line(proc)["warm"]
        got = ask(proc)
        _, err = proc.communicate("\n", timeout=60)
        assert proc.returncode == 0, err
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    before, after = got["before"], got["after"]
    busy = after["busy_ns"] - before["busy_ns"]
    charged = (after["charged_ns"] - before["charged_ns"]) / busy
    assert 0.8 <= charged <= 1.1, (charged, got)
    assert after["samples"] - before["samples"] >= 20, got
