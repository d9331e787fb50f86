"""The interposer's compute plane on the CPU: libvgpu.so LD_PRELOADed into
child processes that launch kernels on the mock libcuda.so.1, whose
simulated device clock runs each kernel for MOCK_CUDA_KERNEL_NS
(vtpu_torch/csrc/mock_cuda.c).

Each behaviour is held to the JAX package where it has one: the 70/30 split
and the per-device buckets run the JAX shim (``lib/vtpu``, built into a
private directory) beside the port under the JAX test's own bounds, and the
feedback, pressure and launch counters the port writes are read back by the
JAX package's ``RegionView``."""

import json
import os
import select
import subprocess
import sys
import textwrap
import time

import pytest

import vtpu.enforce.region as jax_region
from vtpu.enforce.region import RegionView as JaxRegionView
from vtpu_torch import api, native
from vtpu_torch.enforce.region import RegionView

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MS = 1_000_000  # ns

CHILD = textwrap.dedent(r"""
    import ctypes, json, os, sys, threading, time
    from ctypes import (CFUNCTYPE, POINTER, byref, c_char_p, c_int, c_uint,
                        c_uint64, c_ulong, c_ulonglong, c_void_p)

    cu = ctypes.CDLL("libcuda.so.1")
    vg = ctypes.CDLL(os.environ["LD_PRELOAD"])
    for name in ("mock_cuda_launches", "mock_cuda_graph_launches",
                 "mock_cuda_capture_event_records"):
        getattr(cu, name).restype = c_ulong
    GPA2 = CFUNCTYPE(c_int, c_char_p, POINTER(c_void_p), c_int, c_uint64,
                     POINTER(c_int))
    gpa2 = GPA2(ctypes.cast(cu.cuGetProcAddress_v2, c_void_p).value)

    def via2(base, flags=0):
        p, st = c_void_p(), c_int(-1)
        rc = gpa2(base.encode(), byref(p), 12080, flags, byref(st))
        assert rc == 0 and st.value == 0, (base, rc, st.value)
        return p.value

    LAUNCH = CFUNCTYPE(c_int, c_void_p, c_uint, c_uint, c_uint, c_uint,
                       c_uint, c_uint, c_uint, c_void_p, c_void_p, c_void_p)
    launch_entry = via2("cuLaunchKernel")
    hooked = launch_entry == ctypes.cast(vg.cuLaunchKernel, c_void_p).value
    launch = LAUNCH(launch_entry)
    sync = CFUNCTYPE(c_int, c_void_p)(via2("cuStreamSynchronize"))
    ctx_sync = CFUNCTYPE(c_int)(via2("cuCtxSynchronize"))
    new_stream = CFUNCTYPE(c_int, POINTER(c_void_p), c_uint)(
        via2("cuStreamCreate"))
    begin = CFUNCTYPE(c_int, c_void_p, c_int)(via2("cuStreamBeginCapture"))
    end = CFUNCTYPE(c_int, c_void_p, POINTER(c_void_p))(
        via2("cuStreamEndCapture"))
    instantiate = CFUNCTYPE(c_int, POINTER(c_void_p), c_void_p, c_ulonglong)(
        via2("cuGraphInstantiate"))
    graph_launch = CFUNCTYPE(c_int, c_void_p, c_void_p)(via2("cuGraphLaunch"))
    graph_hooked = via2("cuGraphLaunch") == ctypes.cast(
        vg.cuGraphLaunch, c_void_p).value
    mem_alloc = CFUNCTYPE(c_int, POINTER(c_ulonglong), ctypes.c_size_t)(
        via2("cuMemAlloc"))

    def kernel(stream=None):
        return launch(None, 1, 1, 1, 1, 1, 1, 0, stream, None, None)

    def stream():
        s = c_void_p()
        assert new_stream(byref(s), 0) == 0
        return s

    def out(**kw):
        print(json.dumps(dict(kw, hooked=hooked)), flush=True)

    def burn(seconds, step, warmup=0.0):
        t = time.monotonic() + warmup
        while time.monotonic() < t:
            step()
        n, t = 0, time.monotonic() + seconds
        while time.monotonic() < t:
            step()
            n += 1
        return n

    def kernel_sync():
        assert kernel() == 0 and sync(None) == 0

    def kernel_async():
        assert kernel() == 0

    def kernel_then_gap():
        assert kernel() == 0
        time.sleep(0.004)

    mode, args = sys.argv[1], sys.argv[2:]
    if mode == "burn":  # SECONDS WARMUP sync|async|gap
        step = {"sync": kernel_sync, "async": kernel_async,
                "gap": kernel_then_gap}[args[2]]
        n = burn(float(args[0]), step, float(args[1]))
        ctx_sync()
        vg.vgpu_flush_launches()
        out(n=n, mock=cu.mock_cuda_launches())
        if args[3:] == ["wait"]:
            sys.stdin.readline()
    elif mode == "long":  # one kernel, then a sync and a flush on a line
        assert kernel() == 0
        out(launched=True)
        sys.stdin.readline()
        ctx_sync()
        vg.vgpu_flush_launches()
        out(done=True)
        sys.stdin.readline()
    elif mode == "percore":  # MS per device, as shim_test percore
        counts = []
        for dev in ("0", "1"):
            os.environ["MOCK_CUDA_DEVICE"] = dev
            counts.append(burn(float(args[0]) / 1e3, kernel_sync))
        out(counts=counts)
    elif mode == "serve":
        # a thread launches 1-step kernels, synchronised, while the main
        # thread answers each line of stdin with the counts
        stats = {"ok": 0, "refused": 0, "last_rc": 0}

        def launcher():
            while True:
                rc = kernel()
                stats["last_rc"] = rc
                if rc == 0:
                    sync(None)
                    stats["ok"] += 1
                else:
                    stats["refused"] += 1
                    time.sleep(0.001)

        threading.Thread(target=launcher, daemon=True).start()
        for line in sys.stdin:
            cmd = line.split()
            if cmd and cmd[0] == "alloc":
                p = c_ulonglong()
                assert mem_alloc(byref(p), int(cmd[1])) == 0
            vg.vgpu_flush_launches()
            out(mock=cu.mock_cuda_launches(), t=time.monotonic(), **stats)
    elif mode == "graph":  # SECONDS WARMUP
        s = stream()
        before = cu.mock_cuda_launches()
        assert begin(s, 0) == 0
        captured = [kernel(s) for _ in range(5)]
        g, x = c_void_p(), c_void_p()
        assert end(s, byref(g)) == 0 and instantiate(byref(x), g, 0) == 0

        def replay():
            assert graph_launch(x, s) == 0 and sync(s) == 0

        t0 = time.monotonic()
        n = burn(float(args[0]), replay, float(args[1]))
        vg.vgpu_flush_launches()
        out(captured=captured, reached=cu.mock_cuda_launches() - before,
            capture_records=cu.mock_cuda_capture_event_records(), n=n,
            replays=cu.mock_cuda_graph_launches(), graph_hooked=graph_hooked,
            seconds=time.monotonic() - t0)
        sys.stdin.readline()
    elif mode == "entries":  # each launch entry point, plain and _ptsz
        class Config(ctypes.Structure):
            _fields_ = [("grid", c_uint * 3), ("block", c_uint * 3),
                        ("shmem", c_uint), ("stream", c_void_p),
                        ("attrs", c_void_p), ("nattrs", c_uint)]

        s = stream()
        assert begin(s, 0) == 0 and kernel(s) == 0
        g, x = c_void_p(), c_void_p()
        assert end(s, byref(g)) == 0 and instantiate(byref(x), g, 0) == 0
        EX = CFUNCTYPE(c_int, POINTER(Config), c_void_p, c_void_p, c_void_p)
        COOP = CFUNCTYPE(c_int, c_void_p, c_uint, c_uint, c_uint, c_uint,
                         c_uint, c_uint, c_uint, c_void_p, c_void_p)
        GRAPH = CFUNCTYPE(c_int, c_void_p, c_void_p)
        cfg = Config((c_uint * 3)(1, 1, 1), (c_uint * 3)(1, 1, 1), 0, None,
                     None, 0)
        calls = {
            "cuLaunchKernel": lambda f: LAUNCH(f)(None, 1, 1, 1, 1, 1, 1, 0,
                                                  None, None, None),
            "cuLaunchKernelEx": lambda f: EX(f)(byref(cfg), None, None,
                                                None),
            "cuLaunchCooperativeKernel": lambda f: COOP(f)(
                None, 1, 1, 1, 1, 1, 1, 0, None, None),
            "cuGraphLaunch": lambda f: GRAPH(f)(x, None)}
        hooked, rcs = {}, {}
        for base, call in calls.items():
            for flags, exact in ((0, base), (2, base + "_ptsz")):
                f = via2(base, flags)
                hooked[exact] = f == ctypes.cast(getattr(vg, exact),
                                                 c_void_p).value
                rcs[exact] = [call(f), sync(None)]
        vg.vgpu_flush_launches()
        out(entries=hooked, rcs=rcs, mock=cu.mock_cuda_launches(),
            graphs=cu.mock_cuda_graph_launches())
        sys.stdin.readline()
    elif mode == "threads":  # THREADS LAUNCHES
        def one():
            s = stream()
            for _ in range(int(args[1])):
                assert kernel(s) == 0

        ts = [threading.Thread(target=one) for _ in range(int(args[0]))]
        [t.start() for t in ts]
        [t.join(timeout=30) for t in ts]
        alive = sum(t.is_alive() for t in ts)
        ctx_sync()
        vg.vgpu_flush_launches()
        out(alive=alive, mock=cu.mock_cuda_launches())
        sys.stdin.readline()
""")


@pytest.fixture(scope="module")
def libs():
    return native.build_all()


@pytest.fixture(scope="module")
def jax_shim(tmp_path_factory):
    """The JAX shim's test pieces, built into a directory of this module's
    own (never lib/vtpu/build/, which the JAX package's tests build)."""
    build = str(tmp_path_factory.mktemp("jax-shim"))
    targets = [os.path.join(build, t) for t in (
        "shim_test", "libvtpu.so", "mock_pjrt.so", "libvtpucore.so")]
    subprocess.run(["make", "-C", os.path.join(REPO, "lib", "vtpu"),
                    f"BUILD={build}"] + targets, check=True,
                   capture_output=True, timeout=300)
    return build


@pytest.fixture(autouse=True)
def jax_reads_with_its_own_lib(jax_shim, monkeypatch):
    """The JAX RegionView reads through the libvtpucore.so built above."""
    monkeypatch.setenv("VTPU_CORE_LIB",
                       os.path.join(jax_shim, "libvtpucore.so"))
    monkeypatch.setattr(jax_region, "_lib", None)
    monkeypatch.setattr(jax_region, "_abi_checked", False)


def child_env(tmp_path, name, **extra):
    cache = tmp_path / "containers" / f"{name}_0" / "vgpu.cache"
    cache.parent.mkdir(parents=True, exist_ok=True)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("CUDA_", "LD_PRELOAD", "MOCK_CUDA"))}
    env.update({
        "LD_PRELOAD": native.interposer(),
        "LD_LIBRARY_PATH": native.mock_cuda_dir(),
        "MOCK_CUDA_TOTAL": "1g",
        api.ENV_DEVICE_MEMORY_LIMIT: "64m",
        api.ENV_SHARED_CACHE: str(cache),
        "MOCK_CUDA_KERNEL_NS": str(1 * MS),
    })
    env.update({k: str(v) for k, v in extra.items()})
    return env, str(cache)


def spawn(env, mode, *args):
    return subprocess.Popen([sys.executable, "-c", CHILD, mode,
                             *map(str, args)], env=env,
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def line(proc, timeout=30):
    """The child's next line of JSON; fails rather than waits past
    ``timeout`` seconds."""
    ready, _, _ = select.select([proc.stdout], [], [], timeout)
    assert ready, f"no answer from the child in {timeout} s"
    return json.loads(proc.stdout.readline())


def result(proc, timeout=30):
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, err
    return json.loads(out.strip().splitlines()[-1])


def test_split_70_30_matches_the_jax_shim(tmp_path, libs, jax_shim):
    """Two containers at 70% and 30% with 5 ms kernels, synchronised, for
    1.5 s: the JAX shim on its mock PJRT (tests/test_native.py:217-250)
    and the port on the mock driver, all four at once, each pair held to
    the JAX test's bounds."""
    per_exec_ms, burn_ms = 5, 1500
    procs = {}
    for limit in (70, 30):
        env = dict(os.environ,
                   LIBVTPU_SO=os.path.join(jax_shim, "libvtpu.so"),
                   VTPU_REAL_LIBTPU_PATH=os.path.join(jax_shim,
                                                      "mock_pjrt.so"),
                   TPU_DEVICE_MEMORY_LIMIT="1g",
                   TPU_DEVICE_TENSORCORE_LIMIT=str(limit),
                   TPU_DEVICE_MEMORY_SHARED_CACHE=str(
                       tmp_path / f"jax{limit}.cache"),
                   MOCK_PJRT_EXEC_NS=str(per_exec_ms * MS),
                   MOCK_PJRT_OUT_BYTES="0")
        procs["jax", limit] = subprocess.Popen(
            [os.path.join(jax_shim, "shim_test"), "burn", str(burn_ms)],
            env=env, stdout=subprocess.PIPE, text=True, cwd=jax_shim)
        penv, _ = child_env(tmp_path, f"split{limit}", MOCK_CUDA_KERNEL_NS=(
            per_exec_ms * MS), **{api.ENV_SM_LIMIT: limit})
        procs["port", limit] = spawn(penv, "burn", burn_ms / 1e3, 0, "sync")
    counts = {}
    for (side, limit), proc in procs.items():
        if side == "jax":
            out, _ = proc.communicate(timeout=60)
            assert proc.returncode == 0
            counts[side, limit] = int(out)
        else:
            got = result(proc, timeout=60)
            assert got["hooked"]
            counts[side, limit] = got["n"]
    unthrottled = burn_ms / per_exec_ms
    for side in ("jax", "port"):
        n70, n30 = counts[side, 70], counts[side, 30]
        assert n30 > 0, counts
        assert 1.7 < n70 / n30 < 3.2, counts
        assert n70 < unthrottled * 0.9, counts
        assert n30 < unthrottled * 0.55, counts


def test_per_device_buckets_match_the_jax_shim(tmp_path, libs, jax_shim):
    """Device 0 at 20% and device 1 at 80%, 5 ms kernels, one device after
    the other in one process: device 0's debt does not throttle device 1
    (tests/test_native.py:282, shim_test percore). The JAX shim's own
    percore run passes beside the port's, which holds its bounds."""
    env = dict(os.environ, MOCK_PJRT_SO=os.path.join(jax_shim, "mock_pjrt.so"),
               LIBVTPU_SO=os.path.join(jax_shim, "libvtpu.so"))
    jax = subprocess.Popen([os.path.join(jax_shim, "shim_test"), "percore",
                            "500"], env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True, cwd=jax_shim)
    penv, cache = child_env(tmp_path, "percore", MOCK_CUDA_KERNEL_NS=5 * MS,
                            **{f"{api.ENV_SM_LIMIT}_0": 20,
                               f"{api.ENV_SM_LIMIT}_1": 80})
    port = result(spawn(penv, "percore", 500))["counts"]
    out, err = jax.communicate(timeout=60)
    assert jax.returncode == 0 and "shim_test percore OK" in out, err
    assert port[0] >= 3 and port[1] > 2 * port[0], port
    for view_of in (JaxRegionView, RegionView):
        with view_of(cache) as view:
            assert [view.core_limit(0), view.core_limit(1)] == [20, 80]


def test_idle_is_not_charged_and_sleeps_are_not_charged(tmp_path, libs):
    """1 ms kernels with 4 ms host gaps (25% busy) at a 30% limit run as
    often as unthrottled: the gaps are not charged. Back-to-back kernels,
    not synchronised, at 50% run at 0.4-0.6x the unthrottled count after a
    warm-up that spends the burst: the throttle's own sleeps are not
    charged either (charged, they would hold it far below)."""
    runs = {}
    for name, limit, args in (("gap0", 0, (1.5, 0, "gap")),
                              ("gap30", 30, (1.5, 0, "gap")),
                              ("b2b0", 0, (2.0, 0.5, "async")),
                              ("b2b50", 50, (2.0, 0.5, "async"))):
        env, _ = child_env(tmp_path, name, **{api.ENV_SM_LIMIT: limit})
        runs[name] = spawn(env, "burn", *args)
    n = {name: result(proc, timeout=60)["n"] for name, proc in runs.items()}
    assert n["gap30"] >= 0.9 * n["gap0"], n
    assert 0.4 <= n["b2b50"] / n["b2b0"] <= 0.6, n


def test_time_slice_waits_are_not_charged(tmp_path, libs):
    """Another process time-slicing the device (the mock starts every
    third kernel 2 ms late) stretches the events around this process's
    kernels. Each kernel is charged the least time it was measured to take,
    so a 50% tenant runs as many 1 ms kernels as it does alone and is
    charged 1 ms each; charged as the events span them, it would run about
    0.6x as many."""
    runs = {}
    for name, extra in (("alone", {}),
                        ("sliced", {"MOCK_CUDA_STALL_NS": 2 * MS,
                                    "MOCK_CUDA_STALL_EVERY": 3})):
        env, cache = child_env(tmp_path, name, **extra,
                               **{api.ENV_SM_LIMIT: 50})
        runs[name] = (spawn(env, "burn", 1.5, 0.3, "sync", "wait"), cache)
    got, charged = {}, {}
    try:
        for name, (proc, cache) in runs.items():
            got[name] = line(proc)
            with JaxRegionView(cache) as view:
                (slot,) = view.procs()
            charged[name] = slot.launch_ns / (slot.launches * MS)
    finally:
        for proc, _ in runs.values():
            proc.communicate("done\n", timeout=30)
    assert got["sliced"]["n"] >= 0.85 * got["alone"]["n"], got
    for name in runs:
        assert 0.9 <= charged[name] <= 1.1, charged


def ask(proc, request="?"):
    proc.stdin.write(request + "\n")
    proc.stdin.flush()
    return line(proc)


@pytest.mark.parametrize("priority", [1, 0])
def test_feedback_block_holds_a_low_priority_child(tmp_path, libs, priority):
    """The JAX package's RegionView sets recent_kernel = FEEDBACK_BLOCK on
    the region the child attached to: a priority-1 child's launches stop
    and resume when it is cleared; a priority-0 child is never blocked.
    The wait shows in the pressure counters the JAX view reads."""
    env, cache = child_env(tmp_path, f"prio{priority}",
                           **{api.ENV_TASK_PRIORITY: priority})
    proc = spawn(env, "serve")
    try:
        ask(proc)
        time.sleep(0.1)
        with JaxRegionView(cache) as view:
            view.set_recent_kernel(-1)  # FEEDBACK_BLOCK
            time.sleep(0.1)
            a = ask(proc)
            time.sleep(0.3)
            b = ask(proc)
            view.set_recent_kernel(0)  # FEEDBACK_IDLE
            time.sleep(0.2)
            c = ask(proc)
            pressure = view.snapshot().pressure
        with RegionView(cache) as view:  # the port's own binding
            assert view.pressure() == pressure
            assert view.recent_kernel > 0  # unblocked, bumped by launches
        if priority:
            assert b["mock"] == a["mock"], (a, b)
            assert pressure["contention_spins"] > 0
            assert pressure["at_limit_ns"] >= 300 * MS
        else:
            assert b["mock"] - a["mock"] > 50, (a, b)
            assert pressure["contention_spins"] == 0
        assert c["mock"] - b["mock"] > 50, (b, c)
    finally:
        proc.kill()
        proc.wait(timeout=30)


def test_utilization_switch_lifts_the_throttle(tmp_path, libs):
    """A child at 30%: utilization_switch = 1 (written with the JAX
    RegionView) lifts its throttle; back at 0, the buckets are reset and
    the limit binds again."""
    env, cache = child_env(tmp_path, "switch",
                           **{api.ENV_SM_LIMIT: 30})
    proc = spawn(env, "serve")

    def rate(seconds=0.5):
        a = ask(proc)
        time.sleep(seconds)
        b = ask(proc)
        return (b["mock"] - a["mock"]) / (b["t"] - a["t"])

    try:
        ask(proc)
        time.sleep(0.3)  # spends the burst
        with JaxRegionView(cache) as view:
            limited = rate()
            view.set_utilization_switch(1)
            free = rate()
            view.set_utilization_switch(0)
            time.sleep(0.1)
            again = rate()
        assert limited < 0.55 * free, (limited, free)
        assert again < 0.55 * free, (again, free)
    finally:
        proc.kill()
        proc.wait(timeout=30)


def test_gate_refuses_launches_past_a_lowered_limit(tmp_path, libs):
    """The limit lowered below the child's usage (clamped to it by the
    checked resize) refuses cuLaunchKernel with CUDA_ERROR_OUT_OF_MEMORY
    before the driver is called: the mock counts no launch meanwhile.
    Restored, launches pass again."""
    env, cache = child_env(tmp_path, "gate")
    proc = spawn(env, "serve")
    try:
        ask(proc, "alloc 33554432")
        time.sleep(0.1)
        with JaxRegionView(cache) as view:
            assert view.used(0) == 32 << 20
            rc, applied = view.set_limit_checked(16 << 20)
            assert applied == 32 << 20  # clamped to the usage
            time.sleep(0.1)
            a = ask(proc)
            time.sleep(0.2)
            b = ask(proc)
            assert a["last_rc"] == 2 and b["last_rc"] == 2
            assert b["refused"] > a["refused"]
            assert b["mock"] == a["mock"]
            assert b["ok"] == a["ok"]
            view.set_limit_checked(64 << 20)
            time.sleep(0.2)
            c = ask(proc)
            pressure = view.snapshot().pressure
        assert c["last_rc"] == 0 and c["mock"] > b["mock"]
        assert pressure["near_limit_failures"] >= b["refused"] - a["refused"]
    finally:
        proc.kill()
        proc.wait(timeout=30)


def test_capture_passes_through_and_graph_launches_are_throttled(tmp_path,
                                                                libs):
    """Launches into a capturing stream reach the driver untouched, with
    no event recorded on that stream. The graph of five 1 ms kernels,
    replayed back to back at 50%, runs at 0.4-0.6x of the unthrottled
    replays, and each replay is charged as the 5 ms it took."""
    runs, caches = {}, {}
    for limit in (0, 50):
        env, caches[limit] = child_env(tmp_path, f"graph{limit}",
                                       **{api.ENV_SM_LIMIT: limit})
        runs[limit] = spawn(env, "graph", 1.5, 0.3)
    try:
        got = {k: line(p) for k, p in runs.items()}
        with JaxRegionView(caches[50]) as view:
            (slot,) = view.procs()
    finally:
        for p in runs.values():
            p.communicate("done\n", timeout=30)
    for g in got.values():
        assert g["graph_hooked"]
        assert g["captured"] == [0] * 5 and g["reached"] == 5
        assert g["capture_records"] == 0
    assert 0.4 <= got[50]["n"] / got[0]["n"] <= 0.6, got
    charged = slot.launch_ns / (got[50]["replays"] * 5 * MS)
    assert 0.9 <= charged <= 1.1, (slot.launch_ns, got[50])


def test_threads_count_exactly_and_do_not_deadlock(tmp_path, libs):
    """Four threads, each on its own stream, launch 400 kernels of 200 us
    at once under a 50% limit: no deadlock, every launch counted in the
    region (read by the JAX package), none left in flight, and the device
    time charged as the streams' sum."""
    env, cache = child_env(tmp_path, "threads", MOCK_CUDA_KERNEL_NS=200_000,
                           **{api.ENV_SM_LIMIT: 50})
    proc = spawn(env, "threads", 4, 400)
    try:
        got = line(proc)
        with JaxRegionView(cache) as view:
            total = view.total_launches()
            (slot,) = view.procs()
            inflight = view.inflight()
        with RegionView(cache) as view:  # the port's own binding
            (mine,) = view.procs()
            assert view.total_launches() == total
            assert (mine.launches, mine.launch_ns, mine.inflight) == (
                slot.launches, slot.launch_ns, slot.inflight)
        proc.communicate("done\n", timeout=30)
    finally:
        proc.kill()
        proc.wait(timeout=30)
    assert got["alive"] == 0 and got["mock"] == 1600
    assert total == 1600 and slot.launches == 1600 and inflight == 0
    assert 0.9 <= slot.launch_ns / (1600 * 200_000) <= 1.1, slot.launch_ns


def test_every_launch_entry_point_is_throttled_and_counted(tmp_path,
                                                          libs):
    """cuLaunchKernel, cuLaunchKernelEx, cuLaunchCooperativeKernel and
    cuGraphLaunch, each asked for plain and per-thread-stream: every one
    is the interposer's hook, runs, and is counted and charged in the
    region (a 1 ms kernel each, one more captured into the graph)."""
    env, cache = child_env(tmp_path, "entries",
                           **{api.ENV_SM_LIMIT: 50})
    proc = spawn(env, "entries")
    try:
        got = line(proc)
        with JaxRegionView(cache) as view:
            total = view.total_launches()
            (slot,) = view.procs()
        proc.communicate("done\n", timeout=30)
    finally:
        proc.kill()
        proc.wait(timeout=30)
    assert all(got["entries"].values()) and len(got["entries"]) == 8, got
    assert all(rc == [0, 0] for rc in got["rcs"].values()), got["rcs"]
    assert got["mock"] == 7 and got["graphs"] == 2
    assert total == 9 and slot.launches == 9
    assert 0.9 <= slot.launch_ns / (8 * MS) <= 1.1, slot.launch_ns


def test_disable_control_passes_launches_through(tmp_path, libs):
    """CUDA_DISABLE_CONTROL: no launch hook is handed out, a 10% limit does
    not apply and no region is made."""
    runs = {}
    for name, extra in (("free", {}),
                        ("off", {api.ENV_SM_LIMIT: 10,
                                 api.ENV_DISABLE_CONTROL: 1})):
        env, cache = child_env(tmp_path, name, **extra)
        runs[name] = (spawn(env, "burn", 0.5, 0, "sync"), cache)
    got = {name: result(p, timeout=60) for name, (p, _) in runs.items()}
    assert not got["off"]["hooked"] and got["free"]["hooked"]
    assert got["off"]["n"] >= 0.8 * got["free"]["n"], got
    assert not os.path.exists(runs["off"][1])


def test_unlimited_launches_are_timed_like_the_jax_shim(tmp_path, libs,
                                                       jax_shim):
    """With no SM limit, the interposer times every launch as the JAX shim
    times every execute: 1 ms kernels, synchronised, for 1.5 s, beside the
    JAX shim's burn with no limit on 1 ms executes. Both regions, read
    through the JAX RegionView while their processes live, hold busy_ns
    within 0.9-1.25x their launches x 1 ms (the JAX shim charges dispatch
    to completion, ~1.1x here)."""
    cache = tmp_path / "jax.cache"
    env = dict(os.environ, LIBVTPU_SO=os.path.join(jax_shim, "libvtpu.so"),
               VTPU_REAL_LIBTPU_PATH=os.path.join(jax_shim, "mock_pjrt.so"),
               TPU_DEVICE_MEMORY_LIMIT="1g",
               TPU_DEVICE_MEMORY_SHARED_CACHE=str(cache),
               MOCK_PJRT_EXEC_NS=str(MS), MOCK_PJRT_OUT_BYTES="0")
    env.pop("TPU_DEVICE_TENSORCORE_LIMIT", None)
    jax = subprocess.Popen([os.path.join(jax_shim, "shim_test"), "burn",
                            "1500"], env=env, stdout=subprocess.PIPE,
                           text=True, cwd=jax_shim)
    penv, pcache = child_env(tmp_path, "unlimited")
    port = spawn(penv, "burn", 1.5, 0, "sync", "wait")
    try:
        time.sleep(1.0)
        with JaxRegionView(str(cache)) as view:
            snap = view.snapshot()
        jax_ratio = snap.busy_ns() / (snap.total_launches() * MS)
        got = line(port)
        with JaxRegionView(pcache) as view:
            (slot,) = view.procs()
            busy, inflight = view.busy_ns(), view.inflight()
        port.communicate("done\n", timeout=30)
        out, _ = jax.communicate(timeout=60)
    finally:
        for proc in (jax, port):
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
    assert jax.returncode == 0 and int(out) > 0
    assert got["hooked"] and slot.launches == got["n"] == got["mock"]
    port_ratio = busy / (slot.launches * MS)
    for ratio in (jax_ratio, port_ratio):
        assert 0.9 <= ratio <= 1.25, (jax_ratio, port_ratio)
    assert inflight == 0


def test_unlimited_long_kernel_is_in_flight(tmp_path, libs):
    """One 2.5 s kernel with no SM limit: the slot shows it in flight while
    launches are recent, not after 1 s with no launch (the process may be
    idle), and after a synchronise and flush it is charged its 2.5 s with
    nothing in flight."""
    env, cache = child_env(tmp_path, "long", MOCK_CUDA_KERNEL_NS=2500 * MS)
    proc = spawn(env, "long")
    try:
        assert line(proc)["launched"]
        time.sleep(0.3)
        with JaxRegionView(cache) as view:
            running = view.inflight()
            time.sleep(1.3)
            later = view.inflight()
            assert ask(proc, "sync")["done"]
            (slot,) = view.procs()
            after = view.inflight()
        proc.communicate("done\n", timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    assert running == 1 and later == 0 and after == 0, (running, later,
                                                         after)
    assert 0.95 <= slot.launch_ns / (2500 * MS) <= 1.05, slot.launch_ns
