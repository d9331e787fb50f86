"""The port's native layer on the CPU: the gcc build (vtpu_torch/native.py)
and the interposer libvgpu.so, LD_PRELOADed into a child process that
drives the mock libcuda.so.1 (vtpu_torch/csrc/mock_cuda.c) through ctypes —
the way cudart reaches the driver: dlopen("libcuda.so.1"), dlsym, and
cuGetProcAddress by base name + version."""

import json
import os
import select
import subprocess
import sys
import textwrap

import pytest

from vtpu_torch import api, native
from vtpu_torch.enforce.region import RegionView

MiB = 1 << 20
LIMIT = 64 * MiB
CHUNK = 32 * MiB  # the mock pools' reservation granularity
PITCH_BYTES = 1024 * 1000  # 1000 rows of 1000 B, pitch rounded to 512

CHILD = textwrap.dedent(r"""
    import ctypes, json, os, sys
    from ctypes import (CFUNCTYPE, POINTER, byref, c_char_p, c_int,
                        c_size_t, c_uint, c_uint64, c_ulonglong, c_void_p)

    mode = sys.argv[1]
    cu = ctypes.CDLL("libcuda.so.1")
    vg = ctypes.CDLL(os.environ["LD_PRELOAD"]) if "LD_PRELOAD" in os.environ \
        else None
    u64p = POINTER(c_ulonglong)
    ALLOC = CFUNCTYPE(c_int, u64p, c_size_t)
    FREE = CFUNCTYPE(c_int, c_ulonglong)
    INFO = CFUNCTYPE(c_int, POINTER(c_size_t), POINTER(c_size_t))
    PITCH = CFUNCTYPE(c_int, u64p, POINTER(c_size_t), c_size_t, c_size_t,
                      c_uint)

    class Loc(ctypes.Structure):
        _fields_ = [("type", c_int), ("id", c_int)]

    class Prop(ctypes.Structure):
        _fields_ = [("type", c_int), ("handle_types", c_int),
                    ("location", Loc), ("win32", c_void_p),
                    ("flags", ctypes.c_ubyte * 8)]

    CREATE = CFUNCTYPE(c_int, u64p, c_size_t, POINTER(Prop), c_ulonglong)
    RELEASE = CFUNCTYPE(c_int, c_ulonglong)
    ASYNC = CFUNCTYPE(c_int, u64p, c_size_t, c_void_p)
    GPA2 = CFUNCTYPE(c_int, c_char_p, POINTER(c_void_p), c_int, c_uint64,
                     POINTER(c_int))
    GPA1 = CFUNCTYPE(c_int, c_char_p, POINTER(c_void_p), c_int, c_uint64)

    def addr(f):
        return ctypes.cast(f, c_void_p).value

    gpa2 = GPA2(addr(cu.cuGetProcAddress_v2))

    def via2(base, version, flags=0):
        p, st = c_void_p(), c_int(-1)
        rc = gpa2(base.encode(), byref(p), version, flags, byref(st))
        assert rc == 0 and st.value == 0, (base, rc, st.value)
        return p.value

    if mode == "exact":
        def resolve(base, exact, version):
            return addr(getattr(cu, exact))
    elif mode == "gpa1":
        gpa1 = GPA1(via2("cuGetProcAddress", 11030))

        def resolve(base, exact, version):
            p = c_void_p()
            assert gpa1(base.encode(), byref(p), version, 0) == 0, base
            return p.value
    else:
        def resolve(base, exact, version):
            return via2(base, version)

    ENTRIES = [("alloc", "cuMemAlloc", "cuMemAlloc_v2", 3020),
               ("pitch", "cuMemAllocPitch", "cuMemAllocPitch_v2", 3020),
               ("free", "cuMemFree", "cuMemFree_v2", 3020),
               ("info", "cuMemGetInfo", "cuMemGetInfo_v2", 3020),
               ("create", "cuMemCreate", "cuMemCreate", 10020),
               ("release", "cuMemRelease", "cuMemRelease", 10020)]
    fns = {name: resolve(base, exact, v) for name, base, exact, v in ENTRIES}
    out = {"hooked": {name: vg is not None and fns[name] == addr(
        getattr(vg, exact)) for name, _, exact, _ in ENTRIES}}
    if mode == "async":
        a, f, t = c_ulonglong(), c_size_t(), c_size_t()
        rc = ASYNC(via2("cuMemAllocAsync", 12000, 2))(byref(a), 4096, None)
        INFO(resolve("cuMemGetInfo", "cuMemGetInfo_v2", 3020))(byref(f),
                                                              byref(t))
        print(json.dumps([rc, f.value, t.value]), flush=True)
        sys.exit(0)

    alloc, free, info = ALLOC(fns["alloc"]), FREE(fns["free"]), \
        INFO(fns["info"])

    def meminfo():
        f, t = c_size_t(), c_size_t()
        return [info(byref(f), byref(t)), f.value, t.value]

    MiB = 1 << 20
    out["info0"] = meminfo()
    a, b, p, h = c_ulonglong(), c_ulonglong(), c_ulonglong(), c_ulonglong()
    out["alloc"] = alloc(byref(a), 40 * MiB)
    out["info1"] = meminfo()
    out["alloc_over"] = alloc(byref(b), 30 * MiB)
    pitch = c_size_t()
    out["pitch"] = [PITCH(fns["pitch"])(byref(p), byref(pitch), 1000, 1000,
                                        4), pitch.value]
    prop = Prop()
    prop.location.type, prop.location.id = 1, 0
    create = CREATE(fns["create"])
    out["create"] = create(byref(h), 8 * MiB, byref(prop), 0)
    out["create_over"] = create(byref(c_ulonglong()), 64 * MiB,
                                byref(prop), 0)
    out["info2"] = meminfo()
    out["active"] = vg.vgpu_interposer_active() if vg is not None else None
    print(json.dumps(out), flush=True)
    if "--wait" in sys.argv:
        sys.stdin.readline()
    done = {"release": RELEASE(fns["release"])(h.value),
            "free": [free(a.value), free(p.value)]}
    if out["alloc_over"] == 0:
        done["free"].append(free(b.value))
    done["info3"] = meminfo()
    print(json.dumps(done), flush=True)
""")


@pytest.fixture(scope="module")
def libs():
    return native.build_all()


def child_env(tmp_path, **extra):
    cache = tmp_path / "containers" / "pod-uid_0" / "vgpu.cache"
    cache.parent.mkdir(parents=True, exist_ok=True)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("CUDA_", "LD_PRELOAD"))}
    env.update({
        "LD_PRELOAD": native.interposer(),
        "LD_LIBRARY_PATH": native.mock_cuda_dir(),
        "MOCK_CUDA_TOTAL": "1g",
        api.ENV_DEVICE_MEMORY_LIMIT: "64m",
        api.ENV_SHARED_CACHE: str(cache),
    })
    env.update(extra)
    return env, str(cache)


def run_child(env, mode, *args, timeout=60):
    proc = subprocess.run([sys.executable, "-c", CHILD, mode, *args],
                          env=env, capture_output=True, text=True,
                          timeout=timeout)
    return proc


def parse(proc):
    assert proc.returncode == 0, proc.stderr
    first, second = proc.stdout.strip().splitlines()
    return json.loads(first), json.loads(second)


def test_build_outputs_and_rebuild_when_stale(libs):
    assert set(libs) == set(native.TARGETS)
    for path in libs.values():
        assert os.path.getsize(path) > 0
    core = libs["libvgpucore.so"]
    os.utime(core, (1, 1))  # older than every source
    assert native.core_library() == core
    assert os.path.getmtime(core) > 1


def test_build_failure_raises(monkeypatch):
    monkeypatch.setenv("CC", "no-such-compiler-vgpu")
    monkeypatch.setattr(native, "_stale", lambda out, deps: True)
    with pytest.raises(native.NativeBuildFailure):
        native.core_library()


@pytest.mark.parametrize("mode", ["exact", "gpa2", "gpa1"])
def test_interposer_charges_refuses_and_uncharges(tmp_path, libs, mode):
    """Every way of reaching the driver lands on the hooks: dlsym of the
    exported name, and cuGetProcAddress (v2, and the v1 that v2 hands out
    below 12000) asked for base names with a version."""
    env, cache = child_env(tmp_path)
    out, done = parse(run_child(env, mode))
    assert all(out["hooked"].values()), out["hooked"]
    assert out["active"] == 1
    assert out["info0"] == [0, LIMIT, LIMIT]
    assert out["alloc"] == 0
    assert out["info1"] == [0, LIMIT - 40 * MiB, LIMIT]
    assert out["alloc_over"] == 2  # CUDA_ERROR_OUT_OF_MEMORY, mock untouched
    assert out["pitch"] == [0, 1024]
    assert out["create"] == 0 and out["create_over"] == 2
    assert out["info2"] == [0, LIMIT - 48 * MiB - PITCH_BYTES, LIMIT]
    assert done["release"] == 0 and done["free"] == [0, 0]
    assert done["info3"] == [0, LIMIT, LIMIT]


def test_monitor_sees_the_child_and_a_clean_region_after_exit(tmp_path,
                                                              libs):
    env, cache = child_env(tmp_path)
    proc = subprocess.Popen([sys.executable, "-c", CHILD, "gpa2", "--wait"],
                            env=env, stdin=subprocess.PIPE,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        json.loads(proc.stdout.readline())
        with RegionView(cache) as view:
            assert [p.pid for p in view.procs()] == [proc.pid]
            assert view.used(0) == 48 * MiB + PITCH_BYTES
            assert view.hbm_limit(0) == LIMIT
        out, err = proc.communicate("go\n", timeout=60)
    finally:
        proc.kill()
        proc.wait(timeout=60)
    assert proc.returncode == 0, err
    assert json.loads(out)["info3"] == [0, LIMIT, LIMIT]
    with RegionView(cache) as view:
        assert view.procs() == [] and view.used(0) == 0


SIBLING = textwrap.dedent(r"""
    import ctypes, json
    from ctypes import byref, c_size_t, c_ulonglong
    cu = ctypes.CDLL("libcuda.so.1")
    cu.cuMemFree_v2.argtypes = [c_ulonglong]
    MiB = 1 << 20
    a, b, f, t = c_ulonglong(), c_ulonglong(), c_size_t(), c_size_t()
    out = [cu.cuMemAlloc_v2(byref(a), 20 * MiB),
           cu.cuMemAlloc_v2(byref(b), 10 * MiB)]
    cu.cuMemGetInfo_v2(byref(f), byref(t))
    out += [f.value, t.value, cu.cuMemFree_v2(b.value)]
    print(json.dumps(out))
""")


def test_quota_is_shared_by_the_containers_processes(tmp_path, libs):
    """The region is per container: a second process's charge counts
    against what the first one holds."""
    env, cache = child_env(tmp_path)
    first = subprocess.Popen([sys.executable, "-c", CHILD, "gpa2", "--wait"],
                             env=env, stdin=subprocess.PIPE,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True)
    try:
        json.loads(first.stdout.readline())  # holds 48 MiB + the pitch
        proc = subprocess.run([sys.executable, "-c", SIBLING], env=env,
                              capture_output=True, text=True, timeout=60)
        assert proc.returncode == 0, proc.stderr
        held = 48 * MiB + PITCH_BYTES
        assert json.loads(proc.stdout) == [
            2, 0, LIMIT - held - 10 * MiB, LIMIT, 0]
        first.communicate("go\n", timeout=60)
    finally:
        first.kill()
        first.wait(timeout=60)
    assert first.returncode == 0
    with RegionView(cache) as view:
        assert view.procs() == [] and view.used(0) == 0


def test_disable_control_passes_through(tmp_path, libs):
    env, cache = child_env(tmp_path, **{api.ENV_DISABLE_CONTROL: "1"})
    out, done = parse(run_child(env, "gpa2"))
    assert not any(out["hooked"].values())
    assert out["active"] == 0
    total = 1 << 30  # the mock's own, unspoofed
    assert out["info0"] == [0, total, total]
    assert out["alloc"] == 0 and out["alloc_over"] == 0
    assert done["free"] == [0, 0, 0]
    assert not os.path.exists(cache)


def test_stream_ordered_allocation_runs_enforced_and_exits_normally(
        tmp_path, libs):
    """A child that allocates from the stream-ordered allocator runs
    enforced: the allocation is charged at the pool's reservation (one
    32 MiB chunk of the mock's pool for 4 KiB), and the child exits
    normally."""
    env, _ = child_env(tmp_path)
    proc = run_child(env, "async")
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout) == [0, LIMIT - CHUNK, LIMIT]


def test_dlsym_rtld_next_still_finds_the_next_object(tmp_path, libs):
    """The interposer defines dlsym, so glibc sees IT as the caller of
    every dlsym(RTLD_NEXT, ...); it must answer for the real caller."""
    src = tmp_path / "next.c"
    src.write_text(textwrap.dedent("""
        #define _GNU_SOURCE
        #include <dlfcn.h>
        void *next_of(const char *s) { return dlsym(RTLD_NEXT, s); }
    """))
    so = tmp_path / "libnext.so"
    subprocess.run(["gcc", "-shared", "-fPIC", "-o", str(so), str(src),
                    "-ldl"], check=True)
    script = textwrap.dedent(f"""
        import ctypes
        lib = ctypes.CDLL({str(so)!r})
        lib.next_of.restype = ctypes.c_void_p
        lib.next_of.argtypes = [ctypes.c_char_p]
        libc = ctypes.CDLL("libc.so.6")
        want = ctypes.cast(libc.strlen, ctypes.c_void_p).value
        got = lib.next_of(b"strlen")
        assert got == want, (got, want)
        assert lib.next_of(b"no_such_symbol_vgpu") is None
    """)
    env, _ = child_env(tmp_path)
    proc = subprocess.run([sys.executable, "-c", script], env=env,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr


POOL_CHILD = textwrap.dedent(r"""
    import ctypes, json, os, sys, threading
    from ctypes import (CFUNCTYPE, POINTER, byref, c_char_p, c_int,
                        c_size_t, c_uint64, c_ulonglong, c_void_p)

    cu = ctypes.CDLL("libcuda.so.1")
    vg = ctypes.CDLL(os.environ["LD_PRELOAD"])
    cu.mock_cuda_pool_allocs.restype = ctypes.c_ulong
    u64p = POINTER(c_ulonglong)
    GPA2 = CFUNCTYPE(c_int, c_char_p, POINTER(c_void_p), c_int, c_uint64,
                     POINTER(c_int))
    gpa2 = GPA2(ctypes.cast(cu.cuGetProcAddress_v2, c_void_p).value)

    def via2(base, flags=0):
        p, st = c_void_p(), c_int(-1)
        rc = gpa2(base.encode(), byref(p), 12080, flags, byref(st))
        assert rc == 0 and st.value == 0, (base, rc, st.value)
        return p.value

    def addr(f):
        return ctypes.cast(f, c_void_p).value

    class Loc(ctypes.Structure):
        _fields_ = [("type", c_int), ("id", c_int)]

    class PoolProps(ctypes.Structure):
        _fields_ = [("alloc_type", c_int), ("handle_types", c_int),
                    ("location", Loc), ("win32", c_void_p),
                    ("max_size", c_size_t), ("usage", ctypes.c_ushort),
                    ("reserved", ctypes.c_ubyte * 54)]

    # (base name, cuGetProcAddress flags, the interposer's export)
    HOOKS = [("cuMemAllocAsync", 0, "cuMemAllocAsync"),
             ("cuMemAllocAsync", 2, "cuMemAllocAsync_ptsz"),
             ("cuMemAllocFromPoolAsync", 0, "cuMemAllocFromPoolAsync"),
             ("cuMemAllocFromPoolAsync", 2, "cuMemAllocFromPoolAsync_ptsz"),
             ("cuMemFreeAsync", 0, "cuMemFreeAsync"),
             ("cuMemFreeAsync", 2, "cuMemFreeAsync_ptsz"),
             ("cuMemPoolTrimTo", 0, "cuMemPoolTrimTo"),
             ("cuMemPoolDestroy", 0, "cuMemPoolDestroy")]
    out = {"hooked": {f"{base}/{flags}": via2(base, flags) == addr(
        getattr(vg, exact)) for base, flags, exact in HOOKS}}
    alloc = CFUNCTYPE(c_int, u64p, c_size_t, c_void_p)(
        via2("cuMemAllocAsync", 2))
    from_pool = CFUNCTYPE(c_int, u64p, c_size_t, c_void_p, c_void_p)(
        via2("cuMemAllocFromPoolAsync"))
    free = CFUNCTYPE(c_int, c_ulonglong, c_void_p)(via2("cuMemFreeAsync", 2))
    trim = CFUNCTYPE(c_int, c_void_p, c_size_t)(via2("cuMemPoolTrimTo"))
    sync = CFUNCTYPE(c_int, c_void_p)(via2("cuStreamSynchronize"))
    destroy = CFUNCTYPE(c_int, c_void_p)(via2("cuMemPoolDestroy"))
    create = CFUNCTYPE(c_int, POINTER(c_void_p), POINTER(PoolProps))(
        via2("cuMemPoolCreate"))
    dev_pool = CFUNCTYPE(c_int, POINTER(c_void_p), c_int)(
        via2("cuDeviceGetMemPool"))
    info = CFUNCTYPE(c_int, POINTER(c_size_t), POINTER(c_size_t))(
        via2("cuMemGetInfo"))
    mem_alloc = CFUNCTYPE(c_int, u64p, c_size_t)(via2("cuMemAlloc"))
    mem_free = CFUNCTYPE(c_int, c_ulonglong)(via2("cuMemFree"))

    def used():
        f, t = c_size_t(), c_size_t()
        assert info(byref(f), byref(t)) == 0
        return t.value - f.value

    MiB = 1 << 20
    pool = c_void_p()
    assert dev_pool(byref(pool), 0) == 0
    a, b, c, d = (c_ulonglong() for _ in range(4))
    out["used0"] = used()
    out["alloc_a"] = [alloc(byref(a), 1 * MiB, None), used()]
    out["alloc_b"] = [alloc(byref(b), 2 * MiB, None), used()]
    out["free_ab"] = [free(a.value, None), free(b.value, None), used()]
    # the frees are pending until a synchronisation: nothing to trim before
    out["trim"] = [trim(pool, 0), used(), sync(None), trim(pool, 0), used()]
    calls = cu.mock_cuda_pool_allocs()
    out["over"] = [alloc(byref(c), 64 * MiB + 1, None), used(),
                   cu.mock_cuda_pool_allocs() - calls]
    # 24 MiB held outside the pool: a 33 MiB request passes the check before
    # the call, but the pool grows by two chunks, which the quota refuses
    assert mem_alloc(byref(d), 24 * MiB) == 0
    calls = cu.mock_cuda_pool_allocs()
    out["growth_refused"] = [alloc(byref(c), 33 * MiB, None), c.value,
                             used(), cu.mock_cuda_pool_allocs() - calls]
    assert mem_free(d.value) == 0

    # 40 MiB freed: the pool reserves 64 MiB and uses none. A 20 MiB request
    # passes the quota on its size alone, but the pool serves it from what
    # it reserves: no growth, and no synchronisation and trim to make room
    # (which would leave one chunk charged, not two)
    assert alloc(byref(c), 40 * MiB, None) == 0 and free(c.value, None) == 0
    calls = cu.mock_cuda_pool_allocs()
    out["spare"] = [alloc(byref(c), 20 * MiB, None), used(),
                    cu.mock_cuda_pool_allocs() - calls]
    assert free(c.value, None) == 0
    # 60 MiB freed, pending: for 40 MiB more the pool grows by two chunks
    # past the quota; synchronised and trimmed, it fits, and the allocation
    # stays
    c.value = 0
    out["reclaimed"] = [alloc(byref(c), 40 * MiB, None), c.value != 0,
                        used()]
    assert free(c.value, None) == 0 and sync(None) == 0
    out["spare_trim"] = [trim(pool, 0), used()]

    # two threads allocating 20 MiB each from one pool at once: the pool
    # grows by two chunks, and the charge is two chunks, not one or three
    rounds, bad = 200, []
    ptrs = [c_ulonglong(), c_ulonglong()]
    for _ in range(rounds):
        gate = threading.Barrier(2)

        def one(i):
            gate.wait()
            assert alloc(byref(ptrs[i]), 20 * MiB, None) == 0

        ts = [threading.Thread(target=one, args=(i,)) for i in range(2)]
        [t.start() for t in ts]
        [t.join(timeout=30) for t in ts]
        assert not any(t.is_alive() for t in ts)
        if used() != 64 * MiB:
            bad.append(used())
        assert free(ptrs[0].value, None) == 0
        assert free(ptrs[1].value, None) == 0
        assert sync(None) == 0 and trim(pool, 0) == 0
    out["threads"] = [rounds, bad, used()]

    props = PoolProps()
    props.alloc_type, props.location.type, props.location.id = 1, 1, 0
    own = c_void_p()
    assert create(byref(own), byref(props)) == 0
    out["own_pool"] = [from_pool(byref(a), 1 * MiB, own, None), used()]
    out["destroy"] = [destroy(own), used()]
    print(json.dumps(out), flush=True)
""")


def test_pool_allocations_are_charged_at_the_pools_reservation(tmp_path,
                                                               libs):
    """The stream-ordered allocator, enforced on the mock's chunked pools,
    every hook reached through cuGetProcAddress: an allocation charges the
    chunk its pool reserves, not the request; a second one inside the chunk
    charges nothing; a free leaves the charge while the pool holds the
    memory; a trim returns it. A request past the quota is refused before
    the driver's allocator is called. When the pool's growth is what the
    quota refuses, the allocation is freed and the pool trimmed back. A
    request that fits in what the pool reserves and does not use is served
    near the quota; a growth refused while freed memory is pending is
    retried after the stream is synchronised and the pool trimmed. Two
    threads growing one pool charge the growth once; a pool of the
    process's own is charged and, destroyed, uncharged."""
    env, cache = child_env(tmp_path)
    proc = subprocess.run([sys.executable, "-c", POOL_CHILD], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout)
    assert all(out["hooked"].values()), out["hooked"]
    assert out["used0"] == 0
    assert out["alloc_a"] == [0, CHUNK]
    assert out["alloc_b"] == [0, CHUNK]
    assert out["free_ab"] == [0, 0, CHUNK]
    assert out["trim"] == [0, CHUNK, 0, 0, 0]
    assert out["over"] == [2, 0, 0]  # CUDA_ERROR_OUT_OF_MEMORY, mock untouched
    assert out["growth_refused"] == [2, 0, 24 * MiB, 1]
    assert out["spare"] == [0, 2 * CHUNK, 1]
    assert out["reclaimed"] == [0, True, 2 * CHUNK]
    assert out["spare_trim"] == [0, 0]
    assert out["threads"] == [200, [], 0]
    assert out["own_pool"] == [0, CHUNK]
    assert out["destroy"] == [0, 0]
    with RegionView(cache) as view:
        assert view.procs() == [] and view.used(0) == 0


def test_pool_hooks_pass_through_with_control_disabled(tmp_path, libs):
    """CUDA_DISABLE_CONTROL: no pool hook is handed out, nothing is charged
    and the quota does not apply (the mock's own 1 GiB does)."""
    env, cache = child_env(tmp_path, **{api.ENV_DISABLE_CONTROL: "1"})
    script = POOL_CHILD.split("\nMiB = 1 << 20\n")[0] + textwrap.dedent("""
        c = c_ulonglong()
        out["over"] = alloc(byref(c), 65 << 20, None)
        print(json.dumps(out), flush=True)
    """)
    proc = subprocess.run([sys.executable, "-c", script], env=env,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout)
    assert not any(out["hooked"].values()), out["hooked"]
    assert out["over"] == 0
    assert not os.path.exists(cache)


HOST_CHILD = textwrap.dedent(r"""
    import ctypes, json, mmap, os, sys
    from ctypes import (CFUNCTYPE, POINTER, byref, c_char_p, c_int,
                        c_size_t, c_uint, c_uint64, c_ulong, c_ulonglong,
                        c_void_p)

    cu = ctypes.CDLL("libcuda.so.1")
    vg = ctypes.CDLL(os.environ["LD_PRELOAD"])
    cu.mock_cuda_host_calls.restype = c_ulong
    GPA2 = CFUNCTYPE(c_int, c_char_p, POINTER(c_void_p), c_int, c_uint64,
                     POINTER(c_int))
    gpa2 = GPA2(ctypes.cast(cu.cuGetProcAddress_v2, c_void_p).value)

    def via2(base):
        p, st = c_void_p(), c_int(-1)
        assert gpa2(base.encode(), byref(p), 12080, 0, byref(st)) == 0, base
        return p.value

    class Loc(ctypes.Structure):
        _fields_ = [("type", c_int), ("id", c_int)]

    class Prop(ctypes.Structure):
        _fields_ = [("type", c_int), ("handle_types", c_int),
                    ("location", Loc), ("win32", c_void_p),
                    ("flags", ctypes.c_ubyte * 8)]

    HOOKS = [("cuMemHostAlloc", "cuMemHostAlloc"),
             ("cuMemAllocHost", "cuMemAllocHost_v2"),
             ("cuMemFreeHost", "cuMemFreeHost"),
             ("cuMemHostRegister", "cuMemHostRegister_v2"),
             ("cuMemHostUnregister", "cuMemHostUnregister")]
    out = {"hooked": {b: via2(b) == ctypes.cast(getattr(vg, e),
                                                   c_void_p).value
                      for b, e in HOOKS}}
    host_alloc = CFUNCTYPE(c_int, POINTER(c_void_p), c_size_t, c_uint)(
        via2("cuMemHostAlloc"))
    alloc_host = CFUNCTYPE(c_int, POINTER(c_void_p), c_size_t)(
        via2("cuMemAllocHost"))
    free_host = CFUNCTYPE(c_int, c_void_p)(via2("cuMemFreeHost"))
    register = CFUNCTYPE(c_int, c_void_p, c_size_t, c_uint)(
        via2("cuMemHostRegister"))
    unregister = CFUNCTYPE(c_int, c_void_p)(via2("cuMemHostUnregister"))
    create = CFUNCTYPE(c_int, POINTER(c_ulonglong), c_size_t, POINTER(Prop),
                       c_ulonglong)(via2("cuMemCreate"))
    release = CFUNCTYPE(c_int, c_ulonglong)(via2("cuMemRelease"))
    MiB = 1 << 20

    def step(name, rc):
        # the call's code and how many host calls reached the driver
        out[name] = [rc, cu.mock_cuda_host_calls()]

    a, b = c_void_p(), c_void_p()
    step("host_alloc", host_alloc(byref(a), 40 * MiB, 0))
    step("alloc_host_over", alloc_host(byref(b), 30 * MiB))
    buf = mmap.mmap(-1, 16 * MiB)
    p = ctypes.addressof(ctypes.c_char.from_buffer(buf))
    step("register", register(p, 16 * MiB, 0))
    prop = Prop()
    prop.location.type = 2  # CU_MEM_LOCATION_TYPE_HOST
    h = c_ulonglong()
    step("create_over", create(byref(h), 16 * MiB, byref(prop), 0))
    print(json.dumps(out), flush=True)
    sys.stdin.readline()  # the parent reads the region
    step("unregister", unregister(p))
    step("create", create(byref(h), 16 * MiB, byref(prop), 0))
    step("alloc_host", alloc_host(byref(b), 8 * MiB))
    print(json.dumps(out), flush=True)
    sys.stdin.readline()
    out = {"free": [free_host(a), free_host(b), release(h.value)]}
    print(json.dumps(out), flush=True)
    sys.stdin.readline()
""")


def test_host_ledger_charges_refuses_and_uncharges(tmp_path, libs,
                                                   monkeypatch):
    """Pinned host memory under CUDA_HOST_MEMORY_LIMIT=64m, through every
    host hook: cuMemHostAlloc, cuMemAllocHost_v2, cuMemHostRegister_v2 and
    host-located cuMemCreate are charged to the region's host ledger; one
    past the limit is refused with CUDA_ERROR_OUT_OF_MEMORY before the
    driver is called; cuMemHostUnregister, cuMemFreeHost and cuMemRelease
    uncharge. The JAX package's RegionView reads the same bytes."""
    env, cache = child_env(tmp_path, **{api.ENV_HOST_MEMORY_LIMIT: "64m"})
    proc = subprocess.Popen([sys.executable, "-c", HOST_CHILD], env=env,
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    import vtpu.enforce.region as jax_region
    monkeypatch.setenv("VTPU_CORE_LIB", native.core_library())
    monkeypatch.setattr(jax_region, "_lib", None)
    monkeypatch.setattr(jax_region, "_abi_checked", False)

    def host_used():
        with jax_region.RegionView(cache) as view:
            assert view.host_limit() == 64 * MiB
            return view.host_used()

    def line():
        ready, _, _ = select.select([proc.stdout], [], [], 60)
        assert ready, "no answer from the child in 60 s"
        return json.loads(proc.stdout.readline())

    try:
        first = line()
        held_first = host_used()
        proc.stdin.write("go\n")
        proc.stdin.flush()
        second = line()
        held_second = host_used()
        proc.stdin.write("go\n")
        proc.stdin.flush()
        third = line()
        held_third = host_used()
        proc.communicate("go\n", timeout=60)
    finally:
        proc.kill()
        proc.wait(timeout=60)
    assert proc.returncode == 0
    assert all(first["hooked"].values()), first["hooked"]
    assert first["host_alloc"] == [0, 1]
    assert first["alloc_host_over"] == [2, 1]  # refused, driver not called
    assert first["register"] == [0, 2]
    assert first["create_over"] == [2, 2]
    assert held_first == 56 * MiB
    assert second["unregister"] == [0, 2]
    assert second["create"] == [0, 3]
    assert second["alloc_host"] == [0, 4]
    assert held_second == 64 * MiB
    assert third["free"] == [0, 0, 0] and held_third == 0
    with RegionView(cache) as view:
        assert view.procs() == [] and view.host_used() == 0


ABI = textwrap.dedent(r"""
    import ctypes, json, os
    from ctypes import CFUNCTYPE, POINTER, byref, c_char_p, c_int, c_uint64
    from ctypes import c_void_p

    cu = ctypes.CDLL("libcuda.so.1")
    vg = ctypes.CDLL(os.environ["LD_PRELOAD"])
    gpa2 = CFUNCTYPE(c_int, c_char_p, POINTER(c_void_p), c_int, c_uint64,
                     POINTER(c_int))(ctypes.cast(cu.cuGetProcAddress_v2,
                                                 c_void_p).value)

    def addr(f):
        return ctypes.cast(f, c_void_p).value

    def via2(version):
        p, st = c_void_p(), c_int(-1)
        assert gpa2(b"cuCtxSynchronize", byref(p), version, 0,
                    byref(st)) == 0 and st.value == 0
        return p.value

    v13 = via2(13000)
    sync_v2 = CFUNCTYPE(c_int, c_void_p)(v13)
    print(json.dumps({
        "12080": via2(12080) == addr(vg.cuCtxSynchronize),
        "13000": [v13 == addr(vg.cuCtxSynchronize),
                  v13 == addr(cu.cuCtxSynchronize_v2)],
        "v2_with_a_context": sync_v2(0x100)}))
""")


def test_a_variant_of_another_abi_is_handed_out_unhooked(tmp_path, libs):
    """F17: asked for cuCtxSynchronize at CUDA 13.0, the driver answers with
    cuCtxSynchronize_v2, which takes a context. The hook of the old ABI is
    never handed out for it (it called the new entry point without its
    context: CUDA_ERROR_CONTEXT_IS_DESTROYED on the H100's CUDA 13.0
    driver). Since the _v2 has a hook of its own ABI, that hook is handed
    out at 13.0 and runs with its context (tests/test_torch_abi13.py holds
    what it does); at 12.8 the old ABI's hook."""
    env, _ = child_env(tmp_path)
    proc = subprocess.run([sys.executable, "-c", ABI], env=env,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout)
    assert out["12080"]  # at 12.8 the hook
    # at 13.0 not the old ABI's hook: the _v2's own, with its context
    assert out["13000"] == [False, True]
    assert out["v2_with_a_context"] == 0


def test_the_abi_probe_lists_the_variant_of_another_abi(libs):
    """``python -m vtpu_torch.bench.abi`` on the mock driver, without the
    interposer: every hooked variant, those of the copy table's continued
    lines too (103), is resolved at 12.8 and 13.0, and none is answered
    with another ABI. Before cuCtxSynchronize_v2 had its hook, the one
    listed was cuCtxSynchronize at 13.0 (the card's CUDA 13.0 driver
    answers the same, PERF.md)."""
    env = {k: v for k, v in os.environ.items() if k != "LD_PRELOAD"}
    env["LD_LIBRARY_PATH"] = native.mock_cuda_dir()
    proc = subprocess.run([sys.executable, "-m", "vtpu_torch.bench.abi"],
                          env=env, capture_output=True, text=True,
                          timeout=60)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout)
    assert out["driver_version"] == 12080 and out["variants"] == 103
    assert out["other_abi"] == {"12080": [], "13000": []}