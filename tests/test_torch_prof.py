"""libvgpu.so's callsite profile plane on the CPU: a child under
``LD_PRELOAD`` of the interposer drives the mock libcuda.so.1 through
ctypes (as tests/test_torch_faults.py does) and the region shows exactly
its calls, class by class: BUF_ALLOC and BUF_FREE around the allocation
hooks, EXECUTE around the launch hooks with QUOTA_CHECK inside it, CHARGE
and UNCHARGE from the region's primitives, TRANSFER around every copy entry
point (each variant, its bytes, its errors; nothing charged) and
DONE_WITH_BUFFER for each bracket (at an SM limit) or span (with none) of
launches charged to the device.

The region is read three ways and they must agree: the port's reader
(``vtpu_torch.bench.prof``), the JAX package's ``RegionView`` and
``hack/vtpuprof.py`` (loaded by file path, as tests/test_shim_profile.py
loads it). Then ``python -m vtpu_torch.bench --profile`` reports over
regions such children wrote: on the CPU a model makes no driver call, so
the mode's child launch is the ctypes child here (on the card it is the
case's matrix run)."""

import importlib.util
import json
import os
import subprocess
import sys
import textwrap

import pytest

from tests import torch_jaxlib
from vtpu.enforce import region as jax_region
from vtpu_torch import api, native
from vtpu_torch.bench import profile, prof
from vtpu_torch.enforce.region import PROF_CALLSITE_NAMES, RegionView

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MiB = 1 << 20

_spec = importlib.util.spec_from_file_location(
    "vtpuprof_ref", os.path.join(REPO, "hack", "vtpuprof.py"))
vtpuprof = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(vtpuprof)

# N allocations of SIZE, one of OVER past the quota, the N frees, M
# launches (each followed by a synchronisation), N copies through each
# hooked copy entry point and one refused by the driver
N, M, SIZE, OVER, QUOTA = 5, 40, 8 * MiB, 32 * MiB, "64m"

# the copy entry points: (base name, per-thread stream variant, exact
# symbol, shape); a shape's bytes are COPY_BYTES'
COPIES = [(base, ptds, sym, shape)
          for base, v2, shape in [
              ("cuMemcpy", "", "linear"), ("cuMemcpyAsync", "", "linear"),
              ("cuMemcpyHtoD", "_v2", "linear"),
              ("cuMemcpyDtoH", "_v2", "linear"),
              ("cuMemcpyDtoD", "_v2", "linear"),
              ("cuMemcpyHtoDAsync", "_v2", "linear"),
              ("cuMemcpyDtoHAsync", "_v2", "linear"),
              ("cuMemcpyDtoDAsync", "_v2", "linear"),
              ("cuMemcpy2D", "_v2", "2d"),
              ("cuMemcpy2DUnaligned", "_v2", "2d"),
              ("cuMemcpy2DAsync", "_v2", "2d"), ("cuMemcpy3D", "_v2", "3d"),
              ("cuMemcpy3DAsync", "_v2", "3d"),
              ("cuMemcpyPeer", "", "linear"),
              ("cuMemcpyPeerAsync", "", "linear"),
              ("cuMemcpy3DPeer", "", "3d"),
              ("cuMemcpy3DPeerAsync", "", "3d")]
          for ptds, sym in [
              (0, base + v2),
              (1, base + v2 + ("_ptsz" if "Async" in base else "_ptds"))]]
COPY_BYTES = {"linear": 4096, "2d": 256 * 4, "3d": 64 * 4 * 2}

CHILD = textwrap.dedent(r"""
    import ctypes, json, os, sys
    from ctypes import (CFUNCTYPE, POINTER, byref, c_char_p, c_int,
                        c_size_t, c_uint, c_uint64, c_ulonglong, c_void_p)

    cu = ctypes.CDLL("libcuda.so.1")
    GPA2 = CFUNCTYPE(c_int, c_char_p, POINTER(c_void_p), c_int, c_uint64,
                     POINTER(c_int))
    gpa2 = GPA2(ctypes.cast(cu.cuGetProcAddress_v2, c_void_p).value)

    def via2(base):
        p, st = c_void_p(), c_int(-1)
        rc = gpa2(base.encode(), byref(p), 12080, 0, byref(st))
        assert rc == 0 and st.value == 0, (base, rc, st.value)
        return p.value

    def via(base, flags):
        p, st = c_void_p(), c_int(-1)
        rc = gpa2(base.encode(), byref(p), 12080, flags, byref(st))
        assert rc == 0 and st.value == 0, (base, flags, rc, st.value)
        return p.value

    alloc = CFUNCTYPE(c_int, POINTER(c_ulonglong), c_size_t)(
        via2("cuMemAlloc"))
    free = CFUNCTYPE(c_int, c_ulonglong)(via2("cuMemFree"))
    launch = CFUNCTYPE(c_int, c_void_p, c_uint, c_uint, c_uint, c_uint,
                       c_uint, c_uint, c_uint, c_void_p, c_void_p,
                       c_void_p)(via2("cuLaunchKernel"))
    sync = CFUNCTYPE(c_int, c_void_p)(via2("cuStreamSynchronize"))

    if sys.argv[1] == "each":  # one call of each other hooked entry point
        class Desc(ctypes.Structure):
            _fields_ = [("width", c_size_t), ("height", c_size_t),
                        ("format", c_int), ("channels", c_uint)]

        class Config(ctypes.Structure):
            _fields_ = [("grid", c_uint * 3), ("block", c_uint * 3),
                        ("shmem", c_uint), ("stream", c_void_p),
                        ("attrs", c_void_p), ("nattrs", c_uint)]

        u64p = POINTER(c_ulonglong)
        pitch_alloc = CFUNCTYPE(c_int, u64p, POINTER(c_size_t), c_size_t,
                                c_size_t, c_uint)(via2("cuMemAllocPitch"))
        managed = CFUNCTYPE(c_int, u64p, c_size_t, c_uint)(
            via2("cuMemAllocManaged"))
        array = CFUNCTYPE(c_int, POINTER(c_void_p), POINTER(Desc))(
            via2("cuArrayCreate"))
        destroy = CFUNCTYPE(c_int, c_void_p)(via2("cuArrayDestroy"))
        alloc_async = CFUNCTYPE(c_int, u64p, c_size_t, c_void_p)(
            via2("cuMemAllocAsync"))
        free_async = CFUNCTYPE(c_int, c_ulonglong, c_void_p)(
            via2("cuMemFreeAsync"))
        coop = CFUNCTYPE(c_int, c_void_p, c_uint, c_uint, c_uint, c_uint,
                         c_uint, c_uint, c_uint, c_void_p, c_void_p)(
            via2("cuLaunchCooperativeKernel"))
        launch_ex = CFUNCTYPE(c_int, POINTER(Config), c_void_p, c_void_p,
                              c_void_p)(via2("cuLaunchKernelEx"))
        a, b, c, pitch, h = (c_ulonglong(), c_ulonglong(), c_ulonglong(),
                             c_size_t(), c_void_p())
        assert pitch_alloc(byref(a), byref(pitch), 1000, 4, 4) == 0
        assert pitch.value == 1024
        assert managed(byref(b), 1 << 20, 1) == 0
        assert array(byref(h), byref(Desc(256, 256, 0x20, 1))) == 0
        assert alloc_async(byref(c), 1 << 20, None) == 0
        assert free(a.value) == 0 and free(b.value) == 0
        assert destroy(h) == 0 and free_async(c.value, None) == 0
        config = Config((1, 1, 1), (1, 1, 1), 0, None, None, 0)
        for _ in range(2):
            assert coop(None, 1, 1, 1, 1, 1, 1, 0, None, None) == 0
            assert launch_ex(byref(config), None, None, None) == 0
        assert sync(None) == 0
        sys.exit(0)
    vg = ctypes.CDLL(os.environ["LD_PRELOAD"])
    if sys.argv[1] == "bracket":  # launches at an SM limit, then a flush
        for _ in range(int(sys.argv[2])):
            assert launch(None, 1, 1, 1, 1, 1, 1, 0, None, None, None) == 0
        vg.vgpu_flush_launches()
        sys.exit(0)
    n, m, size, over = map(int, sys.argv[1:5])
    copies = json.loads(sys.argv[5])
    held, p = [], c_ulonglong()
    for _ in range(n):
        assert alloc(byref(p), size) == 0
        held.append(p.value)
    assert alloc(byref(p), over) == 2  # CUDA_ERROR_OUT_OF_MEMORY

    class Copy2D(ctypes.Structure):  # CUDA_MEMCPY2D
        _fields_ = [("srcX", c_size_t), ("srcY", c_size_t),
                    ("srcType", c_int), ("srcHost", c_void_p),
                    ("srcDevice", c_ulonglong), ("srcArray", c_void_p),
                    ("srcPitch", c_size_t), ("dstX", c_size_t),
                    ("dstY", c_size_t), ("dstType", c_int),
                    ("dstHost", c_void_p), ("dstDevice", c_ulonglong),
                    ("dstArray", c_void_p), ("dstPitch", c_size_t),
                    ("width", c_size_t), ("height", c_size_t)]

    class Copy3D(ctypes.Structure):  # CUDA_MEMCPY3D, CUDA_MEMCPY3D_PEER
        _fields_ = [("srcX", c_size_t), ("srcY", c_size_t),
                    ("srcZ", c_size_t), ("srcLOD", c_size_t),
                    ("srcType", c_int), ("srcHost", c_void_p),
                    ("srcDevice", c_ulonglong), ("srcArray", c_void_p),
                    ("srcCtx", c_void_p), ("srcPitch", c_size_t),
                    ("srcHeight", c_size_t), ("dstX", c_size_t),
                    ("dstY", c_size_t), ("dstZ", c_size_t),
                    ("dstLOD", c_size_t), ("dstType", c_int),
                    ("dstHost", c_void_p), ("dstDevice", c_ulonglong),
                    ("dstArray", c_void_p), ("dstCtx", c_void_p),
                    ("dstPitch", c_size_t), ("dstHeight", c_size_t),
                    ("width", c_size_t), ("height", c_size_t),
                    ("depth", c_size_t)]

    host = ctypes.create_string_buffer(size)
    dev, ctx = held[0], c_void_p(0x100)
    u64 = c_ulonglong
    shapes = {"linear": [u64, u64, c_size_t], "2d": [POINTER(Copy2D)],
              "3d": [POINTER(Copy3D)]}
    c2d = Copy2D(width=256, height=4, srcDevice=dev, dstDevice=dev)
    c3d = Copy3D(width=64, height=4, depth=2, srcDevice=dev, dstDevice=dev)
    for base, ptds, sym, shape in copies:
        argt = list(shapes[shape])
        if "Peer" in base and shape == "linear":
            argt = [u64, c_void_p, u64, c_void_p, c_size_t]
        if "Async" in base:
            argt.append(c_void_p)
        fn = CFUNCTYPE(c_int, *argt)(via(base, 2 if ptds else 0))
        args = {"linear": [dev, dev, 4096], "2d": [byref(c2d)],
                "3d": [byref(c3d)]}[shape]
        if "Peer" in base and shape == "linear":
            args = [dev, ctx, dev, ctx, 4096]
        if "HtoD" in base:
            args = [dev, ctypes.addressof(host), 4096]
        elif "DtoH" in base:
            args = [ctypes.addressof(host), dev, 4096]
        for _ in range(n):
            assert fn(*args, *([None] if "Async" in base else [])) == 0
        assert cu.mock_cuda_copy_calls(sym.encode()) == n, sym
    htod = CFUNCTYPE(c_int, u64, c_void_p, c_size_t)(via2("cuMemcpyHtoD"))
    assert htod(dev, None, 4096) == 1  # CUDA_ERROR_INVALID_VALUE
    for h in held:
        assert free(h) == 0
    for _ in range(m):
        assert launch(None, 1, 1, 1, 1, 1, 1, 0, None, None, None) == 0
        assert sync(None) == 0
""")


@pytest.fixture(scope="module")
def libs():
    return native.build_all()


@pytest.fixture(scope="module")
def jax_core(tmp_path_factory):
    """The JAX package's libvtpucore.so (tests/torch_jaxlib.py)."""
    return torch_jaxlib.core(tmp_path_factory)


@pytest.fixture(autouse=True)
def jax_reads_with_its_own_lib(jax_core, monkeypatch):
    monkeypatch.setenv("VTPU_CORE_LIB", jax_core)
    monkeypatch.setattr(jax_region, "_lib", None)
    monkeypatch.setattr(jax_region, "_abi_checked", False)


def run_child(env: dict, *args) -> None:
    """The ctypes child under ``env`` (libvgpu.so preloaded, the mock
    driver on the library path): N allocations, one refused, N copies
    through each copy entry point and one refused, N frees and M launches
    each followed by a synchronisation, or ``args``' mode."""
    args = args or (N, M, SIZE, OVER, json.dumps(COPIES))
    proc = subprocess.run([sys.executable, "-c", CHILD, *map(str, args)],
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr


def child_env(tmp_path, **extra) -> tuple:
    cache = tmp_path / "containers" / "pod-uid_0" / api.CACHE_FILENAME
    cache.parent.mkdir(parents=True, exist_ok=True)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("CUDA_", "LD_PRELOAD", "MOCK_", "VGPU_",
                                "VTPU_PROFILE"))}
    env.update({
        "LD_PRELOAD": native.interposer(),
        "LD_LIBRARY_PATH": native.mock_cuda_dir(),
        "MOCK_CUDA_TOTAL": "4g",
        api.ENV_LOCK_DIR: str(tmp_path / "locks"),
        api.ENV_SHARED_CACHE: str(cache),
        api.ENV_DEVICE_MEMORY_LIMIT: QUOTA,
    })
    env.update({k: str(v) for k, v in extra.items()})
    return env, str(cache)


def cells(cache: str) -> dict:
    with RegionView(cache) as view:
        return view.snapshot().prof


# calls, errors and bytes of each class after the child's run
WANT = {
    "buf_alloc": (N + 1, 1, N * SIZE),
    "buf_free": (N, 0, N * SIZE),
    "charge": (N + 1, 1, N * SIZE),
    "uncharge": (N, 0, N * SIZE),
    "execute": (M, 0, 0),
    # N of each copy entry point with its bytes, and the one refused
    "transfer": (N * len(COPIES) + 1, 1,
                 N * sum(COPY_BYTES[c[3]] for c in COPIES)),
    # each launch's span, charged at the synchronisation after it
    "done_with_buffer": (M, 0, 0),
    "quota_check": (M, 0, 0),
}


@pytest.mark.parametrize("sample", ["1", "default"])
def test_every_hooked_call_is_counted_exactly(tmp_path, libs, sample):
    """N allocations, one past the quota (refused before the driver is
    called), N frees and M launches: exact calls, errors and bytes per
    class. Every call timed (VTPU_PROFILE_SAMPLE=1) or, by default, 1 in 64
    of each thread's calls: the counts are exact either way, the timed
    calls' histogram holds every timed call."""
    extra = ({api.ENV_PROFILE: 1, api.ENV_PROFILE_SAMPLE: 1}
             if sample == "1" else {})
    env, cache = child_env(tmp_path, **extra)
    run_child(env)
    got = cells(cache)
    assert {name: (st.calls, st.errors, st.bytes)
            for name, st in got.items()} == WANT
    for name, st in got.items():
        assert sum(st.hist) == st.sampled, name
        if sample == "1":
            assert st.sampled == st.calls, name
    if sample == "default":
        calls = sum(st.calls for st in got.values())
        assert sum(st.sampled for st in got.values()) <= calls // 64 + 1
    with RegionView(cache) as view:
        assert view.total_launches() == M
        assert view.procs() == [] and view.used(0) == 0


def test_each_entry_point_is_noted(tmp_path, libs):
    """The other allocation, free and launch hooks: a pitched allocation
    (its padding charged too), managed memory, an array, a stream-ordered
    allocation (its bytes the request's; its free's unknown, since a pool
    keeps what it reserved) and their frees; cooperative and
    cuLaunchKernelEx launches."""
    env, cache = child_env(tmp_path, **{api.ENV_PROFILE: 1,
                                        api.ENV_PROFILE_SAMPLE: 1})
    run_child(env, "each")
    got = cells(cache)
    pitched, array = 1024 * 4, 256 * 256 * 4
    assert (got["buf_alloc"].calls, got["buf_alloc"].errors,
            got["buf_alloc"].bytes) == (4, 0, pitched + 2 * MiB + array)
    assert (got["buf_free"].calls, got["buf_free"].errors,
            got["buf_free"].bytes) == (4, 0, pitched + MiB + array)
    assert got["execute"].calls == got["quota_check"].calls == 4
    assert got["execute"].sampled == 4
    with RegionView(cache) as view:
        assert view.total_launches() == 4


@pytest.mark.parametrize("launches", [1, 7])
def test_each_charged_bracket_is_noted_once(tmp_path, libs, launches):
    """At an SM limit each launch's bracket is charged once its stream has
    drained (the mock's kernels take no time): at the next launch, the
    last at the flush. One DONE_WITH_BUFFER each, no error, no table
    drop."""
    env, cache = child_env(tmp_path, **{api.ENV_PROFILE: 1,
                                        api.ENV_PROFILE_SAMPLE: 1,
                                        api.ENV_SM_LIMIT: 50})
    run_child(env, "bracket", launches)
    got = cells(cache)
    assert (got["done_with_buffer"].calls,
            got["done_with_buffer"].errors) == (launches, 0)
    assert got["execute"].calls == launches
    assert got["transfer"].calls == 0
    with RegionView(cache) as view:
        assert view.pressure()["table_drops"] == 0
        assert view.total_launches() == launches


def test_profile_off_leaves_every_cell_zero(tmp_path, libs):
    """VTPU_PROFILE=0: the hooks count nothing, the pressure counters
    included (each hooked call pays one relaxed load)."""
    env, cache = child_env(tmp_path, **{api.ENV_PROFILE: 0})
    run_child(env)
    got = cells(cache)
    assert set(got) == set(PROF_CALLSITE_NAMES)
    for name, st in got.items():
        assert (st.calls, st.errors, st.bytes, st.sampled, st.total_ns,
                sum(st.hist)) == (0, 0, 0, 0, 0, 0), name
    with RegionView(cache) as view:
        assert not any(view.pressure().values())
        assert view.total_launches() == M  # the compute plane still counts


def test_both_packages_read_the_same_profile(tmp_path, libs):
    """The JAX package's RegionView and hack/vtpuprof.py read the region
    libvgpu.so wrote as the port's reader does: the same summary, the same
    aggregate, table, top cost centers, pressure flags and diff."""
    env, cache = child_env(tmp_path, **{api.ENV_PROFILE: 1,
                                        api.ENV_PROFILE_SAMPLE: 1})
    run_child(env)
    with RegionView(cache) as view:
        port_summary = view.snapshot().profile_summary()
    with jax_region.RegionView(cache) as view:
        jax_summary = view.snapshot().profile_summary()
    assert port_summary == jax_summary
    assert port_summary["callsites"]["execute"]["calls"] == M
    entry = os.path.dirname(cache)
    ours = prof.aggregate(prof.collect_local([entry]))
    theirs = vtpuprof.aggregate(vtpuprof.collect_local([cache]))
    assert ours == theirs
    assert prof.render_table(ours, "t") == vtpuprof.render_table(theirs, "t")
    assert prof.top_cost_centers(ours, 3) == \
        vtpuprof.top_cost_centers(theirs, 3)
    assert prof.pressure_flags(ours) == vtpuprof.pressure_flags(theirs)
    # the refused allocation was at 5/8 of the quota: no near-limit flag
    assert prof.pressure_flags(ours) == []
    half = prof.aggregate([("x", port_summary)] * 2)
    assert prof.diff_aggregates(half, ours) == \
        vtpuprof.diff_aggregates(half, theirs)
    assert prof.render_diff_table(prof.diff_aggregates(half, ours)) == \
        vtpuprof.render_diff_table(vtpuprof.diff_aggregates(half, theirs))
    assert prof.main([entry, "--json"]) == 0


def test_profile_mode_reports_each_case(tmp_path, libs, monkeypatch,
                                        capsys):
    """``--profile`` over two cases whose children wrote their regions:
    the table, the top cost centers and the region's launches per case,
    the Markdown and JSON reports; the JSON serves as the next run's
    baseline (its diff printed). A child that fails fails the mode."""
    monkeypatch.setenv(api.ENV_BENCH_BACKEND, "mock")
    monkeypatch.setenv(api.ENV_BENCH_QUOTA, QUOTA)
    seen = []

    def case_child(cid, quick, reps, env):
        seen.append((cid, env["LD_PRELOAD"], env[api.ENV_PROFILE],
                     env[api.ENV_PROFILE_SAMPLE]))
        run_child(env)
        return 0

    monkeypatch.setattr(profile, "_case_child", case_child)
    md, js = tmp_path / "prof.md", tmp_path / "prof.json"
    assert profile.run_profile_mode(["1.1", "2.2"], True, 1, str(md),
                                    str(js)) == 0
    assert seen == [(c, native.interposer(), "1", "1")
                    for c in ("1.1", "2.2")]
    out = capsys.readouterr().out
    tops = [line.split(": ")[1].split(", ") for line in out.splitlines()
            if line.startswith("top shim cost centers: ")]
    assert len(tops) == 2 and all(
        len(t) == 2 and set(t) <= set(WANT) for t in tops), out
    data = json.loads(js.read_text())
    assert data["backend"] == "mock"
    assert data["region_launches"] == {"1.1": M, "2.2": M}
    for cid in ("1.1", "2.2"):
        cs = data["cases"][cid]["callsites"]
        assert {n: (c["calls"], c["errors"]) for n, c in cs.items()} == {
            n: w[:2] for n, w in WANT.items() if w[0]}
    assert "## Case 2.2" in md.read_text()

    assert profile.run_profile_mode(["1.1"], True, 1, "", "",
                                    baseline_path=str(js)) == 0
    assert "vs " + str(js) in capsys.readouterr().out

    monkeypatch.setattr(profile, "_case_child",
                        lambda cid, quick, reps, env: 1)
    assert profile.run_profile_mode(["1.1"], True, 1) == 1
