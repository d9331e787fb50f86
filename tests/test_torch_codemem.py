"""Code memory under libvgpu.so on the CPU: the code-memory probe's child
(vtpu_torch/bench/codemem.py) and children of its own drive the mock
libcuda.so.1, whose module and library loads take MOCK_CUDA_LOAD_BYTES of
the mock card and whose unloads give them back (vtpu_torch/csrc/mock_cuda.c).
NVML lists every process as one pid (context mode) unless a test names
another; the tolerance is exact.

- Every entry point that loads code is measured and charged, whether it is
  reached through cuGetProcAddress or by its symbol; an unload gives back
  what its module was charged, and forgets its look-ups and first launches,
  so that a module loaded again at a freed handle is measured again.
- A load that does not fit is refused and undone, as the JAX shim refuses
  a program (lib/vtpu/libvtpu.c:2135-2145), and kills the process under
  ACTIVE_OOM_KILLER, as `shim_test burn` dies.
- A full table of modules charges nothing it could not release, and the
  quota view recovers after the unloads, as `shim_test scratchleak`'s does
  after its destroys.
"""

import json
import os
import signal
import subprocess
import sys
import textwrap

import pytest

import vtpu.enforce.region as jax_region
from tests import torch_jaxlib
from vtpu.enforce.region import RegionView as JaxRegionView
from vtpu_torch import api, native
from vtpu_torch.bench import codemem
from vtpu_torch.enforce.region import RegionView

MiB = 1 << 20
CTX = 64 * MiB      # codemem.MOCK_ENV: the mock's context
FUNC = 2 * MiB      # ... a function's lazy load
MODULE = 8 * MiB    # ... a library's module at its first look-up
FIX = codemem.FIXTURE_BYTES
CODE_MAX = 1 << 14  # libvgpu.c's CODE_MAX

# what each route's stages charge on the mock card
WANT = {route: {"load": FIX,
                "lookup": MODULE if route in codemem.LIBRARY_ROUTES else 0,
                "launch": FUNC} for route in codemem.ROUTES}
WANT["cuFuncLoad"] = {"load": FIX, "lookup": 0, "cuFuncLoad": FUNC,
                      "launch": 0}

CHILD = textwrap.dedent(r"""
    import ctypes, json, os, sys
    from ctypes import byref, c_size_t, c_void_p
    from vtpu_torch.bench.codemem import Code

    code = Code("mock", sys.argv[2])
    load, unload = code.fns["cuModuleLoadData"], code.fns["cuModuleUnload"]
    image = code.images["codemem.cubin"]
    out = {}
    if sys.argv[1] == "names":  # two look-ups through one name buffer
        mod = c_void_p()
        assert load(byref(mod), image) == 0
        name, f = ctypes.create_string_buffer(32), c_void_p()
        before = code.counters()["calls_measured"]
        for text in (b"codemem_touch", b"codemem_other"):
            name.value = text
            assert code.fns["cuModuleGetFunction"](byref(f), mod, name) == 0
        out["measured"] = code.counters()["calls_measured"] - before
        assert unload(mod) == 0
    elif sys.argv[1] == "table":  # the table of modules filled, then past
        info = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.POINTER(c_size_t),
                                ctypes.POINTER(c_size_t))(
            code.drv.address("cuMemGetInfo"))

        def free():
            f, t = c_size_t(), c_size_t()
            assert info(byref(f), byref(t)) == 0
            return f.value

        def loaded():
            h = c_void_p()
            assert load(byref(h), image) == 0
            return h.value

        out["free0"] = free()
        held = [loaded() for _ in range(int(sys.argv[3]))]
        out["full"] = [code.counters(), code.charge(), free()]
        extra = loaded()  # no room to record it: not charged
        out["past"] = [code.counters(), code.charge(), free()]
        assert unload(extra) == 0  # nothing to release, nothing underflows
        out["unloaded_past"] = [code.charge(), free()]
        assert unload(held.pop(0)) == 0
        held.append(loaded())  # room again: recorded and charged
        out["room_again"] = [code.counters(), code.charge(), free()]
        for h in held:
            assert unload(h) == 0
        out["end"] = [code.counters(), code.charge(), free()]
    print(json.dumps(out), flush=True)
""")


@pytest.fixture(scope="module")
def libs():
    return native.build_all()


@pytest.fixture(scope="module")
def jax_shim(tmp_path_factory):
    """The JAX shim's test pieces (tests/torch_jaxlib.py)."""
    return torch_jaxlib.build(tmp_path_factory)


@pytest.fixture
def jax_reads_with_its_own_lib(jax_shim, monkeypatch):
    """The JAX RegionView reads through the libvtpucore.so built above."""
    monkeypatch.setenv("VTPU_CORE_LIB",
                       os.path.join(jax_shim, "libvtpucore.so"))
    monkeypatch.setattr(jax_region, "_lib", None)
    monkeypatch.setattr(jax_region, "_abi_checked", False)


def setup(tmp_path, shared=True, small=FIX):
    """(root, lock dir, fixtures, the mock card's reader); with ``shared``
    this test process on the card already, listed as the same pid as every
    process (NVML cannot tell them apart: context mode)"""
    root = str(tmp_path)
    procs = os.path.join(root, "procs")
    locks = os.path.join(root, "locks")
    os.makedirs(procs, exist_ok=True)
    os.makedirs(locks, exist_ok=True)
    if shared:
        with open(os.path.join(procs, str(os.getpid())), "w") as f:
            f.write(f"{os.getpid()} 0\n")
    return (root, locks, codemem.mock_fixtures(root, small),
            codemem.mock_card_used(procs))


def pod(tmp_path, shared=True, small=FIX, **kw):
    """the probe's child on the mock card, its context made: (child, its
    first line, the card's reader)"""
    root, locks, fixtures, card = setup(tmp_path, shared, small)
    child = codemem.Child(root, "pod", "mock", fixtures, locks, **kw)
    return child, child.read(), card


def used(cache):
    with RegionView(cache) as view:
        return view.used(0)


def clean(cache):
    with RegionView(cache) as view:
        return view.procs() == [] and view.used(0) == 0


@pytest.mark.parametrize("via", ["cuGetProcAddress", "symbol"])
@pytest.mark.parametrize("route", codemem.ROUTES)
def test_each_route_is_charged_the_mock_cards_bytes(tmp_path, libs, route,
                                                     via):
    """Each of the nine routes (a load, the look-ups, one launch) is
    charged exactly what the mock card took at each stage, and its unload
    gives all of it back; every entry point is the interposer's hook,
    reached through cuGetProcAddress or by its symbol on libcuda's
    handle."""
    child, ready, card = pod(tmp_path, direct=via == "symbol")
    try:
        opened = child.ask("open", route=route)
        held, on_card = used(child.cache), card()
        closed = child.ask("close")
        after = used(child.cache)
        counters = child.ask("counters")
        rc = child.finish()
    finally:
        child.kill()
    assert all(ready["hooked"].values()), ready["hooked"]
    assert ready["footprint"][0] == 3 and ready["footprint"][2] == CTX
    assert opened["rc"] == 0 and opened["charged"] == WANT[route]
    total = sum(WANT[route].values())
    assert held == on_card == CTX + total
    assert closed == {"rc": 0, "released": total}
    assert after == CTX
    assert (counters["loads"], counters["unloads"], counters["released"],
            counters["refused"]) == (1, 1, total, 0)
    assert (counters["recorded"], counters["dropped"],
            counters["unattributed"]) == (0, 0, 0)
    assert rc == 0 and clean(child.cache)


def test_a_thousand_cycles_leave_the_charge_where_it_began(tmp_path, libs):
    """1,000 load, look-up, launch and unload cycles, each load given the
    handle the last unload freed: the charge ends exactly where it began,
    and every cycle's look-up and first launch was measured (each unload
    forgot its module's keys; kept, the cycles' first launches ran
    unmeasured and the function loads they made uncharged)."""
    child, ready, _ = pod(tmp_path, small=4 * MiB,
                          env={"MOCK_CUDA_REUSE_HANDLES": "1"})
    try:
        before = child.ask("counters")
        churn = child.ask("churn", route="cuModuleLoadData", cycles=1000)
        after = child.ask("counters")
        region = used(child.cache)
        with RegionView(child.cache) as view:
            unmeasured = view.footprint_unmeasured
        rc = child.finish()
    finally:
        child.kill()
    assert churn["before"] == churn["after"] == CTX == region

    def grew(key):
        return after[key] - before[key]
    assert grew("calls_measured") == 3000  # load, look-up, first launch
    assert grew("load_bytes") == 1000 * FUNC  # each first launch's load
    assert grew("call_bytes") == 1000 * 4 * MiB
    assert grew("unloads") == 1000
    assert grew("released") == 1000 * (4 * MiB + FUNC)
    assert after["recorded"] == 0 and after["dropped"] == 0
    assert unmeasured == 1  # context mode, said once
    assert rc == 0 and clean(child.cache)


def test_a_reload_at_a_reused_handle_is_measured_again(tmp_path, libs):
    """A module unloaded and loaded again at the same handle: its function
    (at the same handle too) is looked up and launched for the first time
    again, and charged the mock's bytes again."""
    child, _, _ = pod(tmp_path, env={"MOCK_CUDA_REUSE_HANDLES": "1"})
    try:
        first = child.ask("open", route="cuModuleLoadData")
        child.ask("close")
        second = child.ask("open", route="cuModuleLoadData")
        closed = child.ask("close")
        child.finish()
    finally:
        child.kill()
    assert second["handle"] == first["handle"]
    assert first["charged"] == second["charged"] == WANT["cuModuleLoadData"]
    assert closed["released"] == FIX + FUNC


def test_lookups_through_one_name_buffer_are_each_measured(tmp_path, libs):
    """Two functions looked up through one buffer whose text changes: each
    look-up is measured (a look-up is keyed by the name's text; keyed by
    its address, the second was taken for the first and not measured)."""
    root, locks, fixtures, _ = setup(tmp_path)
    cache, env = codemem.child_env(root, "names", "mock", locks)
    out = subprocess.run([sys.executable, "-c", CHILD, "names", fixtures],
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.splitlines()[-1]) == {"measured": 2}
    assert clean(cache)


def test_a_tenants_own_cuFuncLoad_is_charged(tmp_path, libs):
    """A function the tenant loads itself before its first launch: the
    load is measured and charged the mock's bytes, and the first launch,
    which finds it loaded, is measured and charged nothing more."""
    child, _, _ = pod(tmp_path)
    try:
        before = child.ask("counters")
        opened = child.ask("open", route="cuFuncLoad")
        after = child.ask("counters")
        closed = child.ask("close")
        child.finish()
    finally:
        child.kill()
    assert opened["charged"] == {"load": FIX, "lookup": 0,
                                 "cuFuncLoad": FUNC, "launch": 0}
    # the load, the look-up, cuFuncLoad and the first launch
    assert after["calls_measured"] - before["calls_measured"] == 4
    assert after["load_bytes"] == before["load_bytes"]  # none at the launch
    assert closed["released"] == FIX + FUNC


def test_pid_mode_charges_nvmls_figure_once(tmp_path, libs):
    """Where NVML lists the process under its own pid, the 100 ms re-read
    follows a load and an unload: the charge is NVML's figure, the hooks
    measure and charge nothing themselves (no double charge)."""
    child, ready, _ = pod(tmp_path, shared=False,
                          env={"MOCK_GPU_PROCS_SHARED": None})

    def reread():
        """the footprint two re-reads on"""
        reads = child.ask("footprint")["footprint"][3]
        while True:
            fp = child.ask("footprint")["footprint"]
            if fp[3] >= reads + 2:
                return fp

    try:
        assert ready["footprint"][0] == 2  # NVML's pid
        child.ask("open", route="cuLibraryLoadData")
        loaded = reread()
        held = used(child.cache)
        child.ask("close")
        unloaded = reread()
        counters = child.ask("counters")
        rc = child.finish()
    finally:
        child.kill()
    total = FIX + MODULE + FUNC
    assert loaded[2] == held == CTX + total
    assert unloaded[2] == CTX
    assert (counters["loads"], counters["unloads"], counters["recorded"],
            counters["calls_measured"]) == (0, 0, 0, 0)
    assert rc == 0 and clean(child.cache)


def test_a_load_past_the_quota_is_refused(tmp_path, libs):
    """A 3 GiB module at the 2 GiB quota: refused with
    CUDA_ERROR_OUT_OF_MEMORY and undone (the mock card back where it was),
    the charge unmoved; a later small load is served."""
    child, _, card = pod(tmp_path)
    try:
        charged, on_card = used(child.cache), card()
        refused = child.ask("open", route="cuModuleLoadData", big=True)
        after, card_after = used(child.cache), card()
        later = child.ask("open", route="cuModuleLoadData")
        child.ask("close")
        counters = child.ask("counters")
        with RegionView(child.cache) as view:
            oom_events = view.snapshot().oom_events
        rc = child.finish()
    finally:
        child.kill()
    assert refused["rc"] == codemem.CUDA_ERROR_OUT_OF_MEMORY
    assert (after, card_after) == (charged, on_card) == (CTX, CTX)
    assert later["rc"] == 0 and later["charged"] == WANT["cuModuleLoadData"]
    assert counters["refused"] == 1 and oom_events == 1
    assert rc == 0 and clean(child.cache)


def test_a_lookup_past_the_quota_is_charged_and_the_launch_refused(
        tmp_path, libs):
    """A deliberate difference from the JAX shim, which refuses a program
    at its compile: a library's module that lands at its first look-up
    (lazy loading; every library route on the H100) cannot be undone by the
    interposer. The look-up is served and its 3 GiB charged, the next
    launch is refused with CUDA_ERROR_OUT_OF_MEMORY, and the unload gives
    the charge back."""
    child, _, card = pod(tmp_path, small=4 * MiB,
                         env={"MOCK_CUDA_MODULE_BYTES": "3g"})
    try:
        with pytest.raises(RuntimeError, match="cuLaunchKernel returned 2"):
            child.ask("open", route="cuLibraryLoadData")
        counters = child.ask("counters")
        after, on_card = used(child.cache), card()
        rc = child.finish()
    finally:
        child.kill()
    # the look-up's growth was charged, and released at the unload the
    # failed open made
    assert counters["released"] == 4 * MiB + (3 << 30)
    assert counters["refused"] == 0 and counters["unloads"] == 1
    assert after == on_card == CTX
    assert rc == 0 and clean(child.cache)


def test_a_load_past_the_quota_kills_as_the_jax_shims_program_does(
        tmp_path, libs, jax_shim, jax_reads_with_its_own_lib):
    """Under ACTIVE_OOM_KILLER, on the same quota (1 KiB) and bytes (a 64
    KiB program, a 64 KiB module): `shim_test burn` dies by SIGKILL at its
    compile, and the port's pod at its load; the JAX RegionView reads the
    same outcome from both regions (one refusal, nothing charged)."""
    jax_cache = str(tmp_path / "jax.cache")
    env = dict(os.environ,
               MOCK_PJRT_SO=os.path.join(jax_shim, "mock_pjrt.so"),
               LIBVTPU_SO=os.path.join(jax_shim, "libvtpu.so"),
               VTPU_REAL_LIBTPU_PATH=os.path.join(jax_shim, "mock_pjrt.so"),
               TPU_DEVICE_MEMORY_LIMIT="1k",
               TPU_DEVICE_MEMORY_SHARED_CACHE=jax_cache,
               MOCK_PJRT_EXEC_BYTES="65536", ACTIVE_OOM_KILLER="1",
               LIBVTPU_LOG_LEVEL="0")
    jax = subprocess.run([os.path.join(jax_shim, "shim_test"), "burn",
                          "2000"], env=env, capture_output=True, text=True,
                         timeout=60, cwd=jax_shim)
    child, _, _ = pod(tmp_path / "port", small=64 << 10, killer=True,
                      env={api.ENV_DEVICE_MEMORY_LIMIT: "1k",
                           "MOCK_CUDA_CTX_BYTES": "0",
                           api.ENV_LOG_LEVEL: "0"})
    try:
        child.send("open", route="cuModuleLoadData")
        rc = child.finish()
    finally:
        child.kill()
    outcomes = []
    for cache in (jax_cache, child.cache):
        with JaxRegionView(cache) as view:
            outcomes.append((view.snapshot().oom_events, view.used(0)))
    assert jax.returncode == rc == -signal.SIGKILL, (jax.returncode, rc)
    assert outcomes[0] == outcomes[1] == (1, 0), outcomes


def test_the_quota_view_recovers_after_unloads_as_after_jax_destroys(
        tmp_path, libs, jax_shim, jax_reads_with_its_own_lib):
    """`shim_test scratchleak` fills the JAX shim's table of programs, and
    its quota view recovers after its destroys. The port's table of
    modules filled (16,384 loads of 4 KiB): a load past it runs uncharged
    and is counted as unmeasured, its unload releases nothing and
    underflows nothing, a slot freed records the next load again, and after
    the unloads the quota view (cuMemGetInfo) and the region (read by the
    JAX RegionView) are back to the context alone."""
    env = dict(os.environ,
               MOCK_PJRT_SO=os.path.join(jax_shim, "mock_pjrt.so"),
               LIBVTPU_SO=os.path.join(jax_shim, "libvtpu.so"))
    jax = subprocess.run([os.path.join(jax_shim, "shim_test"),
                          "scratchleak"], env=env, capture_output=True,
                         text=True, timeout=120, cwd=jax_shim)
    assert jax.returncode == 0, jax.stdout + jax.stderr
    assert "shim_test scratchleak OK" in jax.stdout
    root, locks, fixtures, _ = setup(tmp_path, small=4096)
    cache, env = codemem.child_env(root, "table", "mock", locks,
                                   env={"MOCK_CUDA_LOAD_BYTES": "4096"})
    out = subprocess.run([sys.executable, "-c", CHILD, "table", fixtures,
                          str(CODE_MAX)], env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.splitlines()[-1])
    table = CODE_MAX * 4096
    counters, charge, free = got["full"]
    assert (counters["recorded"], counters["recorded_bytes"]) == (
        CODE_MAX, table)
    assert charge == CTX + table and free == got["free0"] - table
    counters, charge, free = got["past"]
    assert counters["dropped"] == 1 and charge == CTX + table
    assert got["unloaded_past"] == [CTX + table, free]
    counters, charge, _ = got["room_again"]
    assert counters["recorded"] == CODE_MAX and charge == CTX + table
    counters, charge, free = got["end"]
    assert (counters["recorded"], charge, free) == (0, CTX, got["free0"])
    with JaxRegionView(cache) as view:
        assert view.used(0) == 0 and view.procs() == []
    with RegionView(cache) as view:
        assert view.footprint_unmeasured == 2  # context mode, the drop
