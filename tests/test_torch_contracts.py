"""The port's contract registry (vtpu_torch/contracts.py) against the port
it declares and the JAX registry it mirrors, and the VTPU006 mirror
(vtpu_torch/enforce/region.py) against regions libvgpu.so wrote.

1. The registry states the port: every annotation key, env knob and
   durable file is the vtpu_torch.api name it declares, every env name
   vtpu_torch.api or libvgpu.so's C sources read is a knob, every
   confinement site is a module of the port, and the fenced protocols are
   the JAX registry's, edge for edge.
2. Each constant the mirror gained for VTPU006 is read from a region: a
   ctypes child under libvgpu.so on the mock libcuda.so.1 makes the calls
   each callsite class and pressure kind counts, and the region shows
   them at the mirror's index; the header digest is recomputed with the
   mirror's FNV-1a parameters; prof_bucket_index() bins as the C library
   does; the sampling default is the region's stride.
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys
import textwrap

import pytest

from vtpu import contracts as jax_contracts
from vtpu.version import __version__ as jax_version
from vtpu_torch import api, contracts, native
from vtpu_torch.enforce import region as R
from vtpu_torch.version import __version__

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "vtpu_torch")
MiB = 1 << 20


# ---------------------------------------------------------------------------
# 1. the registry states the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("anno", contracts.ANNOTATIONS,
                         ids=[a.const for a in contracts.ANNOTATIONS])
def test_annotation_is_the_api_name(anno):
    assert getattr(api, anno.const) == anno.key
    assert anno.layer in ("scheduler", "plugin", "monitor", "user")
    for pkg, base in anno.writers:
        if pkg != "*" and base != "*":
            assert os.path.isfile(os.path.join(PORT, pkg, base)), (pkg, base)


def test_every_api_annotation_is_registered():
    annos = {k for k, v in vars(api).items()
             if k.endswith("_ANNO") and isinstance(v, str)}
    assert annos == set(contracts.ANNOTATION_BY_CONST)


def test_every_api_env_name_is_a_knob_and_back():
    env = {v for k, v in vars(api).items()
           if k.startswith("ENV_") and isinstance(v, str)}
    assert env == set(contracts.ENV_KNOB_BY_NAME)
    assert len(contracts.ENV_KNOBS) == len(contracts.ENV_KNOB_BY_NAME)


def test_the_c_sources_read_registered_knobs():
    """libvgpu.so's load_config and the profile plane read only knobs
    (the per-card forms are the knob's ``_%d``)."""
    names = set()
    for fname in ("libvgpu.c", "shared_region.c", "validator.c"):
        with open(os.path.join(PORT, "csrc", fname)) as f:
            names |= set(re.findall(r'getenv\("([A-Z_0-9]+)"\)', f.read()))
    assert {"CUDA_DEVICE_MEMORY_LIMIT", "CUDA_DEVICE_SM_LIMIT",
            "VTPU_PROFILE"} <= names
    assert names <= set(contracts.ENV_KNOB_BY_NAME), \
        names - set(contracts.ENV_KNOB_BY_NAME)


@pytest.mark.parametrize("const", [
    "QUARANTINE_MARKER", "RESIZE_RECORD", "HOSTGUARD_RECORD",
    "DRAIN_REQUEST_FILE", "DRAIN_ACK_FILE"])
def test_durable_file_is_the_api_name(const):
    assert getattr(api, const) in contracts.DURABLE_FILE_BY_NAME


def test_the_checkpoint_is_a_durable_file():
    from vtpu_torch.plugin.checkpoint import CHECKPOINT_FILENAME

    assert CHECKPOINT_FILENAME in contracts.DURABLE_FILE_BY_NAME
    assert len(contracts.DURABLE_FILES) == len(jax_contracts.DURABLE_FILES)


@pytest.mark.parametrize("rule", contracts.GUARD_RULES + contracts.STORE_RULES,
                         ids=lambda r: r.rule)
def test_confinement_sites_are_port_modules(rule):
    for pkg, base in rule.confined_to:
        if pkg == "*" or base == "*":
            assert pkg == "*" or os.path.isdir(os.path.join(PORT, pkg))
        else:
            assert os.path.isfile(os.path.join(PORT, pkg, base)), (pkg, base)


def test_guard_rules_are_the_jax_rules_at_the_port_sites():
    """Rule for rule, the same selectors and lock conventions; the sites
    are the JAX ones but the entry point (cmd/ -> scheduler/__main__.py)."""
    assert len(contracts.GUARD_RULES) == len(jax_contracts.GUARD_RULES)
    assert len(contracts.STORE_RULES) == len(jax_contracts.STORE_RULES)
    fields = ("rule", "methods", "suffix", "bare_name", "receiver_self_attrs",
              "receiver_attr", "receiver_names", "receiver_contains",
              "requires_kwarg", "guarded_by", "guard_suffix", "forbid_guard")
    for port, jax in zip(contracts.GUARD_RULES, jax_contracts.GUARD_RULES):
        assert [getattr(port, f) for f in fields] == \
            [getattr(jax, f) for f in fields]
        jax_sites = {s for s in jax.confined_to if s[0] != "cmd"
                     and s != ("scheduler", "scheduler.py")}
        assert jax_sites <= set(port.confined_to)
    for port, jax in zip(contracts.STORE_RULES, jax_contracts.STORE_RULES):
        assert (port.rule, port.attr_targets, port.subscript_of,
                port.confined_to, port.guarded_by) == \
            (jax.rule, jax.attr_targets, jax.subscript_of, jax.confined_to,
             jax.guarded_by)


@pytest.mark.parametrize("proto", contracts.PROTOCOLS,
                         ids=[p.name for p in contracts.PROTOCOLS])
def test_protocol_is_the_jax_protocol(proto):
    jax = jax_contracts.PROTOCOL_BY_NAME[proto.name]
    assert proto.states == jax.states and proto.layers == jax.layers
    assert [e.name for e in proto.edges] == [e.name for e in jax.edges]


def test_edges_per_kind():
    """27 edges: commit 6, resize 6, evict 4, migrate 6, group-lease 5;
    7 waived (2 whose JAX kill point is slow, 5 that write the JAX
    region's file names)."""
    assert {p.name: len(p.edges) for p in contracts.PROTOCOLS} == {
        "commit": 6, "resize": 6, "evict": 4, "migrate": 6,
        "group-lease": 5}
    waived = [e for p in contracts.PROTOCOLS for e in p.edges if e.waiver]
    assert len(waived) == 7


def test_covers_edge_is_transparent():
    @contracts.covers_edge("commit:kill-mid-gang")
    def probe():
        return 42
    assert probe() == 42
    assert probe._vgpu_kill_edges == ("commit:kill-mid-gang",)


def test_wire_literals_are_the_api_strings():
    assert {api.RESOURCE_GPU, api.RESOURCE_MEM, api.NVIDIA_DOMAIN,
            api.DOMAIN} <= contracts.WIRE_LITERALS
    assert all(isinstance(v, str) for v in contracts.WIRE_LITERALS)


def test_version_is_the_jax_version():
    assert __version__ == jax_version


# ---------------------------------------------------------------------------
# 2. the VTPU006 mirror against regions libvgpu.so wrote
# ---------------------------------------------------------------------------

CHILD = textwrap.dedent(r"""
    import ctypes, os, sys
    from ctypes import (CFUNCTYPE, POINTER, byref, c_char_p, c_int,
                        c_size_t, c_uint, c_uint64, c_ulonglong, c_void_p)

    cu = ctypes.CDLL("libcuda.so.1")
    GPA2 = CFUNCTYPE(c_int, c_char_p, POINTER(c_void_p), c_int, c_uint64,
                     POINTER(c_int))
    gpa2 = GPA2(ctypes.cast(cu.cuGetProcAddress_v2, c_void_p).value)

    def via2(base):
        p, st = c_void_p(), c_int(-1)
        assert gpa2(base.encode(), byref(p), 12080, 0, byref(st)) == 0
        return p.value

    alloc = CFUNCTYPE(c_int, POINTER(c_ulonglong), c_size_t)(
        via2("cuMemAlloc"))
    free = CFUNCTYPE(c_int, c_ulonglong)(via2("cuMemFree"))
    host_alloc = CFUNCTYPE(c_int, POINTER(c_void_p), c_size_t, c_uint)(
        via2("cuMemHostAlloc"))
    launch = CFUNCTYPE(c_int, c_void_p, c_uint, c_uint, c_uint, c_uint,
                       c_uint, c_uint, c_uint, c_void_p, c_void_p,
                       c_void_p)(via2("cuLaunchKernel"))
    sync = CFUNCTYPE(c_int, c_void_p)(via2("cuStreamSynchronize"))
    MiB = 1 << 20
    p, h = c_ulonglong(), c_void_p()
    if sys.argv[1] == "pressure":
        # 40 MiB of a 44 MiB quota, then 8 MiB more: refused at >= 7/8
        for _ in range(5):
            assert alloc(byref(p), 8 * MiB) == 0
        assert alloc(byref(p), 8 * MiB) == 2
        # 60 MiB pinned of a 64 MiB host quota, then 8 more: refused
        assert host_alloc(byref(h), 60 * MiB, 0) == 0
        assert host_alloc(byref(h), 8 * MiB, 0) == 2
        # 1 ms kernels at a 10% SM limit: the launches wait their turn
        for _ in range(40):
            assert launch(None, 1, 1, 1, 1, 1, 1, 0, None, None, None) == 0
            assert sync(None) == 0
    elif sys.argv[1] == "retry":
        # the slot is taken away between two allocations (the parent
        # detaches it): the second charge attaches again and retries
        assert alloc(byref(p), MiB) == 0
        print("ready", flush=True)
        sys.stdin.readline()
        assert alloc(byref(p), MiB) == 0
    elif sys.argv[1] == "table":
        # the allocation table filled to its 65,536 entries: one more
        # allocation is refused and counted as a table drop
        for _ in range(1 << 16):
            assert alloc(byref(p), 4096) == 0
        assert alloc(byref(p), 4096) == 2
    ctypes.CDLL(os.environ["LD_PRELOAD"]).vgpu_flush_launches()
""")


def _env(tmp_path, **extra):
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
    })
    env.update({k: str(v) for k, v in extra.items()})
    return env, str(cache)


def _struct(cache: str) -> R.SharedRegionStruct:
    with open(cache, "rb") as f:
        return R.SharedRegionStruct.from_buffer_copy(
            f.read(ctypes.sizeof(R.SharedRegionStruct)))


def _run(env, mode):
    proc = subprocess.run([sys.executable, "-c", CHILD, mode], env=env,
                          capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr


@pytest.fixture(scope="module")
def regions(tmp_path_factory):
    """The regions of the three children, by mode, and the first one's
    host-ledger overage forced through libvgpucore.so."""
    native.build_all()
    out = {}
    root = tmp_path_factory.mktemp("regions")
    limits = {api.ENV_DEVICE_MEMORY_LIMIT: "44m",
              api.ENV_HOST_MEMORY_LIMIT: 64 * MiB, api.ENV_SM_LIMIT: 10,
              "MOCK_CUDA_KERNEL_NS": 1_000_000}
    env, cache = _env(root / "pressure", **limits)
    _run(env, "pressure")
    # a force charge over the host limit (the cooperative offloader's
    # path; libvgpu.so never force-charges the host ledger)
    lib = R.load_core_library()
    lib.vtpu_host_force_alloc.restype = None
    lib.vtpu_host_force_alloc.argtypes = [ctypes.c_void_p, ctypes.c_int32,
                                          ctypes.c_uint64]
    reg = R.SharedRegion(cache)
    try:
        reg.attach()
        lib.vtpu_host_force_alloc(reg._ptr, os.getpid(), 128 * MiB)
        reg.host_free(128 * MiB)
        reg.detach()
    finally:
        reg.close()
    out["pressure"] = cache
    env, cache = _env(root / "retry")
    proc = subprocess.Popen([sys.executable, "-c", CHILD, "retry"], env=env,
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        assert proc.stdout.readline().strip() == "ready", proc.stderr.read()
        reg = R.SharedRegion(cache)
        try:
            assert reg.detach(proc.pid) == 0
        finally:
            reg.close()
        _, err = proc.communicate("\n", timeout=60)
        assert proc.returncode == 0, err
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    out["retry"] = cache
    env, cache = _env(root / "table", **{api.ENV_DEVICE_MEMORY_LIMIT: "1g"})
    _run(env, "table")
    out["table"] = cache
    # every call timed (the callsite counts below), and the default stride
    env, cache = _env(root / "sampled", **limits,
                      **{api.ENV_PROFILE_SAMPLE: 1})
    _run(env, "pressure")
    out["sampled"] = cache
    return out


#: each pressure kind, the child whose region counts it
PRESSURE = {
    "VTPU_PROF_PK_CHARGE_RETRIES": "retry",
    "VTPU_PROF_PK_CONTENTION_SPINS": "pressure",
    "VTPU_PROF_PK_AT_LIMIT_NS": "pressure",
    "VTPU_PROF_PK_NEAR_LIMIT_FAILURES": "pressure",
    "VTPU_PROF_PK_TABLE_DROPS": "table",
    "VTPU_PROF_PK_HOST_NEAR_LIMIT_FAILURES": "pressure",
    "VTPU_PROF_PK_HOST_OVER_EVENTS": "pressure",
}


@pytest.mark.parametrize("const", sorted(PRESSURE))
def test_pressure_kind_is_counted_at_its_index(regions, const):
    """The kind's counter moves at the mirror's index, and it is the
    label the monitor exports there."""
    idx = getattr(R, const)
    got = list(_struct(regions[PRESSURE[const]]).prof_pressure)
    assert got[idx] > 0, (const, got)
    assert R.PROF_PRESSURE_NAMES[idx] == \
        const[len("VTPU_PROF_PK_"):].lower()
    # the child moved no kind of another child only
    others = [k for k, m in PRESSURE.items() if m != PRESSURE[const]]
    assert all(got[getattr(R, k)] == 0 for k in others
               if k not in ("VTPU_PROF_PK_CHARGE_RETRIES",)), got


#: each callsite class and its calls in the "pressure" child: 6 device
#: allocations (one refused) and their 5 charges, 2 host allocations (one
#: refused), no free, 40 launches (each a quota check, each span charged)
CALLS = {
    "VTPU_PROF_CS_BUF_ALLOC": 6, "VTPU_PROF_CS_BUF_FREE": 0,
    "VTPU_PROF_CS_EXECUTE": 40, "VTPU_PROF_CS_TRANSFER": 0,
    "VTPU_PROF_CS_QUOTA_CHECK": 40,
}


@pytest.mark.parametrize("const", sorted(CALLS))
def test_callsite_is_counted_at_its_index(regions, const):
    s = _struct(regions["sampled"])
    idx = getattr(R, const)
    assert s.prof_cs[idx].calls == CALLS[const], const
    assert s.prof_cs[idx].sampled == s.prof_cs[idx].calls
    assert R.PROF_CALLSITE_NAMES[idx] == const[len("VTPU_PROF_CS_"):].lower()


def test_charge_callsites_count_each_charge(regions):
    """CHARGE counts every charge (device and host, the refused ones as
    errors), UNCHARGE none here, DONE_WITH_BUFFER each charged bracket."""
    cs = _struct(regions["sampled"]).prof_cs
    charge, uncharge = cs[R.VTPU_PROF_CS_CHARGE], cs[R.VTPU_PROF_CS_UNCHARGE]
    assert charge.calls == 6 + 2 and charge.errors == 2
    assert uncharge.calls == 0
    assert cs[R.VTPU_PROF_CS_DONE_WITH_BUFFER].calls > 0
    assert R.VTPU_PROF_CALLSITES == len(cs) == len(R.PROF_CALLSITE_NAMES)
    assert R.VTPU_PROF_PRESSURE_KINDS == len(R.PROF_PRESSURE_NAMES)


def test_sampling_default_is_the_regions_stride(regions):
    assert _struct(regions["pressure"]).prof_sample == \
        R.VTPU_PROF_SAMPLE_DEFAULT
    assert _struct(regions["sampled"]).prof_sample == 1


def _fnv1a_header(s: R.SharedRegionStruct) -> int:
    """The header digest by the mirror's FNV-1a parameters, over the
    fields shared_region.c's vtpu_region_header_checksum reads."""
    mask = (1 << 64) - 1
    h = R.VTPU_HEADER_CSUM_INIT

    def mix(h, data):
        for b in data:
            h = ((h ^ b) * R.VTPU_HEADER_CSUM_PRIME) & mask
        return h

    h = mix(h, R.VTPU_SHARED_MAGIC.to_bytes(4, "little"))
    base = ctypes.addressof(s)
    for name in ("version", "num_devices", "priority", "hbm_limit",
                 "core_limit", "util_policy", "dev_uuid", "host_limit"):
        f = getattr(type(s), name)
        h = mix(h, ctypes.string_at(base + f.offset, f.size))
    return h


@pytest.mark.parametrize("mode", ["pressure", "retry", "table"])
def test_header_digest_by_the_mirrors_parameters(regions, mode):
    s = _struct(regions[mode])
    assert s.header_checksum == _fnv1a_header(s) != 0


def test_bucket_index_bins_as_the_c_library():
    lib = R.load_core_library()
    lib.vtpu_prof_bucket_index.restype = ctypes.c_int
    lib.vtpu_prof_bucket_index.argtypes = [ctypes.c_uint64]
    bounds = R.prof_bucket_bounds()
    for ns in [0, 1, 127, 128, 129, 255, 256, 1000, 4095, 4096, 10 ** 6,
               10 ** 9, 1 << 40, (1 << 64) - 1]:
        b = R.prof_bucket_index(ns)
        assert b == lib.vtpu_prof_bucket_index(ns), ns
        assert ns < bounds[b] and (b == 0 or ns >= bounds[b - 1])


def test_sampled_latencies_land_in_their_buckets(regions):
    """Every timed call of the fully sampled child is in the histogram its
    count says."""
    for cell in _struct(regions["sampled"]).prof_cs:
        assert sum(cell.hist) == cell.sampled
        assert len(cell.hist) == R.VTPU_PROF_BUCKETS
