"""The port's workload-side enforcement (vtpu_torch/enforce) against the JAX
package's (vtpu/enforce): the env contract under each side's names, and the
shared-region ABI that the node monitor reads."""

import ctypes
import dataclasses
import os

import pytest

import vtpu.enforce.region as jax_region
from vtpu import api as tpu_api
from vtpu.enforce.workload import parse_bytes as jax_parse_bytes
from vtpu.enforce.workload import quota_from_env as jax_quota_from_env
from vtpu_torch import api, native
from vtpu_torch.enforce import region
from vtpu_torch.enforce.workload import install, parse_bytes, quota_from_env

# the env contract: TPU name (JAX package) -> CUDA name (port)
NAMES = {
    tpu_api.ENV_DEVICE_MEMORY_LIMIT: api.ENV_DEVICE_MEMORY_LIMIT,
    tpu_api.ENV_TENSORCORE_LIMIT: api.ENV_SM_LIMIT,
    tpu_api.ENV_HOST_MEMORY_LIMIT: api.ENV_HOST_MEMORY_LIMIT,
    tpu_api.ENV_SHARED_CACHE: api.ENV_SHARED_CACHE,
    tpu_api.ENV_TASK_PRIORITY: api.ENV_TASK_PRIORITY,
    tpu_api.ENV_CORE_UTILIZATION_POLICY: api.ENV_CORE_UTILIZATION_POLICY,
    tpu_api.ENV_DISABLE_CONTROL: api.ENV_DISABLE_CONTROL,
    tpu_api.ENV_VISIBLE_DEVICES: api.ENV_VISIBLE_DEVICES,
}

QUOTA_MAPS = {
    "empty": {},
    "bare": {tpu_api.ENV_DEVICE_MEMORY_LIMIT: "3g",
             tpu_api.ENV_SHARED_CACHE: "/c/x.cache"},
    # per-index limits with a gap at 1, filled from the bare default
    "gaps": {tpu_api.ENV_DEVICE_MEMORY_LIMIT: "1g",
             f"{tpu_api.ENV_DEVICE_MEMORY_LIMIT}_0": "512m",
             f"{tpu_api.ENV_DEVICE_MEMORY_LIMIT}_2": "256m",
             tpu_api.ENV_TENSORCORE_LIMIT: "40",
             tpu_api.ENV_SHARED_CACHE: "/c/x.cache",
             tpu_api.ENV_TASK_PRIORITY: "0"},
    "index_only": {f"{tpu_api.ENV_DEVICE_MEMORY_LIMIT}_1": "2k"},
    "policy_host": {tpu_api.ENV_DEVICE_MEMORY_LIMIT: "1.5g",
                    tpu_api.ENV_CORE_UTILIZATION_POLICY: "force",
                    tpu_api.ENV_HOST_MEMORY_LIMIT: "8g",
                    tpu_api.ENV_SHARED_CACHE: "/c/x.cache"},
    "disabled": {tpu_api.ENV_DEVICE_MEMORY_LIMIT: "1g",
                 tpu_api.ENV_SHARED_CACHE: "/c/x.cache",
                 tpu_api.ENV_DISABLE_CONTROL: "1",
                 tpu_api.ENV_CORE_UTILIZATION_POLICY: "disable"},
}


def to_cuda_names(env):
    out = {}
    for key, value in env.items():
        base, _, index = key.rpartition("_")
        if index.isdigit() and base in NAMES:
            out[f"{NAMES[base]}_{index}"] = value
        else:
            out[NAMES[key]] = value
    return out


@pytest.mark.parametrize("case", sorted(QUOTA_MAPS))
def test_quota_from_env_matches_reference(case):
    env = QUOTA_MAPS[case]
    ref = jax_quota_from_env(env)
    got = quota_from_env(to_cuda_names(env))
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert got.enforced == ref.enforced


@pytest.mark.parametrize("s", ["1024", "2k", "3m", "1.5g", "", "junk",
                               " 7G ", "0.5K"])
def test_parse_bytes_matches_reference(s):
    assert parse_bytes(s) == jax_parse_bytes(s)


def test_struct_layout_matches_reference():
    assert ctypes.sizeof(region.SharedRegionStruct) == \
        ctypes.sizeof(jax_region.SharedRegionStruct)
    for ours, ref in ((region.SharedRegionStruct,
                       jax_region.SharedRegionStruct),
                      (region.ProcSlot, jax_region.ProcSlot)):
        assert [f[0] for f in ours._fields_] == [f[0] for f in ref._fields_]
        for name, _ in ours._fields_:
            a, b = getattr(ours, name), getattr(ref, name)
            assert (a.offset, a.size) == (b.offset, b.size), name
    lib = region.load_core_library()
    assert lib.vtpu_region_sizeof() == ctypes.sizeof(
        region.SharedRegionStruct)


@pytest.fixture
def jax_reads_port_lib(monkeypatch):
    """Point the JAX package's ctypes mirror at the port's libvgpucore.so:
    its ABI check (region.py:540-567) then holds the copied C layout to its
    own sizeof, without the JAX package's own native build."""
    path = native.core_library()
    monkeypatch.setenv("VTPU_CORE_LIB", path)
    monkeypatch.setattr(jax_region, "_lib", None)
    monkeypatch.setattr(jax_region, "_abi_checked", False)
    return path


def _cache(tmp_path):
    path = tmp_path / "containers" / "pod-uid_0" / "vgpu.cache"
    path.parent.mkdir(parents=True)
    return str(path)


def test_port_region_is_read_by_reference_monitor(tmp_path,
                                                  jax_reads_port_lib):
    cache = _cache(tmp_path)
    with region.SharedRegion(cache) as r:
        r.configure([3 << 30, 5 << 30], [0, 50], priority=0,
                    util_policy=region.UTIL_POLICY_FORCE,
                    dev_uuids=["GPU-a", "GPU-b"])
        r.configure_host(1 << 30)
        r.attach()
        assert r.try_alloc(123 << 20, dev=1)
        assert not r.try_alloc(6 << 30, dev=1)
        assert r.host_try_alloc(4096)
        with jax_region.RegionView(cache) as view:
            assert view.num_devices == 2
            assert view.priority == 0
            assert [view.hbm_limit(0), view.hbm_limit(1)] == [3 << 30,
                                                              5 << 30]
            assert view.core_limit(1) == 50
            assert view.util_policy == region.UTIL_POLICY_FORCE
            assert view.dev_uuids() == ["GPU-a", "GPU-b"]
            assert view.used(1) == 123 << 20 and view.used(0) == 0
            assert view.oom_events == 1
            assert [p.pid for p in view.procs()] == [os.getpid()]
            assert view.host_limit() == 1 << 30
            assert view.host_used() == 4096
            snap = view.snapshot()  # header checksum verified
            assert snap.used(1) == 123 << 20
            assert snap.header_heartbeat_age_s() < 60
        r.free(123 << 20, dev=1)
        r.detach()
        with jax_region.RegionView(cache) as view:
            assert view.procs() == [] and view.used(1) == 0


def test_reference_region_is_read_by_port_view(tmp_path,
                                               jax_reads_port_lib):
    cache = _cache(tmp_path)
    lib = jax_region.load_core_library(jax_reads_port_lib)
    with jax_region.SharedRegion(cache, lib=lib) as r:
        r.configure([1 << 30], [0], dev_uuids=["GPU-z"])
        r.attach(pid=4242)
        assert r.try_alloc(77, pid=4242)
        with region.RegionView(cache) as view:
            assert view.num_devices == 1
            assert view.hbm_limit(0) == 1 << 30
            assert view.used(0) == 77
            assert [(p.pid, p.hbm_used) for p in view.procs()] == [
                (4242, [77])]
            snap = view.snapshot()
            assert snap.dev_uuids() == ["GPU-z"]
            assert snap.used(0) == 77
        r.detach(pid=4242)


def test_port_view_rejects_foreign_and_corrupt_files(tmp_path):
    size = ctypes.sizeof(region.SharedRegionStruct)
    short = tmp_path / "short.cache"
    short.write_bytes(b"\0" * 16)
    with pytest.raises(region.RegionCorruptError):
        region.RegionView(str(short))
    blank = tmp_path / "blank.cache"
    blank.write_bytes(b"\0" * size)
    with pytest.raises(ValueError, match="not initialized"):
        region.RegionView(str(blank))
    cache = _cache(tmp_path)
    with region.SharedRegion(cache) as r:
        r.configure([1 << 20], [0])
        r.raw.hbm_limit[0] = 1 << 40  # a write that bypasses the checksum
    with pytest.raises(region.RegionCorruptError, match="checksum"):
        region.RegionView(cache)


def test_install_without_env_is_passthrough():
    enf = install(env={})
    assert enf.region is None and not enf.interposed
    assert enf.used() == 0 and enf.headroom() > 2 ** 62
    assert enf.host_charge(1 << 40)
    enf.stop()


def test_install_attaches_heartbeats_and_charges_host(tmp_path):
    cache = _cache(tmp_path)
    env = {api.ENV_DEVICE_MEMORY_LIMIT: "1m",
           api.ENV_HOST_MEMORY_LIMIT: "64k",
           api.ENV_SHARED_CACHE: cache,
           api.ENV_VISIBLE_DEVICES: "GPU-1"}
    enf = install(env=env)
    try:
        # no interposer in this process: install says so and attaches
        assert not enf.interposed
        assert enf.limit() == 1 << 20 and enf.limit(3) == 0
        assert enf.region.try_alloc(4096)
        assert enf.used() == 4096
        assert enf.headroom() == (1 << 20) - 4096
        assert enf.host_charge(60 << 10)
        assert not enf.host_charge(8 << 10)
        assert enf.host_used() == 60 << 10
        enf.host_release(60 << 10)
        assert enf.host_used() == 0 and enf.host_limit() == 64 << 10
        with region.RegionView(cache) as view:
            assert [p.pid for p in view.procs()] == [os.getpid()]
            assert view.snapshot().dev_uuids() == ["GPU-1"]
    finally:
        enf.stop()
    with region.RegionView(cache) as view:
        assert view.procs() == []
