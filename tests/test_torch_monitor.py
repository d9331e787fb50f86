"""The port's node monitor (vtpu_torch/monitor) held to the JAX package's
(vtpu/monitor), side by side on the same regions.

Regions are written as libvgpu.so writes them: through the port's
SharedRegion and its C library (libvgpucore.so, vtpu_torch/native.py),
launches and measured device time through ``vtpu_note_batch``. Each
monitor reads its own directory: the JAX one ``<entry>/vtpu.cache``, the
port's ``<entry>/vgpu.cache``, hard links of one file where the monitors
only read and byte-identical copies, written alike, where both write the
feedback plane or a limit. Clocks are injected, so float samples compare
exactly.
"""

import ctypes
import json
import os
import shutil
import subprocess
import sys
import textwrap
import threading
import time
import urllib.error
import urllib.request
from types import SimpleNamespace

import pytest

import vtpu.enforce.region as jax_region
from tests import torch_jaxlib
import vtpu.trace as jax_trace
from vtpu.enforce import workload as jax_workload
from vtpu.monitor import daemon as jax_daemon
from vtpu.monitor import feedback as jax_feedback
from vtpu.monitor import hostguard as jax_hostguard
from vtpu.monitor import metrics as jax_metrics
from vtpu.monitor import migrate as jax_migrate
from vtpu.monitor import pathmonitor as jax_path
from vtpu.monitor import resize as jax_resize
from vtpu.plugin.tpulib import ChipInfo as TpuChip
from vtpu.plugin.tpulib import FakeTpuLib
from vtpu.util import codec as jax_codec
from vtpu.util import lockdebug as jax_lockdebug
from vtpu.util import logsetup as jax_logsetup
from vtpu.util import types as jax_types
from vtpu.util.client import FakeKubeClient as JaxClient
from vtpu.util.podcache import PodCache as JaxPodCache

import vtpu_torch.trace as port_trace
from vtpu_torch import api, native
from vtpu_torch.enforce import region as port_region
from vtpu_torch.enforce import workload as port_workload
from vtpu_torch.enforce.region import (FEEDBACK_BLOCK, FEEDBACK_IDLE,
                                       UTIL_POLICY_FORCE, SharedRegion,
                                       SharedRegionStruct)
from vtpu_torch.monitor import daemon as port_daemon
from vtpu_torch.monitor import feedback as port_feedback
from vtpu_torch.monitor import hostguard as port_hostguard
from vtpu_torch.monitor import metrics as port_metrics
from vtpu_torch.monitor import migrate as port_migrate
from vtpu_torch.monitor import pathmonitor as port_path
from vtpu_torch.monitor import resize as port_resize
from vtpu_torch.plugin.nvml import ChipInfo as GpuChip
from vtpu_torch.plugin.nvml import FakeNvmlLib
from vtpu_torch.util import types
from vtpu_torch.util import lockdebug as port_lockdebug
from vtpu_torch.util import logsetup as port_logsetup
from vtpu_torch.util.client import FakeKubeClient
from vtpu_torch.util.podcache import PodCache as PortPodCache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MB = 1 << 20
MS = 1_000_000
CARD_A, CARD_B = "GPU-0a5e1c2d-aaaa", "GPU-0a5e1c2d-bbbb"
SIDES = ("jax", "port")
CACHE = {"jax": "vtpu.cache", "port": api.CACHE_FILENAME}
PATH = {"jax": jax_path, "port": port_path}
FEEDBACK = {"jax": jax_feedback, "port": port_feedback}


@pytest.fixture(scope="module")
def jax_core(tmp_path_factory):
    """The JAX package's libvtpucore.so (tests/torch_jaxlib.py)."""
    native.build_all()
    return torch_jaxlib.core(tmp_path_factory)


@pytest.fixture(autouse=True)
def jax_reads_with_its_own_lib(jax_core, monkeypatch):
    monkeypatch.setenv("VTPU_CORE_LIB", jax_core)
    monkeypatch.setattr(jax_region, "_lib", None)
    monkeypatch.setattr(jax_region, "_abi_checked", False)


def _core():
    """The port's libvgpucore.so with the calls the workload side makes
    through libvgpu.so declared."""
    lib = port_region.load_core_library()
    P = ctypes.POINTER(SharedRegionStruct)
    lib.vtpu_note_batch.restype = None
    lib.vtpu_note_batch.argtypes = [P, ctypes.c_int32, ctypes.c_uint64,
                                    ctypes.c_int32,
                                    ctypes.POINTER(ctypes.c_uint64)]
    lib.vtpu_host_force_alloc.restype = None
    lib.vtpu_host_force_alloc.argtypes = [P, ctypes.c_int32,
                                          ctypes.c_uint64]
    lib.vtpu_prof_configure.restype = None
    lib.vtpu_prof_configure.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.vtpu_prof_flush.restype = ctypes.c_int
    lib.vtpu_prof_flush.argtypes = [P]
    return lib


class Tenant:
    """One container's region in both monitors' directories, written as
    libvgpu.so writes it. ``copies``: a byte-identical copy for the JAX
    monitor, and every write made to both files; else one file, hard
    linked under both names."""

    def __init__(self, root, entry, hbm_limit=MB, core=50, priority=1,
                 uuid=None, policy=0, host_limit=0, used=0, launches=0,
                 copies=False):
        self.entry = entry
        self.paths = {}
        for side in SIDES:
            d = root / side / entry
            d.mkdir(parents=True, exist_ok=True)
            self.paths[side] = str(d / CACHE[side])
        r = SharedRegion(self.paths["port"])
        r.configure([hbm_limit], [core], priority=priority,
                    util_policy=policy, dev_uuids=[uuid] if uuid else None)
        if host_limit:
            r.configure_host(host_limit)
        r.attach()
        if used:
            assert r.try_alloc(used)
        self.regions = [r]
        if launches:
            self.launch(launches)
        if copies:
            shutil.copyfile(self.paths["port"], self.paths["jax"])
            self.regions.append(SharedRegion(self.paths["jax"]))
        else:
            os.link(self.paths["port"], self.paths["jax"])

    def batch(self, launches=0, inflight=0, ns=0):
        debit = (ctypes.c_uint64 * 16)(ns)
        for r in self.regions:
            _core().vtpu_note_batch(r._ptr, os.getpid(), launches, inflight,
                                    debit)

    def launch(self, n=1, ns=0):
        self.batch(launches=n, ns=ns)

    def begin(self):
        """A launch whose work is still running."""
        self.batch(launches=1, inflight=1)

    def end(self, ns):
        self.batch(inflight=-1, ns=ns)

    def each(self, fn):
        for r in self.regions:
            fn(r)

    def raw(self, side):
        return (self.regions[0] if side == "port" or len(self.regions) == 1
                else self.regions[1]).raw

    def close(self):
        for r in self.regions:
            r.close()


def flip(path, offset, mask=0x01):
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes([b[0] ^ mask]))


def monitors(root, **kw):
    return {side: PATH[side].ContainerRegions(str(root / side), **kw)
            for side in SIDES}


def close_all(regions, *tenants):
    for t in tenants:
        t.close()
    for r in regions.values():
        r.close()


def same(results):
    """Both monitors' results, asserted equal; the JAX one returned."""
    assert results["jax"] == results["port"], results
    return results["jax"]


# ---------------------------------------------------------------------------
# scan, quarantine and GC (tests/test_monitor.py:45-65, :115-135, :581-737)
# ---------------------------------------------------------------------------

def test_pod_uid_of_entry_matches():
    for name in ("abc-123_0", "with_under_1", "nounder", "uid_x"):
        assert port_path.pod_uid_of_entry(name) == \
            jax_path.pod_uid_of_entry(name)


def test_scan_discovers_and_drops(tmp_path):
    regions = monitors(tmp_path)
    assert same({s: regions[s].scan() for s in SIDES}) == {}
    t = Tenant(tmp_path, "pod1_0", used=4096)
    views = {s: regions[s].scan() for s in SIDES}
    assert same({s: set(views[s]) for s in SIDES}) == {"pod1_0"}
    assert same({s: views[s]["pod1_0"].used() for s in SIDES}) == 4096
    t.close()
    for side in SIDES:
        os.unlink(t.paths[side])
    assert same({s: regions[s].scan() for s in SIDES}) == {}
    close_all(regions)


@pytest.mark.parametrize("garbage", [b"junk", b"", b"\0" * 64])
def test_scan_skips_garbage_and_quarantines_alike(tmp_path, garbage):
    for side in SIDES:
        (tmp_path / side / "bad_0").mkdir(parents=True)
    (tmp_path / "port" / "bad_0" / CACHE["port"]).write_bytes(garbage)
    os.link(tmp_path / "port" / "bad_0" / CACHE["port"],
            tmp_path / "jax" / "bad_0" / CACHE["jax"])
    regions = monitors(tmp_path, quarantine_after=3)
    for sweep in range(4):
        snaps = {s: regions[s].scan_snapshots()[0].snapshots for s in SIDES}
        assert same({s: set(snaps[s]) for s in SIDES}) == set()
        same({s: (sorted(regions[s].quarantined), regions[s].corrupt_events)
              for s in SIDES})
    assert "bad_0" in regions["port"].quarantined
    markers = {s: json.load(open(tmp_path / s / "bad_0" / (
        "vtpu.quarantine.json" if s == "jax" else api.QUARANTINE_MARKER)))
        for s in SIDES}
    for s in SIDES:
        markers[s]["reason"] = markers[s]["reason"].replace(
            str(tmp_path / s / "bad_0" / CACHE[s]), "<region>")
    same(markers)
    close_all(regions)


def test_gc_removes_dead_pod_dirs_after_grace(tmp_path):
    clock = [0.0]
    regions = {s: PATH[s].ContainerRegions(str(tmp_path / s), grace_s=300,
                                           clock=lambda: clock[0])
               for s in SIDES}
    t = Tenant(tmp_path, "deadpod_0")
    t.close()
    same({s: set(regions[s].scan()) for s in SIDES})
    assert same({s: regions[s].gc(live_pod_uids=[]) for s in SIDES}) == 0
    clock[0] = 301.0
    assert same({s: regions[s].gc(live_pod_uids=[]) for s in SIDES}) == 1
    assert not any((tmp_path / s / "deadpod_0").exists() for s in SIDES)
    live = Tenant(tmp_path, "livepod_0")
    clock[0] = 1000.0
    assert same({s: regions[s].gc(live_pod_uids=["livepod"])
                 for s in SIDES}) == 0
    assert all((tmp_path / s / "livepod_0").exists() for s in SIDES)
    close_all(regions, live)


def test_quarantine_streak_requires_consecutive_corruption(tmp_path):
    t = Tenant(tmp_path, "flappy_0", used=64)
    regions = monitors(tmp_path, quarantine_after=2)
    off = SharedRegionStruct.hbm_limit.offset
    flip(t.paths["port"], off, 0x02)      # one file: both names see it
    seen = {s: set(regions[s].scan_snapshots()[0].snapshots) for s in SIDES}
    assert same(seen) == set()
    flip(t.paths["port"], off, 0x02)      # healed
    for _ in range(2):
        seen = {s: set(regions[s].scan_snapshots()[0].snapshots)
                for s in SIDES}
        assert same(seen) == {"flappy_0"}
    assert same({s: (dict(regions[s].quarantined), regions[s].corrupt_events)
                 for s in SIDES}) == ({}, 1)
    close_all(regions, t)


def test_quarantine_marker_survives_a_monitor_restart(tmp_path):
    """Quarantined after one corrupt sweep; a restarted monitor honours
    the durable marker without a parse; a rewritten file (its stat moved)
    is probed afresh."""
    t = Tenant(tmp_path, "sick_0", used=4096)
    t.close()
    flip(t.paths["port"], SharedRegionStruct.hbm_limit.offset)
    regions = monitors(tmp_path, quarantine_after=1)
    same({s: set(regions[s].scan_snapshots()[0].snapshots) for s in SIDES})
    assert same({s: sorted(regions[s].quarantined) for s in SIDES}) == [
        "sick_0"]
    close_all(regions)
    regions = monitors(tmp_path, quarantine_after=1)
    same({s: set(regions[s].scan_snapshots()[0].snapshots) for s in SIDES})
    assert same({s: (sorted(regions[s].quarantined),
                     regions[s].corrupt_events) for s in SIDES}) == (
        ["sick_0"], 0)
    flip(t.paths["port"], SharedRegionStruct.hbm_limit.offset)  # healed
    os.utime(t.paths["port"], ns=(1, 1))
    seen = {s: set(regions[s].scan_snapshots()[0].snapshots) for s in SIDES}
    assert same(seen) == {"sick_0"}
    assert same({s: dict(regions[s].quarantined) for s in SIDES}) == {}
    close_all(regions)


def test_previous_abi_region_skipped_without_quarantine(tmp_path):
    """The (0b) parity case: a region of any ABI in [MIN_COMPAT, VERSION),
    shorter than the current struct, is a transient skip in both
    monitors, never a quarantine; below the floor or above the current
    version it is corruption in both."""
    assert port_region.VTPU_SHARED_VERSION_MIN_COMPAT == \
        jax_region.VTPU_SHARED_VERSION_MIN_COMPAT
    t = Tenant(tmp_path, "oldabi_0", used=128)
    t.close()
    path = t.paths["port"]
    off = SharedRegionStruct.version.offset
    size = ctypes.sizeof(SharedRegionStruct)
    regions = monitors(tmp_path, quarantine_after=1)
    for old in range(port_region.VTPU_SHARED_VERSION_MIN_COMPAT,
                     port_region.VTPU_SHARED_VERSION):
        with open(path, "r+b") as f:
            f.seek(off)
            f.write(old.to_bytes(4, "little"))
            f.truncate(size - 512)
        for _ in range(4):
            seen = {s: set(regions[s].scan_snapshots()[0].snapshots)
                    for s in SIDES}
            assert same(seen) == set(), old
        assert same({s: (dict(regions[s].quarantined),
                         regions[s].corrupt_events) for s in SIDES}) == (
            {}, 0), old
    for bad in (port_region.VTPU_SHARED_VERSION_MIN_COMPAT - 1,
                port_region.VTPU_SHARED_VERSION + 7):
        close_all(regions)
        regions = monitors(tmp_path, quarantine_after=1)
        with open(path, "r+b") as f:
            f.seek(off)
            f.write(bad.to_bytes(4, "little"))
            f.truncate(size)
        same({s: set(regions[s].scan_snapshots()[0].snapshots)
              for s in SIDES})
        assert same({s: sorted(regions[s].quarantined)
                     for s in SIDES}) == ["oldabi_0"], bad
        (tmp_path / "jax" / "oldabi_0" / "vtpu.quarantine.json").unlink()
        (tmp_path / "port" / "oldabi_0" / api.QUARANTINE_MARKER).unlink()
    close_all(regions)


def test_snapshot_survives_region_teardown(tmp_path):
    t = Tenant(tmp_path, "gone_0", used=2048)
    regions = monitors(tmp_path)
    snaps = {s: regions[s].scan_snapshots()[0].snapshots["gone_0"]
             for s in SIDES}
    t.close()
    for side in SIDES:
        os.unlink(t.paths[side])
    assert same({s: regions[s].scan() for s in SIDES}) == {}
    assert same({s: (snaps[s].used(0), snaps[s].total_launches())
                 for s in SIDES}) == (2048, 0)
    close_all(regions)


# ---------------------------------------------------------------------------
# feedback (tests/test_monitor.py:66-313): both loops, sweep by sweep, on
# byte-identical copies; their writes must be equal after every sweep
# ---------------------------------------------------------------------------

class FeedbackPair:
    def __init__(self, root, *tenants):
        self.tenants = {t.entry: t for t in tenants}
        self.regions = monitors(root)
        self.loops = {s: FEEDBACK[s].FeedbackLoop() for s in SIDES}
        self.views = {s: self.regions[s].scan() for s in SIDES}

    def rescan(self):
        self.views = {s: self.regions[s].scan() for s in SIDES}

    def sweep(self):
        """One sweep of each loop; the feedback plane of every region,
        equal in both files, by entry: (recent_kernel, switch)."""
        for side in SIDES:
            self.loops[side].observe(self.views[side])
        return same({s: {name: (v.recent_kernel, v.utilization_switch)
                         for name, v in self.views[s].items()}
                     for s in SIDES})

    def close(self):
        close_all(self.regions, *self.tenants.values())


BLOCK, IDLE = FEEDBACK_BLOCK, FEEDBACK_IDLE


def test_feedback_blocks_low_priority_while_high_active(tmp_path):
    hi = Tenant(tmp_path, "hi_0", priority=0, copies=True)
    lo = Tenant(tmp_path, "lo_0", priority=1, copies=True)
    fb = FeedbackPair(tmp_path, hi, lo)
    assert fb.sweep()["lo_0"][0] == IDLE       # baseline
    hi.launch(ns=MS)
    got = fb.sweep()
    assert got["lo_0"][0] == BLOCK and got["hi_0"][0] != BLOCK
    assert fb.sweep()["lo_0"][0] == IDLE       # high idle again
    fb.close()


def test_feedback_inflight_keeps_block_during_long_run(tmp_path):
    hi = Tenant(tmp_path, "hi_0", priority=0, copies=True)
    lo = Tenant(tmp_path, "lo_0", priority=1, copies=True)
    fb = FeedbackPair(tmp_path, hi, lo)
    fb.sweep()
    hi.begin()
    for _ in range(4):
        assert fb.sweep()["lo_0"][0] == BLOCK
    hi.end(2000 * MS)
    assert fb.sweep()["lo_0"][0] == IDLE
    fb.close()


def test_feedback_solo_tenant_released_then_contended(tmp_path, monkeypatch):
    solo = Tenant(tmp_path, "solo_0", copies=True)
    fb = FeedbackPair(tmp_path, solo)
    assert fb.sweep()["solo_0"][1] == 1
    other = Tenant(tmp_path, "other_0", copies=True)
    fb.tenants["other_0"] = other
    fb.rescan()
    got = fb.sweep()
    assert got["solo_0"][1] == 0 and got["other_0"][1] == 0
    fb.close()


def test_feedback_force_policy_keeps_throttle(tmp_path):
    forced = Tenant(tmp_path, "forced_0", policy=UTIL_POLICY_FORCE,
                    copies=True)
    fb = FeedbackPair(tmp_path, forced)
    for _ in range(3):
        assert fb.sweep()["forced_0"][1] == 0
    fb.close()


def test_feedback_blocks_only_card_sharers(tmp_path):
    hi = Tenant(tmp_path, "hi2_0", priority=0, uuid=CARD_A, copies=True)
    same_card = Tenant(tmp_path, "losame_0", uuid=CARD_A, copies=True)
    other_card = Tenant(tmp_path, "loother_0", uuid=CARD_B, copies=True)
    fb = FeedbackPair(tmp_path, hi, same_card, other_card)
    fb.sweep()
    hi.launch()
    got = fb.sweep()
    assert got["losame_0"] == (BLOCK, 0)
    assert got["loother_0"] == (IDLE, 1)
    fb.close()


def test_feedback_monitor_restart_no_spurious_block(tmp_path):
    hi = Tenant(tmp_path, "hist_0", priority=0, launches=100, copies=True)
    lo = Tenant(tmp_path, "cold_0", priority=1, copies=True)
    fb = FeedbackPair(tmp_path, hi, lo)
    assert fb.sweep()["cold_0"][0] == IDLE
    fb.close()


def test_feedback_ignores_stale_inflight(tmp_path):
    hi = Tenant(tmp_path, "dead_0", priority=0, copies=True)
    lo = Tenant(tmp_path, "live_0", priority=1, copies=True)
    fb = FeedbackPair(tmp_path, hi, lo)
    fb.sweep()
    hi.begin()
    assert fb.sweep()["live_0"][0] == BLOCK
    # the process is killed mid-run: its slot keeps inflight, its
    # heartbeat stops (backdated past the freshness window)
    for side in SIDES:
        for slot in hi.raw(side).procs:
            if slot.status:
                slot.last_seen_ns -= 120_000_000_000
    assert fb.sweep()["live_0"][0] == IDLE
    fb.close()


# ---------------------------------------------------------------------------
# the collector (tests/test_monitor.py:146-210, :488-580, :581-887): every
# JAX family has its mapped port family with the same label sets and values
# ---------------------------------------------------------------------------

class FrozenClock:
    """The monitors' clock, held still while both collect."""

    def __init__(self):
        self.t = time.monotonic()

    def ns(self):
        return int(self.t * 1e9)


@pytest.fixture
def clock(monkeypatch):
    c = FrozenClock()
    frozen = SimpleNamespace(monotonic=lambda: c.t, monotonic_ns=c.ns,
                             perf_counter=time.perf_counter, time=time.time)
    for mod in (jax_region, port_region, jax_path, port_path):
        monkeypatch.setattr(mod, "time", frozen)
    return c


def _pod(uid, name, namespace="default", node="n1", annotations=None):
    return {"metadata": {"uid": uid, "name": name, "namespace": namespace,
                         "annotations": dict(annotations or {})},
            "spec": {"nodeName": node, "containers": []},
            "status": {"phase": "Running"}}


def _cards():
    return ({"jax": FakeTpuLib(chips=[
                TpuChip(uuid=CARD_A, index=0, type="TPU-v4", hbm_mb=81559),
                TpuChip(uuid=CARD_B, index=1, type="TPU-v4", hbm_mb=81559)]),
             "port": FakeNvmlLib(chips=[
                 GpuChip(uuid=CARD_A, index=0, hbm_mb=81559),
                 GpuChip(uuid=CARD_B, index=1, hbm_mb=81559)])})


def collectors(root, clock, pods=(), node_name="n1", cache=True, **kw):
    regions = monitors(root, **kw)
    clients = {"jax": JaxClient(), "port": FakeKubeClient()}
    caches = {}
    for side, client in clients.items():
        for pod in pods:
            client.add_pod(json.loads(json.dumps(pod)))
        if cache:
            caches[side] = (JaxPodCache if side == "jax" else PortPodCache)(
                client, node_name=node_name)
            caches[side].sync_once()
    cards = _cards()
    out = {
        "jax": jax_metrics.MonitorCollector(
            regions["jax"], tpulib=cards["jax"], client=clients["jax"],
            node_name=node_name, pod_cache=caches.get("jax")),
        "port": port_metrics.MonitorCollector(
            regions["port"], gpulib=cards["port"], client=clients["port"],
            node_name=node_name, pod_cache=caches.get("port")),
    }
    for c in out.values():
        c._clock = lambda: clock.t
    return out, regions, clients


def families(collector):
    return {f.name: {(s.name, tuple(sorted(s.labels.items()))): s.value
                     for s in f.samples}
            for f in collector.collect()}


def collect_same(cols):
    """One scrape of each collector; every JAX family's samples equal the
    mapped port family's: integers exactly, floats to relative 1e-12.
    The JAX families are returned."""
    jfams, pfams = families(cols["jax"]), families(cols["port"])
    names = port_metrics.METRIC_NAMES
    assert set(pfams) == ({names[j] for j in jfams}
                          | set(port_metrics.PORT_ONLY_FAMILIES))
    for jname, jsamples in jfams.items():
        pname = names[jname]
        want = {(sname.replace(jname, pname, 1), labels): v
                for (sname, labels), v in jsamples.items()}
        assert set(pfams[pname]) == set(want), jname
        for key, v in want.items():
            got = pfams[pname][key]
            if float(v).is_integer():
                assert got == v, (jname, key)
            else:
                assert got == pytest.approx(v, rel=1e-12), (jname, key)
    return jfams


def by(fams, family, label):
    return {dict(labels)[label]: v for (_, labels), v in
            fams[family].items()}


def test_collector_families_match(tmp_path, clock):
    a = Tenant(tmp_path, "uid1_0", hbm_limit=2048, used=1024, launches=3,
               uuid=CARD_A, host_limit=4 * MB)
    b = Tenant(tmp_path, "uid2_0", hbm_limit=8 * MB, used=3 * MB,
               uuid=CARD_B, priority=0)
    cols, regions, _ = collectors(tmp_path, clock, pods=[
        _pod("uid1", "train-job", "ml"), _pod("uid2", "serve", "web")])
    base = collect_same(cols)
    assert by(base, "HostHBMMemoryUsage", "deviceuuid") == {
        CARD_A: 1024.0, CARD_B: float(3 * MB)}
    a.launch(ns=2000 * MS)      # 2 s of device time in a 4 s scrape window
    b.begin()                   # in flight across the scrape
    a.each(lambda r: r.host_try_alloc(MB))
    clock.t += 4.0
    fams = collect_same(cols)
    util = by(fams, "HostCoreUtilization", "deviceuuid")
    assert util[CARD_A] == pytest.approx(50.0) and util[CARD_B] == 0.0
    assert by(fams, "vTPU_container_programs_inflight", "poduid") == {
        "uid1": 0.0, "uid2": 1.0}
    assert by(fams, "vTPUHostMemUsed", "poduid")["uid1"] == float(MB)
    assert by(fams, "vTPU_device_memory_usage_in_bytes", "podname") == {
        "train-job": 1024.0, "serve": float(3 * MB)}
    assert fams["vTPUPodCacheSynced"] and fams["vTPUPodCachePods"]
    close_all(regions, a, b)


def test_collector_profile_families_match(tmp_path, clock):
    t = Tenant(tmp_path, "prof_0", hbm_limit=MB)
    lib = _core()
    lib.vtpu_prof_configure(1, 1)
    try:
        r = t.regions[0]
        for _ in range(6):
            assert r.try_alloc(256)
            r.free(256)
        assert r.try_alloc(MB - 128)
        assert not r.try_alloc(4096)     # near-limit failure
        r.free(MB - 128)
        lib.vtpu_prof_flush(r._ptr)
    finally:
        lib.vtpu_prof_configure(0, 64)
    cols, regions, _ = collectors(tmp_path, clock)
    fams = collect_same(cols)
    calls = by(fams, "vTPUShimCallsiteCalls", "callsite")
    assert calls["charge"] == 8.0 and calls["uncharge"] == 7.0
    assert by(fams, "vTPUShimQuotaPressure", "kind")[
        "near_limit_failures"] == 1.0
    assert any(k[0] == "vTPUShimCallsiteLatency_bucket"
               for k in fams["vTPUShimCallsiteLatency"])
    close_all(regions, t)


def test_collector_exports_unmeasured_footprints(tmp_path, clock):
    """The port's one family of its own: per pod, the devices whose
    footprint libvgpu.so does not re-read (the header's reserved2, which
    the JAX shim leaves 0 and its monitor ignores)."""
    t = Tenant(tmp_path, "uid3_0")
    u = Tenant(tmp_path, "uid4_0")
    with open(t.paths["port"], "r+b") as f:
        f.seek(SharedRegionStruct.reserved2.offset)
        f.write((2).to_bytes(4, "little"))
    cols, regions, _ = collectors(tmp_path, clock)
    fams = collect_same(cols)   # every JAX family still equal
    port = families(cols["port"])
    assert by(port, "vGPUPodFootprintUnmeasured", "poduid") == {
        "uid3": 2.0, "uid4": 0.0}
    close_all(regions, t, u)


def test_collector_quarantined_region_zero_in_every_family(tmp_path, clock):
    healthy = Tenant(tmp_path, "alive_0", uuid=CARD_A, used=2048)
    sick = Tenant(tmp_path, "sick_0", uuid=CARD_A, used=4096, launches=5)
    sick.begin()
    sick.close()
    flip(sick.paths["port"], SharedRegionStruct.hbm_limit.offset)
    cols, regions, _ = collectors(tmp_path, clock, cache=False,
                                  quarantine_after=1)
    collect_same(cols)                   # quarantines sick in both
    assert same({s: sorted(regions[s].quarantined) for s in SIDES}) == [
        "sick_0"]
    healthy.launch(ns=3000 * MS)
    clock.t += 3.0
    fams = collect_same(cols)
    for family in ("vTPU_device_memory_usage_in_bytes",
                   "vTPU_container_program_launches",
                   "vTPU_container_programs_inflight", "vTPUShimStale"):
        assert set(by(fams, family, "poduid")) == {"alive"}, family
    assert by(fams, "HostHBMMemoryUsage", "deviceuuid")[CARD_A] == 2048.0
    assert by(fams, "HostCoreUtilization", "deviceuuid")[CARD_A] == \
        pytest.approx(100.0)
    close_all(regions, healthy)


def test_collector_stale_interposer_gauge_matches(tmp_path, clock):
    wedged = Tenant(tmp_path, "wedged_0", used=512)
    done = Tenant(tmp_path, "done_0")
    done.each(lambda r: r.detach())
    for t in (wedged, done):
        t.raw("port").header_heartbeat_ns = clock.ns() - 120_000_000_000
    cols, regions, _ = collectors(tmp_path, clock, cache=False)
    fams = collect_same(cols)
    assert by(fams, "vTPUShimStale", "poduid") == {"wedged": 1.0,
                                                     "done": 0.0}
    assert by(fams, "vTPUShimHeartbeatAge", "poduid")["wedged"] == \
        pytest.approx(120.0)
    close_all(regions, wedged, done)


def test_collector_cluster_list_fallback_matches(tmp_path, clock):
    t = Tenant(tmp_path, "uidF_0")
    cols, regions, clients = collectors(
        tmp_path, clock, pods=[_pod("uidF", "f")], node_name="", cache=False)
    collect_same(cols)
    collect_same(cols)
    assert same({s: clients[s].list_pod_calls for s in SIDES}) == 1
    clock.t += 100.0
    fams = collect_same(cols)
    assert same({s: clients[s].list_pod_calls for s in SIDES}) == 2
    assert by(fams, "vTPU_device_memory_usage_in_bytes", "podname") == {
        "f": 0.0}
    close_all(regions, t)


def test_split_busy_ns_matches():
    for busy, cards in ((7, ["chip-b", "chip-a"]), (10, ["c", "c", "d"]),
                        (5, []), (1 << 40, [CARD_B, CARD_A])):
        assert port_metrics.split_busy_ns(busy, cards) == \
            jax_metrics.split_busy_ns(busy, cards)


def test_every_jax_family_is_mapped():
    """The map names every family the JAX monitor's process exports: the
    collector's (collected above) and the module-level ones, whose port
    twins are registered under the mapped names."""
    from vtpu.trace import metrics as jax_tmetrics
    from vtpu.util import health as jax_health
    from vtpu_torch.trace import metrics as port_tmetrics
    from vtpu_torch.util import health as port_health

    pairs = [(jax_metrics.SWEEP_LATENCY, port_metrics.SWEEP_LATENCY),
             (jax_tmetrics.STAGE_LATENCY, port_tmetrics.STAGE_LATENCY),
             (jax_health.NODE_DEGRADED, port_health.NODE_DEGRADED)]
    for mod_j, mod_p in ((jax_hostguard, port_hostguard),
                         (jax_resize, port_resize),
                         (jax_migrate, port_migrate)):
        for attr in dir(mod_j):
            obj = getattr(mod_j, attr)
            if type(obj).__name__ == "Counter" and hasattr(obj, "_name"):
                pairs.append((obj, getattr(mod_p, attr)))
    assert len(pairs) == 13
    names = port_metrics.METRIC_NAMES
    for jax_obj, port_obj in pairs:
        assert names[jax_obj._name] == port_obj._name
    assert len(set(names.values())) == len(names)
    assert not any("TPU" in v or "HBM" in v for v in names.values())


# ---------------------------------------------------------------------------
# host guard, resize and drains through the daemon (tests/test_host_chaos.py,
# tests/test_resize_chaos.py:173-226, tests/test_migrate.py:764-830): the
# same annotation sequences through each side's FakeKubeClient and pod
# cache; limits, blocked sets, states and sidecar JSON compared after
# every sweep
# ---------------------------------------------------------------------------

SIDECARS = {"jax": {"resize": "vtpu.resize.json",
                    "host": "vtpu.hostguard.json",
                    "drain": "vtpu.drain.json",
                    "ack": "vtpu.drain.ack.json"},
            "port": {"resize": api.RESIZE_RECORD,
                     "host": api.HOSTGUARD_RECORD,
                     "drain": api.DRAIN_REQUEST_FILE,
                     "ack": api.DRAIN_ACK_FILE}}


class DaemonPair:
    def __init__(self, root, tenants, pods, grace_s=30.0):
        self.root = root
        self.tenants = {t.entry: t for t in tenants}
        self.now = [1000.0]
        self.clients = {"jax": JaxClient(), "port": FakeKubeClient()}
        cards = _cards()
        self.daemons = {
            "jax": jax_daemon.MonitorDaemon(
                str(root / "jax"), tpulib=cards["jax"],
                client=self.clients["jax"], node_name="n1", info_port=0),
            "port": port_daemon.MonitorDaemon(
                str(root / "port"), gpulib=cards["port"],
                client=self.clients["port"], node_name="n1", info_port=0)}
        for side, d in self.daemons.items():
            for pod in pods:
                self.clients[side].add_pod(json.loads(json.dumps(pod)))
            d.podcache.sync_once()
            for part in (d.resizer, d.hostguard):
                part.clock = lambda: self.now[0]
                part.grace_s = grace_s

    def patch(self, name, annos):
        for side, d in self.daemons.items():
            self.clients[side].patch_pod_annotations("default", name, annos)
            d.podcache.sync_once()

    def state(self, side):
        d = self.daemons[side]
        out = {}
        for entry in sorted(self.tenants):
            with (jax_region.RegionView if side == "jax"
                  else port_region.RegionView)(
                    self.tenants[entry].paths[side]) as v:
                region = (v.hbm_limit(0), v.host_limit(),
                          v.recent_kernel, v.utilization_switch)
            sidecars = {kind: jax_workload.read_json(
                str(self.root / side / entry / name))
                for kind, name in SIDECARS[side].items()}
            out[entry] = {
                "region": region,
                "resize": (d.resizer.gen_of(entry), d.resizer.state_of(entry),
                           d.resizer.resize_blocked(entry)),
                "host": (d.hostguard.state_of(entry),
                         d.hostguard.host_blocked(entry)),
                "drain": (d.drains.gen_of(entry), d.drains.state_of(entry),
                          d.drains.migrate_blocked(entry)),
                "sidecars": sidecars}
        return out

    def sweep(self):
        for d in self.daemons.values():
            d.sweep_once()
        return same({s: self.state(s) for s in SIDES})

    def close(self):
        for d in self.daemons.values():
            d.regions.close()
        for t in self.tenants.values():
            t.close()


def test_resize_shrink_clamps_graces_blocks_then_lands(tmp_path):
    t = Tenant(tmp_path, "pod-a_0", hbm_limit=512 * MB, used=400 * MB,
               uuid=CARD_A, copies=True)
    dp = DaemonPair(tmp_path, [t], [_pod("pod-a", "a", annotations={
        types.HBM_LIMIT_ANNO: jax_codec.encode_hbm_limit(1, [[256]])})])
    s = dp.sweep()["pod-a_0"]
    assert s["region"][0] == 400 * MB and s["resize"] == (1, "clamped",
                                                          False)
    dp.now[0] += 10
    assert dp.sweep()["pod-a_0"]["resize"][2] is False
    dp.now[0] += 25
    s = dp.sweep()["pod-a_0"]
    assert s["resize"] == (1, "blocked", True) and s["region"][3] == 0
    assert s["sidecars"]["resize"]["blocked"] is True
    t.each(lambda r: r.free(300 * MB))
    s = dp.sweep()["pod-a_0"]
    assert s["region"][0] == 256 * MB and s["resize"] == (1, "applied",
                                                          False)
    assert s["region"][3] == 1          # solo, released again
    # a garbled later intent is refused once; the applied gen stands
    dp.patch("a", {types.HBM_LIMIT_ANNO: "2:x"})
    s = dp.sweep()["pod-a_0"]
    assert s["resize"] == (1, "refused", False)
    dp.close()


def test_host_guard_clamps_graces_blocks_then_releases(tmp_path):
    bad = Tenant(tmp_path, "bad_0", host_limit=16 * MB, uuid=CARD_A,
                 copies=True)
    good = Tenant(tmp_path, "good_0", host_limit=16 * MB, uuid=CARD_B,
                  copies=True)
    dp = DaemonPair(tmp_path, [bad, good],
                    [_pod("bad", "bad"), _pod("good", "good")],
                    grace_s=10.0)
    for t in (bad, good):
        t.each(lambda r: r.host_try_alloc(8 * MB))
    assert dp.sweep()["bad_0"]["host"] == ("", False)
    bad.each(lambda r: _core().vtpu_host_force_alloc(r._ptr, os.getpid(),
                                                     64 * MB))
    assert dp.sweep()["bad_0"]["host"] == ("over", False)
    dp.now[0] += 5
    assert dp.sweep()["bad_0"]["host"] == ("over", False)
    dp.now[0] += 6
    s = dp.sweep()
    assert s["bad_0"]["host"] == ("blocked", True)
    assert s["bad_0"]["region"][3] == 0 and s["good_0"]["region"][3] == 1
    assert s["bad_0"]["sidecars"]["host"] == {"blocked": True}
    bad.each(lambda r: r.host_free(64 * MB))
    s = dp.sweep()["bad_0"]
    assert s["host"] == ("", False) and s["region"][3] == 1
    dp.close()


def test_drain_handshake_with_each_workload_side(tmp_path):
    """The drain request, the workload's ack through each package's own
    Enforcer (the port's drain_* against the port's DrainCoordinator),
    the quiesce block, the cutover; then a retracted move unlinks the
    sidecars and the workload sees the retraction."""
    t = Tenant(tmp_path, "uid-m_0", uuid=CARD_A, copies=True)
    devs = [[jax_types.ContainerDevice(uuid="chip-0", usedmem=4096)]]
    dp = DaemonPair(tmp_path, [t], [_pod("uid-m", "m", annotations={
        types.MIGRATING_TO_ANNO: jax_codec.encode_migrating_to(3, "n2",
                                                               devs),
        types.MIGRATE_DEADLINE_ANNO: "99999.5"})])
    s = dp.sweep()["uid-m_0"]
    assert s["drain"] == (3, "draining", False)
    assert s["sidecars"]["drain"] == {"gen": 3, "dest": "n2",
                                      "deadline": 99999.5}
    enforcers = {
        "jax": jax_workload.Enforcer(jax_workload.Quota(
            cache_path=t.paths["jax"]), None),
        "port": port_workload.Enforcer(port_workload.Quota(
            cache_path=t.paths["port"]), None)}
    assert same({s_: (e.drain_requested(), e.drain_deadline())
                 for s_, e in enforcers.items()}) == (3, 99999.5)
    for side, e in enforcers.items():
        e.drain_ack(3, (jax_workload if side == "jax" else port_workload)
                    .DRAIN_PHASE_SNAPSHOTTED, 1234)
    s = dp.sweep()["uid-m_0"]
    assert s["drain"] == (3, "snapshotted", True)
    assert s["region"][2] == FEEDBACK_BLOCK and s["region"][3] == 0
    assert same({s_: e.drain_requested() for s_, e in enforcers.items()}) == 0
    # cutover committed: the block lifts, the sidecars stay
    dp.patch("m", {types.MIGRATING_TO_ANNO: "",
                   types.MIGRATED_FROM_ANNO:
                       jax_codec.encode_migrated_from(3, "n1")})
    s = dp.sweep()["uid-m_0"]
    assert s["drain"] == (0, "", False) and s["region"][2] != FEEDBACK_BLOCK
    assert s["sidecars"]["drain"]["gen"] == 3
    # a new move, then retracted without a cutover
    dp.patch("m", {types.MIGRATING_TO_ANNO:
                   jax_codec.encode_migrating_to(4, "n3", devs)})
    assert dp.sweep()["uid-m_0"]["drain"] == (4, "draining", False)
    assert same({s_: e.drain_retracted(4) for s_, e in enforcers.items()}) \
        is False
    dp.patch("m", {types.MIGRATING_TO_ANNO: ""})
    s = dp.sweep()["uid-m_0"]
    assert s["sidecars"]["drain"] is None and s["sidecars"]["ack"] is None
    assert same({s_: e.drain_retracted(4) for s_, e in enforcers.items()}) \
        is True
    dp.close()


def test_preempted_pod_is_blocked_and_held(tmp_path):
    victim = Tenant(tmp_path, "victim_0", priority=1, uuid=CARD_A,
                    copies=True)
    dp = DaemonPair(tmp_path, [victim], [_pod("victim", "v")])
    assert dp.sweep()["victim_0"]["region"][2:] == (FEEDBACK_IDLE, 1)
    dp.patch("v", {types.PREEMPTED_BY_ANNO: "default/winner"})
    assert dp.sweep()["victim_0"]["region"][2:] == (FEEDBACK_BLOCK, 0)
    dp.close()


# ---------------------------------------------------------------------------
# the daemon: sweep_once + /nodeinfo (tests/test_monitor.py:211, :413-465)
# ---------------------------------------------------------------------------

def test_nodeinfo_payload_and_etag_match(tmp_path):
    hi = Tenant(tmp_path, "uidA_0", priority=0, used=4096, launches=2,
                uuid=CARD_A, copies=True)
    lo = Tenant(tmp_path, "uid_with_under_0", core=25, used=1024,
                uuid=CARD_A, copies=True)
    dp = DaemonPair(tmp_path, [hi, lo], [
        _pod("uidA", "train", "ml"), _pod("uid_with_under", "serve")])
    dp.sweep()
    hi.launch()
    s = dp.sweep()
    assert s["uid_with_under_0"]["region"][2] == FEEDBACK_BLOCK
    infos = {side: d.node_info() for side, d in dp.daemons.items()}
    info = same(infos)
    entries = {e["entry"]: e for e in info["containers"]}
    assert entries["uid_with_under_0"]["pod_name"] == "serve"
    assert entries["uid_with_under_0"]["core_limit"] == [25]
    assert entries["uidA_0"]["hbm_used"] == [4096]
    assert entries["uidA_0"]["dev_uuids"] == [CARD_A]
    etags = same({side: d._nodeinfo_payload() for side, d in
                  dp.daemons.items()})[1]
    port = dp.daemons["port"]
    port.start_info_server()
    try:
        url = f"http://127.0.0.1:{port._info_server.server_address[1]}"
        resp = urllib.request.urlopen(url + "/nodeinfo", timeout=5)
        assert resp.headers["ETag"] == etags
        assert json.loads(resp.read()) == info
        req = urllib.request.Request(url + "/nodeinfo",
                                     headers={"If-None-Match": etags})
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=5)
        assert e.value.code == 304
        ready = urllib.request.urlopen(url + "/readyz", timeout=5)
        assert json.loads(ready.read())["component"] == "monitor"
    finally:
        port.stop()
    dp.close()


def test_zero_lists_steady_state(tmp_path):
    t = Tenant(tmp_path, "uidZ_0", used=4096, launches=2, copies=True)
    dp = DaemonPair(tmp_path, [t], [_pod("uidZ", "z", "ml")])
    for c in dp.clients.values():
        c.reset_call_counts()
    for _ in range(3):
        dp.sweep()
        for d in dp.daemons.values():
            list(d.collector.collect())
            d.node_info()
    assert same({s: c.list_pod_calls for s, c in dp.clients.items()}) == 0
    dp.close()


# ---------------------------------------------------------------------------
# the copies: pod cache, lockdebug, tracer and logsetup (tests/
# test_podcache.py, tests/test_lockdebug.py, tests/test_trace.py), each
# run against both modules
# ---------------------------------------------------------------------------

PODCACHE = {"jax": (JaxPodCache, JaxClient),
            "port": (PortPodCache, FakeKubeClient)}


@pytest.mark.parametrize("side", SIDES)
def test_podcache_sync_then_watch_applies_events(side):
    cache_cls, client_cls = PODCACHE[side]
    client = client_cls()
    client.add_pod(_pod("u1", "a"))
    cache = cache_cls(client, node_name="n1", watch_timeout_s=0.05,
                      relist_backoff_s=0.0)
    cache.sync_once()
    assert cache.meta("u1") == {"namespace": "default", "name": "a",
                                "phase": "Running"}
    client.add_pod(_pod("u2", "b"))
    client.delete_pod("default", "a")
    cache.poll_once()
    assert cache.get("u1") is None
    assert cache.get("u2")["metadata"]["name"] == "b"
    assert cache.relists == 1 and client.list_pod_calls == 1


@pytest.mark.parametrize("side", SIDES)
def test_podcache_node_scoped_feed(side):
    cache_cls, client_cls = PODCACHE[side]
    client = client_cls()
    client.add_pod(_pod("u1", "a", node="n1"))
    client.add_pod(_pod("u2", "b", node="n2"))
    cache = cache_cls(client, node_name="n1", watch_timeout_s=0.05,
                      relist_backoff_s=0.0)
    cache.sync_once()
    assert len(cache) == 1 and cache.get("u2") is None
    client.add_pod(_pod("u3", "c", node="n2"))
    client.add_pod(_pod("u4", "d", node="n1"))
    cache.poll_once()
    assert cache.get("u3") is None and cache.get("u4") is not None
    assert sorted(cache.live_uids("n1")) == ["u1", "u4"]
    assert cache.labels("n1")["u4"] == {"namespace": "default", "name": "d"}


@pytest.mark.parametrize("side", SIDES)
def test_podcache_relists_on_gone_error(side):
    cache_cls, client_cls = PODCACHE[side]
    client = client_cls()
    client.add_pod(_pod("u1", "a"))
    cache = cache_cls(client, node_name="n1", watch_timeout_s=0.05,
                      relist_backoff_s=0.0)
    cache.sync_once()
    client.add_pod(_pod("um", "mid"))
    client.compact_events()
    client.add_pod(_pod("u2", "b"))
    cache.poll_once()
    assert cache.relists == 2 and client.list_pod_calls == 2
    assert cache.get("um") is not None and cache.get("u2") is not None


@pytest.mark.parametrize("side", SIDES)
def test_podcache_ensure_fresh_relists_only_when_stale(side):
    cache_cls, client_cls = PODCACHE[side]
    now = [0.0]
    client = client_cls()
    client.add_pod(_pod("u1", "a"))
    cache = cache_cls(client, fresh_s=100.0, clock=lambda: now[0])
    cache.ensure_fresh()
    cache.ensure_fresh()
    assert cache.relists == 1
    now[0] = 200.0
    assert not cache.fresh()
    cache.ensure_fresh()
    assert cache.relists == 2 and cache.fresh()


LOCKDEBUG = {"jax": jax_lockdebug, "port": port_lockdebug}


@pytest.fixture
def tracking(monkeypatch):
    for mod in LOCKDEBUG.values():
        monkeypatch.setenv(mod.ENV_FLAG, "1")
        mod.reset()
    yield
    for mod in LOCKDEBUG.values():
        mod.reset()


@pytest.mark.parametrize("side", SIDES)
def test_lockdebug_disabled_is_plain(side, monkeypatch):
    mod = LOCKDEBUG[side]
    monkeypatch.delenv(mod.ENV_FLAG, raising=False)
    assert isinstance(mod.lock("x"), type(threading.Lock()))
    assert isinstance(mod.rlock("x"), type(threading.RLock()))


@pytest.mark.parametrize("side", SIDES)
def test_lockdebug_inversions_raise(side, tracking):
    mod = LOCKDEBUG[side]
    a, b, c = mod.lock("a"), mod.lock("b"), mod.lock("c")
    with a:
        with b:
            pass
    with b:
        with c:
            pass
    errors = []

    def inverted():
        try:
            with c:
                with a:
                    pass
        except mod.LockOrderError as e:
            errors.append(e)

    th = threading.Thread(target=inverted)
    th.start()
    th.join(timeout=10)
    assert not th.is_alive() and len(errors) == 1
    assert "inversion" in str(errors[0])
    r = mod.rlock("r")
    with r:
        with r:
            pass
    assert mod.edges().get("r", set()) == set()


TRACE = {"jax": jax_trace, "port": port_trace}


@pytest.fixture
def tracers():
    for mod in TRACE.values():
        mod.tracer.configure(process="test", max_traces=512, max_spans=64,
                             journal_path="")
        mod.tracer.set_enabled(True)
        mod.tracer.reset()
    yield
    for mod in TRACE.values():
        mod.tracer.configure(max_traces=512, max_spans=64, journal_path="")
        mod.tracer.set_enabled(True)
        mod.tracer.reset()


@pytest.mark.parametrize("side", SIDES)
def test_trace_spans_nest_error_and_backdate(side, tracers):
    mod = TRACE[side]
    tracer = mod.tracer
    tid = mod.trace_id_for_uid("uid-span")
    assert tid == jax_trace.trace_id_for_uid("uid-span")
    with tracer.span(tid, "outer", pod="ns/p"):
        with tracer.span(tid, "inner") as inner:
            assert tracer.current() is inner
    with pytest.raises(ValueError):
        with tracer.span(tid, "boom"):
            raise ValueError("kaput")
    with tracer.span(tid, "wait", started_at=time.perf_counter() - 0.05):
        pass
    data = tracer.render_trace(tid)
    stages = {s["stage"]: s for s in data["spans"]}
    assert stages["inner"]["parent_id"] == stages["outer"]["span_id"]
    assert stages["boom"]["status"] == "error"
    assert stages["wait"]["duration_ms"] >= 45.0 and data["pod"] == "ns/p"
    pod = {"metadata": {"uid": "u9", "annotations": {
        types.TRACE_ID_ANNO: "feedfacefeedface"}}}
    assert mod.trace_id_of_pod(pod) == "feedfacefeedface"


@pytest.mark.parametrize("side", SIDES)
def test_trace_ring_and_span_caps(side, tracers):
    tracer = TRACE[side].tracer
    tracer.configure(max_traces=2, max_spans=2)
    for i in range(3):
        tid = TRACE[side].trace_id_for_uid(f"uid-ring-{i}")
        for _ in range(4):
            with tracer.span(tid, "s", pod=f"default/p{i}"):
                pass
    assert tracer.trace_for_key("default/p0") is None
    data = tracer.trace_for_key("default/p2")
    assert len(data["spans"]) == 2 and data["spans_dropped"] == 2


@pytest.mark.parametrize("side", SIDES)
def test_trace_journal_rotation(side, tracers, tmp_path):
    tracer = TRACE[side].tracer
    path = tmp_path / "trace.jsonl"
    tracer.configure(journal_path=str(path), journal_max_kb=1)
    tid = TRACE[side].trace_id_for_uid("uid-journal")
    for i in range(80):
        with tracer.span(tid, "region.observe", pod="default/j", i=i):
            pass
    assert (tmp_path / "trace.jsonl.1").exists()
    assert path.stat().st_size <= 4096 + 512


@pytest.mark.parametrize("side", SIDES)
def test_logsetup_json_carries_trace_id(side, tracers, monkeypatch):
    import io
    import logging

    logsetup = {"jax": jax_logsetup, "port": port_logsetup}[side]
    monkeypatch.setenv("VTPU_LOG_FORMAT", "json")
    buf = io.StringIO()
    logsetup.setup(verbose=0, stream=buf)
    try:
        log = logging.getLogger(f"{side}.test.json")
        tid = TRACE[side].trace_id_for_uid("uid-log")
        with TRACE[side].tracer.span(tid, "region.observe"):
            log.info("inside span")
        log.info("outside span")
        lines = [json.loads(line) for line in buf.getvalue().splitlines()]
        assert lines[0]["trace"] == tid and "trace" not in lines[1]
    finally:
        monkeypatch.setenv("VTPU_LOG_FORMAT", "text")
        logsetup.setup(verbose=0)


# ---------------------------------------------------------------------------
# import hygiene
# ---------------------------------------------------------------------------

def test_monitor_imports_neither_jax_nor_vtpu_nor_torch():
    code = ("import json, sys, vtpu_torch.monitor.daemon, "
            "vtpu_torch.monitor.__main__; print(json.dumps(sorted(m for m "
            "in sys.modules if m.split('.')[0] in ('jax', 'vtpu', "
            "'torch'))))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout) == []
    help_ = subprocess.run([sys.executable, "-m", "vtpu_torch.monitor",
                            "--help"], cwd=REPO, capture_output=True,
                           text=True, timeout=120)
    assert help_.returncode == 0 and "--containers-dir" in help_.stdout


def test_no_module_of_the_port_imports_vtpu():
    import ast

    bad = []
    for dirpath, _, files in os.walk(os.path.join(REPO, "vtpu_torch")):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            for node in ast.walk(ast.parse(open(path).read())):
                names = []
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    names = [node.module or ""]
                bad += [(path, n) for n in names
                        if n.split(".")[0] in ("vtpu", "jax")]
    assert bad == []


# ---------------------------------------------------------------------------
# end to end on the CPU: the plugin's Allocate puts two pods under
# libvgpu.so on the mock driver, and the port's monitor sweeps the plugin's
# containers directory
# ---------------------------------------------------------------------------

LAUNCHER = textwrap.dedent(r"""
    import ctypes, json, sys, threading, time
    from ctypes import (CFUNCTYPE, POINTER, byref, c_char_p, c_int, c_uint,
                        c_uint64, c_ulong, c_void_p)

    cu = ctypes.CDLL("libcuda.so.1")
    cu.mock_cuda_launches.restype = c_ulong
    gpa2 = CFUNCTYPE(c_int, c_char_p, POINTER(c_void_p), c_int, c_uint64,
                     POINTER(c_int))(ctypes.cast(cu.cuGetProcAddress_v2,
                                                 c_void_p).value)

    def via2(base):
        p, st = c_void_p(), c_int(-1)
        assert gpa2(base.encode(), byref(p), 12080, 0, byref(st)) == 0
        return p.value

    launch = CFUNCTYPE(c_int, c_void_p, c_uint, c_uint, c_uint, c_uint,
                       c_uint, c_uint, c_uint, c_void_p, c_void_p,
                       c_void_p)(via2("cuLaunchKernel"))
    sync = CFUNCTYPE(c_int, c_void_p)(via2("cuStreamSynchronize"))
    go = threading.Event()

    def launcher():
        while True:
            go.wait()
            if launch(None, 1, 1, 1, 1, 1, 1, 0, None, None, None) == 0:
                sync(None)

    threading.Thread(target=launcher, daemon=True).start()
    for line in sys.stdin:
        cmd = line.strip()
        if cmd == "go":
            go.set()
        elif cmd == "halt":
            go.clear()
        elif cmd == "exit":
            break
        print(json.dumps({"mock": cu.mock_cuda_launches()}), flush=True)
""")


def test_end_to_end_allocate_then_monitor_blocks_and_releases(tmp_path):
    import grpc

    from vtpu_torch.plugin import deviceplugin_pb2 as pb
    from vtpu_torch.plugin import dp_grpc, runtime, server
    from vtpu_torch.plugin.config import PluginConfig
    from vtpu_torch.util import nodelock, podutil

    node = "gpu-node"
    card = GpuChip(uuid=CARD_A, index=0, hbm_mb=81559)
    client = FakeKubeClient()
    client.add_node(node)
    config = PluginConfig(device_split_count=4,
                          socket_dir=str(tmp_path / "sock"),
                          shim_host_dir=str(tmp_path / "vgpu"))
    server.install_shim_artifacts(config.shim_host_dir)
    plugin = server.GPUDevicePlugin(FakeNvmlLib(chips=[card]), config,
                                    client, node)
    plugin.start(register_with_kubelet=False)
    procs = {}
    daemon = None
    try:
        for name, priority in (("h", 0), ("l", 1)):
            grant = types.ContainerDevice(uuid=CARD_A, type="NVIDIA",
                                          usedmem=64, usedcores=50)
            annos = podutil.device_annotations(node, [[grant]])
            annos[api.BIND_PHASE_ANNO] = "allocating"
            annos[api.BIND_TIME_ANNO] = str(time.time_ns())
            client.add_pod({
                "metadata": {"name": name, "namespace": "default",
                             "uid": f"uid-{name}", "annotations": annos},
                "spec": {"nodeName": node, "containers": [{"name": "c"}]},
                "status": {"phase": "Running"}})
            nodelock.lock_node(client, node)
            with grpc.insecure_channel(
                    f"unix://{plugin.socket_path}") as ch:
                resp = dp_grpc.DevicePluginStub(ch).Allocate(
                    pb.AllocateRequest(container_requests=[
                        pb.ContainerAllocateRequest(
                            devicesIDs=[f"{CARD_A}::0"])]))
            env = runtime.process_env(resp.container_responses[0])
            env.update({api.ENV_TASK_PRIORITY: str(priority),
                        "PYTHONPATH": REPO, "PATH": os.environ["PATH"],
                        "LD_LIBRARY_PATH": native.mock_cuda_dir(),
                        "MOCK_CUDA_TOTAL": "1g",
                        "MOCK_CUDA_KERNEL_NS": str(MS)})
            procs[name] = (subprocess.Popen(
                [sys.executable, "-c", LAUNCHER], env=env,
                stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True),
                env[api.ENV_SHARED_CACHE])

        def ask(name, cmd="?"):
            proc = procs[name][0]
            proc.stdin.write(cmd + "\n")
            proc.stdin.flush()
            return json.loads(proc.stdout.readline())["mock"]

        for name in procs:
            ask(name)     # started: attached to its region
        daemon = port_daemon.MonitorDaemon(
            os.path.join(config.shim_host_dir, "containers"),
            gpulib=FakeNvmlLib(chips=[card]), client=client,
            node_name=node, info_port=0)
        daemon.podcache.sync_once()
        daemon.regions.grace_s = 0.0

        def feedback(name):
            with port_region.RegionView(procs[name][1]) as v:
                return v.recent_kernel, v.utilization_switch, v.dev_uuids()

        daemon.sweep_once()
        assert feedback("l") == (FEEDBACK_IDLE, 0, [CARD_A])
        ask("h", "go")
        time.sleep(0.3)
        daemon.sweep_once()
        assert feedback("l")[:2] == (FEEDBACK_BLOCK, 0)
        ask("l", "go")
        time.sleep(0.2)
        held = ask("l")
        time.sleep(0.3)
        assert ask("l") == held            # blocked while h launches
        info = {e["entry"]: e for e in daemon.node_info()["containers"]}
        assert info["uid-h_0"]["priority"] == 0
        assert info["uid-l_0"]["hbm_limit"] == [64 * MB]
        ask("h", "halt")
        procs["h"][0].communicate("exit\n", timeout=30)
        daemon.sweep_once()                # h's last launches
        daemon.sweep_once()
        assert feedback("l")[0] != FEEDBACK_BLOCK
        time.sleep(0.3)
        assert ask("l") > held             # unblocked
        client.delete_pod("default", "h")  # h's dir is GC'd (grace 0) ...
        daemon.podcache.sync_once()
        daemon.sweep_once()
        assert not os.path.exists(os.path.dirname(procs["h"][1]))
        daemon.sweep_once()                # ... and l, alone, released
        rk, switch, _ = feedback("l")
        assert rk != FEEDBACK_BLOCK and switch == 1
        ask("l", "halt")
        procs["l"][0].communicate("exit\n", timeout=30)
        assert all(p.returncode == 0 for p, _ in procs.values())
        with port_region.RegionView(procs["l"][1]) as v:
            assert v.procs() == [] and v.used(0) == 0
    finally:
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
        if daemon is not None:
            daemon.regions.close()
        plugin.stop()
