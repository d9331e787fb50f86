"""The node monitor's scrape A/B, the port of benchmarks/monitor_bench.py
onto vtpu_torch.monitor.

At N synthetic regions (the files libvgpu.so writes) it times the
monitor's two scrape paths:

- **legacy**: a field-for-field replica of the collector before the
  snapshot: every Prometheus ``collect()`` re-scans the containers
  directory, LISTs the node's pods and reads each region field by field
  through its live mmap (O(devices x fields x slots) reads per region,
  the reference's vGPUmonitor shape, metrics.go:140-246);
- **snapshot**: the port's data plane: the sweep copies every region once
  into an immutable snapshot that the collector, the feedback loop and
  ``/nodeinfo`` share, and pod identity comes from the watch-backed
  ``PodCache``: ``collect()`` touches no mmap and makes no apiserver LIST
  in steady state (counted on the in-memory apiserver).

Regions are written through the port's C library (libvgpucore.so), cards
enumerated by ``FakeNvmlLib`` (H100s as NVML names them).

    python -m vtpu_torch.bench.monitor                 # 64 / 256 regions
    python -m vtpu_torch.bench.monitor --regions 256
    python -m vtpu_torch.bench.monitor --smoke         # seconds

One JSON line per region count: both paths' collect() p50, the speedup,
the sweep's cost moved off the scrape, and the steady-state LIST count
(must be 0). The timings are this host's wall clock, printed and never
gated in the tests; the samples both paths export equal the JAX legacy
collector's over the same files (tests/test_torch_benches.py). No torch is
imported.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys
import tempfile
import time
from typing import Dict, List, Optional, Tuple

from prometheus_client.core import CounterMetricFamily, GaugeMetricFamily

from .. import api
from ..enforce.region import SharedRegion, SharedRegionStruct
from ..enforce.region import load_core_library
from ..monitor.daemon import MonitorDaemon
from ..monitor.pathmonitor import ContainerRegions, pod_uid_of_entry
from ..plugin.nvml import ChipInfo, FakeNvmlLib
from ..scheduler.loadtest import CARD_MB, CARD_TYPE
from ..util.client import FakeKubeClient

DEFAULT_SIZES = (64, 256)
NODE = "bench-node"


class LegacyMonitorCollector:
    """The pre-snapshot collector, kept verbatim as the A side: per-scrape
    scan + pod LIST + per-field live RegionView reads. Deliberately NOT
    importing the production class — this replica pins the old behavior
    so the same script measures the same baseline on any commit."""

    def __init__(self, regions, gpulib, client, node_name):
        self.regions = regions
        self.gpulib = gpulib
        self.client = client
        self.node_name = node_name
        self._busy_prev: Dict[str, Tuple[int, float]] = {}
        self._clock = time.monotonic

    def _pod_labels(self):
        out = {}
        pods = (self.client.list_pods_on_node(self.node_name)
                if self.node_name
                else self.client.list_pods_all_namespaces())
        for pod in pods:
            meta = pod.get("metadata", {})
            out[meta.get("uid", "")] = {
                "namespace": meta.get("namespace", "default"),
                "name": meta.get("name", ""),
            }
        return out

    def collect(self):
        host_cap = GaugeMetricFamily(
            "HostGPUMemoryCapacity", "bytes",
            labels=["deviceidx", "deviceuuid"])
        host_mem = GaugeMetricFamily(
            "HostGPUMemoryUsage", "bytes",
            labels=["deviceidx", "deviceuuid"])
        host_util = GaugeMetricFamily(
            "HostCoreUtilization", "pct",
            labels=["deviceidx", "deviceuuid"])
        usage = GaugeMetricFamily(
            "vGPU_device_memory_usage_in_bytes", "bytes",
            labels=["podnamespace", "podname", "poduid", "vdeviceid"])
        limit = GaugeMetricFamily(
            "vGPU_device_memory_limit_in_bytes", "bytes",
            labels=["podnamespace", "podname", "poduid", "vdeviceid"])
        launches = CounterMetricFamily(
            "vGPU_container_program_launches", "count",
            labels=["podnamespace", "podname", "poduid"])
        ooms = CounterMetricFamily(
            "vGPU_container_oom_events", "count",
            labels=["podnamespace", "podname", "poduid"])
        inflight = GaugeMetricFamily(
            "vGPU_container_programs_inflight", "count",
            labels=["podnamespace", "podname", "poduid"])

        chip_used: Dict[str, int] = {}
        chip_busy: Dict[str, int] = {}
        pods = self._pod_labels()
        for name, view in self.regions.scan().items():
            uid = pod_uid_of_entry(name)
            meta = pods.get(uid, {})
            ns = meta.get("namespace", "")
            pname = meta.get("name", "")
            try:
                uuids = view.dev_uuids()
                for dev in range(view.num_devices):
                    used = view.used(dev)
                    usage.add_metric([ns, pname, uid, str(dev)],
                                     float(used))
                    limit.add_metric([ns, pname, uid, str(dev)],
                                     float(view.hbm_limit(dev)))
                    u = uuids[dev] if dev < len(uuids) else ""
                    if u:
                        chip_used[u] = chip_used.get(u, 0) + used
                known = [u for u in uuids if u]
                if known:
                    share = view.busy_ns() // len(known)
                    for u in known:
                        chip_busy[u] = chip_busy.get(u, 0) + share
                launches.add_metric([ns, pname, uid],
                                    float(view.total_launches()))
                ooms.add_metric([ns, pname, uid], float(view.oom_events))
                inflight.add_metric([ns, pname, uid],
                                    float(view.inflight()))
            except Exception:
                continue

        now = self._clock()
        if self.gpulib is not None:
            for chip in self.gpulib.enumerate():
                lbl = [str(chip.index), chip.uuid]
                host_cap.add_metric(lbl, float(chip.hbm_mb) * 1024 * 1024)
                host_mem.add_metric(lbl, float(chip_used.get(chip.uuid, 0)))
                busy = chip_busy.get(chip.uuid, 0)
                prev_busy, prev_t = self._busy_prev.get(
                    chip.uuid, (busy, now))
                dt = now - prev_t
                pct = 0.0
                if dt > 0 and busy > prev_busy:
                    pct = 100.0 * (busy - prev_busy) / (dt * 1e9)
                host_util.add_metric(lbl, min(pct, 100.0))
                self._busy_prev[chip.uuid] = (busy, now)

        return [host_cap, host_mem, host_util, usage, limit, launches,
                ooms, inflight]


def synthesize(containers_dir: str, n: int, chips: List[ChipInfo],
               launches: int = 3) -> None:
    """N regions as the device plugin's Allocate would lay them out,
    written through the real C library (libvgpucore.so) so the bench reads
    genuine ABI; each region's launches and their measured device time
    published as libvgpu.so publishes them (``vtpu_note_batch``)."""
    lib = _core()
    for i in range(n):
        d = os.path.join(containers_dir, f"uid{i}_0")
        os.makedirs(d, exist_ok=True)
        r = SharedRegion(os.path.join(d, api.CACHE_FILENAME))
        r.configure([1 << 30], [50], priority=i % 2,
                    dev_uuids=[chips[i % len(chips)].uuid])
        r.attach()
        r.try_alloc((1 + i % 7) << 20)
        debit = (ctypes.c_uint64 * 16)(launches * 1_000_000)
        lib.vtpu_note_batch(r._ptr, os.getpid(), launches, 0, debit)
        r.close()


def _core():
    """libvgpucore.so with the interposer's batch call declared"""
    lib = load_core_library()
    lib.vtpu_note_batch.restype = None
    lib.vtpu_note_batch.argtypes = [
        ctypes.POINTER(SharedRegionStruct), ctypes.c_int32, ctypes.c_uint64,
        ctypes.c_int32, ctypes.POINTER(ctypes.c_uint64)]
    return lib


def _time_ms(fn, iters: int) -> List[float]:
    out = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e3)
    return sorted(out)


def _p50(samples: List[float]) -> float:
    return samples[len(samples) // 2]


def bench_chips(n: int) -> List[ChipInfo]:
    """the node's cards: H100s as NVML enumerates them"""
    return [ChipInfo(uuid=f"GPU-bench-{i}", index=i, type=CARD_TYPE,
                     hbm_mb=CARD_MB) for i in range(n)]


def bench_pods(n_regions: int) -> List[Dict]:
    """the pods the regions belong to, on the bench's node"""
    return [{"metadata": {"uid": f"uid{i}", "name": f"pod-{i}",
                          "namespace": "bench"},
             "spec": {"nodeName": NODE, "containers": []}}
            for i in range(n_regions)]


def run_case(n_regions: int, iters: int = 20, n_chips: int = 4) -> Dict:
    """One region count: legacy vs snapshot collect() latency, sweep
    cost, and the steady-state apiserver LIST count."""
    chips = bench_chips(n_chips)
    with tempfile.TemporaryDirectory() as tmp:
        cdir = os.path.join(tmp, "containers")
        synthesize(cdir, n_regions, chips)

        def fresh_client() -> FakeKubeClient:
            c = FakeKubeClient()
            for pod in bench_pods(n_regions):
                c.add_pod(pod)
            return c

        # -- A: legacy scrape (per-scrape scan + LIST + live field reads)
        legacy_client = fresh_client()
        legacy_regions = ContainerRegions(cdir)
        legacy = LegacyMonitorCollector(
            legacy_regions, FakeNvmlLib(chips=chips), legacy_client, NODE)
        legacy.collect()  # warm the view table (mmap opens)
        legacy_client.reset_call_counts()
        legacy_ms = _time_ms(lambda: legacy.collect(), iters)
        legacy_lists = legacy_client.list_pod_calls / iters
        legacy_regions.close()

        # -- B: snapshot data plane (sweep publishes, scrape consumes)
        client = fresh_client()
        daemon = MonitorDaemon(cdir, gpulib=FakeNvmlLib(chips=chips),
                               client=client, node_name=NODE, info_port=0)
        daemon.podcache.sync_once()   # the watch thread's priming LIST
        daemon.sweep_once()           # warm + publish
        sweep_ms = _time_ms(lambda: daemon.sweep_once(), iters)
        client.reset_call_counts()
        daemon.sweep_once()
        snap_ms = _time_ms(lambda: daemon.collector.collect(), iters)
        daemon.node_info()
        steady_lists = client.list_pod_calls
        daemon.regions.close()

    res = {
        "metric": "monitor_scrape",
        "regions": n_regions,
        "iters": iters,
        "legacy_collect_ms_p50": round(_p50(legacy_ms), 3),
        "snapshot_collect_ms_p50": round(_p50(snap_ms), 3),
        "collect_speedup": round(_p50(legacy_ms) / _p50(snap_ms), 2)
        if _p50(snap_ms) else None,
        "sweep_ms_p50": round(_p50(sweep_ms), 3),
        "legacy_lists_per_scrape": round(legacy_lists, 2),
        "steady_state_list_calls": steady_lists,
        "unit": "ms/collect",
    }
    return res


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--regions", default=None,
                    help="comma-separated region counts "
                         f"(default {','.join(map(str, DEFAULT_SIZES))})")
    ap.add_argument("--iters", type=int, default=None,
                    help="timed collect() calls per path (default 20)")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny fast run (16 regions, 5 iters); explicit "
                         "flags still override")
    args = ap.parse_args(argv)
    sizes = ([int(x) for x in args.regions.split(",")] if args.regions
             else [16] if args.smoke else list(DEFAULT_SIZES))
    iters = (args.iters if args.iters is not None
             else 5 if args.smoke else 20)
    for n in sizes:
        print(json.dumps(run_case(n, iters=iters)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
