"""Prometheus collector for the node monitor (:9394).

The port's copy of vtpu/monitor/metrics.py. Its families carry the
reference's own NVIDIA names where it has them (cmd/vGPUmonitor/
metrics.go:61-91 descriptors, 140-246 Collect): HostGPUMemoryUsage and
HostCoreUtilization per card from NVML's inventory, and per container
vGPU_device_memory_{usage,limit}_in_bytes plus launch/oom counters from the
mmap'd shared regions libvgpu.so writes. Every other family of the JAX
collector is exported under its JAX name with ``vTPU`` → ``vGPU`` and
``HBM`` → ``GPUMemory``; :data:`METRIC_NAMES` maps each JAX family to the
port's.

Data plane (docs/monitoring.md): the collector consumes the sweep's
published :class:`~vtpu.monitor.pathmonitor.RegionSetSnapshot` — one bulk
copy per region per sweep — so a scrape touches neither the mmaps nor the
region-table lock, and pod identity comes from the watch-backed
:class:`~vtpu.util.podcache.PodCache` instead of a per-scrape LIST
(the reference lists pods on every Collect, metrics.go:150-158). Run
standalone (no daemon wiring) it degrades to self-snapshotting and a
node-scoped LIST; the cluster-wide LIST of an unset node_name is loudly
rate-limited, never silent.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Dict, List, Optional, Tuple

from prometheus_client import Histogram
from prometheus_client.core import (CounterMetricFamily, GaugeMetricFamily,
                                    HistogramMetricFamily)
from prometheus_client.registry import Collector

from .. import api
from ..enforce.region import (PROF_CALLSITE_NAMES, PROF_PRESSURE_NAMES,
                              prof_bucket_bounds)
from ..plugin.nvml import GpuLib
from ..util.client import KubeClient
from ..util.env import env_bool, env_float
from ..util.podcache import PodCache
from .feedback import INFLIGHT_FRESH_NS
from .pathmonitor import ContainerRegions, RegionSetSnapshot, pod_uid_of_entry

log = logging.getLogger("vtpu_torch.monitor")

#: every metric family the JAX monitor's process exports (the collector's,
#: the module-level ones of the sweep, the host guard, the resize applier
#: and the drain coordinator, the tracer's stage histogram and the degraded
#: gauge) -> the port's family. A process that imports both packages
#: registers both sets in one Prometheus registry, so no port family may
#: keep a JAX name.
METRIC_NAMES = {
    "HostHBMMemoryCapacity": "HostGPUMemoryCapacity",
    "HostHBMMemoryUsage": "HostGPUMemoryUsage",
    "HostCoreUtilization": "HostCoreUtilization",
    "vTPU_device_memory_usage_in_bytes": "vGPU_device_memory_usage_in_bytes",
    "vTPU_device_memory_limit_in_bytes": "vGPU_device_memory_limit_in_bytes",
    "vTPU_container_program_launches": "vGPU_container_program_launches",
    "vTPU_container_oom_events": "vGPU_container_oom_events",
    "vTPU_container_programs_inflight": "vGPU_container_programs_inflight",
    "vTPUMonitorSnapshotAge": "vGPUMonitorSnapshotAge",
    "vTPUMonitorQuarantinedRegions": "vGPUMonitorQuarantinedRegions",
    "vTPUMonitorRegionCorruptEvents": "vGPUMonitorRegionCorruptEvents",
    "vTPUShimStale": "vGPUShimStale",
    "vTPUShimHeartbeatAge": "vGPUShimHeartbeatAge",
    "vTPUShimCallsiteLatency": "vGPUShimCallsiteLatency",
    "vTPUShimCallsiteCalls": "vGPUShimCallsiteCalls",
    "vTPUShimCallsiteErrors": "vGPUShimCallsiteErrors",
    "vTPUShimQuotaPressure": "vGPUShimQuotaPressure",
    "vTPUShimPodSeconds": "vGPUShimPodSeconds",
    "vTPUShimPodQuotaPressure": "vGPUShimPodQuotaPressure",
    "vTPUPodHBMLimit": "vGPUPodGPUMemoryLimit",
    "vTPUPodResizeGeneration": "vGPUPodResizeGeneration",
    "vTPUHostMemUsed": "vGPUHostMemUsed",
    "vTPUHostMemLimit": "vGPUHostMemLimit",
    "vTPUHostMemOOMEvents": "vGPUHostMemOOMEvents",
    "vTPUPodCacheRelists": "vGPUPodCacheRelists",
    "vTPUPodCacheSynced": "vGPUPodCacheSynced",
    "vTPUPodCachePods": "vGPUPodCachePods",
    "vTPUMonitorSweepLatency": "vGPUMonitorSweepLatency",
    "vTPUHostQuotaOver": "vGPUHostQuotaOver",
    "vTPUHostQuotaBlocked": "vGPUHostQuotaBlocked",
    "vTPUHostQuotaUnblocked": "vGPUHostQuotaUnblocked",
    "vTPUResizeApplied": "vGPUResizeApplied",
    "vTPUResizeRefused": "vGPUResizeRefused",
    "vTPUResizeClamped": "vGPUResizeClamped",
    "vTPUResizeBlocked": "vGPUResizeBlocked",
    "vTPUMigrateDrainsRequested": "vGPUMigrateDrainsRequested",
    "vTPUMigrateSnapshotsAcked": "vGPUMigrateSnapshotsAcked",
    "vTPUMigrateDrainsRefused": "vGPUMigrateDrainsRefused",
    "vTPUSchedulingStageLatency": "vGPUSchedulingStageLatency",
    "vTPUNodeDegraded": "vGPUNodeDegraded",
}

# One observation per sweep (scan + snapshot + feedback + GC). Buckets
# span "a handful of regions" (~1ms) to "the sweep is starving the 5s
# cadence" (seconds).
SWEEP_LATENCY = Histogram(
    "vGPUMonitorSweepLatency",
    "monitor sweep (region scan+snapshot, feedback, GC) latency in seconds",
    buckets=(0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
             0.5, 1.0, 2.5, 5.0),
)

#: minimum spacing of the cluster-wide LIST fallback (node_name unset,
#: no pod cache); between refreshes scrapes serve the cached labels
LIST_FALLBACK_MIN_S = env_float(api.ENV_MONITOR_LIST_FALLBACK_S, 30.0,
                                minimum=0.0)

#: monitor-side gate on the v6 shim-profile export (docs/shim-profiling.md).
#: Off, scrapes skip the vGPUShimCallsite*/vGPUShimQuotaPressure families
#: (a fleet can dark-launch the shim-side recording without growing its
#: Prometheus cardinality); the staleness gauge below stays — it rides the
#: v5 heartbeat, not the profile block.
PROFILE_EXPORT = env_bool(api.ENV_MONITOR_PROFILE_EXPORT, True)

#: heartbeat age past which a LIVE region (attached processes) counts as
#: stale — SIGSTOPped or wedged workload. The shim heartbeats every 5s;
#: 30s tolerates scheduler hiccups and one missed beat, not a stopped
#: process.
SHIM_STALE_S = env_float(api.ENV_SHIM_STALE_S, 30.0, minimum=1.0)

#: vGPUShimCallsiteLatency bucket upper bounds in SECONDS, derived from
#: the same log2 header constants the C writer bins with
_LATENCY_BOUNDS_S = [b / 1e9 for b in prof_bucket_bounds()[:-1]]


def split_busy_ns(busy_ns: int, chips: List[str]) -> Dict[str, int]:
    """Split a container's cumulative busy-ns over its chips CONSERVING
    the sum: `busy // n` each, remainder to the lexicographically first
    chip. Deterministic across scrapes so the duty-cycle gauge (which
    diffs per-chip busy between collects) never sees the remainder hop
    chips; flooring alone dropped up to n-1 ns per container per scrape,
    a per-chip undercount that drifts forever."""
    out: Dict[str, int] = {}
    if not chips:
        return out
    share, rem = divmod(busy_ns, len(chips))
    for u in chips:
        out[u] = out.get(u, 0) + share
    out[min(chips)] += rem
    return out


class MonitorCollector(Collector):
    def __init__(self, regions: ContainerRegions,
                 gpulib: Optional[GpuLib] = None,
                 client: Optional[KubeClient] = None,
                 node_name: str = "",
                 snapshots: Optional[Callable[[], RegionSetSnapshot]] = None,
                 pod_cache: Optional[PodCache] = None,
                 resize_gens: Optional[Callable[[str], int]] = None):
        self.regions = regions
        self.gpulib = gpulib
        self.client = client
        self.node_name = node_name
        #: sweep-published snapshot source (wired by MonitorDaemon);
        #: None → self-snapshot per collect (standalone use)
        self._snapshots = snapshots
        self.pod_cache = pod_cache
        #: entry name → applied resize generation (the daemon wires the
        #: ResizeApplier's gen_of; None → the generation gauge is 0)
        self._resize_gens = resize_gens
        # per-chip (busy_ns, wall_ts) from the previous collect, for the
        # duty-cycle gauge (utilization = Δbusy / Δwall)
        self._busy_prev: Dict[str, Tuple[int, float]] = {}
        self._clock = time.monotonic
        # cluster-wide LIST fallback guard state
        self._fallback_labels: Dict[str, Dict[str, str]] = {}
        self._fallback_next = 0.0
        self._fallback_warned = False

    def _pod_labels(self) -> Dict[str, Dict[str, str]]:
        """podUID → {namespace, name} for pods on this node.

        Preference order: the watch-backed pod cache (zero apiserver
        calls), a node-scoped LIST (standalone collector with a node
        name), and last a cluster-wide LIST — the reference's per-scrape
        behavior (metrics.go:150-158) — which is logged loudly once and
        rate-limited to LIST_FALLBACK_MIN_S, serving cached labels in
        between: an unset node_name must never silently turn every
        scrape into O(cluster) apiserver load."""
        cache = self.pod_cache
        if cache is not None and cache.synced:
            return cache.labels(self.node_name or None)
        if self.client is None:
            return {}
        try:
            if self.node_name:
                return self._labels_of(
                    self.client.list_pods_on_node(self.node_name))
            now = self._clock()
            if now < self._fallback_next:
                return self._fallback_labels
            if not self._fallback_warned:
                self._fallback_warned = True
                log.warning(
                    "node_name is unset and no pod cache is wired: pod "
                    "labels need a CLUSTER-WIDE pod list; rate-limiting "
                    "it to every %.0fs — set NODE_NAME/--node-name to "
                    "scope the lookup", LIST_FALLBACK_MIN_S)
            self._fallback_labels = self._labels_of(
                self.client.list_pods_all_namespaces())
            self._fallback_next = now + LIST_FALLBACK_MIN_S
            return self._fallback_labels
        except Exception as e:  # metrics must not crash on apiserver blips
            log.warning("pod lookup failed: %s", e)
            return {}

    @staticmethod
    def _labels_of(pods) -> Dict[str, Dict[str, str]]:
        out: Dict[str, Dict[str, str]] = {}
        for pod in pods:
            meta = pod.get("metadata", {})
            out[meta.get("uid", "")] = {
                "namespace": meta.get("namespace", "default"),
                "name": meta.get("name", ""),
            }
        return out

    def _snapshot_set(self) -> RegionSetSnapshot:
        if self._snapshots is not None:
            return self._snapshots()
        snapset, _views = self.regions.scan_snapshots()
        return snapset

    def collect(self):
        host_cap = GaugeMetricFamily(
            "HostGPUMemoryCapacity",
            "device memory capacity per physical card in bytes",
            labels=["deviceidx", "deviceuuid"])
        host_mem = GaugeMetricFamily(
            "HostGPUMemoryUsage",
            "device memory in use per physical card in bytes (sum of the vGPU "
            "shared-region charges of every container on the chip)",
            labels=["deviceidx", "deviceuuid"])
        host_util = GaugeMetricFamily(
            "HostCoreUtilization",
            "per-chip tensorcore duty cycle percent since the previous "
            "scrape (from the shims' measured program durations)",
            labels=["deviceidx", "deviceuuid"])
        usage = GaugeMetricFamily(
            "vGPU_device_memory_usage_in_bytes",
            "per-container vGPU device-memory usage",
            labels=["podnamespace", "podname", "poduid", "vdeviceid"])
        limit = GaugeMetricFamily(
            "vGPU_device_memory_limit_in_bytes",
            "per-container vGPU device-memory quota",
            labels=["podnamespace", "podname", "poduid", "vdeviceid"])
        launches = CounterMetricFamily(
            "vGPU_container_program_launches",
            "programs dispatched by a container since attach",
            labels=["podnamespace", "podname", "poduid"])
        ooms = CounterMetricFamily(
            "vGPU_container_oom_events",
            "allocations rejected by the device-memory quota",
            labels=["podnamespace", "podname", "poduid"])
        inflight = GaugeMetricFamily(
            "vGPU_container_programs_inflight",
            "programs dispatched but not yet complete (live heartbeats "
            "only: slots of SIGKILLed processes age out)",
            labels=["podnamespace", "podname", "poduid"])
        snap_age = GaugeMetricFamily(
            "vGPUMonitorSnapshotAge",
            "age in seconds of the region snapshot set this scrape "
            "served (published by the sweep loop; growth beyond the "
            "sweep interval means the sweep is stalled)")
        quarantined = GaugeMetricFamily(
            "vGPUMonitorQuarantinedRegions",
            "region cache files currently quarantined as corrupt "
            "(wrong magic/version, truncation, header-checksum "
            "mismatch); a quarantined region contributes ZERO to every "
            "other family — no partial numbers")
        corrupt = CounterMetricFamily(
            "vGPUMonitorRegionCorruptEvents",
            "definitive region-corruption observations (each failed "
            "parse before and including the quarantining one)")
        # v6 shim hot-path profile plane (docs/shim-profiling.md).
        # Quarantined regions contribute ZERO here exactly as everywhere
        # else: they never reach the snapshot set this loop walks.
        stale = GaugeMetricFamily(
            "vGPUShimStale",
            "1 when a region with attached shim processes has not "
            "heartbeat for VTPU_SHIM_STALE_S — a SIGSTOPped or wedged "
            "workload still holding quota (invisible before v6)",
            labels=["podnamespace", "podname", "poduid"])
        hb_age = GaugeMetricFamily(
            "vGPUShimHeartbeatAge",
            "seconds since any shim process in the container heartbeat "
            "its shared region",
            labels=["podnamespace", "podname", "poduid"])
        cs_lat = HistogramMetricFamily(
            "vGPUShimCallsiteLatency",
            "shim-side latency of one intercepted PJRT callsite class "
            "in seconds (log2 buckets from the shared-region profile "
            "block; counts cover the 1-in-N latency-sampled events — "
            "vGPUShimCallsiteCalls has the exact volumes), aggregated "
            "over this node's regions",
            labels=["callsite"])
        cs_calls = CounterMetricFamily(
            "vGPUShimCallsiteCalls",
            "intercepted PJRT calls per callsite class (exact, "
            "unsampled), aggregated over this node's regions",
            labels=["callsite"])
        cs_errors = CounterMetricFamily(
            "vGPUShimCallsiteErrors",
            "failed intercepted PJRT calls per callsite class (quota "
            "rejections + real-plugin errors)",
            labels=["callsite"])
        pressure = CounterMetricFamily(
            "vGPUShimQuotaPressure",
            "quota-pressure signals from the shim charge path: "
            "charge_retries, contention_spins, at_limit_ns, "
            "near_limit_failures — why short-step workloads tax",
            labels=["kind"])
        pod_shim_s = GaugeMetricFamily(
            "vGPUShimPodSeconds",
            "estimated cumulative shim-side time per pod per callsite "
            "class in seconds (sampled time scaled to the full call "
            "population; the scaling makes it non-monotonic, so it is "
            "a gauge — compare values, don't rate())",
            labels=["podnamespace", "podname", "poduid", "callsite"])
        pod_pressure = CounterMetricFamily(
            "vGPUShimPodQuotaPressure",
            "per-pod quota-pressure counters (same kinds as "
            "vGPUShimQuotaPressure)",
            labels=["podnamespace", "podname", "poduid", "kind"])
        # elastic quotas (docs/elastic-quotas.md): the resize surface.
        # vGPUPodGPUMemoryLimit is the LIVE per-device limit the checked
        # resize API maintains (the vGPU_device_memory_limit family
        # keeps its reference-inherited name; this one pairs with the
        # resize generation for the dashboard's elastic-quota row).
        pod_limit = GaugeMetricFamily(
            "vGPUPodGPUMemoryLimit",
            "per-pod effective device-memory limit in bytes by visible-device "
            "index (live — reflects every applied resize)",
            labels=["podnamespace", "podname", "poduid", "vdeviceid"])
        pod_resize_gen = GaugeMetricFamily(
            "vGPUPodResizeGeneration",
            "generation of the last resize intent applied (exactly or "
            "clamped) to the pod's shared region; 0 = never resized",
            labels=["podnamespace", "podname", "poduid"])
        # v8 host-memory ledger (docs/adr-oversubscription.md closing
        # note): the cooperative-offload quota dimension — bytes of
        # PJRT host-memory-space placements vs the pod's
        # vtpu.io/host-memory cap, plus rejected/over events
        host_used_fam = GaugeMetricFamily(
            "vGPUHostMemUsed",
            "per-pod host-memory bytes pinned through PJRT "
            "host-memory-space placements (the v8 shared-region host "
            "ledger)",
            labels=["podnamespace", "podname", "poduid"])
        host_limit_fam = GaugeMetricFamily(
            "vGPUHostMemLimit",
            "per-pod host-memory cap in bytes (vtpu.io/host-memory; "
            "0 = unlimited legacy mode)",
            labels=["podnamespace", "podname", "poduid"])
        host_ooms = CounterMetricFamily(
            "vGPUHostMemOOMEvents",
            "host allocations rejected by the host quota plus force "
            "charges that pushed usage over it",
            labels=["podnamespace", "podname", "poduid"])

        snapset = self._snapshot_set()
        quarantined.add_metric(
            [], float(len(self.regions.quarantined)))
        corrupt.add_metric([], float(self.regions.corrupt_events))
        snap_age.add_metric(
            [], max(0.0, self._clock() - snapset.taken_monotonic))

        # -- per-container scrape, accumulating per-chip usage/busy -------
        chip_used: Dict[str, int] = {}   # chip uuid -> bytes in use
        chip_busy: Dict[str, int] = {}   # chip uuid -> cumulative busy ns
        # node-level profile aggregation: callsite -> [calls, errors,
        # sampled_total_ns, hist-vector]; pressure kind -> count
        prof_acc: Dict[str, list] = {}
        pressure_acc: Dict[str, int] = {}
        pods = self._pod_labels()
        for name, snap in snapset.snapshots.items():
            uid = pod_uid_of_entry(name)
            meta = pods.get(uid, {})
            ns = meta.get("namespace", "")
            pname = meta.get("name", "")
            uuids = snap.dev_uuids()
            pod_resize_gen.add_metric(
                [ns, pname, uid],
                float(self._resize_gens(name))
                if self._resize_gens is not None else 0.0)
            for dev in range(snap.num_devices):
                used = snap.used(dev)
                usage.add_metric([ns, pname, uid, str(dev)],
                                 float(used))
                limit.add_metric([ns, pname, uid, str(dev)],
                                 float(snap.hbm_limit(dev)))
                pod_limit.add_metric([ns, pname, uid, str(dev)],
                                     float(snap.hbm_limit(dev)))
                u = uuids[dev] if dev < len(uuids) else ""
                if u:
                    chip_used[u] = chip_used.get(u, 0) + used
            # busy time is tracked per process, not per device: split it
            # over the container's chips conserving the sum (exact for
            # the common single-chip container)
            known = [u for u in uuids if u]
            if known:
                for u, share in split_busy_ns(snap.busy_ns(),
                                              known).items():
                    chip_busy[u] = chip_busy.get(u, 0) + share
            launches.add_metric([ns, pname, uid],
                                float(snap.total_launches()))
            ooms.add_metric([ns, pname, uid], float(snap.oom_events))
            # v8 host ledger: zeros exported on purpose so a tenant's
            # first host byte / first rejection is visible to
            # increase()
            host_used_fam.add_metric([ns, pname, uid],
                                     float(snap.host_used()))
            host_limit_fam.add_metric([ns, pname, uid],
                                      float(snap.host_limit()))
            host_ooms.add_metric([ns, pname, uid],
                                 float(snap.host_oom_events))
            # same freshness window as the feedback loop: a SIGKILLed
            # process's tombstone slot must not gauge as in-flight forever
            inflight.add_metric(
                [ns, pname, uid],
                float(snap.inflight(max_age_ns=INFLIGHT_FRESH_NS)))
            # v6 staleness: a region with live processes whose heartbeat
            # stopped advancing — SIGSTOPped/wedged, holding quota
            age = snap.header_heartbeat_age_s()
            hb_age.add_metric([ns, pname, uid], age)
            stale.add_metric(
                [ns, pname, uid],
                1.0 if (snap.procs() and age > SHIM_STALE_S) else 0.0)
            if PROFILE_EXPORT:
                for cs_name, st in snap.prof.items():
                    if st.calls:
                        pod_shim_s.add_metric([ns, pname, uid, cs_name],
                                              st.est_total_ns / 1e9)
                    acc = prof_acc.get(cs_name)
                    if acc is None:
                        acc = prof_acc[cs_name] = [0, 0, 0,
                                                   [0] * len(st.hist)]
                    acc[0] += st.calls
                    acc[1] += st.errors
                    acc[2] += st.total_ns
                    hist = acc[3]
                    for b, v in enumerate(st.hist):
                        hist[b] += v
                # zeros exported on purpose (like the node family): a
                # series born at its first nonzero value is invisible
                # to increase()/rate()
                for kind, v in snap.pressure.items():
                    pressure_acc[kind] = pressure_acc.get(kind, 0) + v
                    pod_pressure.add_metric([ns, pname, uid, kind],
                                            float(v))

        # -- host-side chip gauges ---------------------------------------
        now = self._clock()
        if self.gpulib is not None:
            try:
                for chip in self.gpulib.enumerate():
                    lbl = [str(chip.index), chip.uuid]
                    host_cap.add_metric(
                        lbl, float(chip.hbm_mb) * 1024 * 1024)
                    host_mem.add_metric(
                        lbl, float(chip_used.get(chip.uuid, 0)))
                    busy = chip_busy.get(chip.uuid, 0)
                    prev_busy, prev_t = self._busy_prev.get(
                        chip.uuid, (busy, now))
                    dt = now - prev_t
                    pct = 0.0
                    if dt > 0 and busy > prev_busy:
                        pct = 100.0 * (busy - prev_busy) / (dt * 1e9)
                    host_util.add_metric(lbl, min(pct, 100.0))
                    self._busy_prev[chip.uuid] = (busy, now)
            except Exception as e:
                log.warning("card enumeration failed: %s", e)

        fams = [host_cap, host_mem, host_util, usage, limit, launches,
                ooms, inflight, snap_age, quarantined, corrupt,
                stale, hb_age, pod_limit, pod_resize_gen,
                host_used_fam, host_limit_fam, host_ooms]

        # -- node-level profile rollup ------------------------------------
        if PROFILE_EXPORT:
            for cs_name in PROF_CALLSITE_NAMES:
                acc = prof_acc.get(cs_name)
                if acc is None or not acc[0]:
                    continue
                calls, errors, total_ns, hist = acc
                cs_calls.add_metric([cs_name], float(calls))
                cs_errors.add_metric([cs_name], float(errors))
                cum, buckets = 0, []
                for b, bound in enumerate(_LATENCY_BOUNDS_S):
                    cum += hist[b]
                    buckets.append((repr(bound), float(cum)))
                cum += hist[len(_LATENCY_BOUNDS_S)]
                buckets.append(("+Inf", float(cum)))
                cs_lat.add_metric([cs_name], buckets,
                                  sum_value=total_ns / 1e9)
            for kind in PROF_PRESSURE_NAMES:
                pressure.add_metric([kind],
                                    float(pressure_acc.get(kind, 0)))
            fams += [cs_lat, cs_calls, cs_errors, pressure,
                     pod_shim_s, pod_pressure]

        # -- pod-cache health ---------------------------------------------
        cache = self.pod_cache
        if cache is not None:
            relists = CounterMetricFamily(
                "vGPUPodCacheRelists",
                "full pod LISTs issued by the watch-backed pod cache "
                "(priming + GoneError/failure recovery; growth in steady "
                "state means the watch stream keeps dying)")
            relists.add_metric([], float(cache.relists))
            synced = GaugeMetricFamily(
                "vGPUPodCacheSynced",
                "1 once the pod cache completed its priming list")
            synced.add_metric([], 1.0 if cache.synced else 0.0)
            npods = GaugeMetricFamily(
                "vGPUPodCachePods", "pods currently held by the pod cache")
            npods.add_metric([], float(len(cache)))
            fams += [relists, synced, npods]

        return fams
