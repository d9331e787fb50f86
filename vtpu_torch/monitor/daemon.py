"""Monitor daemon wiring: metrics HTTP + node-info API + 5s feedback/GC sweep.

The port's copy of vtpu/monitor/daemon.py, over the regions libvgpu.so
writes and NVML's card inventory (it holds no CUDA context). Entry point:
``python -m vtpu_torch.monitor``.

Reference: cmd/vGPUmonitor/main.go:11-32 runs initmetrics (:9394) and
watchAndFeedback (5s loop) side by side, plus a NodeVGPUInfo gRPC service
on :9395 whose server is UNIMPLEMENTED (pathmonitor.go:122-124 — a
greeting-sample-derived stub nothing consumes). The TPU rebuild replaces
that vestigial stub with a working JSON endpoint (``GET /nodeinfo`` on
the info port): the same per-pod shared-region snapshot the proto
promised (noderpc.proto:25-58 — limits, per-process usage slots), as
machine-readable JSON.

Telemetry data plane (docs/monitoring.md): each sweep bulk-copies every
region ONCE into an immutable RegionSetSnapshot and pre-serializes the
/nodeinfo JSON (with an ETag); the Prometheus collector, the feedback
loop's reads, and the info endpoint all consume that one snapshot, so
scrapes never touch the mmaps. Pod liveness/identity comes from a
watch-backed PodCache — steady state performs ZERO apiserver LISTs
(the reference's monitor lists pods per metrics cycle instead,
cmd/vGPUmonitor/metrics.go:150-158).
"""

from __future__ import annotations

import hashlib
import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional, Tuple

from prometheus_client import start_http_server
from prometheus_client.core import REGISTRY

from ..plugin.nvml import GpuLib
from ..util import lockdebug, types
from ..util.client import KubeClient
from ..util.health import DegradedState, readyz_payload
from ..util.podcache import PodCache
from . import metrics
from .feedback import FeedbackLoop
from .hostguard import HostLedgerGuard
from .metrics import SWEEP_LATENCY, MonitorCollector
from .migrate import DrainCoordinator
from .pathmonitor import (ContainerRegions, RegionSetSnapshot,
                          pod_uid_of_entry)
from .resize import ResizeApplier

log = logging.getLogger("vtpu_torch.monitor")

METRICS_PORT = 9394
INFO_PORT = 9395  # the reference's monitor gRPC port (noderpc)
# /nodeinfo reports per-pod pids, limits and usage: bind loopback unless
# the operator opts in (--info-bind 0.0.0.0 + a NetworkPolicy); the
# reference's analogous gRPC service was an unimplemented stub, so an
# all-interfaces default here would be a brand-new unauthenticated
# exposure
INFO_BIND = "127.0.0.1"
SWEEP_INTERVAL_S = 5.0
# GC only acts on a pod cache at most this stale; past it, pod liveness
# is unknowable and the sweep relists (degrading to the old
# LIST-per-sweep behavior, never worse) before touching any dir
GC_CACHE_MAX_AGE_S = 120.0


class MonitorDaemon:
    def __init__(self, containers_dir: str,
                 gpulib: Optional[GpuLib] = None,
                 client: Optional[KubeClient] = None,
                 node_name: str = "",
                 metrics_port: int = METRICS_PORT,
                 info_port: int = INFO_PORT,
                 info_bind: str = INFO_BIND,
                 sweep_interval_s: float = SWEEP_INTERVAL_S,
                 pod_cache: Optional[PodCache] = None):
        self.regions = ContainerRegions(containers_dir)
        # elastic quotas (docs/elastic-quotas.md): applies annotation
        # resize intents through the checked region API with atomicio
        # crash-replay records; the feedback loop consults its blocked
        # set so uncooperative shrinks hold the throttle engaged
        self.resizer = ResizeApplier(self.regions,
                                     annos_of=self._pod_annotations)
        # host-memory guard (docs/adr-oversubscription.md closing note):
        # clamp -> VTPU_HOST_GRACE_S grace -> feedback blocking for
        # offloaders whose host ledger stands over its quota
        self.hostguard = HostLedgerGuard(self.regions)
        # live migration (docs/migration.md): turns the scheduler's
        # durable migrating-to stamp into the workload drain handshake
        # (crash-replayed sidecar files) and quiesces drained sources
        # until cutover via the feedback loop's blocked set
        self.drains = DrainCoordinator(self.regions,
                                       annos_of=self._pod_annotations)
        self.feedback = FeedbackLoop(
            resize_blocked=self.resizer.resize_blocked,
            host_blocked=self.hostguard.host_blocked,
            preempt_blocked=self._preempt_blocked,
            migrate_blocked=self.drains.migrate_blocked)
        # degraded-mode surface (docs/node-resilience.md): /readyz flips
        # 503 and vGPUNodeDegraded{reason} rises while any reason holds
        self.degraded = DegradedState("monitor")
        self.client = client
        self.node_name = node_name
        if pod_cache is None and client is not None:
            pod_cache = PodCache(client, node_name=node_name)
        self.podcache = pod_cache
        self.collector = MonitorCollector(
            self.regions, gpulib=gpulib, client=client, node_name=node_name,
            snapshots=self.latest_snapshot, pod_cache=self.podcache,
            resize_gens=self.resizer.gen_of)
        self.metrics_port = metrics_port
        self.info_port = info_port
        self.info_bind = info_bind
        self.sweep_interval_s = sweep_interval_s
        self._stop = threading.Event()
        self._info_server: Optional[ThreadingHTTPServer] = None
        # sweep-published telemetry (one writer: the sweep loop; many
        # lock-free-after-copy readers: scrapes and /nodeinfo)
        self._snap_lock = lockdebug.lock("monitor.snapshot")
        self._snapset: Optional[RegionSetSnapshot] = None
        self._nodeinfo_body: bytes = b""
        self._nodeinfo_etag: str = ""

    def _pod_annotations(self, uid: str) -> Optional[dict]:
        """uid → pod annotations from the watch-backed cache (None on
        miss / no cache) — the resize applier's intent source."""
        cache = self.podcache
        if cache is None:
            return None
        pod = cache.get(uid)
        if pod is None:
            return None
        return pod.get("metadata", {}).get("annotations")

    def _preempt_blocked(self, entry: str) -> bool:
        """True while `entry`'s pod carries the durable preemption
        stamp (vtpu.io/preempted-by): the feedback loop blocks the
        dying victim's launches until kubelet tears it down — the
        bridge between the scheduler's eviction decision and the
        node's actual teardown (docs/multihost.md ADR). Once the pod
        object is deleted the cache drops it and the ordinary region
        GC owns the remainder."""
        annos = self._pod_annotations(pod_uid_of_entry(entry))
        return bool(annos and annos.get(types.PREEMPTED_BY_ANNO))

    # ------------------------------------------------------------------
    # snapshot publication
    # ------------------------------------------------------------------

    def latest_snapshot(self) -> RegionSetSnapshot:
        """The sweep-published snapshot set; refreshed on demand only
        when none exists yet or the sweep loop has visibly stalled
        (> 2 sweep intervals) — the steady-state scrape path is a plain
        read."""
        with self._snap_lock:
            snapset = self._snapset
        if snapset is not None:
            max_age = max(2.0 * self.sweep_interval_s, 1.0)
            if time.monotonic() - snapset.taken_monotonic <= max_age:
                return snapset
        return self.refresh_snapshot()

    def refresh_snapshot(self) -> RegionSetSnapshot:
        snapset, _views = self.regions.scan_snapshots()
        self._publish(snapset)
        return snapset

    def _publish(self, snapset: RegionSetSnapshot) -> None:
        body = json.dumps(self._render_nodeinfo(snapset)).encode()
        # strong ETag over the serialized snapshot: identical telemetry
        # between sweeps (the common idle case) → 304, no body
        etag = '"' + hashlib.sha256(body).hexdigest()[:32] + '"'
        with self._snap_lock:
            self._snapset = snapset
            self._nodeinfo_body = body
            self._nodeinfo_etag = etag

    # ------------------------------------------------------------------
    # node-info API
    # ------------------------------------------------------------------

    def _render_nodeinfo(self, snapset: RegionSetSnapshot) -> dict:
        """Per-container shared-region snapshot (the working analog of
        the reference's never-implemented NodeVGPUInfo gRPC reply —
        noderpc.proto:37-58 podusage/sharedRegionT), enriched with the
        pod cache's namespace/name."""
        cache = self.podcache
        entries = []
        for name in sorted(snapset.snapshots):
            s = snapset.snapshots[name]
            uid = pod_uid_of_entry(name)
            meta = (cache.meta(uid) if cache is not None else None) or {}
            # v6 profile summary (docs/shim-profiling.md): per-callsite
            # counters + percentile estimates + quota pressure; consumed
            # by `vtpuprof --scrape` for the fleet-wide table. Same gate
            # as the Prometheus families.
            profile = (s.profile_summary()
                       if metrics.PROFILE_EXPORT else None)
            entries.append({
                "entry": name,
                "pod_uid": uid,
                "pod_namespace": meta.get("namespace", ""),
                "pod_name": meta.get("name", ""),
                "pod_phase": meta.get("phase", ""),
                "num_devices": s.num_devices,
                "priority": s.priority,
                "hbm_limit": [s.hbm_limit(d)
                              for d in range(s.num_devices)],
                "core_limit": [s.core_limit(d)
                               for d in range(s.num_devices)],
                "hbm_used": [s.used(d) for d in range(s.num_devices)],
                "dev_uuids": s.dev_uuids(),
                "oom_events": s.oom_events,
                "total_launches": s.total_launches(),
                "recent_kernel": s.recent_kernel,
                "utilization_switch": s.utilization_switch,
                # raw stamp + thresholded flag, NOT a per-render age: an
                # age field would change every sweep and defeat the
                # idle-body ETag 304 (the stamp only moves while a shim
                # heartbeats, i.e. when the body moves anyway)
                "header_heartbeat_ns": s.header_heartbeat_ns,
                "shim_stale": bool(
                    s.procs() and s.header_heartbeat_age_s()
                    > metrics.SHIM_STALE_S),
                # elastic quotas: generation of the last resize intent
                # that reached this region + its protocol state. Both
                # move only on resize events, so the idle-body ETag 304
                # discipline is preserved (hbm_limit above is already
                # the LIVE limit the resize rewrote).
                "resize_gen": self.resizer.gen_of(name),
                "resize_state": self.resizer.state_of(name),
                # v8 host-memory ledger + guard state ('' / 'over' /
                # 'blocked'): the rebalancer's host-headroom check and
                # `vtpuprof --scrape` read these. All move only on
                # ledger/guard events, preserving the ETag 304.
                "host_limit": s.host_limit(),
                "host_used": s.host_used(),
                "host_oom_events": s.host_oom_events,
                "host_state": self.hostguard.state_of(name),
                # live migration: drain generation + handshake phase
                # ('' / 'draining' / 'snapshotted' / 'refused'). Both
                # move only on protocol events (stamp seen, ack
                # observed, stamp cleared), preserving the ETag 304;
                # the scheduler's planner polls these to drive cutover.
                "migrate_gen": self.drains.gen_of(name),
                "migrate_state": self.drains.state_of(name),
                "profile": profile,
                "procs": [{
                    "pid": p.pid,
                    "hbm_used": p.hbm_used,
                    "launches": p.launches,
                    "inflight": p.inflight,
                } for p in s.procs()],
            })
        return {"node": self.node_name, "sweep_seq": snapset.sweep_seq,
                "containers": entries}

    def node_info(self) -> dict:
        return self._render_nodeinfo(self.latest_snapshot())

    def _nodeinfo_payload(self) -> Tuple[bytes, str]:
        """(pre-serialized body, ETag) — built once per sweep, not per
        request."""
        self.latest_snapshot()  # ensures a publication exists / is fresh
        with self._snap_lock:
            return self._nodeinfo_body, self._nodeinfo_etag

    def start_info_server(self) -> None:
        daemon = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                path = self.path.rstrip("/")
                if path == "/healthz":
                    self.send_response(200)
                    self.send_header("Content-Length", "3")
                    self.end_headers()
                    self.wfile.write(b"ok\n")
                    return
                if path == "/readyz":
                    # alive but degraded: 503 names every active reason
                    # (apiserver_unreachable / podcache_stale /
                    # region_quarantine) so rollouts and alerts can gate
                    # on it; /healthz above stays 200 — restarting the
                    # daemon cannot fix an unreachable apiserver
                    code, body = readyz_payload(daemon.degraded)
                    self.send_response(code)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                if path not in ("", "/nodeinfo"):
                    self.send_error(404)
                    return
                body, etag = daemon._nodeinfo_payload()
                if etag and self.headers.get("If-None-Match") == etag:
                    self.send_response(304)
                    self.send_header("ETag", etag)
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                if etag:
                    self.send_header("ETag", etag)
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # quiet
                pass

        self._info_server = ThreadingHTTPServer(
            (self.info_bind, self.info_port), Handler)
        threading.Thread(target=self._info_server.serve_forever,
                         daemon=True).start()
        log.info("node-info API on %s:%d (/nodeinfo)",
                 self.info_bind or "*", self.info_port)

    # ------------------------------------------------------------------
    # sweep
    # ------------------------------------------------------------------

    def _live_pod_uids(self) -> Optional[List[str]]:
        """Live pod uids for GC, from the pod cache; None (= skip GC)
        when liveness is unknowable. Without a running watch thread the
        freshness valve degrades to one LIST per sweep — exactly the old
        behavior — and to zero LISTs once the watch is streaming."""
        cache = self.podcache
        if cache is None:
            return None
        err: Optional[Exception] = None
        try:
            cache.ensure_fresh(GC_CACHE_MAX_AGE_S)
        except Exception as e:
            err = e
            log.warning("pod cache refresh failed: %s", e)
        if not cache.synced or not cache.fresh(GC_CACHE_MAX_AGE_S):
            # a dir with no known pod may belong to a pod we simply
            # haven't heard about: never GC on a stale view. GC erring
            # toward keeping is the safe behavior, but it is still a
            # degradation the operator must see, not a silent limp.
            self.degraded.set(
                "podcache_stale",
                f"refresh failed: {err}" if err is not None
                else "pod cache not synced/fresh; region GC suspended")
            return None
        self.degraded.clear("podcache_stale")
        return cache.live_uids(self.node_name or None)

    def sweep_once(self) -> None:
        """One feedback+GC iteration (factored out for tests): bulk-copy
        every region once, publish the snapshot set for scrapes and
        /nodeinfo, run feedback off it, then GC against the pod cache."""
        t0 = time.perf_counter()
        snapset, views = self.regions.scan_snapshots()
        # resize BEFORE feedback: a shrink crossing its grace window
        # this sweep is throttle-blocked in the same sweep (the
        # feedback loop is the sole utilization_switch writer and
        # consults the applier's blocked set)
        try:
            if self.resizer.sweep(views):
                # an intent advanced: re-snapshot so this sweep's
                # published /nodeinfo pairs the NEW limit with the new
                # resize_gen instead of serving a pre-resize copy for
                # one interval (the scheduler reads the pair as its
                # apply confirmation)
                snapset, views = self.regions.scan_snapshots()
        except Exception:
            log.exception("resize sweep failed")
        # host guard BEFORE feedback for the same reason as resize: an
        # overage crossing its grace window this sweep is
        # throttle-blocked in the same sweep
        try:
            self.hostguard.sweep(snapset.snapshots)
        except Exception:
            log.exception("host-guard sweep failed")
        # drain coordination BEFORE feedback, same reason again: a
        # snapshot ack observed this sweep quiesces the drained source
        # in the same sweep (and the published migrate_state pairs
        # with the launch block the scheduler's cutover waits on)
        try:
            self.drains.sweep(list(views))
        except Exception:
            log.exception("drain sweep failed")
        self.feedback.observe(views, snapshots=snapset.snapshots)
        self._publish(snapset)
        quarantined = self.regions.quarantined
        self.degraded.assign(
            "region_quarantine", bool(quarantined),
            detail=", ".join(sorted(quarantined)[:8]))
        if self.client is not None:
            try:
                live = self._live_pod_uids()
                if live is not None:
                    self.regions.gc(live)
            except Exception as e:
                log.warning("GC sweep failed: %s", e)
        SWEEP_LATENCY.observe(time.perf_counter() - t0)

    def run(self) -> None:
        REGISTRY.register(self.collector)
        start_http_server(self.metrics_port)
        if self.info_port:
            self.start_info_server()
        if self.podcache is not None:
            self.podcache.start()
        log.info("monitor metrics on :%d, sweeping %s every %.0fs",
                 self.metrics_port, self.regions.dir, self.sweep_interval_s)
        try:
            while not self._stop.is_set():
                self.sweep_once()
                self._stop.wait(self.sweep_interval_s)
        finally:
            REGISTRY.unregister(self.collector)
            self.regions.close()

    def stop(self) -> None:
        self._stop.set()
        if self.podcache is not None:
            self.podcache.stop()
        if self._info_server is not None:
            self._info_server.shutdown()
