"""The admission front door's soak, the port of benchmarks/soak.py onto the
port's scheduler, HA pair, rebalancer, migration planner and gateway.

The ladder (``python -m vtpu_torch.bench.sched --ladder``) proves the
batched front door's rate; this harness proves it sustained. Four legs,
each the JAX soak's:

- **the chaos soak** (default, wall-clock): tenant-churned diurnal load
  with two chaos harnesses composed under it. HA chaos
  (``vtpu_torch.bench.chaos.ChaosCluster``): the leader is SIGKILLed
  mid-stream (queued commits dropped) and the standby promoted; every
  interrupted pod is re-driven as kube-scheduler would requeue it. Node
  chaos: a node's handshake goes stale, the registration poll evicts its
  cards, then it re-reports; its standing pods' usage must survive.
  Gates: p99 admission latency (arrival to bound, retries included) <=
  ``--p99-slo-ms``, zero overlay drift after the final drain, zero
  double-booked cards, no pod dropped.
- ``--elastic``: the same breathing load with quotas fixed at admission,
  then with the rebalancer resizing standing pods to a diurnal usage
  curve; density must rise strictly, with zero quota violations and
  drift.
- ``--migrate``: the elastic load with the rebalancer alone, then with the
  ``MigrationPlanner`` moving marked pods through drain, snapshot,
  reschedule and resume; density must rise through completed moves (at
  least one a diurnal wave), blackout p99 within
  ``VTPU_MIGRATE_BLACKOUT_P99_MS``.
- ``--serving``: the gateway's fleet (each replica a pod through webhook,
  filter and bind) under a simulated day with a leader SIGKILL that
  deposes the gateway's autoscaler and a guaranteed gang preempting
  best-effort replicas mid-peak; no request dropped, sheds within budget.

``--waves N`` runs the elastic and migrate legs in simulated time (N waves
a phase, no sleeping); the serving leg's day is always simulated.

    python -m vtpu_torch.bench.soak --duration 600       # ten minutes
    python -m vtpu_torch.bench.soak --duration 8 --nodes 32 --rate 40
    python -m vtpu_torch.bench.soak --elastic --duration 8 --nodes 8 \\
        --rate 30 --waves 80

Env mirrors (vtpu_torch/api): VTPU_SOAK_S, VTPU_SOAK_P99_SLO_MS,
VTPU_MIGRATE_BLACKOUT_P99_MS. One JSON line; exit 1 on a gate. Cards are
16 GiB NVIDIA cards (the JAX soak's chip size); pods ask for
``nvidia.com/gpu``. The simulated legs' results and the records their
apiserver receives equal the JAX soak's (tests/test_torch_soak.py). No
torch is imported.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
from typing import Dict, List, Optional, Tuple

from .. import api, device
from ..device import config as devconfig
from ..gateway import Autoscaler, Replica, ReplicaBatcher, ReplicaSet, Router
from ..scheduler import committer as committermod
from ..scheduler import webhook as webhookmod
from ..scheduler.core import FilterError, Scheduler, ShedError
from ..scheduler.rebalancer import Rebalancer, StaticNodeInfoSource
from ..util import codec, nodelock, types
from ..util.client import FakeKubeClient, NotFoundError
from ..util.types import DeviceInfo
from .chaos import CARD_TYPE, ChaosCluster
from .sched import _bind_and_release
from .serve_ladder import SimModel, _warm_buckets

#: default soak length (seconds); --duration or VTPU_SOAK_S overrides
DEFAULT_DURATION_S = 600.0
DEFAULT_P99_SLO_MS = 2500.0
#: re-admission attempts per pod across failovers before it counts as
#: dropped (kube-scheduler retries forever; the soak bounds it to gate)
MAX_RETRIES = 25


def _pod(namespace: str, name: str, mem: int = 512) -> Dict:
    return {
        "metadata": {"name": name, "namespace": namespace,
                     "uid": f"uid-{namespace}-{name}", "annotations": {}},
        "spec": {"containers": [{"name": "c0", "resources": {"limits": {
            types.RESOURCE_GPU: 1, types.RESOURCE_MEM: mem}}}]},
        "status": {"phase": "Pending"},
    }


class Soak:
    def __init__(self, duration_s: float, nodes: int, pools: int,
                 tenants: int, rate: float, chaos_every_s: float,
                 diurnal_period_s: Optional[float],
                 p99_slo_ms: float, tenant_quota: int = 16,
                 seed_standby: bool = True) -> None:
        self.duration_s = duration_s
        self.rate = rate
        self.pools = pools
        self.tenants = tenants
        self.chaos_every_s = chaos_every_s
        self.diurnal_period_s = diurnal_period_s or max(duration_s / 3.0,
                                                        1.0)
        self.p99_slo_ms = p99_slo_ms
        self.tenant_quota = tenant_quota

        device.init_default_devices()
        devconfig.GLOBAL.default_mem = 0
        devconfig.GLOBAL.default_cores = 0
        self.cluster = ChaosCluster(n_hosts=nodes, pools=pools)
        self.client = self.cluster.client
        self.leader = self.cluster.spawn("soak-A")
        assert self.cluster.elect(self.leader)
        self.standby = (self.cluster.spawn("soak-B") if seed_standby
                        else None)
        self.pool_members = {
            p: [h for i, h in enumerate(self.cluster.hosts)
                if i % pools == p]
            for p in range(pools)
        }
        # per-tenant FIFO of live pod names (the churn quota)
        self.live: Dict[str, List[str]] = {}
        self.latencies: List[float] = []
        self.counters = {
            "admitted": 0, "bound": 0, "deleted": 0, "retries": 0,
            "shed": 0, "dropped": 0, "failovers": 0,
            "node_chaos_events": 0, "no_fit": 0,
            # decisions whose decider died before their bind: recovered
            # from the durable annotation (rebind) or re-decided on the
            # survivor because the dropped commit never landed
            "chaos_rebinds": 0, "chaos_refilters": 0,
        }
        self._seq = 0
        self._spawn_seq = 0

    # -- chaos actions -----------------------------------------------------

    def failover(self) -> None:
        """SIGKILL the leader mid-stream, promote the standby, spawn a
        fresh standby — the ChaosCluster failure the HA suite pins,
        driven here with live load in flight. The caller froze the
        victim's commit pipeline one decide wave earlier, so the kill
        reliably lands with undurable decisions in the queue — the
        bind phase must recover them from the survivor."""
        dead = self.leader
        self.cluster.sigkill(dead)
        assert self.standby is not None
        assert self.cluster.promote(self.standby), "standby did not lead"
        self.leader = self.standby
        self._spawn_seq += 1
        self.standby = self.cluster.spawn(f"soak-R{self._spawn_seq}")
        self.counters["failovers"] += 1

    def node_chaos(self) -> None:
        """Stale-handshake eviction + re-report round trip for one
        node: the scheduler must drop its devices, keep its standing
        pods' usage aggregates, and re-admit to it after recovery."""
        victim = self.cluster.hosts[
            self.counters["node_chaos_events"] % len(self.cluster.hosts)]
        stale = time.time() - types.HANDSHAKE_TIMEOUT_S - 5
        self.client.patch_node_annotations(victim, {
            types.HANDSHAKE_ANNO: f"Requesting_{stale:.0f}"})
        self.leader.register_from_node_annotations_once()  # evicts
        self.client.patch_node_annotations(victim, {
            types.HANDSHAKE_ANNO: f"Reported {time.time():.0f}"})
        self.leader.register_from_node_annotations_once()  # re-ingests
        self.counters["node_chaos_events"] += 1

    # -- admission ---------------------------------------------------------

    def _decide_wave(
        self, arrivals: List[Tuple[str, str, float, List[str]]],
    ) -> List[Tuple[str, str, float, List[str], Optional[str], object]]:
        """Webhook + batch decide for one arrival wave; returns each
        pod's decision alongside the scheduler that made it (the bind
        phase must know whether that scheduler has since been killed)."""
        items = []
        kept = []
        for namespace, name, due, cands in arrivals:
            pod = _pod(namespace, name)
            review = webhookmod.handle_admission_review({
                "apiVersion": "admission.k8s.io/v1",
                "kind": "AdmissionReview",
                "request": {"uid": f"rev-{namespace}-{name}",
                            "object": pod},
            })
            if not review["response"]["allowed"]:
                continue
            self.counters["admitted"] += 1
            self.client.add_pod(pod)
            items.append((pod, cands))
            kept.append((namespace, name, due, cands))
        if not items:
            return []
        decider = self.leader
        results = decider.filter_batch(items)
        return [(ns, name, due, cands, winner if err is None else None,
                 decider)
                for (ns, name, due, cands), (winner, _failed, err)
                in zip(kept, results)]

    def _finish_admission(self, namespace: str, name: str, due: float,
                          cands: List[str], winner: Optional[str],
                          decider) -> None:
        """Bind one decided pod, surviving whatever chaos hit between
        decide and bind: if the decider was SIGKILLed (its queued
        commit dropped on the floor), the durable annotations are the
        only truth — a surviving assignment binds on the new leader, a
        vanished one re-filters there, exactly kube-scheduler's
        requeue."""
        for _attempt in range(MAX_RETRIES):
            s = self.leader
            try:
                if s is not decider or winner is None:
                    # failover (or no decision) since the decide wave:
                    # consult the durable annotations on the apiserver
                    if s is not decider and winner is not None:
                        self.counters["chaos_rebinds"] += 1
                    current = self.client.get_pod(namespace, name)
                    annos = (current.get("metadata", {})
                             .get("annotations", {}) or {})
                    durable = annos.get(types.ASSIGNED_NODE_ANNO)
                    if durable is None and s is not decider \
                            and winner is not None:
                        # the dead leader's queued commit never landed
                        self.counters["chaos_rebinds"] -= 1
                        self.counters["chaos_refilters"] += 1
                    winner = durable
                    decider = s
                    if winner is None:
                        res = s.filter_batch([(current, cands)])
                        w, _failed, err = res[0]
                        if err is not None:
                            raise err
                        if w is None:
                            self.counters["no_fit"] += 1
                            return
                        winner = w
                _bind_and_release(s, self.client, name, winner,
                                  namespace=namespace)
                self.counters["bound"] += 1
                self.latencies.append(time.perf_counter() - due)
                self.live.setdefault(namespace, []).append(name)
                return
            except (FilterError, committermod.CommitFailed,
                    committermod.FencedError,
                    nodelock.NodeLockedError) as e:
                if isinstance(e, FilterError) \
                        and "Shed" in type(e).__name__:
                    self.counters["shed"] += 1
                self.counters["retries"] += 1
                winner = None  # re-consult the durable annotations
                continue
        self.counters["dropped"] += 1

    def _churn(self, namespace: str) -> None:
        q = self.live.get(namespace, [])
        while len(q) > self.tenant_quota:
            gone = q.pop(0)
            try:
                pod_obj = self.client.get_pod(namespace, gone)
                self.client.delete_pod(namespace, gone)
                self.leader.on_del_pod(pod_obj)
                self.counters["deleted"] += 1
            except Exception:  # pragma: no cover - chaos overlap
                self.counters["retries"] += 1

    # -- the run -----------------------------------------------------------

    def run(self) -> Dict:
        t0 = time.perf_counter()
        next_chaos = self.chaos_every_s
        chaos_flip = 0
        submitted = 0.0  # fractional arrivals owed by the rate integral
        while True:
            now = time.perf_counter() - t0
            if now >= self.duration_s:
                break
            # diurnal offered rate: base * (0.6 + 0.4 sin) — breathes
            # between 20% and 100% of peak over each compressed "day"
            cur_rate = self.rate * (
                0.6 + 0.4 * math.sin(
                    2 * math.pi * now / self.diurnal_period_s))
            submitted += cur_rate * 0.05
            n_now = int(submitted)
            submitted -= n_now
            arrivals = []
            for _ in range(n_now):
                tenant = f"tenant-{self._seq % self.tenants}"
                pool = self._seq % self.pools
                name = f"soak-{self._seq}"
                self._seq += 1
                arrivals.append((tenant, name, time.perf_counter(),
                                 self.pool_members[pool]))
            fire_failover = False
            if now >= next_chaos:
                next_chaos += self.chaos_every_s
                if chaos_flip % 2 == 0:
                    # freeze the doomed leader's pipeline BEFORE this
                    # wave decides: its commits queue but never land —
                    # the exact mid-queue-drain state a real SIGKILL
                    # leaves — then kill it between decide and bind so
                    # recovery runs against the durable annotations
                    self.cluster.freeze_pipeline(self.leader)
                    fire_failover = True
                else:
                    self.node_chaos()
                chaos_flip += 1
            decided = self._decide_wave(arrivals)
            if fire_failover:
                self.failover()
            for ns, name, due, cands, winner, decider in decided:
                self._finish_admission(ns, name, due, cands, winner,
                                       decider)
                self._churn(ns)
            time.sleep(0.05)
        # final drain + audits
        self.leader.committer.drain(timeout=60)
        drift = self.leader.verify_overlay()
        # retire the survivors' worker threads before the audits
        # return: a soak must not bleed idle committers into whatever
        # the harness runs next (the standby never decided — closing
        # it is free)
        if self.standby is not None:
            self.standby.committer.close()
        double_booked = 0
        try:
            self.cluster.assert_no_double_booked_chips(self.leader)
        except AssertionError:
            double_booked = 1
        self.latencies.sort()

        def pct(p: float) -> float:
            if not self.latencies:
                return 0.0
            return self.latencies[min(len(self.latencies) - 1,
                                      int(round(p * (len(self.latencies)
                                                     - 1))))]

        p99_ms = round(pct(0.99) * 1e3, 2)
        slo_ok = p99_ms <= self.p99_slo_ms
        ok = (slo_ok and not drift and not double_booked
              and self.counters["dropped"] == 0)
        out = {
            "metric": "soak",
            "duration_s": self.duration_s,
            "nodes": len(self.cluster.hosts),
            "pools": self.pools,
            "tenants": self.tenants,
            "offered_peak_pods_per_sec": self.rate,
            "p50_latency_ms": round(pct(0.50) * 1e3, 2),
            "p99_latency_ms": p99_ms,
            "p99_slo_ms": self.p99_slo_ms,
            "overlay_drift": len(drift),
            "double_booked_chips": double_booked,
            "slo_ok": slo_ok,
            "ok": ok,
        }
        out.update(self.counters)
        if drift:
            out["drift_samples"] = drift[:5]
        self.leader.committer.close()
        return out


MB = 1024 * 1024


class ElasticSoak:
    """Diurnal elastic-quota A/B (the JAX package's docs/elastic-quotas.md
    acceptance):
    the SAME breathing load runs twice — once with quotas fixed at
    admission (the static baseline) and once with the rebalancer
    live-resizing standing pods against synthetic per-pod usage that
    follows the diurnal curve. Gates (exit 1 on violation):

      * packing density (mean standing bound pods) STRICTLY above the
        static baseline;
      * zero quota violations: at every audit, each card's summed pod
        quotas fit its capacity (the durable-annotation audit — the
        region-level "limit never breached mid-churn, authoritative
        within one gate epoch" half is `region_test resizestress` and
        the resize kill points of tests/test_torch_ha.py);
      * zero overlay drift after each phase's final drain.

    Pods ask for 3/4 of a chip but USE a diurnal 20-90% of what they
    asked — the exact over-provisioned serving shape ROADMAP item 3
    names. Statically one such pod strands a chip; elastically the
    rebalancer shrinks it to usage*(1+headroom) and a second (often
    third) tenant admits into the reclaimed headroom; when the curve
    rises again, grows are capped to real card headroom, so density
    gains can never become oversubscription.
    """

    def __init__(self, duration_s: float, nodes: int = 16,
                 tenants: int = 3, rate: float = 20.0,
                 chips_per_node: int = 4, chip_mb: int = 16384,
                 pod_mem_mb: int = 12288,
                 pod_lifetime_s: Optional[float] = None,
                 diurnal_period_s: Optional[float] = None,
                 headroom_pct: float = 25.0,
                 waves: Optional[int] = None) -> None:
        self.duration_s = duration_s
        self.nodes = nodes
        self.tenants = tenants
        self.rate = rate
        self.chips_per_node = chips_per_node
        self.chip_mb = chip_mb
        self.pod_mem_mb = pod_mem_mb
        self.phase_s = max(duration_s / 2.0, 1.0)
        # lifetime long enough that offered standing load saturates the
        # fleet: the phase must be CAPACITY-limited, or the density A/B
        # would only measure the arrival rate
        self.pod_lifetime_s = pod_lifetime_s or max(self.phase_s / 2.0,
                                                    1.0)
        self.diurnal_period_s = diurnal_period_s or max(
            self.phase_s / 2.0, 1.0)
        self.headroom_pct = headroom_pct
        # waves > 0 = SIMULATED time: each phase runs exactly `waves`
        # iterations with `now` advancing phase_s/waves per wave and no
        # sleeping — the density A/B becomes deterministic and immune
        # to shared-machine load (the tests use this; a full soak keeps
        # wall-clock pacing)
        self.waves = waves

    # -- one phase ---------------------------------------------------------

    def _make_cluster(self):
        client = FakeKubeClient()
        hosts = [f"e{i}" for i in range(self.nodes)]
        for node in hosts:
            inventory = [
                DeviceInfo(id=f"{node}-chip-{i}", index=i, count=10,
                           devmem=self.chip_mb, devcore=100, type=CARD_TYPE,
                           numa=0)
                for i in range(self.chips_per_node)
            ]
            client.add_node(node, annotations={
                types.HANDSHAKE_ANNO: f"Reported {time.time():.0f}",
                types.NODE_REGISTER_ANNO:
                    codec.encode_node_devices(inventory),
            })
        s = Scheduler(client)
        s.register_from_node_annotations_once()
        return client, s, hosts

    def _usage_mb(self, seq: int, now_s: float) -> int:
        """Synthetic diurnal usage for pod `seq`: 20-90% of its request,
        phase-shifted per pod so the fleet breathes instead of
        snapping."""
        phase = (seq % 7) / 7.0
        f = 0.55 + 0.35 * math.sin(
            2 * math.pi * (now_s / self.diurnal_period_s + phase))
        return max(1, int(self.pod_mem_mb * f))

    def _nodeinfo(self, s, hosts, usage: Dict[str, int]) -> Dict:
        payloads: Dict[str, Dict] = {}
        for node in hosts:
            containers = []
            for p in s.pods.pods_on_node(node):
                flat = [cd for ctr in p.devices for cd in ctr]
                u = usage.get(p.name, 0) * MB
                containers.append({
                    "entry": f"{p.uid}_0", "pod_uid": p.uid,
                    "pod_namespace": p.namespace, "pod_name": p.name,
                    "hbm_used": [u for _ in flat],
                    "hbm_limit": [cd.usedmem * MB for cd in flat],
                    "profile": {"pressure": {}},
                })
            payloads[node] = {"node": node, "containers": containers}
        return payloads

    def _audit_quotas(self, client, s) -> int:
        """Quota-violation audit over the DURABLE assignments: per
        (node, chip), summed pod quotas must fit the chip. Returns the
        violation count (0 is the gate)."""
        usage: Dict[tuple, int] = {}
        for pod in client.list_pods_all_namespaces():
            annos = pod.get("metadata", {}).get("annotations", {}) or {}
            node = annos.get(types.ASSIGNED_NODE_ANNO)
            if not node:
                continue
            for ctr in codec.decode_pod_devices(
                    annos.get(types.ASSIGNED_IDS_ANNO, "")):
                for d in ctr:
                    usage[(node, d.uuid)] = (
                        usage.get((node, d.uuid), 0) + d.usedmem)
        violations = 0
        for (node, uuid), mem in usage.items():
            info = s.nodes.get_node(node)
            chip = next((d for d in info.devices if d.id == uuid), None)
            if chip is None or mem > chip.devmem:
                violations += 1
        return violations

    def run_phase(self, elastic: bool, migrate: bool = False) -> Dict:
        client, s, hosts = self._make_cluster()
        source = StaticNodeInfoSource()
        rb = (Rebalancer(s, source, period_s=0,
                         headroom_pct=self.headroom_pct)
              if elastic else None)
        planner = None
        msource = None
        mig = None
        if migrate:
            from ..scheduler import metrics as schedmetrics
            from ..scheduler.migrate import MigrationPlanner
            msource = StaticNodeInfoSource()
            planner = MigrationPlanner(s, msource, period_s=0.0,
                                       deadline_s=30.0)
            mig = {"stamped": {}, "blackout_s": [],
                   "moves_by_cycle": {},
                   "cutover": schedmetrics.MIGRATIONS.labels("cutover"),
                   "c0": schedmetrics.MIGRATIONS.labels(
                       "cutover")._value.get()}
        live: List[Tuple[str, str, float, int]] = []  # (ns, name, born, seq)
        usage: Dict[str, int] = {}
        density_samples: List[int] = []
        counters = {"admitted": 0, "no_fit": 0, "deleted": 0,
                    "resizes": 0, "quota_violations": 0}
        seq = 0
        submitted = 0.0
        wave = 0
        step = (self.phase_s / self.waves) if self.waves else 0.0
        t0 = time.perf_counter()
        last_now = 0.0
        try:
            while True:
                if self.waves:
                    now = wave * step
                    if wave >= self.waves:
                        break
                else:
                    now = time.perf_counter() - t0
                    if now >= self.phase_s:
                        break
                wave += 1
                # churn: pods age out, freeing capacity for the next
                # diurnal cohort
                while live and now - live[0][2] > self.pod_lifetime_s:
                    ns, name, _born, _sq = live.pop(0)
                    try:
                        pod_obj = client.get_pod(ns, name)
                        client.delete_pod(ns, name)
                        s.on_del_pod(pod_obj)
                        usage.pop(name, None)
                        counters["deleted"] += 1
                    except Exception:  # pragma: no cover - churn race
                        pass
                # arrivals at the offered rate — accrued by ELAPSED
                # time, not per iteration: the A/B legs do different
                # amounts of work per pass (the migrate leg drives the
                # planner), so a fixed per-iteration quantum would
                # offer the slower leg less load and bias the density
                # ratio toward 1.0
                submitted += self.rate * (step if self.waves
                                          else now - last_now)
                last_now = now
                n_now = int(submitted)
                submitted -= n_now
                for _ in range(n_now):
                    ns = f"etenant-{seq % self.tenants}"
                    name = f"epod-{seq}"
                    pod = client.add_pod(_pod(ns, name,
                                              mem=self.pod_mem_mb))
                    try:
                        winner, _failed = s.filter(pod)
                    except FilterError:
                        winner = None
                    if winner is None:
                        counters["no_fit"] += 1
                        client.delete_pod(ns, name)
                    else:
                        counters["admitted"] += 1
                        live.append((ns, name, now, seq))
                        usage[name] = self._usage_mb(seq, now)
                    seq += 1
                # the diurnal curve moves every standing pod's usage
                for _ns, name, _born, sq in live:
                    usage[name] = self._usage_mb(sq, now)
                if rb is not None:
                    source.payloads = self._nodeinfo(s, hosts, usage)
                    counters["resizes"] += rb.poll_once()
                if planner is not None:
                    self._drive_migrations(client, s, planner, msource,
                                           mig, now)
                density_samples.append(len(live))
                if not self.waves:
                    time.sleep(0.05)
            s.committer.drain(timeout=60)
            counters["quota_violations"] = self._audit_quotas(client, s)
            drift = s.verify_overlay()
            # steady-state density: the second half of the phase (the
            # ramp-up while the fleet first fills is not packing)
            steady = density_samples[len(density_samples) // 2:]
            mean_density = (sum(steady) / len(steady)
                            if steady else 0.0)
            out = {
                "elastic": elastic,
                "mean_standing_pods": round(mean_density, 2),
                "peak_standing_pods": max(density_samples, default=0),
                "overlay_drift": len(drift),
                **counters,
            }
            if mig is not None:
                blk = sorted(mig["blackout_s"])

                def pct(p: float) -> float:
                    if not blk:
                        return 0.0
                    i = min(len(blk) - 1, int(p * (len(blk) - 1)))
                    return round(blk[i] * 1000.0, 1)

                cycles = max(1, int(self.phase_s
                                    / self.diurnal_period_s))
                per_cycle = [mig["moves_by_cycle"].get(c, 0)
                             for c in range(cycles)]
                out.update({
                    "completed_moves": int(
                        mig["cutover"]._value.get() - mig["c0"]),
                    "moves_per_wave": per_cycle,
                    "min_moves_per_wave": min(per_cycle, default=0),
                    "blackout_p50_ms": pct(0.50),
                    "blackout_p99_ms": pct(0.99),
                })
            return out
        finally:
            s.committer.close()

    def _drive_migrations(self, client, s, planner, msource, mig,
                          now: float) -> None:
        """One migration control round: the harness plays BOTH sides of
        the drain handshake — every stamped pod is a cooperative
        MigratableModel that snapshots immediately (the monitor-side
        DrainCoordinator publishing `snapshotted` on /nodeinfo) — and
        the planner consumes it through the same payload shape the
        daemon serves. Blackout is measured workload-side: from the
        snapshot ack (step stopped) to the cutover landing durably."""
        s.committer.drain(timeout=30)  # stamps/cutovers become durable
        payloads: Dict[str, Dict] = {}
        seen = set()
        for pod in client.list_pods_all_namespaces():
            annos = pod.get("metadata", {}).get("annotations", {}) or {}
            node = annos.get(types.ASSIGNED_NODE_ANNO)
            uid = pod.get("metadata", {}).get("uid", "")
            if not node or not uid:
                continue
            seen.add(uid)
            entry = {"pod_uid": uid, "migrate_gen": 0,
                     "migrate_state": ""}
            stamp = annos.get(types.MIGRATING_TO_ANNO)
            if stamp:
                try:
                    gen, _dst, _devs = codec.decode_migrating_to(stamp)
                    entry["migrate_gen"] = gen
                    entry["migrate_state"] = "snapshotted"
                    mig["stamped"].setdefault(uid, now)
                except Exception:
                    pass
            elif uid in mig["stamped"]:
                # stamp cleared: cutover (or abort) became durable —
                # the workload's step blackout ends here
                mig["blackout_s"].append(
                    max(0.0, now - mig["stamped"].pop(uid)))
                if types.MIGRATED_FROM_ANNO in annos:
                    cycle = int(now / self.diurnal_period_s)
                    mig["moves_by_cycle"][cycle] = \
                        mig["moves_by_cycle"].get(cycle, 0) + 1
            payloads.setdefault(
                node, {"containers": []})["containers"].append(entry)
        for uid in [u for u in mig["stamped"] if u not in seen]:
            mig["stamped"].pop(uid, None)  # churned out mid-move
        msource.payloads = payloads
        planner.poll_once()

    def run(self) -> Dict:
        static = self.run_phase(elastic=False)
        elastic = self.run_phase(elastic=True)
        density_up = (elastic["mean_standing_pods"]
                      > static["mean_standing_pods"])
        ok = (density_up
              and static["quota_violations"] == 0
              and elastic["quota_violations"] == 0
              and static["overlay_drift"] == 0
              and elastic["overlay_drift"] == 0
              and elastic["resizes"] > 0)
        return {
            "metric": "soak_elastic",
            "duration_s": self.duration_s,
            "nodes": self.nodes,
            "pod_mem_mb": self.pod_mem_mb,
            "static": static,
            "elastic": elastic,
            "density_gain": round(
                elastic["mean_standing_pods"]
                / max(static["mean_standing_pods"], 1e-9), 3),
            "density_up": density_up,
            "ok": ok,
        }


class MigrateSoak(ElasticSoak):
    """Live-migration A/B (the JAX package's docs/migration.md
    acceptance): the SAME breathing elastic load runs twice — once with
    the rebalancer alone (defrag marks land but nothing moves: a
    report-only world)
    and once with the MigrationPlanner consuming the marks through the
    full drain→snapshot→reschedule→resume protocol. Gates (exit 1):

      * packing density STRICTLY above the elastic-only baseline, and
        the gain must come from real moves: at least one COMPLETED
        live migration per diurnal wave;
      * zero quota violations and zero overlay drift in both phases
        (a half-finished move that double-booked chips would trip the
        durable-annotation audit);
      * workload-observed blackout p99 — snapshot ack to durable
        cutover — within VTPU_MIGRATE_BLACKOUT_P99_MS.
    """

    BLACKOUT_P99_MS_DEFAULT = 2000.0

    def run(self) -> Dict:
        base = self.run_phase(elastic=True)
        moved = self.run_phase(elastic=True, migrate=True)
        gate_ms = float(os.environ.get(api.ENV_MIGRATE_BLACKOUT_P99_MS,
                                       self.BLACKOUT_P99_MS_DEFAULT)
                        or self.BLACKOUT_P99_MS_DEFAULT)
        density_up = (moved["mean_standing_pods"]
                      > base["mean_standing_pods"])
        moves_ok = moved.get("min_moves_per_wave", 0) >= 1
        blackout_ok = moved.get("blackout_p99_ms", 0.0) <= gate_ms
        ok = (density_up and moves_ok and blackout_ok
              and base["quota_violations"] == 0
              and moved["quota_violations"] == 0
              and base["overlay_drift"] == 0
              and moved["overlay_drift"] == 0)
        return {
            "metric": "soak_migrate",
            "duration_s": self.duration_s,
            "nodes": self.nodes,
            "pod_mem_mb": self.pod_mem_mb,
            "elastic_only": base,
            "migrate": moved,
            "density_gain": round(
                moved["mean_standing_pods"]
                / max(base["mean_standing_pods"], 1e-9), 3),
            "density_up": density_up,
            "completed_moves": moved.get("completed_moves", 0),
            "min_moves_per_wave": moved.get("min_moves_per_wave", 0),
            "blackout_p99_ms": moved.get("blackout_p99_ms", 0.0),
            "blackout_p99_gate_ms": gate_ms,
            "ok": ok,
        }


class _GateHA:
    """A leadership handle for the gateway autoscaler's gate: the soak
    flips ``leading`` at failover, exactly what HACoordinator.is_leader
    reports on a real pair."""

    def __init__(self, leading: bool) -> None:
        self.leading = leading

    def is_leader(self) -> bool:
        return self.leading


#: each serving replica's pod: most of one 16384 MB card, so a
#: guaranteed gang member (GANG_MEM_MB) can only land by preempting it
REPLICA_MEM_MB = 12000
GANG_MEM_MB = 8000
#: explicit retryable refusals per offered request the serving day may
#: burn (queue_full + drain_overflow); everything else must complete
SERVING_SHED_BUDGET = 0.02


class ServingSoak:
    """Serving front-door soak (the soak's fourth leg):
    the gateway fleet composed with the REAL control plane under one
    diurnal day of traffic —

      * every replica is a live best-effort pod admitted through the
        webhook -> filter -> bind path on a ChaosCluster leader, so the
        overlay/double-booking audits cover the serving fleet;
      * mid-ramp the leader is SIGKILLed and the standby promoted; the
        gateway autoscaler is leader-gated the same way, so the deposed
        loop's next poll must observe nothing and mutate nothing while
        the successor scales on;
      * mid-peak a guaranteed gang arrives and the scheduler's
        preemption engine evicts best-effort replicas to seat it; each evicted
        replica's queued requests are re-routed through the survivors
        (Router.drain_replica) or explicitly shed — never silently
        dropped.

    Gates (exit 1 on violation): zero dropped in-flight requests
    (submitted == completed + explicitly shed), sheds within
    SERVING_SHED_BUDGET, zero overlay drift, zero double-booked chips,
    and the chaos actually fired (>=1 failover, >=1 preempted replica,
    the gang bound). Time is fully SIMULATED — deterministic waves, no
    sleeps — so a full day takes seconds of wall clock.
    """

    def __init__(self, duration_s: float, nodes: int = 2,
                 tenants: int = 3, trough_qps: float = 100.0,
                 peak_qps: float = 1600.0, slo_s: float = 0.1,
                 max_replicas: Optional[int] = None,
                 autoscale_s: float = 2.0, queue_cap: int = 512,
                 shed_budget: float = SERVING_SHED_BUDGET) -> None:
        self.duration_s = duration_s
        self.tenants = tenants
        self.trough_qps = trough_qps
        self.peak_qps = peak_qps
        self.slo_s = slo_s
        self.autoscale_s = autoscale_s
        self.queue_cap = queue_cap
        self.shed_budget = shed_budget

        device.init_default_devices()
        devconfig.GLOBAL.default_mem = 0
        devconfig.GLOBAL.default_cores = 0
        self.cluster = ChaosCluster(n_hosts=nodes, pools=1)
        self.client = self.cluster.client
        self.sched = self.cluster.spawn("serve-A")
        assert self.cluster.elect(self.sched)
        self.standby = self.cluster.spawn("serve-B")
        # 4 cards per ChaosCluster host; one replica pod per card
        self.max_replicas = max_replicas or nodes * 4

        self.now = 0.0
        self._rseq = 0
        self._arr = 0
        self.counters = {
            "requests": 0, "completed": 0, "shed_submit": 0,
            "drain_requeued": 0, "drain_shed": 0, "spawned": 0,
            "spawn_no_fit": 0, "retired": 0, "forced_fill": 0,
            "failovers": 0, "gated_polls": 0, "gang_bound": 0,
            "preempted_replicas": 0,
        }
        self.replicas = ReplicaSet("serving")
        self.router = Router(self.replicas)
        self.ha_a = _GateHA(True)
        self.ha_b = _GateHA(False)
        self.autoscaler = Autoscaler(
            self.replicas, self._spawn_replica, self._retire_replica,
            ha=self.ha_a, slo_s=slo_s, min_replicas=1,
            max_replicas=self.max_replicas, idle_rounds=3,
            period_s=autoscale_s)
        self.autoscaler_standby = Autoscaler(
            self.replicas, self._spawn_replica, self._retire_replica,
            ha=self.ha_b, slo_s=slo_s, min_replicas=1,
            max_replicas=self.max_replicas, idle_rounds=3,
            period_s=autoscale_s)
        first = self._spawn_replica()
        assert first is not None, "baseline replica failed to place"
        self.replicas.add(first)

    # -- replica lifecycle (pods through the real control plane) -----------

    def _replica_pod(self, name: str, namespace: str, mem: int,
                     priority: int) -> Dict:
        return {
            "metadata": {"name": name, "namespace": namespace,
                         "uid": f"uid-{namespace}-{name}",
                         "annotations": {}},
            "spec": {"containers": [{"name": "c0", "resources": {
                "limits": {types.RESOURCE_GPU: 1,
                           types.RESOURCE_MEM: mem,
                           types.RESOURCE_PRIORITY: priority}}}]},
            "status": {"phase": "Pending"},
        }

    def _spawn_replica(self) -> Optional[Replica]:
        """One new BEST-EFFORT serving replica: a real pod through the
        webhook + filter + bind path, then a warmed batcher on its
        node."""
        name = f"srv-{self._rseq}"
        self._rseq += 1
        pod = self._replica_pod(name, "serving", REPLICA_MEM_MB,
                                priority=types.TASK_PRIORITY_DEFAULT)
        review = webhookmod.handle_admission_review(
            {"request": {"uid": f"rev-{name}", "object": pod}})
        if not review["response"]["allowed"]:
            return None
        self.client.add_pod(pod)
        try:
            winner, _failed = self.sched.filter(
                self.client.get_pod("serving", name))
        except FilterError:
            winner = None
        if winner is None:
            # the fleet is out of chips (e.g. the gang took them):
            # serving capacity above the baseline is the cluster's
            # slack, and right now there is none
            self.counters["spawn_no_fit"] += 1
            try:
                self.client.delete_pod("serving", name)
            except Exception:
                pass
            return None
        _bind_and_release(self.sched, self.client, name, winner,
                          namespace="serving")
        model = SimModel(base_s=0.02, per_row_s=0.002)
        batcher = ReplicaBatcher(model, model_name="serving",
                                 batch_min=1, batch_max=8,
                                 queue_cap=self.queue_cap,
                                 slo_s=self.slo_s)
        _warm_buckets(batcher, t=self.now)
        live = [r.batcher.step_ewma for r in self.replicas.list()
                if r.live]
        if live:
            batcher.step_ewma = max(live)
        self.counters["spawned"] += 1
        return Replica(name=name, batcher=batcher, node=winner)

    def _retire_replica(self, replica: Replica) -> None:
        """Autoscaler scale-down: re-route the queue, then tear the
        pod down through the scheduler's delete path."""
        requeued, shed = self.router.drain_replica(replica,
                                                   now=self.now)
        self.counters["drain_requeued"] += requeued
        self.counters["drain_shed"] += shed
        try:
            pod_obj = self.client.get_pod("serving", replica.name)
            self.client.delete_pod("serving", replica.name)
            self.sched.on_del_pod(pod_obj)
            self.counters["retired"] += 1
        except Exception:  # pragma: no cover - chaos overlap
            pass

    # -- chaos actions -----------------------------------------------------

    def failover(self) -> None:
        """SIGKILL the scheduler leader AND depose the gateway
        autoscaler riding its leadership; the promoted successor's
        autoscaler takes over scaling."""
        self.cluster.sigkill(self.sched)
        assert self.cluster.promote(self.standby), "standby did not lead"
        self.sched = self.standby
        self.standby = self.cluster.spawn("serve-R")
        self.ha_a.leading = False
        self.ha_b.leading = True
        self.counters["failovers"] += 1

    def gang_arrives(self) -> None:
        """Mid-peak: a guaranteed 2-member gang lands. Its members fit
        nowhere without evicting best-effort replica pods, so the
        preemption engine seats them; every evicted replica's queue is
        re-routed through the survivors."""
        for i in range(2):
            name = f"gang-{i}"
            pod = self._replica_pod(name, "gang", GANG_MEM_MB,
                                    priority=types.TASK_PRIORITY_HIGH)
            review = webhookmod.handle_admission_review(
                {"request": {"uid": f"rev-{name}", "object": pod}})
            assert review["response"]["allowed"], review
            self.client.add_pod(pod)
            try:
                winner, _failed = self.sched.filter(
                    self.client.get_pod("gang", name))
            except FilterError:
                winner = None
            if winner is not None:
                _bind_and_release(self.sched, self.client, name, winner,
                                  namespace="gang")
                self.counters["gang_bound"] += 1
        self.sched.committer.drain(timeout=60)
        # evicted replicas vanished from the apiserver (two-phase
        # stamp+delete); the gateway must now stop routing to them and
        # hand their queues back
        for replica in list(self.replicas.list()):
            try:
                self.client.get_pod("serving", replica.name)
            except NotFoundError:
                self.replicas.remove(replica.name)
                requeued, shed = self.router.drain_replica(
                    replica, now=self.now)
                self.counters["drain_requeued"] += requeued
                self.counters["drain_shed"] += shed
                self.counters["preempted_replicas"] += 1

    # -- the run -----------------------------------------------------------

    def _step_replicas(self, busy: Dict[str, float], now: float,
                       horizon: float,
                       latencies: List[float]) -> None:
        """Run each replica's step loop up to ``now + horizon``: a
        replica steps back-to-back (the continuous-batching loop never
        idles while work is queued), each step starting when the
        previous one finished."""
        for r in self.router.live_replicas():
            t = max(busy.get(r.name, 0.0), now)
            while r.batcher.depth and t < now + horizon:
                res = r.batcher.step(now=t)
                if res is None:
                    break
                t += res.step_seconds
                busy[r.name] = t
                for q in res.requests:
                    if q.tenant != "warmup":
                        self.counters["completed"] += 1
                        latencies.append(q.latency)

    def run(self) -> Dict:
        step = 0.05
        waves = max(20, int(self.duration_s / step))
        autoscale_every = max(1, int(self.autoscale_s / step))
        failover_wave = int(waves * 0.35)
        fill_wave = int(waves * 0.50)
        gang_wave = int(waves * 0.55)
        busy: Dict[str, float] = {}
        latencies: List[float] = []
        submitted = 0.0
        for wave in range(waves):
            now = wave * step
            self.now = now
            # sin^2 diurnal: trough at the edges, peak mid-day
            rate = self.trough_qps + (
                self.peak_qps - self.trough_qps) * (
                math.sin(math.pi * wave / waves) ** 2)
            submitted += rate * step
            n_now = int(submitted)
            submitted -= n_now
            for _ in range(n_now):
                tenant = f"tenant-{self._arr % self.tenants}"
                self._arr += 1
                self.counters["requests"] += 1
                try:
                    self.router.submit(tenant, [0.0] * 8, now=now)
                except ShedError:
                    self.counters["shed_submit"] += 1
            if wave == failover_wave:
                self.failover()
                # the deposed autoscaler's next poll must be a no-op
                assert self.autoscaler.poll_once() == 0
                self.counters["gated_polls"] += 1
            if wave == fill_wave:
                # mid-peak top-up through the SAME spawn path: the gang
                # must provably arrive into a saturated fleet even when
                # a short smoke day gave the autoscaler too few polls
                while len(self.replicas) < self.max_replicas:
                    extra = self._spawn_replica()
                    if extra is None:
                        break
                    self.replicas.add(extra)
                    self.counters["forced_fill"] += 1
            if wave == gang_wave:
                self.gang_arrives()
            if wave % autoscale_every == 0:
                self.autoscaler.poll_once()
                self.autoscaler_standby.poll_once()
            self._step_replicas(busy, now, step, latencies)
        # final drain: serve everything still queued
        now = waves * step
        for _ in range(20000):
            if not any(r.batcher.depth
                       for r in self.router.live_replicas()):
                break
            self.now = now
            self._step_replicas(busy, now, step, latencies)
            now += step
        self.sched.committer.drain(timeout=60)
        drift = self.sched.verify_overlay()
        double_booked = 0
        try:
            self.cluster.assert_no_double_booked_chips(self.sched)
        except AssertionError:
            double_booked = 1
        if self.standby is not None:
            self.standby.committer.close()
        latencies.sort()

        def pct(p: float) -> float:
            if not latencies:
                return 0.0
            return latencies[min(len(latencies) - 1,
                                 int(round(p * (len(latencies) - 1))))]

        shed_total = (self.counters["shed_submit"]
                      + self.counters["drain_shed"])
        dropped = (self.counters["requests"]
                   - self.counters["completed"] - shed_total)
        shed_fraction = shed_total / max(1, self.counters["requests"])
        ok = (dropped == 0
              and shed_fraction <= self.shed_budget
              and not drift and not double_booked
              and self.counters["failovers"] >= 1
              and self.counters["gang_bound"] >= 1
              and self.counters["preempted_replicas"] >= 1)
        out = {
            "metric": "soak_serving",
            "duration_s": self.duration_s,
            "tenants": self.tenants,
            "trough_qps": self.trough_qps,
            "peak_qps": self.peak_qps,
            "slo_ms": round(self.slo_s * 1e3, 2),
            "p50_latency_ms": round(pct(0.50) * 1e3, 2),
            "p99_latency_ms": round(pct(0.99) * 1e3, 2),
            "dropped": dropped,
            "shed_fraction": round(shed_fraction, 5),
            "shed_budget": self.shed_budget,
            "overlay_drift": len(drift),
            "double_booked_chips": double_booked,
            "peak_fleet": self.max_replicas,
            "final_fleet": len(self.replicas),
            "ok": ok,
        }
        out.update(self.counters)
        if drift:
            out["drift_samples"] = drift[:5]
        self.sched.committer.close()
        return out


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--duration", type=float,
                    default=float(os.environ.get(api.ENV_SOAK_S,
                                                 DEFAULT_DURATION_S)
                                  or DEFAULT_DURATION_S),
                    help="soak length in seconds (env VTPU_SOAK_S; "
                         f"default {DEFAULT_DURATION_S:.0f})")
    ap.add_argument("--nodes", type=int, default=128,
                    help="fleet size (default 128)")
    ap.add_argument("--pools", type=int, default=4,
                    help="node pools / decide shards exercised "
                         "(default 4)")
    ap.add_argument("--tenants", type=int, default=6,
                    help="namespaces sharing the front door (default 6)")
    ap.add_argument("--rate", type=float, default=60.0,
                    help="peak offered admissions/sec; the diurnal "
                         "curve breathes between 20%% and 100%% of it "
                         "(default 60)")
    ap.add_argument("--chaos-every", type=float, default=None,
                    help="seconds between chaos events, alternating "
                         "leader SIGKILL+failover and node "
                         "eviction+recovery (default duration/6)")
    ap.add_argument("--diurnal-period", type=float, default=None,
                    help="seconds per compressed load 'day' (default "
                         "duration/3)")
    ap.add_argument("--tenant-quota", type=int, default=16,
                    help="standing pods per tenant before its oldest "
                         "churn out (default 16)")
    ap.add_argument("--p99-slo-ms", type=float,
                    default=float(os.environ.get(api.ENV_SOAK_P99_SLO_MS,
                                                 DEFAULT_P99_SLO_MS)
                                  or DEFAULT_P99_SLO_MS),
                    help="admission-latency SLO gate (env "
                         "VTPU_SOAK_P99_SLO_MS; default "
                         f"{DEFAULT_P99_SLO_MS:.0f})")
    ap.add_argument("--out", default=None,
                    help="append the JSON summary to this file too")
    ap.add_argument("--elastic", action="store_true",
                    help="run the diurnal elastic-quota A/B instead of "
                         "the chaos soak: the same breathing load with "
                         "static quotas, then with the rebalancer live "
                         "— gates packing density strictly above the "
                         "static baseline with zero quota violations "
                         "and zero overlay drift")
    ap.add_argument("--migrate", action="store_true",
                    help="run the live-migration A/B instead: the same "
                         "breathing elastic load with the rebalancer "
                         "alone, then with the MigrationPlanner moving "
                         "marked pods through the full drain/snapshot/"
                         "resume protocol — gates packing density "
                         "strictly above elastic-only via >=1 completed "
                         "live move per diurnal wave, zero quota "
                         "violations, zero overlay drift, and blackout "
                         "p99 within VTPU_MIGRATE_BLACKOUT_P99_MS")
    ap.add_argument("--waves", type=int, default=None,
                    help="run the A/B legs in SIMULATED time with this "
                         "many waves per phase (deterministic; no "
                         "sleeping) instead of wall-clock pacing")
    ap.add_argument("--bench-json", default=None,
                    help="also write the machine-readable summary to "
                         "this file")
    ap.add_argument("--serving", action="store_true",
                    help="run the serving front-door soak instead: the "
                         "gateway fleet (replica pods through the real "
                         "filter/bind path) under a diurnal day with a "
                         "leader SIGKILL and a guaranteed gang "
                         "preempting best-effort replicas mid-peak — "
                         "gates zero dropped in-flight requests beyond "
                         "the shed budget and zero overlay drift")
    args = ap.parse_args(argv)
    if args.serving:
        ssoak = ServingSoak(duration_s=args.duration,
                            tenants=args.tenants)
        res = ssoak.run()
        line = json.dumps(res)
        print(line)
        if args.out:
            with open(args.out, "a", encoding="utf-8") as f:
                f.write(line + "\n")
        return 0 if res["ok"] else 1
    if args.elastic or args.migrate:
        device.init_default_devices()
        devconfig.GLOBAL.default_mem = 0
        devconfig.GLOBAL.default_cores = 0
        cls = MigrateSoak if args.migrate else ElasticSoak
        esoak = cls(duration_s=args.duration,
                    nodes=min(args.nodes, 64),
                    tenants=args.tenants,
                    rate=args.rate,
                    diurnal_period_s=args.diurnal_period,
                    waves=args.waves)
        res = esoak.run()
        line = json.dumps(res)
        print(line)
        if args.out:
            with open(args.out, "a", encoding="utf-8") as f:
                f.write(line + "\n")
        if args.bench_json:
            with open(args.bench_json, "w", encoding="utf-8") as f:
                json.dump(res, f, indent=1)
                f.write("\n")
        return 0 if res["ok"] else 1
    chaos_every = args.chaos_every or max(args.duration / 6.0, 1.0)
    soak = Soak(duration_s=args.duration, nodes=args.nodes,
                pools=args.pools, tenants=args.tenants, rate=args.rate,
                chaos_every_s=chaos_every,
                diurnal_period_s=args.diurnal_period,
                p99_slo_ms=args.p99_slo_ms,
                tenant_quota=args.tenant_quota)
    res = soak.run()
    line = json.dumps(res)
    print(line)
    if args.out:
        with open(args.out, "a", encoding="utf-8") as f:
            f.write(line + "\n")
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
