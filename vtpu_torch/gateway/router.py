"""Latency-aware replica routing: the port of vtpu/gateway/router.py.

Each request is routed across the model's N replicas — fractional
vGPU gangs, mixed guaranteed/best-effort — by the cheapest live
signal the gateway already owns: the replica batcher's EWMA of
observed step latency (fed by ``ServingStats.record_step``) scaled by
its queue depth. Ties break on the observatory's quota-pressure
counters: the router scrapes each replica node's ``/nodeinfo``
through the SAME
:class:`~vtpu_torch.scheduler.rebalancer.HTTPNodeInfoSource`
the rebalancer uses (ETag/304 + bounded-pool discipline — one
scraper implementation in the codebase, not two), and a replica on a
node whose tenants are slamming their quota gates loses the tie: its
next step is the one most likely to degrade first.

The router never mutates the replica set — that is the autoscaler's
leader-gated job (vtpu_torch/gateway/autoscaler.py). It
only reads the set and, on the preemption path, drains a reclaimed
replica's queue back through routing (``drain_replica``) so in-flight
requests are re-routed or explicitly shed, never silently dropped.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from ..scheduler.core import ShedError
from ..util import types
from . import metrics as metricsmod
from .batcher import GatewayRequest, ReplicaBatcher

log = logging.getLogger(__name__)


@dataclass
class Replica:
    """One routable serving replica: a batcher plus its placement."""

    name: str
    batcher: ReplicaBatcher
    node: str = ""
    #: task priority: autoscaler-spawned replicas are
    #: best-effort (TASK_PRIORITY_DEFAULT) so guaranteed gangs can
    #: preempt them; a pinned baseline replica may be guaranteed
    priority: int = types.TASK_PRIORITY_DEFAULT
    #: mirror of the migration-candidate mark on the replica's pod —
    #: scale-downs prefer these so defrag and autoscaling pull the
    #: same direction
    migration_candidate: bool = False
    live: bool = True
    meta: Dict[str, Any] = field(default_factory=dict)


class Router:
    """Route requests across a ReplicaSet by latency x depth."""

    def __init__(self, replicas, source: Any = None) -> None:
        #: the autoscaler-owned ReplicaSet (read-only here)
        self.replicas = replicas
        #: NodeInfoSource (HTTPNodeInfoSource in production,
        #: StaticNodeInfoSource in tests/bench); None = no tie-break
        self.source = source
        #: node -> lifetime pressure total seen at the last refresh
        self._pressure_prev: Dict[str, int] = {}
        #: node -> pressure DELTA over the last refresh window (the
        #: rebalancer's baseline rule: first observation is history,
        #: not current pressure)
        self._pressure: Dict[str, int] = {}

    # -- pressure tie-break ------------------------------------------------

    @staticmethod
    def _payload_pressure(payload: Dict) -> int:
        total = 0
        for entry in payload.get("containers", []) or []:
            pressure = (entry.get("profile") or {}).get("pressure") or {}
            total += int(pressure.get("near_limit_failures", 0))
            total += int(pressure.get("at_limit_ns", 0))
        return total

    def refresh_pressure(self) -> Dict[str, int]:
        """Scrape /nodeinfo and recompute per-node pressure deltas.
        Call on the routing control period, not per request."""
        if self.source is None:
            return {}
        deltas: Dict[str, int] = {}
        for node, payload in self.source.fetch().items():
            total = self._payload_pressure(payload)
            prev = self._pressure_prev.get(node)
            deltas[node] = max(0, total - prev) if prev is not None else 0
            self._pressure_prev[node] = total
        self._pressure = deltas
        return deltas

    # -- routing -----------------------------------------------------------

    def _score(self, r: Replica) -> Tuple[float, int, str]:
        # expected wait ~ one step EWMA per (depth/batch) queued
        # steps; +1 biases toward the emptier queue at equal latency.
        # Pressure only breaks ties: a noisy-neighbour node serves
        # LAST among otherwise-equal replicas.
        b = r.batcher
        score = b.step_ewma * (b.depth + 1)
        return (score, self._pressure.get(r.node, 0), r.name)

    def live_replicas(self) -> List[Replica]:
        return [r for r in self.replicas.list() if r.live]

    def pick(self) -> Optional[Replica]:
        live = self.live_replicas()
        if not live:
            return None
        return min(live, key=self._score)

    def submit(self, tenant: str, payload: Any,
               now: Optional[float] = None) -> GatewayRequest:
        """Route one request to the best replica's batcher. Sheds
        (429-style ShedError) when no replica is live or the chosen
        queue is full — the scoring already steers toward the
        emptiest queue, so a full winner means the fleet is
        saturated and queueing further would only bust the SLO."""
        replica = self.pick()
        if replica is None:
            metricsmod.GW_SHED.labels("no_replica").inc()
            raise ShedError("no live serving replica; retry")
        return replica.batcher.submit(tenant, payload, now=now)

    # -- preemption / drain path -------------------------------------------

    def drain_replica(self, name_or_replica,
                      now: Optional[float] = None) -> Tuple[int, int]:
        """A replica is being reclaimed (preempted or scaled down):
        mark it unroutable and re-route its queued requests through
        the surviving replicas. Requests that no survivor can absorb
        are SHED explicitly (reason drain_overflow, inside the shed
        budget) — never silently dropped. Accepts a name (preemption
        path: the replica is still in the set) or a Replica object
        (autoscaler retire path: already removed). Returns
        (requeued, shed)."""
        if isinstance(name_or_replica, Replica):
            replica = name_or_replica
            name = replica.name
        else:
            name = name_or_replica
            replica = self.replicas.get(name)
        if replica is None:
            return (0, 0)
        replica.live = False
        requeued = shed = 0
        for req in replica.batcher.drain():
            survivor = self.pick()
            if survivor is None:
                req.shed = True
                shed += 1
                metricsmod.GW_SHED.labels("drain_overflow").inc()
                continue
            try:
                survivor.batcher.queue.push(req.tenant, req)
                metricsmod.GW_QUEUE_DEPTH.labels(
                    survivor.batcher.model_name).set(
                    survivor.batcher.depth)
                requeued += 1
            except Exception:
                req.shed = True
                shed += 1
                metricsmod.GW_SHED.labels("drain_overflow").inc()
        if requeued or shed:
            log.info("drained replica %s: %d re-routed, %d shed",
                     name, requeued, shed)
        return (requeued, shed)
