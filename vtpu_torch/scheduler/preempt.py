"""Priority-aware preemption engine (ROADMAP item 2, docs/multihost.md ADR).

The port's copy of vtpu/scheduler/preempt.py.

``TASK_PRIORITY`` has flowed end-to-end since the seed (webhook env →
shim → monitor feedback), but nothing in the scheduler ever ACTED on
it: a guaranteed pod (or gang) that didn't fit simply failed admission
while best-effort pods squatted on the chips. This module closes that
loop. It is invoked from ``Scheduler._decide_locked`` — under the OWNING
shards' decide locks, exactly like the decision itself (cross-shard
gangs arrive holding the ordered ``ShardLockSet``) — when a pod
whose priority outranks running tenants fails per-chip fitting:

  * **victim search** (:meth:`PreemptionEngine.plan_locked`): for each
    candidate node (bounded by ``VTPU_PREEMPT_MAX_NODES``), grow a
    victim set greedily over the node's strictly-lower-priority pods —
    ``vtpu.io/migration-candidate``-marked pods first (evicting one of
    the defrag proposals both makes room AND defragments), then
    lowest priority, then smallest quota — simulating each eviction
    against a private snapshot until the requester fits, then prune the
    set back to minimality (every remaining victim is necessary). The
    host-memory axis is freed alongside the chip axes. Guaranteed
    (priority-0) pods are NEVER victims, by eligibility filter — the
    pinned negative test in tests/test_preempt.py.
  * **fenced two-phase evict** (driven by core under the same locks):
    phase 1 retracts each victim from the pod cache/overlay in memory
    (the freed capacity is visible to the requester's re-score inside
    the SAME critical section — no other filter can steal it) and
    submits the durable ``vtpu.io/preempted-by`` stamp through the
    commit pipeline with uid + leadership-generation preconditions (a
    deposed leader's eviction is refused before the wire, the fencing
    discipline); phase 2 — the pod DELETE, uid-preconditioned — fires
    from the committer's post-commit hook only after the stamp is
    durable. A leader killed between the phases is healed by
    ``Scheduler.recover()``: the durable stamp replays the delete
    exactly-once on promotion (idempotent by uid). The node monitor
    feedback-blocks a stamped victim's launches until kubelet tears it
    down (vtpu/monitor/feedback.py), so a dying victim can't race the
    incoming tenant's quota.

Deliberate limits (docs/multihost.md ADR): equal priority never
preempts, and the engine only frees what per-chip fitting can use —
it never evicts speculatively. A migratable best-effort
victim with a viable destination is RESCUED — moved through the
drain/snapshot/resume pipeline (docs/migration.md) instead of
deleted, the delete suspended behind a durable deadline; victims
that refuse or cannot move still get the plain eviction (their
controller reschedules them).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .. import api
from ..trace import decision as decisionmod
from ..trace.decision import Rejection
from ..util import types
from ..util.env import env_int
from . import score as scoremod
from .pods import PodInfo

log = logging.getLogger(__name__)

#: candidate nodes the victim search will simulate per decision —
#: bounds the worst case (a whole-cluster candidate list of busy
#: nodes) without affecting the common one (config.md)
PREEMPT_MAX_NODES_DEFAULT = 16


@dataclass
class PreemptPlan:
    """A minimal victim set whose eviction makes the requester fit on
    `node` — everything core needs to execute the two-phase protocol
    and record the PREEMPTED DecisionTrace."""

    node: str
    victims: List[PodInfo] = field(default_factory=list)
    freed_mb: int = 0          # HBM MB the victims' quotas release
    freed_host_mb: int = 0     # node host-RAM MB released

    @property
    def all_defrag(self) -> bool:
        """True when every victim was a migration candidate —
        the eviction doubles as the defrag the rebalancer proposed."""
        return bool(self.victims) and all(v.migration_candidate
                                          for v in self.victims)


def victim_mb(v: PodInfo) -> int:
    return sum(cd.usedmem for ctr in v.devices for cd in ctr)


def _release_usage(usage: List, victim: PodInfo) -> None:
    """Subtract one victim's per-chip quotas from a mutable usage
    snapshot (the inverse of fit_in_certain_device's trial charge)."""
    by_id = {u.id: u for u in usage}
    for ctr in victim.devices:
        for cd in ctr:
            u = by_id.get(cd.uuid)
            if u is None:
                continue  # chip left the inventory: nothing to free
            u.used = max(0, u.used - 1)
            u.usedmem = max(0, u.usedmem - cd.usedmem)
            u.usedcores = max(0, u.usedcores - cd.usedcores)


class PreemptionEngine:
    """Victim search over the scheduler's decide-locked state. Every
    public method is ``*_locked``: the caller holds the decide lock(s)
    of every shard owning a node it names (hack/vtpulint.py VTPU015
    confines the callers to the decide path)."""

    def __init__(self, scheduler) -> None:
        self.s = scheduler
        self.max_nodes = env_int(api.ENV_PREEMPT_MAX_NODES,
                                 PREEMPT_MAX_NODES_DEFAULT, minimum=1)

    # -- fit simulation ----------------------------------------------------

    def _fits(self, usage: List, requests, annos,
              host_demand: int, host_cap: int, host_used: int) -> bool:
        """Would the requester fit this (already victim-released)
        usage? Chip fitting runs on a private clone — `usage` stays
        the accumulating victim-released view."""
        if scoremod.host_fit_rejection(host_demand, host_cap,
                                       host_used) is not None:
            return False
        trial = [scoremod.clone_usage(u) for u in usage]
        placed, _ = scoremod.fit_pod(trial, requests, annos)
        return placed is not None

    def victims_for_node_locked(
        self, node: str, requests, annos, req_priority: int,
        pods: Optional[List[PodInfo]] = None,
    ) -> Optional[PreemptPlan]:
        """Minimal victim set on ONE node (None = even evicting every
        eligible pod would not fit the requester). Deterministic:
        eligibility order is (migration-candidate first, lowest
        priority first, smallest quota, uid). `pods` (when the caller
        already partitioned the cache) skips the per-node scan."""
        if pods is None:
            pods = self.s.pods.pods_on_node(node)
        eligible = [
            p for p in pods
            # strictly-lower priority only: equals never preempt each
            # other, and priority 0 (guaranteed) is structurally
            # un-evictable because no requester outranks it
            if p.priority > req_priority
        ]
        if not eligible:
            return None
        eligible.sort(key=lambda p: (not p.migration_candidate,
                                     -p.priority, victim_mb(p),
                                     p.uid))
        snap = self.s.overlay.snapshot([node]).get(node)
        if not snap:
            return None
        host_demand = scoremod.host_mem_request_mb(annos)
        host_cap, host_used = self.s.overlay.host_state(
            [node]).get(node, (0, 0))
        chosen: List[PodInfo] = []
        fits = False
        for v in eligible:
            _release_usage(snap, v)
            host_used -= v.host_mb
            chosen.append(v)
            if self._fits(snap, requests, annos, host_demand,
                          host_cap, host_used):
                fits = True
                break
        if not fits:
            return None
        # minimality prune: re-simulate without each chosen victim (in
        # the order they were added — the cheapest first); a victim
        # whose retention still lets the requester fit was never
        # necessary. The survivors form a minimal set: removing ANY
        # one breaks the fit.
        minimal = list(chosen)
        for v in list(chosen):
            rest = [w for w in minimal if w is not v]
            if not rest:
                continue
            resnap = self.s.overlay.snapshot([node]).get(node)
            if resnap is None:
                break
            h_used = self.s.overlay.host_state(
                [node]).get(node, (0, 0))[1]
            for w in rest:
                _release_usage(resnap, w)
                h_used -= w.host_mb
            if self._fits(resnap, requests, annos, host_demand,
                          host_cap, h_used):
                minimal = rest
        return PreemptPlan(
            node=node, victims=minimal,
            freed_mb=sum(victim_mb(v) for v in minimal),
            freed_host_mb=sum(v.host_mb for v in minimal))

    def plan_locked(
        self, node_names: Optional[List[str]], requests, annos,
        req_priority: int,
        failed: Optional[Dict[str, Rejection]] = None,
    ) -> Tuple[Optional[PreemptPlan], bool]:
        """Best plan across the candidate nodes (None = whole
        cluster): fewest victims, then least freed HBM (evict as
        little as possible), then node id for determinism. `failed`
        (the decision's rejection map) skips nodes whose refusal
        preemption cannot cure — an unregistered candidate stays
        unregistered with every tenant evicted.

        Returns (plan or None, had_eligible): the second member is
        True when at least one strictly-lower-priority pod existed on
        the candidate set at all — what separates "preemption engaged
        and found NO_VICTIMS" (counted, traced) from the ordinary
        best-effort-pod-didn't-fit case (silent)."""
        allowed = None if node_names is None else set(node_names)
        # ONE pass over the pod cache partitions victims by node —
        # nodes with no lower-priority tenant cost nothing and never
        # consume the simulation budget
        by_node: Dict[str, List[PodInfo]] = {}
        for p in self.s.pods.list_pods():
            if p.priority <= req_priority:
                continue
            if allowed is not None and p.node_id not in allowed:
                continue
            if failed is not None:
                why = failed.get(p.node_id)
                if why is not None and why.code in (
                        decisionmod.NODE_UNREGISTERED,
                        decisionmod.NODE_NO_VENDOR,
                        # multi-active: evicting on another owner's
                        # group cannot cure anything WE can commit
                        decisionmod.NODE_GROUP_NOT_OWNED):
                    continue
            by_node.setdefault(p.node_id, []).append(p)
        if not by_node:
            return None, False
        best: Optional[PreemptPlan] = None
        examined = 0
        for node in sorted(by_node):
            if examined >= self.max_nodes:
                log.info("preemption search capped at %d nodes "
                         "(VTPU_PREEMPT_MAX_NODES); %d candidate(s) "
                         "unexamined", self.max_nodes,
                         len(by_node) - examined)
                break
            examined += 1
            plan = self.victims_for_node_locked(
                node, requests, annos, req_priority,
                pods=by_node[node])
            if plan is None:
                continue
            key = (len(plan.victims), plan.freed_mb, plan.node)
            if best is None or key < (len(best.victims),
                                      best.freed_mb, best.node):
                best = plan
        return best, True


def preemptor_key(namespace: str, name: str) -> str:
    """The vtpu.io/preempted-by value: who evicted the victim."""
    return f"{namespace}/{name}"


def victim_trace_detail(plan: PreemptPlan) -> List[Dict]:
    """The PREEMPTED DecisionTrace's victim list — exact pods, their
    priorities, and the MB each eviction frees (the acceptance
    surface: a victim's trace shows who evicted it and why, and the
    preemptor's trace shows exactly what it cost)."""
    return [{
        "pod": f"{v.namespace}/{v.name}", "uid": v.uid,
        "node": v.node_id, "priority": v.priority,
        "freed_mb": victim_mb(v), "freed_host_mb": v.host_mb,
        "migration_candidate": v.migration_candidate,
    } for v in plan.victims]


# the annotation key, re-exported so protocol consumers (tests, the
# monitor bridge) can import it from the engine module; defined in the
# vtpu/contracts.py registry (writer-confined to this module + core)
from ..api import PREEMPTED_BY_ANNO  # noqa: E402,F401
