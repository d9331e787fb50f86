"""Elastic quotas: the leader-gated live-resize control loop.

The port's copy of vtpu/scheduler/rebalancer.py, with one deliberate
difference (F11, ``_plan_container``): a container none of whose devices
has been charged a byte yet (no CUDA context) is never shrunk.

docs/elastic-quotas.md. Production serving load
breathes daily, but a pod's HBM quota was fixed at admission for its
lifetime. The pieces below close the loop the reference's vGPUmonitor
write-back channel only hinted at:

  * **signals** — the region observatory, scraped through each node
    monitor's ``/nodeinfo`` (per-pod usage + ``hbm_limit`` +
    quota-pressure counters ``near_limit_failures`` / ``at_limit_ns``
    + ``resize_gen`` confirming earlier intents landed);
  * **decisions** — grow a pressured pod toward
    ``usage * (1 + VTPU_RESIZE_HEADROOM_PCT/100)`` inside its chip's
    free headroom, shrink a padded pod back to the same envelope
    (hysteresis below keeps the loop from flapping); taken under the
    node's OWNING SHARD's decide lock, with the new quota written
    through the pod cache → :class:`UsageOverlay` in the same critical
    section — the freed/claimed headroom is visible to the very next
    admission fit, and ``verify_overlay`` stays drift-free because the
    commit rewrites ``vtpu.io/vtpu-ids`` to match;
  * **durability + fencing** — the decision rides the commit pipeline
    as the annotation ``vtpu.io/hbm-limit`` ("<gen>:<mb,...>") with
    uid + leadership-generation preconditions: a deposed leader's
    resize is refused before the wire (the fencing discipline),
    and a permanently-failed commit reverts the in-memory quota
    (core._on_commit_failed resize path);
  * **defragmentation** — report-only: pods whose migration would
    reclaim stranded fractional capacity get
    ``vtpu.io/migration-candidate`` + ``vGPUMigrationCandidates``;
    acting on them is the planner's and preemption's job.

The node monitor's :class:`~vtpu_torch.monitor.resize.ResizeApplier` is the
other half of the crash-safe two-phase protocol (intent record →
checked apply); this loop never touches a region directly.
"""

from __future__ import annotations

import json
import logging
import math
import threading
import urllib.error
import urllib.request
from concurrent import futures
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from .. import api
from ..trace import trace_id_for_uid
from ..trace import tracer as _tracer
from ..util import codec, types
from ..util.client import NotFoundError, PreconditionError
from ..util.env import env_float, env_str
from ..util.podutil import container_index_of_cache_entry
from ..util.types import ContainerDevice, PodDevices
from . import committer as committermod
from . import metrics as metricsmod
from . import migrate as migratemod

log = logging.getLogger(__name__)

MB = 1024 * 1024

#: loop period (config.md); 0 disables the loop entirely
REBALANCE_S_DEFAULT = 30.0
#: target headroom above observed usage, both as the grow target and
#: the shrink envelope (config.md)
RESIZE_HEADROOM_PCT_DEFAULT = 25.0
#: hysteresis: shrink only when the target releases at least this
#: fraction of the current quota (prevents grow/shrink flapping at the
#: headroom boundary)
SHRINK_MIN_RELEASE = 0.20
#: grow when usage crosses this fraction of the quota even without a
#: pressure event (the gate margin means the tenant is already paying
#: locked sweeps there)
GROW_USAGE_FRACTION = 0.90


@dataclass
class _PodSignal:
    """One /nodeinfo CONTAINER entry (`<uid>_<n>` region) joined with
    the scheduler's view — signals, like regions and intents, are
    per container."""

    namespace: str
    name: str
    uid: str
    node: str
    container: int                   # entry's container index (n)
    used_mb: List[int]
    limit_mb: List[int]
    near_limit_failures: int = 0
    at_limit_ns: int = 0


@dataclass
class _Plan:
    """Merged per-POD resize plan: one or more containers' target
    lists (the wire intent is pod-level, so all of a pod's container
    decisions must ride ONE commit — two tasks for the same key would
    coalesce last-writer-wins and drop one container's resize)."""

    namespace: str
    name: str
    uid: str
    node: str
    actions: List[str] = field(default_factory=list)  # grow/shrink
    #: container index -> per-device targets (unplanned containers
    #: keep their current quotas at apply time)
    ctr_targets: Dict[int, List[int]] = field(default_factory=dict)
    #: container index -> the quotas the plan was computed against
    ctr_quota: Dict[int, List[int]] = field(default_factory=dict)


class StaticNodeInfoSource:
    """Test/demo source: a dict of node → /nodeinfo payload."""

    def __init__(self, payloads: Optional[Dict[str, Dict]] = None) -> None:
        self.payloads: Dict[str, Dict] = payloads or {}

    def fetch(self) -> Dict[str, Dict]:
        return dict(self.payloads)


class HTTPNodeInfoSource:
    """Scrapes each registered node's monitor ``/nodeinfo`` endpoint
    (VTPU_MONITOR_URL_TEMPLATE, default ``http://{node}:9395/nodeinfo``)
    with If-None-Match so idle nodes answer 304 off their pre-serialized
    body. Per-node failures degrade to 'no signal from that node this
    round' — the loop must never stall on one dark monitor."""

    def __init__(self, nodes: Callable[[], List[str]],
                 url_template: Optional[str] = None,
                 timeout_s: float = 2.0) -> None:
        self.nodes = nodes
        self.url_template = url_template or env_str(
            api.ENV_MONITOR_URL_TEMPLATE, "http://{node}:9395/nodeinfo")
        self.timeout_s = timeout_s
        self._cache: Dict[str, Tuple[str, Dict]] = {}  # node -> (etag, body)

    #: bounded scrape concurrency: serial fetches would make the poll
    #: period collapse at fleet scale (10k nodes x 20ms each) and every
    #: dark monitor would add its full timeout to the round
    MAX_CONCURRENCY = 16

    def _fetch_one(self, node: str) -> Tuple[str, Optional[Dict]]:
        url = self.url_template.format(node=node)
        etag, cached = self._cache.get(node, ("", None))
        req = urllib.request.Request(url)
        if etag:
            req.add_header("If-None-Match", etag)
        try:
            with urllib.request.urlopen(
                    req, timeout=self.timeout_s) as resp:
                body = json.loads(resp.read().decode())
                self._cache[node] = (resp.headers.get("ETag", ""), body)
                return node, body
        except urllib.error.HTTPError as e:
            if e.code == 304 and cached is not None:
                return node, cached
            log.debug("nodeinfo scrape of %s failed: %s", node, e)
        except Exception as e:
            log.debug("nodeinfo scrape of %s failed: %s", node, e)
        return node, None

    def fetch(self) -> Dict[str, Dict]:
        nodes = list(self.nodes())
        if not nodes:
            return {}
        # nodes that left the cluster must not pin their last full
        # /nodeinfo body (KBs each) in this cluster-lifetime daemon
        live = set(nodes)
        for node in list(self._cache):
            if node not in live:
                self._cache.pop(node, None)
        out: Dict[str, Dict] = {}
        with futures.ThreadPoolExecutor(
                max_workers=min(self.MAX_CONCURRENCY,
                                len(nodes))) as pool:
            for node, body in pool.map(self._fetch_one, nodes):
                if body is not None:
                    out[node] = body
        return out


class Rebalancer:
    """The control loop. ``poll_once`` is the unit tests and the chaos
    harness drive; ``start`` runs it on a daemon thread every
    VTPU_REBALANCE_S seconds."""

    def __init__(self, scheduler, source,
                 period_s: Optional[float] = None,
                 headroom_pct: Optional[float] = None) -> None:
        self.s = scheduler
        self.source = source
        self.period_s = (period_s if period_s is not None
                         else env_float(api.ENV_REBALANCE_S,
                                        REBALANCE_S_DEFAULT, minimum=0.0))
        self.headroom_pct = (headroom_pct if headroom_pct is not None
                             else env_float(api.ENV_RESIZE_HEADROOM_PCT,
                                            RESIZE_HEADROOM_PCT_DEFAULT,
                                            minimum=0.0))
        #: last resize generation this process issued per pod uid
        #: (seeded from the pod's current annotation before each issue,
        #: so a failover continues the monotonic sequence)
        self._gens: Dict[str, int] = {}
        #: (near_limit_failures, at_limit_ns) seen per uid last poll —
        #: pressure triggers on DELTAS, not lifetime totals
        self._pressure: Dict[str, Tuple[int, int]] = {}
        #: pods currently annotated as migration candidates
        self._migration_marked: set = set()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------
    # signal collection (no locks, apiserver GETs allowed)
    # ------------------------------------------------------------------

    def _signals(self) -> List[_PodSignal]:
        out: List[_PodSignal] = []
        for node, payload in self.source.fetch().items():
            for entry in payload.get("containers", []) or []:
                ns = entry.get("pod_namespace") or ""
                name = entry.get("pod_name") or ""
                uid = entry.get("pod_uid") or ""
                if not ns or not name or not uid:
                    continue  # pod cache miss on the node: no identity
                ctr = container_index_of_cache_entry(
                    entry.get("entry", "") or f"{uid}_0")
                if ctr < 0:
                    continue
                used = [int(x) for x in entry.get("hbm_used", [])]
                limits = [int(x) for x in entry.get("hbm_limit", [])]
                profile = entry.get("profile") or {}
                pressure = profile.get("pressure") or {}
                out.append(_PodSignal(
                    namespace=ns, name=name, uid=uid, node=node,
                    container=ctr,
                    used_mb=[(u + MB - 1) // MB for u in used],
                    limit_mb=[(b + MB - 1) // MB for b in limits],
                    near_limit_failures=int(
                        pressure.get("near_limit_failures", 0)),
                    at_limit_ns=int(pressure.get("at_limit_ns", 0)),
                ))
        return out

    def _pressure_delta(self, sig: _PodSignal) -> bool:
        key = (sig.uid, sig.container)  # per REGION, like the counters
        prev = self._pressure.get(key)
        self._pressure[key] = (sig.near_limit_failures,
                               sig.at_limit_ns)
        if prev is None:
            # first observation: lifetime totals are history, not
            # current pressure (the feedback loop's baseline rule)
            return False
        return (sig.near_limit_failures > prev[0]
                or sig.at_limit_ns > prev[1])

    def _plan_container(self, sig: _PodSignal) -> Optional[
            Tuple[str, List[int], List[int]]]:
        """Grow/shrink decision for ONE container's region against the
        scheduler's cached assignment: (action, targets, quota) or
        None. Pure math — feasibility (chip headroom) is re-checked
        under the shard lock at apply time."""
        info = self.s.pods.get(sig.namespace, sig.name, sig.uid)
        if info is None or info.node_id != sig.node:
            return None
        if sig.container >= len(info.devices):
            return None  # region/assignment shape mismatch
        devs = info.devices[sig.container]
        if not devs or any(cd.usedmem <= 0 for cd in devs):
            return None  # whole-chip assignment: not resizable
        if len(sig.used_mb) < len(devs):
            return None  # region/assignment shape mismatch: no signal
        quota = [cd.usedmem for cd in devs]
        h = 1.0 + self.headroom_pct / 100.0
        desired = [max(1, int(math.ceil(sig.used_mb[i] * h)))
                   for i in range(len(devs))]
        pressured = self._pressure_delta(sig) or any(
            sig.used_mb[i] >= quota[i] * GROW_USAGE_FRACTION
            for i in range(len(devs)))
        if pressured and any(desired[i] > quota[i]
                             for i in range(len(devs))):
            targets = [max(desired[i], quota[i])
                       for i in range(len(devs))]
            return "grow", targets, quota
        # shrink: every device comfortable AND the release is material.
        # F11, a deliberate difference from the JAX rebalancer: never
        # while a device reads 0 MiB used. Every live CUDA process holds
        # its context's footprint in the region (libvgpu.so charges it),
        # so 0 MiB means a pod that attached before making its context;
        # the reference's rule would shrink it to 1 MiB and refuse its
        # first allocation.
        if (all(desired[i] <= quota[i] for i in range(len(devs)))
                and all(sig.used_mb[i] > 0 for i in range(len(devs)))
                and sum(quota) - sum(desired)
                >= SHRINK_MIN_RELEASE * sum(quota)):
            return "shrink", desired, quota
        return None

    def _next_gen(self, plan: _Plan) -> Optional[int]:
        """Monotonic per-pod resize generation: max(what this process
        issued, what the pod's annotation carries) + 1. The GET also
        re-checks the uid — a recreated pod must start a fresh
        sequence, never inherit the old one."""
        try:
            pod = self.s.client.get_pod(plan.namespace, plan.name)
        except NotFoundError:
            return None
        meta = pod.get("metadata", {}) or {}
        if meta.get("uid", "") not in ("", plan.uid):
            return None
        annos = meta.get("annotations", {}) or {}
        current = 0
        raw = annos.get(types.HBM_LIMIT_ANNO)
        if raw:
            try:
                current, _ = codec.decode_hbm_limit(raw)
            except codec.CodecError:
                # a GARBLED annotation may still carry a valid numeric
                # generation prefix — and the monitor's refused record
                # remembers it. Seeding from 0 here would issue
                # generations the applier drops as stale forever
                # (overlay quotas diverging from the region's enforced
                # limit); always climb past whatever the prefix says.
                try:
                    current = int(raw.split(":", 1)[0])
                except ValueError:
                    pass
        return max(current, self._gens.get(plan.uid, 0)) + 1

    # ------------------------------------------------------------------
    # apply (under the owning shard's decide lock)
    # ------------------------------------------------------------------

    @staticmethod
    def _rebuild_devices(devices: PodDevices,
                         targets: List[int]) -> PodDevices:
        """New PodDevices with per-flat-index usedmem targets (same
        chips, same cores, same container shape)."""
        out: PodDevices = []
        i = 0
        for ctr in devices:
            nctr = []
            for cd in ctr:
                nctr.append(ContainerDevice(
                    uuid=cd.uuid, type=cd.type, usedmem=targets[i],
                    usedcores=cd.usedcores))
                i += 1
            out.append(nctr)
        return out

    def _apply_shard_locked(self, shard, plans: List[Tuple[_Plan, int]],
                            generation: int,
                            sink: List, shard_group: int = 0) -> int:
        """Validate + apply one shard's merged per-pod plans; caller
        holds ``shard.lock``. Growth is capped to the chip's free
        headroom read from THIS shard's overlay inside the same
        critical section the write-through lands in — the resized
        quota is reflected in admission fit immediately, with no
        window where two growers could both claim the last free MB."""
        applied = 0
        for plan, gen in plans:
            info = self.s.pods.get(plan.namespace, plan.name, plan.uid)
            if info is None or info.node_id != plan.node:
                continue  # pod moved/vanished since collection
            stale = False
            for ctr, quota in plan.ctr_quota.items():
                if ctr >= len(info.devices) or \
                        [cd.usedmem for cd in info.devices[ctr]] != quota:
                    stale = True  # quota changed underneath: re-plan
                    break
            if stale:
                continue
            # per-flat targets: planned containers get their targets,
            # the rest keep their current quotas — ONE pod-level intent
            # (two same-key tasks would coalesce last-writer-wins)
            targets: List[int] = []
            for ci, c in enumerate(info.devices):
                targets.extend(plan.ctr_targets.get(
                    ci, [cd.usedmem for cd in c]))
            flat = [cd for ctr in info.devices for cd in ctr]
            quota_flat = [cd.usedmem for cd in flat]
            if "grow" in plan.actions:
                usage = shard.overlay.snapshot([plan.node]).get(plan.node)
                if usage is None:
                    continue
                # host-memory interplay: growing
                # an OFFLOADING pod's HBM quota grows its potential
                # host-RAM spill with it (param/optimizer state moves
                # between the two tiers) — before v8 this could push
                # the node's host commitment past capacity with no one
                # checking. Gate the grow on the node's host axis: the
                # total HBM delta must fit inside the host free
                # headroom (conservative 1:1 coupling), and a node
                # already over-committed (legacy-unlimited tenants)
                # grants no grows to offloaders at all.
                if info.host_mb > 0:
                    cap, committed = shard.overlay.host_state(
                        [plan.node]).get(plan.node, (0, 0))
                    grow_mb = sum(
                        max(0, plan.ctr_targets.get(ci, [])[j]
                            - cd.usedmem)
                        for ci, c in enumerate(info.devices)
                        if ci in plan.ctr_targets
                        for j, cd in enumerate(c))
                    if cap > 0 and grow_mb > 0 \
                            and committed + grow_mb > cap:
                        metricsmod.REBALANCE_SKIPPED_HEADROOM.inc()
                        log.info(
                            "%s/%s: grow of %dMB withheld — node %s "
                            "host-memory axis has %dMB free of %dMB "
                            "(offloading tenant must not outgrow the "
                            "host commitment)", plan.namespace,
                            plan.name, grow_mb, plan.node,
                            max(0, cap - committed), cap)
                        # strip ONLY the grows: a shrink merged into
                        # the same per-pod plan must still land —
                        # dropping the whole plan would strand
                        # reclaimable HBM exactly while the node is
                        # most constrained (the per-chip cap below
                        # has the same shrinks-proceed discipline)
                        for i, cd in enumerate(flat):
                            if targets[i] > cd.usedmem:
                                targets[i] = cd.usedmem
                free = {u.id: u.totalmem - u.usedmem for u in usage}
                for i, cd in enumerate(flat):
                    want = targets[i] - cd.usedmem
                    if want <= 0:
                        continue
                    grant = min(want, max(0, free.get(cd.uuid, 0)))
                    if grant < want:
                        metricsmod.REBALANCE_SKIPPED_HEADROOM.inc()
                    targets[i] = cd.usedmem + grant
                    free[cd.uuid] = free.get(cd.uuid, 0) - grant
            if targets == quota_flat:
                continue  # capped to a no-op
            new_devices = self._rebuild_devices(info.devices, targets)
            # per-CONTAINER segments on the wire (each container has
            # its own region; the applier indexes segments by the
            # entry's container index, never a pod-wide flat offset)
            per_ctr: List[List[int]] = []
            i = 0
            for c in info.devices:
                per_ctr.append(targets[i:i + len(c)])
                i += len(c)
            action = "+".join(sorted(set(plan.actions)))
            with _tracer.span(trace_id_for_uid(plan.uid),
                              "rebalance.decide",
                              pod=f"{plan.namespace}/{plan.name}",
                              node=plan.node, action=action,
                              gen=gen,
                              targets_mb=",".join(str(t)
                                                  for t in targets)):
                # write-through: the overlay delta lands here, inside
                # the shard's decide lock — the next filter() on this
                # shard already fits against the resized quota. The
                # pod's HOST reservation rides along unchanged: a
                # re-add without it would silently retract the node's
                # host commitment on every resize
                self.s.pods.add_pod(
                    plan.namespace, plan.name, plan.uid,
                    plan.node, new_devices, host_mb=info.host_mb,
                    priority=info.priority, group=info.group,
                    migration_candidate=info.migration_candidate)
            annos = {
                types.HBM_LIMIT_ANNO: codec.encode_hbm_limit(
                    gen, per_ctr),
                types.ASSIGNED_IDS_ANNO: codec.encode_pod_devices(
                    new_devices),
            }
            if generation:
                annos[types.SCHED_GEN_ANNO] = str(generation)
            sink.append(committermod.CommitTask(
                namespace=plan.namespace, name=plan.name, uid=plan.uid,
                node_id=plan.node, devices=new_devices,
                annotations=annos, trace_id=trace_id_for_uid(plan.uid),
                generation=generation, shard_group=shard_group,
                resize=True, prev_devices=info.devices))
            self._gens[plan.uid] = gen
            for a in plan.actions:
                if a == "grow":
                    metricsmod.REBALANCE_GROWS.inc()
                else:
                    metricsmod.REBALANCE_SHRINKS.inc()
            applied += 1
        return applied

    # ------------------------------------------------------------------
    # the loop
    # ------------------------------------------------------------------

    def poll_once(self) -> int:
        """One control-loop round; returns the number of resize
        decisions submitted. Ownership-gated end to end: an instance
        owning nothing (or whose fencing validity lapsed — generation
        0) collects nothing and writes nothing. Under multi-active
        (docs/ha.md) the gate is PER SHARD GROUP: every instance runs
        this loop, each acting only on pods whose node lives in a
        group it owns, stamping that group's own generation — N
        rebalancers cover the fleet disjointly."""
        if self.s.ha is not None and not self.s.ha.is_leader():
            return 0
        multi = (self.s.shards.n_groups > 1
                 and self.s.ha is not None)
        generation = self.s._fence_generation()
        if self.s.ha is not None and not multi and generation == 0:
            return 0
        signals = self._signals()
        if multi:
            # per-group scope: drop signals for nodes another instance
            # owns BEFORE any planning (the plan phase does apiserver
            # GETs — N instances each re-planning the whole fleet
            # would multiply that load by N for work they must refuse)
            signals = [
                sig for sig in signals
                if self.s._owns_group(self.s.shards.group_of(sig.node))
            ]
        if signals:
            # prune per-pod state for pods no longer observed anywhere:
            # a control loop meant to run for the cluster's lifetime
            # must not accumulate dead uids forever. (Skipped when the
            # whole fetch came back empty — a transiently dark fleet
            # must not wipe every pressure baseline.) A pruned-then-
            # reappearing pod just re-baselines: one delayed grow
            # trigger, no correctness impact (_next_gen re-reads the
            # annotation, so generations stay monotonic regardless.)
            seen = {sig.uid for sig in signals}
            for key in list(self._pressure):
                if key[0] not in seen:
                    self._pressure.pop(key, None)
            for uid in list(self._gens):
                if uid not in seen:
                    self._gens.pop(uid, None)
        # plan phase: no locks held (apiserver GETs happen here).
        # Container decisions MERGE into one plan per pod — the intent
        # annotation is pod-level, so a pod's containers must ride one
        # commit.
        merged: Dict[Tuple[str, str, str], _Plan] = {}
        for sig in signals:
            if self.s.committer.pending(f"{sig.namespace}/{sig.name}"):
                continue  # an earlier decision is still in flight
            decided = self._plan_container(sig)
            if decided is None:
                continue
            action, targets, quota = decided
            key = (sig.namespace, sig.name, sig.uid)
            plan = merged.get(key)
            if plan is None:
                plan = merged[key] = _Plan(
                    namespace=sig.namespace, name=sig.name,
                    uid=sig.uid, node=sig.node)
            plan.actions.append(action)
            plan.ctr_targets[sig.container] = targets
            plan.ctr_quota[sig.container] = quota
        plans: List[Tuple[_Plan, int]] = []
        for plan in merged.values():
            gen = self._next_gen(plan)
            if gen is not None:
                plans.append((plan, gen))
        applied = 0
        if plans:
            by_shard: Dict[int, List[Tuple[_Plan, int]]] = {}
            for plan, gen in plans:
                by_shard.setdefault(
                    self.s.shards.shard_index(plan.node),
                    []).append((plan, gen))
            for idx, shard_plans in sorted(by_shard.items()):
                gen_g = generation
                if multi:
                    # stamp the SHARD's group generation; a group lost
                    # since the signal filter above is skipped (its
                    # new owner re-plans from the same annotations)
                    gen_g = self.s._fence_generation(
                        self.s.shards.shard_group(idx))
                    if gen_g == 0:
                        continue
                shard = self.s.shards.shards[idx]
                sink: List[committermod.CommitTask] = []
                with shard.lock:
                    applied += self._apply_shard_locked(
                        shard, shard_plans, gen_g, sink,
                        shard_group=(self.s.shards.shard_group(idx)
                                     if multi else 0))
                    if sink:
                        # inside the lock, like the batch decider: a
                        # resync can never observe the new quota cached
                        # without its commit pending
                        self.s.committer.submit_many(sink)
        self._propose_migrations(signals)
        return applied

    def _mark_cached(self, ns: str, name: str, uid: str,
                     value: bool) -> None:
        """Write a migration mark through to the decide cache under the
        pod's owning route lockset — the same single-writer discipline
        as every other pod-cache write: an unlocked attribute write
        racing a resync could drop (or resurrect) a mark for a round."""
        info = self.s.pods.get(ns, name, uid)
        if info is None:
            return
        with self.s.shards.route([info.node_id]).lockset:
            info = self.s.pods.get(ns, name, uid)
            if info is not None:
                info.migration_candidate = value

    def _propose_migrations(self, signals: List[_PodSignal]) -> None:
        """Report-only defragmentation: a node whose total free HBM
        could host a half-chip tenant that no SINGLE chip can take is
        fragmented; propose moving its smallest resizable pod.
        Annotation-driven so the planner and preemption can
        act on it; nothing here evicts anything."""
        # defrag loop closure: a mark whose pod
        # was preempted/deleted must be CLEARED from the tracked set on
        # the next sweep — a stale (ns, name, uid) entry would keep
        # retrying a name-keyed clear forever, and once the name is
        # recycled by a NEW pod instance that clear would erase the new
        # pod's own legitimate mark (and the preemption engine's victim
        # preference with it). Drop entries whose uid no longer matches
        # a live cached pod; clears below only ever target the SAME
        # instance (uid re-checked against the live object).
        gone = set()
        for key in self._migration_marked:
            ns, name, uid = key
            if self.s.pods.get(ns, name, uid) is not None:
                continue
            try:
                live = self.s.client.get_pod(ns, name)
                if (live.get("metadata", {}) or {}).get("uid",
                                                        "") == uid:
                    continue  # cache lag: the pod still exists
            except NotFoundError:
                pass
            except Exception as e:
                # transient apiserver failure: keep the mark, re-check
                # next sweep (dropping it on a blip would strand a
                # stale "1" on a live pod)
                log.debug("stale-mark check of %s/%s deferred: %s",
                          ns, name, e)
                continue
            # deleted, or the name now belongs to a different
            # instance: the mark died with the pod object — never
            # patch the successor
            gone.add(key)
        if gone:
            log.info("dropping %d stale migration-candidate mark(s) "
                     "for deleted/recycled pods", len(gone))
            self._migration_marked -= gone
        by_node: Dict[str, List[_PodSignal]] = {}
        for sig in signals:
            by_node.setdefault(sig.node, []).append(sig)
        marked_now: set = set()
        for node, sigs in by_node.items():
            usage = self.s.overlay.snapshot([node]).get(node)
            if not usage:
                continue
            free = [u.totalmem - u.usedmem for u in usage]
            chip = max((u.totalmem for u in usage), default=0)
            if not chip or len(free) < 2:
                continue
            if sum(free) >= chip // 2 and max(free) < chip // 2:
                candidates = [
                    s for s in sigs
                    if self.s.pods.get(s.namespace, s.name, s.uid)
                    is not None
                ]
                if not candidates:
                    continue
                # rank by freed-fragment VALUE, not pod size: the
                # smallest pod is the cheapest move but often leaves
                # the same fragment stranded (its quota sits on the
                # chip that stays shared either way). What the next
                # arrival needs is a WHOLE free chip — prefer the pod
                # whose departure completes one, then the largest
                # resulting fragment, then the cheapest move; uid
                # tie-breaks deterministically
                # (tests/test_migrate.py pins the regression).
                ranked = []
                for s in candidates:
                    info = self.s.pods.get(s.namespace, s.name, s.uid)
                    if info is None:
                        continue
                    ranked.append((migratemod.fragment_value(
                        usage, migratemod.pod_chip_mb(info.devices)),
                        s.uid, s))
                if not ranked:
                    continue
                best = max(ranked, key=lambda t: (t[0], t[1]))[2]
                marked_now.add((best.namespace, best.name, best.uid))
        for key in list(marked_now - self._migration_marked):
            ns, name, uid = key
            try:
                self.s.client.patch_pod_annotations(
                    ns, name, {types.MIGRATION_CANDIDATE_ANNO: "1"})
                # write the mark through to the decide cache so the
                # migration planner (and the preemption engine's
                # victim preference) acts on it THIS round instead of
                # after the next full resync
                self._mark_cached(ns, name, uid, True)
            except NotFoundError:
                marked_now.discard(key)
            except Exception as e:
                # transient apiserver failure: the mark never landed —
                # drop it from the marked set so the next round RETRIES
                # instead of reporting an annotation that doesn't exist
                marked_now.discard(key)
                log.warning("migration-candidate mark of %s/%s failed "
                            "(will retry): %s", ns, name, e)
        still_marked = set()
        to_clear = sorted(self._migration_marked - marked_now)
        if to_clear:
            # ONE uid-preconditioned bulk clear for the whole set (the
            # verb evaluates each precondition against the live
            # object, so a name recycled between the prune above and
            # this patch can never have the NEW pod's annotations
            # touched for the OLD mark); per-item outcomes keep the
            # exact retry/skip semantics without N serial RPCs
            try:
                results = self.s.client.patch_pods_annotations_bulk(
                    [(ns, name,
                      {types.MIGRATION_CANDIDATE_ANNO: None},
                      {"uid": uid} if uid else None)
                     for ns, name, uid in to_clear])
            except Exception as e:
                # transport failure: every stale "1" may still be on a
                # LIVE pod — keep them all so the clear retries next
                # round (the preemption engine acting on a stale mark
                # would prefer the wrong victim)
                still_marked.update(to_clear)
                log.warning("migration-candidate bulk clear of %d "
                            "mark(s) failed (will retry): %s",
                            len(to_clear), e)
                results = []
            for key, res in zip(to_clear, results):
                if res is None or isinstance(
                        res, (NotFoundError, PreconditionError)):
                    self._mark_cached(*key, value=False)
                    continue  # cleared, or pod gone/recycled with it
                still_marked.add(key)  # per-item transient: retry
                log.warning("migration-candidate clear of %s/%s failed "
                            "(will retry): %s", key[0], key[1], res)
        self._migration_marked = marked_now | still_marked
        metricsmod.MIGRATION_CANDIDATES.set(len(marked_now))

    def run(self) -> None:
        while not self._stop.is_set():
            try:
                self.poll_once()
            except Exception:
                log.exception("rebalance poll failed")
            self._stop.wait(self.period_s or REBALANCE_S_DEFAULT)

    def start(self) -> "Rebalancer":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self.run, name="vtpu-rebalancer", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
