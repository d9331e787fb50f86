"""Live migration planner: the defrag loop that MOVES instead of kills.

The port's copy of vtpu/scheduler/migrate.py.

docs/migration.md is the ADR. The
rebalancer proposes defrag marks (``vtpu.io/migration-candidate``) and
The preemption engine *evicts* marked pods when an arrival needs the
room — but stranded fractional capacity with no arrival pressure just
sat there, and every defrag was a kill. This leader-gated control loop
(started beside the rebalancer, same per-shard-group gating under
multi-active scheduling) closes the loop with a crash-safe
drain → snapshot → reschedule → resume pipeline:

  * **phase A — plan + stamp**: marked pods are ranked by
    :func:`fragment_value` — does moving THIS pod complete a whole free
    chip? — highest yield first (not "smallest pod", the earlier bug a
    regression test pins). The destination is scored through
    the normal decide path (``_score_candidates_locked`` under the
    owned shards' route locks), the destination reservation
    write-through lands in the same critical section, and the durable
    ``vtpu.io/migrating-to = "<gen>:<node>;<chips>"`` stamp rides the
    commit pipeline with uid + group-generation preconditions — a
    deposed owner's move is refused before the wire.
  * **phase B — cutover**: the node monitor's drain coordinator
    (vtpu/monitor/migrate.py) turns the stamp into the workload
    handshake and publishes ``migrate_state`` on /nodeinfo; once every
    region of the source replica acks ``snapshotted`` the planner
    commits the cutover — assignment annotations rewritten to the
    destination, stamp cleared, ``vtpu.io/migrated-from`` recorded for
    the destination Allocate's env replay — and swaps the in-memory
    entry in one overlay transaction (byte-exact: source chips + host
    axis release in the same step the destination claim becomes live).
  * **phase C — completion**: once the destination region attaches
    (its entry appears on /nodeinfo) the migrated-from record is
    cleared; a refused drain or an expired deadline aborts the move
    (and for preempt-rescue victims falls back to the classic delete,
    so a guaranteed arrival is never delayed past
    ``VTPU_MIGRATE_DEADLINE_S``).

Failover: every phase is durable-first, so ``Scheduler.recover()``
rebuilds the destination reservation from the stamp and the absorbing
owner's planner continues the move from wherever it stopped —
exactly-once per absorption, the group-scoped replay discipline
(tests/test_migrate_chaos.py SIGKILLs the owner at every boundary).

Deliberate limits (docs/migration.md): gang members never migrate
(their slice solve is host-shaped); uncooperative workloads never ack
and fall back to preemption delete; one move in flight per planner by
default (``VTPU_MIGRATE_MAX_INFLIGHT``).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, List, Optional, Tuple

from .. import api
from ..trace import trace_id_for_uid
from ..trace import tracer as _tracer
from ..util import codec, podutil, types
from ..util.client import NotFoundError, PreconditionError
from ..util.env import env_float, env_int
from ..util.types import PodDevices
from . import committer as committermod
from . import metrics as metricsmod
from . import score as scoremod
from .core import MIG_RESERVATION_SUFFIX
from .pods import PodInfo

log = logging.getLogger(__name__)

#: planner loop period (config.md); 0 disables the loop entirely
MIGRATE_S_DEFAULT = 30.0
#: concurrent moves per planner instance (config.md) — migration is a
#: background optimization; one move at a time keeps the blast radius
#: of a bad destination bounded
MIGRATE_MAX_INFLIGHT_DEFAULT = 1


def pod_chip_mb(devices: PodDevices) -> Dict[str, int]:
    """Per-chip HBM MB a pod's quota pins, summed across containers."""
    out: Dict[str, int] = {}
    for ctr in devices:
        for cd in ctr:
            out[cd.uuid] = out.get(cd.uuid, 0) + cd.usedmem
    return out


def fragment_value(usage, pod_mb: Dict[str, int]) -> Tuple[int, int, int]:
    """Defrag yield of moving ONE pod off its node, as a sort key
    (descending): (whole chips its departure completes, best free
    fragment MB after the move, -moved MB). The first member is the
    fix for the earlier "smallest pod" ranking: moving the smallest tenant
    often leaves the SAME fragment stranded — what matters is whether
    the move completes a whole free chip (or slice host) that the next
    whole/half-chip arrival can actually use. Ties prefer the largest
    resulting fragment, then the cheapest move (fewest bytes gathered
    and shipped)."""
    free = {u.id: u.totalmem - u.usedmem for u in usage}
    total = {u.id: u.totalmem for u in usage}
    wholes = sum(
        1 for uu, q in pod_mb.items()
        if q > 0 and total.get(uu, 0) > 0
        and free.get(uu, 0) + q >= total[uu])
    best_after = max(
        (free[uu] + pod_mb.get(uu, 0) for uu in free), default=0)
    return (wholes, best_after, -sum(pod_mb.values()))


def requests_of_devices(
        devices: PodDevices) -> List[types.ContainerDeviceRequest]:
    """Re-synthesize the per-container requests a pod's current
    assignment answers — what the destination must fit. usedmem 0
    (whole-chip assignment) round-trips as memreq 0 (whole-chip
    request), the codec's own convention."""
    return [types.ContainerDeviceRequest(
                nums=len(ctr), type=ctr[0].type,
                memreq=max(cd.usedmem for cd in ctr),
                coresreq=max(cd.usedcores for cd in ctr))
            for ctr in devices if ctr]


class MigrationPlanner:
    """The control loop. ``poll_once`` is what the unit tests, the
    chaos harness, and the soak drive; ``start`` runs it on a daemon
    thread every VTPU_MIGRATE_S seconds. ``source`` is a /nodeinfo
    source (rebalancer.HTTPNodeInfoSource in production,
    StaticNodeInfoSource in tests)."""

    def __init__(self, scheduler, source,
                 period_s: Optional[float] = None,
                 deadline_s: Optional[float] = None,
                 clock=time.time) -> None:
        self.s = scheduler
        self.source = source
        self.period_s = (period_s if period_s is not None
                         else env_float(api.ENV_MIGRATE_S,
                                        MIGRATE_S_DEFAULT, minimum=0.0))
        self.deadline_s = (deadline_s if deadline_s is not None
                           else scheduler.migrate_deadline_s)
        self.max_inflight = env_int(api.ENV_MIGRATE_MAX_INFLIGHT,
                                    MIGRATE_MAX_INFLIGHT_DEFAULT,
                                    minimum=1)
        self.clock = clock
        #: last migration generation this process issued per pod uid
        self._gens: Dict[str, int] = {}
        #: uid -> when this process stamped/first observed the move
        #: (the planner-side deadline for non-rescue moves; resets on
        #: failover — the absorbing owner restarts the clock, a
        #: documented deliberate limit)
        self._started: Dict[str, float] = {}
        #: uid -> first all-snapshotted observation (blackout metric)
        self._snap_seen: Dict[str, float] = {}
        #: cutovers awaiting phase-C completion (dest region attach)
        self._cleanup: Dict[str, Tuple[str, str, str]] = {}
        #: uid -> not-before time for re-planning after a refusal or
        #: deadline expiry (a workload that just said no — or never
        #: answered — is not re-drained until a full deadline passes)
        self._cooldown: Dict[str, float] = {}
        # chaos kill points (tests/test_migrate_chaos.py): raise a
        # BaseException — the SIGKILL stand-in — right after the
        # corresponding durable write lands
        self.kill_after_stamp = None
        self.kill_after_cutover = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------
    # signal collection
    # ------------------------------------------------------------------

    def _drain_states(self) -> Dict[str, List[Tuple[int, str, str]]]:
        """uid -> [(migrate_gen, migrate_state, node)] across every
        monitored region entry (the DrainCoordinator's published
        handshake state; also how phase C observes the destination
        region attach)."""
        out: Dict[str, List[Tuple[int, str, str]]] = {}
        for node, payload in self.source.fetch().items():
            for entry in payload.get("containers", []) or []:
                uid = entry.get("pod_uid") or ""
                if not uid:
                    continue
                try:
                    gen = int(entry.get("migrate_gen", 0) or 0)
                except (TypeError, ValueError):
                    gen = 0
                out.setdefault(uid, []).append(
                    (gen, str(entry.get("migrate_state", "") or ""),
                     node))
        return out

    def _reservations(self) -> List[PodInfo]:
        return [p for p in self.s.pods.list_pods()
                if p.name.endswith(MIG_RESERVATION_SUFFIX)]

    def _owned_reservations(self, owned) -> List[PodInfo]:
        """Reservations for moves THIS planner drives. The pod cache is
        rebuilt globally (every resync mirrors every stamp), but under
        multi-active a move belongs to its SOURCE pod's shard group —
        the same scoping _continue_moves applies — falling back to the
        destination's group for rescue moves whose source entry was
        granted away with the preemption decision. Counting other
        owners' in-flight moves against max_inflight would let one
        slow move in group A stop group B's planner from planning at
        all — the opposite of the N-concurrent-planners design."""
        resvs = self._reservations()
        if owned is None:
            return resvs
        out = []
        for r in resvs:
            src = self.s.pods.get(
                r.namespace, r.name[:-len(MIG_RESERVATION_SUFFIX)],
                r.uid[:-len(MIG_RESERVATION_SUFFIX)])
            node = src.node_id if src is not None else r.node_id
            if self.s.shards.group_of(node) in owned:
                out.append(r)
        return out

    def _next_gen(self, uid: str, annos: Dict[str, str],
                  fence_gen: int) -> int:
        """Monotonic per-move generation: strictly above whatever the
        pod's annotations carry (a failed-over planner continues the
        sequence from the durable record), whatever this process
        issued, and the fencing generation."""
        cur = self._gens.get(uid, 0)
        raw = annos.get(types.MIGRATED_FROM_ANNO)
        if raw:
            try:
                cur = max(cur, codec.decode_migrated_from(raw)[0])
            except codec.CodecError:
                pass
        raw = annos.get(types.MIGRATING_TO_ANNO)
        if raw:
            try:
                cur = max(cur, codec.decode_migrating_to(raw)[0])
            except codec.CodecError:
                pass
        self.s.note_migrate_gen(cur)
        return self.s.next_migrate_gen(fence_gen)

    def _forget(self, uid: str) -> None:
        self._started.pop(uid, None)
        self._snap_seen.pop(uid, None)

    # ------------------------------------------------------------------
    # the loop
    # ------------------------------------------------------------------

    def poll_once(self) -> int:
        """One control round; returns the number of protocol steps
        taken (stamps, cutovers, aborts, completions). Ownership-gated
        end to end, per shard group under multi-active — N planners
        drive disjoint moves (the group-scoped discipline)."""
        if self.s.ha is not None and not self.s.ha.is_leader():
            return 0
        multi = (self.s.shards.n_groups > 1 and self.s.ha is not None)
        if self.s.ha is not None and not multi \
                and self.s._fence_generation() == 0:
            return 0
        owned = None
        if multi:
            owned = self.s._owned_groups()
            if not owned:
                return 0
        # adopt phase-C watches recover() re-seeded from durable
        # migrated-from breadcrumbs (cutover committed, planner died
        # before the destination attach closed the protocol)
        seed = getattr(self.s, "_migrate_cleanup_seed", None)
        while seed:
            uid, rec = seed.popitem()
            self._cleanup.setdefault(uid, rec)
        states = self._drain_states()
        acted = self._continue_moves(states, owned)
        acted += self._complete_moves(states)
        inflight = len(self._owned_reservations(owned))
        if inflight < self.max_inflight:
            acted += self._plan_moves(owned,
                                      self.max_inflight - inflight)
        return acted

    # -- in-flight moves: drive cutover / abort / fallback -----------------

    def _continue_moves(self, states, owned) -> int:
        n = 0
        for resv in self._reservations():
            ns = resv.namespace
            name = resv.name[:-len(MIG_RESERVATION_SUFFIX)]
            uid = resv.uid[:-len(MIG_RESERVATION_SUFFIX)]
            try:
                pod = self.s.client.get_pod(ns, name)
            except NotFoundError:
                # the pod died mid-move: the reservation dies with it
                self._drop_reservation(ns, name, uid, resv.node_id)
                continue
            except Exception as e:
                log.debug("migration check of %s/%s deferred: %s",
                          ns, name, e)
                continue
            meta = pod.get("metadata", {}) or {}
            if meta.get("uid", "") not in ("", uid):
                self._drop_reservation(ns, name, uid, resv.node_id)
                continue
            annos = meta.get("annotations", {}) or {}
            stamp = annos.get(types.MIGRATING_TO_ANNO, "")
            if not stamp:
                # cutover or abort already durable: the annotation bus
                # retracts the reservation; nothing to drive
                self._forget(uid)
                continue
            try:
                gen, dest, devices = codec.decode_migrating_to(stamp)
            except codec.CodecError as e:
                log.error("pod %s/%s: undecodable migration stamp: %s",
                          ns, name, e)
                continue
            self._gens[uid] = max(self._gens.get(uid, 0), gen)
            src = annos.get(types.ASSIGNED_NODE_ANNO, "")
            if owned is not None and src \
                    and self.s.shards.group_of(src) not in owned:
                continue  # another owner's move: ITS planner drives it
            src_states = [(g, s) for g, s, node in states.get(uid, [])
                          if node == src]
            rescue = bool(annos.get(types.PREEMPTED_BY_ANNO))
            snapped = bool(src_states) and all(
                g == gen and s == "snapshotted" for g, s in src_states)
            refused = any(g == gen and s == "refused"
                          for g, s in src_states)
            started = self._started.setdefault(uid, self.clock())
            if snapped:
                t0 = self._snap_seen.setdefault(uid, self.clock())
                if self._cutover(pod, gen, src, dest, devices, rescue):
                    metricsmod.MIGRATE_BLACKOUT.observe(
                        max(0.0, self.clock() - t0))
                    n += 1
                continue
            deadline = 0.0
            try:
                deadline = float(
                    annos.get(types.MIGRATE_DEADLINE_ANNO, "0") or 0)
            except ValueError:
                pass
            expired = (deadline and self.clock() > deadline) or (
                not deadline and self.deadline_s > 0
                and self.clock() - started > self.deadline_s)
            if refused or expired:
                if self._abort(pod, gen, src, dest, rescue, refused):
                    n += 1
        return n

    def _cutover(self, pod: Dict, gen: int, src: str, dest: str,
                 devices: PodDevices, rescue: bool) -> bool:
        """Phase B: the destination assignment becomes the durable
        truth in ONE fenced commit; the in-memory swap (reservation →
        live entry, source usage → destination usage) is one overlay
        transaction under the touched shards' locks — byte-exact, no
        window where the chips are counted zero or twice."""
        meta = pod.get("metadata", {}) or {}
        ns = meta.get("namespace", "default")
        name = meta.get("name", "")
        uid = meta.get("uid", "")
        annos = meta.get("annotations", {}) or {}
        shard_group, generation = 0, 0
        if self.s.shards.n_groups > 1 and self.s.ha is not None:
            shard_group = self.s.shards.group_of(dest)
            generation = self.s._fence_generation(shard_group)
            if generation == 0:
                return False  # dest group lost mid-move: retry/absorb
        elif self.s.ha is not None:
            generation = self.s._fence_generation()
            if generation == 0:
                return False
        patch = podutil.device_annotations(dest, devices)
        patch[types.MIGRATED_FROM_ANNO] = \
            codec.encode_migrated_from(gen, src)
        patch[types.MIGRATING_TO_ANNO] = None
        # the defrag mark is spent: leaving it would make the next
        # planner round ping-pong the pod straight back (the
        # rebalancer re-marks if the NEW placement fragments too)
        patch[types.MIGRATION_CANDIDATE_ANNO] = None
        if rescue:
            # the rescued victim lives again: both preemption stamps
            # clear with the same cutover commit
            patch[types.PREEMPTED_BY_ANNO] = None
            patch[types.MIGRATE_DEADLINE_ANNO] = None
        if generation:
            patch[types.SCHED_GEN_ANNO] = str(generation)
        route = self.s.shards.route([src, dest] if src else [dest])
        with route.lockset:
            self.s.pods.del_pod(ns, name + MIG_RESERVATION_SUFFIX,
                                uid + MIG_RESERVATION_SUFFIX)
            # add_pod's re-add delta swaps source usage out and
            # destination usage in atomically (for a rescue there is
            # no source entry — its capacity was granted away with the
            # preemption decision)
            self.s.pods.add_pod(
                ns, name, uid, dest, devices,
                host_mb=scoremod.host_mem_request_mb(annos),
                priority=podutil.task_priority_of(annos))
            with _tracer.span(trace_id_for_uid(uid), "migrate.cutover",
                              pod=f"{ns}/{name}", src=src, dest=dest,
                              gen=gen, rescue=rescue):
                self.s.committer.submit_task(committermod.CommitTask(
                    namespace=ns, name=name, uid=uid, node_id=dest,
                    devices=devices, annotations=patch,
                    trace_id=trace_id_for_uid(uid),
                    generation=generation, shard_group=shard_group,
                    migrate=True))
        metricsmod.MIGRATIONS.labels("cutover").inc()
        log.info("migration cutover: %s/%s %s -> %s (gen %d%s)",
                 ns, name, src or "?", dest, gen,
                 ", rescued" if rescue else "")
        self._forget(uid)
        self._cleanup[uid] = (ns, name, dest)
        if self.kill_after_cutover is not None:
            self.kill_after_cutover()
        return True

    def _abort(self, pod: Dict, gen: int, src: str, dest: str,
               rescue: bool, refused: bool) -> bool:
        """Refused drain or expired deadline: unwind the move. A
        planner move just clears its stamp (the workload keeps
        running at the source, untouched); a preempt-rescue falls back
        to the delete the rescue replaced — the guaranteed arrival's
        capacity was granted at decision time and is never delayed
        past the deadline."""
        meta = pod.get("metadata", {}) or {}
        ns = meta.get("namespace", "default")
        name = meta.get("name", "")
        uid = meta.get("uid", "")
        if rescue:
            route = self.s.shards.route([dest])
            with route.lockset:
                self.s.pods.del_pod(ns, name + MIG_RESERVATION_SUFFIX,
                                    uid + MIG_RESERVATION_SUFFIX)
            with _tracer.span(trace_id_for_uid(uid),
                              "migrate.fallback", pod=f"{ns}/{name}",
                              refused=refused):
                # vtpulint: ignore[VTPU015] rescue fallback: the planner completes the phase-2 delete the rescue suspended (stamp already durable)
                self.s._complete_eviction(ns, name, uid)
            metricsmod.MIGRATIONS.labels("fallback_delete").inc()
            log.warning("migration rescue of %s/%s %s; falling back "
                        "to preemption delete", ns, name,
                        "refused" if refused else "expired")
            self._forget(uid)
            return True
        shard_group, generation = 0, 0
        if self.s.shards.n_groups > 1 and self.s.ha is not None:
            shard_group = self.s.shards.group_of(src) if src else 0
            generation = self.s._fence_generation(shard_group)
            if generation == 0:
                return False
        elif self.s.ha is not None:
            generation = self.s._fence_generation()
            if generation == 0:
                return False
        patch: Dict[str, Optional[str]] = {
            types.MIGRATING_TO_ANNO: None}
        if generation:
            patch[types.SCHED_GEN_ANNO] = str(generation)
        info = self.s.pods.get(ns, name, uid)
        route = self.s.shards.route([src, dest] if src else [dest])
        with route.lockset:
            self.s.pods.del_pod(ns, name + MIG_RESERVATION_SUFFIX,
                                uid + MIG_RESERVATION_SUFFIX)
            self.s.committer.submit_task(committermod.CommitTask(
                namespace=ns, name=name, uid=uid,
                node_id=src or (info.node_id if info else ""),
                devices=(info.devices if info else []),
                annotations=patch, trace_id=trace_id_for_uid(uid),
                generation=generation, shard_group=shard_group,
                migrate=True))
        metricsmod.MIGRATIONS.labels(
            "aborted" if refused else "expired").inc()
        log.warning("migration of %s/%s %s; stamp cleared, workload "
                    "stays at %s", ns, name,
                    "refused by workload" if refused
                    else "deadline expired", src or "?")
        self._forget(uid)
        self._cooldown[uid] = self.clock() + self.deadline_s
        return True

    def _drop_reservation(self, ns: str, name: str, uid: str,
                          dest: str) -> None:
        route = self.s.shards.route([dest])
        with route.lockset:
            self.s.pods.del_pod(ns, name + MIG_RESERVATION_SUFFIX,
                                uid + MIG_RESERVATION_SUFFIX)
        self._forget(uid)

    # -- phase C: completion ----------------------------------------------

    def _complete_moves(self, states) -> int:
        """Clear vtpu.io/migrated-from once the destination region is
        observed attached on /nodeinfo — the durable record exists
        precisely so the destination Allocate (and its checkpoint
        replay) can see where the pod came from; once the region is
        live the protocol is complete."""
        n = 0
        for uid, (ns, name, dest) in list(self._cleanup.items()):
            attached = any(node == dest
                           for _g, _s, node in states.get(uid, []))
            if not attached:
                continue
            try:
                res = self.s.client.patch_pods_annotations_bulk(
                    [(ns, name, {types.MIGRATED_FROM_ANNO: None},
                      {"uid": uid})])
                err = res[0] if res else None
            except Exception as e:
                log.debug("migrated-from clear of %s/%s deferred: %s",
                          ns, name, e)
                continue
            if err is None or isinstance(err, (NotFoundError,
                                               PreconditionError)):
                self._cleanup.pop(uid, None)
                metricsmod.MIGRATIONS.labels("completed").inc()
                n += 1
        return n

    # -- phase A: plan new moves -------------------------------------------

    def _plan_moves(self, owned, budget: int) -> int:
        """Rank this round's defrag marks by freed-fragment value and
        start the highest-yield moves (up to `budget`)."""
        inflight = {p.uid[:-len(MIG_RESERVATION_SUFFIX)]
                    for p in self._reservations()}
        now = self.clock()
        for uid, t in list(self._cooldown.items()):
            if t <= now:
                del self._cooldown[uid]
        ranked = []
        for p in self.s.pods.list_pods():
            if not p.migration_candidate or p.group \
                    or p.name.endswith(MIG_RESERVATION_SUFFIX) \
                    or p.uid in inflight \
                    or self._cooldown.get(p.uid, 0.0) > now:
                continue
            if owned is not None \
                    and self.s.shards.group_of(p.node_id) not in owned:
                continue
            if self.s.committer.pending(f"{p.namespace}/{p.name}"):
                continue  # an earlier decision is still in flight
            usage = self.s.overlay.snapshot([p.node_id]).get(p.node_id)
            if not usage:
                continue
            ranked.append((fragment_value(usage,
                                          pod_chip_mb(p.devices)), p))
        ranked.sort(key=lambda t: (t[0], t[1].uid), reverse=True)
        n = 0
        for _val, p in ranked:
            if budget <= 0:
                break
            if self._start_move(p, owned):
                n += 1
                budget -= 1
        return n

    def _start_move(self, p: PodInfo, owned) -> bool:
        """Phase A for one pod: score a destination through the normal
        decide path under the owned shards' route locks, write the
        destination reservation through in the same critical section,
        and submit the fenced migrating-to stamp."""
        ns, name, uid = p.namespace, p.name, p.uid
        try:
            pod = self.s.client.get_pod(ns, name)
        except NotFoundError:
            return False
        except Exception as e:
            log.debug("migration plan GET of %s/%s failed: %s",
                      ns, name, e)
            return False
        meta = pod.get("metadata", {}) or {}
        if meta.get("uid", "") not in ("", uid):
            return False  # recycled name: the mark died with the pod
        annos = meta.get("annotations", {}) or {}
        if annos.get(types.MIGRATING_TO_ANNO) \
                or annos.get(types.PREEMPTED_BY_ANNO):
            return False  # already moving / already being evicted
        multi = (self.s.shards.n_groups > 1 and self.s.ha is not None)
        shard_group, generation = 0, 0
        if multi:
            shard_group = self.s.shards.group_of(p.node_id)
            generation = self.s._fence_generation(shard_group)
            if generation == 0:
                return False
        elif self.s.ha is not None:
            generation = self.s._fence_generation()
            if generation == 0:
                return False
        gen = self._next_gen(uid, annos, generation)
        # destination pool: every owned registered node except the
        # source (cross-group destinations ride the same owned-route
        # consolidation order as cross-group gangs)
        pool = [n for n in self.s.nodes.list_nodes()
                if n != p.node_id
                and (owned is None
                     or self.s.shards.group_of(n) in owned)]
        if not pool:
            metricsmod.MIGRATIONS.labels("no_destination").inc()
            return False
        allowed = None
        if multi:
            allowed = frozenset(
                i for i in range(self.s.shards.count)
                if self.s.shards.shard_group(i) in owned)
        route = self.s.shards.route(pool)
        with route.lockset:
            info = self.s.pods.get(ns, name, uid)
            if info is None or info.node_id != p.node_id \
                    or info.devices != p.devices:
                return False  # moved/resized underneath: re-plan
            reqs = requests_of_devices(info.devices)
            if not reqs:
                return False
            score_annos = ({types.HOST_MEM_ANNO: str(info.host_mb)}
                           if info.host_mb else {})
            scores, _failed = self.s._score_candidates_locked(
                route, pool, reqs, score_annos, None,
                allowed_shards=allowed)
            if not scores:
                metricsmod.MIGRATIONS.labels("no_destination").inc()
                return False
            dest = scores[0]
            patch: Dict[str, str] = {
                types.MIGRATING_TO_ANNO: codec.encode_migrating_to(
                    gen, dest.node_id, dest.devices)}
            if generation:
                patch[types.SCHED_GEN_ANNO] = str(generation)
            # destination reservation write-through INSIDE the same
            # critical section the fit was scored in: no concurrent
            # admission can claim the scored chips first, and the
            # submit lands under the lock like every decision commit
            # (a resync sees either no reservation or a pending stamp)
            self.s.pods.add_pod(
                ns, name + MIG_RESERVATION_SUFFIX,
                uid + MIG_RESERVATION_SUFFIX, dest.node_id,
                dest.devices, host_mb=info.host_mb,
                priority=types.TASK_PRIORITY_HIGH)
            with _tracer.span(trace_id_for_uid(uid), "migrate.plan",
                              pod=f"{ns}/{name}", src=p.node_id,
                              dest=dest.node_id, gen=gen):
                self.s.committer.submit_task(committermod.CommitTask(
                    namespace=ns, name=name, uid=uid,
                    node_id=p.node_id, devices=info.devices,
                    annotations=patch,
                    trace_id=trace_id_for_uid(uid),
                    generation=generation, shard_group=shard_group,
                    migrate=True))
        self._gens[uid] = gen
        self.s.note_migrate_gen(gen)
        self._started[uid] = self.clock()
        metricsmod.MIGRATIONS.labels("planned").inc()
        log.info("migration planned: %s/%s %s -> %s (gen %d, "
                 "fragment yield via freed-fragment ranking)",
                 ns, name, p.node_id, dest.node_id, gen)
        if self.kill_after_stamp is not None:
            self.kill_after_stamp()
        return True

    # ------------------------------------------------------------------

    def run(self) -> None:
        while not self._stop.is_set():
            try:
                self.poll_once()
            except Exception:
                log.exception("migration poll failed")
            self._stop.wait(self.period_s or MIGRATE_S_DEFAULT)

    def start(self) -> "MigrationPlanner":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self.run, name="vtpu-migrate", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
