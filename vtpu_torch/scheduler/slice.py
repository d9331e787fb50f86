"""Multi-host slice gang placement (SURVEY §7 step 7).

The port's copy of vtpu/scheduler/slice.py.

The reference has no analog — its MLULink ring allocators are strictly
intra-node (mlu/allocator/board.go:44-118) — but it is the one genuinely
TPU-shaped scheduling problem: a v4/v5p slice's ICI torus SPANS hosts,
so a job of N cooperating pods (one per host) wants hosts that are
adjacent in the slice's host-level mesh; non-adjacent hosts force
collectives through intermediate chips or DCN.

Design: gang-by-reservation. Pods carry

    tpu.google.com/slice-group: <name>   # gang id (namespace-scoped)
    tpu.google.com/slice-hosts: N        # gang width

The first member to reach Filter solves for N hosts of ONE slice whose
host coordinates form a contiguous sub-mesh — the same solver that
places chips inside a host (vtpu/parallel/mesh.py), applied one level
up — and reserves them in scheduler memory; each member consumes one
reserved host and then goes through the normal per-chip scoring
restricted to that host. Refilters are idempotent (keyed by pod uid).

A reservation is placement AFFINITY, not admission: no chips are held
until each pod binds, and an incomplete gang's reservation expires
after RESERVATION_TTL_S — the nodelock expiry discipline (reference
nodelock.go:94-102) — so stragglers cannot deadlock capacity. Members
whose assignment was CONFIRMED (the scheduler patched their device
annotations — `confirm_placed`) survive a reservation drop: the
re-solve must include their hosts in the new block, or fail, so a
capacity-driven re-solve can never double-book one host for two gang
members. Confirmed placements do not self-expire; they are released
when the pod goes away — `release_pod` from the delete hook, or
`reconcile` from the scheduler's sync_pods poll, which drops members
whose uid no longer holds a live assignment (with a grace window so a
just-confirmed pod can't be reaped by a stale pod list).
docs/multihost.md is the ADR, including the deliberate non-goal
(atomic all-or-nothing gang admission needs a pod-group CRD /
co-scheduler, outside the reference's architecture).

Durability (docs/ha.md): confirmed members are no longer memory-only.
Each confirming commit stamps the gang's solved block into the member's
annotations (types.SLICE_BLOCK_ANNO), and `rebuild` reconstructs the
whole store — placed members AND the live reservation — from one pass
over live pods (Scheduler.recover), so a scheduler crash between a
gang's first and last member neither strands the block nor lets the
restarted/promoted scheduler re-solve confirmed members onto
conflicting hosts.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..parallel import mesh
from ..util.types import MeshCoord
from ..util import lockdebug

log = logging.getLogger(__name__)

RESERVATION_TTL_S = 300.0  # nodelock.go:94-102 expiry discipline
# a confirmed member must survive at least this long even if a pod
# list fetched just before its annotation patch omits it (4 poll
# periods of core.REGISTER_POLL_S)
RECONCILE_GRACE_S = 60.0
# an assigned-but-unconfirmed member protects its host from re-solves
# for at most this long; a filter() that died without confirming or
# invalidating must not pin the host forever
PENDING_TTL_S = 60.0
# a host whose chips failed scoring is soft-avoided in re-solves for
# this long: without it, the deterministic solver re-picks the same
# best-scored block and the gang livelocks on a full host while a
# feasible alternative block exists
AVOID_TTL_S = 60.0


@dataclass
class Reservation:
    slice_name: str
    hosts: List[str]                 # node ids, assignment order
    assigned: Dict[str, str] = field(default_factory=dict)  # uid -> node
    created: float = field(default_factory=time.time)
    # mesh geometry of the solved block (docs/multihost.md "mesh env
    # contract"): the sub-mesh box shape and each host's BLOCK-RELATIVE
    # coordinate, positional with `hosts`. Stamped into the slice-block
    # annotation so Allocate can inject VTPU_MESH_SHAPE/COORDS/AXES.
    # Empty = unknown (v1 blocks, unknown topology) — members still
    # place correctly, only the mesh env is withheld.
    shape: Tuple[int, int, int] = (0, 0, 0)
    coords: Tuple[Tuple[int, int, int], ...] = ()


@dataclass(frozen=True)
class RebuiltMember:
    """One live gang member reconstructed from the annotation bus
    (docs/ha.md): its own durable assignment plus — when the member's
    commit stamped it — the whole solved block, so stragglers keep
    landing on the block the dead leader chose."""

    namespace: str
    group: str
    uid: str
    node: str
    name: str = ""     # pod name (trace stitching only)
    slice_name: str = ""
    hosts: tuple = ()  # solved block, assignment order ("" block = unknown)
    assigned_ns: int = 0  # ASSIGNED_TIME_ANNO: orders blocks by recency
    # mesh geometry recovered from a v2 slice-block annotation (None on
    # v1/garbled geometry): restored into the rebuilt reservation so
    # stragglers placed after a failover still get the mesh env
    shape: Optional[tuple] = None
    coords: Optional[tuple] = None


class SliceReservations:
    """In-memory gang reservations, keyed by (namespace, group)."""

    def __init__(self) -> None:
        self._lock = lockdebug.lock("scheduler.slices")
        self._res: Dict[Tuple[str, str], Reservation] = {}
        # uid -> (node, t_confirmed) for members whose assignment the
        # scheduler actually annotated (confirm_placed). These must
        # survive a reservation drop — a re-solve builds around them —
        # and never self-expire; reconcile()/release_pod() retire them
        # when the pod goes away.
        self._placed: Dict[Tuple[str, str],
                           Dict[str, Tuple[str, float]]] = {}
        # uid -> (node, t_assigned) for members BETWEEN node_for's
        # assignment and confirm_placed. Their scoring runs outside the
        # lock (routes.py thread pool), so a concurrent invalidate +
        # re-solve must build the new block around these hosts too —
        # otherwise the re-solve can hand a pending member's host to a
        # different member and both confirm on it (double-book).
        # Entries expire after PENDING_TTL_S; invalidate(pod_uid=...)
        # clears only the failing pod's own entry.
        self._pending: Dict[Tuple[str, str],
                            Dict[str, Tuple[str, float]]] = {}
        # host -> t_failed per gang: hosts whose chips failed scoring,
        # soft-avoided by _solve until AVOID_TTL_S passes (usage frees)
        self._avoid: Dict[Tuple[str, str], Dict[str, float]] = {}

    def node_for(
        self,
        key: Tuple[str, str],
        pod_uid: str,
        n_hosts: int,
        candidates: Dict[str, Tuple[str, Optional[MeshCoord]]],
    ) -> Tuple[Optional[str], str]:
        """The node this gang member should land on.

        candidates: node id -> (slice name, host coord) for every node
        currently registered with slice membership AND offered to this
        pod by kube-scheduler (the extender must never answer with a
        node outside the pod's offered list). Returns
        (node or None, failure reason)."""
        now = time.time()
        with self._lock:
            self._prune_pending(key, now)
            placed = self._placed_nodes(key)
            pending = self._pending_nodes(key)
            res = self._res.get(key)
            if res and now - res.created > RESERVATION_TTL_S:
                log.warning("slice gang %s reservation expired with "
                            "%d/%d members placed", key,
                            len(res.assigned), len(res.hosts))
                del self._res[key]
                res = None
            if res is None:
                res, reason = self._solve(key, n_hosts, candidates,
                                          placed, pending)
                if res is None:
                    return None, reason
                self._res[key] = res
            if pod_uid in res.assigned:
                node = res.assigned[pod_uid]  # refilter: idempotent
                if node not in candidates:
                    # even a confirmed member may only be answered with
                    # an OFFERED node (extender contract): a cordoned
                    # host is a refusal, not a phantom placement — and
                    # it must NOT refresh the pending hold, or a
                    # never-landable host stays pinned past its TTL
                    return None, (
                        f"reserved host {node} is not in this pod's "
                        f"feasible node set")
                # refresh the pending hold while scoring retries (a
                # confirmed member's entry was already retired)
                if pod_uid not in self._placed.get(key, {}):
                    self._pending.setdefault(key, {})[pod_uid] = (
                        node, now)
                return node, ""
            taken = set(res.assigned.values())
            feasible_skipped = []
            for node in res.hosts:
                if node in taken:
                    continue
                if node not in candidates:
                    feasible_skipped.append(node)
                    continue
                # assignment only — the member becomes durable when the
                # scheduler confirms the annotation patch succeeded
                # (confirm_placed); an assignment whose scoring then
                # fails dies with the reservation instead of pinning
                # the pod to an infeasible host. Until then the pending
                # record keeps concurrent re-solves from handing this
                # host to another member mid-scoring.
                res.assigned[pod_uid] = node
                self._pending.setdefault(key, {})[pod_uid] = (node, now)
                return node, ""
            if feasible_skipped:
                return None, (
                    f"reserved host(s) {feasible_skipped} are not in "
                    f"this pod's feasible node set")
            return None, (f"gang {key[1]} already has "
                          f"{len(res.hosts)} members placed")

    def _placed_nodes(self, key) -> Dict[str, str]:
        """uid -> node of confirmed members (lock held)."""
        return {uid: node
                for uid, (node, _) in self._placed.get(key, {}).items()}

    def _pending_nodes(self, key) -> Dict[str, str]:
        """uid -> node of assigned-but-unconfirmed members (lock
        held; prune first)."""
        return {uid: node
                for uid, (node, _) in self._pending.get(key, {}).items()}

    def _prune_pending(self, key, now: float) -> None:
        entry = self._pending.get(key)
        if not entry:
            return
        for uid, (node, t) in list(entry.items()):
            if now - t > PENDING_TTL_S:
                log.warning("slice gang %s pending member %s (host %s) "
                            "never confirmed; dropping its hold", key,
                            uid, node)
                del entry[uid]
        if not entry:
            self._pending.pop(key, None)

    def _prune_avoid(self, key, now: float) -> None:
        entry = self._avoid.get(key)
        if not entry:
            return
        for host, t in list(entry.items()):
            if now - t > AVOID_TTL_S:
                del entry[host]
        if not entry:
            self._avoid.pop(key, None)

    def confirm_placed(self, key: Tuple[str, str], pod_uid: str,
                       node: str) -> None:
        """The scheduler wrote this member's device annotations on
        `node`: the assignment is now durable (survives reservation
        drops, released only by release_pod/reconcile). The node comes
        from the caller, not the reservation — a concurrent
        invalidate() between node_for and the annotation patch must
        not cost a bound member its double-book protection."""
        with self._lock:
            self._placed.setdefault(key, {})[pod_uid] = (node,
                                                         time.time())
            pend = self._pending.get(key)
            if pend is not None:
                pend.pop(pod_uid, None)
                if not pend:
                    self._pending.pop(key, None)
            res = self._res.get(key)
            if res is not None:
                # keep the live reservation's taken-set consistent even
                # if it was re-solved while this member was mid-patch
                res.assigned.setdefault(pod_uid, node)

    def block_of(self, key: Tuple[str, str]):
        """(slice name, solved host block, shape, block-relative
        coords) of the live reservation — what the committer stamps
        into each confirmed member's annotations
        (types.SLICE_BLOCK_ANNO, v2 wire form) so both the block AND
        its mesh geometry survive this process. shape/coords are None
        when geometry is unknown (v1-rebuilt blocks, unknown topology).
        None when the gang has no live reservation."""
        with self._lock:
            res = self._res.get(key)
            if res is None:
                return None
            if res.coords and len(res.coords) == len(res.hosts):
                return (res.slice_name, list(res.hosts), res.shape,
                        list(res.coords))
            return res.slice_name, list(res.hosts), None, None

    def rebuild(self, members,
                preserve_after: Optional[float] = None) -> int:
        """Crash-recovery rebuild (docs/ha.md): replace ALL in-memory
        gang state with what the annotation bus proves. `members` is an
        iterable of RebuiltMember decoded from live pods (one pass over
        the pod list — Scheduler.recover builds it).

        Invariants restored:
          * every member with durable assignment annotations is PLACED
            (confirmed at `now`, so a pod list fetched before the
            member's patch cannot reap it — the RECONCILE_GRACE_S
            discipline holds across the rebuild);
          * the solved block (when any member's SLICE_BLOCK_ANNO names
            one that covers every member) becomes the live reservation,
            created at `now` — unconfirmed stragglers fall back to the
            ordinary RESERVATION_TTL_S discipline;
          * members whose pods died with the old leader simply do not
            appear: their slots are free, nothing leaks;
          * confirms stamped at/after `preserve_after` survive the
            clear — the rebuild's pod list was fetched at that moment,
            so a confirm that raced in between the list and this call
            (a dead leader's in-flight commit landing mid-recover,
            delivered by the watch) is NEWER than the list and must not
            be erased (the watch never re-delivers it).

        Returns the number of members restored."""
        now = time.time()
        by_key: Dict[Tuple[str, str], List[RebuiltMember]] = {}
        for m in members:
            by_key.setdefault((m.namespace, m.group), []).append(m)
        with self._lock:
            preserved: Dict[Tuple[str, str],
                            Dict[str, Tuple[str, float]]] = {}
            if preserve_after is not None:
                for key, entry in self._placed.items():
                    keep = {uid: (node, t)
                            for uid, (node, t) in entry.items()
                            if t >= preserve_after}
                    if keep:
                        preserved[key] = keep
            self._res.clear()
            self._placed.clear()
            self._pending.clear()
            self._avoid.clear()
            count = 0
            for key, ms in by_key.items():
                nodes = {m.uid: m.node for m in ms}
                self._placed[key] = {uid: (node, now)
                                     for uid, node in nodes.items()}
                count += len(nodes)
                # adopt a stamped block only when it covers every
                # member's host — a block that cannot have produced
                # these placements (garbled/partial annotations) is
                # dropped, and the next straggler re-solves AROUND the
                # placed hosts instead (never double-booking them).
                # Members can carry DIFFERENT blocks (a mid-gang
                # re-solve between confirming commits); the NEWEST
                # covering one wins, deterministically — the commit's
                # ASSIGNED_TIME stamp orders them, uid breaks ties (pod
                # list order must not decide which block a crash
                # recovers)
                block = None
                block_member = None
                for m in sorted(ms, key=lambda m: (m.assigned_ns,
                                                   m.uid)):
                    if not m.hosts:
                        continue
                    if set(nodes.values()) <= set(m.hosts):
                        block = (m.slice_name, list(m.hosts))
                        block_member = m
                if block is None:
                    if any(m.hosts for m in ms):
                        log.warning(
                            "slice gang %s: stamped block(s) do not "
                            "cover the members' hosts %s; dropping the "
                            "block (stragglers re-solve around placed "
                            "members)", key, sorted(nodes.values()))
                    continue
                shape, coords = (0, 0, 0), ()
                if (block_member is not None
                        and block_member.shape is not None
                        and block_member.coords is not None
                        and len(block_member.coords) == len(block[1])):
                    shape = tuple(block_member.shape)
                    coords = tuple(tuple(c)
                                   for c in block_member.coords)
                self._res[key] = Reservation(
                    slice_name=block[0], hosts=block[1],
                    assigned=dict(nodes), created=now,
                    shape=shape, coords=coords)
            # merge back confirms newer than the rebuild's pod list
            for key, entry in preserved.items():
                tgt = self._placed.setdefault(key, {})
                res = self._res.get(key)
                for uid, (node, t) in entry.items():
                    if uid not in tgt:
                        tgt[uid] = (node, t)
                        count += 1
                    if res is not None:
                        res.assigned.setdefault(uid, node)
            if count:
                log.info("rebuilt %d gang member placement(s) across %d "
                         "gang(s) from the annotation bus", count,
                         len(by_key))
            return count

    def reconcile(self, live_uids,
                  grace: float = RECONCILE_GRACE_S) -> None:
        """Retire confirmed members whose pod no longer holds a live
        assignment (sync_pods poll). The grace window keeps a member
        confirmed moments ago from being reaped by a pod list fetched
        before its annotation patch landed."""
        now = time.time()
        with self._lock:
            for key in list(self._placed):
                entry = self._placed[key]
                dead = [uid for uid, (node, t) in entry.items()
                        if uid not in live_uids and now - t > grace]
                for uid in dead:
                    node, _ = entry.pop(uid)
                    log.info("slice gang %s member %s (host %s) gone "
                             "from the pod cache; releasing its slot",
                             key, uid, node)
                    res = self._res.get(key)
                    if res:
                        res.assigned.pop(uid, None)
                if not entry:
                    del self._placed[key]
            # gangs that never re-solve would otherwise leak their
            # _avoid/_pending/_res entries forever (scheduler lives for
            # months; gang names churn) — expire them on the same poll
            for key in list(self._pending):
                self._prune_pending(key, now)
            for key in list(self._avoid):
                self._prune_avoid(key, now)
            for key in list(self._res):
                if now - self._res[key].created > RESERVATION_TTL_S:
                    del self._res[key]

    def _solve(
        self,
        key: Tuple[str, str],
        n_hosts: int,
        candidates: Dict[str, Tuple[str, Optional[MeshCoord]]],
        placed: Dict[str, str],
        pending: Optional[Dict[str, str]] = None,
    ) -> Tuple[Optional[Reservation], str]:
        """Pick n_hosts adjacent hosts from one slice; any
        already-placed member's host MUST be inside the chosen block,
        and so must any pending (assigned, mid-scoring) member's —
        otherwise a re-solve racing an unconfirmed member could hand
        its host to someone else (lock held)."""
        by_slice: Dict[str, Dict[str, Optional[MeshCoord]]] = {}
        for node, (slice_name, coord) in candidates.items():
            if slice_name and coord is not None:
                by_slice.setdefault(slice_name, {})[node] = coord
        pending = dict(pending or {})
        # a uid that is both confirmed and pending keeps the confirmed
        # record; hosts from either must anchor the new block
        for uid in placed:
            pending.pop(uid, None)
        anchored = {**pending, **placed}
        placed_hosts = set(anchored.values())
        now = time.time()
        self._prune_avoid(key, now)
        # soft tabu: prefer blocks without recently-failed hosts, but
        # fall back to them rather than refuse a solvable gang
        avoid = set(self._avoid.get(key, {})) - placed_hosts
        best: Optional[mesh.Candidate] = None
        best_slice = ""
        for skip_avoided in ((True, False) if avoid else (False,)):
            for slice_name, hosts in by_slice.items():
                if skip_avoided:
                    hosts = {h: c for h, c in hosts.items()
                             if h not in avoid}
                if len(hosts) < n_hosts:
                    continue
                if placed_hosts and not placed_hosts <= set(hosts):
                    # a bound member's host is missing from this pod's
                    # view of the slice: the block can't be verified to
                    # contain it, so this slice can't serve the
                    # re-solve
                    continue
                for cand in mesh.enumerate_submeshes(hosts, n_hosts):
                    if placed_hosts and not placed_hosts <= set(
                            cand.chips):
                        continue
                    if best is None or cand.score > best.score:
                        best = cand
                        best_slice = slice_name
            if best is not None:
                break
        if best is None:
            if placed_hosts:
                return None, (
                    f"no contiguous {n_hosts}-host block contains the "
                    f"already-placed member host(s) "
                    f"{sorted(placed_hosts)}")
            return None, (
                f"no slice offers {n_hosts} hosts forming a contiguous "
                f"host-mesh block (slices seen: "
                f"{sorted(by_slice) or 'none'})")
        log.info("slice gang %s reserved hosts %s on slice %s "
                 "(shape %s)", key, best.chips, best_slice, best.shape)
        # block-relative geometry: normalize the solver's absolute
        # slice coords to the block origin so the annotation (and the
        # VTPU_MESH_COORDS env derived from it) is translation-free
        shape, coords = (0, 0, 0), ()
        if best.coords and len(best.coords) == len(best.chips):
            lo = tuple(min(c[a] for c in best.coords) for a in range(3))
            coords = tuple(tuple(c[a] - lo[a] for a in range(3))
                           for c in best.coords)
            shape = best.shape
        return Reservation(slice_name=best_slice,
                           hosts=list(best.chips),
                           assigned=dict(anchored),
                           shape=shape, coords=coords), ""

    def invalidate(self, key: Tuple[str, str],
                   failed_host: Optional[str] = None,
                   pod_uid: Optional[str] = None) -> None:
        """Drop a reservation whose host stopped fitting; the next
        member re-solves, soft-avoiding `failed_host` for AVOID_TTL_S
        so the deterministic solver doesn't re-pick the exact block
        that just failed. Already-placed members keep their hosts via
        the placed record; other members' pending holds survive too —
        only the failing pod's own pending entry is cleared (its host
        must not anchor the re-solve, it just failed there)."""
        with self._lock:
            self._res.pop(key, None)
            pend = self._pending.get(key)
            if pend is not None:
                if pod_uid:
                    pend.pop(pod_uid, None)
                if failed_host:
                    # a pending hold on the failed host can only be the
                    # failing pod's own (the taken-set keeps two members
                    # off one host); it must not anchor the re-solve to
                    # the host that just refused it
                    for uid, (node, _) in list(pend.items()):
                        if node == failed_host:
                            del pend[uid]
                if not pend:
                    self._pending.pop(key, None)
            if failed_host:
                self._avoid.setdefault(key, {})[failed_host] = \
                    time.time()

    def release_pod(self, key: Tuple[str, str], pod_uid: str) -> None:
        """A gang member went away (pod deleted / bind unwound): free
        its slot so a recreated pod (new uid) can take it."""
        with self._lock:
            res = self._res.get(key)
            if res:
                res.assigned.pop(pod_uid, None)
            for store in (self._placed, self._pending):
                entry = store.get(key)
                if entry:
                    entry.pop(pod_uid, None)
                    if not entry:
                        del store[key]
