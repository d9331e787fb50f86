"""Sharded decide plane: concurrent non-overlapping admission.

The port's copy of vtpu/scheduler/shard.py.

The decision/commit split made ``filter()`` a pure in-memory decision, but every decision
still serialized on ONE ``_decide_lock`` — two pods landing on disjoint
node pools that cannot possibly conflict queued behind each other, and
every filter re-probed O(candidates) per-node verdicts even when
nothing it could see had changed. At the 10k-node / 1k-pods-per-minute
scale ROADMAP item 1 targets, that single decide domain is the front
door's bottleneck.

This module partitions the decide state into **shards**:

  * Every node belongs to exactly one :class:`DecideShard`, keyed by
    its node-pool label (``VTPU_SHARD_KEY_LABEL``, default the GKE
    nodepool label) or, for slice hosts, its slice name — so the nodes
    a nodeSelector-constrained pod can land on, and the hosts a gang
    can span, live together. Unpooled nodes fall back to a
    deterministic ``crc32(node) % shards`` hash.
  * Each shard owns its own decide lock, :class:`UsageOverlay`,
    :class:`VerdictCache`, and scoreboards — a filter touching one
    pool locks one shard; filters over disjoint pools decide
    CONCURRENTLY.
  * A request whose candidate set spans shards (gang solves over a
    mislabeled slice, whole-cluster candidate lists) takes the touched
    shards' locks in canonical (ascending-index) order — the same
    discipline :class:`ShardLockSet` uses for the "all shards" barrier
    the event/recovery paths need. lockdebug names every shard lock
    distinctly (``scheduler.decide.sNN``), so any out-of-order acquire
    raises :class:`~vtpu.util.lockdebug.LockOrderError` in the stress
    tests instead of deadlocking a 10k-node cluster at 3am.

The per-shard **scoreboard** is where the throughput comes from on a
GIL-bound interpreter: when a request's candidate set covers a whole
shard (the pool-aligned case kube-scheduler produces for nodeSelector
workloads, and the whole-cluster case), the shard keeps one
incrementally-maintained scored set per request signature, synced by
the overlay's mutation log (:meth:`UsageOverlay.changes_since`). A
filter then pays O(nodes mutated since the last same-shaped decision)
— typically just the previous winner — instead of O(candidates)
per-node verdict probes. A single global decide domain structurally
cannot do this for pool-sized candidate sets: no aggregation unit
aligns with them. benchmarks/sched_bench.py ``--sharded`` measures the
A/B (gated ≥3x at 4096 nodes, docs/benchmark.md).

Shard assignment is routing state only — nothing durable depends on
it, so a restart may re-deal pools to different shards freely. Pool →
shard is first-seen round-robin (perfect balance); node → shard moves
are rare (a node gaining its pool label after its usage was cached)
and migrate the node's overlay state under the full lock barrier
(``DecideShards.assign``).
"""

from __future__ import annotations

import threading
import time
import zlib
from bisect import bisect_left, insort
from collections import OrderedDict
from typing import Dict, FrozenSet, Iterable, List, Optional, Set, Tuple

from .. import api
from ..trace.decision import NODE_UNREGISTERED, Rejection
from ..util import lockdebug
from ..util.env import env_int
from ..util.types import DeviceUsage, PodDevices  # noqa: F401 (API surface)
from . import metrics as metricsmod
from . import overlay as overlaymod
from . import score as scoremod

#: default shard count (VTPU_DECIDE_SHARDS); 1 degenerates to the
#: classic single-decide-lock scheduler
DEFAULT_DECIDE_SHARDS = 8
#: node label whose value keys pool→shard routing (VTPU_SHARD_KEY_LABEL)
DEFAULT_SHARD_KEY_LABEL = "cloud.google.com/gke-nodepool"
#: retained Route objects per (routing-epoch, candidate-list) — bounds
#: the cache when kube-scheduler's candidate lists churn arbitrarily
ROUTE_CACHE_CAP = 512


class ShardLockSet:
    """Ordered multi-lock over a fixed shard subset (canonical =
    ascending shard index, the order the constructor receives).

    Stateless across acquisitions, so one instance is safely shared by
    every thread (Scheduler._decide_lock is the all-shards instance).
    ``acquire(timeout=...)`` is all-or-nothing: a partial acquire rolls
    back so a timed-out caller never strands a subset of the locks."""

    __slots__ = ("_locks",)

    def __init__(self, locks: List) -> None:
        self._locks = locks

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        deadline = (None if timeout is None or timeout < 0
                    else time.monotonic() + timeout)
        got = []
        for lk in self._locks:
            if not blocking:
                ok = lk.acquire(False)
            elif deadline is None:
                ok = lk.acquire()
            else:
                ok = lk.acquire(True, max(0.0,
                                          deadline - time.monotonic()))
            if not ok:
                for g in reversed(got):
                    g.release()
                return False
            got.append(lk)
        return True

    def release(self) -> None:
        for lk in reversed(self._locks):
            lk.release()

    def __enter__(self) -> "ShardLockSet":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()


class _Board:
    """One (shard, request-signature) scored set, incrementally
    maintained: ``synced`` is the shard-overlay version every entry is
    current at; ``order`` keeps the fitting nodes sorted best-first as
    ``(-score, node)`` tuples so the top-k read is a slice, not a
    per-filter sort."""

    __slots__ = ("synced", "scores_by_node", "failed", "order")

    def __init__(self, synced: int,
                 scores_by_node: Dict[str, scoremod.NodeScore],
                 failed: Dict[str, Rejection]) -> None:
        self.synced = synced
        self.scores_by_node = scores_by_node
        self.failed = failed
        self.order: List[Tuple[float, str]] = sorted(
            (-s.score, n) for n, s in scores_by_node.items())


class DecideShard:
    """One decide domain: lock + overlay + verdicts + scoreboards.

    Everything here is guarded by ``self.lock`` (lockdebug name
    ``scheduler.decide.sNN``): the ``*_shard_locked`` methods document
    — and hack/vtpulint.py VTPU010 enforces — that callers hold it."""

    #: scored-set entries retained per shard (LRU by request signature)
    BOARD_LRU = 32
    #: best-first entries a shard contributes to the cross-shard merge
    #: (winner + DecisionTrace.MAX_RUNNERS_UP, with slack)
    TOP_K = 8

    def __init__(self, index: int) -> None:
        self.index = index
        self.name = f"s{index:02d}"
        self.lock = lockdebug.lock(f"scheduler.decide.{self.name}")
        self.overlay = overlaymod.UsageOverlay(
            lock_name=f"scheduler.overlay.{self.name}")
        self.verdicts = scoremod.VerdictCache()
        self.boards: "OrderedDict[object, _Board]" = OrderedDict()
        # test/diagnostic counters (board reuse is the perf claim)
        self.board_hits = 0
        self.board_rebuilds = 0
        # pre-resolved metric child: .labels() costs a lock + dict probe
        # per call, so resolve once here instead of on the filter path
        self.filters_metric = metricsmod.DECIDE_SHARD_FILTERS.labels(
            self.name)

    # -- coverage ----------------------------------------------------------

    def coverage_shard_locked(
        self, group_set: FrozenSet[str]
    ) -> Tuple[bool, Tuple[str, ...]]:
        """Does the candidate set cover every node of this shard (the
        scoreboard's soundness condition — scoring the whole shard must
        never answer with a node kube-scheduler did not offer)?
        Also returns the named-but-unregistered extras so the caller
        can reject them individually. Caller holds self.lock; inventory
        mutation is excluded because it runs under ALL decide locks."""
        members = self.overlay.members()
        if not members <= group_set:
            return False, ()
        if len(group_set) > len(members):
            return True, tuple(n for n in group_set if n not in members)
        return True, ()

    # -- scoring -----------------------------------------------------------

    def score_shard_locked(
        self, sig, requests, annos,
    ) -> Tuple[List[scoremod.NodeScore], int, Dict[str, Rejection],
               int, int, int]:
        """Whole-shard scoring via the scoreboard. Caller holds
        self.lock. Returns (top best-first, fit count, failed copy,
        cache hits, cache misses, registered candidates)."""
        board = self.boards.get(sig)
        changed: Optional[Set[str]] = None
        cur = 0
        if board is not None:
            cur, changed = self.overlay.changes_since(board.synced)
        misses = 0
        # the host axis is consulted only for pods that RESERVE host
        # memory (the board is keyed by a signature that includes the
        # demand, so a demand-0 board built without host_state stays
        # sound); legacy pods — the rollout majority — pay nothing
        want_host = scoremod.host_mem_request_mb(annos) > 0
        if board is None or changed is None:
            ver, usage = self.overlay.snapshot_versioned(None)
            scores, failed = scoremod.calc_score(
                usage, requests, annos, mutable_usages=True,
                host_state=self.overlay.host_state(None)
                if want_host else None)
            board = _Board(ver, {s.node_id: s for s in scores},
                           dict(failed))
            self.boards[sig] = board
            self.boards.move_to_end(sig)
            while len(self.boards) > self.BOARD_LRU:
                self.boards.popitem(last=False)
            misses = len(usage)
            self.board_rebuilds += 1
        else:
            self.board_hits += 1
            self.boards.move_to_end(sig)
            if changed:
                misses = self._resync_board_shard_locked(
                    board, changed, cur, requests, annos)
        registered = len(board.scores_by_node) + len(board.failed)
        top = [board.scores_by_node[n]
               for _, n in board.order[:self.TOP_K]]
        return (top, len(board.order), dict(board.failed),
                registered - misses, misses, registered)

    def _resync_board_shard_locked(self, board: _Board,
                                   changed: Set[str], cur: int,
                                   requests, annos) -> int:
        """Re-fit only the nodes mutated since the board's sync point;
        nodes dropped from the inventory leave the board entirely."""
        changed_list = list(changed)
        _, usage = self.overlay.snapshot_versioned(changed_list)
        host_state = (self.overlay.host_state(changed_list)
                      if scoremod.host_mem_request_mb(annos) > 0
                      else None)
        for node in changed:
            old = board.scores_by_node.pop(node, None)
            if old is not None:
                key = (-old.score, node)
                i = bisect_left(board.order, key)
                if i < len(board.order) and board.order[i] == key:
                    board.order.pop(i)
                else:  # float drift paranoia: never strand an entry
                    board.order.remove(key)
            else:
                board.failed.pop(node, None)
        scores, failed = scoremod.calc_score(
            usage, requests, annos, mutable_usages=True,
            host_state=host_state)
        for s in scores:
            board.scores_by_node[s.node_id] = s
            insort(board.order, (-s.score, s.node_id))
        board.failed.update(failed)
        board.synced = cur
        return len(usage)

    def score_nodes_shard_locked(
        self, node_names: List[str], sig, requests, annos,
    ) -> Tuple[List[scoremod.NodeScore], int, Dict[str, Rejection],
               int, int, int]:
        """Per-node scoring for a candidate subset of this shard — the
        pre-shard (generation, signature) verdict-memo path, now against
        shard-local caches. Caller holds self.lock. Same return shape
        as score_shard_locked (scores are the FULL sorted fit list —
        subsets are small by construction). Named candidates with no
        registered inventory carry a structured NODE_UNREGISTERED
        rejection, matching the whole-shard path's `extras` handling —
        a candidate must never silently vanish from FailedNodes."""
        gens = self.overlay.generations(node_names)
        failed: Dict[str, Rejection] = {}
        for nid in node_names:
            if nid not in gens:
                failed[nid] = Rejection(NODE_UNREGISTERED)
        if not gens:
            return [], 0, failed, 0, 0, 0
        scores: List[scoremod.NodeScore] = []
        misses: List[str] = []
        for nid, gen in gens.items():
            verdict = self.verdicts.get(nid, sig, gen)
            if verdict is None:
                misses.append(nid)
            elif isinstance(verdict, Rejection):
                failed[nid] = verdict
            else:
                scores.append(verdict)
        if misses:
            usage = self.overlay.snapshot(misses)
            fresh, fresh_failed = scoremod.calc_score(
                usage, requests, annos, mutable_usages=True,
                host_state=self.overlay.host_state(misses)
                if scoremod.host_mem_request_mb(annos) > 0 else None)
            for ns in fresh:
                self.verdicts.put(ns.node_id, sig, gens[ns.node_id], ns)
            for nid, why in fresh_failed.items():
                self.verdicts.put(nid, sig, gens[nid], why)
            scores.extend(fresh)
            failed.update(fresh_failed)
        scores.sort(key=lambda r: (-r.score, r.node_id))
        return (scores, len(scores), failed,
                len(gens) - len(misses), len(misses), len(gens))


class Route:
    """One routed candidate set: the shards it touches (ascending
    index — the lock order), the per-shard candidate split, and the
    memoized coverage verdicts. Cached per (routing epoch, candidate
    tuple) so repeat filters over the same pool pay one dict probe,
    not an O(candidates) re-split."""

    __slots__ = ("shards", "groups", "group_sets", "coverage", "epoch",
                 "lockset")

    def __init__(self, shards: List[DecideShard],
                 groups: Optional[Dict[int, List[str]]],
                 epoch: int) -> None:
        self.shards = shards
        self.groups = groups                  # None = all nodes, all shards
        self.group_sets: Dict[int, FrozenSet[str]] = (
            {} if groups is None
            else {i: frozenset(g) for i, g in groups.items()})
        # shard index -> (inventory epoch, covered, unregistered extras)
        self.coverage: Dict[int, Tuple[int, bool, Tuple[str, ...]]] = {}
        self.epoch = epoch
        self.lockset = ShardLockSet([s.lock for s in shards])

    def names(self) -> str:
        """Span attribute: which shards decided this pod."""
        return "+".join(s.name for s in self.shards) or "-"


class DecideShards:
    """The shard router: node→shard assignment, candidate routing, the
    ordered lock sets, and a :class:`UsageOverlay`-compatible facade
    that PodManager/NodeManager write through so every usage delta
    lands in its owner shard's overlay."""

    def __init__(self, count: Optional[int] = None,
                 groups: Optional[int] = None) -> None:
        if count is None:
            count = env_int(api.ENV_DECIDE_SHARDS, DEFAULT_DECIDE_SHARDS,
                            minimum=1)
        self.count = max(1, count)
        if groups is None:
            groups = env_int(api.ENV_SHARD_GROUPS, 1, minimum=1)
        # ownership granularity for multi-active scheduling
        # (vtpu/ha/groups.py): shard i belongs to group i % n_groups, a
        # pure function of the shard index so every replica — and the
        # webhook routing a pod by pool label — computes the same map
        # with no coordination. Clamped to the shard count (more groups
        # than shards would leave empty groups holding useless leases);
        # 1 = the classic whole-plane ownership.
        self.n_groups = max(1, min(self.count, groups))
        self.shards = [DecideShard(i) for i in range(self.count)]
        # node -> shard index for explicitly keyed (pooled/sliced) nodes;
        # everything else hashes. Mutated only under the all-shards lock
        # (assign); read lock-free on the filter path — CPython dict
        # reads are atomic, and a stale probe at worst routes a filter
        # to a shard the node just left, where the node shows
        # unregistered and kube-scheduler retries (benign, transient).
        self._assigned: Dict[str, int] = {}
        self._pools: Dict[str, int] = {}   # pool key -> shard (round-robin)
        self._next_pool = 0
        self.routing_epoch = 0
        self._route_cache: Dict[Tuple[str, ...], Route] = {}
        self._all_route = Route(list(self.shards), None,
                                self.routing_epoch)
        self.all_locks = ShardLockSet([s.lock for s in self.shards])
        metricsmod.DECIDE_SHARDS.set(self.count)

    # -- assignment --------------------------------------------------------

    def shard_index(self, node_id: str) -> int:
        idx = self._assigned.get(node_id)
        if idx is not None:
            return idx
        return zlib.crc32(node_id.encode()) % self.count

    def shard_of(self, node_id: str) -> DecideShard:
        return self.shards[self.shard_index(node_id)]

    def shard_group(self, index: int) -> int:
        """Ownership group of shard `index` (multi-active scheduling,
        docs/ha.md): the static modulo map every replica shares."""
        return index % self.n_groups

    def group_of(self, node_id: str) -> int:
        """Ownership group of `node_id`'s shard — the group whose lease
        fences every decision and commit touching this node."""
        return self.shard_index(node_id) % self.n_groups

    def assign_all_locked(self, node_id: str, pool_key: str) -> None:
        """Key `node_id`'s shard by its pool (or un-key it when the
        pool label went away). Caller holds EVERY shard lock
        (registration runs under Scheduler._decide_lock): a changed
        assignment migrates the node's overlay state between shards,
        which no concurrent decision may observe half-done."""
        old = self.shard_index(node_id)
        if pool_key:
            idx = self._pools.get(pool_key)
            if idx is None:
                idx = self._pools[pool_key] = self._next_pool % self.count
                self._next_pool += 1
            self._assigned[node_id] = idx
        else:
            self._assigned.pop(node_id, None)
            idx = self.shard_index(node_id)
        if idx != old:
            inv, agg, gen, host = \
                self.shards[old].overlay.export_node(node_id)
            self.shards[idx].overlay.import_node(node_id, inv, agg,
                                                 gen_floor=gen,
                                                 host=host)
            self.routing_epoch += 1
            self._route_cache.clear()

    # -- routing -----------------------------------------------------------

    def route(self, node_names: Optional[Iterable[str]]) -> Route:
        if node_names is None:
            return self._all_route
        key = tuple(node_names)
        cached = self._route_cache.get(key)
        if cached is not None and cached.epoch == self.routing_epoch:
            return cached
        groups: Dict[int, List[str]] = {}
        assigned = self._assigned
        n = self.count
        for name in key:
            idx = assigned.get(name)
            if idx is None:
                idx = zlib.crc32(name.encode()) % n
            groups.setdefault(idx, []).append(name)
        r = Route([self.shards[i] for i in sorted(groups)], groups,
                  self.routing_epoch)
        if len(self._route_cache) >= ROUTE_CACHE_CAP:
            self._route_cache.clear()
        self._route_cache[key] = r
        return r

    def primary_index(self, node_names: Optional[List[str]]) -> int:
        """Cheap fairness key for routes.py: the shard of the first
        candidate (-1 = whole-cluster/unknown). A heuristic — the
        executor gate only needs 'requests for the same pool share a
        bucket', not exact multi-shard accounting."""
        if not node_names:
            return -1
        return self.shard_index(node_names[0])

    # -- UsageOverlay-compatible facade (PodManager/NodeManager hooks) -----

    def set_node_inventory(self, node_id: str, devices,
                           host_mem_mb: int = 0) -> None:
        self.shard_of(node_id).overlay.set_node_inventory(
            node_id, devices, host_mem_mb=host_mem_mb)

    def drop_node_inventory(self, node_id: str) -> None:
        self.shard_of(node_id).overlay.drop_node_inventory(node_id)

    def add_usage(self, node_id: str, devices: PodDevices,
                  host_mb: int = 0) -> None:
        self.shard_of(node_id).overlay.add_usage(node_id, devices,
                                                 host_mb)

    def remove_usage(self, node_id: str, devices: PodDevices,
                     host_mb: int = 0) -> None:
        self.shard_of(node_id).overlay.remove_usage(node_id, devices,
                                                    host_mb)

    def apply_delta(self, removals, additions) -> None:
        """Split the batch by owner shard; each shard's portion applies
        under ONE overlay lock hold, preserving the original atomicity
        guarantee where it matters (a re-add's retract+re-apply targets
        one node, hence one shard)."""
        by_shard: Dict[int, Tuple[list, list]] = {}
        for entry in removals:
            by_shard.setdefault(self.shard_index(entry[0]),
                                ([], []))[0].append(entry)
        for entry in additions:
            by_shard.setdefault(self.shard_index(entry[0]),
                                ([], []))[1].append(entry)
        for idx, (rem, add) in by_shard.items():
            self.shards[idx].overlay.apply_delta(rem, add)

    def reset_usage(self, pods: Iterable = ()) -> None:
        pod_list = list(pods)
        for sh in self.shards:
            sh.overlay.reset_usage(
                [p for p in pod_list
                 if self.shard_index(p.node_id) == sh.index])

    def reset_inventory(self, nodes: Dict) -> None:
        for sh in self.shards:
            sh.overlay.reset_inventory(
                {nid: info for nid, info in nodes.items()
                 if self.shard_index(nid) == sh.index})

    def generations(
        self, node_names: Optional[List[str]] = None
    ) -> Dict[str, int]:
        if node_names is None:
            out: Dict[str, int] = {}
            for sh in self.shards:
                out.update(sh.overlay.generations(None))
            return out
        out = {}
        route = self.route(node_names)
        for sh in self.shards if route.groups is None else route.shards:
            group = (None if route.groups is None
                     else route.groups.get(sh.index))
            out.update(sh.overlay.generations(group))
        return out

    def host_state(
        self, node_names: Optional[List[str]] = None
    ) -> Dict[str, Tuple[int, int]]:
        """Merged per-node host-memory axis (capacity_mb, used_mb)
        across owner shards — UsageOverlay.host_state's facade twin."""
        if node_names is None:
            out: Dict[str, Tuple[int, int]] = {}
            for sh in self.shards:
                out.update(sh.overlay.host_state(None))
            return out
        out = {}
        route = self.route(node_names)
        for sh in route.shards:
            group = (None if route.groups is None
                     else route.groups.get(sh.index))
            out.update(sh.overlay.host_state(group))
        return out

    def snapshot(
        self, node_names: Optional[List[str]] = None
    ) -> Dict[str, List[DeviceUsage]]:
        if node_names is None:
            out: Dict[str, List[DeviceUsage]] = {}
            for sh in self.shards:
                out.update(sh.overlay.snapshot(None))
            return out
        out = {}
        route = self.route(node_names)
        for sh in route.shards:
            group = (None if route.groups is None
                     else route.groups.get(sh.index))
            out.update(sh.overlay.snapshot(group))
        return out

    def diff_against(self, nodes: Dict, pods: Iterable) -> List[str]:
        """Per-shard cross-check against the from-scratch rebuild —
        Scheduler.verify_overlay's sharded form. Usage parked in the
        WRONG shard surfaces as a mismatch in the node's OWNER shard
        (whose rebuild sees the pod but whose overlay lacks the
        aggregate)."""
        pod_list = list(pods)
        problems: List[str] = []
        for sh in self.shards:
            subset = {nid: info for nid, info in nodes.items()
                      if self.shard_index(nid) == sh.index}
            for p in sh.overlay.diff_against(subset, pod_list):
                problems.append(f"[{sh.name}] {p}")
        return problems
