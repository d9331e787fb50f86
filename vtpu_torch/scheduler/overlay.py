"""Incrementally-maintained per-node usage overlay.

The port's copy of vtpu/scheduler/overlay.py.

The reference leans on a client-go informer so `getNodesUsage`
(scheduler.go:249-310) never pays an O(cluster) rebuild per scheduling
attempt. The seed port rebuilt the whole overlay inside every `filter()`
call: O(nodes x chips) fresh `DeviceUsage` construction plus an
O(nodes x pods) scan of the pod cache — per call, on the critical path
of every pod in the cluster.

`UsageOverlay` replaces that with delta accounting:

  * the node side (`NodeManager`) writes each node's chip inventory in
    via `set_node_inventory` / `drop_node_inventory`;
  * the pod side (`PodManager`) applies per-chip usage deltas via
    `add_usage` / `remove_usage` whenever a pod enters, leaves, or
    changes in the cache — including the `Scheduler.filter`
    write-through assignment;
  * `snapshot(node_names)` then materialises fresh, caller-mutable
    `DeviceUsage` lists for just the candidate set: O(candidates x
    chips), independent of cluster size and pod count.

INVARIANT: after any sequence of pod/node mutations, `snapshot()` must
equal `rebuild(nodes, pods)` — the retained from-scratch construction.
`Scheduler.verify_overlay()` cross-checks the two (used by the
randomized property test in tests/test_overlay.py and by the opt-in
periodic audit, VTPU_OVERLAY_AUDIT_S).

Usage aggregates live separately from inventory on purpose: a node
whose devices are evicted (stale handshake) and later re-registered
keeps the usage contributed by its still-cached pods, exactly as the
from-scratch rebuild would recompute it. Aggregates for chip uuids
absent from the current inventory are retained but not surfaced —
matching the rebuild, which skips assignments it cannot resolve.
"""

from __future__ import annotations

from collections import deque
from typing import Deque, Dict, Iterable, List, Optional, Set, Tuple

from ..util import lockdebug
from ..util.types import DeviceInfo, DeviceUsage, NodeInfo, PodDevices

# TYPE_CHECKING-free forward reference: PodInfo is only needed for
# rebuild()'s signature documentation; it is duck-typed (node_id,
# devices) so monitor/test callers can pass lightweight records.


def _blank_usage(d: DeviceInfo) -> DeviceUsage:
    return DeviceUsage(
        id=d.id, index=d.index, used=0, count=d.count,
        usedmem=0, totalmem=d.devmem, usedcores=0,
        totalcores=d.devcore, numa=d.numa, mesh=d.mesh,
        type=d.type, health=d.health,
    )


def rebuild(
    nodes: Dict[str, NodeInfo],
    pods: Iterable,
    node_names: Optional[List[str]] = None,
) -> Dict[str, List[DeviceUsage]]:
    """From-scratch overlay construction — the seed's `get_nodes_usage`
    algorithm, retained verbatim as the overlay's ground truth for
    `verify_overlay()` and the periodic audit. O(nodes x chips +
    nodes x pods); never call this on the filter hot path."""
    pod_list = list(pods)
    out: Dict[str, List[DeviceUsage]] = {}
    for node_id, info in nodes.items():
        if node_names is not None and node_id not in node_names:
            continue
        usages = [_blank_usage(d) for d in info.devices]
        by_id = {u.id: u for u in usages}
        for pod in pod_list:
            if pod.node_id != node_id:
                continue
            for ctr in pod.devices:
                for cd in ctr:
                    u = by_id.get(cd.uuid)
                    if u is None:
                        continue
                    u.used += 1
                    u.usedmem += cd.usedmem
                    u.usedcores += cd.usedcores
        out[node_id] = usages
    return out


class UsageOverlay:
    """Thread-safe incremental (inventory, usage-aggregate) store.

    Lock ordering: callers (PodManager/NodeManager) hold their own lock
    while calling in; the overlay lock is always innermost and never
    calls out, so no cycle is possible."""

    #: retained mutation-log entries: a reader more than this many
    #: mutations behind gets `None` from changes_since (full resync)
    LOG_CAP = 4096

    def __init__(self, lock_name: str = "scheduler.overlay") -> None:
        self._lock = lockdebug.rlock(lock_name)
        # node -> inventory as registered (shared, never mutated here)
        self._inv: Dict[str, List[DeviceInfo]] = {}
        # host-memory axis (NODE-level, not per-chip): registered
        # schedulable host-RAM capacity in MB and the sum of scheduled
        # pods' vtpu.io/host-memory reservations. Capacity rides the
        # inventory lifecycle (set/drop/reset/export/import); usage
        # rides the pod delta lifecycle exactly like the per-chip
        # aggregates, so every mutation bumps the node generation and
        # the scoreboard mutation log picks it up for free.
        self._host_cap: Dict[str, int] = {}
        self._host_used: Dict[str, int] = {}
        # node -> zero-usage DeviceUsage templates, precomputed at
        # registration so snapshot() clones instead of constructing
        # (dataclass __init__ with 12 kwargs is the costlier half of a
        # 4096-chip snapshot)
        self._base: Dict[str, List[DeviceUsage]] = {}
        # node -> chip uuid -> [used, usedmem, usedcores]
        self._agg: Dict[str, Dict[str, List[int]]] = {}
        # node -> monotonically increasing usage generation, bumped on
        # EVERY mutation that could change what snapshot() returns for
        # the node. Keys the scheduler's (generation, request-signature)
        # scoring-verdict memo (score.VerdictCache): a node whose
        # generation is unchanged since its last verdict needs no
        # re-fit within a filter burst.
        self._gen: Dict[str, int] = {}
        # whole-overlay monotonic version: bumped on EVERY node bump.
        # Keys the shard scoreboard (vtpu/scheduler/shard.py): a reader
        # that remembers the version it synced at asks changes_since()
        # for exactly the nodes mutated since, instead of re-probing
        # every node's generation per filter.
        self._version = 0
        # bounded (version, node) mutation log serving changes_since();
        # entries older than _log_floor have been evicted, so readers
        # behind the floor must full-resync
        self._log: Deque[Tuple[int, str]] = deque()
        self._log_floor = 0
        # bumped whenever the set of nodes WITH INVENTORY changes —
        # the shard-coverage memo key (shard.py Route). Inventory
        # mutations are serialized by the decide locks (core.py), so
        # readers holding a shard decide lock may compare epochs and
        # iterate members() without taking the overlay lock.
        self._inventory_epoch = 0

    def _bump(self, node_id: str) -> None:
        # lock held by every caller
        self._gen[node_id] = self._gen.get(node_id, 0) + 1
        self._version += 1
        self._log.append((self._version, node_id))
        if len(self._log) > self.LOG_CAP:
            self._log_floor = self._log.popleft()[0]

    # -- node side --------------------------------------------------------

    def set_node_inventory(self, node_id: str,
                           devices: List[DeviceInfo],
                           host_mem_mb: int = 0) -> None:
        with self._lock:
            if node_id not in self._inv:
                self._inventory_epoch += 1
            self._inv[node_id] = list(devices)
            self._base[node_id] = [_blank_usage(d) for d in devices]
            if host_mem_mb > 0:
                self._host_cap[node_id] = host_mem_mb
            else:
                self._host_cap.pop(node_id, None)
            self._bump(node_id)

    def drop_node_inventory(self, node_id: str) -> None:
        """Node evicted: inventory goes, pod aggregates stay (the pods
        are still cached; a re-registration must see their usage)."""
        with self._lock:
            if self._inv.pop(node_id, None) is not None:
                self._inventory_epoch += 1
            self._base.pop(node_id, None)
            self._host_cap.pop(node_id, None)
            self._bump(node_id)

    def reset_inventory(self, nodes: Dict[str, NodeInfo]) -> None:
        """Replace the whole inventory view — the audit's self-heal."""
        with self._lock:
            for nid in set(self._inv) | set(nodes):
                self._bump(nid)
            self._inv = {nid: list(info.devices)
                         for nid, info in nodes.items()}
            self._base = {nid: [_blank_usage(d) for d in info.devices]
                          for nid, info in nodes.items()}
            self._host_cap = {
                nid: info.host_mem_mb for nid, info in nodes.items()
                if getattr(info, "host_mem_mb", 0) > 0}
            self._inventory_epoch += 1

    def export_node(self, node_id: str):
        """Remove one node's whole state (inventory + usage aggregates +
        generation floor) so it can move to another overlay instance —
        the shard-migration half of DecideShards.assign (shard.py).
        Callers hold every decide lock, so no reader can observe the
        node mid-move. Returns (inventory|None, agg|None, generation)."""
        with self._lock:
            inv = self._inv.pop(node_id, None)
            if inv is not None:
                self._inventory_epoch += 1
            self._base.pop(node_id, None)
            agg = self._agg.pop(node_id, None)
            host = (self._host_cap.pop(node_id, 0),
                    self._host_used.pop(node_id, 0))
            gen = self._gen.get(node_id, 0)
            self._bump(node_id)
            return inv, agg, gen, host

    def import_node(self, node_id: str, inv, agg,
                    gen_floor: int = 0,
                    host: "Tuple[int, int]" = (0, 0)) -> None:
        """Install a node exported from another overlay. `gen_floor`
        keeps the node's usage generation monotonic across the move, so
        a verdict cached against the old shard's numbering can never
        read as fresh in the new one."""
        with self._lock:
            if gen_floor and self._gen.get(node_id, 0) < gen_floor:
                self._gen[node_id] = gen_floor
            if inv is not None:
                if node_id not in self._inv:
                    self._inventory_epoch += 1
                self._inv[node_id] = inv
                self._base[node_id] = [_blank_usage(d) for d in inv]
            if agg:
                self._agg[node_id] = agg
            cap, used = host
            if cap > 0:
                self._host_cap[node_id] = cap
            if used:
                self._host_used[node_id] = used
            self._bump(node_id)

    # -- pod side (delta accounting) --------------------------------------

    def add_usage(self, node_id: str, devices: PodDevices,
                  host_mb: int = 0) -> None:
        self._apply(node_id, devices, +1, host_mb)

    def remove_usage(self, node_id: str, devices: PodDevices,
                     host_mb: int = 0) -> None:
        self._apply(node_id, devices, -1, host_mb)

    def apply_delta(self, removals, additions) -> None:
        """Retract and apply (node_id, PodDevices[, host_mb]) assignment
        batches under ONE lock hold, so a concurrent snapshot() can
        never observe the retracted-but-not-yet-readded intermediate
        state (which would show occupied chips as free and invite
        double-booking). Used by PodManager for re-adds and the
        replace_all diff."""
        with self._lock:
            for entry in removals:
                node_id, devices = entry[0], entry[1]
                self._apply(node_id, devices, -1,
                            entry[2] if len(entry) > 2 else 0)
            for entry in additions:
                node_id, devices = entry[0], entry[1]
                self._apply(node_id, devices, +1,
                            entry[2] if len(entry) > 2 else 0)

    def _apply(self, node_id: str, devices: PodDevices, sign: int,
               host_mb: int = 0) -> None:
        with self._lock:
            self._bump(node_id)
            agg = self._agg.setdefault(node_id, {})
            for ctr in devices:
                for cd in ctr:
                    a = agg.get(cd.uuid)
                    if a is None:
                        a = agg[cd.uuid] = [0, 0, 0]
                    a[0] += sign
                    a[1] += sign * cd.usedmem
                    a[2] += sign * cd.usedcores
                    if a[0] == 0 and a[1] == 0 and a[2] == 0:
                        del agg[cd.uuid]
            if not agg:
                self._agg.pop(node_id, None)
            if host_mb:
                h = self._host_used.get(node_id, 0) + sign * host_mb
                if h:
                    self._host_used[node_id] = h
                else:
                    self._host_used.pop(node_id, None)

    def reset_usage(self, pods: Iterable = ()) -> None:
        """Drop all aggregates and re-derive them from `pods` — the
        audit's self-heal and `PodManager.clear`'s reset."""
        with self._lock:
            for nid in set(self._inv) | set(self._agg) \
                    | set(self._host_used):
                self._bump(nid)
            self._agg.clear()
            self._host_used.clear()
            for p in pods:
                self.add_usage(p.node_id, p.devices,
                               getattr(p, "host_mb", 0))

    # -- read side --------------------------------------------------------

    def generations(
        self, node_names: Optional[List[str]] = None
    ) -> Dict[str, int]:
        """Per-node usage generations for the candidate set (nodes with
        a registered inventory only — exactly the nodes snapshot() would
        surface). O(candidates) dict reads; the cheap pre-pass that lets
        the scheduler skip snapshotting nodes whose scoring verdict is
        already memoized for the current generation."""
        with self._lock:
            if node_names is None:
                return {n: self._gen.get(n, 0) for n in self._base}
            return {n: self._gen.get(n, 0) for n in node_names
                    if n in self._base}

    def version(self) -> int:
        """Whole-overlay mutation counter (monotonic)."""
        with self._lock:
            return self._version

    def changes_since(self, since: int) -> Tuple[int, Optional[Set[str]]]:
        """(current version, nodes mutated after `since`). Returns None
        for the node set when `since` predates the retained mutation log
        — the reader must rebuild from scratch. O(changes), not
        O(nodes): the scan walks the log newest-first and stops at
        `since`."""
        with self._lock:
            cur = self._version
            if since >= cur:
                return cur, set()
            if since < self._log_floor:
                return cur, None
            out: Set[str] = set()
            for ver, node in reversed(self._log):
                if ver <= since:
                    break
                out.add(node)
            return cur, out

    def host_state(
        self, node_names: Optional[List[str]] = None
    ) -> Dict[str, Tuple[int, int]]:
        """Per-node host-memory axis for the candidate set: node ->
        (capacity_mb, used_mb), for nodes with a registered inventory.
        Capacity 0 = unreported (legacy-unlimited). O(candidates) dict
        reads; read under the same decide lock as the snapshot the fit
        runs against, so the two views are mutation-consistent."""
        with self._lock:
            names = self._base if node_names is None else [
                n for n in node_names if n in self._base]
            return {n: (self._host_cap.get(n, 0),
                        self._host_used.get(n, 0)) for n in names}

    def inventory_epoch(self) -> int:
        with self._lock:
            return self._inventory_epoch

    def members(self) -> Set[str]:
        """LIVE view of the nodes with registered inventory — NOT a
        copy. Callers must hold a lock that excludes inventory mutation
        (the decide locks do: every set/drop/reset/import/export runs
        under them, core.py) and must not mutate the set."""
        return self._base.keys()  # dict view: membership + iteration

    def snapshot_versioned(
        self, node_names: Optional[List[str]] = None
    ) -> Tuple[int, Dict[str, List[DeviceUsage]]]:
        """snapshot() plus the overlay version the snapshot reflects,
        read under the SAME lock hold — the shard scoreboard's sync
        point (a version read after the snapshot could miss a mutation
        that the snapshot already missed too)."""
        with self._lock:
            return self._version, self._snapshot_locked(node_names)

    def snapshot(
        self, node_names: Optional[List[str]] = None
    ) -> Dict[str, List[DeviceUsage]]:
        """Fresh DeviceUsage lists for the candidate set. The returned
        objects are new on every call — callers (scoring trials) may
        mutate them freely without write-back."""
        with self._lock:
            return self._snapshot_locked(node_names)

    def _snapshot_locked(
        self, node_names: Optional[List[str]] = None
    ) -> Dict[str, List[DeviceUsage]]:
        new = DeviceUsage.__new__
        if node_names is None:
            items = list(self._base.items())
        else:
            items = [(n, self._base[n]) for n in node_names
                     if n in self._base]
        out: Dict[str, List[DeviceUsage]] = {}
        for node_id, templates in items:
            agg = self._agg.get(node_id)
            usages = []
            for t in templates:
                # fast clone: bypass dataclass __init__ (hot path)
                u = new(DeviceUsage)
                u.__dict__.update(t.__dict__)
                if agg is not None:
                    a = agg.get(u.id)
                    if a is not None:
                        u.used, u.usedmem, u.usedcores = a
                usages.append(u)
            out[node_id] = usages
        return out

    # -- consistency ------------------------------------------------------

    def diff_against(
        self,
        nodes: Dict[str, NodeInfo],
        pods: Iterable,
    ) -> List[str]:
        """Compare the incremental state against the from-scratch
        rebuild; returns human-readable discrepancies (empty ==
        consistent). O(cluster) — test/audit only."""
        pods = list(pods)
        truth = rebuild(nodes, pods)
        snap = self.snapshot()
        problems: List[str] = []
        # host axis: the from-scratch sum of cached pods' reservations
        # per node must equal the incremental aggregate
        host_truth: Dict[str, int] = {}
        for p in pods:
            mb = getattr(p, "host_mb", 0)
            if mb and p.node_id in nodes:
                host_truth[p.node_id] = host_truth.get(p.node_id, 0) + mb
        host_snap = self.host_state()
        for node_id in sorted(set(host_truth) | set(host_snap)):
            want = host_truth.get(node_id, 0)
            got = host_snap.get(node_id, (0, 0))[1]
            if node_id in host_snap and want != got:
                problems.append(
                    f"{node_id}: host-memory rebuild={want}MB "
                    f"overlay={got}MB")
        for node_id in sorted(set(truth) | set(snap)):
            want = truth.get(node_id)
            got = snap.get(node_id)
            if want is None:
                problems.append(f"{node_id}: overlay has unregistered node")
            elif got is None:
                problems.append(f"{node_id}: overlay missing node")
            elif want != got:
                for w, g in zip(want, got):
                    if w != g:
                        problems.append(
                            f"{node_id}/{w.id}: rebuild={w} overlay={g}")
                if len(want) != len(got):
                    problems.append(
                        f"{node_id}: device count rebuild={len(want)} "
                        f"overlay={len(got)}")
        return problems
