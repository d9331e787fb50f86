"""Multi-active scheduling: per-shard-group leases (docs/ha.md).

The port's copy of vtpu/ha/groups.py.

The binary HACoordinator makes ONE instance own every decide shard.
This module generalizes the same ClusterLease fencing discipline to
**shard groups**: the decide plane's shards map onto ``n_groups``
groups (``shard_index % n_groups``, shard.py), each group elects on
its OWN coordination.k8s.io Lease (``{base}-gNN``), and N scheduler
instances each own a disjoint group subset and decide concurrently.

Ownership map
-------------

Group → preferred owner is the static modulo map ``g % peers``; every
replica knows its own ``ordinal`` (StatefulSet-style, from the pod
name suffix or VTPU_SCHEDULER_ORDINAL; the last-resort fallback is a
crc32 digest of the identity — deterministic across restarts, unlike
the per-process-salted builtin ``hash``). Each poll an instance:

  * renews the groups it owns (renew-only — never re-steals a lease
    it lost);
  * force-takes its PREFERRED groups from whoever holds them — a
    planned rebalance is a deliberate, fencing-safe handoff (the
    transitions bump deposes the interim holder's generation, so its
    in-flight commits fail the committer's fence). If a LIVE peer
    force-takes a group WE prefer, two replicas map to one ordinal
    slot (or we paused past the lease window): the deposed side backs
    its forced reclaim off exponentially and alerts instead of
    force-fighting (see :meth:`GroupCoordinator._suspect_collision`);
  * silence-steals any OTHER group whose holder stopped renewing —
    failure absorption: a dead peer's groups are absorbed by whichever
    live instance polls first, beyond its fair share.

Groups a single poll pass acquires are admitted together at the end
of the pass: with the ``on_acquire_batch`` hook wired, one shared
rebuild covers the union instead of one full cluster pod LIST per
group (mass failover and startup are exactly when the apiserver is
least able to absorb k extra LISTs).

Because the map is a pure function of (group, peers) and every holder
is published in its lease object, a pod's route is consistent without
any membership protocol: the webhook/extender routes by pool → shard →
group → lease holder, and a non-owner answers a retryable 503 naming
the holder (routes.py).

Disjointness & fencing, per group
---------------------------------

Each group's lease carries its own ``leaseTransitions`` fencing
generation; ``generation_for(g)`` is non-zero only while (a) the lease
is validly held by OUR clock and (b) the group's scoped rebuild
(``on_acquire``) completed. Every decision stamps — and every commit
re-checks — the generation of the CHOSEN node's group, so two
instances can never both commit under the same (group, generation):
the single-lease disjointness argument (lease.py module doc), applied
per group. Cross-group gangs either find one owner holding every
involved group or hand the missing groups over via :meth:`take_over`
(the forced acquire above) before deciding.

``on_acquire(group, generation)`` runs BEFORE the group joins the
owned set — it is where the scheduler replays the absorbed group's
durable state (``Scheduler.recover(groups={g})``), so the first
decision served for a group already respects everything the dead (or
deposed) previous owner committed. A failing rebuild releases the
lease: an owner that cannot reconstruct a group's state must not
serve guesses for it.

``n_groups=1`` degenerates to the classic pair — cmd/scheduler wires
HACoordinator in that case; this module never runs.
"""

from __future__ import annotations

import logging
import re
import threading
import time
import zlib
from typing import Callable, Dict, FrozenSet, List, Optional

from ..api import LEASE_NAME_DEFAULT
from ..trace import tracer as _tracer
from ..trace import trace_id_for_uid

from .lease import LEASE_EXPIRE_S, ClusterLease

log = logging.getLogger(__name__)

#: renew cadence, same margin as the binary coordinator: a third of
#: the expiry so two missed renewals still precede any legal steal
RENEW_FRACTION = 3.0

#: forced-reclaim backoff cap after suspected ordinal collisions, in
#: lease windows: colliding replicas decay to at most one handoff per
#: ~8 minutes at the default 15s lease instead of one per renew (~5s)
FORCE_BACKOFF_CAP = 32.0


def ordinal_from_identity(identity: str, peers: int) -> int:
    """This replica's slot in the group→owner modulo map: the trailing
    ``-<n>`` of a StatefulSet-style pod name, else a crc32 digest of
    the identity. The digest — NOT the builtin ``hash``, whose
    PYTHONHASHSEED salt differs per process — keeps the slot stable
    across restarts; two replicas digesting to one slot are detected
    at runtime and stop force-fighting (_suspect_collision)."""
    m = re.search(r"-(\d+)$", identity)
    if m:
        return int(m.group(1)) % max(1, peers)
    return zlib.crc32(identity.encode("utf-8")) % max(1, peers)


class _GroupGate:
    """Per-group leadership view for control loops that gate on ONE
    group (the gateway autoscaler gates on the control group): quacks
    like the coordinator the loop already accepts."""

    def __init__(self, coord: "GroupCoordinator", group: int) -> None:
        self._coord = coord
        self._group = group

    def owns(self, group: int) -> bool:
        # scoped to ONE group: a question about any other group is
        # answered False, never the fixed group's state — a silently
        # wrong True here would un-gate a loop for a group this gate
        # knows nothing about
        return group == self._group and self._coord.owns(group)

    def is_leader(self) -> bool:
        return self._coord.owns(self._group)

    @property
    def generation(self) -> int:
        return self._coord.generation_for(self._group)


class GroupCoordinator:
    """N-active ownership of the shard groups; one ClusterLease per
    group, one instance of this class per scheduler replica."""

    def __init__(self, client, identity: str, n_groups: int, *,
                 ordinal: Optional[int] = None, peers: int = 2,
                 lease_name_base: str = LEASE_NAME_DEFAULT,
                 namespace: str = "kube-system",
                 lease_s: float = LEASE_EXPIRE_S,
                 clock=time.time,
                 on_acquire: Optional[Callable[[int, int], None]] = None,
                 on_acquire_batch: Optional[
                     Callable[[Dict[int, int]], None]] = None,
                 on_release: Optional[Callable[[int], None]] = None,
                 renew_s: float = 0.0) -> None:
        self.identity = identity
        self.n_groups = max(1, n_groups)
        self.peers = max(1, peers)
        self.ordinal = (ordinal if ordinal is not None
                        else ordinal_from_identity(identity,
                                                   self.peers)) % self.peers
        self.lease_name_base = lease_name_base
        self.leases = [
            ClusterLease(client, identity,
                         name=f"{lease_name_base}-g{g:02d}",
                         namespace=namespace, lease_s=lease_s,
                         clock=clock)
            for g in range(self.n_groups)
        ]
        self._clock = clock
        #: rebuild hook, run BEFORE a group joins the owned set
        self.on_acquire = on_acquire
        #: optional batch rebuild hook: one call for ALL the groups a
        #: single poll pass acquired (one shared pod LIST instead of
        #: one per group); take_over and single acquisitions still use
        #: the per-group hook
        self.on_acquire_batch = on_acquire_batch
        self.on_release = on_release
        self.renew_s = renew_s or lease_s / RENEW_FRACTION
        # groups whose lease we hold AND whose scoped rebuild completed;
        # mutated only on the poll path / take_over (vtpulint VTPU017),
        # read lock-free from decide/HTTP threads (set-of-int snapshot
        # semantics: a stale read at worst refuses one retryable filter)
        self._owned: FrozenSet[int] = frozenset()
        self._owned_lock = threading.Lock()
        # one mutex PER GROUP serializes its acquire→rebuild→admit
        # transition across the poll thread and take_over's HTTP
        # decide threads: ClusterLease mutates its holding state
        # non-atomically, and on_acquire (a full scoped rebuild) must
        # never run twice concurrently for one group. Multi-lock
        # holders (_admit_groups) acquire in ascending group order —
        # the ShardLockSet total order — so the single-lock paths can
        # never deadlock them.
        self._acq_locks = [threading.Lock()
                           for _ in range(self.n_groups)]
        # forced-reclaim backoff per group after a suspected ordinal
        # collision (_suspect_collision); `collisions` feeds the
        # vGPUShardGroupOrdinalCollisions counter
        self._force_block_until: Dict[int, float] = {}
        self._force_penalty: Dict[int, float] = {}
        self.collisions: Dict[int, int] = {g: 0
                                           for g in range(self.n_groups)}
        #: last holder identity observed per group (routing hints for
        #: the non-owner 503; "" = never observed)
        self._holders: Dict[int, str] = {}
        #: ownership transitions (acquire + loss) per group — feeds
        #: vGPUShardGroupTransitions via SchedulerCollector
        self.transitions: Dict[int, int] = {g: 0
                                            for g in range(self.n_groups)}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- read side ---------------------------------------------------------

    def owns(self, group: int) -> bool:
        """Validly own `group`: lease held by our clock AND the scoped
        rebuild completed (a group is never served half-rebuilt)."""
        return group in self._owned and self.leases[group].held

    def generation_for(self, group: int) -> int:
        """Per-group fencing token (0 = not validly owning `group`)."""
        if group not in self._owned:
            return 0
        return self.leases[group].generation

    def owned_groups(self) -> FrozenSet[int]:
        return frozenset(g for g in self._owned if self.leases[g].held)

    def owner_of(self, group: int) -> str:
        """Best-effort routing hint: the holder we last observed on the
        group's lease (ourselves while owning)."""
        if self.owns(group):
            return self.identity
        return self._holders.get(group, "")

    def is_leader(self) -> bool:
        """Compat with the binary coordinator's consumers: an instance
        owning ANY group participates in the control plane (answers
        handshakes for its groups, serves extender verbs)."""
        return bool(self.owned_groups())

    @property
    def role(self) -> str:
        return "owner" if self.is_leader() else "standby"

    @property
    def generation(self) -> int:
        """Binary-compat token: the control group's generation. Group-
        aware callers use generation_for()."""
        return self.generation_for(0)

    def group_gate(self, group: int = 0) -> _GroupGate:
        """Leadership view scoped to one group, for single-gate control
        loops (the gateway autoscaler gates on the control group)."""
        return _GroupGate(self, group)

    def preferred(self, group: int) -> bool:
        return group % self.peers == self.ordinal

    # -- state machine -----------------------------------------------------

    def poll_once(self) -> None:
        """One renew/rebalance/absorb pass over every group lease.
        Factored out so tests and the chaos harness drive the exact
        production path without threads (HACoordinator discipline).
        Leases acquired during the pass are admitted TOGETHER at the
        end (_admit_groups): with the batch hook wired, k absorptions
        share one rebuild instead of running k cluster pod lists."""
        acquired: List[int] = []
        for g, lease in enumerate(self.leases):
            with self._acq_locks[g]:
                if g in self._owned:
                    # renew-ONLY: a lease we lost must come back
                    # through a fresh acquire + rebuild, never a
                    # silent re-steal
                    if not lease.try_acquire(steal=False):
                        self._drop_group(g, "lease renewal lost")
                        self._suspect_collision(g)
                    continue
                if self.preferred(g) and self._force_allowed(g):
                    # planned rebalance: reclaim our preferred group
                    # from whoever absorbed it while we were down
                    # (fencing-safe forced handoff — lease.py
                    # _try_once force doc)
                    got = lease.try_acquire(steal=True, force=True)
                else:
                    # failure absorption: take a dead peer's group
                    # only after the full observed-silence window.
                    # Also the fallback for a PREFERRED group while
                    # its forced reclaim is backed off after a
                    # suspected ordinal collision — a dead holder is
                    # still absorbed, a live one is left alone.
                    got = lease.try_acquire(steal=True)
                if got:
                    acquired.append(g)
                else:
                    self._note_holder(g)
        if acquired:
            self._admit_groups(acquired)

    def take_over(self, group: int) -> int:
        """Forced acquisition of one group for a cross-group gang the
        caller majority-owns (core._filter gang routing): bumps the
        group's generation — deposing the previous owner's in-flight
        commits — and runs the scoped rebuild before returning the new
        fencing token (0 = takeover failed; the caller refuses
        retryably). MUST be called outside the decide locks: the
        rebuild acquires them."""
        with self._acq_locks[group]:
            if not self.owns(group):
                # re-check membership under the lock: a concurrent
                # poll/take_over may have admitted the group already —
                # try_acquire then merely renews, and re-running the
                # rebuild would double-replay on_acquire
                if (self.leases[group].try_acquire(steal=True,
                                                   force=True)
                        and group not in self._owned):
                    self._admit_group(group)
        return self.generation_for(group)

    def _force_allowed(self, g: int) -> bool:
        return self._clock() >= self._force_block_until.get(g, 0.0)

    def _suspect_collision(self, g: int) -> None:
        """A PREFERRED group's renewal just failed while its lease
        shows a live holder. Only a preferred owner force-takes a live
        holder's lease, so either two replicas map to one ordinal slot
        (duplicate VTPU_SCHEDULER_ORDINAL / identity-digest collision)
        or WE paused past the silence window and were legitimately
        absorbed. Either way, force-reclaiming right back would
        ping-pong ownership every renew — each swing bumping the
        generation (fencing the peer's in-flight commits) and running
        a full scoped rebuild — so the forced reclaim backs off
        exponentially and alerts instead. Silence-steal still absorbs
        the group the moment the holder actually dies, and a vacant or
        deleted lease is taken without force, so the backoff only ever
        delays deposing a LIVE peer."""
        if not self.preferred(g):
            return
        key = self.leases[g]._obs_key
        holder = key[0] if key else ""
        if not holder or holder == self.identity:
            return
        lease_s = self.leases[g].lease_s
        penalty = min(2 * self._force_penalty.get(g, lease_s / 2),
                      lease_s * FORCE_BACKOFF_CAP)
        self._force_penalty[g] = penalty
        self._force_block_until[g] = self._clock() + penalty
        self.collisions[g] += 1
        log.error(
            "%s (ordinal %d) was force-deposed from its PREFERRED "
            "shard group %d by live holder %s — duplicate ordinal "
            "(check VTPU_SCHEDULER_ORDINAL / StatefulSet pod names) "
            "or a pause past the lease window; backing forced reclaim "
            "off %.0fs instead of force-fighting",
            self.identity, self.ordinal, g, holder, penalty)

    def _admit_groups(self, groups: List[int]) -> None:
        """Admit the groups one poll pass acquired. With the batch
        rebuild hook wired and more than one group, ONE shared rebuild
        covers the union — per-group admission would run a full
        cluster pod LIST per group, multiplying apiserver load exactly
        when the control plane is least stable (startup, mass
        failover). Locks are taken in ascending group order; a batch
        rebuild failure releases every involved lease (the failure
        cannot be attributed to one group, and an owner that cannot
        reconstruct a group must not serve guesses for it)."""
        groups = sorted(groups)
        if self.on_acquire_batch is None or len(groups) == 1:
            for g in groups:
                with self._acq_locks[g]:
                    self._admit_group(g)
            return
        held: List[int] = []
        try:
            for g in groups:
                self._acq_locks[g].acquire()
                held.append(g)
            # re-check under the locks: a concurrent take_over may
            # have admitted — or a renewal race dropped — a group
            # since the scan collected it
            gens = {g: self.leases[g].generation for g in groups
                    if g not in self._owned and self.leases[g].held}
            if not gens:
                return
            batch = sorted(gens)
            tid = trace_id_for_uid(
                "ha:%s:batch:%s" % (self.lease_name_base,
                                    ",".join(f"{g}:{gens[g]}"
                                             for g in batch)))
            try:
                with _tracer.span(tid, "ha.group_acquire",
                                  identity=self.identity,
                                  groups=batch,
                                  generations=[gens[g] for g in batch]):
                    self.on_acquire_batch(dict(gens))
            except Exception:
                log.exception(
                    "batch rebuild of shard groups %s failed; "
                    "releasing their leases and leaving them unowned",
                    batch)
                for g in batch:
                    self.leases[g].release()
                return
            for g in batch:
                with self._owned_lock:
                    self._owned = self._owned | {g}
                self.transitions[g] += 1
                self._holders[g] = self.identity
            log.info("%s acquired shard groups %s in one pass "
                     "(generations %s; owns %s)", self.identity,
                     batch, [gens[g] for g in batch],
                     sorted(self._owned))
        finally:
            for g in held:
                self._acq_locks[g].release()

    def _admit_group(self, g: int) -> None:
        """Lease acquired; rebuild the group's durable state BEFORE it
        joins the owned set — failure releases the lease (an owner that
        cannot reconstruct a group must not serve guesses for it).
        Caller holds ``_acq_locks[g]``."""
        if g in self._owned:
            return
        gen = self.leases[g].generation
        tid = trace_id_for_uid(f"ha:{self.leases[g].name}:{gen}")
        try:
            with _tracer.span(tid, "ha.group_acquire",
                              identity=self.identity, group=g,
                              generation=gen):
                if self.on_acquire is not None:
                    self.on_acquire(g, gen)
        except Exception:
            log.exception(
                "group %d rebuild (generation %d) failed; releasing its "
                "lease and leaving the group unowned", g, gen)
            self.leases[g].release()
            return
        with self._owned_lock:
            self._owned = self._owned | {g}
        self.transitions[g] += 1
        self._holders[g] = self.identity
        log.info("%s acquired shard group %d (generation %d; owns %s)",
                 self.identity, g, gen, sorted(self._owned))

    def _drop_group(self, g: int, why: str) -> None:
        with self._owned_lock:
            self._owned = self._owned - {g}
        self.transitions[g] += 1
        log.warning("%s lost shard group %d: %s (owns %s)",
                    self.identity, g, why, sorted(self._owned))
        if self.on_release is not None:
            try:
                self.on_release(g)
            except Exception:
                log.exception("group %d release callback failed", g)

    def _note_holder(self, g: int) -> None:
        # the failed acquire observed the lease object; remember who
        # holds it so routes.py can hint the owner in its 503
        key = self.leases[g]._obs_key
        if key is not None:
            self._holders[g] = key[0]

    # -- thread ------------------------------------------------------------

    def run(self) -> None:
        while not self._stop.is_set():
            try:
                self.poll_once()
            except Exception:
                log.exception("group coordinator poll failed")
            self._stop.wait(self.renew_s)

    def start(self) -> "GroupCoordinator":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self.run, name="vtpu-ha-groups", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        """Clean shutdown: release every owned group so peers absorb
        them immediately instead of waiting out the silence window.
        Poll thread joined FIRST (HACoordinator.stop's race argument)."""
        self._stop.set()
        t = self._thread
        if (t is not None and t.is_alive()
                and t is not threading.current_thread()):
            t.join(timeout=10.0)
            if t.is_alive():
                log.warning("group poll thread did not stop in 10s; "
                            "releasing anyway")
        for g in sorted(self._owned):
            with self._acq_locks[g]:
                self._drop_group(g, "shutting down")
                self.leases[g].release()
