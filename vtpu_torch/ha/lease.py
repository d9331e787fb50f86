"""Cluster leadership lease: the nodelock CAS discipline, one level up.

The port's copy of vtpu/ha/lease.py.

The repo's node mutex (vtpu_torch/util/nodelock.py, reference
nodelock.go:18-47) serializes one node's bind→allocate window with an
annotation CAS + expiry steal. An HA scheduler pair needs the same
machinery at cluster scope: ONE well-known object, CAS-guarded writes,
a renew loop, and expiry-based steal (nodelock.go:94-102) so a dead
leader's lease frees itself. This module generalizes that discipline
onto a coordination.k8s.io Lease:

  * ``spec.holderIdentity`` — who leads (pod name / hostname).
  * ``spec.renewTime``     — MicroTime heartbeat. Steal eligibility is
    measured on the OBSERVER's clock (the client-go discipline): a
    contender may steal only after watching an UNCHANGED
    (holder, renewTime) pair for a full ``lease_s`` of its own local
    time — never by comparing its clock against the remote timestamp,
    which would let wall-clock OFFSET between replicas depose a live
    leader.
  * ``spec.leaseTransitions`` — bumped on every change of holder: the
    **fencing generation**. Every assignment commit carries the
    generation it was decided under; the committer refuses to execute a
    commit whose generation is no longer current
    (vtpu_torch/scheduler/committer.py FencedError), so a deposed leader's
    in-flight writes can never clobber the new leader's placements.

Fencing validity is local-clock-bounded: :meth:`ClusterLease.generation`
reports 0 once ``lease_s`` has passed since OUR last successful CAS —
anchored to the clock read BEFORE the renewing RPC — while a steal
requires a full ``lease_s`` of observed silence on the CONTENDER's
clock. Each side measures only its own clock, so a paused-then-resumed
leader fences itself before anyone could have stolen the lease: the
standard disjointness argument for lease-based leadership, assuming
only bounded clock-RATE skew (the assumption every k8s lease makes),
never clock synchronization.

docs/ha.md is the ADR.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, Optional

from .. import api
from ..util import nodelock
from ..util.client import ConflictError, KubeClient, NotFoundError

log = logging.getLogger(__name__)

#: holder considered dead after this long without a renewal
#: (scaled-down nodelock expiry: failover must be bounded in seconds,
#: not the node lock's 5 minutes)
LEASE_EXPIRE_S = 15.0
#: CAS conflict retries per acquisition attempt (nodelock.go:18-47)
MAX_RETRY = 5
RETRY_DELAY_S = 0.1


class ClusterLease:
    """One contender's view of the well-known leadership lease."""

    def __init__(self, client: KubeClient, identity: str,
                 name: str = api.LEASE_NAME_DEFAULT,
                 namespace: str = "kube-system",
                 lease_s: float = LEASE_EXPIRE_S,
                 clock=time.time) -> None:
        self.client = client
        self.identity = identity
        self.name = name
        self.namespace = namespace
        self.lease_s = lease_s
        self.clock = clock
        self._generation = 0       # transitions of OUR current holding
        self._last_renew_ok = 0.0  # clock() of our last successful CAS
        self._held = False
        # steal-eligibility observation (client-go semantics): the
        # (holder, renewTime) pair we last saw and WHEN we first saw it
        # unchanged, on our own clock
        self._obs_key: Optional[tuple] = None
        self._obs_at = 0.0
        # highest leaseTransitions this process has ever observed: a
        # DELETED-then-recreated lease (operator force-re-election) must
        # not rewind the fencing generation below values already
        # stamped on pods — the object precondition orders on it
        self._max_seen = 0

    # -- state -------------------------------------------------------------

    @property
    def held(self) -> bool:
        """We hold the lease AND our holding is still fencing-valid
        (renewed within lease_s by our own clock — see module doc)."""
        return (self._held
                and self.clock() - self._last_renew_ok < self.lease_s)

    @property
    def generation(self) -> int:
        """Fencing token: the leaseTransitions of our current holding,
        0 whenever we do not (validly) hold the lease."""
        return self._generation if self.held else 0

    # -- acquisition / renewal --------------------------------------------

    def _spec(self, transitions: int, at: float,
              acquire_time: Optional[str] = None) -> Dict[str, Any]:
        now = nodelock.now_str(at=at, precise=True)
        return {
            "holderIdentity": self.identity,
            "leaseDurationSeconds": int(self.lease_s),
            "acquireTime": acquire_time or now,
            "renewTime": now,
            "leaseTransitions": transitions,
        }

    def _observed_silence_s(self, holder: str, spec: Dict[str, Any],
                            now: float) -> float:
        """How long WE have watched this exact (holder, renewTime) pair
        without change, on our own clock. The remote timestamp is used
        only as an opaque change-detection token — comparing it against
        our clock would turn inter-replica wall-clock OFFSET into a
        false steal of a live leader."""
        key = (holder, spec.get("renewTime")
               or spec.get("acquireTime") or "")
        if key != self._obs_key:
            self._obs_key = key
            self._obs_at = now
            return 0.0
        return now - self._obs_at

    def _try_once(self, steal: bool = True, force: bool = False) -> bool:
        """One acquire/renew pass; ConflictError propagates (caller
        retries with backoff, the nodelock loop shape). With
        ``steal=False`` the pass only ever RENEWS an existing holding —
        it never creates the lease, never takes an empty holder, never
        steals a silent one (the mid-promotion renewal ticker runs in
        this mode so a shutdown race can never re-steal a lease the
        coordinator just released).

        ``force=True`` (multi-active group ownership, vtpu_torch/ha/groups.py)
        takes the lease from a LIVE holder without waiting out the
        silence window — a deliberate, fencing-safe handoff: the CAS
        still serializes contenders, and the transitions bump deposes
        the previous holder's generation, so its in-flight commits fail
        the committer's fence exactly as a silence-steal would. Only
        the group coordinator's planned rebalance / cross-group gang
        takeover paths use it.

        Disjointness detail: `t0` — read BEFORE any RPC — anchors both
        the renewTime the server stores and our local fencing-validity
        window. A peer may steal at renewTime+lease_s; anchoring our
        own expiry to a post-RPC clock read would let a slow apiserver
        round-trip (exactly failover conditions) keep a deposed leader
        fencing-valid for the RPC's duration after a steal became
        legal."""
        t0 = self.clock()
        try:
            lease = self.client.get_lease(self.namespace, self.name)
        except NotFoundError:
            if not steal:
                self._note_lost()
                return False
            # seed a (re)created lease's generation ABOVE everything we
            # ever observed: an operator deleting the lease to force
            # re-election must not rewind fencing below generations
            # already stamped on pods
            gen0 = self._max_seen + 1
            created = self.client.create_lease(
                self.namespace, self.name,
                self._spec(transitions=gen0, at=t0))
            self._note_held(created["spec"], at=t0)
            log.info("lease %s/%s created; %s leads (generation %d)",
                     self.namespace, self.name, self.identity, gen0)
            return True
        spec = lease.get("spec", {}) or {}
        rv = lease.get("metadata", {}).get("resourceVersion", "")
        holder = spec.get("holderIdentity", "")
        transitions = int(spec.get("leaseTransitions", 0) or 0)
        self._max_seen = max(self._max_seen, transitions)
        if holder == self.identity:
            # renew: same holder, same generation
            updated = self.client.update_lease_guarded(
                self.namespace, self.name,
                self._spec(transitions, at=t0,
                           acquire_time=spec.get("acquireTime")), rv)
            self._note_held(updated["spec"], at=t0)
            return True
        if holder and not force:
            silence = self._observed_silence_s(holder, spec, t0)
            # the required silence honors the HOLDER's advertised
            # duration (client-go gates on the observed record's
            # LeaseDurationSeconds): during a rollout that changes
            # VTPU_LEASE_EXPIRE_S, a not-yet-updated contender must not
            # depose a leader that is still valid by its own, longer
            # window — max() keeps the steal safe in both directions
            try:
                advertised = float(spec.get("leaseDurationSeconds")
                                   or 0.0)
            except (TypeError, ValueError):
                advertised = 0.0
            if silence < max(self.lease_s, advertised):
                self._note_lost()
                return False
        if not steal:
            # renew-only mode and the holder is not (or no longer) us
            self._note_lost()
            return False
        if holder and force:
            # planned takeover of a live holder's group (see docstring):
            # the transitions bump below fences the previous holder
            log.info("lease %s/%s taken over from %s by %s (forced "
                     "rebalance/handoff)", self.namespace, self.name,
                     holder, self.identity)
        elif holder:
            # the holder went a full lease window of OUR clock without
            # renewing: dead. Steal, bumping the fencing generation —
            # nodelock.go:94-102's reset, with a token
            log.warning("lease %s/%s holder %s silent for %.1fs; %s "
                        "stealing", self.namespace, self.name, holder,
                        silence, self.identity)
        # (an empty holder is an explicit release: stealable now)
        updated = self.client.update_lease_guarded(
            self.namespace, self.name,
            self._spec(transitions + 1, at=t0), rv)
        self._note_held(updated["spec"], at=t0)
        log.info("lease %s/%s acquired by %s (generation %d)",
                 self.namespace, self.name, self.identity,
                 self._generation)
        return True

    def _note_held(self, spec: Dict[str, Any], at: float) -> None:
        self._generation = int(spec.get("leaseTransitions", 0) or 0)
        self._max_seen = max(self._max_seen, self._generation)
        self._last_renew_ok = at
        self._held = True
        # contender observation state is meaningless while we hold:
        # clearing it guarantees a later failed renewal's _obs_key
        # names only a holder that renewal ACTUALLY observed, not a
        # pre-acquisition leftover (groups.py _suspect_collision and
        # _note_holder read it as a freshness-sensitive hint)
        self._obs_key = None
        self._obs_at = 0.0

    def _note_lost(self) -> None:
        self._held = False

    def try_acquire(self, steal: bool = True, force: bool = False) -> bool:
        """Acquire-or-renew, retrying CAS conflicts up to MAX_RETRY
        times (the nodelock loop). Returns whether we hold the lease;
        never raises on contention — losing is a normal outcome.
        ``steal=False`` restricts the pass to renewing an existing
        holding; ``force=True`` deposes a live holder (see _try_once)."""
        for i in range(MAX_RETRY):
            try:
                return self._try_once(steal, force=force)
            except ConflictError:
                time.sleep(RETRY_DELAY_S * (i + 1))
            except Exception:
                # apiserver trouble: we cannot confirm our holding, so
                # report what fencing validity says rather than guessing
                log.exception("lease %s/%s acquire/renew attempt failed",
                              self.namespace, self.name)
                return self.held
        return self.held

    def release(self) -> None:
        """Best-effort handover on clean shutdown: clear the holder so
        the peer steals immediately instead of waiting out lease_s."""
        was_held, self._held = self._held, False
        if not was_held:
            return
        for i in range(MAX_RETRY):
            try:
                lease = self.client.get_lease(self.namespace, self.name)
                spec = lease.get("spec", {}) or {}
                if spec.get("holderIdentity") != self.identity:
                    return  # someone already took over
                spec = dict(spec)
                spec["holderIdentity"] = ""
                self.client.update_lease_guarded(
                    self.namespace, self.name, spec,
                    lease.get("metadata", {}).get("resourceVersion", ""))
                return
            except NotFoundError:
                return
            except ConflictError:
                time.sleep(RETRY_DELAY_S * (i + 1))
            except Exception:
                log.exception("lease %s/%s release failed",
                              self.namespace, self.name)
                return
        log.warning("lease %s/%s release lost its CAS races; peer will "
                    "steal after expiry", self.namespace, self.name)
