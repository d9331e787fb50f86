"""Active/passive scheduler pair: role state machine over ClusterLease.

The port's copy of vtpu/ha/coordinator.py.

Both replicas run the full warm path — registration poll, pod watch,
overlay — so their in-memory views track the annotation bus
continuously; only the LEADER decides and commits. The coordinator owns
the role transitions:

  standby --(lease acquired)--> promoting --(on_promote ok)--> leader
  leader  --(renewal lost/expired)---------------------------> standby

``on_promote(generation)`` runs BEFORE the role flips to leader: it is
where the scheduler rebuilds gang state from the annotation bus
(Scheduler.recover) so the first decision the new leader takes already
respects every half-placed gang. A failing promotion releases the lease
and returns to standby — a leader that cannot reconstruct its state
must not serve guesses.

Demotion is deliberately cheap: flip the role, zero the fencing
generation (every queued commit from the old generation then fails the
committer's fence check), and keep the caches warm for the next term.
"""

from __future__ import annotations

import logging
import threading

from ..trace import tracer as _tracer
from ..trace import trace_id_for_uid

from .lease import ClusterLease

log = logging.getLogger(__name__)

ROLE_LEADER = "leader"
ROLE_STANDBY = "standby"

#: renew cadence: a third of the expiry so two missed renewals still
#: leave margin before the peer may steal
RENEW_FRACTION = 3.0


class HACoordinator:
    def __init__(self, lease: ClusterLease,
                 on_promote=None, on_demote=None,
                 renew_s: float = 0.0) -> None:
        self.lease = lease
        self.on_promote = on_promote
        self.on_demote = on_demote
        self.renew_s = renew_s or lease.lease_s / RENEW_FRACTION
        self._role = ROLE_STANDBY
        self._stop = threading.Event()
        self._thread = None
        self.promotions = 0  # observability

    # -- read side ---------------------------------------------------------

    @property
    def role(self) -> str:
        # a leader whose lease lapsed (paused process, apiserver cut)
        # reports standby immediately — the role must never outlive the
        # fencing validity the committer checks
        if self._role == ROLE_LEADER and not self.lease.held:
            return ROLE_STANDBY
        return self._role

    def is_leader(self) -> bool:
        return self.role == ROLE_LEADER

    @property
    def generation(self) -> int:
        """Current fencing token (0 unless validly leading)."""
        return self.lease.generation

    # group-view compat (vtpu/ha/groups.py GroupCoordinator): the binary
    # pair is the n_groups=1 degenerate case — the leader owns the one
    # and only group 0, the standby owns nothing. Scheduler/routes code
    # is written against this group view and works unchanged under
    # either coordinator.

    def owns(self, group: int) -> bool:
        return self.is_leader()

    def generation_for(self, group: int) -> int:
        return self.generation

    def owned_groups(self):
        return frozenset({0}) if self.is_leader() else frozenset()

    def owner_of(self, group: int) -> str:
        return self.lease.identity if self.is_leader() else ""

    # -- state machine -----------------------------------------------------

    def poll_once(self) -> None:
        """One acquire/renew attempt + role transition. Factored out so
        tests (and the chaos harness) drive the exact production path
        without threads."""
        if self._role == ROLE_LEADER and not self.lease.held:
            # our fencing validity lapsed (pause/partition): step down
            # BEFORE trying to acquire. Without this, a paused
            # ex-leader that re-wins the lease below (peer released, or
            # expiry) would keep its stale raw role and SKIP the
            # promotion — serving a new generation without the
            # mandatory gang-state rebuild
            self._demote("lease validity lapsed")
        held = self.lease.try_acquire()
        if held and self._role != ROLE_LEADER:
            self._promote()
        elif not held and self._role == ROLE_LEADER:
            self._demote("lease lost")

    def _promote(self) -> None:
        gen = self.lease.generation
        tid = trace_id_for_uid(f"ha:{self.lease.name}:{gen}")
        # keep renewing WHILE the promotion rebuild runs: recover() on a
        # big cluster can outlast the lease window, and a promotion that
        # starves its own renewal would let the peer steal mid-rebuild —
        # the pair then livelocks promoting/stealing with nobody ever
        # validly leading (client-go renews on a separate goroutine from
        # the leading callbacks for the same reason). The ticker is the
        # ONLY try_acquire caller while the poll thread sits here, and
        # it is joined before poll_once resumes, so the lease object
        # never sees concurrent calls.
        done = threading.Event()

        def _renew_through_promotion():
            while not done.wait(self.renew_s):
                if self._stop.is_set():
                    return  # stop() may time out joining a stuck
                    # promotion; the ticker must die on its own
                try:
                    # renew-ONLY: were this allowed to steal, a
                    # shutdown racing a stuck promotion could release
                    # the lease and have this very ticker re-steal it
                    # for a dying process
                    self.lease.try_acquire(steal=False)
                except Exception:
                    log.exception("mid-promotion lease renewal failed")

        ticker = threading.Thread(target=_renew_through_promotion,
                                  name="vtpu-ha-promote-renew",
                                  daemon=True)
        ticker.start()
        try:
            with _tracer.span(tid, "ha.promote",
                              identity=self.lease.identity,
                              generation=gen):
                if self.on_promote is not None:
                    self.on_promote(gen)
        except Exception:
            log.exception(
                "promotion of %s (generation %d) failed; releasing the "
                "lease and staying standby", self.lease.identity, gen)
            done.set()
            ticker.join(timeout=10.0)
            self.lease.release()
            return
        finally:
            done.set()
            ticker.join(timeout=10.0)
        self._role = ROLE_LEADER
        self.promotions += 1
        log.info("%s promoted to leader (generation %d)",
                 self.lease.identity, gen)

    def _demote(self, why: str) -> None:
        self._role = ROLE_STANDBY
        log.warning("%s demoted to standby: %s", self.lease.identity, why)
        if self.on_demote is not None:
            try:
                self.on_demote()
            except Exception:
                log.exception("demotion callback failed")

    # -- thread ------------------------------------------------------------

    def run(self) -> None:
        while not self._stop.is_set():
            try:
                self.poll_once()
            except Exception:
                log.exception("HA coordinator poll failed")
            self._stop.wait(self.renew_s)

    def start(self) -> "HACoordinator":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self.run, name="vtpu-ha-coordinator", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        """Clean shutdown: release the lease so the peer promotes now
        instead of after the expiry window. The poll thread is joined
        FIRST — an in-flight try_acquire racing the release could hit
        its CAS conflict, re-read the empty holder, and re-steal the
        lease we just gave up, leaving it held by a dead process."""
        self._stop.set()
        t = self._thread
        if (t is not None and t.is_alive()
                and t is not threading.current_thread()):
            t.join(timeout=10.0)
            if t.is_alive():
                log.warning("HA poll thread did not stop in 10s; "
                            "releasing anyway (peer may have to wait "
                            "out lease expiry)")
        if self._role == ROLE_LEADER:
            self._demote("shutting down")
        self.lease.release()
