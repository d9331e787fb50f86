"""SLO-driven replica autoscaling: the gateway's leader-gated loop, the
port of vtpu/gateway/autoscaler.py. It is gated by the port's
:mod:`vtpu_torch.ha` coordinators (``owns(0)``, else ``is_leader()``) and
fenced by their generation.

The third leader-gated control loop in the system, same discipline as
the rebalancer and the preemption engine (docs/ha.md): a standby — or
a deposed leader whose fencing generation lapsed — observes nothing
and mutates nothing, so a SIGKILLed leader's half-decided scale
actions die with it and the promoted successor re-derives the world
from live signals.

Policy (docs/serving.md ADR):

* **Grow** when the p99-vs-SLO headroom over the last poll window
  shrinks below ``VTPU_GW_HEADROOM`` (the fleet is about to miss the
  SLO) or the queues are backing up beyond one full batch per
  replica. Spawned replicas are **best-effort priority**
  (``TASK_PRIORITY_DEFAULT``) — the scheduler's preemption can legally
  reclaim them the moment a guaranteed gang arrives; serving
  capacity above the pinned baseline is explicitly the cluster's
  slack, not a reservation.
* **Shrink** only on SUSTAINED idleness (``VTPU_GW_IDLE_ROUNDS``
  consecutive quiet polls), preferring replicas whose pods the
  rebalancer marked as migration candidates — defrag and
  autoscaling pull the same direction — then best-effort over
  guaranteed, then the emptiest queue.

All ReplicaSet mutation happens HERE, under ``ReplicaSet.lock``
(``*_locked`` mutators). The router only reads the set.
"""

from __future__ import annotations

import logging
import threading
from typing import Callable, Dict, List, Optional

from .. import api
from ..util import lockdebug, types
from ..util.env import env_float, env_int
from . import metrics as metricsmod
from .batcher import SLO_MS_DEFAULT
from .router import Replica

log = logging.getLogger(__name__)

#: autoscaler defaults (docs/config.md)
MIN_REPLICAS_DEFAULT = 1
MAX_REPLICAS_DEFAULT = 8
AUTOSCALE_S_DEFAULT = 10.0
IDLE_ROUNDS_DEFAULT = 3
HEADROOM_DEFAULT = 0.1
#: a poll counts as idle when its p99 sits below this fraction of the
#: SLO with empty queues — comfortably under, not merely passing
IDLE_P99_FRACTION = 0.4


class ReplicaSet:
    """The mutable set of one model's replicas.

    ``lock`` guards membership; the ``*_locked`` mutators require it
    held and are only called from the autoscaler's gated path (or the
    take-the-lock wrappers below, which exist for composition code —
    bench/soak harnesses — that owns no leadership). Readers
    (``list``/``get``) take the lock briefly and hand out snapshots.
    """

    def __init__(self, model: str = "default") -> None:
        self.model = model
        self.lock = lockdebug.lock("gateway.replicas")
        self._replicas: Dict[str, Replica] = {}

    # -- reads (router-safe) ----------------------------------------------

    def list(self) -> List[Replica]:
        with self.lock:
            return list(self._replicas.values())

    def get(self, name: str) -> Optional[Replica]:
        with self.lock:
            return self._replicas.get(name)

    def __len__(self) -> int:
        with self.lock:
            return len(self._replicas)

    # -- mutators (lock held, autoscaler path only) ------------------------

    def add_replica_locked(self, replica: Replica) -> None:
        """Caller holds ``self.lock``."""
        self._replicas[replica.name] = replica
        metricsmod.GW_REPLICAS.labels(self.model).set(
            len(self._replicas))

    def remove_replica_locked(self, name: str) -> Optional[Replica]:
        """Caller holds ``self.lock``."""
        replica = self._replicas.pop(name, None)
        metricsmod.GW_REPLICAS.labels(self.model).set(
            len(self._replicas))
        return replica

    # -- wrappers for non-leader composition code --------------------------

    def add(self, replica: Replica) -> None:
        with self.lock:
            self.add_replica_locked(replica)

    def remove(self, name: str) -> Optional[Replica]:
        with self.lock:
            return self.remove_replica_locked(name)


class Autoscaler:
    """The control loop. ``poll_once`` is what tests/bench/soak
    drive; ``start`` runs it on a daemon thread every
    VTPU_GW_AUTOSCALE_S seconds."""

    def __init__(self, replicas: ReplicaSet,
                 spawn: Callable[[], Optional[Replica]],
                 retire: Callable[[Replica], None], *,
                 ha: Optional[object] = None,
                 fence: Optional[Callable[[], int]] = None,
                 slo_s: Optional[float] = None,
                 min_replicas: Optional[int] = None,
                 max_replicas: Optional[int] = None,
                 idle_rounds: Optional[int] = None,
                 headroom: Optional[float] = None,
                 period_s: Optional[float] = None) -> None:
        self.replicas = replicas
        #: builds ONE new best-effort replica (schedules its pod,
        #: wires its batcher); returns None when the cluster refused
        self.spawn = spawn
        #: tears one replica down AFTER it left the set (delete pod,
        #: close model); the caller composes queue drainage via
        #: Router.drain_replica
        self.retire = retire
        self.ha = ha
        self.fence = fence
        self.slo_s = (slo_s if slo_s is not None
                      else env_float(api.ENV_GW_SLO_MS, SLO_MS_DEFAULT,
                                     minimum=1.0) / 1e3)
        self.min_replicas = (min_replicas if min_replicas is not None
                             else env_int(api.ENV_GW_MIN_REPLICAS,
                                          MIN_REPLICAS_DEFAULT,
                                          minimum=0))
        self.max_replicas = (max_replicas if max_replicas is not None
                             else env_int(api.ENV_GW_MAX_REPLICAS,
                                          MAX_REPLICAS_DEFAULT,
                                          minimum=1))
        self.idle_rounds = (idle_rounds if idle_rounds is not None
                            else env_int(api.ENV_GW_IDLE_ROUNDS,
                                         IDLE_ROUNDS_DEFAULT,
                                         minimum=1))
        self.headroom = (headroom if headroom is not None
                         else env_float(api.ENV_GW_HEADROOM,
                                        HEADROOM_DEFAULT, minimum=0.0))
        self.period_s = (period_s if period_s is not None
                         else env_float(api.ENV_GW_AUTOSCALE_S,
                                        AUTOSCALE_S_DEFAULT,
                                        minimum=0.0))
        self._idle_streak = 0
        self.grows = 0
        self.shrinks = 0
        self.last_p99 = 0.0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- signal window ----------------------------------------------------

    @staticmethod
    def _p99(samples: List[float]) -> float:
        if not samples:
            return 0.0
        ordered = sorted(samples)
        return ordered[min(len(ordered) - 1,
                           int(0.99 * len(ordered)))]

    def _pick_victim(self, live: List[Replica]) -> Replica:
        """Shrink preference: migration-candidate first (defrag and
        autoscaling pulling the same direction), then best-effort
        before guaranteed, then the emptiest queue."""
        return min(live, key=lambda r: (
            not r.migration_candidate,
            r.priority == types.TASK_PRIORITY_HIGH,
            r.batcher.depth, r.name))

    # -- the loop ----------------------------------------------------------

    def poll_once(self) -> int:
        """One gated control round; returns scale actions taken (+1
        grow / -1 shrink as a net count). Ownership-gated end to end,
        exactly the rebalancer's discipline: no lease or fencing
        lapse (generation 0) means observe nothing, mutate nothing.
        Under multi-active (docs/ha.md) this loop is GLOBAL — replica
        counts are fleet-wide, so exactly one instance may run it:
        the owner of shard group 0, the designated control group
        (binary coordinators expose owns(0) == is_leader(), so the
        pair's behavior is unchanged)."""
        if self.ha is not None:
            owns = getattr(self.ha, "owns", None)
            if owns is not None:
                if not owns(0):
                    return 0
            elif not self.ha.is_leader():
                return 0
        if self.fence is not None:
            # the fence callable reports the control group's (group
            # 0's) generation — the default group of every fence fn
            generation = self.fence()
            if self.ha is not None and generation == 0:
                return 0
        live = [r for r in self.replicas.list() if r.live]
        samples: List[float] = []
        depth = 0
        batch_capacity = 0
        for r in live:
            samples.extend(r.batcher.pop_latencies())
            depth += r.batcher.depth
            batch_capacity += r.batcher.batch
        p99 = self._p99(samples)
        self.last_p99 = p99
        actions = 0
        pressured = (samples and p99 > self.slo_s * (1.0 - self.headroom)
                     ) or depth > batch_capacity
        idle = (not samples and depth == 0) or (
            samples and depth == 0
            and p99 < self.slo_s * IDLE_P99_FRACTION)
        if pressured and len(live) < self.max_replicas:
            self._idle_streak = 0
            replica = self.spawn()
            if replica is not None:
                # autoscaled capacity is the cluster's slack: always
                # best-effort, so guaranteed gangs preempt it freely
                replica.priority = types.TASK_PRIORITY_DEFAULT
                with self.replicas.lock:
                    self.replicas.add_replica_locked(replica)
                self.grows += 1
                actions += 1
                log.info("gateway scale-up: %s (p99 %.1fms / SLO "
                         "%.1fms, depth %d)", replica.name, p99 * 1e3,
                         self.slo_s * 1e3, depth)
        elif idle:
            self._idle_streak += 1
            if self._idle_streak >= self.idle_rounds \
                    and len(live) > self.min_replicas:
                victim = self._pick_victim(live)
                with self.replicas.lock:
                    removed = self.replicas.remove_replica_locked(
                        victim.name)
                if removed is not None:
                    removed.live = False
                    self.retire(removed)
                    self.shrinks += 1
                    actions -= 1
                    log.info("gateway scale-down: %s (idle %d rounds)",
                             victim.name, self._idle_streak)
                self._idle_streak = 0
        else:
            self._idle_streak = 0
        return actions

    def run(self) -> None:
        while not self._stop.is_set():
            try:
                self.poll_once()
            except Exception:
                log.exception("gateway autoscale poll failed")
            self._stop.wait(self.period_s or AUTOSCALE_S_DEFAULT)

    def start(self) -> "Autoscaler":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self.run, name="vgpu-gw-autoscaler", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
