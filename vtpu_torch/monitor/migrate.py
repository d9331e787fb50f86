"""Crash-safe drain coordination: migration stamps → workload handshake.

The port's copy of vtpu/monitor/migrate.py; the workload's half is
vtpu_torch/enforce/workload.py's Enforcer.drain_*.

The node half of the live-migration protocol (docs/migration.md). The
scheduler's migration planner lands the durable ``vtpu.io/migrating-to``
stamp on a pod; this coordinator — driven once per monitor sweep, the
same single-writer discipline as resize/host/preempt blocking — turns
the stamp into the workload-visible drain handshake:

  1. **durable drain request** — on first sight of a new migration
     generation the coordinator atomically writes the drain request
     sidecar (``<entry>/vgpu.drain.json``, the workload-facing file
     defined by vtpu_torch/enforce/workload.py) BEFORE anything else, so a
     monitor SIGKILLed at any later instruction replays the request on
     restart (writing an absolute generation is idempotent — replay is
     exactly-once in effect);
  2. **ack tracking** — the cooperative workload
     (through :meth:`~vtpu_torch.enforce.workload.Enforcer.drain_ack`) snapshots into
     host-ledger-accounted memory and atomically writes the ack
     sidecar; the coordinator publishes the phase on /nodeinfo
     (``migrate_state``) so the planner can drive the cutover;
  3. **quiesce blocking** — once a workload acks ``snapshotted`` its
     launches are feedback-blocked via ``utilization_switch``
     (:meth:`migrate_blocked`, consulted by the FeedbackLoop exactly
     like ``resize_blocked``): the drained source replica must not
     mutate state the destination already owns.

Uncooperative workloads simply never ack; the scheduler-side deadline
(``VTPU_MIGRATE_DEADLINE_S``) then falls the move back to preemption
delete — the coordinator never kills anything itself.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Callable, Dict, Optional, Set, Tuple

from prometheus_client import Counter

from ..enforce.workload import (
    DRAIN_ACK_FILE,
    DRAIN_PHASE_REFUSED,
    DRAIN_PHASE_SNAPSHOTTED,
    DRAIN_REQUEST_FILE,
)
from ..trace import trace_id_for_uid
from ..trace import tracer as _tracer
from ..util import codec
from ..util.atomicio import atomic_write_json, read_json
from ..util.types import (
    MIGRATE_DEADLINE_ANNO,
    MIGRATED_FROM_ANNO,
    MIGRATING_TO_ANNO,
)
from .pathmonitor import ContainerRegions, pod_uid_of_entry

log = logging.getLogger("vtpu_torch.monitor")

MIGRATE_DRAINS = Counter(
    "vGPUMigrateDrainsRequested",
    "drain requests written to workloads (generation transitions; "
    "at-least-once across a monitor crash)",
)
MIGRATE_SNAPSHOTS = Counter(
    "vGPUMigrateSnapshotsAcked",
    "workload snapshot acks observed (once per generation)",
)
MIGRATE_REFUSALS = Counter(
    "vGPUMigrateDrainsRefused",
    "drains the workload refused (host ledger could not account the "
    "snapshot); the planner falls these back to preemption delete",
)


class DrainCoordinator:
    """Coordinates workload drains for this node's shared regions.

    Driven once per monitor sweep (daemon.sweep_once). ``annos_of``
    maps a pod uid to its annotations (the watch-backed PodCache in
    production); with no pod source wired the coordinator is inert.
    """

    def __init__(self, regions: ContainerRegions,
                 annos_of: Optional[Callable[[str],
                                             Optional[Dict[str, str]]]]
                 = None,
                 clock: Callable[[], float] = time.time) -> None:
        self.regions = regions
        self.annos_of = annos_of
        self.clock = clock
        #: entry -> current drain request (mirrors the durable sidecar;
        #: the file is the authority across restarts)
        self._requests: Dict[str, Dict] = {}
        #: entry -> last observed ack phase for the request generation
        self._phases: Dict[str, str] = {}
        #: entries whose disk sidecars were consulted at least once
        self._probed: Set[str] = set()
        #: (entry, gen, event) metric transitions already counted
        self._counted: Set[Tuple[str, int, str]] = set()
        #: entries whose drained source replica is launch-blocked
        self._blocked: Set[str] = set()
        # chaos kill point (tests/test_migrate_chaos.py): raise a
        # BaseException — the SIGKILL stand-in — right after the
        # durable drain request lands
        self.kill_after_intent: Optional[Callable[[], None]] = None

    # -- read side (feedback loop, /nodeinfo, planner) ---------------------

    def migrate_blocked(self, name: str) -> bool:
        """True while `name`'s drained source replica must not launch —
        the FeedbackLoop holds utilization_switch engaged from the
        snapshot ack until the migration stamp clears (cutover)."""
        return name in self._blocked

    def gen_of(self, name: str) -> int:
        """Generation of the current drain request; 0 when none."""
        rec = self._requests.get(name)
        return int(rec.get("gen", 0)) if rec else 0

    def state_of(self, name: str) -> str:
        """'' | 'draining' | 'snapshotted' | 'refused'."""
        if name not in self._requests:
            return ""
        phase = self._phases.get(name, "")
        if phase == DRAIN_PHASE_SNAPSHOTTED:
            return "snapshotted"
        if phase == DRAIN_PHASE_REFUSED:
            return "refused"
        return "draining"

    # -- durable sidecar helpers -------------------------------------------

    def _request_path(self, name: str) -> str:
        return os.path.join(self.regions.dir, name, DRAIN_REQUEST_FILE)

    def _ack_path(self, name: str) -> str:
        return os.path.join(self.regions.dir, name, DRAIN_ACK_FILE)

    def _load_request(self, name: str) -> Optional[Dict]:
        """In-memory request, falling back to the durable sidecar
        exactly once per entry — the crash-replay read."""
        rec = self._requests.get(name)
        if rec is not None or name in self._probed:
            return rec
        self._probed.add(name)
        loaded = read_json(self._request_path(name))
        if isinstance(loaded, dict) and "gen" in loaded:
            self._requests[name] = loaded
            log.warning("replaying drain request gen %s for %s "
                        "(monitor restarted mid-drain)",
                        loaded.get("gen"), name)
            return loaded
        return None

    @staticmethod
    def _cutover_landed(annos: Dict[str, str], rec: Dict) -> bool:
        """True when the stamp cleared because the cutover COMMITTED
        (the pod carries a ``vtpu.io/migrated-from`` record at or above
        the request's generation) rather than because the planner
        aborted/expired the move."""
        raw = annos.get(MIGRATED_FROM_ANNO, "")
        if not raw:
            return False
        try:
            gen, _src = codec.decode_migrated_from(raw)
        except codec.CodecError:
            return False
        try:
            return gen >= int(rec.get("gen", 0))
        except (TypeError, ValueError):
            return False

    def _count_once(self, name: str, gen: int, event: str,
                    metric) -> None:
        key = (name, gen, event)
        if key not in self._counted:
            self._counted.add(key)
            metric.inc()

    # -- the sweep ---------------------------------------------------------

    def sweep(self, entries) -> int:
        """One coordination pass; returns the number of entries whose
        drain state advanced (request written or ack phase moved)."""
        if self.annos_of is None:
            return 0
        advanced = 0
        for name in entries:
            if name in self.regions.quarantined:
                continue
            try:
                if self._sweep_one(name):
                    advanced += 1
            except (ValueError, OSError) as e:
                log.debug("drain skip %s: %s", name, e)
        # entries whose dir vanished (pod GC'd after cutover) must not
        # pin state forever — the sidecars went with the dir
        live = set(entries)
        for name in list(self._blocked):
            if name not in live:
                self._blocked.discard(name)
        for name in list(self._requests):
            if name not in live:
                self._requests.pop(name, None)
                self._phases.pop(name, None)
                self._probed.discard(name)
        self._counted = {k for k in self._counted if k[0] in live}
        return advanced

    def _sweep_one(self, name: str) -> bool:
        uid = pod_uid_of_entry(name)
        annos = self.annos_of(uid)
        if annos is None:
            return False
        stamp = annos.get(MIGRATING_TO_ANNO)
        rec = self._load_request(name)
        if not stamp:
            # stamp cleared (cutover committed or move aborted): the
            # handshake for this entry is over — lift the quiesce block
            # and drop state; the next stamp starts a new generation
            changed = name in self._blocked or rec is not None
            self._blocked.discard(name)
            self._requests.pop(name, None)
            self._phases.pop(name, None)
            if rec is not None and not self._cutover_landed(annos, rec):
                # abort/expiry: the planner retracted the move and the
                # workload stays at the source — the durable request
                # sidecar must retract WITH the stamp, or the workload
                # would later see the stale request, snapshot, charge
                # the host ledger, and drain itself for a move nobody
                # is driving. (A cutover keeps the sidecars: the
                # drained source must not resume — its state now lives
                # at the destination — and the entry dir dies with the
                # source container anyway.)
                for path in (self._request_path(name),
                             self._ack_path(name)):
                    try:
                        os.unlink(path)
                    except FileNotFoundError:
                        pass
            return changed
        try:
            gen, dest, _devices = codec.decode_migrating_to(stamp)
        except codec.CodecError as e:
            log.error("pod %s: undecodable migration stamp: %s", uid, e)
            return False
        changed = False
        if rec is None or int(rec.get("gen", 0)) < gen:
            # phase 1 — durable drain request BEFORE anything acts: a
            # monitor SIGKILLed past this line replays from the sidecar
            deadline = 0.0
            try:
                deadline = float(annos.get(MIGRATE_DEADLINE_ANNO, 0.0))
            except (TypeError, ValueError):
                pass
            rec = {"gen": gen, "dest": dest, "deadline": deadline}
            # unlink any stale ack BEFORE the new request lands: the
            # gen check below already ignores acks for other
            # generations, but a scheduler restarted without HA can
            # reuse a generation number — a leftover ack file must
            # never satisfy a NEW drain the workload hasn't answered.
            # (Killed between unlink and write: the replay rewrites
            # the request and the workload re-acks — still safe.)
            try:
                os.unlink(self._ack_path(name))
            except FileNotFoundError:
                pass
            with _tracer.span(trace_id_for_uid(uid), "migrate.drain",
                              entry=name, gen=gen, dest=dest):
                atomic_write_json(self._request_path(name), rec)
            self._requests[name] = rec
            self._phases.pop(name, None)
            self._count_once(name, gen, "drain", MIGRATE_DRAINS)
            changed = True
            if self.kill_after_intent is not None:
                self.kill_after_intent()
        elif int(rec.get("gen", 0)) > gen:
            # defense in depth behind the committer's fencing: a stale
            # (deposed-leader) stamp never rewinds a newer drain
            return False
        # phase 2 — ack tracking: the workload's durable answer
        ack = read_json(self._ack_path(name))
        phase = ""
        if isinstance(ack, dict):
            try:
                if int(ack.get("gen", 0)) == gen:
                    phase = str(ack.get("phase", ""))
            except (TypeError, ValueError):
                pass
        if phase and phase != self._phases.get(name):
            self._phases[name] = phase
            changed = True
            if phase == DRAIN_PHASE_SNAPSHOTTED:
                # quiesce: the drained replica launches nothing more
                # until the stamp clears — this window IS the blackout
                self._blocked.add(name)
                self._count_once(name, gen, "snap", MIGRATE_SNAPSHOTS)
                log.info("%s: snapshot acked for migration gen %d to "
                         "%s; launches blocked until cutover",
                         name, gen, rec.get("dest", "?"))
            elif phase == DRAIN_PHASE_REFUSED:
                self._blocked.discard(name)
                self._count_once(name, gen, "refused",
                                 MIGRATE_REFUSALS)
                log.warning("%s: workload refused drain gen %d (host "
                            "ledger); falling back to preemption",
                            name, gen)
        return changed
