"""Host-memory guard: graceful degradation for over-quota offloaders.

The port's copy of vtpu/monitor/hostguard.py. The interposer's host ledger
(shared-region ABI v8, libvgpu.so's host_charge) is the hard front line:
a tenant's pinned host allocations are REFUSED with
CUDA_ERROR_OUT_OF_MEMORY before they can pin a byte past
``vtpu.io/host-memory``. What the try-path cannot stop is
memory the runtime already materialized — force charges (post-hoc
true-ups) and ledger drift from an uncooperative workload — which can
leave ``host_used > host_limit`` standing. This module is the node
monitor's escalation for exactly that state, the host twin of the
resize applier's clamp → grace → block discipline
(vtpu/monitor/resize.py, docs/elastic-quotas.md):

  1. **clamp** — already in effect the instant usage crosses the
     limit: every further host ``try_alloc`` is rejected at the region
     layer, so the overage cannot GROW through cooperative paths;
  2. **grace** — the tenant gets ``VTPU_HOST_GRACE_S`` seconds to shed
     the overage (free offloaded buffers) before any throttling;
  3. **block** — past the grace window the entry joins the guard's
     blocked set, and the :class:`~vtpu_torch.monitor.feedback.FeedbackLoop`
     — still the SOLE writer of ``utilization_switch`` — holds the
     tenant's launch throttle engaged until host usage drops back
     under the limit. The offender slows down; it is NEVER killed, and
     the kernel's OOM killer never picks a compliant co-tenant.

Crash safety: the blocked flag is durably recorded next to the cache
file (``vgpu.hostguard.json``, atomicio) and replayed on monitor
restart — a restart must not silently release an over-quota tenant.
The grace timer itself restarts conservatively (the tenant gets a
fresh grace window after a monitor crash; the block, once engaged,
survives). Quarantined regions are never judged — their numbers are
untrusted by definition.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Callable, Dict, Optional, Set

from prometheus_client import Counter

from .. import api
from ..enforce.region import RegionSnapshot
from ..util.atomicio import atomic_write_json, read_json
from ..util.env import env_float
from .pathmonitor import ContainerRegions

log = logging.getLogger("vtpu_torch.monitor")

#: durable per-entry guard record, next to the cache file (like the
#: quarantine marker and the resize intent); removed with the dir by GC
HOSTGUARD_RECORD = api.HOSTGUARD_RECORD

#: grace window between host-quota overage and feedback blocking
#: (config.md; the host twin of VTPU_RESIZE_GRACE_S)
HOST_GRACE_S_DEFAULT = 30.0

HOST_OVER = Counter(
    "vGPUHostQuotaOver",
    "host-ledger overage episodes observed (host_used crossed above "
    "host_limit; counted once per episode, at-least-once across a "
    "monitor crash)",
)
HOST_BLOCKED = Counter(
    "vGPUHostQuotaBlocked",
    "over-quota offloaders that exhausted VTPU_HOST_GRACE_S and "
    "engaged feedback blocking via utilization_switch",
)
HOST_UNBLOCKED = Counter(
    "vGPUHostQuotaUnblocked",
    "feedback blocks released because host usage dropped back under "
    "the host limit",
)


class HostLedgerGuard:
    """Watches every region's v8 host ledger and escalates overages.

    Driven once per monitor sweep (daemon.sweep_once) off the sweep's
    shared immutable snapshots — the guard never touches a live mmap.
    """

    def __init__(self, regions: ContainerRegions,
                 grace_s: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.regions = regions
        self.grace_s = (grace_s if grace_s is not None
                        else env_float(api.ENV_HOST_GRACE_S,
                                       HOST_GRACE_S_DEFAULT,
                                       minimum=0.0))
        self.clock = clock
        #: entry -> clock() of the first sweep that saw the overage
        self._over_since: Dict[str, float] = {}
        #: entries currently feedback-blocked for a host overage
        self._blocked: Set[str] = set()
        #: entries whose durable record has been consulted once
        self._probed: Set[str] = set()

    # -- read side (feedback loop, /nodeinfo) ------------------------------

    def host_blocked(self, name: str) -> bool:
        """True while `name` is feedback-blocked for a host-memory
        overage — the FeedbackLoop holds utilization_switch engaged."""
        return name in self._blocked

    def state_of(self, name: str) -> str:
        """'' (no host axis / within quota) | 'over' (grace running) |
        'blocked'."""
        if name in self._blocked:
            return "blocked"
        if name in self._over_since:
            return "over"
        return ""

    # -- durable record ----------------------------------------------------

    def _record_path(self, name: str) -> str:
        return os.path.join(self.regions.dir, name, HOSTGUARD_RECORD)

    def _replay(self, name: str) -> None:
        """Consult the durable record exactly once per entry: a block
        engaged by a previous monitor incarnation survives the
        restart."""
        if name in self._probed:
            return
        self._probed.add(name)
        rec = read_json(self._record_path(name))
        if isinstance(rec, dict) and rec.get("blocked"):
            self._blocked.add(name)
            log.warning("%s: replaying host-quota feedback block "
                        "(monitor restarted while tenant over limit)",
                        name)

    def _store(self, name: str, blocked: bool) -> None:
        try:
            atomic_write_json(self._record_path(name),
                              {"blocked": blocked})
        except OSError as e:
            # in-memory state still drives this incarnation; only
            # crash-replay protection is narrowed
            log.warning("cannot persist hostguard record for %s: %s",
                        name, e)

    # -- the sweep ---------------------------------------------------------

    def sweep(self, snapshots: Dict[str, RegionSnapshot]) -> int:
        """One guard pass over the sweep's snapshots; returns the
        number of entries whose guard state changed."""
        changed = 0
        now = self.clock()
        for name, snap in snapshots.items():
            # quarantine interplay: scan_snapshots never surfaces
            # quarantined regions, so this is defense in depth
            if name in self.regions.quarantined:
                continue
            # consult the durable record BEFORE judging: a replayed
            # block must be liftable by the within-quota branch below
            # (the tenant may have shed the overage while the monitor
            # was down)
            self._replay(name)
            limit = snap.host_limit()
            used = snap.host_used()
            if limit <= 0 or used <= limit:
                # within quota (or no host axis): episode over
                if name in self._blocked:
                    self._blocked.discard(name)
                    self._store(name, False)
                    HOST_UNBLOCKED.inc()
                    changed += 1
                    log.info("%s: host usage %d B back under limit "
                             "%d B; feedback block lifted", name, used,
                             limit)
                self._over_since.pop(name, None)
                continue
            # over limit: the region-layer clamp already refuses new
            # cooperative charges; escalate on the grace clock
            first = self._over_since.get(name)
            if first is None:
                first = self._over_since[name] = now
                HOST_OVER.inc()
                changed += 1
                log.warning(
                    "%s: host ledger over quota (%d B used > %d B "
                    "limit); clamp active, %.0fs grace before feedback "
                    "blocking", name, used, limit, self.grace_s)
            if (name not in self._blocked
                    and now - first > self.grace_s):
                self._blocked.add(name)
                self._store(name, True)
                HOST_BLOCKED.inc()
                changed += 1
                log.warning(
                    "%s: host overage outlived %.0fs grace; engaging "
                    "feedback blocking (utilization_switch) until the "
                    "tenant sheds %d B", name, self.grace_s,
                    used - limit)
        # entries whose dir vanished (pod GC'd) must not pin state
        # forever; their durable record went with the dir
        for name in list(self._over_since):
            if name not in snapshots:
                self._over_since.pop(name, None)
        for name in list(self._blocked):
            if name not in snapshots:
                self._blocked.discard(name)
        self._probed &= set(snapshots)
        return changed
