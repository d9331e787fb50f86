"""Priority feedback loop: monitor → shared regions → interposers.

The port's copy of vtpu/monitor/feedback.py, writing the feedback plane
libvgpu.so obeys: ``recent_kernel = BLOCK`` holds a priority>0 process's
launches, ``utilization_switch = 1`` lifts its SM-limit token bucket.

Reference semantics (feedback.go:197-269 + CHANGELOG.md:56-60): every 5s
the monitor observes which containers launched work recently; while any
high-priority (priority 0) container is active, low-priority containers'
regions get ``recent_kernel = BLOCK`` so their shims pause launches; when
the high-priority task goes idle the block lifts. The utilization_switch
honors GPU_CORE_UTILIZATION_POLICY: "force" keeps the throttler on even
for solo tenants, "disable" turns it off entirely.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Set

from ..enforce.region import (
    FEEDBACK_BLOCK,
    FEEDBACK_IDLE,
    RegionSnapshot,
    RegionView,
    UTIL_POLICY_DEFAULT,
)

log = logging.getLogger("vtpu_torch.monitor")

HIGH_PRIORITY = 0

# Inflight marks count as activity only while the slot's heartbeat is
# fresh. The shim heartbeats every 5s; 3 periods of slack tolerates a
# busy host without mistaking a SIGKILLed process (whose slot the host
# monitor must not GC — wrong pid namespace) for a running one. Without
# this, one dead high-priority process would block every low-priority
# tenant on its chips forever.
INFLIGHT_FRESH_NS = 15_000_000_000


@dataclass
class _Last:
    launches: int = 0
    active: bool = False
    seen: bool = False


class FeedbackLoop:
    def __init__(self,
                 resize_blocked: Optional[Callable[[str], bool]] = None,
                 host_blocked: Optional[Callable[[str], bool]] = None,
                 preempt_blocked: Optional[Callable[[str], bool]] = None,
                 migrate_blocked: Optional[Callable[[str], bool]] = None):
        self._last: Dict[str, _Last] = {}
        # elastic quotas (docs/elastic-quotas.md): while the resize
        # applier holds a container under shrink feedback blocking, the
        # throttle stays ENGAGED even for a solo tenant — the feedback
        # loop stays the sole writer of utilization_switch, so the two
        # monitor subsystems can never fight over the field
        self._resize_blocked = resize_blocked
        # host-memory quota (vtpu/monitor/hostguard.py): same
        # single-writer discipline for offloaders whose host ledger
        # outlived its grace window over the limit
        self._host_blocked = host_blocked
        # priority preemption (docs/multihost.md ADR): a victim whose
        # pod carries the durable vtpu.io/preempted-by stamp is a dead
        # pod walking — block its launches (and keep the throttle
        # engaged) until kubelet tears it down, so it cannot race the
        # incoming tenant's quota between decision and teardown. Same
        # single-writer discipline as the other two.
        self._preempt_blocked = preempt_blocked
        # live migration (docs/migration.md): a source replica that
        # acked its snapshot is quiesced — its launches stay blocked
        # from the ack until the migration stamp clears at cutover, so
        # it cannot mutate state the destination already owns. Same
        # single-writer utilization_switch discipline as the other
        # three (vtpu/monitor/migrate.py DrainCoordinator).
        self._migrate_blocked = migrate_blocked

    def observe(self, views: Dict[str, RegionView],
                snapshots: Optional[Dict[str, RegionSnapshot]] = None
                ) -> None:
        """One sweep: compute activity deltas, then write feedback.

        Activity uses the region's container-lifetime monotonic launch
        counter, so workload process restarts don't read as idleness; the
        first observation of a region only records a baseline (history is
        not activity — a monitor restart must not spuriously block).
        Blocking and throttle release are PER CHIP: containers are grouped
        by the chip UUIDs their regions carry, and a low-priority
        container is paused only while a high-priority container on one of
        ITS chips is active. Views racing container teardown are skipped.

        All READS come from immutable per-region snapshots (one bulk copy
        each); only the feedback writes touch the live mmaps. The daemon
        passes the sweep's shared snapshot set in; called with views only
        (the pre-snapshot signature), snapshots are taken here — behavior
        is identical either way. Comparing snapshot state before writing
        is safe: the monitor is the only writer of utilization_switch,
        and the shim bumps recent_kernel only while it is >= 0, so the
        blocked(-1)/not-blocked classification cannot race.
        """
        if snapshots is None:
            snapshots = {}
            for name, v in views.items():
                try:
                    snapshots[name] = v.snapshot()
                except (ValueError, OSError, TypeError, AttributeError):
                    continue
        usable: Dict[str, RegionSnapshot] = {}
        active: Dict[str, bool] = {}
        chips: Dict[str, Set[str]] = {}       # name -> chip uuids
        for name, snap in snapshots.items():
            if name not in views:
                continue
            prev = self._last.setdefault(name, _Last())
            launches = snap.total_launches()
            inflight = snap.inflight(max_age_ns=INFLIGHT_FRESH_NS)
            uuids = {u for u in snap.dev_uuids() if u}
            usable[name] = snap
            if not prev.seen:
                prev.seen = True
                # in-flight work IS current activity even with no history
                active[name] = inflight > 0
            else:
                # a container inside ONE multi-second program shows no
                # launch delta between sweeps; the in-flight count keeps
                # it "active" for the whole program (v3 ABI; improves the
                # reference's launch-delta-only granularity)
                active[name] = launches > prev.launches or inflight > 0
            prev.launches = launches
            prev.active = active[name]
            # regions with unknown chips share one implicit "chip" so the
            # conservative pre-UUID behavior (node-wide) still applies
            chips[name] = uuids or {"?"}
        for name in list(self._last):
            if name not in views:
                del self._last[name]

        # per-chip aggregates
        chip_tenants: Dict[str, int] = {}
        chip_active_high: Dict[str, bool] = {}
        for name, snap in usable.items():
            for c in chips[name]:
                chip_tenants[c] = chip_tenants.get(c, 0) + 1
                if snap.priority == HIGH_PRIORITY and active[name]:
                    chip_active_high[c] = True

        for name, snap in usable.items():
            solo = all(chip_tenants[c] == 1 for c in chips[name])
            blocked_by_high = any(
                chip_active_high.get(c, False) for c in chips[name])
            try:
                self._apply(name, views[name], snap, blocked_by_high, solo)
            except (AttributeError, ValueError):
                continue

    def _apply(self, name: str, v: RegionView, snap: RegionSnapshot,
               active_high: bool, solo: bool) -> None:
        # utilization switch: under the "default" policy the sole tenant
        # of its chip(s) needs no tensorcore throttle (reference
        # config.md:34-39); "force" keeps it on, "disable" is latched on
        # by the shim itself
        preempted = (self._preempt_blocked is not None
                     and self._preempt_blocked(name))
        # a drained migration source is quiesced exactly like a
        # preemption victim: dead replica walking until cutover
        migrating = (self._migrate_blocked is not None
                     and self._migrate_blocked(name))
        if snap.util_policy == UTIL_POLICY_DEFAULT:
            blocked_resize = (self._resize_blocked is not None
                              and self._resize_blocked(name))
            blocked_host = (self._host_blocked is not None
                            and self._host_blocked(name))
            # shrink/host-overage/preemption feedback blocking
            # overrides the solo-tenant release: an uncooperative
            # tenant past its grace window stays throttled until the
            # shrink lands / the host overage is shed / the victim is
            # torn down (DISABLE policy is exempt by construction — it
            # never reaches this branch; docs/elastic-quotas.md
            # "deliberate limits")
            want = 0 if (blocked_resize or blocked_host or preempted
                         or migrating) \
                else (1 if solo else 0)
            if snap.utilization_switch != want:
                v.set_utilization_switch(want)
                log.info("%s: throttle %s (default policy, %s)",
                         name, "off" if want else "on",
                         "resize block" if blocked_resize
                         else ("host-quota block" if blocked_host
                               else ("preempted" if preempted
                                     else ("migrating" if migrating
                                           else ("solo tenant" if solo
                                                 else "contended")))))

        if snap.priority == HIGH_PRIORITY and not (preempted
                                                   or migrating):
            # guaranteed pods are never launch-blocked — and by the
            # never-a-victim invariant they are never preempted either;
            # the `preempted` carve-out is defense in depth against a
            # direct apiserver write of the stamp
            return
        blocked = snap.recent_kernel == FEEDBACK_BLOCK
        want_block = active_high or preempted or migrating
        if want_block and not blocked:
            v.set_recent_kernel(FEEDBACK_BLOCK)
            log.info("blocking %s container %s",
                     "preempted" if preempted
                     else ("migrating" if migrating
                           else "low-priority"), name)
        elif not want_block and blocked:
            v.set_recent_kernel(FEEDBACK_IDLE)
            log.info("unblocking container %s", name)
