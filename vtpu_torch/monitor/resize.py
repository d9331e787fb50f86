"""Crash-safe live-resize apply loop: annotation intents → shared regions.

The port's copy of vtpu/monitor/resize.py.

The scheduler-side rebalancer (vtpu/scheduler/rebalancer.py) writes its
resize decision durably as the pod annotation ``vtpu.io/hbm-limit``
("<gen>:<mb0>,<mb1>,...", fenced through the committer). This module is
the node half of the two-phase protocol (docs/elastic-quotas.md):

  1. **durable intent** — on first sight of a new generation the
     applier writes an atomicio intent record
     (``<entry>/vgpu.resize.json``) BEFORE touching the region, so a
     monitor SIGKILLed at any later instruction replays the apply on
     restart (applying an absolute limit is idempotent — replay is
     exactly-once in effect);
  2. **checked apply** — each device's limit goes through
     :meth:`RegionView.set_limit_checked` (the C
     ``vtpu_region_set_limit_checked``): a shrink below live usage is
     clamped AT THE REGION LAYER with the usage lock held, and the v7
     usage-epoch bump makes the new limit authoritative within one
     launch-gate epoch.

Uncooperative shrinks degrade gracefully, never breach: while the
workload holds more than the target the apply clamps to usage and
retries each sweep; past ``VTPU_RESIZE_GRACE_S`` the tenant is
feedback-blocked via ``utilization_switch`` (the throttle is held
engaged — :class:`~vtpu_torch.monitor.feedback.FeedbackLoop` consults
:meth:`resize_blocked`) until the shrink finally lands, at which point
the block lifts. Quarantined regions are never resized. Counters are
at-least-once across a crash (the REGION effect is exactly-once; the
intent record, not the metric, is the authority — docs/elastic-quotas.md
"deliberate limits").
"""

from __future__ import annotations

import logging
import os
import time
from typing import Callable, Dict, Optional, Set, Tuple

from prometheus_client import Counter

from .. import api
from ..enforce.region import RESIZE_APPLIED, RegionView
from ..trace import trace_id_for_uid
from ..trace import tracer as _tracer
from ..util import codec
from ..util.atomicio import atomic_write_json, read_json
from ..util.env import env_float
from ..util.podutil import container_index_of_cache_entry
from ..util.types import HBM_LIMIT_ANNO
from .pathmonitor import ContainerRegions, pod_uid_of_entry

log = logging.getLogger("vtpu_torch.monitor")

#: durable per-entry resize intent record, next to the cache file (like
#: the quarantine marker); removed with the dir by GC
RESIZE_RECORD = api.RESIZE_RECORD

#: grace window for an uncooperative shrink before feedback blocking
#: engages (docs/elastic-quotas.md, config.md)
RESIZE_GRACE_S_DEFAULT = 30.0

MB = 1024 * 1024

RESIZES_APPLIED = Counter(
    "vGPUResizeApplied",
    "resize intents whose every device limit was applied exactly "
    "(generation transitions; at-least-once across a monitor crash)",
)
RESIZES_REFUSED = Counter(
    "vGPUResizeRefused",
    "resize intents refused outright (undecodable annotation or a "
    "device-count mismatch); refused generations are never retried",
)
RESIZES_CLAMPED = Counter(
    "vGPUResizeClamped",
    "shrink intents clamped to live usage at the region layer "
    "(counted once per generation, at the first clamped apply)",
)
RESIZES_BLOCKED = Counter(
    "vGPUResizeBlocked",
    "uncooperative shrinks that exhausted VTPU_RESIZE_GRACE_S and "
    "engaged feedback blocking via utilization_switch",
)


class ResizeApplier:
    """Applies annotation resize intents to this node's shared regions.

    Driven once per monitor sweep (daemon.sweep_once). ``annos_of`` maps
    a pod uid to its annotations (the watch-backed PodCache in
    production); with no pod source wired the applier is inert.
    """

    def __init__(self, regions: ContainerRegions,
                 annos_of: Optional[Callable[[str],
                                             Optional[Dict[str, str]]]]
                 = None,
                 grace_s: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.regions = regions
        self.annos_of = annos_of
        self.grace_s = (grace_s if grace_s is not None
                        else env_float(api.ENV_RESIZE_GRACE_S,
                                       RESIZE_GRACE_S_DEFAULT,
                                       minimum=0.0))
        self.clock = clock
        #: entry name -> intent record (mirrors the durable file; the
        #: file is the authority across restarts)
        self._records: Dict[str, Dict] = {}
        #: entries whose disk record has been consulted at least once
        self._probed: Set[str] = set()
        #: (entry, gen, event) metric transitions already counted this
        #: incarnation — keeps counters once-per-generation in steady
        #: state (at-least-once across a crash, by design)
        self._counted: Set[Tuple[str, int, str]] = set()
        #: entries currently under shrink feedback blocking
        self._blocked: Set[str] = set()
        # chaos kill points (tests/test_resize_chaos.py): raise a
        # BaseException — the SIGKILL stand-in the node-chaos harness
        # uses — at the named protocol boundary
        self.kill_after_intent: Optional[Callable[[], None]] = None
        self.kill_after_apply: Optional[Callable[[], None]] = None

    # -- read side (feedback loop, /nodeinfo, collector) -------------------

    def resize_blocked(self, name: str) -> bool:
        """True while `name` is feedback-blocked for an uncooperative
        shrink — the FeedbackLoop holds utilization_switch engaged."""
        return name in self._blocked

    def gen_of(self, name: str) -> int:
        """Generation of the last intent whose apply reached the region
        (exactly or clamped); 0 before any resize. /nodeinfo surfaces
        it so the scheduler can confirm its intent landed. A refused
        later intent carries the last applied generation forward
        (prev_applied_gen) — the confirmation never regresses."""
        rec = self._records.get(name)
        if rec is None:
            return 0
        if "applied_mb" in rec:
            return int(rec.get("gen", 0))
        return int(rec.get("prev_applied_gen", 0))

    def state_of(self, name: str) -> str:
        """'' | 'applied' | 'clamped' | 'blocked' | 'refused'."""
        rec = self._records.get(name)
        if rec is None:
            return ""
        if rec.get("state") == "refused":
            return "refused"
        if name in self._blocked:
            return "blocked"
        if rec.get("state") == "applied":
            return "applied"
        if "applied_mb" in rec:
            return "clamped"
        return "pending"

    # -- durable record helpers --------------------------------------------

    def _record_path(self, name: str) -> str:
        return os.path.join(self.regions.dir, name, RESIZE_RECORD)

    def _load_record(self, name: str) -> Optional[Dict]:
        """In-memory record, falling back to the durable file exactly
        once per entry — the crash-replay read."""
        rec = self._records.get(name)
        if rec is not None or name in self._probed:
            return rec
        self._probed.add(name)
        loaded = read_json(self._record_path(name))
        if isinstance(loaded, dict) and "gen" in loaded:
            self._records[name] = loaded
            if loaded.get("blocked"):
                # the block outlives the crash: a restarted monitor
                # must not silently release an uncooperative tenant
                self._blocked.add(name)
            if loaded.get("state") == "pending":
                log.warning(
                    "replaying resize intent gen %s for %s (monitor "
                    "restarted mid-resize)", loaded.get("gen"), name)
            return loaded
        return None

    def _store_record(self, name: str, rec: Dict) -> None:
        self._records[name] = rec
        try:
            atomic_write_json(self._record_path(name), rec)
        except OSError as e:
            # in-memory state still drives this incarnation; only
            # crash-replay protection is narrowed
            log.warning("cannot persist resize record for %s: %s",
                        name, e)

    def _count_once(self, name: str, gen: int, event: str, metric) -> None:
        key = (name, gen, event)
        if key not in self._counted:
            self._counted.add(key)
            metric.inc()

    # -- the sweep ---------------------------------------------------------

    def sweep(self, views: Dict[str, RegionView]) -> int:
        """One apply pass over the live views; returns the number of
        entries whose intent advanced (applied or clamped)."""
        if self.annos_of is None:
            return 0
        advanced = 0
        for name, view in views.items():
            # quarantine interplay: a quarantined region is NEVER
            # resized (its header is untrusted; scan() also drops its
            # view, so this is defense in depth)
            if name in self.regions.quarantined:
                continue
            try:
                if self._sweep_one(name, view):
                    advanced += 1
            except (ValueError, OSError) as e:
                # region racing teardown / transient header state: skip
                # this sweep, exactly like the scan does
                log.debug("resize skip %s: %s", name, e)
        # entries whose dir vanished (pod GC'd) must not pin state
        # forever — the durable record went with the dir, so the
        # in-memory mirrors go too (a long-lived monitor on a churning
        # node would otherwise grow them without bound)
        for name in list(self._blocked):
            if name not in views:
                self._blocked.discard(name)
        for name in list(self._records):
            if name not in views:
                self._records.pop(name, None)
                self._probed.discard(name)
        self._counted = {k for k in self._counted if k[0] in views}
        return advanced

    def _sweep_one(self, name: str, view: RegionView) -> bool:
        """One entry's protocol step; returns True only when the region
        or record state actually CHANGED (the daemon re-snapshots on a
        True — a persistently-clamped shrink must not double the sweep's
        region-scan cost forever)."""
        uid = pod_uid_of_entry(name)
        annos = self.annos_of(uid)
        if not annos:
            return False
        intent = annos.get(HBM_LIMIT_ANNO)
        if not intent:
            return False
        rec = self._load_record(name)
        try:
            gen, per_container = codec.decode_hbm_limit(intent)
        except codec.CodecError as e:
            log.error("pod %s: undecodable resize intent: %s", uid, e)
            return self._refuse(name, rec, intent, str(e))
        if rec is not None and int(rec.get("gen", 0)) > gen:
            # defense in depth behind the committer's fencing: a stale
            # (deposed-leader) annotation can never rewind a newer
            # applied generation
            return False
        if rec is not None and int(rec.get("gen", 0)) == gen:
            if rec.get("state") in ("applied", "refused"):
                return False  # settled
        else:
            # phase 1 — durable intent BEFORE the region is touched:
            # a SIGKILL at any later boundary replays this record. The
            # last APPLIED generation rides along so the /nodeinfo
            # confirmation (gen_of) never regresses while a new intent
            # is mid-flight or ends up refused.
            prev = rec
            rec = {"gen": gen, "target_mb": list(per_container),
                   "state": "pending"}
            if prev is not None:
                if "applied_mb" in prev:
                    rec["prev_applied_gen"] = int(prev.get("gen", 0))
                elif prev.get("prev_applied_gen"):
                    rec["prev_applied_gen"] = int(
                        prev["prev_applied_gen"])
            self._store_record(name, rec)
        if self.kill_after_intent is not None:
            self.kill_after_intent()
        # each container has its OWN region: pick THIS entry's segment
        # by container index — a pod-wide flat offset would hand
        # container 1 container 0's quota
        ctr = container_index_of_cache_entry(name)
        limits_mb = (per_container[ctr]
                     if 0 <= ctr < len(per_container) else [])
        if len(limits_mb) < view.num_devices:
            log.error("pod %s: resize intent segment %d names %d "
                      "device(s), region has %d; refusing generation "
                      "%d", uid, ctr, len(limits_mb), view.num_devices,
                      gen)
            return self._refuse(name, rec, intent,
                                "device-count mismatch")
        # phase 2 — checked apply, device by device. `changed` tracks
        # whether any STORED limit actually moved: clamped retries that
        # re-store the same clamp are steady state, not progress
        prev_applied = list((self._records.get(name) or {})
                            .get("applied_mb", []))
        applied_mb = []
        clamped = False
        with _tracer.span(trace_id_for_uid(uid), "resize.apply",
                          entry=name, gen=gen,
                          target_mb=",".join(str(m) for m in
                                             limits_mb)) as sp:
            for dev in range(view.num_devices):
                rc, applied = view.set_limit_checked(
                    limits_mb[dev] * MB, dev)
                applied_mb.append((applied + MB - 1) // MB)
                if rc != RESIZE_APPLIED:
                    clamped = True
            sp.set("applied_mb", ",".join(str(m) for m in applied_mb))
            sp.set("clamped", clamped)
        changed = applied_mb != prev_applied
        if self.kill_after_apply is not None:
            self.kill_after_apply()
        now = self.clock()
        if not clamped:
            rec = {"gen": gen, "target_mb": list(limits_mb),
                   "applied_mb": applied_mb, "state": "applied"}
            self._store_record(name, rec)
            self._count_once(name, gen, "applied", RESIZES_APPLIED)
            if name in self._blocked:
                self._blocked.discard(name)
                log.info("%s: shrink landed at generation %d; feedback "
                         "block lifted", name, gen)
            return True
        # clamped shrink: grace window, then feedback blocking — the
        # limit stored is the live usage, so there is NO breach either
        # way; what escalates is only the pressure on the tenant
        first_short = rec.get("first_short")
        if first_short is None:
            first_short = now
        rec = {"gen": gen, "target_mb": list(limits_mb),
               "applied_mb": applied_mb, "state": "pending",
               "first_short": first_short,
               "blocked": name in self._blocked}
        self._count_once(name, gen, "clamped", RESIZES_CLAMPED)
        if now - first_short > self.grace_s and name not in self._blocked:
            self._blocked.add(name)
            rec["blocked"] = True
            changed = True
            self._count_once(name, gen, "blocked", RESIZES_BLOCKED)
            log.warning(
                "%s: shrink to %s MB still clamped after %.0fs grace; "
                "engaging feedback blocking (utilization_switch)",
                name, limits_mb, self.grace_s)
        self._store_record(name, rec)
        return changed

    def _refuse(self, name: str, rec: Optional[Dict], intent: str,
                why: str) -> bool:
        gen = 0
        try:
            gen = int(intent.split(":", 1)[0])
        except ValueError:
            pass
        if rec is not None:
            rgen = int(rec.get("gen", 0))
            if rgen > gen:
                return False  # garbled STALE intent: progress stands
            if rgen == gen and "applied_mb" in rec:
                # a garbled copy of an already-progressed generation
                # must not rewind it: gen_of would regress and a later
                # corrected same-gen intent would be stuck refused.
                # (A same-gen record WITHOUT applied progress is this
                # very intent's phase-1 record — refusing that one is
                # the point.)
                return False
            if rec.get("state") == "refused" and rgen >= gen:
                return False  # already refused this (or newer) intent
        refused = {"gen": gen, "state": "refused", "why": why}
        # carry the last applied generation through a refusal so the
        # /nodeinfo resize_gen confirmation never regresses
        if rec is not None:
            if "applied_mb" in rec:
                refused["prev_applied_gen"] = int(rec.get("gen", 0))
            elif rec.get("prev_applied_gen"):
                refused["prev_applied_gen"] = int(
                    rec["prev_applied_gen"])
        self._store_record(name, refused)
        self._count_once(name, gen, "refused", RESIZES_REFUSED)
        return True
