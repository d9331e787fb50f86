"""Container shared-region discovery and garbage collection.

The port's copy of vtpu/monitor/pathmonitor.py. Scans the host-side
containers dir the device plugin populates at Allocate
(``<shim_host_dir>/containers/<podUID>_<n>/vgpu.cache``, the region
libvgpu.so writes), keeps RegionView
mmaps for live entries, and deletes directories whose pod no longer exists
after a grace period (reference pathmonitor.go:74-120: monitorpath() mmaps
new caches; 89-98: dirs of dead pods removed after 300s).
"""

from __future__ import annotations

import logging
import os
import shutil
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, Optional, Set, Tuple

from ..enforce.region import RegionCorruptError, RegionSnapshot, RegionView
from ..trace import trace_id_for_uid
from ..trace import tracer as _tracer
from .. import api
from ..util import lockdebug, podutil
from ..util.atomicio import atomic_write_json, read_json
from ..util.env import env_int

log = logging.getLogger("vtpu_torch.monitor")

CACHE_FILENAME = api.CACHE_FILENAME
DEAD_POD_GRACE_S = 300.0

#: consecutive corrupt sweeps before a region file is quarantined. One
#: mismatch can be a legitimate race (a snapshot interleaving the shim's
#: configure between a limit write and the checksum restamp); the same
#: definitive corruption N sweeps running cannot.
QUARANTINE_AFTER = env_int(api.ENV_QUARANTINE_AFTER, 3, minimum=1)
#: durable per-entry quarantine marker, written next to the cache file
#: so a restarted monitor re-quarantines instantly instead of flapping
#: through another N corrupt parses
QUARANTINE_MARKER = api.QUARANTINE_MARKER


def pod_uid_of_entry(name: str) -> str:
    """``<podUID>_<n>`` → podUID; delegates to the canonical parser
    (vtpu_torch/util/podutil.pod_uid_of_cache_entry) so the plugin's
    cache_name convention has exactly one reader implementation."""
    return podutil.pod_uid_of_cache_entry(name)


@dataclass(frozen=True)
class RegionSetSnapshot:
    """One sweep's immutable view of every readable region.

    Produced under the region-table lock once per sweep; consumed
    lock-free by the Prometheus collector, /nodeinfo, and the feedback
    loop's read side. `taken_monotonic` is `time.monotonic()` at capture
    (the snapshot-age gauge diffs against it)."""

    snapshots: Dict[str, RegionSnapshot] = field(default_factory=dict)
    taken_monotonic: float = 0.0
    sweep_seq: int = 0


class ContainerRegions:
    """Live map of container-cache dirs → RegionView."""

    def __init__(self, containers_dir: str,
                 grace_s: float = DEAD_POD_GRACE_S,
                 clock: Callable[[], float] = time.monotonic,
                 quarantine_after: int = QUARANTINE_AFTER):
        self.dir = containers_dir
        self.grace_s = grace_s
        self.clock = clock
        self.quarantine_after = quarantine_after
        self.views: Dict[str, RegionView] = {}
        self._first_missing: Dict[str, float] = {}
        self._sweep_seq = 0
        # quarantine plane (docs/node-resilience.md): entries whose
        # cache file is DEFINITIVELY corrupt (RegionCorruptError — wrong
        # magic/version, truncation, checksum mismatch) for
        # quarantine_after consecutive sweeps are skipped without even a
        # parse attempt until the file's stat changes, so one
        # permanently-mangled file costs one os.stat per sweep, not a
        # parse + a log line every 5s forever
        self.quarantined: Dict[str, Dict] = {}
        self._corrupt_streak: Dict[str, int] = {}
        #: total definitive-corruption parse failures observed (monotonic)
        self.corrupt_events = 0
        #: total quarantine transitions (monotonic; > len(quarantined)
        #: when files were rewritten and re-probed)
        self.quarantines_total = 0
        # serializes scan/gc/close across the sweep loop and the Prometheus
        # scrape thread, which both walk and mutate the view table
        self.lock = lockdebug.rlock("monitor.regions")

    def _dir_entries(self) -> list:
        """Sorted directory names under the containers dir, via one
        scandir (dirent type info — no per-entry stat; at hundreds of
        regions the per-name isdir/isfile stats were the sweep's single
        biggest cost)."""
        try:
            with os.scandir(self.dir) as it:
                return sorted(e.name for e in it if e.is_dir())
        except OSError:
            return []

    # -- quarantine plane (all callers hold self.lock) ---------------------

    @staticmethod
    def _cache_stat(cache: str) -> Optional[Dict[str, int]]:
        try:
            st = os.stat(cache)
            return {"size": int(st.st_size), "mtime_ns": int(st.st_mtime_ns)}
        except OSError:
            return None

    def _note_corrupt(self, name: str, cache: str, reason: str) -> None:
        """One definitive-corruption observation; quarantines the entry
        after quarantine_after consecutive sweeps. Never raises — a
        corrupt file must cost the sweep nothing but this bookkeeping."""
        self.corrupt_events += 1
        streak = self._corrupt_streak.get(name, 0) + 1
        self._corrupt_streak[name] = streak
        if streak < self.quarantine_after:
            log.debug("corrupt region %s (%d/%d before quarantine): %s",
                      cache, streak, self.quarantine_after, reason)
            return
        info = {"reason": reason, "stat": self._cache_stat(cache),
                "streak": streak}
        self.quarantined[name] = info
        self.quarantines_total += 1
        self._corrupt_streak.pop(name, None)
        view = self.views.pop(name, None)
        if view is not None:
            view.close()
        # log ONCE, at the transition: the whole point of quarantine is
        # that the file produces no further per-sweep noise
        log.warning("quarantined region %s after %d consecutive corrupt "
                    "sweeps: %s", cache, streak, reason)
        try:
            atomic_write_json(os.path.join(self.dir, name,
                                           QUARANTINE_MARKER), info)
        except OSError as e:
            # in-memory quarantine still holds; only restart flap
            # protection is lost
            log.warning("cannot persist quarantine marker for %s: %s",
                        name, e)

    def _quarantine_skip(self, name: str, cache: str) -> bool:
        """True when `name` stays quarantined this sweep. A quarantined
        entry is re-probed only when the cache file's stat changes (a
        restarted shim re-initializing the region is a fresh file and
        deserves a fresh verdict)."""
        info = self.quarantined.get(name)
        if info is None:
            marker = os.path.join(self.dir, name, QUARANTINE_MARKER)
            if not os.path.isfile(marker):
                return False
            loaded = read_json(marker)
            if not isinstance(loaded, dict):
                return False
            info = self.quarantined.setdefault(name, loaded)
            log.warning("region %s quarantined by a previous monitor "
                        "incarnation (%s); honoring the marker", name,
                        info.get("reason", "unknown"))
        if self._cache_stat(cache) == info.get("stat"):
            return True
        self._unquarantine(name)
        return False

    def _unquarantine(self, name: str) -> None:
        info = self.quarantined.pop(name, None)
        self._corrupt_streak.pop(name, None)
        if info is not None:
            log.info("region %s left quarantine (cache file changed); "
                     "re-probing", name)
        try:
            os.unlink(os.path.join(self.dir, name, QUARANTINE_MARKER))
        except OSError:
            pass

    def scan(self) -> Dict[str, RegionView]:
        """Pick up new cache files, drop views whose files vanished.
        Returns a snapshot dict (the live table is only touched under the
        lock)."""
        with self.lock:
            seen: Set[str] = set()
            entries = self._dir_entries()
            for name in entries:
                cache = os.path.join(self.dir, name, CACHE_FILENAME)
                if not os.path.isfile(cache):
                    continue
                if self._quarantine_skip(name, cache):
                    continue
                seen.add(name)
                if name in self.views:
                    continue
                try:
                    t0 = time.perf_counter()
                    self.views[name] = RegionView(cache)
                    self._corrupt_streak.pop(name, None)
                    # span recorded only on SUCCESS (backdated over the
                    # construction): an uninitialized or foreign cache
                    # file is re-tried every sweep by design, and a
                    # recurring error span per sweep would be permanent
                    # false telemetry for a non-event. Joins the pod's
                    # trace (trace id is a pure function of the uid) —
                    # first observation means enforcement is live.
                    with _tracer.span(
                            trace_id_for_uid(pod_uid_of_entry(name)),
                            "region.observe", started_at=t0, entry=name):
                        pass
                    log.info("monitoring %s", cache)
                except RegionCorruptError as e:
                    seen.discard(name)
                    self._note_corrupt(name, cache, str(e))
                except (OSError, ValueError) as e:
                    # not yet initialized by the interposer, or a transient
                    # race: skip this sweep (reference skips bad cache
                    # files, pathmonitor.go:100-111); a transient state
                    # also breaks any corruption streak
                    self._corrupt_streak.pop(name, None)
                    log.debug("skip %s: %s", cache, e)
            for name in list(self.views):
                if name not in seen:
                    self.views.pop(name).close()
                    log.info("dropped vanished region %s", name)
            # quarantine bookkeeping follows the directory: a GC'd (or
            # operator-removed) entry must not pin state forever
            present = set(entries)
            for name in list(self.quarantined):
                if name not in present:
                    self.quarantined.pop(name, None)
            for name in list(self._corrupt_streak):
                if name not in present:
                    self._corrupt_streak.pop(name, None)
            return dict(self.views)

    def scan_snapshots(self) -> Tuple[RegionSetSnapshot,
                                      Dict[str, RegionView]]:
        """Scan, then bulk-copy every live region ONCE into an immutable
        snapshot set. A region racing container teardown (file replaced,
        header torn, view closed) is skipped this sweep, exactly like
        scan() skips unreadable cache files. Returns the snapshot set
        plus the live view dict (the feedback loop still needs views for
        its writes)."""
        with self.lock:
            views = self.scan()
            snaps: Dict[str, RegionSnapshot] = {}
            for name, v in list(views.items()):
                try:
                    snaps[name] = v.snapshot()
                except RegionCorruptError as e:
                    # a region that WAS healthy can corrupt under a live
                    # view (bit-flip, hostile writer): same quarantine
                    # discipline as a corrupt open, and this sweep emits
                    # NO numbers for it — partial values must never
                    # reach Prometheus
                    self._note_corrupt(name, v.path, str(e))
                    views.pop(name, None)
                except (ValueError, OSError, TypeError, AttributeError) as e:
                    log.debug("skip snapshot of %s: %s", name, e)
            self._sweep_seq += 1
            return (RegionSetSnapshot(snapshots=snaps,
                                      taken_monotonic=time.monotonic(),
                                      sweep_seq=self._sweep_seq),
                    views)

    def gc(self, live_pod_uids: Iterable[str]) -> int:
        """Remove container dirs whose pod is gone for > grace_s."""
        live = set(live_pod_uids)
        removed = 0
        if not os.path.isdir(self.dir):
            return 0
        with self.lock:
            now = self.clock()
            for name in self._dir_entries():
                path = os.path.join(self.dir, name)
                uid = pod_uid_of_entry(name)
                if uid in live:
                    self._first_missing.pop(name, None)
                    continue
                first = self._first_missing.setdefault(name, now)
                if now - first < self.grace_s:
                    continue
                if name in self.views:
                    self.views.pop(name).close()
                try:
                    shutil.rmtree(path)
                    removed += 1
                    log.info("GC'd container dir %s (pod %s gone)",
                             name, uid)
                    self._first_missing.pop(name, None)
                except OSError as e:
                    # keep the first-missing timestamp: retry next sweep,
                    # not after another full grace period
                    log.warning("GC of %s failed (will retry): %s",
                                path, e)
        return removed

    def close(self) -> None:
        with self.lock:
            for v in self.views.values():
                v.close()
            self.views.clear()
