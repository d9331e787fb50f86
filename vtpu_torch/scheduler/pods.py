"""In-memory cache of scheduled pods and their device assignments.

The port's copy of vtpu/scheduler/pods.py.

Reference: pkg/scheduler/pods.go — `podManager` (pods.go:39-74). Entries are
reconstructed purely from pod annotations (the reference's recovery-by-
reconstruction design, SURVEY.md §5.4), so a scheduler restart loses nothing.

When constructed with a `UsageOverlay`, every mutation (add/del/replace)
also applies its per-chip usage delta to the overlay, keeping the
scheduler's usage view incremental — `filter()` never rescans the pod
cache (overlay.py module docstring has the invariant).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..util import lockdebug
from ..util.types import PodDevices
from .overlay import UsageOverlay


@dataclass
class PodInfo:
    namespace: str
    name: str
    uid: str
    node_id: str
    devices: PodDevices = field(default_factory=list)
    # host-memory reservation in MB (vtpu.io/host-memory): a NODE-level
    # axis, one number per pod; 0 = legacy-unlimited migration default
    host_mb: int = 0
    # task priority (vtpu.io/task-priority; 0 = guaranteed/high): the
    # preemption engine's victim eligibility — a cached pod with a
    # NUMERICALLY larger priority than an unfittable arrival is a
    # candidate victim; priority-0 pods never are (docs/multihost.md)
    priority: int = 1
    # slice gang id (tpu.google.com/slice-group), so evicting a gang
    # member releases its slice slot in the same decide-locked step
    group: str = ""
    # vtpu.io/migration-candidate mark (defrag proposals): the
    # preemption engine prefers marked victims — evicting one both
    # makes room AND defragments. uid-keyed with the entry, so a
    # recycled pod name can never inherit a dead pod's mark.
    migration_candidate: bool = False


class PodManager:
    def __init__(self, overlay: Optional[UsageOverlay] = None) -> None:
        self._lock = lockdebug.rlock("scheduler.pods")
        self._pods: Dict[str, PodInfo] = {}  # key: uid (fallback ns/name)
        self._overlay = overlay

    @property
    def lock(self) -> threading.RLock:
        """Outer lock for callers that must see the pod cache and the
        overlay as one consistent unit (overlay audit/verify): holding
        it blocks every mutation path, since all of them write the
        overlay while holding this lock."""
        return self._lock

    @staticmethod
    def _key(namespace: str, name: str, uid: str) -> str:
        return uid or f"{namespace}/{name}"

    def add_pod(self, namespace: str, name: str, uid: str, node_id: str,
                devices: PodDevices, host_mb: int = 0,
                priority: int = 1, group: str = "",
                migration_candidate: bool = False) -> None:
        with self._lock:
            key = self._key(namespace, name, uid)
            old = self._pods.get(key)
            self._pods[key] = PodInfo(
                namespace=namespace, name=name, uid=uid, node_id=node_id,
                devices=devices, host_mb=host_mb, priority=priority,
                group=group, migration_candidate=migration_candidate,
            )
            if self._overlay is not None:
                # re-add (watch MODIFIED / resync overlap): retract the
                # previous assignment and account the new one in one
                # atomic overlay step — a reader between the two would
                # see the pod's chips as free
                self._overlay.apply_delta(
                    [(old.node_id, old.devices, old.host_mb)]
                    if old is not None else [],
                    [(node_id, devices, host_mb)])

    def del_pod(self, namespace: str, name: str, uid: str) -> None:
        with self._lock:
            old = self._pods.pop(self._key(namespace, name, uid), None)
            if old is not None and self._overlay is not None:
                self._overlay.remove_usage(old.node_id, old.devices,
                                           old.host_mb)

    def get(self, namespace: str, name: str, uid: str) -> Optional[PodInfo]:
        with self._lock:
            return self._pods.get(self._key(namespace, name, uid))

    def find(self, namespace: str, name: str) -> Optional[PodInfo]:
        """Lookup by pod identity when the caller has no uid (the extender
        Bind verb carries only namespace/name). O(pods); used on failure
        paths only, never per-filter."""
        with self._lock:
            for p in self._pods.values():
                if p.namespace == namespace and p.name == name:
                    return p
            return None

    def list_pods(self) -> List[PodInfo]:
        with self._lock:
            return list(self._pods.values())

    def pods_on_node(self, node_id: str) -> List[PodInfo]:
        with self._lock:
            return [p for p in self._pods.values() if p.node_id == node_id]

    def clear(self) -> None:
        with self._lock:
            self._pods.clear()
            if self._overlay is not None:
                self._overlay.reset_usage()

    def replace_all(self, pods: List[PodInfo]) -> None:
        """Atomic swap — readers never observe a half-rebuilt cache.
        Overlay deltas are computed from the old-vs-new diff, so a
        resync of N pods with k changes costs k aggregate updates, not
        a full overlay rebuild."""
        fresh = {self._key(p.namespace, p.name, p.uid): p for p in pods}
        with self._lock:
            if self._overlay is not None:
                removals = []
                additions = []
                for key, old in self._pods.items():
                    new = fresh.get(key)
                    if (new is None or new.node_id != old.node_id
                            or new.devices != old.devices
                            or new.host_mb != old.host_mb):
                        removals.append((old.node_id, old.devices,
                                         old.host_mb))
                for key, new in fresh.items():
                    old = self._pods.get(key)
                    if (old is None or old.node_id != new.node_id
                            or old.devices != new.devices
                            or old.host_mb != new.host_mb):
                        additions.append((new.node_id, new.devices,
                                          new.host_mb))
                self._overlay.apply_delta(removals, additions)
            self._pods = fresh
