"""Watch-backed pod cache: an informer for components that only read pods.

The port's copy of vtpu/util/podcache.py, on the port's
``KubeClient.watch_pods``.

The node-side daemons (monitor sweep/GC, Prometheus collector, /nodeinfo,
the device plugin's pending-pod lookup) used to issue a pod LIST per
iteration — O(cluster) apiserver load per node per 5s sweep and again per
15s scrape. This cache plays the informer role instead (the same
ListAndWatch contract the scheduler's pod_watch_loop uses,
the JAX package's vtpu/scheduler/core.py): one priming LIST for a resourceVersion, then a
watch stream keeps a uid → trimmed-pod table current; history expiry
(410 / GoneError) or stream failure falls back to a relist with backoff.
Steady state performs ZERO list calls. Constructed with a node_name,
both the list and the watch are scoped server-side
(``fieldSelector=spec.nodeName=...``), so per-node consumers hold an
O(node) table and wake only on their own node's events.

Entries are pod-shaped dicts trimmed to what consumers read (metadata
uid/namespace/name/annotations, spec.nodeName, status.phase) so helpers
written against real pod objects (`vtpu_torch/util/podutil.py`) work on cache
hits unchanged. Returned objects are shared, not copied — treat them as
read-only.
"""

from __future__ import annotations

import copy
import logging
import threading
import time
from typing import Any, Dict, List, Optional

from . import lockdebug
from .client import GoneError, KubeClient, node_field_selector

log = logging.getLogger(__name__)

Obj = Dict[str, Any]

#: one watch pass's server-side quiet timeout; the cache's age is bounded
#: by this plus delivery latency while the stream is healthy
WATCH_TIMEOUT_S = 60.0
#: pause before relisting after a failed/expired watch (a persistently
#: broken apiserver must not drive an O(cluster) relist busy-loop —
#: the scheduler's pod_watch_loop applies the same backoff)
RELIST_BACKOFF_S = 5.0
#: default "fresh enough to act on" horizon: 2.5x the watch timeout, so a
#: single slow-but-healthy quiet watch pass never counts as staleness
FRESH_S = 150.0


def _trim(pod: Obj) -> Obj:
    """Keep only the fields cache consumers read (still pod-shaped)."""
    meta = pod.get("metadata", {}) or {}
    return {
        "metadata": {
            "uid": meta.get("uid", ""),
            "namespace": meta.get("namespace", "default"),
            "name": meta.get("name", ""),
            "annotations": dict(meta.get("annotations", {}) or {}),
        },
        "spec": {
            "nodeName": (pod.get("spec", {}) or {}).get("nodeName", ""),
        },
        "status": {
            "phase": (pod.get("status", {}) or {}).get("phase", ""),
        },
    }


class PodCache:
    """uid → pod table fed by list-once-then-watch.

    Thread model: `start()` runs the watch loop on a daemon thread;
    readers take the internal lock only long enough to copy out what
    they need. Tests (and embedders without a thread) drive the same
    loop body via `sync_once()` / `poll_once()`.
    """

    def __init__(self, client: KubeClient, node_name: str = "",
                 watch_timeout_s: float = WATCH_TIMEOUT_S,
                 relist_backoff_s: float = RELIST_BACKOFF_S,
                 fresh_s: float = FRESH_S,
                 clock=time.monotonic):
        self.client = client
        self.node_name = node_name
        # with a node name the list AND the watch are scoped server-side:
        # every node keeping an O(cluster) pod table (and waking on every
        # cluster-wide pod event) would defeat the point of this cache
        self.field_selector = (node_field_selector(node_name)
                               if node_name else "")
        self.watch_timeout_s = watch_timeout_s
        self.relist_backoff_s = relist_backoff_s
        self.fresh_s = fresh_s
        self.clock = clock
        self._lock = lockdebug.rlock("podcache.table")
        self._pods: Dict[str, Obj] = {}
        self._rv = "0"
        self._epoch = 0  # bumped by every relist (guards rv write-back)
        self._synced = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # observability (exported by the monitor collector)
        self.relists = 0      # LISTs issued (priming + GoneError recovery)
        self.events = 0       # watch events applied
        self._last_ok = 0.0   # clock() of the last successful list OR
        #                       completed watch pass (quiet passes count:
        #                       the server answered, the cache is current)

    # -- feed --------------------------------------------------------------

    def sync_once(self) -> str:
        """Prime/recover: one (node-scoped) LIST replacing the table."""
        pods, rv = self.client.list_pods_with_version(
            field_selector=self.field_selector)
        table = {}
        for pod in pods:
            uid = (pod.get("metadata", {}) or {}).get("uid", "")
            if uid:
                table[uid] = _trim(pod)
        with self._lock:
            self._pods = table
            self._rv = rv
            self._epoch += 1
            self.relists += 1
            self._last_ok = self.clock()
        self._synced.set()
        return rv

    def _apply(self, etype: str, pod: Obj, epoch: int) -> None:
        uid = (pod.get("metadata", {}) or {}).get("uid", "")
        if not uid:
            return
        with self._lock:
            if epoch != self._epoch:
                # a relist replaced the table after this watch pass
                # began: its events predate the new table — dropping
                # them is safe (the relist already reflects them)
                return
            if etype == "DELETED":
                self._pods.pop(uid, None)
            elif etype in ("ADDED", "MODIFIED"):
                self._pods[uid] = _trim(pod)
            self.events += 1

    def _watch_pass(self) -> None:
        """One watch stream from the current rv; GoneError propagates.
        The rv write-back is epoch-guarded: a concurrent relist
        (ensure_fresh from another thread) installs a newer rv that a
        finishing stale pass must not rewind."""
        with self._lock:
            rv = self._rv
            epoch = self._epoch
        for etype, pod in self.client.watch_pods(
                rv, timeout_s=self.watch_timeout_s,
                field_selector=self.field_selector):
            meta_rv = (pod.get("metadata", {}) or {}).get("resourceVersion")
            if meta_rv:
                rv = meta_rv
            if etype != "BOOKMARK":
                self._apply(etype, pod, epoch)
            if self._stop.is_set():
                break
        with self._lock:
            if epoch == self._epoch:
                self._rv = rv
                self._last_ok = self.clock()

    def poll_once(self) -> None:
        """One loop iteration: (re)list if never synced, else one watch
        pass; expiry/failure backs off then relists. Factored out so
        tests drive the exact production path without a thread. Never
        raises: a recovery relist failing too (apiserver still down)
        only logs — run() keeps retrying, because a dead cache thread
        would freeze pod labels/liveness forever while still reporting
        synced."""
        try:
            if not self._synced.is_set():
                self.sync_once()
            self._watch_pass()
        except GoneError:
            log.info("pod watch history expired; relisting in %gs",
                     self.relist_backoff_s)
            self._recover()
        except Exception:
            if self._stop.is_set():
                return
            log.exception("pod watch failed; relisting in %gs",
                          self.relist_backoff_s)
            self._recover()

    def _recover(self) -> None:
        self._stop.wait(self.relist_backoff_s)
        if self._stop.is_set():
            return
        try:
            self.sync_once()
        except Exception as e:
            log.warning("pod cache relist failed (will retry): %s", e)

    def run(self) -> None:
        while not self._stop.is_set():
            self.poll_once()

    def start(self) -> "PodCache":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self.run, name="vgpu-podcache", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()

    # -- reads -------------------------------------------------------------

    @property
    def synced(self) -> bool:
        return self._synced.is_set()

    def wait_synced(self, timeout_s: float) -> bool:
        return self._synced.wait(timeout_s)

    def age_s(self) -> float:
        """Seconds since the last successful list or watch pass."""
        with self._lock:
            if not self._synced.is_set():
                return float("inf")
            return max(0.0, self.clock() - self._last_ok)

    def fresh(self, max_age_s: Optional[float] = None) -> bool:
        return self.age_s() <= (self.fresh_s if max_age_s is None
                                else max_age_s)

    def ensure_fresh(self, max_age_s: Optional[float] = None) -> None:
        """Relist if the cache is unsynced or older than the horizon —
        the safety valve for embedders whose watch thread isn't running
        (it degrades to the old LIST-per-call behavior, never worse)."""
        if not self.fresh(max_age_s):
            self.sync_once()

    def __len__(self) -> int:
        with self._lock:
            return len(self._pods)

    def get(self, uid: str) -> Optional[Obj]:
        with self._lock:
            return self._pods.get(uid)

    def meta(self, uid: str) -> Optional[Dict[str, str]]:
        """uid → {namespace, name, phase} (None on miss)."""
        with self._lock:
            pod = self._pods.get(uid)
            if pod is None:
                return None
            return {
                "namespace": pod["metadata"]["namespace"],
                "name": pod["metadata"]["name"],
                "phase": pod["status"]["phase"],
            }

    def labels(self, node_name: Optional[str] = None) -> Dict[str, Dict[str, str]]:
        """uid → {namespace, name}, the collector's label lookup shape."""
        out: Dict[str, Dict[str, str]] = {}
        with self._lock:
            for uid, pod in self._pods.items():
                if (node_name and
                        pod["spec"].get("nodeName") != node_name):
                    continue
                out[uid] = {
                    "namespace": pod["metadata"]["namespace"],
                    "name": pod["metadata"]["name"],
                }
        return out

    def live_uids(self, node_name: Optional[str] = None) -> List[str]:
        with self._lock:
            return [
                uid for uid, pod in self._pods.items()
                if not node_name or pod["spec"].get("nodeName") == node_name
            ]

    def pods_on_node(self, node_name: str) -> List[Obj]:
        with self._lock:
            return [pod for pod in self._pods.values()
                    if pod["spec"].get("nodeName") == node_name]

    def snapshot_pods(self) -> List[Obj]:
        """Copy-isolated dump (debug/test helper)."""
        with self._lock:
            return copy.deepcopy(list(self._pods.values()))
