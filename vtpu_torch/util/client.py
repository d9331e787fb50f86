"""Kubernetes API access (the port's copy of vtpu/util/client.py).

The reference keeps one lazy global client-go clientset
(pkg/util/client/client.go:17-43, in-cluster config with kubeconfig
fallback). We mirror that shape but behind a small interface so every
control-plane component is unit-testable against an in-memory fake — the
reference's biggest test gap (SURVEY.md §4: "the scheduler package has zero
tests") is closed by injecting FakeKubeClient everywhere.

Only the half-dozen verbs the stack actually uses are modeled: get/list/patch
nodes and pods, bind, and pod deletion events via a poll-style list.
"""

from __future__ import annotations

import bisect
import json
import os
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

from .. import api
from .env import env_float, env_str
from .jsoncopy import json_copy

Obj = Dict[str, Any]  # plain JSON-shaped k8s objects


class ConflictError(Exception):
    """Optimistic-concurrency failure on a guarded patch."""


class PreconditionError(ConflictError):
    """A per-item precondition on a bulk annotation patch failed.
    `field` names which one: "uid" (the object is a different instance
    than the patch was computed for) or "anno" (an integer-annotation
    ceiling — the commit pipeline's generation fence — was exceeded)."""

    def __init__(self, key: str, field: str, detail: str = "") -> None:
        super().__init__(f"{key}: {field} precondition failed"
                         + (f" ({detail})" if detail else ""))
        self.field = field


class NotFoundError(Exception):
    pass


class GoneError(Exception):
    """Watch resourceVersion expired (HTTP 410); caller must relist
    (the standard informer ListAndWatch fallback)."""


class KubeClient:
    """Verb surface used by scheduler / plugin / monitor."""

    # -- nodes ------------------------------------------------------------
    def get_node(self, name: str) -> Obj:
        raise NotImplementedError

    def list_nodes(self) -> List[Obj]:
        raise NotImplementedError

    def patch_node_annotations(
        self, name: str, annotations: Dict[str, Optional[str]]
    ) -> Obj:
        """Merge-patch node annotations; None deletes a key."""
        raise NotImplementedError

    def update_node_annotations_guarded(
        self, name: str, annotations: Dict[str, Optional[str]],
        resource_version: str,
    ) -> Obj:
        """CAS update used by the node lock; raises ConflictError if the
        object moved (reference relies on apiserver update conflicts,
        nodelock.go:18-47)."""
        raise NotImplementedError

    # -- pods -------------------------------------------------------------
    def get_pod(self, namespace: str, name: str) -> Obj:
        raise NotImplementedError

    def list_pods_all_namespaces(self) -> List[Obj]:
        raise NotImplementedError

    def list_pods_on_node(self, node_name: str) -> List[Obj]:
        """Node-scoped pod list. The real client pushes the filter to
        the apiserver (`fieldSelector=spec.nodeName=...` — reference
        semantics pkg/util/util.go:41-66 should have done the same);
        this default matches those semantics client-side so every
        KubeClient behaves identically."""
        return [
            p for p in self.list_pods_all_namespaces()
            if p.get("spec", {}).get("nodeName") == node_name
        ]

    def list_pods_with_version(
        self, field_selector: str = ""
    ) -> Tuple[List[Obj], str]:
        """Pod list plus the list's resourceVersion, the handle a
        subsequent watch_pods resumes from. `field_selector` is pushed
        server-side (e.g. ``spec.nodeName=<node>`` via
        :func:`node_field_selector`) so node-scoped informers never pull
        the whole cluster."""
        raise NotImplementedError

    def watch_pods(self, resource_version: str,
                   timeout_s: float = 60.0,
                   field_selector: str = "") -> Iterator[Tuple[str, Obj]]:
        """Stream ("ADDED"|"MODIFIED"|"DELETED"|"BOOKMARK", pod) events
        after `resource_version` until `timeout_s` of quiet; raises
        GoneError when the version is too old to resume (caller
        relists). Mirrors client-go's ListAndWatch contract
        (reference: scheduler.go:72-133 informer wiring). With a
        `field_selector` only matching pods' events are delivered."""
        raise NotImplementedError

    def patch_pod_annotations(
        self, namespace: str, name: str, annotations: Dict[str, Optional[str]]
    ) -> Obj:
        raise NotImplementedError

    def patch_pods_annotations_bulk(
        self, patches: List[Tuple[str, str, Dict[str, Optional[str]],
                                  Optional[Dict[str, Any]]]],
    ) -> List[Optional[Exception]]:
        """Apply several pods' annotation patches in one call, each
        guarded by optional per-item preconditions — the commit
        pipeline's per-node coalesced write (committer.py).

        Each item is `(namespace, name, annotations, preconditions)`;
        preconditions may carry:

          * ``"uid"``: the patch applies only while `metadata.uid`
            still equals this value (a pod deleted and recreated under
            the same name must not inherit the old patch);
          * ``"anno_le"``: ``(anno_key, ceiling)`` — the patch applies
            only while ``int(annotations[anno_key] or 0) <= ceiling``
            (the scheduler's leadership-generation fence: a newer
            leader's stamp must never be rewound).

        Returns one entry per item: ``None`` on success, or the
        exception that item hit (`NotFoundError`, `PreconditionError`)
        — item failures never abort the rest of the batch. Transport
        failures (anything that prevents evaluating the batch at all)
        raise instead.

        The base implementation is a per-pod get→check→patch loop, so
        every KubeClient keeps working unchanged; FakeKubeClient
        overrides it with a single-lock batch (one "RPC"), which is
        what the coalescing committer measures against."""
        results: List[Optional[Exception]] = []
        for namespace, name, annotations, preconds in patches:
            key = f"{namespace}/{name}"
            try:
                if preconds:
                    current = self.get_pod(namespace, name)
                    err = check_patch_preconditions(key, current, preconds)
                    if err is not None:
                        results.append(err)
                        continue
                self.patch_pod_annotations(namespace, name, annotations)
                results.append(None)
            except (NotFoundError, ConflictError) as e:
                results.append(e)
        return results

    def bind_pod(self, namespace: str, name: str, node: str) -> None:
        raise NotImplementedError

    def delete_pod(self, namespace: str, name: str,
                   uid: str = "") -> None:
        """Delete a pod — the preemption protocol's phase 2
        (docs/multihost.md ADR). With `uid` set the delete is
        preconditioned on the pod still being that INSTANCE
        (DeleteOptions.preconditions server-side): a victim deleted
        and recreated under the same name while the evict commit was
        in flight must never have the NEW pod killed for the old
        decision — a mismatch raises PreconditionError. Deleting an
        already-gone pod raises NotFoundError (callers treat it as
        the eviction having already completed — deletes are
        idempotent by uid)."""
        raise NotImplementedError

    # -- leases (coordination.k8s.io; HA leader election, docs/ha.md) ------
    def get_lease(self, namespace: str, name: str) -> Obj:
        raise NotImplementedError

    def create_lease(self, namespace: str, name: str, spec: Obj) -> Obj:
        """Create; raises ConflictError when the lease already exists
        (the loser of a creation race must re-read, never clobber)."""
        raise NotImplementedError

    def update_lease_guarded(
        self, namespace: str, name: str, spec: Obj,
        resource_version: str,
    ) -> Obj:
        """CAS replace of lease.spec — the same optimistic-concurrency
        discipline the node lock uses (nodelock.go:18-47), one level up:
        raises ConflictError when the object moved."""
        raise NotImplementedError


def node_field_selector(node_name: str) -> str:
    """The selector scoping pod list/watch to one node server-side."""
    return f"spec.nodeName={node_name}"


def check_patch_preconditions(key: str, current: Obj,
                              preconds: Dict[str, Any],
                              ) -> Optional[Exception]:
    """Evaluate a bulk-patch item's preconditions against the live
    object (shared by the base loop implementation and the fake's
    single-lock batch). Returns the failure (None = all hold)."""
    want_uid = preconds.get("uid")
    if want_uid:
        cur_uid = (current.get("metadata", {}) or {}).get("uid", "")
        if cur_uid and cur_uid != want_uid:
            return PreconditionError(
                key, "uid", f"have {cur_uid}, want {want_uid}")
    anno_le = preconds.get("anno_le")
    if anno_le:
        anno_key, ceiling = anno_le
        annos = (current.get("metadata", {}) or {}) \
            .get("annotations", {}) or {}
        try:
            have = int(annos.get(anno_key, "0") or 0)
        except ValueError:
            have = 0
        if have > ceiling:
            return PreconditionError(
                key, "anno", f"{anno_key}={have} > {ceiling}")
    return None


# --------------------------------------------------------------------------
# In-memory fake (test double; reference pattern: C mock of libcndev, C7)
# --------------------------------------------------------------------------

def _meta(obj: Obj) -> Obj:
    return obj.setdefault("metadata", {})


def _matches_selector(pod: Obj, field_selector: str) -> bool:
    """Client-side evaluation of the selector subset the fake supports
    (spec.nodeName / metadata.name / metadata.namespace equality —
    clauses the apiserver would evaluate server-side; unknown fields
    are rejected loudly rather than silently matching everything)."""
    if not field_selector:
        return True
    for clause in field_selector.split(","):
        key, _, want = clause.partition("=")
        if key == "spec.nodeName":
            got = (pod.get("spec", {}) or {}).get("nodeName", "")
        elif key == "metadata.name":
            got = (pod.get("metadata", {}) or {}).get("name", "")
        elif key == "metadata.namespace":
            got = (pod.get("metadata", {}) or {}).get("namespace", "")
        else:
            raise ValueError(f"unsupported field selector: {clause!r}")
        if got != want:
            return False
    return True


def _annos(obj: Obj) -> Dict[str, str]:
    return _meta(obj).setdefault("annotations", {})


class FakeKubeClient(KubeClient):
    """Thread-safe in-memory apiserver good enough for the annotation bus."""

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._cond = threading.Condition(self._lock)
        self._nodes: Dict[str, Obj] = {}
        self._pods: Dict[str, Obj] = {}  # key: ns/name
        self._leases: Dict[str, Obj] = {}  # key: ns/name
        self._rv = 0
        self.bindings: List[Dict[str, str]] = []
        # verb → call count, so tests can assert apiserver load (e.g. the
        # monitor's zero-LIST steady state); list_pods counts every
        # full-pod-list verb, including the node-scoped default
        # (list_pods_on_node routes through list_pods_all_namespaces)
        self.call_counts: Dict[str, int] = {}
        # pod event log for watch_pods: (rv, type, snapshot). Compacted
        # via compact_events() to simulate apiserver history expiry
        # (watch from an evicted rv -> 410/GoneError).
        self._events: List[Tuple[int, str, Obj]] = []
        self._oldest_rv = 0  # events at/below this rv are gone

    # apiserver-watch-cache analog: the event log is bounded; watchers
    # resuming from before the trimmed horizon get GoneError and relist
    MAX_EVENTS = 4096

    def _count(self, verb: str) -> None:
        with self._lock:
            self.call_counts[verb] = self.call_counts.get(verb, 0) + 1

    def reset_call_counts(self) -> None:
        with self._lock:
            self.call_counts.clear()

    @property
    def list_pod_calls(self) -> int:
        """Full pod LISTs issued (the apiserver cost the watch-backed
        caches exist to eliminate)."""
        with self._lock:
            return (self.call_counts.get("list_pods", 0)
                    + self.call_counts.get("list_pods_with_version", 0))

    def _emit(self, etype: str, pod: Obj) -> None:
        """Lock held; record a pod event at the current rv."""
        self._events.append((self._rv, etype, json_copy(pod)))
        if len(self._events) > self.MAX_EVENTS:
            drop = len(self._events) - self.MAX_EVENTS
            self._oldest_rv = self._events[drop - 1][0]
            del self._events[:drop]
        self._cond.notify_all()

    def compact_events(self) -> None:
        """Test helper: forget all history, like an apiserver whose
        watch cache rolled over — resuming from any prior rv raises
        GoneError."""
        with self._lock:
            self._oldest_rv = self._rv
            self._events.clear()

    # -- test helpers -----------------------------------------------------
    def add_node(self, name: str, annotations: Optional[Dict[str, str]] = None,
                 labels: Optional[Dict[str, str]] = None) -> Obj:
        with self._lock:
            self._rv += 1
            node = {
                "metadata": {
                    "name": name,
                    "annotations": dict(annotations or {}),
                    "labels": dict(labels or {}),
                    "resourceVersion": str(self._rv),
                },
                "status": {},
            }
            self._nodes[name] = node
            return json_copy(node)

    def add_pod(self, pod: Obj) -> Obj:
        with self._lock:
            self._rv += 1
            pod = json_copy(pod)  # copy-isolate from the caller's dict
            _meta(pod).setdefault("namespace", "default")
            _meta(pod)["resourceVersion"] = str(self._rv)
            key = f"{_meta(pod)['namespace']}/{_meta(pod)['name']}"
            self._pods[key] = pod
            self._emit("ADDED", pod)
            return json_copy(pod)

    def delete_pod(self, namespace: str, name: str,
                   uid: str = "") -> None:
        with self._lock:
            key = f"{namespace}/{name}"
            pod = self._pods.get(key)
            if pod is None:
                # harness convenience: deleting an absent pod stays a
                # no-op for uid-less calls (the historical fake
                # semantics dozens of tests rely on); the
                # preconditioned protocol path gets the real
                # apiserver's 404 so idempotent replay is observable
                if uid:
                    raise NotFoundError(key)
                return
            if uid:
                cur = _meta(pod).get("uid", "")
                if cur and cur != uid:
                    raise PreconditionError(
                        key, "uid", f"have {cur}, want {uid}")
            self._pods.pop(key, None)
            self._rv += 1
            # the deletion event carries a fresh rv (apiserver
            # semantics) so a resuming watch never rewinds
            _meta(pod)["resourceVersion"] = str(self._rv)
            self._emit("DELETED", pod)

    # -- nodes ------------------------------------------------------------
    def get_node(self, name: str) -> Obj:
        with self._lock:
            if name not in self._nodes:
                raise NotFoundError(name)
            return json_copy(self._nodes[name])

    def list_nodes(self) -> List[Obj]:
        with self._lock:
            return json_copy(list(self._nodes.values()))

    def _apply_annos(self, obj: Obj,
                     annotations: Dict[str, Optional[str]]) -> None:
        annos = _annos(obj)
        for k, v in annotations.items():
            if v is None:
                annos.pop(k, None)
            else:
                annos[k] = v
        self._rv += 1
        _meta(obj)["resourceVersion"] = str(self._rv)

    def patch_node_annotations(self, name, annotations):
        with self._lock:
            if name not in self._nodes:
                raise NotFoundError(name)
            self._apply_annos(self._nodes[name], annotations)
            return json_copy(self._nodes[name])

    def update_node_annotations_guarded(self, name, annotations,
                                        resource_version):
        with self._lock:
            if name not in self._nodes:
                raise NotFoundError(name)
            node = self._nodes[name]
            if _meta(node).get("resourceVersion") != resource_version:
                raise ConflictError(name)
            self._apply_annos(node, annotations)
            return json_copy(node)

    # -- pods -------------------------------------------------------------
    def get_pod(self, namespace: str, name: str) -> Obj:
        with self._lock:
            key = f"{namespace}/{name}"
            if key not in self._pods:
                raise NotFoundError(key)
            return json_copy(self._pods[key])

    def list_pods_all_namespaces(self) -> List[Obj]:
        self._count("list_pods")
        with self._lock:
            return json_copy(list(self._pods.values()))

    def patch_pod_annotations(self, namespace, name, annotations):
        with self._lock:
            key = f"{namespace}/{name}"
            if key not in self._pods:
                raise NotFoundError(key)
            self._apply_annos(self._pods[key], annotations)
            self._emit("MODIFIED", self._pods[key])
            return json_copy(self._pods[key])

    def patch_pods_annotations_bulk(self, patches):
        """One lock hold ("RPC") for the whole batch — the server-side
        shape of the committer's per-node coalesced write. Preconditions
        are evaluated against the live object under the same hold, so a
        concurrent recreate can never slip between check and patch."""
        self._count("patch_pods_bulk")
        results: List[Optional[Exception]] = []
        with self._lock:
            for namespace, name, annotations, preconds in patches:
                key = f"{namespace}/{name}"
                pod = self._pods.get(key)
                if pod is None:
                    results.append(NotFoundError(key))
                    continue
                if preconds:
                    err = check_patch_preconditions(key, pod, preconds)
                    if err is not None:
                        results.append(err)
                        continue
                self._apply_annos(pod, annotations)
                self._emit("MODIFIED", pod)
                results.append(None)
        return results

    def bind_pod(self, namespace: str, name: str, node: str) -> None:
        with self._lock:
            self.bindings.append(
                {"namespace": namespace, "name": name, "node": node}
            )
            key = f"{namespace}/{name}"
            if key in self._pods:
                self._pods[key].setdefault("spec", {})["nodeName"] = node
                self._rv += 1
                _meta(self._pods[key])["resourceVersion"] = str(self._rv)
                self._emit("MODIFIED", self._pods[key])

    def list_pods_with_version(
        self, field_selector: str = ""
    ) -> Tuple[List[Obj], str]:
        self._count("list_pods_with_version")
        with self._lock:
            return (json_copy([p for p in self._pods.values()
                                   if _matches_selector(p, field_selector)]),
                    str(self._rv))

    # -- leases ------------------------------------------------------------
    def get_lease(self, namespace: str, name: str) -> Obj:
        with self._lock:
            key = f"{namespace}/{name}"
            if key not in self._leases:
                raise NotFoundError(key)
            return json_copy(self._leases[key])

    def create_lease(self, namespace: str, name: str, spec: Obj) -> Obj:
        with self._lock:
            key = f"{namespace}/{name}"
            if key in self._leases:
                raise ConflictError(key)
            self._rv += 1
            lease = {
                "metadata": {"name": name, "namespace": namespace,
                             "resourceVersion": str(self._rv)},
                "spec": json_copy(spec),
            }
            self._leases[key] = lease
            return json_copy(lease)

    def update_lease_guarded(self, namespace, name, spec,
                             resource_version):
        with self._lock:
            key = f"{namespace}/{name}"
            if key not in self._leases:
                raise NotFoundError(key)
            lease = self._leases[key]
            if _meta(lease).get("resourceVersion") != resource_version:
                raise ConflictError(key)
            self._rv += 1
            lease["spec"] = json_copy(spec)
            _meta(lease)["resourceVersion"] = str(self._rv)
            return json_copy(lease)

    def watch_pods(self, resource_version: str,
                   timeout_s: float = 60.0,
                   field_selector: str = "") -> Iterator[Tuple[str, Obj]]:
        try:
            rv = int(resource_version)
        except (TypeError, ValueError):
            raise GoneError(resource_version) from None
        deadline = time.monotonic() + timeout_s
        while True:
            with self._cond:
                if rv < self._oldest_rv:
                    raise GoneError(resource_version)
                # events are in rv order: start past `rv` by bisection,
                # not by scanning the whole history on every wake-up
                start = bisect.bisect_right(self._events, rv,
                                            key=lambda e: e[0])
                batch = [(erv, etype, json_copy(pod))
                         for erv, etype, pod in self._events[start:]
                         if _matches_selector(pod, field_selector)]
                if not batch:
                    # non-matching events still advance the resume point
                    # (the apiserver does this via bookmarks)
                    if self._events:
                        rv = max(rv, self._events[-1][0])
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return
                    self._cond.wait(min(remaining, 0.05))
                    continue
            for erv, etype, pod in batch:
                rv = max(rv, erv)
                yield etype, pod


# --------------------------------------------------------------------------
# Real REST client (in-cluster service account, kubeconfig fallback)
# --------------------------------------------------------------------------

_SA_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"


class RestKubeClient(KubeClient):
    """Minimal REST client speaking directly to the apiserver.

    Equivalent slot to client-go in the reference (pkg/util/client/client.go);
    uses merge-patch for annotations and the pods/binding subresource for
    Bind, exactly the verbs the reference issues.
    """

    #: sleep before retrying an idempotent request (transient 5xx /
    #: connection error); one retry only — the callers' own loops
    #: (watch re-list, registration poll) handle longer outages
    RETRY_DELAY_S = 0.2

    def __init__(self, base_url: Optional[str] = None,
                 token: Optional[str] = None,
                 ca_cert: Optional[str] = None,
                 timeout_s: Optional[float] = None) -> None:
        import requests  # lazy: tests never import this path

        self._requests = requests
        if timeout_s is None:
            timeout_s = env_float(api.ENV_API_TIMEOUT_S, 30.0)
        self.timeout_s = timeout_s
        self._s = requests.Session()
        if base_url is None:
            host = env_str(api.ENV_KUBERNETES_SERVICE_HOST)
            port = env_str(api.ENV_KUBERNETES_SERVICE_PORT, "443")
            if host:
                base_url = f"https://{host}:{port}"
                token_path = os.path.join(_SA_DIR, "token")
                if token is None and os.path.exists(token_path):
                    with open(token_path) as f:
                        token = f.read().strip()
                ca = os.path.join(_SA_DIR, "ca.crt")
                if ca_cert is None and os.path.exists(ca):
                    ca_cert = ca
            else:
                raise RuntimeError(
                    "no in-cluster env (KUBERNETES_SERVICE_HOST); "
                    "pass base_url explicitly"
                )
        self.base_url = base_url.rstrip("/")
        if token:
            self._s.headers["Authorization"] = f"Bearer {token}"
        # default to the system trust store; never silently disable TLS
        self._s.verify = ca_cert if ca_cert else True

    def _req(self, method: str, path: str, **kw) -> Any:
        # idempotent GETs (get/list) retry once on transient failures:
        # a flaky connection or a 5xx from a restarting apiserver must
        # not fail a whole registration poll / Allocate lookup. Writes
        # never retry here — patch/bind retry policy belongs to their
        # callers (e.g. the commit pipeline's backoff).
        attempts = 2 if method == "GET" else 1
        for attempt in range(attempts):
            try:
                r = self._s.request(method, self.base_url + path,
                                    timeout=self.timeout_s, **kw)
            except (self._requests.exceptions.ConnectionError,
                    self._requests.exceptions.Timeout):
                if attempt + 1 < attempts:
                    time.sleep(self.RETRY_DELAY_S)
                    continue
                raise
            if r.status_code == 404:
                raise NotFoundError(path)
            if r.status_code == 409:
                raise ConflictError(path)
            if r.status_code >= 500 and attempt + 1 < attempts:
                time.sleep(self.RETRY_DELAY_S)
                continue
            r.raise_for_status()
            return r.json() if r.content else None

    # -- nodes ------------------------------------------------------------
    def get_node(self, name):
        return self._req("GET", f"/api/v1/nodes/{name}")

    def list_nodes(self):
        return self._req("GET", "/api/v1/nodes").get("items", [])

    def _merge_patch_annos(self, path: str,
                           annotations: Dict[str, Optional[str]]) -> Obj:
        body = {"metadata": {"annotations": annotations}}
        return self._req(
            "PATCH", path, data=json.dumps(body),
            headers={"Content-Type": "application/merge-patch+json"},
        )

    def patch_node_annotations(self, name, annotations):
        return self._merge_patch_annos(f"/api/v1/nodes/{name}", annotations)

    def update_node_annotations_guarded(self, name, annotations,
                                        resource_version):
        node = self.get_node(name)
        if node["metadata"].get("resourceVersion") != resource_version:
            raise ConflictError(name)
        annos = node["metadata"].setdefault("annotations", {})
        for k, v in annotations.items():
            if v is None:
                annos.pop(k, None)
            else:
                annos[k] = v
        return self._req(
            "PUT", f"/api/v1/nodes/{name}", data=json.dumps(node),
            headers={"Content-Type": "application/json"},
        )

    # -- pods -------------------------------------------------------------
    def get_pod(self, namespace, name):
        return self._req("GET", f"/api/v1/namespaces/{namespace}/pods/{name}")

    def list_pods_all_namespaces(self):
        return self._req("GET", "/api/v1/pods").get("items", [])

    def list_pods_on_node(self, node_name):
        # server-side filter: the kubelet Allocate path must not pull
        # the whole cluster's pods per call (VERDICT r4 missing #2)
        return self._req(
            "GET", "/api/v1/pods",
            params={"fieldSelector": f"spec.nodeName={node_name}"},
        ).get("items", [])

    def list_pods_with_version(self, field_selector=""):
        params = {"fieldSelector": field_selector} if field_selector else {}
        body = self._req("GET", "/api/v1/pods", params=params)
        return (body.get("items", []),
                body.get("metadata", {}).get("resourceVersion", "0"))

    def watch_pods(self, resource_version, timeout_s=60.0,
                   field_selector=""):
        params = {
            "watch": "true",
            "resourceVersion": resource_version,
            "timeoutSeconds": str(max(1, int(timeout_s))),
            "allowWatchBookmarks": "true",
        }
        if field_selector:
            params["fieldSelector"] = field_selector
        r = self._s.request(
            "GET", self.base_url + "/api/v1/pods",
            params=params,
            stream=True, timeout=timeout_s + 30,
        )
        try:
            if r.status_code == 410:
                raise GoneError(resource_version)
            r.raise_for_status()
            for line in r.iter_lines():
                if not line:
                    continue
                event = json.loads(line)
                etype = event.get("type", "")
                obj = event.get("object", {}) or {}
                if etype == "ERROR":
                    # apiserver reports expiry mid-stream as a Status
                    # object with code 410
                    if obj.get("code") == 410:
                        raise GoneError(resource_version)
                    raise RuntimeError(f"watch error: {obj}")
                yield etype, obj
        finally:
            r.close()

    def patch_pod_annotations(self, namespace, name, annotations):
        return self._merge_patch_annos(
            f"/api/v1/namespaces/{namespace}/pods/{name}", annotations
        )

    def delete_pod(self, namespace, name, uid=""):
        body: Dict[str, Any] = {
            "apiVersion": "v1", "kind": "DeleteOptions",
        }
        if uid:
            # server-side instance precondition: the apiserver answers
            # 409 when the live object's uid differs — mapped to
            # ConflictError by _req, re-raised as the protocol's
            # PreconditionError so callers see one exception type
            body["preconditions"] = {"uid": uid}
        try:
            self._req(
                "DELETE",
                f"/api/v1/namespaces/{namespace}/pods/{name}",
                data=json.dumps(body),
                headers={"Content-Type": "application/json"},
            )
        except ConflictError as e:
            if uid:
                raise PreconditionError(f"{namespace}/{name}", "uid",
                                        str(e)) from e
            raise

    # -- leases ------------------------------------------------------------

    _LEASE_BASE = "/apis/coordination.k8s.io/v1/namespaces"

    def get_lease(self, namespace, name):
        return self._req("GET",
                         f"{self._LEASE_BASE}/{namespace}/leases/{name}")

    def create_lease(self, namespace, name, spec):
        body = {
            "apiVersion": "coordination.k8s.io/v1",
            "kind": "Lease",
            "metadata": {"name": name, "namespace": namespace},
            "spec": spec,
        }
        return self._req(
            "POST", f"{self._LEASE_BASE}/{namespace}/leases",
            data=json.dumps(body),
            headers={"Content-Type": "application/json"},
        )

    def update_lease_guarded(self, namespace, name, spec,
                             resource_version):
        body = {
            "apiVersion": "coordination.k8s.io/v1",
            "kind": "Lease",
            "metadata": {"name": name, "namespace": namespace,
                         "resourceVersion": resource_version},
            "spec": spec,
        }
        # PUT with resourceVersion set is the apiserver's native CAS:
        # a concurrent writer moved the object -> 409 -> ConflictError
        return self._req(
            "PUT", f"{self._LEASE_BASE}/{namespace}/leases/{name}",
            data=json.dumps(body),
            headers={"Content-Type": "application/json"},
        )

    def bind_pod(self, namespace, name, node):
        body = {
            "apiVersion": "v1",
            "kind": "Binding",
            "metadata": {"name": name, "namespace": namespace},
            "target": {"apiVersion": "v1", "kind": "Node", "name": node},
        }
        self._req(
            "POST", f"/api/v1/namespaces/{namespace}/pods/{name}/binding",
            data=json.dumps(body),
            headers={"Content-Type": "application/json"},
        )


# --------------------------------------------------------------------------
# Lazy singleton (reference: client.go:17-24)
# --------------------------------------------------------------------------

_client: Optional[KubeClient] = None
_client_lock = threading.Lock()


def get_client() -> KubeClient:
    global _client
    with _client_lock:
        if _client is None:
            _client = RestKubeClient()
        return _client


def set_client(c: KubeClient) -> None:
    """Inject a client (tests / embedding)."""
    global _client
    with _client_lock:
        _client = c


def now_ns() -> int:
    return time.time_ns()
