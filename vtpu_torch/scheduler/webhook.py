"""Mutating admission webhook.

The port's copy of vtpu/scheduler/webhook.py.

Reference: pkg/scheduler/webhook.go:52-88 — detect vendor resources in the
pod, let each vendor mutate its containers, rewrite `schedulerName` so only
vGPU pods flow through the extender. Privileged containers are skipped
(webhook.go:66-70: a privileged container sees the host's devices anyway, so
quota enforcement is meaningless).
"""

from __future__ import annotations

import base64
import json
import logging
import time
from typing import Any, Dict, Optional

from .. import api
from .. import device as devmod
from ..device.config import GLOBAL
from ..device.gpu import parse_quantity
from ..trace import trace_id_for_uid
from ..trace import tracer as _tracer
from ..util import types
from ..util.env import env_int, env_str
from ..util.jsoncopy import json_copy

log = logging.getLogger(__name__)


def _anno_patch_ops(pod: Dict[str, Any],
                    new_annos: Dict[str, str]) -> list:
    """JSON-patch ops stamping annotations, honoring whether the
    incoming object already has an annotations map (a JSON-pointer
    `add` into a missing map would fail the whole patch; two
    whole-map adds would clobber each other, so ALL of this request's
    annotation writes go through one call). Also applies the
    annotations to `pod` in place so in-process callers observe the
    same object the apiserver would persist."""
    if not new_annos:
        return []
    meta = pod.setdefault("metadata", {})
    had_annos = isinstance(meta.get("annotations"), dict)
    annos = meta.setdefault("annotations", {})
    annos.update(new_annos)
    if had_annos:
        ops = []
        for key, value in new_annos.items():
            escaped = key.replace("~", "~0").replace("/", "~1")
            ops.append({"op": "add",
                        "path": f"/metadata/annotations/{escaped}",
                        "value": value})
        return ops
    return [{"op": "add", "path": "/metadata/annotations",
             "value": dict(new_annos)}]


def _is_privileged(container: Dict[str, Any]) -> bool:
    return bool(
        (container.get("securityContext") or {}).get("privileged", False)
    )


def mutate_pod(pod: Dict[str, Any]) -> bool:
    """Mutate in place; True when the pod requests any vendor's devices."""
    found = False
    for ctr in pod.get("spec", {}).get("containers", []) or []:
        if _is_privileged(ctr):
            log.info("skipping privileged container %s", ctr.get("name"))
            continue
        for vendor in devmod.all_devices():
            if vendor.mutate_admission(ctr, pod):
                found = True
    if found:
        pod["spec"]["schedulerName"] = GLOBAL.scheduler_name
    return found


def _resource_host_mem_mb(pod: Dict[str, Any]) -> int:
    """Sum of the vendors' host-memory resources (google.com/tpuhostmem)
    over non-privileged containers — the synthesis source for the
    pod-level vtpu.io/host-memory annotation."""
    total = 0
    for ctr in pod.get("spec", {}).get("containers", []) or []:
        if _is_privileged(ctr):
            continue
        for vendor in devmod.all_devices():
            total += vendor.container_host_mem_mb(ctr)
    return total


class MigrationAnnotationReject(ValueError):
    """A pod CREATE carried — or a pod UPDATE changed — a
    scheduler-owned migration annotation."""


_MIGRATION_ANNOS = (types.MIGRATING_TO_ANNO, types.MIGRATED_FROM_ANNO,
                    types.MIGRATE_DEADLINE_ANNO)


def validate_migration_annotations(pod: Dict[str, Any]) -> None:
    """The live-migration protocol annotations (docs/migration.md) are
    written exclusively by the scheduler's fenced commit pipeline and
    the planner — ``vtpu.io/migrating-to`` is an attach authorization
    for destination chips and ``vtpu.io/migrated-from`` drives the
    destination Allocate's environment replay. A user-supplied value on
    CREATE could aim a workload at chips it was never granted, so the
    front door denies it outright (same rigor as host-memory/priority;
    hack/vtpulint.py VTPU018 confines the legitimate writers)."""
    annos = (pod.get("metadata", {}) or {}).get("annotations", {}) or {}
    for anno in _MIGRATION_ANNOS:
        if anno in annos:
            raise MigrationAnnotationReject(
                f"{anno} is written by the vGPU scheduler's migration "
                "protocol and may not be supplied at pod creation")


#: comma-separated usernames (service accounts) allowed to mutate the
#: migration protocol annotations on UPDATE — the scheduler's own
#: identity, wired by the helm chart. Everyone else's UPDATEs may not
#: CHANGE a stamp: the scheduler's resync trusts vtpu.io/migrating-to
#: from the annotation bus to synthesize destination reservations, so
#: an unvalidated UPDATE could book arbitrary chips without a grant.
MIGRATION_WRITERS_ENV = api.ENV_MIGRATION_WRITERS


def validate_migration_update(pod: Dict[str, Any],
                              old_pod: Dict[str, Any],
                              username: str = "") -> None:
    """UPDATE-side twin of :func:`validate_migration_annotations`: the
    protocol annotations may only *change* through the scheduler's
    fenced commit pipeline (identified by its service-account username,
    ``VTPU_MIGRATION_WRITERS``). Unchanged values pass — ordinary
    UPDATEs that merely carry the stamps along are not the attack."""
    writers = {w.strip()
               for w in env_str(MIGRATION_WRITERS_ENV).split(",")
               if w.strip()}
    if username and username in writers:
        return
    annos = (pod.get("metadata", {}) or {}).get("annotations", {}) or {}
    old = (old_pod.get("metadata", {}) or {}).get("annotations", {}) \
        or {}
    for anno in _MIGRATION_ANNOS:
        if annos.get(anno) != old.get(anno):
            raise MigrationAnnotationReject(
                f"{anno} is written by the vGPU scheduler's migration "
                "protocol and may not be changed by "
                f"{username or 'this user'}")


class HostMemoryReject(ValueError):
    """A host-memory request the webhook must DENY (invalid value,
    host-memory without a vGPU request, over the cluster cap) — as
    opposed to our own bugs, which admit unmodified with a warning."""


class TaskPriorityReject(ValueError):
    """A task-priority declaration the webhook must DENY (malformed or
    negative vtpu.io/task-priority annotation): admitting it would
    either mint an accidental guaranteed pod (preemption immunity) or
    silently degrade the tier the user asked for."""


def _resource_task_priority(pod: Dict[str, Any]) -> Optional[int]:
    """MIN (= highest) task priority declared across the vendors'
    priority resources on non-privileged containers; None when no
    container declares one — the synthesis source for the pod-level
    vtpu.io/task-priority annotation the preemption engine reads.
    The DENY contract covers this path too: a malformed or negative
    resource value raises :class:`TaskPriorityReject` — synthesizing
    an annotation the webhook itself would reject (and every consumer
    would silently demote to best-effort) is exactly the tier drift
    validation exists to prevent."""
    best: Optional[int] = None
    for ctr in pod.get("spec", {}).get("containers", []) or []:
        if _is_privileged(ctr):
            continue
        for vendor in devmod.all_devices():
            try:
                prio = vendor.container_task_priority(ctr)
            except (ValueError, TypeError):
                raise TaskPriorityReject(
                    f"invalid {types.RESOURCE_PRIORITY} resource on "
                    f"container {ctr.get('name', '?')!r}: not an "
                    "integer") from None
            if prio is not None and prio < 0:
                raise TaskPriorityReject(
                    f"invalid {types.RESOURCE_PRIORITY} resource on "
                    f"container {ctr.get('name', '?')!r}: negative")
            if prio is not None and (best is None or prio < best):
                best = prio
    return best


def validate_task_priority(pod: Dict[str, Any]) -> Optional[int]:
    """Validate the priority dimension and return the pod's effective
    priority (None = nothing declared anywhere — the scheduler treats
    that as the best-effort default). An explicit annotation wins over
    the container-resource synthesis; malformed/negative values raise
    :class:`TaskPriorityReject`."""
    annos = (pod.get("metadata", {}) or {}).get("annotations", {}) or {}
    raw = annos.get(types.TASK_PRIORITY_ANNO)
    if raw is not None:
        try:
            declared = int(str(raw).strip())
        except (ValueError, TypeError):
            raise TaskPriorityReject(
                f"invalid {types.TASK_PRIORITY_ANNO} annotation "
                f"{raw!r}: not an integer") from None
        if declared < 0:
            raise TaskPriorityReject(
                f"invalid {types.TASK_PRIORITY_ANNO} annotation "
                f"{raw!r}: negative")
        return declared
    return _resource_task_priority(pod)


def validate_host_memory(pod: Dict[str, Any], is_vtpu: bool) -> int:
    """Validate the host-memory dimension and return the pod's
    reservation in MB (0 = legacy no-reservation). Raises
    :class:`HostMemoryReject` for requests that must be denied:

      * a malformed / negative ``vtpu.io/host-memory`` annotation;
      * host memory declared (annotation or resource) on a pod with no
        vGPU request — the quota dimension only exists for vGPU pods;
      * a request above the cluster-operator cap VTPU_HOST_MEM_MAX_MB
        (0 = no cap).

    An explicit annotation wins over the container-resource sum (the
    documented override for workloads whose offload footprint is not
    per-container additive)."""
    annos = (pod.get("metadata", {}) or {}).get("annotations", {}) or {}
    raw = annos.get(types.HOST_MEM_ANNO)
    resource_mb = _resource_host_mem_mb(pod)
    declared: Optional[int] = None
    if raw is not None:
        try:
            declared = parse_quantity(raw)
        except (ValueError, TypeError):
            raise HostMemoryReject(
                f"invalid {types.HOST_MEM_ANNO} annotation {raw!r}: "
                "not a quantity (MB)") from None
        if declared < 0:
            raise HostMemoryReject(
                f"invalid {types.HOST_MEM_ANNO} annotation {raw!r}: "
                "negative")
    demand = declared if declared is not None else resource_mb
    if demand > 0 and not is_vtpu:
        raise HostMemoryReject(
            f"{types.HOST_MEM_ANNO} ({demand}MB) without a vGPU "
            "request: host-memory quota is a dimension of vGPU "
            "allocations, not a standalone resource")
    cap = env_int(api.ENV_HOST_MEM_MAX_MB, 0, minimum=0)
    if cap and demand > cap:
        raise HostMemoryReject(
            f"host-memory request {demand}MB exceeds the cluster cap "
            f"{cap}MB (VTPU_HOST_MEM_MAX_MB)")
    return demand


def handle_admission_review(review: Dict[str, Any]) -> Dict[str, Any]:
    """AdmissionReview request → AdmissionReview response with a JSON patch
    (the Go side uses sigs.k8s.io admission helpers; the wire format is the
    same).

    Tracing (docs/observability.md): vGPU pods whose ``metadata.uid`` is
    already set get the trace-id annotation stamped (types.TRACE_ID_ANNO,
    a pure function of the UID — the stitch key every other daemon
    re-derives). On a real apiserver the UID is assigned AFTER mutating
    admission on CREATE, so no annotation is stamped there — stamping a
    random id would actively break stitching; the scheduler writes the
    UID-derived annotation with the assignment commit instead, and the
    webhook span keeps a standalone id. The span is recorded only for
    vGPU pods — this webhook intercepts every pod CREATE in the cluster,
    and non-vGPU churn must not evict real traces from the ring."""
    request = review.get("request", {}) or {}
    uid = request.get("uid", "")
    response: Dict[str, Any] = {"uid": uid, "allowed": True}
    pod = request.get("object", {}) or {}
    meta = pod.get("metadata", {}) or {}
    pod_key = (f"{meta.get('namespace', 'default')}/"
               f"{meta.get('name', '')}")
    started = time.perf_counter()
    operation = str(request.get("operation", "") or "CREATE").upper()
    if operation == "UPDATE":
        # the webhook also intercepts pod UPDATEs (helm registers
        # both), but only to guard the migration protocol annotations:
        # the pod spec is immutable post-create, so no mutation runs —
        # validate and answer. Denial is reserved for a CHANGED stamp
        # by a non-scheduler identity; our own bugs admit unmodified.
        try:
            validate_migration_update(
                pod, request.get("oldObject", {}) or {},
                str((request.get("userInfo", {}) or {})
                    .get("username", "") or ""))
        except MigrationAnnotationReject as e:
            response["allowed"] = False
            response["status"] = {"code": 400, "message": str(e)}
        except Exception as e:
            log.exception("webhook UPDATE validation failed; "
                          "admitting unmodified")
            response["warnings"] = [f"vtpu webhook error: {e}"]
        return {
            "apiVersion": review.get("apiVersion",
                                     "admission.k8s.io/v1"),
            "kind": "AdmissionReview",
            "response": response,
        }
    try:
        # structural snapshot, not a json round-trip: this runs on every
        # pod CREATE in the cluster, and at the 1k-admissions/s front
        # door the dumps+loads pair was the webhook's costliest line
        original_spec = json_copy(pod.get("spec", {}))
        is_vtpu = mutate_pod(pod)
        # host-memory dimension: an INVALID request is an explicit
        # admission DENY (unlike our own bugs below, which admit with a
        # warning) — admitting it would either schedule an unpayable
        # reservation or silently strip the quota the user asked for
        try:
            host_mb = validate_host_memory(pod, is_vtpu)
            # priority is validated with the same front-door rigor:
            # a malformed tier must not silently become best-effort
            # (or worse, guaranteed) — docs/multihost.md preemption ADR
            task_prio = validate_task_priority(pod) if is_vtpu else None
            validate_migration_annotations(pod)
        except (HostMemoryReject, TaskPriorityReject,
                MigrationAnnotationReject) as e:
            response["allowed"] = False
            response["status"] = {"code": 400, "message": str(e)}
            return {
                "apiVersion": review.get("apiVersion",
                                         "admission.k8s.io/v1"),
                "kind": "AdmissionReview",
                "response": response,
            }
        if is_vtpu:
            pod_uid = meta.get("uid", "")
            # backdated span: only vGPU pods reach the tracer at all
            with _tracer.span(trace_id_for_uid(pod_uid), "webhook.mutate",
                              started_at=started, pod=pod_key,
                              uid_known=bool(pod_uid)):
                patch = []
                if pod["spec"] != original_spec:
                    patch.append({"op": "replace", "path": "/spec",
                                  "value": pod["spec"]})
                annos0 = (pod.get("metadata", {})
                          or {}).get("annotations", {}) or {}
                new_annos: Dict[str, str] = {}
                # synthesis: containers declared google.com/tpuhostmem
                # but no pod annotation — stamp the summed reservation
                # so every downstream consumer (filter fit, Allocate
                # env, recovery rebuild) reads ONE durable number
                if host_mb > 0 and types.HOST_MEM_ANNO not in annos0:
                    new_annos[types.HOST_MEM_ANNO] = str(host_mb)
                # priority synthesis (preemption ADR): containers
                # declared google.com/priority but no pod annotation —
                # stamp the durable tier so the scheduler's preemption
                # engine and every recovery rebuild read ONE number
                # (min across containers = the pod's strongest claim)
                if (task_prio is not None
                        and types.TASK_PRIORITY_ANNO not in annos0):
                    new_annos[types.TASK_PRIORITY_ANNO] = str(task_prio)
                if pod_uid:
                    new_annos[types.TRACE_ID_ANNO] = \
                        trace_id_for_uid(pod_uid)
                patch.extend(_anno_patch_ops(pod, new_annos))
                if patch:
                    response["patchType"] = "JSONPatch"
                    response["patch"] = base64.b64encode(
                        json.dumps(patch).encode()
                    ).decode()
    except Exception as e:  # never block admission on our own bug
        log.exception("webhook mutation failed; admitting unmodified")
        response["warnings"] = [f"vtpu webhook error: {e}"]
    return {
        "apiVersion": review.get("apiVersion", "admission.k8s.io/v1"),
        "kind": "AdmissionReview",
        "response": response,
    }
