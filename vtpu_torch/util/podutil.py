"""Pod-side helpers of the annotation bus: the Allocate half, and the
parsers the node monitor shares with it.

The port's copy of vtpu/util/podutil.py:25-285, reduced to what the device
plugin and the monitor call (reference: pkg/util/util.go:41-66 pending-pod lookup, 174-236
next-device-request + erase-after-consume, 238-294 annotation patches).

The device-plugin/scheduler identity dance (SURVEY.md §7 hard part 3):
kubelet's Allocate call carries meaningless replica IDs, so the plugin finds
*the* pod currently bound to this node in phase "allocating" and consumes one
container's worth of the real assignment from the pod annotation.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, List, Optional

from . import codec, nodelock, types
from .client import KubeClient, NotFoundError

log = logging.getLogger(__name__)

BIND_GRACE_S = 5 * 60.0  # ignore allocating pods older than the lock expiry


def host_mem_mb_of(annos: Dict[str, str]) -> int:
    """The pod's host-memory reservation in MB (vtpu.io/host-memory),
    parsed as the scheduler's fit parses it; a malformed annotation
    degrades to the legacy 0-reservation default rather than failing
    Allocate."""
    raw = (annos or {}).get(types.HOST_MEM_ANNO)
    if not raw:
        return 0
    try:
        from ..device.gpu import parse_quantity  # lazy: no import cycle

        return max(0, parse_quantity(raw))
    except (ValueError, TypeError):
        log.warning("unparseable %s annotation %r; treating as 0",
                    types.HOST_MEM_ANNO, raw)
        return 0


def task_priority_of(annos: Dict[str, str],
                     default: int = types.TASK_PRIORITY_DEFAULT) -> int:
    """The pod's task priority (vtpu.io/task-priority), parsed as the
    scheduler's preemption engine parses it: 0 = guaranteed (may preempt,
    never a victim); absent or malformed degrades to the best-effort
    default, so a garbled annotation never mints a guaranteed pod."""
    raw = (annos or {}).get(types.TASK_PRIORITY_ANNO)
    if raw is None or raw == "":
        return default
    try:
        prio = int(raw)
        if prio < 0:
            raise ValueError(raw)
        return prio
    except (ValueError, TypeError):
        log.warning("unparseable %s annotation %r; treating as "
                    "best-effort (%d)", types.TASK_PRIORITY_ANNO, raw,
                    default)
        return default


def pod_uid_of_cache_entry(name: str) -> str:
    """``<podUID>_<n>`` region directory name (Allocate's cache_name,
    plugin/server.py) -> podUID: the one reader of that convention, shared
    by the monitor's region discovery, GC and trace stitching."""
    return name.rsplit("_", 1)[0]


def container_index_of_cache_entry(name: str) -> int:
    """``<podUID>_<n>`` -> container index n (-1 when unparsable): the
    resize applier picks a container's segment of a ``vtpu.io/hbm-limit``
    intent with it, since each container has its own region."""
    parts = name.rsplit("_", 1)
    if len(parts) != 2:
        return -1
    try:
        return int(parts[1])
    except ValueError:
        return -1


def is_pod_in_terminated_state(pod: Dict[str, Any]) -> bool:
    """Reference: pkg/k8sutil/pod.go:43-45."""
    phase = pod.get("status", {}).get("phase", "")
    return phase in ("Failed", "Succeeded")


def all_containers(pod: Dict[str, Any]) -> List[Dict[str, Any]]:
    return pod.get("spec", {}).get("containers", []) or []


def pending_from(pods, node_name: str) -> Optional[Dict[str, Any]]:
    """The pending-allocation predicate over an in-memory pod list."""
    for pod in pods:
        annos = pod.get("metadata", {}).get("annotations", {}) or {}
        if annos.get(types.ASSIGNED_NODE_ANNO) != node_name:
            continue
        if annos.get(types.BIND_PHASE_ANNO) \
                != types.BindPhase.ALLOCATING.value:
            continue
        if is_pod_in_terminated_state(pod):
            continue
        bind_time = annos.get(types.BIND_TIME_ANNO)
        if bind_time is not None:
            try:
                age = time.time() - int(bind_time) / 1e9
                if age > BIND_GRACE_S:
                    continue
            except ValueError:
                pass
        return pod
    return None


def get_pending_pod(client: KubeClient,
                    node_name: str) -> Optional[Dict[str, Any]]:
    """Find the pod bound to this node still in bind-phase=allocating
    (reference: util.go:41-66, which lists ALL pods per Allocate; the list
    is scoped to this node server-side, since the scheduler's Bind always
    precedes kubelet's Allocate). The JAX package can nominate the pod
    from a watch-backed cache first (vtpu/util/podutil.py:130-179); the
    port has no pod cache yet and always lists."""
    return pending_from(client.list_pods_on_node(node_name), node_name)


def decode_assigned_devices(pod: Dict[str, Any],
                            anno: str = types.TO_ALLOCATE_ANNO
                            ) -> types.PodDevices:
    value = (pod.get("metadata", {}).get("annotations", {}) or {}).get(
        anno, "")
    return codec.decode_pod_devices(value)


def get_next_device_request(
    vendor: str, pod: Dict[str, Any]
) -> types.ContainerDevices:
    """First not-yet-consumed container assignment of this vendor
    (reference: GetNextDeviceRequest util.go:174-194)."""
    for ctr_devs in decode_assigned_devices(pod):
        matching = [d for d in ctr_devs if d.type == vendor]
        if matching:
            return matching
    return []


def erase_next_device_type_from_annotation(
    client: KubeClient, vendor: str, pod: Dict[str, Any]
) -> None:
    """Remove this vendor's devices from the first container slot holding
    them, marking that slot consumed for this vendor while leaving other
    vendors' pending entries intact (reference:
    EraseNextDeviceTypeFromAnnotation util.go:204-236)."""
    pod_devices = decode_assigned_devices(pod)
    for i, ctr_devs in enumerate(pod_devices):
        if any(d.type == vendor for d in ctr_devs):
            pod_devices[i] = [d for d in ctr_devs if d.type != vendor]
            break
    meta = pod["metadata"]
    client.patch_pod_annotations(
        meta.get("namespace", "default"),
        meta["name"],
        {types.TO_ALLOCATE_ANNO: codec.encode_pod_devices(pod_devices)},
    )


def device_annotations(
    node_name: str, pod_devices: types.PodDevices
) -> Dict[str, str]:
    """The annotation set a scheduler's winning assignment writes
    (vtpu/util/podutil.py:239-251), in the port's codec: what Allocate
    later consumes."""
    encoded = codec.encode_pod_devices(pod_devices)
    return {
        types.ASSIGNED_NODE_ANNO: node_name,
        types.ASSIGNED_IDS_ANNO: encoded,
        types.TO_ALLOCATE_ANNO: encoded,
        types.ASSIGNED_TIME_ANNO: str(time.time_ns()),
    }


def pod_allocation_try_success(
    client: KubeClient, pod: Dict[str, Any], node_name: str
) -> None:
    """Flip bind-phase to success once every container slot is consumed, then
    release the node lock (reference: pkg/device/devices.go:54-78)."""
    try:
        fresh = client.get_pod(
            pod["metadata"].get("namespace", "default"),
            pod["metadata"]["name"],
        )
    except NotFoundError:
        return
    remaining = decode_assigned_devices(fresh)
    if any(len(c) > 0 for c in remaining):
        return  # more containers still to Allocate
    client.patch_pod_annotations(
        fresh["metadata"].get("namespace", "default"),
        fresh["metadata"]["name"],
        {types.BIND_PHASE_ANNO: types.BindPhase.SUCCESS.value},
    )
    nodelock.release_node(client, node_name)


def pod_allocation_failed(
    client: KubeClient, pod: Dict[str, Any], node_name: str
) -> None:
    """Reference: devices.go:80-91."""
    meta = pod["metadata"]
    try:
        client.patch_pod_annotations(
            meta.get("namespace", "default"),
            meta["name"],
            {types.BIND_PHASE_ANNO: types.BindPhase.FAILED.value},
        )
    except NotFoundError:
        pass
    nodelock.release_node(client, node_name)
