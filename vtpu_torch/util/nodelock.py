"""Annotation-based node mutex (the port's copy of vtpu/util/nodelock.py:
the device plugin releases the lock the scheduler's Bind took).

Reference: pkg/util/nodelock/nodelock.go — a cluster-wide per-node lock
implemented as a node annotation holding an RFC3339 timestamp, acquired with
a CAS retried 5 times (nodelock.go:18-47) and considered expired after 5
minutes (nodelock.go:94-102). The scheduler takes it in Bind before handing
the pod to kubelet; the device plugin releases it after Allocate succeeds or
fails — it serializes the (bind → allocate) critical section per node.
"""

from __future__ import annotations

import datetime
import logging
import time
from typing import Optional

from . import types
from .client import ConflictError, KubeClient

log = logging.getLogger(__name__)

MAX_RETRY = 5
LOCK_EXPIRE_S = 5 * 60.0  # nodelock.go:94-102
RETRY_DELAY_S = 0.1


class NodeLockedError(Exception):
    pass


def now_str(at: Optional[float] = None, precise: bool = False) -> str:
    """RFC3339 UTC stamp (the lock/lease wire form). `at` is an epoch
    override so lease holders driven by an injected clock (tests, chaos
    harness) write times their own expiry math can read back; `precise`
    emits microseconds (k8s MicroTime, coordination.k8s.io leases)."""
    dt = (datetime.datetime.now(datetime.timezone.utc) if at is None
          else datetime.datetime.fromtimestamp(at, datetime.timezone.utc))
    fmt = "%Y-%m-%dT%H:%M:%S.%fZ" if precise else "%Y-%m-%dT%H:%M:%SZ"
    return dt.strftime(fmt)


_now_str = now_str  # original private name, kept for in-module callers


def parse_lock_time(value: str) -> datetime.datetime:
    """Inverse of now_str; accepts both second- and microsecond-precision
    forms (the cluster lease writes MicroTime, nodes write seconds)."""
    fmt = "%Y-%m-%dT%H:%M:%S.%fZ" if "." in value else "%Y-%m-%dT%H:%M:%SZ"
    return datetime.datetime.strptime(value, fmt).replace(
        tzinfo=datetime.timezone.utc
    )


def _try_lock(client: KubeClient, node_name: str) -> None:
    node = client.get_node(node_name)
    annos = node.get("metadata", {}).get("annotations", {}) or {}
    existing = annos.get(types.NODE_LOCK_ANNO)
    if existing:
        held_for = (
            datetime.datetime.now(datetime.timezone.utc)
            - parse_lock_time(existing)
        ).total_seconds()
        if held_for < LOCK_EXPIRE_S:
            raise NodeLockedError(
                f"node {node_name} locked since {existing}"
            )
        # stale lock: steal it (reference resets expired locks,
        # nodelock.go:94-102)
        log.warning("node %s lock expired (%.0fs); stealing", node_name,
                    held_for)
    client.update_node_annotations_guarded(
        node_name,
        {types.NODE_LOCK_ANNO: _now_str()},
        node["metadata"]["resourceVersion"],
    )


def lock_node(client: KubeClient, node_name: str) -> None:
    """Acquire, retrying CAS conflicts up to MAX_RETRY times."""
    last: Optional[Exception] = None
    for i in range(MAX_RETRY):
        try:
            _try_lock(client, node_name)
            return
        except ConflictError as e:
            last = e
            time.sleep(RETRY_DELAY_S * (i + 1))
    raise NodeLockedError(f"lock {node_name} failed after retries: {last}")


def release_node(client: KubeClient, node_name: str) -> None:
    from .client import NotFoundError

    for i in range(MAX_RETRY):
        try:
            node = client.get_node(node_name)
            annos = node.get("metadata", {}).get("annotations", {}) or {}
            if types.NODE_LOCK_ANNO not in annos:
                return
            client.update_node_annotations_guarded(
                node_name,
                {types.NODE_LOCK_ANNO: None},
                node["metadata"]["resourceVersion"],
            )
            return
        except NotFoundError:
            # node deleted out from under us — nothing left to unlock
            log.warning("node %s vanished while releasing its lock",
                        node_name)
            return
        except ConflictError:
            time.sleep(RETRY_DELAY_S * (i + 1))
    log.error("release of node lock on %s failed after retries", node_name)
