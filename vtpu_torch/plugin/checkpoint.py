"""Durable allocation checkpoint: the device plugin's crash memory (the
port's copy of vtpu/plugin/checkpoint.py; same file layout, version 1).

The plugin's ``Allocate()`` is a multi-step transaction against the
annotation bus: assemble a container's env/mounts/devices, consume that
container's slot from the pod annotation, repeat, then flip bind-phase
to success. Before this module, every step lived only in process
memory — a plugin SIGKILLed between the annotation erase and the gRPC
reply left kubelet retrying an Allocate the annotation could no longer
satisfy, failing the pod.

Now each container response is persisted BEFORE its annotation slot is
consumed, via the atomic write+fsync+rename helper
(:mod:`vtpu_torch.util.atomicio`, the only write path), so a
restarted plugin can answer kubelet's re-``Allocate`` idempotently:
the exact same envs, the exact same cache-dir mounts, no double-wiring. The file is versioned like ``shared_region.h`` — a
foreign layout is discarded loudly, never half-parsed.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Dict, List, Optional

from .. import api
from ..util import lockdebug
from ..util.atomicio import atomic_write_json, read_json
from ..util.env import env_float, env_str
from . import deviceplugin_pb2 as pb

log = logging.getLogger(__name__)

#: bump on any layout change; a mismatched file is dropped (the plugin
#: then serves first-time Allocates only — safe, just not crash-proof
#: for pods allocated under the old layout)
CHECKPOINT_VERSION = 1
CHECKPOINT_FILENAME = "allocations.ckpt.json"

#: completed records older than this are pruned at startup (kubelet's
#: own checkpoint outlives any Allocate replay window long before this)
CHECKPOINT_TTL_S = 86400.0


def default_checkpoint_path(shim_host_dir: str) -> str:
    return env_str(api.ENV_CHECKPOINT_PATH) or os.path.join(
        shim_host_dir, CHECKPOINT_FILENAME)


def response_to_record(resp: pb.ContainerAllocateResponse) -> Dict:
    """pb.ContainerAllocateResponse → JSON-serializable record."""
    return {
        "envs": dict(resp.envs),
        "mounts": [{"container_path": m.container_path,
                    "host_path": m.host_path,
                    "read_only": bool(m.read_only)} for m in resp.mounts],
        "devices": [{"container_path": d.container_path,
                     "host_path": d.host_path,
                     "permissions": d.permissions} for d in resp.devices],
    }


def record_to_response(rec: Dict) -> pb.ContainerAllocateResponse:
    return pb.ContainerAllocateResponse(
        envs=dict(rec.get("envs", {})),
        mounts=[pb.Mount(container_path=m["container_path"],
                         host_path=m["host_path"],
                         read_only=bool(m.get("read_only")))
                for m in rec.get("mounts", [])],
        devices=[pb.DeviceSpec(container_path=d["container_path"],
                               host_path=d["host_path"],
                               permissions=d.get("permissions", "rw"))
                 for d in rec.get("devices", [])],
    )


class AllocationCheckpoint:
    """Pod-uid-keyed store of issued container responses.

    Thread-safe (Allocate runs on gRPC worker threads); every mutation
    persists synchronously — the whole point is surviving a SIGKILL at
    any instruction boundary, so there is no write-behind window."""

    def __init__(self, path: str,
                 ttl_s: Optional[float] = None):
        self.path = path
        self.ttl_s = (env_float(api.ENV_CHECKPOINT_TTL_S, CHECKPOINT_TTL_S,
                                minimum=0.0)
                      if ttl_s is None else ttl_s)
        self._lock = lockdebug.lock("plugin.checkpoint")
        self._allocations: Dict[str, Dict] = {}
        self._write_failed_logged = False
        try:
            os.makedirs(os.path.dirname(os.path.abspath(path)),
                        exist_ok=True)
        except OSError as e:
            log.warning("cannot create checkpoint dir for %s: %s", path, e)
        self._load()
        self.prune()

    # -- persistence -------------------------------------------------------

    def _load(self) -> None:
        data = read_json(self.path)
        if data is None:
            return
        if not isinstance(data, dict) \
                or data.get("version") != CHECKPOINT_VERSION:
            log.warning(
                "checkpoint %s has foreign version %r (want %d); "
                "discarding — in-flight Allocate replays lose idempotent "
                "recovery for pods allocated under the old layout",
                self.path, data.get("version") if isinstance(data, dict)
                else "?", CHECKPOINT_VERSION)
            return
        allocs = data.get("allocations")
        if isinstance(allocs, dict):
            self._allocations = allocs
            log.info("restored allocation checkpoint %s (%d pod(s))",
                     self.path, len(allocs))

    def _persist_locked(self) -> None:
        try:
            atomic_write_json(self.path, {
                "version": CHECKPOINT_VERSION,
                "allocations": self._allocations,
            })
            self._write_failed_logged = False
        except OSError as e:
            # an unwritable checkpoint must not fail Allocate itself —
            # but crash-safety is silently off, so say it loudly once
            if not self._write_failed_logged:
                self._write_failed_logged = True
                log.warning("cannot persist allocation checkpoint %s: %s "
                            "(Allocate keeps working; crash recovery is "
                            "OFF until the write path recovers)",
                            self.path, e)

    # -- reads -------------------------------------------------------------

    def pod_record(self, pod_uid: str) -> Optional[Dict]:
        with self._lock:
            rec = self._allocations.get(pod_uid)
            return dict(rec) if rec is not None else None

    def recorded_containers(self, pod_uid: str) -> List[Dict]:
        rec = self.pod_record(pod_uid)
        return list(rec.get("containers", [])) if rec else []

    def __len__(self) -> int:
        with self._lock:
            return len(self._allocations)

    # -- writes ------------------------------------------------------------

    def record_container(self, pod_uid: str, pod_key: str, index: int,
                         record: Dict, assigned_time: str = "",
                         host_mem_mb: int = 0) -> None:
        """Persist container ``index``'s response record. Idempotent:
        re-recording an existing index with identical content is a
        no-op; a same-index conflict (should never happen) is replaced
        and logged. ``assigned_time`` is the pod's ASSIGNED_TIME
        annotation at record time — the assignment GENERATION: a replay
        is only valid against the same assignment (a failed pod gets
        re-scheduled under the same uid with different devices, and
        replaying the old wiring then would double-allocate chips).
        ``host_mem_mb`` is the pod's vtpu.io/host-memory reservation at
        record time — stored on the pod record so a replayed Allocate's
        CUDA_HOST_MEMORY_LIMIT env is auditable against the durable
        reservation (the env itself replays verbatim from the record)."""
        with self._lock:
            rec = self._allocations.setdefault(pod_uid, {
                "pod_key": pod_key, "containers": [],
                "complete": False, "converged": False,
                "assigned_time": assigned_time, "time_s": time.time(),
            })
            if host_mem_mb and not rec.get("host_mem_mb"):
                rec["host_mem_mb"] = host_mem_mb
            ctrs = rec["containers"]
            if index < len(ctrs):
                if ctrs[index] == record:
                    return
                log.warning("checkpoint %s: container %d re-recorded "
                            "with different content", pod_key, index)
                ctrs[index] = record
            elif index == len(ctrs):
                ctrs.append(record)
            else:
                # gaps cannot happen (Allocate walks containers in
                # order); refuse to fabricate one
                raise ValueError(
                    f"checkpoint {pod_key}: container index {index} "
                    f"beyond recorded {len(ctrs)}")
            self._persist_locked()

    def mark_complete(self, pod_uid: str) -> None:
        with self._lock:
            rec = self._allocations.get(pod_uid)
            if rec is None or rec.get("complete"):
                return
            rec["complete"] = True
            rec["time_s"] = time.time()
            self._persist_locked()

    def mark_converged(self, pod_uid: str) -> None:
        """The annotation bus reached its end state for this pod (slots
        consumed, bind-phase success). Unconverged-but-complete records
        are what a degraded Allocate (apiserver unreachable) leaves
        behind; the plugin's reconcile loop drains them — durably, so
        a restart mid-outage does not lose the debt."""
        with self._lock:
            rec = self._allocations.get(pod_uid)
            if rec is None or rec.get("converged"):
                return
            rec["converged"] = True
            self._persist_locked()

    def unconverged(self) -> List[Dict]:
        """Complete records whose annotation convergence is still owed
        (each returned dict carries pod_uid/pod_key/containers/
        assigned_time)."""
        with self._lock:
            out = []
            for uid, rec in self._allocations.items():
                if rec.get("complete") and not rec.get("converged", True):
                    out.append(dict(rec, pod_uid=uid))
            return out

    def forget(self, pod_uid: str) -> None:
        with self._lock:
            if self._allocations.pop(pod_uid, None) is not None:
                self._persist_locked()

    def prune(self, now: Optional[float] = None) -> int:
        """Drop completed records older than ttl_s. Incomplete records
        are kept regardless of age: they are exactly the crash evidence
        a restarted plugin needs."""
        if self.ttl_s <= 0:
            return 0
        now = time.time() if now is None else now
        dropped = 0
        with self._lock:
            for uid in list(self._allocations):
                rec = self._allocations[uid]
                if rec.get("complete") \
                        and now - rec.get("time_s", 0.0) > self.ttl_s:
                    del self._allocations[uid]
                    dropped += 1
            if dropped:
                self._persist_locked()
        if dropped:
            log.info("pruned %d expired checkpoint record(s)", dropped)
        return dropped
