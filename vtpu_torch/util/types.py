"""Shared wire types and annotation vocabulary of the port's node agent.

The port's copy of vtpu/util/types.py: the same dataclasses with the same
field names and defaults, under the NVIDIA vendor tag. The annotation keys
and resource names are declared in :mod:`vtpu_torch.api` and re-exported
here for the import sites that mirror the JAX package's.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from ..api import (  # noqa: F401  (re-exported vocabulary)
    ASSIGNED_IDS_ANNO,
    ASSIGNED_NODE_ANNO,
    ASSIGNED_TIME_ANNO,
    BIND_PHASE_ANNO,
    BIND_TIME_ANNO,
    DOMAIN,
    HANDSHAKE_ANNO,
    HBM_LIMIT_ANNO,
    HOST_MEM_ANNO,
    MIGRATE_DEADLINE_ANNO,
    MIGRATED_FROM_ANNO,
    MIGRATING_TO_ANNO,
    MIGRATION_CANDIDATE_ANNO,
    NODE_HOST_MEM_ANNO,
    NODE_LOCK_ANNO,
    NODE_REGISTER_ANNO,
    NODE_SLICE_ANNO,
    NOUSE_GPUTYPE_ANNO,
    NUMA_BIND_ANNO,
    NVIDIA_DOMAIN,
    PREEMPTED_BY_ANNO,
    RESOURCE_CORES,
    RESOURCE_GPU,
    RESOURCE_HOST_MEM,
    RESOURCE_MEM,
    RESOURCE_MEM_PERCENT,
    RESOURCE_PRIORITY,
    SCHED_GEN_ANNO,
    SLICE_BLOCK_ANNO,
    SLICE_GROUP_ANNO,
    SLICE_HOSTS_ANNO,
    TASK_PRIORITY_ANNO,
    TASK_PRIORITY_DEFAULT,
    TASK_PRIORITY_HIGH,
    TO_ALLOCATE_ANNO,
    TRACE_ID_ANNO,
    USE_GPUTYPE_ANNO,
)


class BindPhase(str, enum.Enum):
    """Pod bind-phase state machine (reference: pkg/util/types.go:39-43)."""

    ALLOCATING = "allocating"
    SUCCESS = "success"
    FAILED = "failed"


#: the vendor tag of every card this node agent reports and every assignment
#: it serves (reference: nvidia/device.go NvidiaGPUDevice)
GPU_VENDOR = "NVIDIA"

# Handshake staleness after which a node's devices are evicted from the
# scheduler inventory (reference: pkg/scheduler/scheduler.go:158-179, 60s).
HANDSHAKE_TIMEOUT_S = 60.0


@dataclass(frozen=True, order=True)
class MeshCoord:
    """Position of a device in an interconnect mesh (the register
    annotation's ``x-y-z`` field). NVML reports no such coordinate, so a
    card's is always None; the type stays so the wire grammar is the JAX
    package's."""

    x: int = 0
    y: int = 0
    z: int = 0

    def encode(self) -> str:
        return f"{self.x}-{self.y}-{self.z}"

    @staticmethod
    def decode(s: str) -> Optional["MeshCoord"]:
        if not s or s == "*":
            return None
        parts = s.split("-")
        if len(parts) != 3:
            raise ValueError(f"bad mesh coord {s!r}")
        return MeshCoord(int(parts[0]), int(parts[1]), int(parts[2]))

    def as_tuple(self) -> Tuple[int, int, int]:
        return (self.x, self.y, self.z)


@dataclass
class ContainerDeviceRequest:
    """What one container asks for, synthesized from resource limits by the
    vendor backend (reference: ContainerDeviceRequest types.go:85-91,
    filled in pkg/device/nvidia/device.go:114-175)."""

    nums: int = 0
    type: str = GPU_VENDOR
    memreq: int = 0          # device memory MB per card; 0 = whole card
    mem_percentage: int = 0  # percent of the card's memory, when memreq == 0
    coresreq: int = 0        # SM percent per card


@dataclass
class ContainerDevice:
    """One assigned (card uuid, quota) pair (reference: types.go:93-97)."""

    uuid: str = ""
    type: str = GPU_VENDOR
    usedmem: int = 0         # device memory MB
    usedcores: int = 0       # SM percent


# per-pod assignment: one list of ContainerDevice per container
ContainerDevices = List[ContainerDevice]
PodDevices = List[ContainerDevices]


@dataclass
class DeviceInfo:
    """One physical card as registered by a node plugin
    (reference: pkg/api/device_register.go:13-22)."""

    id: str = ""
    index: int = 0
    count: int = 0           # virtual replica count (split-count)
    devmem: int = 0          # total device memory MB
    devcore: int = 100       # total SM percent (scaled)
    type: str = GPU_VENDOR
    numa: int = 0
    mesh: Optional[MeshCoord] = None
    health: bool = True


@dataclass
class DeviceUsage:
    """Scheduler-side live view of one card: inventory overlaid with the sum
    of scheduled pods' quotas (reference: types.go:104-115)."""

    id: str = ""
    index: int = 0
    used: int = 0            # tasks sharing the card
    count: int = 0
    usedmem: int = 0
    totalmem: int = 0
    usedcores: int = 0
    totalcores: int = 0
    numa: int = 0
    mesh: Optional[MeshCoord] = None
    type: str = GPU_VENDOR
    health: bool = True


@dataclass
class NodeInfo:
    """Scheduler registry entry for a node (reference:
    pkg/scheduler/nodes.go:28-43)."""

    id: str = ""
    devices: List[DeviceInfo] = field(default_factory=list)
    slice_name: str = ""
    host_coord: Optional[MeshCoord] = None
    host_mem_mb: int = 0
