"""Resource manager: physical cards → virtual device replicas (the port of
vtpu/plugin/rm.py, the same replica ids).

Reference: pkg/device-plugin/nvidiadevice/nvinternal/rm/devices.go:144-166 —
each physical device is advertised to kubelet `DeviceSplitCount` times so
kubelet's integer accounting allows N pods per card; the *real* quota
assignment rides pod annotations, not the replica IDs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

from ..util.types import DeviceInfo
from . import deviceplugin_pb2 as pb
from .config import PluginConfig
from .nvml import ChipInfo


def replica_id(uuid: str, i: int) -> str:
    return f"{uuid}::{i}"


def parse_replica_id(rid: str) -> str:
    """Replica ID → physical card uuid."""
    return rid.rsplit("::", 1)[0]


@dataclass
class ResourceManager:
    config: PluginConfig

    def kubelet_devices(self, chips: List[ChipInfo]) -> List[pb.Device]:
        """The replica-expanded device list for ListAndWatch."""
        out: List[pb.Device] = []
        for chip in chips:
            health = "Healthy" if chip.health else "Unhealthy"
            topo = pb.TopologyInfo(nodes=[pb.NUMANode(ID=chip.numa)])
            for i in range(self.config.device_split_count):
                out.append(
                    pb.Device(ID=replica_id(chip.uuid, i), health=health,
                              topology=topo)
                )
        return out

    def register_devices(self, chips: List[ChipInfo]) -> List[DeviceInfo]:
        """The scheduler-facing inventory with scaling applied
        (reference: register.go:55-100 — devmem = NVML total MiB x
        DeviceMemoryScaling, devcore = DeviceCoresScaling x 100)."""
        return [
            DeviceInfo(
                id=chip.uuid,
                index=chip.index,
                count=self.config.device_split_count,
                devmem=int(chip.hbm_mb * self.config.device_memory_scaling),
                devcore=int(100 * self.config.device_cores_scaling),
                type=chip.type,
                numa=chip.numa,
                mesh=chip.mesh,
                health=chip.health,
            )
            for chip in chips
        ]

    @staticmethod
    def chips_by_uuid(chips: List[ChipInfo]) -> Dict[str, ChipInfo]:
        return {c.uuid: c for c in chips}
