"""In-memory node → devices registry.

The port's copy of vtpu/scheduler/nodes.py.

Reference: pkg/scheduler/nodes.go — `nodeManager` guarding a map of node name
to device inventory (nodes.go:52-114).

When constructed with a `UsageOverlay`, inventory changes are written
through so the overlay's `snapshot()` always reflects the registered
device set (overlay.py module docstring has the invariant).
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ..util import lockdebug
from ..util.types import DeviceInfo, MeshCoord, NodeInfo
from .overlay import UsageOverlay


class NodeManager:
    def __init__(self, overlay: Optional[UsageOverlay] = None) -> None:
        self._lock = lockdebug.rlock("scheduler.nodes")
        self._nodes: Dict[str, NodeInfo] = {}
        self._overlay = overlay

    def add_node(self, node_id: str, devices: List[DeviceInfo],
                 slice_name: str = "",
                 host_coord: Optional[MeshCoord] = None,
                 host_mem_mb: int = 0) -> None:
        with self._lock:
            self._nodes[node_id] = NodeInfo(
                id=node_id, devices=list(devices),
                slice_name=slice_name, host_coord=host_coord,
                host_mem_mb=host_mem_mb)
            if self._overlay is not None:
                self._overlay.set_node_inventory(node_id, devices,
                                                 host_mem_mb=host_mem_mb)

    def rm_node_devices(self, node_id: str) -> None:
        with self._lock:
            self._nodes.pop(node_id, None)
            if self._overlay is not None:
                self._overlay.drop_node_inventory(node_id)

    def get_node(self, node_id: str) -> Optional[NodeInfo]:
        with self._lock:
            return self._nodes.get(node_id)

    def list_nodes(self) -> Dict[str, NodeInfo]:
        with self._lock:
            return dict(self._nodes)
