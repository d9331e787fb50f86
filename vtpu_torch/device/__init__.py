"""Device vendor abstraction + registry (the port's copy of
vtpu/device/__init__.py:17-112).

Reference: pkg/device/devices.go — the `Devices` interface (devices.go:20-25)
that every vendor implements, the vendor registry filled at init
(devices.go:43-52), and the handshake-annotation map `KnownDevice`
(devices.go:27-33). The scheduler and webhook fan out over a registry and
never name a vendor directly; adding a vendor is registering one object.
:class:`vtpu_torch.device.gpu.GPUDevices` is the port's vendor: the request
the device plugin later serves is defined by it.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from ..util import types


class Devices:
    """Vendor plug-in point (reference: devices.go:20-25)."""

    #: vendor tag matching DeviceInfo.type prefixes, e.g. "NVIDIA"
    vendor: str = ""
    #: node-handshake annotation key → register annotation key
    handshake_anno: str = ""
    register_anno: str = ""
    #: every pod-annotation key this vendor's check_type reads; part of
    #: the scheduler's scoring-verdict cache key
    scheduling_annos: Tuple[str, ...] = ()

    def mutate_admission(self, container: Dict[str, Any],
                         pod: Dict[str, Any]) -> bool:
        """Inspect/modify one container at admission; return True when the
        container requests this vendor's resources
        (reference: nvidia/device.go:49-60)."""
        raise NotImplementedError

    def check_type(
        self,
        annos: Dict[str, str],
        device: types.DeviceUsage,
        request: types.ContainerDeviceRequest,
    ) -> Tuple[bool, bool]:
        """(device type acceptable for this request, locality-bind asserted)
        (reference: nvidia/device.go:107-112 + score.go:71-84). The verdict
        may depend only on `annos`, `request` and `device.type`: the
        scheduler memoizes one call per distinct device type per node."""
        raise NotImplementedError

    def generate_resource_requests(
        self, container: Dict[str, Any]
    ) -> types.ContainerDeviceRequest:
        """Resource limits/requests → one ContainerDeviceRequest
        (reference: nvidia/device.go:114-175)."""
        raise NotImplementedError

    def container_host_mem_mb(self, container: Dict[str, Any]) -> int:
        """Host-memory MB this container declares via the vendor's
        resource name; 0 when the vendor has no host-memory dimension."""
        return 0

    def container_task_priority(
        self, container: Dict[str, Any]
    ) -> "int | None":
        """Task priority this container declares via the vendor's
        priority resource (0 = guaranteed/high); None when absent."""
        return None


_registry: Dict[str, Devices] = {}

#: handshake anno → register anno, consulted by a scheduler's node poll
#: (reference: KnownDevice, devices.go:27-33)
known_devices: Dict[str, str] = {}


def register(dev: Devices) -> None:
    _registry[dev.vendor] = dev
    if dev.handshake_anno:
        known_devices[dev.handshake_anno] = dev.register_anno


def get(vendor: str) -> Optional[Devices]:
    return _registry.get(vendor)


def all_devices() -> List[Devices]:
    return list(_registry.values())


def reset_registry() -> None:
    """Test hook."""
    _registry.clear()
    known_devices.clear()


def init_default_devices(config: Optional[Dict[str, Any]] = None) -> None:
    """Register the built-in vendor (reference: devices.go:43-52)."""
    from .gpu import GPUDevices  # local import to avoid cycle

    reset_registry()
    register(GPUDevices(**(config or {})))
