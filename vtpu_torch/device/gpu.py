"""NVIDIA GPU vendor backend.

The reference's NVIDIA vendor (pkg/device/nvidia/device.go:49-175) on the
skeleton of the JAX package's TPU vendor (vtpu/device/tpu/__init__.py:49-187),
so the two answer the same container spec alike under their own names:
``nvidia.com/gpu``/``gpumem``/``gpumem-percentage``/``gpucores``/``priority``
for ``google.com/tpu*``, ``nvidia.com/use-gputype``/``nouse-gputype`` for
the TPU's type constraints and ``nvidia.com/numa-bind`` for its ``ici-bind``.
Card types are strings like ``"NVIDIA-NVIDIA H100 80GB HBM3"`` as the node
plugin's NVML enumeration reports them.

It is the scheduler's side of the port (the request the device plugin
later serves); the plugin itself does not use it.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

from .. import api
from ..util import types
from . import Devices, config


_QUANTITY_SUFFIX = {
    "k": 10**3, "M": 10**6, "G": 10**9, "T": 10**12, "P": 10**15,
    "Ki": 2**10, "Mi": 2**20, "Gi": 2**30, "Ti": 2**40, "Pi": 2**50,
}


def parse_quantity(v: Any) -> int:
    """Kubernetes resource.Quantity → integer scalar (the reference calls
    Quantity.Value()). The mem resource is defined in MB, so plain integers
    are the expected form; suffixes are honored numerically."""
    s = str(v).strip()
    for suffix in sorted(_QUANTITY_SUFFIX, key=len, reverse=True):
        if s.endswith(suffix):
            return int(float(s[: -len(suffix)]) * _QUANTITY_SUFFIX[suffix])
    return int(float(s))


def _res_int(container: Dict[str, Any], name: str) -> int:
    """One integer resource from limits, falling back to requests."""
    spec = container.get("resources", {}) or {}
    for sect in ("limits", "requests"):
        v = (spec.get(sect) or {}).get(name)
        if v is not None:
            return parse_quantity(v)
    return 0


def _declares(container: Dict[str, Any], name: str) -> bool:
    spec = container.get("resources", {}) or {}
    return any(name in (spec.get(sect) or {})
               for sect in ("limits", "requests"))


class GPUDevices(Devices):
    vendor = types.GPU_VENDOR
    handshake_anno = types.HANDSHAKE_ANNO
    register_anno = types.NODE_REGISTER_ANNO
    # exactly the annos check_type reads (the scheduler's verdict-cache key)
    scheduling_annos = (types.NUMA_BIND_ANNO, types.USE_GPUTYPE_ANNO,
                        types.NOUSE_GPUTYPE_ANNO)

    def __init__(
        self,
        resource_count_name: str = types.RESOURCE_GPU,
        resource_mem_name: str = types.RESOURCE_MEM,
        resource_mem_percentage_name: str = types.RESOURCE_MEM_PERCENT,
        resource_cores_name: str = types.RESOURCE_CORES,
        resource_priority_name: str = types.RESOURCE_PRIORITY,
        resource_host_mem_name: str = types.RESOURCE_HOST_MEM,
    ) -> None:
        self.resource_count_name = resource_count_name
        self.resource_mem_name = resource_mem_name
        self.resource_mem_percentage_name = resource_mem_percentage_name
        self.resource_cores_name = resource_cores_name
        self.resource_priority_name = resource_priority_name
        self.resource_host_mem_name = resource_host_mem_name

    # -- admission --------------------------------------------------------
    def mutate_admission(self, container: Dict[str, Any],
                         pod: Dict[str, Any]) -> bool:
        """True iff the container asks for vGPUs; injects the
        CUDA_TASK_PRIORITY env libvgpu.so reads (nvidia/device.go:49-60)."""
        if _res_int(container, self.resource_count_name) == 0:
            return False
        # priority 0 means HIGH and must still be injected, so test for the
        # resource's presence, not its value
        if _declares(container, self.resource_priority_name):
            try:
                prio = _res_int(container, self.resource_priority_name)
            except (ValueError, TypeError):
                # malformed quantity: inject nothing, and the webhook's
                # priority validation denies the pod
                prio = None
            envs = container.setdefault("env", [])
            if prio is not None and not any(
                    e.get("name") == api.ENV_TASK_PRIORITY for e in envs):
                envs.append({"name": api.ENV_TASK_PRIORITY,
                             "value": str(prio)})
        return True

    def container_host_mem_mb(self, container: Dict[str, Any]) -> int:
        """Host-memory MB from the nvidia.com/gpuhostmem resource, summed
        pod-wide by the webhook into vtpu.io/host-memory."""
        return _res_int(container, self.resource_host_mem_name)

    def container_task_priority(self, container: Dict[str, Any]):
        """Task priority from the nvidia.com/priority resource (0 =
        guaranteed/high); None when the resource is absent."""
        if not _declares(container, self.resource_priority_name):
            return None
        return _res_int(container, self.resource_priority_name)

    # -- scheduling -------------------------------------------------------
    def check_type(
        self,
        annos: Dict[str, str],
        device: types.DeviceUsage,
        request: types.ContainerDeviceRequest,
    ) -> Tuple[bool, bool]:
        """(card type acceptable, numa-bind asserted): use-gputype lists
        the acceptable types and nouse-gputype the refused ones, each a
        comma-separated list of case-insensitive substrings of the card
        type (reference checkGPUtype, nvidia/device.go:62-105)."""
        if request.type != self.vendor:
            return False, False
        numa_assert = annos.get(types.NUMA_BIND_ANNO, "").lower() == "true"
        use = annos.get(types.USE_GPUTYPE_ANNO)
        nouse = annos.get(types.NOUSE_GPUTYPE_ANNO)
        ok = True
        if use:
            ok = any(
                t.strip().lower() in device.type.lower()
                for t in use.split(",") if t.strip()
            )
        if ok and nouse:
            ok = not any(
                t.strip().lower() in device.type.lower()
                for t in nouse.split(",") if t.strip()
            )
        return ok, numa_assert

    # -- request synthesis ------------------------------------------------
    def generate_resource_requests(
        self, container: Dict[str, Any]
    ) -> types.ContainerDeviceRequest:
        """nvidia/device.go:114-175: the count drives everything; absent
        mem → default_mem, or the whole card as percentage 100 when that
        is 0; absent cores → default_cores."""
        count = _res_int(container, self.resource_count_name)
        mem = _res_int(container, self.resource_mem_name)
        mem_pct = _res_int(container, self.resource_mem_percentage_name)
        cores = _res_int(container, self.resource_cores_name)

        if count == 0 and (mem or mem_pct or cores):
            # quota without an explicit count: one device, as the JAX
            # vendor does
            count = config.GLOBAL.default_replicas
        if count == 0:
            return types.ContainerDeviceRequest(nums=0)

        if mem == 0:
            if config.GLOBAL.default_mem:
                mem = config.GLOBAL.default_mem
            elif mem_pct == 0:
                mem_pct = 100  # whole card (nvidia/device.go:147-150)
        if cores == 0:
            cores = config.GLOBAL.default_cores

        return types.ContainerDeviceRequest(
            nums=count,
            type=self.vendor,
            memreq=mem,
            mem_percentage=mem_pct,
            coresreq=cores,
        )
