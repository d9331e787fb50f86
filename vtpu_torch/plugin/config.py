"""Plugin configuration with per-node override file (the port of
vtpu/plugin/config.py:26-120).

Reference: cmd/device-plugin/nvidia/vgpucfg.go — CLI flags
`--device-split-count/--device-memory-scaling/--device-cores-scaling/
--disable-core-limit` (vgpucfg.go:15-54) overridden per node from a
ConfigMap-mounted /config/config.json (vgpucfg.go:81-107).
"""

from __future__ import annotations

import json
import logging
from dataclasses import dataclass, replace

from ..util import types

log = logging.getLogger(__name__)

DEFAULT_NODE_CONFIG_PATH = "/config/config.json"


@dataclass
class PluginConfig:
    resource_name: str = types.RESOURCE_GPU
    device_split_count: int = 10       # virtual replicas per card
    # <= 1.0 only. The reference supports >1 through libvgpu.so's host-RAM
    # swap (CUDA_OVERSUBSCRIBE, reference docs/config.md:9-10); the port's
    # interposer charges device memory and spills nothing (cuMemAllocManaged
    # is not charged yet), so advertising scaled memory would overcommit the
    # card. >1.0 is REJECTED at startup (validate()).
    device_memory_scaling: float = 1.0
    device_cores_scaling: float = 1.0
    disable_core_limit: bool = False
    # host dir holding libvgpu.so, ld.so.preload and the containers' region
    # files, mounted into containers
    shim_host_dir: str = "/usr/local/vgpu"
    socket_dir: str = "/var/lib/kubelet/device-plugins"
    # GetPreferredAllocation replica placement (the reference's
    # aligned/distributed policies, rm/allocate.go:30-123):
    #   "packed" — fill one card's replicas before the next
    #   "spread" — round-robin replicas across cards
    preferred_allocation_policy: str = "packed"

    def validate(self) -> "PluginConfig":
        if self.preferred_allocation_policy not in ("packed", "spread"):
            raise ValueError(
                "preferred_allocation_policy must be 'packed' or 'spread'")
        if self.device_memory_scaling > 1.0:
            raise ValueError(
                "device_memory_scaling > 1 (device-memory oversubscription) "
                "is not supported: libvgpu.so spills nothing to host memory, "
                "so the scaled memory would overcommit the card. Set "
                "device_memory_scaling <= 1.0.")
        if self.device_memory_scaling <= 0 or self.device_cores_scaling <= 0:
            raise ValueError("device scalings must be positive")
        if self.device_split_count < 1:
            raise ValueError("device_split_count must be >= 1")
        return self


def load_node_config(base: PluginConfig, node_name: str,
                     path: str = DEFAULT_NODE_CONFIG_PATH) -> PluginConfig:
    """Apply the per-node entry from the cluster config file, if present
    (mirrors readFromConfigFile, vgpucfg.go:81-107)."""
    try:
        with open(path) as f:
            data = json.load(f)
    except FileNotFoundError:
        return base
    except (OSError, json.JSONDecodeError) as e:
        log.error("node config %s unreadable: %s", path, e)
        return base
    for entry in data.get("nodeconfig", []):
        if entry.get("name") != node_name:
            continue
        out = replace(base)
        try:
            if "devicesplitcount" in entry:
                out.device_split_count = int(entry["devicesplitcount"])
            if "devicememoryscaling" in entry:
                out.device_memory_scaling = float(
                    entry["devicememoryscaling"])
            if "devicecorescaling" in entry:
                out.device_cores_scaling = float(entry["devicecorescaling"])
            if "disablecorelimit" in entry:
                out.disable_core_limit = bool(entry["disablecorelimit"])
            if "preferredallocationpolicy" in entry:
                out.preferred_allocation_policy = str(
                    entry["preferredallocationpolicy"])
        except (TypeError, ValueError) as e:
            # one bad field must not take the daemon down; keep CLI config
            log.error("node config entry for %s has a bad value (%s); "
                      "ignoring the override", node_name, e)
            return base
        out.validate()  # oversubscription etc. must fail LOUDLY, not run
        log.info("applied node config override for %s: %s", node_name, out)
        return out
    return base
