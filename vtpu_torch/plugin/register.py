"""Annotation registrar: the plugin side of the node handshake (the port of
vtpu/plugin/register.py:81-144).

Reference: pkg/device-plugin/nvidiadevice/nvinternal/plugin/register.go —
every 30s (register.go:122-133) the plugin re-encodes its card inventory
(x memory/cores scaling, register.go:55-100) into the node-register
annotation and stamps the handshake "Reported <time>". The keys are this
vendor's own pair (vtpu.io/node-handshake-nvidia, vtpu.io/node-nvidia-
register), so a scheduler that serves TPU nodes too tells the two apart.
"""

from __future__ import annotations

import logging
import threading
import time

from .. import api
from ..util import codec, types
from ..util.client import KubeClient
from ..util.env import env_int
from .nvml import GpuLib
from .rm import ResourceManager

log = logging.getLogger(__name__)

REPORT_INTERVAL_S = 30.0  # register.go:129-132

#: fraction of MemTotal reported as schedulable host memory when the
#: operator sets no explicit capacity: the kernel, the kubelet and other
#: pods need RAM too
HOST_MEM_DEFAULT_FRACTION = 0.8


def host_mem_capacity_mb(meminfo_path: str = "/proc/meminfo") -> int:
    """The node's schedulable host-RAM capacity in MB, reported in
    NODE_HOST_MEM_ANNO for the scheduler's node-level host-memory axis.
    VTPU_HOST_MEM_CAPACITY_MB overrides; otherwise 80% of MemTotal. 0
    (unreadable meminfo and no override) = no axis reported."""
    override = env_int(api.ENV_HOST_MEM_CAPACITY_MB, -1)
    if override >= 0:
        return override
    try:
        with open(meminfo_path, "r", encoding="ascii") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    kb = int(line.split()[1])
                    return int(kb // 1024 * HOST_MEM_DEFAULT_FRACTION)
    except (OSError, ValueError, IndexError) as e:
        log.warning("cannot read %s (%s); node reports no host-memory "
                    "capacity (legacy-unlimited)", meminfo_path, e)
    return 0


class Registrar:
    def __init__(self, gpulib: GpuLib, rm: ResourceManager,
                 client: KubeClient, node_name: str,
                 degraded=None) -> None:
        self.gpulib = gpulib
        self.rm = rm
        self.client = client
        self.node_name = node_name
        # optional DegradedState: a node that cannot publish its inventory
        # is invisible to the scheduler — loud degradation
        self.degraded = degraded
        self._failures = 0
        self._stop = threading.Event()

    def register_once(self) -> None:
        chips = self.gpulib.enumerate()
        devices = self.rm.register_devices(chips)
        encoded = codec.encode_node_devices(devices)
        annos = {
            types.HANDSHAKE_ANNO: f"Reported {time.time():.0f}",
            types.NODE_REGISTER_ANNO: encoded,
            # always written, and empty: a GPU node is in no multi-host TPU
            # slice, and must not keep a stale membership the scheduler's
            # slice solver would read (the JAX registrar writes it so too)
            types.NODE_SLICE_ANNO: "",
            types.NODE_HOST_MEM_ANNO: str(host_mem_capacity_mb()),
        }
        self.client.patch_node_annotations(self.node_name, annos)
        log.debug("registered %d cards on %s", len(devices), self.node_name)

    #: consecutive failed reports before the node-register degradation is
    #: raised: one blip inside a 30s cadence is noise, three is an outage
    DEGRADE_AFTER = 3

    def loop(self) -> None:
        while True:
            try:
                self.register_once()
                self._failures = 0
                if self.degraded is not None:
                    self.degraded.clear("node_register_failing")
            except Exception as e:
                self._failures += 1
                log.exception("node registration failed")
                if self.degraded is not None \
                        and self._failures >= self.DEGRADE_AFTER:
                    self.degraded.set(
                        "node_register_failing",
                        f"{self._failures} consecutive failures: {e}")
            if self._stop.wait(REPORT_INTERVAL_S):
                return

    def start(self) -> threading.Thread:
        t = threading.Thread(target=self.loop, daemon=True)
        t.start()
        return t

    def stop(self) -> None:
        self._stop.set()
