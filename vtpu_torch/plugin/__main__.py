"""vgpu-device-plugin main: ``python -m vtpu_torch.plugin``.

The port of cmd/device_plugin.py. Reference: cmd/device-plugin/nvidia/
main.go — flag surface (vgpucfg.go:15-54), kubelet-restart handling (the
plugin watches kubelet.sock itself and re-registers with backoff) and the
crash-loop breaker (plugin/server.go:171-199: more than 5 restarts within
an hour is fatal). The allocation checkpoint and the /healthz + /readyz
surface are built outside the restart loop, so both outlive a crashed
plugin incarnation.

The process enumerates the cards through NVML only (``VGPU_FAKE_NVML``
names a fixture instead) and never creates a CUDA context. In a cluster
(the in-cluster apiserver env set)::

    python -m vtpu_torch.plugin --node-name n1

and against a fixture of cards::

    VGPU_FAKE_NVML=cards.json python -m vtpu_torch.plugin --node-name n1 \\
        --socket-dir /tmp/dp --shim-host-dir /tmp/vgpu

Outside a cluster the apiserver client must be brought along:
:func:`main` takes a ``client`` (a ``FakeKubeClient``, for one).
"""

from __future__ import annotations

import argparse
import logging
import sys
import time
from typing import List, Optional

from .. import api
from ..util.client import KubeClient, get_client
from ..util.env import env_float, env_int, env_str
from ..util.health import DegradedState, start_health_server
from ..util.podcache import PodCache
from .checkpoint import AllocationCheckpoint, default_checkpoint_path
from .config import PluginConfig, load_node_config
from .nvml import HealthTrackingNvmlLib, detect
from .register import Registrar
from .server import GPUDevicePlugin, install_shim_artifacts

log = logging.getLogger("vtpu_torch.plugin.main")

MAX_RESTARTS = 5
RESTART_WINDOW_S = 3600.0
RESTART_DELAY_S = 5.0


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser("vgpu-device-plugin")
    p.add_argument("--node-name", default=env_str(api.ENV_NODE_NAME))
    p.add_argument("--resource-name", default=PluginConfig.resource_name)
    p.add_argument("--device-split-count", type=int,
                   default=PluginConfig.device_split_count)
    p.add_argument("--device-memory-scaling", type=float,
                   default=PluginConfig.device_memory_scaling)
    p.add_argument("--device-cores-scaling", type=float,
                   default=PluginConfig.device_cores_scaling)
    p.add_argument("--disable-core-limit", action="store_true")
    p.add_argument("--preferred-allocation-policy",
                   choices=["packed", "spread"],
                   default=PluginConfig.preferred_allocation_policy,
                   help="replica placement for GetPreferredAllocation "
                        "(reference aligned/distributed analog)")
    p.add_argument("--shim-host-dir", default=PluginConfig.shim_host_dir)
    p.add_argument("--socket-dir", default=PluginConfig.socket_dir)
    p.add_argument("--node-config-file", default="/config/config.json")
    p.add_argument("--checkpoint-path", default="",
                   help="durable allocation checkpoint "
                        "(default: VTPU_CHECKPOINT_PATH or "
                        "<shim-host-dir>/allocations.ckpt.json)")
    p.add_argument("--health-port", type=int,
                   default=env_int(api.ENV_PLUGIN_HEALTH_PORT, 9396),
                   help="/healthz + /readyz port (-1 = disabled)")
    p.add_argument("--health-bind",
                   default=env_str(api.ENV_PLUGIN_HEALTH_BIND, "127.0.0.1"))
    p.add_argument("-v", "--verbose", action="count", default=0)
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None,
         client: Optional[KubeClient] = None) -> None:
    """Run the node agent until interrupted. ``client`` replaces the
    in-cluster apiserver client (what ``util.client.set_client`` does for
    the process)."""
    args = parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose > 1
        else logging.INFO if args.verbose else logging.WARNING,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    if not args.node_name:
        sys.exit("--node-name or NODE_NAME required")

    config = PluginConfig(
        resource_name=args.resource_name,
        device_split_count=args.device_split_count,
        device_memory_scaling=args.device_memory_scaling,
        device_cores_scaling=args.device_cores_scaling,
        disable_core_limit=args.disable_core_limit,
        preferred_allocation_policy=args.preferred_allocation_policy,
        shim_host_dir=args.shim_host_dir,
        socket_dir=args.socket_dir,
    )
    config = load_node_config(config, args.node_name,
                              args.node_config_file)
    try:
        install_shim_artifacts(config.shim_host_dir)
    except OSError:
        # enforcement mounts will fail per-container with a clear error;
        # inventory/registration must still come up
        log.exception("installing shim artifacts into %s failed",
                      config.shim_host_dir)
    client = client if client is not None else get_client()
    # one shared health-tracking view: the server's 1 Hz loop and the
    # registrar's 30 s report agree on error-driven health and ghosts
    gpulib = HealthTrackingNvmlLib(
        detect(), recovery_s=env_float(api.ENV_HEALTH_RECOVERY_S, 60.0))

    # one watch-backed pod cache for every plugin incarnation: Allocate's
    # pending-pod lookup reads it instead of LISTing the node's pods per
    # call, and serves from its last view while the apiserver is dark
    pod_cache = PodCache(client, node_name=args.node_name).start()

    checkpoint = AllocationCheckpoint(
        args.checkpoint_path
        or default_checkpoint_path(config.shim_host_dir))
    degraded = DegradedState("device-plugin")
    start_health_server(degraded, args.health_port, args.health_bind)

    crashes: List[float] = []
    while True:
        plugin = GPUDevicePlugin(gpulib, config, client, args.node_name,
                                 pod_cache=pod_cache,
                                 checkpoint=checkpoint, degraded=degraded)
        registrar = Registrar(gpulib, plugin.rm, client, args.node_name,
                              degraded=degraded)
        try:
            plugin.start()
            registrar.start()
            while True:
                time.sleep(1.0)
        except KeyboardInterrupt:
            return
        except Exception:
            # crash-loop breaker (reference: server.go:171-199)
            now = time.time()
            crashes = [t for t in crashes if now - t < RESTART_WINDOW_S]
            crashes.append(now)
            if len(crashes) > MAX_RESTARTS:
                sys.exit("too many plugin crashes within an hour; giving up")
            log.exception("plugin crashed; restarting")
            time.sleep(RESTART_DELAY_S)
        finally:
            registrar.stop()
            plugin.stop()


if __name__ == "__main__":
    main()
