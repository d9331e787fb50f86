"""vgpu-monitor main: ``python -m vtpu_torch.monitor``.

The port of cmd/monitor.py (reference: cmd/vGPUmonitor/main.go:11-32).
Scrapes the per-container shared regions libvgpu.so writes into Prometheus
(:9394), serves ``/nodeinfo`` (:9395), runs the priority-feedback sweep and
GCs the region directories of vanished pods. It reads the cards through
NVML only (``VGPU_FAKE_NVML`` names a fixture instead) and never creates a
CUDA context. In a cluster (the in-cluster apiserver env set)::

    python -m vtpu_torch.monitor --node-name n1

and with no apiserver (metrics, feedback and /nodeinfo; no pod labels, no
GC)::

    python -m vtpu_torch.monitor --containers-dir D --no-kube

Outside a cluster :func:`main` takes a ``client`` (a ``FakeKubeClient``,
for one), as the device plugin's main does.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

from .. import api, trace
from ..plugin import nvml
from ..util.client import KubeClient, get_client
from ..util.env import env_str
from ..util.logsetup import setup as setup_logging
from .daemon import INFO_BIND, INFO_PORT, METRICS_PORT, MonitorDaemon


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser("vgpu-monitor")
    p.add_argument("--containers-dir", default=api.HOST_CONTAINERS_DIR,
                   help="host dir of the per-container region files (the "
                        "device plugin's <shim-host-dir>/containers)")
    p.add_argument("--metrics-port", type=int, default=METRICS_PORT)
    p.add_argument("--info-port", type=int, default=INFO_PORT,
                   help="node-info JSON API port (0 = disabled); the "
                        "reference's monitor gRPC port")
    p.add_argument("--info-bind", default=INFO_BIND,
                   help="node-info bind address; loopback by default — "
                        "the endpoint reports per-pod pids/limits/usage, "
                        "so expose it (0.0.0.0) only behind a "
                        "NetworkPolicy")
    p.add_argument("--sweep-interval", type=float, default=5.0)
    p.add_argument("--quarantine-after", type=int, default=0,
                   help="consecutive corrupt sweeps before a region "
                        "file is quarantined (0 = VTPU_QUARANTINE_AFTER "
                        "/ default 3)")
    p.add_argument("--node-name", default=env_str(api.ENV_NODE_NAME),
                   help="this node's name (for pod lookup + GC)")
    p.add_argument("--no-kube", action="store_true",
                   help="run without an apiserver (metrics only, no GC)")
    p.add_argument("-v", "--verbose", action="count", default=0)
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None,
         client: Optional[KubeClient] = None) -> None:
    """Run the monitor until interrupted. ``client`` replaces the
    in-cluster apiserver client; ``--no-kube`` runs without one."""
    args = parse_args(argv)
    setup_logging(args.verbose)
    trace.tracer.configure(process="monitor")
    if args.no_kube:
        client = None
    elif client is None:
        client = get_client()
    daemon = MonitorDaemon(
        args.containers_dir,
        gpulib=nvml.detect(),
        client=client,
        node_name=args.node_name,
        metrics_port=args.metrics_port,
        info_port=args.info_port,
        info_bind=args.info_bind,
        sweep_interval_s=args.sweep_interval,
    )
    if args.quarantine_after > 0:
        daemon.regions.quarantine_after = args.quarantine_after
    try:
        daemon.run()
    except KeyboardInterrupt:
        pass
    finally:
        daemon.stop()


if __name__ == "__main__":
    main()
