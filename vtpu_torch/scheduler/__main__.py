"""vtpu-scheduler main: ``python -m vtpu_torch.scheduler``.

The port of cmd/scheduler.py:56-221 (reference: cmd/scheduler/main.go:
48-93). Runs the extender and webhook HTTP(S) endpoints (``/filter``,
``/bind``, ``/webhook``, ``/healthz``, ``/readyz``, ``/trace/{ns}/{name}``,
``/debug/traces``), the node-registration poll, the pod watch and the
Prometheus endpoint, after the startup crash-recovery rebuild
(Scheduler.recover) every deployment gets. A host program: it imports
neither ``torch`` nor ``vtpu`` and holds no CUDA context. In a cluster
(the in-cluster apiserver env set)::

    python -m vtpu_torch.scheduler

and with an in-memory apiserver (no cluster)::

    python -m vtpu_torch.scheduler --fake-kube --http-bind 127.0.0.1:9443

Outside a cluster :func:`main` also takes a ``client`` (a
``FakeKubeClient``, for one), as the device plugin's and the monitor's
mains do. The leader-elected pair (``--ha``, ``--lease-*``), the
rebalancer (``VTPU_REBALANCE_S``) and the migration planner
(``VTPU_MIGRATE_S``) are not ported yet (ROADMAP item 14): argparse
rejects the flags, and a period above 0 exits non-zero.
"""

from __future__ import annotations

import argparse
import ssl
import sys
import threading
from typing import List, Optional

from aiohttp import web
from prometheus_client import REGISTRY, start_http_server

from .. import api, device, trace
from ..device.config import GLOBAL
from ..util.client import FakeKubeClient, KubeClient, get_client
from ..util.env import env_float
from ..util.logsetup import setup as setup_logging
from .core import Scheduler
from .metrics import SchedulerCollector
from .routes import build_app


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(api.SCHEDULER_NAME)
    p.add_argument("--http-bind", default="0.0.0.0:9443",
                   help="extender/webhook listen address")
    p.add_argument("--cert-file", default="", help="TLS cert for webhook")
    p.add_argument("--key-file", default="", help="TLS key for webhook")
    p.add_argument("--scheduler-name", default=GLOBAL.scheduler_name)
    p.add_argument("--default-mem", type=int, default=GLOBAL.default_mem,
                   help="default device memory MB per vGPU (0 = whole "
                        "card)")
    p.add_argument("--default-cores", type=int,
                   default=GLOBAL.default_cores,
                   help="default SM %% per vGPU (0 = fit anywhere)")
    p.add_argument("--metrics-bind", default="0.0.0.0:9395")
    p.add_argument("--fake-kube", action="store_true",
                   help="in-memory apiserver (dev/demo; no cluster)")
    p.add_argument("-v", "--verbose", action="count", default=0)
    return p.parse_args(argv)


def refuse_unported_loops() -> None:
    """The rebalancer and the migration planner are ROADMAP item 14: a
    deployment that turns either on must not run without it unnoticed."""
    for knob in (api.ENV_REBALANCE_S, api.ENV_MIGRATE_S):
        if env_float(knob, 0.0, minimum=0.0) > 0:
            sys.exit(f"{knob} > 0 asks for a loop vtpu_torch.scheduler "
                     f"does not have yet (the rebalancer and the "
                     f"migration planner are ROADMAP item 14); unset it")


def main(argv: Optional[List[str]] = None,
         client: Optional[KubeClient] = None) -> None:
    """Serve until interrupted. ``client`` replaces the in-cluster
    apiserver client (and ``--fake-kube``'s in-memory one)."""
    args = parse_args(argv)
    refuse_unported_loops()
    setup_logging(args.verbose)
    trace.tracer.configure(process="scheduler")
    GLOBAL.scheduler_name = args.scheduler_name
    GLOBAL.default_mem = args.default_mem
    GLOBAL.default_cores = args.default_cores
    device.init_default_devices()

    if client is None:
        client = FakeKubeClient() if args.fake_kube else get_client()
    sched = Scheduler(client)
    sched.recover()
    threading.Thread(target=sched.registration_loop, daemon=True).start()
    threading.Thread(target=sched.pod_watch_loop, daemon=True).start()

    REGISTRY.register(SchedulerCollector(sched))
    mhost, mport = args.metrics_bind.rsplit(":", 1)
    start_http_server(int(mport), addr=mhost)

    host, port = args.http_bind.rsplit(":", 1)
    ssl_ctx = None
    if args.cert_file and args.key_file:
        ssl_ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ssl_ctx.load_cert_chain(args.cert_file, args.key_file)
    try:
        # signal handlers can only be set from the main thread; a caller
        # that serves from another thread stops the process instead
        web.run_app(build_app(sched), host=host, port=int(port),
                    ssl_context=ssl_ctx,
                    handle_signals=(threading.current_thread()
                                    is threading.main_thread()))
    finally:
        sched.stop()


if __name__ == "__main__":
    main()
