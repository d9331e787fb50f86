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
mains do.

``--ha`` joins the leader-elected pair (docs/ha.md): one lease
(``--lease-name``, ``--lease-namespace``, ``VTPU_LEASE_EXPIRE_S``) and an
:class:`~vtpu_torch.ha.HACoordinator` whose promotion rebuilds gang state
before the role flips; with ``VTPU_SHARD_GROUPS`` above 1 it is a
multi-active :class:`~vtpu_torch.ha.GroupCoordinator`, one lease per shard
group (``VTPU_SCHEDULER_PEERS``, ``VTPU_SCHEDULER_ORDINAL``). A period above
0 in ``VTPU_REBALANCE_S`` starts the elastic-quota rebalancer, in
``VTPU_MIGRATE_S`` the live-migration planner; both read each node
monitor's ``/nodeinfo`` (``VTPU_MONITOR_URL_TEMPLATE``) and gate
themselves on leadership each round.
"""

from __future__ import annotations

import argparse
import logging
import socket
import ssl
import threading
from typing import List, Optional

from aiohttp import web
from prometheus_client import REGISTRY, start_http_server

from .. import api, device, trace
from ..device.config import GLOBAL
from ..ha import (ClusterLease, GroupCoordinator, HACoordinator,
                  ordinal_from_identity)
from ..util.client import FakeKubeClient, KubeClient, get_client
from ..util.env import env_float, env_int, env_str
from ..util.logsetup import setup as setup_logging
from .core import Scheduler
from .metrics import SchedulerCollector
from .migrate import MigrationPlanner
from .rebalancer import HTTPNodeInfoSource, Rebalancer
from .routes import build_app

log = logging.getLogger(__name__)


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
    p.add_argument("--ha", action="store_true",
                   help="join the leader-elected scheduler pair "
                        "(docs/ha.md); standby stays warm and serves "
                        "503 on /filter //bind until promoted")
    p.add_argument("--lease-name",
                   default=env_str(api.ENV_LEASE_NAME,
                                   api.LEASE_NAME_DEFAULT))
    p.add_argument("--lease-namespace",
                   default=env_str(api.ENV_LEASE_NAMESPACE, "kube-system"))
    p.add_argument("-v", "--verbose", action="count", default=0)
    return p.parse_args(argv)


def start_ha(sched: Scheduler, client: KubeClient,
             args: argparse.Namespace):
    """Attach and start the coordinator ``--ha`` asks for (cmd/
    scheduler.py:97-160): a GroupCoordinator, one lease per shard group,
    when the decide plane has more than one group, else an HACoordinator
    on one lease. Absorbing a group (or a promotion) replays the durable
    records before the instance serves a decision for it."""
    identity = env_str(api.ENV_POD_NAME) or socket.gethostname()
    lease_s = env_float(api.ENV_LEASE_EXPIRE_S, 15.0, minimum=1.0)
    n_groups = sched.shards.n_groups
    if n_groups > 1:
        peers = env_int(api.ENV_SCHEDULER_PEERS, 2, minimum=1)
        ordinal = env_int(api.ENV_SCHEDULER_ORDINAL, -1)
        if ordinal < 0:
            ordinal = ordinal_from_identity(identity, peers)

        def on_acquire(g: int, gen: int) -> None:
            restored = sched.recover(groups=frozenset({g}))
            log.info("acquired shard group %d (generation %d); "
                     "replayed %d durable record(s) for it", g, gen,
                     restored)

        def on_acquire_batch(gens) -> None:
            # one rebuild (one cluster pod LIST) for every group a poll
            # pass absorbed
            restored = sched.recover(groups=frozenset(gens))
            log.info("acquired shard groups %s (generations %s); "
                     "replayed %d durable record(s) for them",
                     sorted(gens), [gens[g] for g in sorted(gens)],
                     restored)

        coord = GroupCoordinator(
            client, identity=identity, n_groups=n_groups,
            ordinal=ordinal, peers=peers,
            lease_name_base=args.lease_name,
            namespace=args.lease_namespace, lease_s=lease_s,
            on_acquire=on_acquire, on_acquire_batch=on_acquire_batch)
        log.info("multi-active: %d shard groups, ordinal %d of %d "
                 "peer(s)", n_groups, ordinal, peers)
    else:
        lease = ClusterLease(client, identity=identity,
                             name=args.lease_name,
                             namespace=args.lease_namespace,
                             lease_s=lease_s)

        def on_promote(gen: int) -> None:
            restored = sched.recover()
            log.info("promoted (generation %d); rebuilt %d gang member "
                     "placement(s)", gen, restored)

        coord = HACoordinator(lease, on_promote=on_promote)
    sched.ha = coord
    coord.start()
    return coord


def start_loops(sched: Scheduler) -> list:
    """The leader-gated control loops a period above 0 turns on
    (cmd/scheduler.py:165-190): the elastic-quota rebalancer and the
    live-migration planner, each over the node monitors' /nodeinfo.
    Standbys run them too; each round gates itself on leadership."""
    loops = []
    rebalance_s = env_float(api.ENV_REBALANCE_S, 0.0, minimum=0.0)
    if rebalance_s > 0:
        source = HTTPNodeInfoSource(
            nodes=lambda: list(sched.nodes.list_nodes().keys()))
        loops.append(Rebalancer(sched, source, period_s=rebalance_s))
        log.info("rebalancer on (every %.0fs)", rebalance_s)
    migrate_s = env_float(api.ENV_MIGRATE_S, 0.0, minimum=0.0)
    if migrate_s > 0:
        msource = HTTPNodeInfoSource(
            nodes=lambda: list(sched.nodes.list_nodes().keys()))
        loops.append(MigrationPlanner(sched, msource, period_s=migrate_s))
        log.info("migration planner on (every %.0fs, deadline %.0fs)",
                 migrate_s, sched.migrate_deadline_s)
    for loop in loops:
        loop.start()
    return loops


def main(argv: Optional[List[str]] = None,
         client: Optional[KubeClient] = None) -> None:
    """Serve until interrupted. ``client`` replaces the in-cluster
    apiserver client (and ``--fake-kube``'s in-memory one)."""
    args = parse_args(argv)
    setup_logging(args.verbose)
    trace.tracer.configure(process="scheduler")
    GLOBAL.scheduler_name = args.scheduler_name
    GLOBAL.default_mem = args.default_mem
    GLOBAL.default_cores = args.default_cores
    device.init_default_devices()

    if client is None:
        client = FakeKubeClient() if args.fake_kube else get_client()
    sched = Scheduler(client)
    if args.ha:
        start_ha(sched, client, args)
    else:
        # single-scheduler deployments recover at startup the same way
        sched.recover()
    threading.Thread(target=sched.registration_loop, daemon=True).start()
    threading.Thread(target=sched.pod_watch_loop, daemon=True).start()
    loops = start_loops(sched)

    REGISTRY.register(SchedulerCollector(sched))
    mhost, mport = args.metrics_bind.rsplit(":", 1)
    start_http_server(int(mport), addr=mhost)

    host, port = args.http_bind.rsplit(":", 1)
    ssl_ctx = None
    if args.cert_file and args.key_file:
        ssl_ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ssl_ctx.load_cert_chain(args.cert_file, args.key_file)
    app = build_app(sched)
    if sched.ha is not None:
        # a graceful stop releases the lease, so the peer takes over at
        # once instead of after the expiry; stop() joins a thread and
        # makes lease round-trips, so it runs off the event loop
        async def _handover(app_):
            import asyncio

            await asyncio.get_running_loop().run_in_executor(
                None, sched.ha.stop)

        app.on_shutdown.append(_handover)
    try:
        # signal handlers can only be set from the main thread; a caller
        # that serves from another thread stops the process instead
        web.run_app(app, host=host, port=int(port), ssl_context=ssl_ctx,
                    handle_signals=(threading.current_thread()
                                    is threading.main_thread()))
    finally:
        for loop in loops:
            loop.stop()
        sched.stop()


if __name__ == "__main__":
    main()
