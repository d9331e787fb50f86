"""One live move through the port's own processes:
``python -m vtpu_torch.scheduler.livemove``.

The path docs/migration.md describes, on one machine. One in-memory
apiserver holds two nodes; each node has the port's device plugin
(:class:`~vtpu_torch.plugin.server.GPUDevicePlugin`, registered by its
:class:`~vtpu_torch.plugin.register.Registrar` from NVML) and the port's
node monitor (:class:`~vtpu_torch.monitor.daemon.MonitorDaemon`: its sweep,
drain coordinator, feedback loop and ``/nodeinfo`` server, without its
Prometheus endpoint, which one process can serve only once). The
scheduler runs the daemon's wiring (:func:`~vtpu_torch.scheduler.__main__
.start_loops`, with ``VTPU_REBALANCE_S`` and ``VTPU_MIGRATE_S`` above 0),
its nodes registered at once rather than at the first 15 s poll. A node's
name is a loopback address (``127.0.0.2``, ``127.0.0.3``), where its
monitor serves ``/nodeinfo``, so the planner reaches each monitor over
HTTP through ``VTPU_MONITOR_URL_TEMPLATE`` as in a cluster. Both nodes
register the same card: the move is node to node in the scheduler's
view, card to the same card physically.

The pods are :func:`vtpu_torch.models.offload.pod_main` processes, each
started with only the env its node's ``Allocate`` response gives
(:func:`vtpu_torch.plugin.runtime.process_env`: its region file,
``CUDA_DEVICE_MEMORY_LIMIT``, ``CUDA_HOST_MEMORY_LIMIT``,
``libvgpu.so`` preloaded). This process plays the API server, kube-
scheduler and kubelet:

1. the source pod is admitted through the webhook, placed on the source
   node (filter, bind) and allocated; it sets up its host state (the
   ledger's growth is read) and trains 3 steps, then trains on,
   polling its drain surface between steps;
2. the pod is marked a migration candidate (the mark the rebalancer's
   defragmentation proposes; one card a node never fragments): the
   planner stamps ``migrating-to`` with the destination reserved, the
   source monitor turns the stamp into the drain request, the pod
   snapshots (the ledger's growth is read) and acks, the monitor
   publishes the ack and blocks the pod's launches (read until 2 s
   past the cutover),
   and the planner cuts the assignment over to the destination node;
3. kubelet on the destination: the pod is bound there and allocated
   again, and the destination pod resumes from the source's snapshot; its
   monitor reports its region and the planner completes the move
   (``migrated-from`` cleared); then the source releases its snapshot
   (the ledger's drop is read) and exits;
4. the destination trains 3 steps; a control pod (no interposer)
   runs the same stream unmigrated; the losses are compared.

With ``--refuse`` the pod's host limit holds its state but not a
snapshot: the snapshot is refused, acked ``refused``, and the planner
aborts the move (the stamp cleared, the pod training at the source).

Prints one JSON object: the gates' readings, each protocol step's time
(mark to stamp, stamp to ack, the planner's blackout, cut over to
complete), the step ms, and ``ok``; exits 1 when a gate fails. A host
program: the pods import torch, this process does not.

    python -m vtpu_torch.scheduler.livemove --dim 1024 \\
        --layers 4096,4096,4096 --batch 256
"""

from __future__ import annotations

import argparse
import json
import math
import os
import select
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional

from .. import api
from ..util.env import env_str

SRC, DST = "127.0.0.2", "127.0.0.3"
NS = "default"
POD = "mover"
#: the pod's card memory (gpumem, MiB)
QUOTA_MB = 8192
#: the losses of the moved stream against the control's
LOSS_RTOL, LOSS_ATOL = 1e-6, 1e-7
#: setup's ledger growth over the model's host bytes (pinned blocks round)
SETUP_GROWTH = (1.0, 1.01)
POLL_S = 0.05
#: steps the source trains before the move, and the destination after it
PREFIX_STEPS, AFTER_STEPS = 3, 3
#: how long past the cutover the drained source's launches are watched
HOLD_S = 2.0
#: the monitors' sweep and the planner's period
SWEEP_S, MIGRATE_S = 0.5, 0.5
#: the rebalancer's period. Its first round runs at its start, before any
#: pod; a round over a pod that has attached its region but not yet made
#: its context reads 0 MiB used and shrinks the quota to 1 MiB (the
#: reference's rule, ROADMAP F11), so the period is longer than a move
REBALANCE_S = 60.0
#: the longest any step of the move may take
STEP_TIMEOUT_S = 60.0


class Failure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise Failure(msg)


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def until(cond, timeout_s: float, what: str) -> float:
    """Seconds until cond() held; Failure past timeout_s."""
    t0 = time.monotonic()
    while not cond():
        check(time.monotonic() - t0 < timeout_s,
              f"{what}: not within {timeout_s} s")
        time.sleep(POLL_S)
    return time.monotonic() - t0


class Pod:
    """A pod process and its JSON line protocol."""

    def __init__(self, label: str, env: Dict[str, str], argv: List[str],
                 errdir: str, wait: bool = True) -> None:
        self.label = label
        self.errf = open(os.path.join(errdir, f"{label}.err"), "w+")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "vtpu_torch.models.offload", *argv],
            env=env, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=self.errf, text=True)
        self.first = self.read(300) if wait else None

    def err(self) -> str:
        self.errf.flush()
        self.errf.seek(0)
        return self.errf.read()[-3000:]

    def read(self, timeout_s: float) -> Dict[str, Any]:
        ready, _, _ = select.select([self.proc.stdout], [], [], timeout_s)
        line = self.proc.stdout.readline() if ready else ""
        if not line:
            raise Failure(f"pod {self.label} gave no answer, rc "
                          f"{self.proc.poll()}:\n{self.err()}")
        return json.loads(line)

    def send(self, op: str, **args) -> None:
        self.proc.stdin.write(json.dumps(dict(args, op=op)) + "\n")
        self.proc.stdin.flush()

    def ask(self, op: str, timeout_s: float = 300, **args) -> Dict[str, Any]:
        self.send(op, **args)
        return self.read(timeout_s)

    def stop(self) -> int:
        if self.proc.poll() is None:
            try:
                self.send("exit")
                self.proc.wait(timeout=60)
            except (OSError, subprocess.TimeoutExpired):
                self.proc.kill()
                self.proc.wait(timeout=30)
        return self.proc.returncode


class Node:
    """A node's device plugin and monitor on the shared apiserver."""

    def __init__(self, name: str, root: str, client, info_port: int,
                 sweep_s: float) -> None:
        from ..monitor.daemon import MonitorDaemon
        from ..plugin import nvml
        from ..plugin.config import PluginConfig
        from ..plugin.register import Registrar
        from ..plugin.server import GPUDevicePlugin, install_shim_artifacts

        self.name = name
        shim = os.path.join(root, name, "vgpu")
        self.containers = os.path.join(shim, "containers")
        os.makedirs(self.containers)
        config = PluginConfig(shim_host_dir=shim,
                              socket_dir=os.path.join(root, name, "dp"))
        install_shim_artifacts(shim)
        gpulib = nvml.detect()
        self.plugin = GPUDevicePlugin(gpulib, config, client, name)
        Registrar(gpulib, self.plugin.rm, client, name).register_once()
        self.monitor = MonitorDaemon(self.containers, client=client,
                                     node_name=name, info_port=info_port,
                                     info_bind=name,
                                     sweep_interval_s=sweep_s)
        self.monitor.start_info_server()
        self.monitor.podcache.start()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sweep, daemon=True,
                                        name=f"monitor-{name}")
        self._thread.start()
        self.uuid = self.plugin.chips[0].uuid

    def _sweep(self) -> None:
        while not self._stop.is_set():
            self.monitor.sweep_once()
            self._stop.wait(self.monitor.sweep_interval_s)

    def allocate(self) -> Dict[str, str]:
        """kubelet's Allocate for the pod bound here: the response's env
        for a process (runtime.process_env)."""
        from ..plugin import deviceplugin_pb2 as pb
        from ..plugin import runtime
        from ..plugin.rm import replica_id

        resp = self.plugin._allocate(pb.AllocateRequest(container_requests=[
            pb.ContainerAllocateRequest(
                devicesIDs=[replica_id(self.uuid, 0)])]))
        (ctr,) = resp.container_responses
        return runtime.process_env(ctr)

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=10)
        self.monitor.stop()


def pod_env(allocated: Dict[str, str]) -> Dict[str, str]:
    """This process's env less every device knob, plus the response's."""
    env = {k: v for k, v in os.environ.items() if not k.startswith(
        ("CUDA_", "NVIDIA_", "LD_PRELOAD", "PYTORCH_CUDA_ALLOC_CONF"))}
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))]
        + [p for p in env_str("PYTHONPATH", "").split(os.pathsep)
           if p])
    env.update(allocated)
    return env


def run(args: argparse.Namespace) -> Dict[str, Any]:
    from .. import device
    from ..device.config import GLOBAL
    from ..enforce.region import FEEDBACK_BLOCK, RegionView
    from ..util import nodelock
    from ..util.client import FakeKubeClient
    from . import metrics as metricsmod
    from .__main__ import start_loops
    from .core import Scheduler
    from .webhook import handle_admission_review

    t_start = time.perf_counter()
    root = tempfile.mkdtemp(prefix="vgpu_livemove_")
    res: Dict[str, Any] = {"ok": False}
    nodes: List[Node] = []
    pods: List[Pod] = []
    sched, loops = None, []
    argv = ["--dim", str(args.dim), "--layers", args.layers, "--batch",
            str(args.batch)] + (["--device", args.device]
                                if args.device else [])
    try:
        info_port = free_port()
        os.environ[api.ENV_MONITOR_URL_TEMPLATE] = \
            f"http://{{node}}:{info_port}/nodeinfo"
        os.environ[api.ENV_MIGRATE_S] = str(MIGRATE_S)
        os.environ[api.ENV_REBALANCE_S] = str(REBALANCE_S)
        GLOBAL.default_mem = 0
        GLOBAL.default_cores = 0
        device.init_default_devices()
        client = FakeKubeClient()
        for name in (SRC, DST):
            client.add_node(name)
        nodes = [Node(n, root, client, info_port, SWEEP_S)
                 for n in (SRC, DST)]
        src, dst = nodes
        sched = Scheduler(client)
        sched.recover()
        sched.register_from_node_annotations_once()
        threading.Thread(target=sched.registration_loop,
                         daemon=True).start()
        threading.Thread(target=sched.pod_watch_loop, daemon=True).start()
        loops = start_loops(sched)
        check(len(loops) == 2, f"loops started: {loops}")

        # 1. the source pod: admitted, placed on the source, allocated
        host_limit = args.host_limit_mib << 20
        pod = {"metadata": {"name": POD, "namespace": NS,
                            "uid": f"uid-{POD}", "annotations": {}},
               "spec": {"containers": [{"name": "main", "resources": {
                   "limits": {api.RESOURCE_GPU: 1,
                              api.RESOURCE_MEM: QUOTA_MB,
                              api.RESOURCE_HOST_MEM: args.host_limit_mib,
                              api.RESOURCE_PRIORITY: 1}}}]},
               "status": {"phase": "Pending"}}
        review = handle_admission_review(
            {"request": {"uid": "rev-mover", "object": pod}})
        check(review["response"]["allowed"], f"webhook: {review}")
        client.add_pod(pod)
        winner, failed = sched.filter(client.get_pod(NS, POD), [SRC])
        check(winner == SRC, f"filter: {winner} {failed}")
        sched.bind(NS, POD, SRC)
        env = src.allocate()
        check(env.get(api.ENV_HOST_MEMORY_LIMIT) == str(host_limit),
              f"host limit in the response: {env}")
        client.patch_pod_annotations(NS, POD, {
            api.BIND_PHASE_ANNO: "success"})
        nodelock.release_node(client, SRC)
        source = Pod("source", pod_env(env), argv, root)
        pods.append(source)
        res["interposed"] = source.first["interposed"]
        check(source.first["interposed"],
              "the source pod is not under libvgpu.so")
        setup = source.ask("setup", seed=0)
        host_bytes = setup["host_bytes"]
        res["host_bytes"] = host_bytes
        res["setup_growth"] = (setup["after"] - setup["before"]) / host_bytes
        lo, hi = SETUP_GROWTH
        check(lo <= res["setup_growth"] <= hi,
              f"setup grew the ledger {res['setup_growth']}x")
        prefix = source.ask("train", steps=PREFIX_STEPS, seed=1)
        res["step_ms"] = prefix["ms"][1:] or prefix["ms"]
        if not args.refuse:
            # the control (no interposer) starts while the move runs
            control = Pod("control", pod_env({}), argv, root, wait=False)
            pods.append(control)

        # 2. marked, stamped, drained, snapshotted, cut over
        source.send("train", until_drained=True, seed=1,
                    timeout_s=STEP_TIMEOUT_S)
        blackout0 = metricsmod.MIGRATE_BLACKOUT._sum.get()
        client.patch_pod_annotations(NS, POD, {
            # vtpulint: ignore[VTPU020] the harness marks the pod as an operator would; the planner then drives the fenced move
            api.MIGRATION_CANDIDATE_ANNO: "1"})

        def annos():
            return client.get_pod(NS, POD)["metadata"].get(
                "annotations", {}) or {}

        res["mark_to_stamp_s"] = until(
            lambda: api.MIGRATING_TO_ANNO in annos(), STEP_TIMEOUT_S,
            "the planner's stamp")
        t_stamp = time.monotonic()
        drained = source.read(STEP_TIMEOUT_S)
        res["stamp_to_ack_s"] = time.monotonic() - t_stamp
        if args.refuse:
            check(not drained["drained"] and drained["refused"],
                  f"refused snapshot: {drained}")
            res["refused_host_used"] = drained["host_used"]
            until(lambda: api.MIGRATING_TO_ANNO not in annos(),
                  STEP_TIMEOUT_S, "the planner's abort")
            res["aborted"] = True
            res["assigned_node"] = annos().get(api.ASSIGNED_NODE_ANNO)
            check(res["assigned_node"] == SRC, "an aborted move moved")
            res["ok"] = True
            return res
        check(drained["drained"], f"no drain: {drained}")
        res["snapshot_growth_bytes"] = \
            drained["host_used"] - prefix["host_used"]
        check(res["snapshot_growth_bytes"] == host_bytes,
              f"the snapshot grew the ledger "
              f"{res['snapshot_growth_bytes']} B, not {host_bytes}")
        res["steps_before_drain"] = drained["t"]
        cache = os.path.join(src.containers, f"uid-{POD}_0",
                             api.CACHE_FILENAME)

        def feedback():
            with RegionView(cache) as view:
                return view.recent_kernel, view.total_launches()

        # from the block (which lasts until the cutover clears the stamp)
        # to hold_s past the cutover, the drained source launches nothing
        until(lambda: feedback()[0] == FEEDBACK_BLOCK, STEP_TIMEOUT_S,
              "the source's launches blocked")
        l0 = feedback()[1]
        until(lambda: annos().get(api.ASSIGNED_NODE_ANNO) == DST,
              STEP_TIMEOUT_S, "the cutover")
        res["ack_to_cutover_s"] = time.monotonic() - t_stamp - \
            res["stamp_to_ack_s"]
        time.sleep(HOLD_S)
        l1 = feedback()[1]
        res["blocked_launches"] = [l0, l1]
        check(l1 == l0, f"the drained source launched: {l0} -> {l1}")
        res["blackout_s"] = metricsmod.MIGRATE_BLACKOUT._sum.get() - \
            blackout0
        res["assigned_node"] = annos()[api.ASSIGNED_NODE_ANNO]
        t_cut = time.monotonic()
        blob = os.path.join(root, "blob.pt")
        source.ask("save", path=blob)

        # 3. kubelet on the destination; the move completes
        client.bind_pod(NS, POD, DST)
        nodelock.lock_node(client, DST)
        client.patch_pod_annotations(NS, POD, {
            api.BIND_PHASE_ANNO: "allocating",
            api.BIND_TIME_ANNO: str(time.time_ns())})
        denv = dst.allocate()
        check(denv.get(api.ENV_MIGRATED_FROM, "").endswith(SRC),
              f"migrated-from in the response: {denv}")
        client.patch_pod_annotations(NS, POD, {
            api.BIND_PHASE_ANNO: "success"})
        nodelock.release_node(client, DST)
        dest = Pod("destination", pod_env(denv), argv, root)
        pods.append(dest)
        dsetup = dest.ask("setup", seed=0)
        resumed = dest.ask("resume", path=blob)
        check(resumed["t"] == drained["t"], f"resumed at {resumed}")
        until(lambda: api.MIGRATED_FROM_ANNO not in annos(),
              STEP_TIMEOUT_S, "the move's completion")
        res["cutover_to_complete_s"] = time.monotonic() - t_cut
        before = source.ask("ledger")["host_used"]
        released = source.ask("release")
        res["release_bytes"] = before - released["host_used"]
        check(res["release_bytes"] == host_bytes,
              f"release {res['release_bytes']} != {host_bytes}")
        check(source.stop() == 0, f"source rc:\n{source.err()}")
        res["dest_setup_growth"] = \
            (dsetup["after"] - dsetup["before"]) / host_bytes

        # 4. the stream goes on at the destination, as unmigrated
        after = dest.ask("train", steps=AFTER_STEPS, seed=1)
        control.first = control.read(300)
        control.ask("setup", seed=0)
        ctl = control.ask("train", steps=drained["t"] + AFTER_STEPS, seed=1)
        got, want = after["losses"], ctl["losses"][-AFTER_STEPS:]
        res["losses"] = {"moved": got, "control": want}
        res["loss_max_rel_err"] = max(
            abs(g - w) / max(abs(w), 1e-30) for g, w in zip(got, want))
        check(len(got) == AFTER_STEPS and all(
            math.isclose(g, w, rel_tol=LOSS_RTOL, abs_tol=LOSS_ATOL)
            for g, w in zip(got, want)), f"losses: {got} vs {want}")
        res["ok"] = True
        return res
    finally:
        for p in pods:
            p.stop()
            p.errf.close()
        for loop in loops:
            loop.stop()
        if sched is not None:
            sched.stop()
        for n in nodes:
            n.stop()
        res["took_s"] = time.perf_counter() - t_start
        shutil.rmtree(root, ignore_errors=True)


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser("vtpu_torch.scheduler.livemove")
    p.add_argument("--dim", type=int, default=1024)
    p.add_argument("--layers", default="4096,4096,4096")
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--device", default=None,
                   help="the pods' device (default: the card)")
    p.add_argument("--host-limit-mib", type=int, default=1024,
                   help="the pod's host-memory reservation")
    p.add_argument("--refuse", action="store_true",
                   help="a host limit that holds the state but not a "
                        "snapshot: the move is refused and aborted")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    try:
        res = run(args)
    except Failure as e:
        print(json.dumps({"ok": False, "error": str(e)}), flush=True)
        return 1
    print(json.dumps(res), flush=True)
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
