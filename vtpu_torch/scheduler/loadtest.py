"""The scheduler at cluster scale, through its HTTP entry points:
``python -m vtpu_torch.scheduler.loadtest``.

Starts the scheduler's daemon (:func:`vtpu_torch.scheduler.__main__.main`)
in a process of its own, on an in-memory apiserver holding ``--nodes``
nodes of 8 cards each, registered as the port's device plugin registers
them (NVML's type string and MiB, 10 replicas a card, the HGX NUMA layout
``0,0,0,0,1,1,1,1``, no mesh coordinate) and
re-reported every 30 s. This process then plays the API server's
admission, kube-scheduler and kubelet for a seeded stream of ``--pods``
pods, in three lanes: each pod is admitted through ``/webhook`` and
created with the returned patch ahead of scheduling; filtered through
``/filter`` against every node, one at a time; on a fit bound through
``/bind``, one binding after another, after which bind-phase turns
``success`` and the node lock is released as Allocate leaves them. The
stream (:func:`make_stream`): 1-card pods at 3,072, 12,288 or 20,480 MiB
with 25, 50 or 100 cores; 2- and 4-card pods with and without
``nvidia.com/numa-bind``; whole-node pods.

Gates, from the pods' assignment annotations and never from the
scheduler's own view: no card past its replica count, its MiB or its 100
cores; every numa-bind pod's cards on one NUMA node; and a pod refused
only where a plain first-fit over the same recomputed usage finds no
node for it at that point of the stream (every earlier placement bound
first). Prints one JSON object: the latency percentiles of each call,
binds a second, placed and refused counts, the wall time, the modules of
torch, jax or vtpu either process loaded (none), and ``ok``; exits 1
when a gate fails. A host program: no ``torch``, no device.

    python -m vtpu_torch.scheduler.loadtest --nodes 1024 --pods 8192
"""

from __future__ import annotations

import argparse
import base64
import http.client
import json
import logging
import queue
import socket
import subprocess
import sys
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .. import api
from ..util import codec, nodelock
from ..util.client import FakeKubeClient
from ..util.types import DeviceInfo

#: an HGX H100 node's cards by NUMA node
HGX_NUMA = (0, 0, 0, 0, 1, 1, 1, 1)
CARDS = len(HGX_NUMA)
#: replicas a card (the plugin's device_split_count default)
REPLICAS = 10
CARD_TYPE = "NVIDIA-NVIDIA H100 80GB HBM3"
CARD_MB = 81559
# the plugin's re-report period (plugin/register.py REPORT_INTERVAL_S):
# a node whose handshake goes stale for 60 s loses its cards
REPORT_S = 30.0


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def quantile(xs: List[float], q: float) -> Optional[float]:
    if not xs:
        return None
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))]


def apply_patch(pod: Dict[str, Any], patch: List[Dict[str, Any]]) -> None:
    """The webhook's JSON patch, as the apiserver applies it: a replaced
    spec and added annotations (the only ops it emits)."""
    for op in patch:
        path = op["path"]
        if path == "/spec":
            pod["spec"] = op["value"]
        elif path == "/metadata/annotations":
            pod["metadata"]["annotations"] = dict(op["value"])
        elif path.startswith("/metadata/annotations/"):
            key = path.split("/", 3)[3].replace("~1", "/").replace("~0",
                                                                   "~")
            pod["metadata"].setdefault("annotations", {})[key] = op["value"]
        else:
            raise ValueError(f"unexpected patch op {op}")


# ---------------------------------------------------------------------------
# the cluster and the stream
# ---------------------------------------------------------------------------

def node_cards(node: str, card_type: str,
               card_mb: int) -> List[DeviceInfo]:
    return [DeviceInfo(id=f"GPU-{node}-{i}", index=i, count=REPLICAS,
                       devmem=card_mb, devcore=100, type=card_type,
                       numa=numa)
            for i, numa in enumerate(HGX_NUMA)]


def report(client: FakeKubeClient, nodes: Dict[str, List[DeviceInfo]]):
    """What each node's plugin writes every REPORT_S."""
    for name, devs in nodes.items():
        client.patch_node_annotations(name, {
            api.HANDSHAKE_ANNO: f"Reported {time.time():.0f}",
            api.NODE_REGISTER_ANNO: codec.encode_node_devices(devs)})


#: the multi-card shapes: (cards, gpumem MiB, gpucores), each sent with
#: and without numa-bind
MULTI = ((2, 20480, 50), (4, 12288, 25))


def make_stream(seed: int, n: int) -> List[Dict[str, Any]]:
    """The seeded requests: (count, gpumem or None for the whole card,
    gpucores, numa-bind). 80% 1-card pods at 3,072, 12,288 or 20,480 MiB
    with 25, 50 or 100 cores; 16% multi-card (MULTI), half of them
    numa-bind; 4% whole-node pods."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        r = rng.random()
        if r < 0.80:
            req = (1, int(rng.choice([3072, 12288, 20480])),
                   int(rng.choice([25, 50, 100])), False)
        elif r < 0.96:
            count, mem, cores = MULTI[int(rng.integers(len(MULTI)))]
            req = (count, mem, cores, bool(rng.random() < 0.5))
        else:
            req = (CARDS, None, 100, False)
        out.append({"name": f"pod-{i}", "count": req[0], "mem": req[1],
                    "cores": req[2], "numa_bind": req[3]})
    return out


def pod_object(req: Dict[str, Any]) -> Dict[str, Any]:
    limits: Dict[str, Any] = {api.RESOURCE_GPU: req["count"],
                              api.RESOURCE_CORES: req["cores"]}
    if req["mem"] is not None:
        limits[api.RESOURCE_MEM] = req["mem"]
    annos = {api.NUMA_BIND_ANNO: "true"} if req["numa_bind"] else {}
    return {"metadata": {"name": req["name"], "namespace": "default",
                         "uid": f"uid-{req['name']}", "annotations": annos},
            "spec": {"containers": [{"name": "main", "resources": {
                "limits": limits}}]},
            "status": {"phase": "Pending"}}


# ---------------------------------------------------------------------------
# the recomputed usage and the plain first-fit
# ---------------------------------------------------------------------------

class Usage:
    """Per-card usage summed from the pods' assignment annotations."""

    def __init__(self, nodes: Dict[str, List[DeviceInfo]]) -> None:
        self.cards = {d.id: d for devs in nodes.values() for d in devs}
        self.node_of = {d.id: n for n, devs in nodes.items() for d in devs}
        self.nodes = nodes
        self.tasks = {c: 0 for c in self.cards}
        self.mem = {c: 0 for c in self.cards}
        self.cores = {c: 0 for c in self.cards}

    def add(self, encoded: str) -> List[str]:
        uuids = []
        for ctr in codec.decode_pod_devices(encoded):
            for d in ctr:
                self.tasks[d.uuid] += 1
                self.mem[d.uuid] += d.usedmem
                self.cores[d.uuid] += d.usedcores
                uuids.append(d.uuid)
        return uuids

    def overcommitted(self) -> List[str]:
        return [c for c, d in self.cards.items()
                if self.tasks[c] > d.count or self.mem[c] > d.devmem
                or self.cores[c] > d.devcore]

    def card_fits(self, d: DeviceInfo, mem: int, cores: int) -> bool:
        used, cid = self.tasks[d.id], d.id
        return (used < d.count and self.mem[cid] + mem <= d.devmem
                and self.cores[cid] + cores <= d.devcore
                and not (cores == 100 and used > 0)
                and not (used > 0 and self.cores[cid] >= d.devcore))

    def first_fit(self, req: Dict[str, Any]) -> Optional[str]:
        """The first node the request fits on: enough cards each with a
        free replica, the MiB (the whole card when no gpumem is given)
        and the cores; for a multi-card numa-bind request, all on one
        NUMA node."""
        for node, devs in self.nodes.items():
            groups: Dict[int, int] = {}
            for d in devs:
                mem = req["mem"] if req["mem"] is not None else d.devmem
                if self.card_fits(d, mem, req["cores"]):
                    key = d.numa if (req["numa_bind"]
                                     and req["count"] > 1) else 0
                    groups[key] = groups.get(key, 0) + 1
            if any(n >= req["count"] for n in groups.values()):
                return node
        return None


# ---------------------------------------------------------------------------
# the scheduler's process: the daemon and the in-memory apiserver
# ---------------------------------------------------------------------------

def cluster_nodes(nodes_n: int, card_type: str,
                  card_mb: int) -> Dict[str, List[DeviceInfo]]:
    return {f"node-{i:04d}": node_cards(f"node-{i:04d}", card_type, card_mb)
            for i in range(nodes_n)}


def serve(args: argparse.Namespace) -> None:
    """The scheduler's process: the daemon (its main, on this process's
    main thread) over an in-memory apiserver that also answers the
    driver's calls on `--api-port`, as the API server and kubelet would
    write it: create a pod, Allocate's bind-phase and lock release, the
    assignments for the gates. The nodes' plugins re-report every
    REPORT_S."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    from .__main__ import main

    client = FakeKubeClient()
    nodes = cluster_nodes(args.nodes, args.card_type, args.card_mb)
    for name in nodes:
        client.add_node(name)
    report(client, nodes)

    def reporter():
        while True:
            time.sleep(REPORT_S)
            report(client, nodes)

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def setup(self):
            super().setup()
            # headers and body go out in two writes: without this, the
            # client's delayed ACK holds the second for ~40 ms
            self.request.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY,
                                    1)

        def log_message(self, *a):
            pass

        def _reply(self, obj) -> None:
            data = json.dumps(obj).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            if self.path == "/registered":
                self._reply(all(
                    (client.get_node(n)["metadata"].get("annotations")
                     or {}).get(api.HANDSHAKE_ANNO, "").startswith(
                         "Requesting") for n in nodes))
            elif self.path == "/assigned":
                self._reply({
                    p["metadata"]["name"]:
                    p["metadata"]["annotations"][api.ASSIGNED_IDS_ANNO]
                    for p in client.list_pods_all_namespaces()
                    if (p["metadata"].get("annotations") or {}).get(
                        api.ASSIGNED_IDS_ANNO)})
            elif self.path == "/modules":
                self._reply(sorted(
                    m for m in sys.modules
                    if m.split(".")[0] in ("torch", "jax", "vtpu")))
            else:
                self.send_error(404)

        def do_POST(self):
            body = json.loads(self.rfile.read(
                int(self.headers["Content-Length"])))
            if self.path == "/pods":
                client.add_pod(body)
                self._reply({})
            elif self.path == "/allocate":
                # kubelet's Allocate through the plugin: bind-phase
                # success and the node's lock released
                name, node = body["name"], body["node"]
                annos = client.get_pod("default", name)["metadata"][
                    "annotations"]
                client.patch_pod_annotations("default", name, {
                    api.BIND_PHASE_ANNO: "success"})
                nodelock.release_node(client, node)
                self._reply({"assigned": annos[api.ASSIGNED_IDS_ANNO]})
            else:
                self.send_error(404)

    api_server = ThreadingHTTPServer(("127.0.0.1", args.api_port), Handler)
    api_server.daemon_threads = True
    threading.Thread(target=api_server.serve_forever, daemon=True).start()
    threading.Thread(target=reporter, daemon=True).start()
    # the daemon logs each request at INFO; at this rate that is noise
    logging.getLogger("aiohttp.access").setLevel(logging.WARNING)
    main(["--http-bind", f"127.0.0.1:{args.port}",
          "--metrics-bind", f"127.0.0.1:{args.metrics_port}"], client=client)


# ---------------------------------------------------------------------------
# the drive: the API server's admission, kube-scheduler and kubelet
# ---------------------------------------------------------------------------

class Http:
    """One keep-alive connection."""

    def __init__(self, port: int) -> None:
        self.conn = http.client.HTTPConnection("127.0.0.1", port,
                                               timeout=60)

    def call(self, method: str, path: str, body: Any = None,
             raw: Optional[str] = None) -> Tuple[int, Any, float]:
        data = raw if raw is not None else (
            None if body is None else json.dumps(body))
        t0 = time.perf_counter()
        self.conn.request(method, path, body=data,
                          headers={"Content-Type": "application/json"})
        resp = self.conn.getresponse()
        raw_out = resp.read()
        took = time.perf_counter() - t0
        try:
            payload = json.loads(raw_out)
        except ValueError:
            payload = raw_out.decode(errors="replace")
        return resp.status, payload, took


def wait_for(port: int, path: str, proc: subprocess.Popen,
             timeout_s: float = 120.0) -> None:
    deadline = time.monotonic() + timeout_s
    while True:
        if proc.poll() is not None:
            raise RuntimeError(f"the scheduler's process exited "
                               f"({proc.returncode})")
        try:
            status, body, _ = Http(port).call("GET", path)
            if status == 200 and body not in (False, None):
                return
        except OSError:
            pass
        if time.monotonic() > deadline:
            raise RuntimeError(f"no answer on :{port}{path}")
        time.sleep(0.05)


def run(nodes_n: int = 1024, pods_n: int = 8192, seed: int = 0,
        card_type: str = CARD_TYPE,
        card_mb: int = CARD_MB) -> Dict[str, Any]:
    t_start = time.perf_counter()
    port, metrics_port, api_port = free_port(), free_port(), free_port()
    errf = tempfile.TemporaryFile("w+")
    proc = subprocess.Popen(
        [sys.executable, "-m", "vtpu_torch.scheduler.loadtest", "--serve",
         "--nodes", str(nodes_n), "--card-type", card_type,
         "--card-mb", str(card_mb),
         "--port", str(port), "--metrics-port", str(metrics_port),
         "--api-port", str(api_port)],
        stdout=subprocess.DEVNULL, stderr=errf)
    try:
        wait_for(port, "/healthz", proc)
        wait_for(api_port, "/registered", proc)
        registered_s = time.perf_counter() - t_start
        result = drive(nodes_n, pods_n, seed, card_type, card_mb, port,
                       api_port)
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)
        errf.seek(0)
        tail = errf.read()[-4000:]
        errf.close()
    result["scheduler_rc"] = proc.returncode
    # the daemon's first registration poll comes one period in
    result["registered_s"] = registered_s
    result["wall_s"] = time.perf_counter() - t_start
    if not result["ok"]:
        result["scheduler_log_tail"] = tail
    return result


def drive(nodes_n: int, pods_n: int, seed: int, card_type: str,
          card_mb: int, port: int, api_port: int) -> Dict[str, Any]:
    nodes = cluster_nodes(nodes_n, card_type, card_mb)
    # the candidate list kube-scheduler sends with every filter, encoded
    # once
    names_json = json.dumps(list(nodes))
    usage = Usage(nodes)
    lat: Dict[str, List[float]] = {"webhook": [], "filter": [], "bind": []}
    counts = {"placed": 0, "refused": 0}
    wrong_refusals: List[Dict[str, Any]] = []
    split_numa: List[str] = []
    errors: List[str] = []
    stream = make_stream(seed, pods_n)
    # three lanes, as a cluster runs them: pods are created (admitted by
    # the webhook) ahead of scheduling; kube-scheduler filters one pod
    # at a time and binds asynchronously, one binding after another here,
    # each followed by kubelet's Allocate
    created: "queue.Queue" = queue.Queue(maxsize=64)
    to_bind: "queue.Queue" = queue.Queue()

    def creator():
        conn, apiserver = Http(port), Http(api_port)
        for req in stream:
            name = req["name"]
            pod = pod_object(req)
            status, review, took = conn.call("POST", "/webhook", {
                "apiVersion": "admission.k8s.io/v1",
                "kind": "AdmissionReview",
                "request": {"uid": f"rev-{name}", "object": pod}})
            lat["webhook"].append(took)
            resp = review.get("response", {}) if status == 200 else {}
            if not resp.get("allowed"):
                errors.append(f"{name}: webhook {status} {review}")
                created.put((req, None))
                continue
            if "patch" in resp:
                apply_patch(pod, json.loads(base64.b64decode(
                    resp["patch"])))
            pod_json = json.dumps(pod)
            apiserver.call("POST", "/pods", raw=pod_json)
            created.put((req, pod_json))

    def binder():
        conn, apiserver = Http(port), Http(api_port)
        while True:
            item = to_bind.get()
            if item is None:
                to_bind.task_done()
                return
            req, node = item
            name = req["name"]
            status, body, took = conn.call("POST", "/bind", {
                "PodName": name, "PodNamespace": "default",
                "PodUID": f"uid-{name}", "Node": node})
            lat["bind"].append(took)
            if status != 200 or body.get("Error"):
                errors.append(f"{name}: bind {status} {body}")
            else:
                _, alloc, _ = apiserver.call("POST", "/allocate", {
                    "name": name, "node": node})
                uuids = usage.add(alloc["assigned"])
                if req["numa_bind"] and len({usage.cards[u].numa
                                             for u in uuids}) > 1:
                    split_numa.append(name)
                if {usage.node_of[u] for u in uuids} != {node}:
                    errors.append(f"{name}: bound to {node}, cards "
                                  f"{uuids}")
                counts["placed"] += 1
            to_bind.task_done()

    sched = Http(port)
    t0 = time.perf_counter()
    lanes = [threading.Thread(target=creator, daemon=True),
             threading.Thread(target=binder, daemon=True)]
    for lane in lanes:
        lane.start()
    for _ in stream:
        req, pod_json = created.get()
        if pod_json is None:
            continue
        name = req["name"]
        status, body, took = sched.call(
            "POST", "/filter", raw='{"Pod": %s, "NodeNames": %s}' % (
                pod_json, names_json))
        lat["filter"].append(took)
        if status != 200:
            errors.append(f"{name}: filter {status} {body}")
            continue
        if body["NodeNames"]:
            to_bind.put((req, body["NodeNames"][0]))
            continue
        counts["refused"] += 1
        # the usage every earlier placement left, bound and allocated
        to_bind.join()
        fit = usage.first_fit(req)
        if fit is not None:
            wrong_refusals.append({"pod": name, "request": req,
                                   "first_fit": fit,
                                   "error": body.get("Error")})
    to_bind.put(None)
    for lane in lanes:
        lane.join()
    stream_s = time.perf_counter() - t0
    placed, refused = counts["placed"], counts["refused"]

    # the gates, from every pod's annotations as the apiserver holds them
    apiserver = Http(api_port)
    final = Usage(nodes)
    for encoded in apiserver.call("GET", "/assigned")[1].values():
        final.add(encoded)
    over = final.overcommitted()
    modules = sorted(set(apiserver.call("GET", "/modules")[1]) | {
        m for m in sys.modules
        if m.split(".")[0] in ("torch", "jax", "vtpu")})
    result = {
        "nodes": nodes_n, "cards_per_node": CARDS, "card_type": card_type,
        "card_mb": card_mb, "replicas": REPLICAS, "pods": pods_n,
        "seed": seed,
        "placed": placed, "refused": refused,
        "numa_bind_pods": sum(1 for r in stream if r["numa_bind"]),
        "stream_s": stream_s,
        "binds_per_s": placed / stream_s if stream_s else 0.0,
        "ms": {k: {"p50": _ms(quantile(v, 0.5)),
                   "p99": _ms(quantile(v, 0.99)), "n": len(v)}
               for k, v in lat.items()},
        "cards_used": sum(1 for c in final.tasks if final.tasks[c]),
        "overcommitted_cards": over[:20],
        "numa_split_pods": split_numa[:20],
        "wrong_refusals": wrong_refusals[:20],
        "n_wrong_refusals": len(wrong_refusals),
        "errors": errors[:20], "n_errors": len(errors),
        # what either process loaded of the device stack: nothing
        "modules": modules,
    }
    result["ok"] = (not over and not split_numa and not wrong_refusals
                    and not errors and placed + refused == pods_n
                    and not modules)
    return result


def _ms(s: Optional[float]) -> Optional[float]:
    return None if s is None else s * 1e3


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser("vtpu-scheduler-loadtest")
    p.add_argument("--nodes", type=int, default=1024)
    p.add_argument("--pods", type=int, default=8192)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--card-type", default=CARD_TYPE)
    p.add_argument("--card-mb", type=int, default=CARD_MB)
    # the scheduler's process, which run() starts
    p.add_argument("--serve", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--metrics-port", type=int, default=0,
                   help=argparse.SUPPRESS)
    p.add_argument("--api-port", type=int, default=0,
                   help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.serve:
        serve(args)
        return 0
    result = run(args.nodes, args.pods, args.seed, args.card_type,
                 args.card_mb)
    sys.stdout.write(json.dumps(result) + "\n")
    sys.stdout.flush()
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
