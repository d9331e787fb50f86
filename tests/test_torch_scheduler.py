"""The port's scheduler (vtpu_torch.scheduler) against the JAX one
(vtpu.scheduler) with the port's GPUDevices registered at run time: the
same node annotations and the same seeded pods, each side on its own
in-memory apiserver, and every winner, FailedNodes string, assignment
annotation (wall-clock stamps aside), DecisionTrace and webhook patch
compared, up to the ``vTPU`` -> ``vGPU`` rename (tests/torch_sched_parity.py).
The one other difference, F8 (a multi-card ``nvidia.com/numa-bind`` pod
on cards with no mesh coordinate), has its own test below.

Sizes: 16 nodes x 8 cards (HGX NUMA layout 0,0,0,0,1,1,1,1), about 200
pods a scenario."""

import json
import os
import subprocess
import sys
import time

import pytest

from torch_sched_parity import (A100, A100_MB, H100, H100_MB, Pair,
                                cards, decode_review, gpu_pod, node_annos,
                                register_vendors, reset_vendors,
                                seeded_pods, to_port_strings)
from vtpu.scheduler import score as jax_score
from vtpu.scheduler.core import MIG_RESERVATION_SUFFIX as JAX_MIG_SUFFIX
from vtpu.util import types as jax_types
from vtpu_torch import api
from vtpu_torch.scheduler import score as port_score
from vtpu_torch.scheduler.core import MIG_RESERVATION_SUFFIX
from vtpu_torch.trace import decision as port_decision
from vtpu_torch.util import codec, types
from vtpu_torch.util.types import ContainerDeviceRequest, DeviceUsage

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOX_NODES = [f"n{i:02d}" for i in range(12, 16)]


@pytest.fixture(autouse=True)
def vendors():
    register_vendors()
    yield
    reset_vendors()


def cluster(host_mem: bool = True, pools: int = 0):
    """16 nodes x 8 cards: n00-n09 H100 with no coordinates (n00-n07
    with a host-memory capacity), n10-n11 A100, n12-n15 H100 with a box
    of coordinates. `pools` > 0 labels the nodes into that many node
    pools (the sharded decide plane's key)."""
    nodes = {}
    for i in range(16):
        name = f"n{i:02d}"
        if 10 <= i < 12:
            devs = cards(name, typ=A100, mb=A100_MB)
        else:
            devs = cards(name, boxed=i >= 12)
        annos = node_annos(devs, host_mem_mb=(262144 if host_mem and i < 8
                                              else 0))
        labels = ({"cloud.google.com/gke-nodepool": f"pool{i % pools}"}
                  if pools else {})
        nodes[name] = (annos, labels)
    return nodes


def run_stream(pair, pods):
    names, placed, refused = [], 0, 0
    for pod, nodes in pods:
        winner = pair.step(pod, nodes)
        names.append(pod["metadata"]["name"])
        if winner is None:
            refused += 1
        else:
            placed += 1
    pair.check_state(names)
    return placed, refused


# ---------------------------------------------------------------------------
# the decide plane: filter, bind, both commit modes, sharded
# ---------------------------------------------------------------------------

STREAMS = {
    # (seed, pods, scheduler kwargs, node pools)
    "pipelined": (1, 200, {"commit_pipeline": True}, 0),
    "inline": (2, 200, {"commit_pipeline": False}, 0),
    "sharded": (3, 200, {"decide_shards": 4}, 4),
    "sharded-inline": (4, 160, {"decide_shards": 4,
                                "commit_pipeline": False}, 4),
}


@pytest.mark.parametrize("case", sorted(STREAMS))
def test_stream_matches_the_reference(case):
    seed, n, kw, pools = STREAMS[case]
    pair = Pair(cluster(pools=pools), **kw)
    try:
        placed, refused = run_stream(
            pair, seeded_pods(seed, n, BOX_NODES))
        # the stream must exercise both answers
        assert placed > 50 and refused > 0, (placed, refused)
    finally:
        pair.stop()


def test_stream_batched_matches_sequential_reference():
    """filter_batch (what /filter's intake calls) on both sides."""
    pair = Pair(cluster())
    try:
        pods = seeded_pods(5, 96, BOX_NODES)
        for batch_start in range(0, len(pods), 16):
            batch = pods[batch_start:batch_start + 16]
            for pod, _ in batch:
                pair.admit(pod)
            results = []
            for side in pair.sides:
                items = [(side.client.get_pod("default",
                                              p["metadata"]["name"]), nodes)
                         for p, nodes in batch]
                results.append([
                    (w, side.norm(f), type(e).__name__ if e else None)
                    for w, f, e in side.sched.filter_batch(items)])
            assert results[1] == results[0]
            for side in pair.sides:
                side.drain()
        pair.check_state([p["metadata"]["name"] for p, _ in pods])
    finally:
        pair.stop()


SCENARIOS = {
    # single cards filling one node: exclusive 100-core cards and the
    # task-slot limit
    "single": [gpu_pod(f"s{i}", 1, mem=3072, cores=25 if i % 3 else 100)
               for i in range(40)],
    # multi-card without the assertion on coordinate-less cards: NUMA
    # groups tried in order before crossing them
    "numa": [gpu_pod(f"m{i}", (2, 4, 3)[i % 3], mem=20480, cores=50)
             for i in range(24)],
    # the contiguous-box rule on cards with coordinates, asserted
    "boxes": [gpu_pod(f"b{i}", (2, 4)[i % 2], mem=12288, cores=25,
                      annotations={api.NUMA_BIND_ANNO: "true"})
              for i in range(24)],
    # host memory against the node's capacity
    "host-memory": [gpu_pod(f"h{i}", 1, mem=3072, cores=25,
                            host_mb=65536) for i in range(12)],
    # use-gputype / nouse-gputype
    "gputype": [gpu_pod(f"t{i}", 1, mem=3072, annotations={
        (api.USE_GPUTYPE_ANNO if i % 2 else api.NOUSE_GPUTYPE_ANNO):
        ("a100" if i % 2 else "H100")}) for i in range(16)],
    # two containers, and a share of the card
    "containers": [gpu_pod(f"c{i}", 2, mem_pct=30, cores=25, containers=2)
                   for i in range(12)],
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_the_reference(name):
    nodes = {
        "n0": (node_annos(cards("n0", numa=(0, 0, 1, 1, 1, 1, 0, 0)),
                          host_mem_mb=200000), {}),
        "n1": (node_annos(cards("n1", typ=A100, mb=A100_MB)), {}),
        "n2": (node_annos(cards("n2", boxed=True)), {}),
    }
    only = {"boxes": ["n2"], "single": ["n0"]}.get(name)
    pair = Pair(nodes)
    try:
        run_stream(pair, [(p, only) for p in SCENARIOS[name]])
    finally:
        pair.stop()


# ---------------------------------------------------------------------------
# task-priority preemption
# ---------------------------------------------------------------------------

def test_preemption_matches_the_reference():
    """Two small nodes filled with best-effort pods, then guaranteed
    arrivals: the same victims are stamped and deleted on both sides,
    and the PREEMPTED / NO_VICTIMS records agree."""
    nodes = {f"n{i}": (node_annos(cards(f"n{i}", n=2, numa=(0, 1))), {})
             for i in range(2)}
    pair = Pair(nodes)
    try:
        names = []
        for i in range(8):
            pod = gpu_pod(f"low{i}", 1, mem=(30000, 20000, 12000)[i % 3],
                          cores=25, priority=1)
            pair.step(pod, None)
            names.append(f"low{i}")
        for i in range(6):
            pod = gpu_pod(f"hi{i}", 1, mem=(40000, 70000)[i % 2],
                          cores=50, priority=0)
            pair.step(pod, None)
            names.append(f"hi{i}")
            for side in pair.sides:
                side.sched.sync_pods()
        decisions = [pair.port.decision(f"hi{i}") for i in range(6)]
        results = [d.get("preemption", {}).get("result") for d in decisions]
        assert "PREEMPTED" in results, results
        deleted = [n for n in names
                   if pair.port.annotations(n) == {"<deleted>": True}]
        assert deleted, "no victim was deleted"
        pair.check_state(names)
    finally:
        pair.stop()


# ---------------------------------------------------------------------------
# a gang slice reservation and recover()
# ---------------------------------------------------------------------------

def gang_pod(name, hosts=3):
    return gpu_pod(name, 2, mem=12288, cores=25, annotations={
        api.SLICE_GROUP_ANNO: "job1", api.SLICE_HOSTS_ANNO: str(hosts)})


@pytest.mark.parametrize("pipeline", [True, False])
def test_gang_and_recover_match_the_reference(pipeline):
    nodes = {f"h{i}": (node_annos(cards(f"h{i}", n=4, numa=(0, 0, 1, 1)),
                                  slice_anno=f"sliceA;{i}-0-0"), {})
             for i in range(5)}
    pair = Pair(nodes, commit_pipeline=pipeline)
    try:
        hosts = sorted(nodes)
        for name in ("g0", "g1"):
            assert pair.step(gang_pod(name), hosts) is not None
        blocks = [s.sched.slices.block_of(("default", "job1"))
                  for s in pair.sides]
        assert blocks[1] == blocks[0] and blocks[1] is not None
        # a scheduler restart: a fresh one on each side recovers the
        # reservation from the annotation bus
        for side in pair.sides:
            side.drain()
            side.sched.stop()
            for node in hosts:
                side.client.patch_node_annotations(node, {
                    api.HANDSHAKE_ANNO: f"Reported {time.time():.0f}"})
            side.sched = side.new_scheduler()
        restored = [s.sched.recover() for s in pair.sides]
        assert restored == [2, 2]
        assert pair.port.sched.slices.block_of(("default", "job1")) == \
            pair.jax.sched.slices.block_of(("default", "job1")) == blocks[0]
        # the third member lands inside the recovered block; a fourth is
        # over the gang's width
        assert pair.step(gang_pod("g2"), hosts) in blocks[0][1]
        assert pair.step(gang_pod("g3"), hosts) is None
        pair.check_state(["g0", "g1", "g2", "g3"])
    finally:
        pair.stop()


def test_migration_reservation_matches_the_reference():
    """A durable migrating-to stamp on the bus reserves its destination
    on both sides (the `#mig` reservation), so a later pod sees the
    destination's capacity taken."""
    assert MIG_RESERVATION_SUFFIX == JAX_MIG_SUFFIX
    nodes = {f"n{i}": (node_annos(cards(f"n{i}", n=1, numa=(0,))), {})
             for i in range(2)}
    pair = Pair(nodes)
    try:
        src = pair.step(gpu_pod("m", 1, mem=50000), None)
        dest = "n1" if src == "n0" else "n0"
        stamp = codec.encode_migrating_to(1, dest, [[types.ContainerDevice(
            uuid=f"GPU-{dest}-0", usedmem=50000)]])
        for side in pair.sides:
            side.client.patch_pod_annotations("default", "m", {
                api.MIGRATING_TO_ANNO: stamp})
            side.sched.sync_pods()
        # 50000 of the card's 81559 MiB are held on both nodes now
        assert pair.step(gpu_pod("big", 1, mem=40000), None) is None
        pair.check_state(["m", "big"])
    finally:
        pair.stop()


# ---------------------------------------------------------------------------
# the webhook's patch
# ---------------------------------------------------------------------------

def _privileged(pod):
    pod["spec"]["containers"][0]["securityContext"] = {"privileged": True}
    return pod


def _with_env(pod):
    pod["spec"]["containers"][0]["env"] = [{"name": "A", "value": "1"}]
    return pod


WEBHOOK_PODS = {
    "plain": lambda: gpu_pod("w", 1, mem=3072, cores=50),
    "priority-0": lambda: gpu_pod("w", 1, mem=3072, priority=0),
    "priority-1-env": lambda: _with_env(gpu_pod("w", 1, priority=1)),
    "host-memory": lambda: gpu_pod("w", 1, host_mb=4096, containers=2),
    "host-memory-annotated": lambda: gpu_pod(
        "w", 1, annotations={api.HOST_MEM_ANNO: "2048"}),
    "host-memory-malformed": lambda: gpu_pod(
        "w", 1, annotations={api.HOST_MEM_ANNO: "lots"}),
    "host-memory-without-gpu": lambda: {
        "metadata": {"name": "w", "namespace": "default",
                     "annotations": {api.HOST_MEM_ANNO: "1024"}},
        "spec": {"containers": [{"name": "c"}]}},
    "priority-malformed": lambda: gpu_pod(
        "w", 1, annotations={api.TASK_PRIORITY_ANNO: "high"}),
    "priority-negative": lambda: gpu_pod("w", 1, priority=-1),
    "migration-stamp": lambda: gpu_pod(
        "w", 1, annotations={api.MIGRATING_TO_ANNO: "1;n1;x"}),
    "no-gpu": lambda: {"metadata": {"name": "w", "namespace": "default"},
                       "spec": {"containers": [{"name": "c"}]}},
    "privileged": lambda: _privileged(gpu_pod("w", 1)),
    "no-uid": lambda: {k: v for k, v in gpu_pod("w", 1).items()},
}


@pytest.mark.parametrize("case", sorted(WEBHOOK_PODS))
def test_webhook_patch_matches_the_reference(case):
    from vtpu.scheduler.webhook import handle_admission_review as jax_hook
    from vtpu_torch.scheduler.webhook import \
        handle_admission_review as port_hook

    pods = [WEBHOOK_PODS[case]() for _ in range(2)]
    if case == "no-uid":
        for pod in pods:
            pod["metadata"].pop("uid")
    reviews = [hook({"apiVersion": "admission.k8s.io/v1",
                     "kind": "AdmissionReview",
                     "request": {"uid": "rev", "object": pod}})
               for hook, pod in zip((jax_hook, port_hook), pods)]
    # the denial names the priority resource by its constant: the TPU's
    # google.com/priority there, the port's nvidia.com/priority here
    jax = json.loads(json.dumps(to_port_strings(decode_review(
        reviews[0]))).replace(jax_types.RESOURCE_PRIORITY,
                              api.RESOURCE_PRIORITY))
    assert decode_review(reviews[1]) == jax
    if case == "plain":
        patch = decode_review(reviews[1])["response"]["patch"]
        assert patch[0]["value"]["schedulerName"] == "vtpu-scheduler"


def test_webhook_update_guard_matches_the_reference():
    from vtpu.scheduler.webhook import handle_admission_review as jax_hook
    from vtpu_torch.scheduler.webhook import \
        handle_admission_review as port_hook

    old = gpu_pod("w", 1)
    new = gpu_pod("w", 1, annotations={api.MIGRATED_FROM_ANNO: "1:n1"})
    for user in ("alice", "system:serviceaccount:kube-system:"
                          "vtpu-scheduler"):
        reviews = [hook({"request": {
            "uid": "u", "operation": "UPDATE", "object": new,
            "oldObject": old, "userInfo": {"username": user}}})
            for hook in (jax_hook, port_hook)]
        assert reviews[1] == to_port_strings(reviews[0])


# ---------------------------------------------------------------------------
# F8: numa-bind on cards with no mesh coordinate
# ---------------------------------------------------------------------------

def _usages(numa, full=()):
    return [DeviceUsage(id=f"GPU-{i}", index=i, used=1 if i in full else 0,
                        count=10, usedmem=H100_MB if i in full else 0,
                        totalmem=H100_MB, usedcores=0, totalcores=100,
                        numa=n, mesh=None, type=H100)
            for i, n in enumerate(numa)]


def _jax_usages(numa, full=()):
    return [jax_types.DeviceUsage(**{k: getattr(u, k) for k in (
        "id", "index", "used", "count", "usedmem", "totalmem", "usedcores",
        "totalcores", "numa", "mesh", "type", "health")})
        for u in _usages(numa, full)]


REQ = ContainerDeviceRequest(nums=2, type="NVIDIA", memreq=12288,
                             coresreq=25)
BIND = {api.NUMA_BIND_ANNO: "true"}


@pytest.mark.parametrize("numa", [(0, 0, 0, 0), (0, 0, 1, 1), (0, 1, 1, 1)])
def test_f8_numa_bind_places_inside_one_numa_node(numa):
    """The JAX scorer refuses a 2-card numa-bind request on 4 free
    coordinate-less cards whatever the NUMA layout (the TPU rule wants a
    contiguous ICI box); the port places it inside one NUMA node, on
    exactly the cards the request without the assertion gets."""
    jax_got = jax_score.fit_in_certain_device(_jax_usages(numa), REQ, BIND)
    assert jax_got is None
    unbound = port_score.fit_in_certain_device(_usages(numa), REQ, {})
    bound = port_score.fit_in_certain_device(_usages(numa), REQ, BIND)
    jax_unbound = jax_score.fit_in_certain_device(_jax_usages(numa), REQ,
                                                  {})
    assert [d.uuid for d in unbound] == [d.uuid for d in jax_unbound]
    assert bound is not None
    assert [d.uuid for d in bound] == [d.uuid for d in unbound]
    assert len({numa[int(d.uuid.split("-")[1])] for d in bound}) == 1
    # through the whole decide plane: same node on both sides but for
    # the assertion, where the JAX side refuses with its mesh rejection
    nodes = {"n0": (node_annos(cards("n0", n=4, numa=numa)), {})}
    pair = Pair(nodes)
    try:
        for side in pair.sides:
            side.admit(gpu_pod("f8", 2, mem=12288, cores=25,
                               annotations=BIND))
        (wj, fj), (wp, fp) = (s.filter("f8", None) for s in pair.sides)
        assert wj is None and "no contiguous ICI sub-mesh" in fj["n0"]
        assert wp == "n0" and fp == {}
        pair.port.drain()
        (placed,) = codec.decode_pod_devices(
            pair.port.annotations("f8")[api.TO_ALLOCATE_ANNO])
        assert [d.uuid for d in placed] == [
            d.uuid.replace("GPU-", "GPU-n0-") for d in unbound]
    finally:
        pair.stop()


def test_f8_numa_bind_refused_with_a_numa_rejection():
    """Every node has only 1 fitting card per NUMA node: the port refuses
    the numa-bind pod with a rejection that names NUMA, and still places
    the same pod without the assertion across the NUMA nodes."""
    numa = (0, 0, 1, 1)
    full = (1, 3)
    assert port_score.fit_in_certain_device(_usages(numa, full), REQ,
                                            BIND) is None
    rej = port_score.explain_request_failure(_usages(numa, full), REQ,
                                             BIND, 0)
    assert rej.code == port_decision.NODE_NUMA
    assert "NUMA" in str(rej)
    assert rej.detail["numa_most"] == 1 and rej.detail["fitting"] == 2
    crossing = port_score.fit_in_certain_device(_usages(numa, full), REQ,
                                                {})
    assert [d.uuid for d in crossing] == ["GPU-0", "GPU-2"]

    nodes = {f"n{i}": (node_annos(cards(f"n{i}", n=2, numa=(0, 1))), {})
             for i in range(3)}
    pair = Pair(nodes)
    try:
        for side in pair.sides:
            side.admit(gpu_pod("f8", 2, mem=12288, annotations=BIND))
        winner, failed = pair.port.filter("f8", None)
        assert winner is None
        assert all("no NUMA node holds 2" in failed[n] for n in nodes)
        rejections = pair.port.decision("f8")["rejections"]
        assert {r["code"] for r in rejections.values()} == {"numa"}
        jax_winner, _ = pair.jax.filter("f8", None)
        assert jax_winner is None
    finally:
        pair.stop()


def test_f8_coordinates_keep_the_box_rule():
    """Cards that carry coordinates keep the contiguous-box rule: the
    port answers as the JAX scorer does."""
    boxed = [DeviceUsage(id=f"GPU-{i}", index=i, count=10,
                         totalmem=H100_MB, totalcores=100, numa=i // 2,
                         mesh=types.MeshCoord(i, 0, 0), type=H100)
             for i in (0, 2, 3)]
    jax_boxed = [jax_types.DeviceUsage(
        id=u.id, index=u.index, count=10, totalmem=H100_MB,
        totalcores=100, numa=u.numa,
        mesh=jax_types.MeshCoord(u.mesh.x, 0, 0), type=H100) for u in boxed]
    port = port_score.fit_in_certain_device(boxed, REQ, BIND)
    jax = jax_score.fit_in_certain_device(jax_boxed, REQ, BIND)
    assert [d.uuid for d in port] == [d.uuid for d in jax] == [
        "GPU-2", "GPU-3"]


# ---------------------------------------------------------------------------
# import hygiene and the daemon
# ---------------------------------------------------------------------------

def test_scheduler_imports_neither_jax_nor_vtpu_nor_torch():
    code = ("import json, sys, vtpu_torch.scheduler, "
            "vtpu_torch.scheduler.routes, vtpu_torch.scheduler.__main__, "
            "vtpu_torch.scheduler.loadtest, vtpu_torch.scheduler.livemove, "
            "vtpu_torch.ha, vtpu_torch.scheduler.migrate, "
            "vtpu_torch.scheduler.rebalancer; "
            "print(json.dumps(sorted(m for m in sys.modules if "
            "m.split('.')[0] in ('jax', 'vtpu', 'torch'))))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout) == []
    help_ = subprocess.run([sys.executable, "-m", "vtpu_torch.scheduler",
                            "--help"], cwd=REPO, capture_output=True,
                           text=True, timeout=120)
    assert help_.returncode == 0 and "--fake-kube" in help_.stdout
    for flag in ("--ha", "--lease-name", "--lease-namespace"):
        assert flag in help_.stdout


# the daemon in a thread of its own process on an in-memory apiserver;
# prints its threads and the apiserver's leases once the threads the
# case names run
_DAEMON = r"""
import json, socket, sys, threading, time
from vtpu_torch.scheduler.__main__ import main
from vtpu_torch.util.client import FakeKubeClient

want = sys.argv[1].split(",")
n_leases = int(sys.argv[2])  # a group coordinator takes its leases in turn
argv = sys.argv[3:]


def port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


client = FakeKubeClient()
threading.Thread(target=main, args=([
    "--http-bind", f"127.0.0.1:{port()}",
    "--metrics-bind", f"127.0.0.1:{port()}", *argv],),
    kwargs={"client": client}, daemon=True).start()
deadline = time.time() + 60
while time.time() < deadline:
    names = sorted(t.name for t in threading.enumerate())
    leases = sorted((k, v["spec"]["holderIdentity"],
                     v["spec"]["leaseTransitions"])
                    for k, v in client._leases.items())
    if all(w in names for w in want if w != "lease") and (
            len(leases) >= n_leases):
        break
    time.sleep(0.05)
print(json.dumps({"threads": names, "leases": leases}), flush=True)
"""


@pytest.mark.parametrize("want,argv,env,leases", [
    # --ha: one lease, an HACoordinator that promotes this instance
    ("vtpu-ha-coordinator,lease", ["--ha"], {},
     [["kube-system/vtpu-scheduler", "sched-0", 1]]),
    # the lease's name and namespace from the flags
    ("vtpu-ha-coordinator,lease",
     ["--ha", "--lease-name", "vgpu-leader", "--lease-namespace", "ops"],
     {}, [["ops/vgpu-leader", "sched-0", 1]]),
    # VTPU_SHARD_GROUPS=2 with --ha: a GroupCoordinator, one lease a group
    ("vtpu-ha-groups,lease", ["--ha"],
     {"VTPU_SHARD_GROUPS": "2", "VTPU_DECIDE_SHARDS": "2",
      "VTPU_SCHEDULER_PEERS": "1"},
     [["kube-system/vtpu-scheduler-g00", "sched-0", 1],
      ["kube-system/vtpu-scheduler-g01", "sched-0", 1]]),
    # VTPU_REBALANCE_S: the rebalancer; no --ha, no lease
    ("vtpu-rebalancer", [], {"VTPU_REBALANCE_S": "5"}, []),
    # VTPU_MIGRATE_S: the planner
    ("vtpu-migrate", [], {"VTPU_MIGRATE_S": "1"}, []),
])
def test_daemon_runs_what_cmd_scheduler_runs(want, argv, env, leases):
    """cmd/scheduler.py:71-211 on the port: --ha joins the leader-elected
    pair (an HACoordinator on one lease, a GroupCoordinator with a lease a
    shard group under VTPU_SHARD_GROUPS), and a period above 0 starts the
    rebalancer or the migration planner."""
    out = subprocess.run(
        [sys.executable, "-c", _DAEMON, want, str(len(leases)), *argv],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=REPO, POD_NAME="sched-0", **env))
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    for name in want.split(","):
        if name != "lease":
            assert name in got["threads"], got
    assert got["leases"] == leases
    loops = {"vtpu-rebalancer", "vtpu-migrate"}
    assert loops & set(got["threads"]) == loops & set(want.split(","))


def test_metric_families_are_renamed_and_coexist():
    """Both packages' module-level collectors live in one process (the
    default registry would raise "Duplicated timeseries" otherwise), and
    each port family is its JAX family with vTPU -> vGPU."""
    from prometheus_client import CollectorRegistry, generate_latest

    from vtpu.scheduler import metrics as jax_metrics
    from vtpu_torch.scheduler import metrics as port_metrics

    def families(mod):
        return sorted(v._name for v in vars(mod).values()
                      if hasattr(v, "_name") and hasattr(v, "_type"))

    assert families(port_metrics) == [
        n.replace("vTPU", "vGPU") for n in families(jax_metrics)]
    assert all(n.startswith("vGPU") for n in families(port_metrics))
    pair = Pair({"n0": (node_annos(cards("n0", n=2, numa=(0, 1))), {})})
    try:
        pair.step(gpu_pod("p", 1, mem=3072), None)
        texts = []
        for side, mod in zip(pair.sides, (jax_metrics, port_metrics)):
            reg = CollectorRegistry()
            reg.register(mod.SchedulerCollector(side.sched))
            texts.append(generate_latest(reg).decode())
        assert texts[1] == texts[0].replace("vTPU", "vGPU")
        assert 'vGPUPodsDeviceAllocated{containeridx="0",deviceuuid=' \
               '"GPU-n0-0",nodename="n0"' in texts[1]
    finally:
        pair.stop()


@pytest.mark.parametrize("seed", range(3))
def test_pod_cache_find_matches_the_reference(seed):
    """The port's PodManager.find gives the JAX one's answer after a seeded
    run of adds (recreated names with new uids, re-adds under a new name),
    deletes and whole-cache replacements."""
    import numpy as np

    from vtpu.scheduler.pods import PodInfo as JaxPodInfo
    from vtpu.scheduler.pods import PodManager as JaxPods
    from vtpu_torch.scheduler.pods import PodInfo, PodManager

    rng = np.random.default_rng(seed)
    jax, port = JaxPods(), PodManager()
    live = []
    for step in range(400):
        op = rng.choice(["add", "add", "del", "replace"])
        ns = f"ns{int(rng.integers(2))}"
        name = f"p{int(rng.integers(12))}"
        if op == "add":
            uid = f"u{int(rng.integers(30))}" if rng.random() < 0.9 else ""
            for mgr in (jax, port):
                mgr.add_pod(ns, name, uid, "n0", [])
            live.append((ns, name, uid))
        elif op == "del" and live:
            ns, name, uid = live.pop(int(rng.integers(len(live))))
            for mgr in (jax, port):
                mgr.del_pod(ns, name, uid)
        elif op == "replace":
            keep = [p for p in live if rng.random() < 0.7]
            jax.replace_all([JaxPodInfo(n, m, u, "n0") for n, m, u in keep])
            port.replace_all([PodInfo(n, m, u, "n0") for n, m, u in keep])
            live = keep
        for ns in ("ns0", "ns1"):
            for i in range(12):
                got, want = port.find(ns, f"p{i}"), jax.find(ns, f"p{i}")
                assert (got is None) == (want is None), step
                if got is not None:
                    assert (got.namespace, got.name, got.uid) == (
                        want.namespace, want.name, want.uid), step


# ---------------------------------------------------------------------------
# the cluster-scale drive (chip_smoke.py phase (n)), at a small size
# ---------------------------------------------------------------------------

def test_loadtest_small_cluster_passes_its_gates():
    """16 nodes x 8 cards and 400 seeded pods through the daemon's HTTP
    entry points, the daemon in its own process: every gate holds and
    the stream fills the cluster far enough to refuse some pods."""
    out = subprocess.run(
        [sys.executable, "-m", "vtpu_torch.scheduler.loadtest",
         "--nodes", "16", "--pods", "400", "--seed", "3"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["ok"] and res["modules"] == []
    assert res["placed"] + res["refused"] == 400
    assert res["placed"] > 100 and res["refused"] > 0
    assert res["numa_bind_pods"] > 0 and res["ms"]["filter"]["n"] == 400


def test_loadtest_gates_catch_what_they_guard():
    """The recomputed usage flags an overcommitted card, and the plain
    first-fit finds the node a wrong refusal left out; a numa-bind
    request needs its cards on one NUMA node."""
    from vtpu_torch.scheduler import loadtest

    nodes = {"a": loadtest.node_cards("a", H100, H100_MB)}
    usage = loadtest.Usage(nodes)
    req = {"count": 2, "mem": 40000, "cores": 50, "numa_bind": True}
    assert usage.first_fit(req) == "a"
    # leave one free card on each NUMA node (cards 3 and 7)
    fill = [[types.ContainerDevice(uuid=f"GPU-a-{i}", usedmem=H100_MB,
                                   usedcores=100)]
            for i in (0, 1, 2, 4, 5, 6)]
    usage.add(codec.encode_pod_devices(fill))
    assert usage.first_fit(req) is None
    assert usage.first_fit(dict(req, numa_bind=False)) == "a"
    assert usage.overcommitted() == []
    usage.add(codec.encode_pod_devices([[types.ContainerDevice(
        uuid="GPU-a-3", usedmem=H100_MB, usedcores=100)]]))
    usage.add(codec.encode_pod_devices([[types.ContainerDevice(
        uuid="GPU-a-3", usedmem=1, usedcores=1)]]))
    assert usage.overcommitted() == ["GPU-a-3"]


def test_patch_pod_device_annotations_matches_the_reference():
    """The assignment write a Filter winner makes, in both codecs: the
    same annotations, the wall-clock stamp aside."""
    from vtpu.util import podutil as jax_podutil
    from vtpu.util.client import FakeKubeClient as JaxClient
    from vtpu_torch.util import podutil
    from vtpu_torch.util.client import FakeKubeClient

    got = []
    for client, util in ((JaxClient(), jax_podutil),
                         (FakeKubeClient(), podutil)):
        pod = client.add_pod(gpu_pod("a", 2, mem=3072))
        devices = [[types.ContainerDevice(uuid=f"GPU-{i}", usedmem=3072,
                                          usedcores=25) for i in range(2)]]
        util.patch_pod_device_annotations(client, pod, "n1", devices)
        annos = client.get_pod("default", "a")["metadata"]["annotations"]
        annos[api.ASSIGNED_TIME_ANNO] = "<time>"
        got.append(annos)
    assert got[1] == got[0]
    assert got[1][api.ASSIGNED_NODE_ANNO] == "n1"
