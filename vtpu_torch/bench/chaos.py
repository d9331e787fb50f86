"""Fault injection against an HA scheduler pair, for the soak harness
(vtpu_torch/bench/soak.py): the port of tests/test_ha_chaos.py's
``ChaosCluster`` onto vtpu_torch.ha and vtpu_torch.scheduler.

The in-memory ``FakeKubeClient`` is the durable apiserver; ``Scheduler``
objects are the processes. The harness can

- **SIGKILL** the active scheduler: its commit pipeline stops dead and
  everything queued is dropped (``Committer.kill``), what a killed process
  leaves behind;
- **freeze** a scheduler's commit pipeline: decisions queue and never land
  (a kill in the middle of the queue's drain);
- **promote** the standby: a lease steal at a bumped generation and the
  crash-recovery rebuild before its first decision.

The hosts are plain node-pool hosts (node i in pool i % pools), each with
four 16 GiB NVIDIA cards under the JAX harness's names (``chip-0`` ..
``chip-3``). The slice (multi-host gang) hosts of the JAX harness are left
out: the soak never places a gang across hosts, and NVML gives a card no
mesh coordinate. Its audit is the JAX harness's: per (node, card) the
durable assignments' tasks, memory and cores fit the card.
"""

from __future__ import annotations

import time
from typing import Dict, List

from ..ha import ClusterLease, HACoordinator
from ..scheduler import Scheduler
from ..scheduler import committer as committermod
from ..util import codec, types
from ..util.client import FakeKubeClient
from ..util.types import DeviceInfo

POOL_LABEL = "cloud.google.com/gke-nodepool"
#: the JAX harness's chips (tests/test_slice.py make_inventory): 4 x 16 GiB
CARDS = 4
CARD_MB = 16384
CARD_TYPE = "NVIDIA-Tesla V100-SXM2-16GB"


class FakeClock:
    """a lease clock the harness moves by hand"""

    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def make_inventory(n: int = CARDS, devmem: int = CARD_MB) -> List[DeviceInfo]:
    return [DeviceInfo(id=f"chip-{i}", index=i, count=10, devmem=devmem,
                       devcore=100, type=CARD_TYPE, numa=0)
            for i in range(n)]


class ChaosCluster:
    """One in-memory apiserver and a sequence of leader-elected
    schedulers over ``n_hosts`` hosts labelled into ``pools`` node pools
    (the label keys each host's decide shard, so a failover repopulates
    several shards' overlays)."""

    LEASE_S = 15.0

    def __init__(self, n_hosts: int = 4, pools: int = 1):
        self.clock = FakeClock()
        self.client = FakeKubeClient()
        self.hosts = [f"a{i}" for i in range(n_hosts)]
        for i, node in enumerate(self.hosts):
            self.client.add_node(node, annotations={
                types.HANDSHAKE_ANNO: f"Reported {time.time():.0f}",
                types.NODE_REGISTER_ANNO: codec.encode_node_devices(
                    make_inventory()),
            }, labels={POOL_LABEL: f"pool-{i % pools}"})

    def rereport(self) -> None:
        """The node plugins re-report inventory every registration poll;
        a newly spawned scheduler consumes the next Reported handshake."""
        for node in self.hosts:
            self.client.patch_node_annotations(node, {
                types.HANDSHAKE_ANNO: f"Reported {time.time():.0f}"})

    def spawn(self, identity: str) -> Scheduler:
        """A scheduler process joined to the leader-election pair (warm:
        inventory ingested, standby until its coordinator polls)."""
        s = Scheduler(self.client)
        lease = ClusterLease(self.client, identity=identity,
                             lease_s=self.LEASE_S, clock=self.clock)
        s.ha = HACoordinator(lease, on_promote=lambda gen: s.recover())
        self.rereport()
        s.register_from_node_annotations_once()
        return s

    def elect(self, s: Scheduler) -> bool:
        """Drive one coordinator poll (promotion runs recover())."""
        s.ha.poll_once()
        return s.ha.is_leader()

    def promote(self, s: Scheduler) -> bool:
        """Fail over to ``s``: the successor first observes the dead
        holder's last renewal, a full lease window passes with no change,
        then its next poll steals and promotes (recover runs inside the
        promotion)."""
        s.ha.poll_once()
        self.expire_lease()
        s.ha.poll_once()
        return s.ha.is_leader()

    def sigkill(self, s: Scheduler) -> None:
        """Process death: queued commits vanish, nothing unwinds."""
        s.ha.lease._held = False  # a dead process renews nothing
        s.committer.kill()

    def expire_lease(self) -> None:
        self.clock.advance(self.LEASE_S + 1.0)

    def freeze_pipeline(self, s: Scheduler) -> None:
        """Replace the committer with one whose workers never start:
        decisions queue and no patch ever lands."""
        s.committer.close()
        frozen = committermod.Committer(
            self.client, on_permanent_failure=s._on_commit_failed,
            fence=s._fence_generation)
        frozen._started = True  # no worker thread will ever run
        s.committer = frozen

    # -- invariants --------------------------------------------------------

    def assert_no_double_booked_chips(self, s: Scheduler) -> None:
        """Per (node, card): the durable assignments' tasks, memory and
        cores never exceed the card's registered capacity."""
        usage: Dict[tuple, List[int]] = {}
        for pod in self.client.list_pods_all_namespaces():
            annos = pod.get("metadata", {}).get("annotations", {}) or {}
            node = annos.get(types.ASSIGNED_NODE_ANNO)
            if not node:
                continue
            for ctr in codec.decode_pod_devices(
                    annos.get(types.ASSIGNED_IDS_ANNO, "")):
                for d in ctr:
                    slot = usage.setdefault((node, d.uuid), [0, 0, 0])
                    slot[0] += 1
                    slot[1] += d.usedmem
                    slot[2] += d.usedcores
        for (node, uuid), (tasks, mem, cores) in usage.items():
            info = s.nodes.get_node(node)
            assert info is not None, f"assignment on unknown node {node}"
            card = next(d for d in info.devices if d.id == uuid)
            assert tasks <= card.count, (node, uuid, tasks)
            assert mem <= card.devmem, (node, uuid, mem)
            assert cores <= card.devcore, (node, uuid, cores)
