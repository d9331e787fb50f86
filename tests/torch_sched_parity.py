"""Harness of the scheduler parity tests (tests/test_torch_scheduler.py,
tests/test_torch_routes.py): the JAX scheduler, with the port's
``GPUDevices`` registered into its vendor registry at run time, and the
port's scheduler get the same node annotations (encoded once by the
port's codec, which is wire-identical to the JAX one), the same seeded
pods, and each its own in-memory apiserver. Their answers are compared
after the JAX side's strings are mapped ``vTPU`` -> ``vGPU``, the one
rename between the packages."""

from __future__ import annotations

import base64
import copy
import json
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from vtpu import device as jax_device
from vtpu.device import config as jax_config
from vtpu.scheduler import Scheduler as JaxScheduler
from vtpu.scheduler import webhook as jax_webhook
from vtpu.scheduler.routes import build_app as jax_build_app
from vtpu.trace import tracer as jax_tracer
from vtpu.util import nodelock as jax_nodelock
from vtpu.util.client import FakeKubeClient as JaxClient

from vtpu_torch import api
from vtpu_torch import device as port_device
from vtpu_torch.device import config as port_config
from vtpu_torch.device.gpu import GPUDevices
from vtpu_torch.scheduler import Scheduler as PortScheduler
from vtpu_torch.scheduler import webhook as port_webhook
from vtpu_torch.scheduler.routes import build_app as port_build_app
from vtpu_torch.trace import tracer as port_tracer
from vtpu_torch.util import codec, nodelock as port_nodelock
from vtpu_torch.util.client import FakeKubeClient as PortClient
from vtpu_torch.util.types import DeviceInfo, MeshCoord

H100 = "NVIDIA-NVIDIA H100 80GB HBM3"
H100_MB = 81559
A100 = "NVIDIA-NVIDIA A100-SXM4-40GB"
A100_MB = 40960
HGX_NUMA = (0, 0, 0, 0, 1, 1, 1, 1)
# annotations stamped with wall-clock times: compared for presence only
TIME_ANNOS = (api.ASSIGNED_TIME_ANNO, api.BIND_TIME_ANNO)


def register_vendors() -> None:
    """Both registries as the parity tests use them: the JAX one with
    its TPU vendor and the port's GPUDevices beside it, the port's with
    GPUDevices; both with the default scheduling config."""
    jax_device.init_default_devices()
    jax_device.register(GPUDevices())
    port_device.init_default_devices()
    for cfg in (jax_config.GLOBAL, port_config.GLOBAL):
        cfg.default_mem = 0
        cfg.default_cores = 0
    jax_tracer.reset()
    port_tracer.reset()


def reset_vendors() -> None:
    jax_device.reset_registry()
    port_device.reset_registry()


def to_port_strings(obj: Any) -> Any:
    """The JAX side's answer with ``vTPU`` -> ``vGPU`` in every string."""
    if isinstance(obj, str):
        return obj.replace("vTPU", "vGPU")
    if isinstance(obj, dict):
        return {to_port_strings(k): to_port_strings(v)
                for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [to_port_strings(v) for v in obj]
    return obj


# ---------------------------------------------------------------------------
# inventories and pods
# ---------------------------------------------------------------------------

def cards(node: str, n: int = 8, typ: str = H100, mb: int = H100_MB,
          numa=HGX_NUMA, boxed: bool = False,
          count: int = 10) -> List[DeviceInfo]:
    """A node's cards as the port's plugin registers them (no mesh
    coordinate, as NVML reports), or with a 2 x (n/2) box of
    coordinates."""
    return [DeviceInfo(id=f"GPU-{node}-{i}", index=i, count=count,
                       devmem=mb, devcore=100, type=typ, numa=numa[i],
                       mesh=MeshCoord(i % 2, i // 2, 0) if boxed else None)
            for i in range(n)]


def node_annos(devs: List[DeviceInfo], host_mem_mb: int = 0,
               slice_anno: str = "") -> Dict[str, str]:
    annos = {api.HANDSHAKE_ANNO: f"Reported {time.time():.0f}",
             api.NODE_REGISTER_ANNO: codec.encode_node_devices(devs)}
    if host_mem_mb:
        annos[api.NODE_HOST_MEM_ANNO] = str(host_mem_mb)
    if slice_anno:
        annos[api.NODE_SLICE_ANNO] = slice_anno
    return annos


def gpu_pod(name: str, count: int = 1, mem: Optional[int] = None,
            cores: Optional[int] = None, mem_pct: Optional[int] = None,
            priority: Optional[int] = None, host_mb: Optional[int] = None,
            containers: int = 1, annotations=None,
            ns: str = "default") -> Dict[str, Any]:
    limits: Dict[str, Any] = {api.RESOURCE_GPU: count}
    for key, value in ((api.RESOURCE_MEM, mem), (api.RESOURCE_CORES, cores),
                       (api.RESOURCE_MEM_PERCENT, mem_pct),
                       (api.RESOURCE_PRIORITY, priority),
                       (api.RESOURCE_HOST_MEM, host_mb)):
        if value is not None:
            limits[key] = value
    return {
        "metadata": {"name": name, "namespace": ns, "uid": f"uid-{name}",
                     "annotations": dict(annotations or {})},
        "spec": {"containers": [
            {"name": f"c{i}", "resources": {"limits": dict(limits)}}
            for i in range(containers)]},
        "status": {"phase": "Pending"},
    }


def seeded_pods(seed: int, n: int, box_nodes: List[str],
                numa_bind_multi: bool = True,
                priorities: bool = False) -> List[Tuple[Dict, Optional[
                    List[str]]]]:
    """(pod, candidate node names or None for all) from a numpy seed:
    1-card pods at 3,072 / 12,288 / 20,480 MiB or a share of the card,
    25 / 50 / 100 cores; 2- and 4-card pods with and without numa-bind;
    8-card whole-node pods; type constraints; host memory; two-container
    pods. A multi-card numa-bind pod is offered only the boxed nodes,
    where both schedulers keep the contiguous-box rule (on cards with no
    coordinate the port places it inside one NUMA node, the one allowed
    difference, which tests/test_torch_scheduler.py shows on its own)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        kind = rng.choice(["one", "one", "one", "multi", "whole", "typed",
                           "host", "two"])
        name = f"p{seed}-{i}"
        annos: Dict[str, str] = {}
        nodes = None
        prio = int(rng.integers(0, 2)) if priorities else None
        mem = int(rng.choice([3072, 12288, 20480]))
        cores = int(rng.choice([25, 50, 100]))
        if kind == "one":
            if rng.random() < 0.2:
                pod = gpu_pod(name, 1, mem_pct=int(rng.choice([10, 50])),
                              cores=cores, priority=prio)
            else:
                pod = gpu_pod(name, 1, mem=mem, cores=cores, priority=prio)
            if rng.random() < 0.2:
                annos[api.NUMA_BIND_ANNO] = "true"
        elif kind == "multi":
            count = int(rng.choice([2, 4]))
            if numa_bind_multi and rng.random() < 0.5:
                annos[api.NUMA_BIND_ANNO] = "true"
                nodes = list(box_nodes)
            pod = gpu_pod(name, count, mem=mem, cores=int(
                rng.choice([25, 50])), priority=prio)
        elif kind == "whole":
            pod = gpu_pod(name, 8, cores=100, priority=prio)
        elif kind == "typed":
            pod = gpu_pod(name, 1, mem=mem, cores=cores, priority=prio)
            if rng.random() < 0.5:
                annos[api.USE_GPUTYPE_ANNO] = "A100"
            else:
                annos[api.NOUSE_GPUTYPE_ANNO] = "H100,foo"
        elif kind == "host":
            pod = gpu_pod(name, 1, mem=mem, cores=cores, priority=prio,
                          host_mb=int(rng.choice([16384, 65536, 200000])))
        else:
            pod = gpu_pod(name, 1, mem=mem // 2, cores=25, containers=2,
                          priority=prio)
        pod["metadata"]["annotations"].update(annos)
        out.append((pod, nodes))
    return out


# ---------------------------------------------------------------------------
# one scheduler with its apiserver
# ---------------------------------------------------------------------------

class Side:
    """One package's scheduler, webhook and apiserver."""

    def __init__(self, port: bool, nodes: Dict[str, Tuple[Dict, Dict]],
                 **sched_kw) -> None:
        self.port = port
        self.client = (PortClient if port else JaxClient)()
        self.webhook = port_webhook if port else jax_webhook
        self.tracer = port_tracer if port else jax_tracer
        self.nodelock = port_nodelock if port else jax_nodelock
        self.build_app = port_build_app if port else jax_build_app
        self.sched_cls = PortScheduler if port else JaxScheduler
        self.sched_kw = sched_kw
        for name, (annos, labels) in nodes.items():
            self.client.add_node(name, annotations=dict(annos),
                                 labels=dict(labels))
        self.sched = self.new_scheduler()

    def new_scheduler(self):
        s = self.sched_cls(self.client, **self.sched_kw)
        s.register_from_node_annotations_once()
        return s

    def norm(self, obj: Any) -> Any:
        return obj if self.port else to_port_strings(obj)

    def admit(self, pod: Dict) -> Dict:
        """The webhook's review of `pod`; an allowed pod is created."""
        pod = copy.deepcopy(pod)
        review = self.webhook.handle_admission_review(
            {"request": {"uid": f"rev-{pod['metadata']['name']}",
                         "object": pod}})
        if review["response"]["allowed"]:
            self.client.add_pod(pod)
        return review

    def filter(self, name: str, nodes: Optional[List[str]],
               ns: str = "default"):
        winner, failed = self.sched.filter(self.client.get_pod(ns, name),
                                           nodes)
        return winner, self.norm(failed)

    def bind_and_allocate(self, name: str, node: str,
                          ns: str = "default") -> None:
        """Bind, then what Allocate leaves: bind-phase success, lock
        released."""
        self.sched.bind(ns, name, node)
        self.client.patch_pod_annotations(
            ns, name, {api.BIND_PHASE_ANNO: "success"})
        self.nodelock.release_node(self.client, node)

    def annotations(self, name: str, ns: str = "default") -> Dict:
        from vtpu_torch.util.client import NotFoundError as PortNF
        from vtpu.util.client import NotFoundError as JaxNF

        try:
            annos = dict(self.client.get_pod(ns, name)["metadata"].get(
                "annotations") or {})
        except (PortNF, JaxNF):
            return {"<deleted>": True}
        for key in TIME_ANNOS:
            if key in annos:
                annos[key] = "<time>"
        return annos

    def decision(self, name: str, ns: str = "default") -> Optional[Dict]:
        data = self.tracer.trace_for_key(f"{ns}/{name}")
        if data is None or "decision" not in data:
            return None
        dec = dict(data["decision"])
        dec.pop("ts", None)
        return self.norm(dec)

    def usage(self) -> Dict:
        nodes = sorted(self.sched.nodes.list_nodes())
        snap = self.sched.overlay.snapshot(nodes)
        return {n: [(u.id, u.used, u.usedmem, u.usedcores) for u in us]
                for n, us in sorted(snap.items())}

    def drain(self) -> None:
        self.sched.committer.drain()

    def stop(self) -> None:
        self.sched.stop()


class Pair:
    """The JAX and the port side over the same nodes."""

    def __init__(self, nodes: Dict[str, Tuple[Dict, Dict]],
                 **sched_kw) -> None:
        self.jax = Side(False, nodes, **sched_kw)
        self.port = Side(True, nodes, **sched_kw)
        self.sides = (self.jax, self.port)

    def admit(self, pod: Dict) -> Tuple[Dict, Dict]:
        jax, port = (s.admit(pod) for s in self.sides)
        assert decode_review(port) == to_port_strings(decode_review(jax))
        return port

    def step(self, pod: Dict, nodes: Optional[List[str]],
             bind: bool = True) -> Optional[str]:
        """Admit, filter and (on a fit) bind one pod on both sides;
        assert every observable agrees; return the winner."""
        name = pod["metadata"]["name"]
        review = self.admit(pod)
        if not review["response"]["allowed"]:
            return None
        (wj, fj), (wp, fp) = (s.filter(name, nodes) for s in self.sides)
        assert (wp, fp) == (wj, fj), name
        if wp is not None and bind:
            for s in self.sides:
                s.bind_and_allocate(name, wp)
        for s in self.sides:
            s.drain()
        assert self.port.annotations(name) == self.jax.annotations(name)
        assert self.port.decision(name) == self.jax.decision(name), name
        return wp

    def check_state(self, names: List[str]) -> None:
        for s in self.sides:
            s.drain()
            assert s.sched.verify_overlay() == []
        assert self.port.usage() == self.jax.usage()
        for name in names:
            assert self.port.annotations(name) == \
                self.jax.annotations(name), name

    def stop(self) -> None:
        for s in self.sides:
            s.stop()


def decode_review(review: Dict) -> Dict:
    """An AdmissionReview response with its JSON patch decoded."""
    resp = dict(review["response"])
    if "patch" in resp:
        resp["patch"] = json.loads(base64.b64decode(resp["patch"]))
    return dict(review, response=resp)
