"""Harness of the scheduler parity tests (tests/test_torch_scheduler.py,
tests/test_torch_routes.py): the JAX scheduler, with the port's
``GPUDevices`` registered into its vendor registry at run time, and the
port's scheduler get the same node annotations (encoded once by the
port's codec, which is wire-identical to the JAX one), the same seeded
pods, and each its own in-memory apiserver. Their answers are compared
after the JAX side's strings are mapped ``vTPU`` -> ``vGPU``, the one
rename between the packages. ``run_reference_test`` (below) runs the JAX
package's own test functions against either package the same way."""

from __future__ import annotations

import ast
import base64
import contextlib
import copy
import dataclasses
import functools
import importlib
import inspect
import json
import sys
import time
import types as pytypes
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
from _pytest.fixtures import FixtureFunctionDefinition

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
from vtpu_torch.util.types import GPU_VENDOR, DeviceInfo, MeshCoord

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


# ---------------------------------------------------------------------------
# the JAX package's own tests, run against either package
# ---------------------------------------------------------------------------
#
# A test function of the JAX package's suite (tests/test_ha.py, the chaos
# files, tests/test_migrate.py, tests/test_torch_replay_*.py's modules)
# runs here twice on the same inputs: once as written, once with every name
# it takes from ``vtpu`` bound to the port's object of the same name in the
# same module (``vtpu.a.b`` -> ``vtpu_torch.a.b``, PORT_MODULES and
# PORT_ATTRS where the port's name differs). Helpers it takes from other
# test modules are rebound the same way, and imports inside a function
# body find the port's modules (sys.modules is swapped for the call). Its
# module's fixtures are set up from each side's view, every view is built
# afresh for each run, and the port side reads ``vTPU`` as ``vGPU`` in the
# test's string constants. Both runs see the device plane as the port's:
# the TPU's resource, handshake, type-constraint and ``ici-bind`` names
# read as the NVIDIA ones (GPU_NAMES), a request a test builds names the
# GPU's vendor, and the JAX registry holds the port's GPUDevices; but an
# AS_WRITTEN module's JAX side runs with the TPU's own names. Each run
# records what it wrote to its apiserver (every pod annotation, deletion,
# binding, node annotation, each lease's holder and generation), each
# fenced commit and each recover()'s replay count; the records are
# compared after ``vTPU`` -> ``vGPU``.

#: the TPU vendor's names in ``types``/``contracts``, read as the GPU's
GPU_NAMES = {
    "RESOURCE_TPU": api.RESOURCE_GPU, "RESOURCE_MEM": api.RESOURCE_MEM,
    "RESOURCE_CORES": api.RESOURCE_CORES,
    "RESOURCE_PRIORITY": api.RESOURCE_PRIORITY,
    "RESOURCE_HOST_MEM": api.RESOURCE_HOST_MEM,
    "HANDSHAKE_ANNO": api.HANDSHAKE_ANNO,
    "NODE_REGISTER_ANNO": api.NODE_REGISTER_ANNO,
    "TPU_VENDOR": GPU_VENDOR,
    "USE_TPUTYPE_ANNO": api.USE_GPUTYPE_ANNO,
    "NOUSE_TPUTYPE_ANNO": api.NOUSE_GPUTYPE_ANNO,
    "ICI_BIND_ANNO": api.NUMA_BIND_ANNO,
}
#: names only the port's side reads as the GPU's: the JAX workload reads
#: its own env
PORT_NAMES = {"ENV_TENSORCORE_LIMIT": api.ENV_SM_LIMIT}
#: JAX modules and names whose port counterpart has another name
PORT_MODULES = {"vtpu.contracts": "vtpu_torch.api",
                "vtpu.device.tpu": "vtpu_torch.device.gpu"}
PORT_ATTRS = {"TPUDevices": "GPUDevices"}
#: test modules of the TPU vendor and the workload side: their JAX side
#: runs as written (the TPU's names, the JAX registry alone), their
#: port side with the GPU's names and PORT_LITERALS
AS_WRITTEN = {"tests.test_device", "tests.test_enforce"}
#: a whole string constant of an AS_WRITTEN test's code, as the port's
#: side reads it: the vendor's tag (every test's port side also reads
#: ``vTPU`` as ``vGPU`` anywhere in a constant, as to_port_strings does)
PORT_LITERALS = {"TPU": GPU_VENDOR}
#: JAX names with no port counterpart that only tag a function at import
KEEP_JAX = {("vtpu.contracts", "covers_edge")}
#: annotations whose values hold a clock reading: compared for presence
CLOCK_ANNOS = (api.ASSIGNED_TIME_ANNO, api.BIND_TIME_ANNO,
               api.MIGRATE_DEADLINE_ANNO, api.NODE_LOCK_ANNO,
               api.HANDSHAKE_ANNO)

_LOG: List[Any] = []
#: the schedulers a run made: their commits drained before its record is
#: read, then stopped
_SCHEDS: List[Any] = []


class GpuNames:
    """A ``types``/``contracts`` module whose TPU device-plane names read
    as the GPU's (``names``)."""

    def __init__(self, mod, names: Dict[str, Any]) -> None:
        self._mod = mod
        self._names = names

    def __getattr__(self, name: str):
        if name in self._names:
            return self._names[name]
        return getattr(self._mod, name)


def gpu_request(cls):
    """The JAX ``ContainerDeviceRequest`` with the GPU's vendor as its
    default type: a request a test builds names the vendor the JAX
    side's registry places for it, as the port's does."""
    at = [f.name for f in dataclasses.fields(cls)].index("type")

    def make(*args, **kw):
        if len(args) <= at:
            kw.setdefault("type", GPU_VENDOR)
        return cls(*args, **kw)
    return make


def _port_modname(name: str) -> str:
    if name in PORT_MODULES:
        return PORT_MODULES[name]
    return "vtpu_torch" + name[len("vtpu"):]


def _resolve(modname: str, attr: Optional[str], port: bool,
             as_written: bool = False):
    """``from modname import attr`` (``import modname`` when attr is None)
    for one side; ``as_written``: the JAX side sees its own names."""
    if port and (modname, attr) not in KEEP_JAX:
        modname = _port_modname(modname)
        attr = PORT_ATTRS.get(attr, attr)
    mod = importlib.import_module(modname)
    value = mod
    if attr is not None:
        try:
            value = importlib.import_module(f"{modname}.{attr}")
        except ImportError:
            value = getattr(mod, attr)
    if as_written and not port:
        return value
    if isinstance(value, pytypes.ModuleType) and value.__name__.split(
            ".")[-1] in ("types", "contracts", "api"):
        names = {**GPU_NAMES, **PORT_NAMES} if port else dict(GPU_NAMES)
        if not port and hasattr(value, "ContainerDeviceRequest"):
            names["ContainerDeviceRequest"] = gpu_request(
                value.ContainerDeviceRequest)
        return GpuNames(value, names)
    if not port and attr == "ContainerDeviceRequest":
        return gpu_request(value)
    if value is jax_device:
        return JaxDeviceWithGpus()
    return value


class JaxDeviceWithGpus:
    """The JAX ``vtpu.device`` whose default registry also holds the
    port's GPUDevices."""

    def __getattr__(self, name: str):
        return getattr(jax_device, name)

    @staticmethod
    def init_default_devices():
        jax_device.init_default_devices()
        jax_device.register(GPUDevices())


@functools.lru_cache(maxsize=None)
def _imports(modname: str):
    """(module level, anywhere): the ``from vtpu... import`` and ``from
    tests... import`` bindings of a test module's source."""
    src = inspect.getsource(importlib.import_module(modname))
    tree = ast.parse(src)
    top, inner = [], set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module and \
                node.module.split(".")[0] in ("vtpu", "tests"):
            inner.add(node.module)
            for a in node.names:
                inner.add(f"{node.module}.{a.name}")
        elif isinstance(node, ast.Import):
            inner |= {a.name for a in node.names
                      if a.name.split(".")[0] in ("vtpu", "tests")}
    for node in tree.body:
        if isinstance(node, ast.ImportFrom) and node.module and \
                node.module.split(".")[0] in ("vtpu", "tests"):
            for a in node.names:
                top.append((node.module, a.name, a.asname or a.name))
    return top, inner


_VIEWS: Dict[Tuple[str, bool], Dict[str, Any]] = {}


def _port_const(c, literals: Dict[str, str]):
    if isinstance(c, str):
        return literals.get(c, c.replace("vTPU", "vGPU"))
    if isinstance(c, pytypes.CodeType):
        return _port_code(c, literals)
    if isinstance(c, (tuple, frozenset)):
        return type(c)(_port_const(x, literals) for x in c)
    return c


def _port_code(code: pytypes.CodeType,
               literals: Dict[str, str]) -> pytypes.CodeType:
    """``code`` with the port's strings in its constants: ``vTPU`` ->
    ``vGPU`` anywhere, a whole constant in ``literals`` replaced."""
    return code.replace(co_consts=tuple(_port_const(c, literals)
                                        for c in code.co_consts))


class Fixture:
    """A test module's fixture function in one side's view."""

    def __init__(self, fn, autouse: bool) -> None:
        self.fn = fn
        self.autouse = autouse


def _rebind(obj, glb: Dict[str, Any], modname: str, port: bool,
            class_cell=None):
    """``obj`` of test module ``modname`` bound to one side's globals: a
    function's code reads ``glb`` (and on the port's side the port's
    strings), a class is rebuilt of rebound members (``super()`` finds the
    rebuilt class through ``class_cell``), a fixture keeps its flags."""
    if isinstance(obj, pytypes.FunctionType) and obj.__module__ == modname:
        literals = PORT_LITERALS if modname in AS_WRITTEN else {}
        code = _port_code(obj.__code__, literals) if port else obj.__code__
        closure = obj.__closure__
        if class_cell is not None and "__class__" in code.co_freevars:
            closure = tuple(
                class_cell if name == "__class__" else cell
                for name, cell in zip(code.co_freevars, closure))
        defaults = obj.__defaults__
        if port and defaults:
            defaults = tuple(_port_const(d, literals) for d in defaults)
        fn = pytypes.FunctionType(code, glb, obj.__name__, defaults,
                                  closure)
        fn.__kwdefaults__ = obj.__kwdefaults__
        fn.__dict__.update(obj.__dict__)
        fn.__qualname__ = obj.__qualname__
        return fn
    if isinstance(obj, FixtureFunctionDefinition):
        raw = obj._get_wrapped_function()
        if raw.__module__ != modname:
            return obj
        return Fixture(_rebind(raw, glb, modname, port),
                       obj._fixture_function_marker.autouse)
    if isinstance(obj, (staticmethod, classmethod)):
        return type(obj)(_rebind(obj.__func__, glb, modname, port,
                                 class_cell))
    if isinstance(obj, property):
        return property(*(_rebind(f, glb, modname, port, class_cell)
                          if f else None
                          for f in (obj.fget, obj.fset, obj.fdel)))
    if isinstance(obj, type) and obj.__module__ == modname:
        bases = tuple(module_view(b.__module__, port)[b.__name__]
                      if b.__module__.startswith("tests.") else b
                      for b in obj.__bases__)
        cell = pytypes.CellType()
        body = {k: _rebind(v, glb, modname, port, cell)
                for k, v in obj.__dict__.items()
                if k not in ("__dict__", "__weakref__")}
        cls = type(obj.__name__, bases, body)
        cell.cell_contents = cls
        return cls
    return obj


def module_view(modname: str, port: bool) -> Dict[str, Any]:
    """The globals of test module ``modname`` for one side: its ``vtpu``
    names bound to that side's objects (the GPU's names in ``types``,
    but on the JAX side of an AS_WRITTEN module), the recording apiserver
    and scheduler, its test helpers and fixtures rebound alike."""
    key = (modname, port)
    if key in _VIEWS:
        return _VIEWS[key]
    mod = importlib.import_module(modname)
    glb: Dict[str, Any] = dict(mod.__dict__)
    _VIEWS[key] = glb
    top, _ = _imports(modname)
    for src, attr, name in top:
        if src.startswith("tests"):
            glb[name] = module_view(src, port)[attr] if hasattr(
                importlib.import_module(src), attr) else glb[name]
        else:
            glb[name] = _resolve(src, attr, port, modname in AS_WRITTEN)
    for name in ("FakeKubeClient", "Scheduler"):
        if name in glb:
            glb[name] = _recording(port)[name]
    for name, value in list(glb.items()):
        glb[name] = _rebind(value, glb, modname, port)
    return glb


_RECORDING: Dict[bool, Dict[str, type]] = {}


def _norm_annos(annos) -> Dict[str, Any]:
    out = {}
    for k, v in (annos or {}).items():
        out[k] = "<time>" if k in CLOCK_ANNOS and v else v
    return out


def _recording(port: bool) -> Dict[str, type]:
    """The recording FakeKubeClient and Scheduler of one side."""
    if port in _RECORDING:
        return _RECORDING[port]
    client_cls = PortClient if port else JaxClient
    sched_cls = PortScheduler if port else JaxScheduler

    class Client(client_cls):
        def patch_pod_annotations(self, namespace, name, annotations,
                                  *a, **k):
            out = super().patch_pod_annotations(namespace, name,
                                                annotations, *a, **k)
            _LOG.append(("pod", namespace, name, _norm_annos(annotations)))
            return out

        def patch_pods_annotations_bulk(self, patches, *a, **k):
            out = super().patch_pods_annotations_bulk(patches, *a, **k)
            for p in patches:
                _LOG.append(("pod", *[x for x in p if isinstance(x, str)],
                             _norm_annos(next(x for x in p
                                              if isinstance(x, dict)))))
            return out

        def delete_pod(self, namespace, name, *a, **k):
            out = super().delete_pod(namespace, name, *a, **k)
            _LOG.append(("delete", namespace, name))
            return out

        def bind_pod(self, namespace, name, node, *a, **k):
            out = super().bind_pod(namespace, name, node, *a, **k)
            _LOG.append(("bind", namespace, name, node))
            return out

        def patch_node_annotations(self, name, annotations, *a, **k):
            out = super().patch_node_annotations(name, annotations, *a, **k)
            _LOG.append(("node", name, _norm_annos(annotations)))
            return out

        def _lease(self, obj):
            spec = obj.get("spec", {}) or {}
            _LOG.append(("lease", obj["metadata"]["name"],
                         spec.get("holderIdentity"),
                         spec.get("leaseTransitions")))
            return obj

        def create_lease(self, namespace, name, spec, *a, **k):
            return self._lease(super().create_lease(namespace, name, spec,
                                                    *a, **k))

        def update_lease_guarded(self, namespace, name, spec, *a, **k):
            return self._lease(super().update_lease_guarded(
                namespace, name, spec, *a, **k))

    class Sched(sched_cls):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            _SCHEDS.append(self)

        def recover(self, *a, **k):
            restored = super().recover(*a, **k)
            _LOG.append(("recover", restored))
            return restored

    Client.__name__ = "FakeKubeClient"
    Sched.__name__ = "Scheduler"
    _RECORDING[port] = {"FakeKubeClient": Client, "Scheduler": Sched}
    return _RECORDING[port]


@contextlib.contextmanager
def _fences_recorded():
    """Each FencedError raised (either package's) joins the record."""
    from vtpu.scheduler import committer as jc
    from vtpu_torch.scheduler import committer as pc
    saved = [(c, c.__init__) for c in (jc.FencedError, pc.FencedError)]

    def wrap(init):
        def __init__(self, *a, **k):
            _LOG.append(("fenced", to_port_strings(str(a[0]) if a else "")))
            init(self, *a, **k)
        return __init__

    for c, init in saved:
        c.__init__ = wrap(init)
    try:
        yield
    finally:
        for c, init in saved:
            c.__init__ = init


@contextlib.contextmanager
def _swapped_modules(modname: str, port: bool):
    """Imports inside the test's functions (of this module and the test
    modules it draws on) find this side's view of a test module, and in
    the port's run the port's modules."""
    names = set()
    todo, seen = [modname], set()
    while todo:
        m = todo.pop()
        if m in seen:
            continue
        seen.add(m)
        top, inner = _imports(m)
        names |= inner
        todo += [src for src, _, _ in top if src.startswith("tests")]
    # every module is imported before any is swapped: a JAX module first
    # imported while another is swapped would bind the port's objects
    swaps = {}
    for name in sorted(names):
        try:
            importlib.import_module(name)
        except ImportError:
            continue
        if name.startswith("tests."):
            swaps[name] = None
        elif port:
            swaps[name] = importlib.import_module(_port_modname(name))
    for name in swaps:
        if swaps[name] is None:
            view = pytypes.ModuleType(name)
            view.__dict__.update(module_view(name, port))
            swaps[name] = view
    saved = {}
    for name, mod in swaps.items():
        saved[name] = sys.modules[name]
        sys.modules[name] = mod
        _set_parent_attr(name, mod)
    try:
        yield
    finally:
        for name, mod in saved.items():
            sys.modules[name] = mod
            _set_parent_attr(name, mod)


def _set_parent_attr(name: str, mod) -> None:
    """``import a.b as c`` reads the package's attribute, not sys.modules"""
    parent, _, leaf = name.rpartition(".")
    if parent:
        setattr(sys.modules[parent], leaf, mod)


def _finish(gen) -> None:
    """A generator fixture's teardown, as pytest runs it."""
    try:
        next(gen)
    except StopIteration:
        return
    raise RuntimeError(f"fixture {gen.__name__} yielded twice")


def _fixture(name: str, view: Dict[str, Any], values: Dict[str, Any],
             stack: contextlib.ExitStack, wanted_by: str):
    """Fixture ``name``, set up once from ``view`` (its teardown on
    ``stack``) or taken from ``values`` (pytest's own: tmp_path,
    monkeypatch, capsys)."""
    if name not in values:
        fx = view.get(name)
        if not isinstance(fx, Fixture):
            raise TypeError(f"{wanted_by} wants fixture {name}")
        out = fx.fn(**_fixture_args(fx.fn, view, values, stack))
        if inspect.isgenerator(out):
            gen, out = out, next(out)
            stack.callback(_finish, gen)
        values[name] = out
    return values[name]


def _fixture_args(fn, view: Dict[str, Any], values: Dict[str, Any],
                  stack: contextlib.ExitStack) -> Dict[str, Any]:
    """The fixtures ``fn`` asks for; a parameter with a default keeps it."""
    return {name: _fixture(name, view, values, stack, fn.__name__)
            for name, param in inspect.signature(fn).parameters.items()
            if param.default is inspect.Parameter.empty}


def run_reference_test(modname: str, test: str, port: bool,
                       tmp_path=None, capsys=None) -> List[str]:
    """Run the JAX package's ``modname::test`` on one side (the port's
    objects when ``port``), its module's fixtures (autouse ones first) set
    up from that side's view and torn down after it; its record, sorted
    (threads may reorder writes to different objects). Every run builds
    its views afresh, so no case sees a global an earlier one set."""
    import pytest

    _VIEWS.clear()
    view = module_view(modname, port)
    fn = view[test]
    del _LOG[:]
    mp = pytest.MonkeyPatch()
    if tmp_path is not None:
        tmp_path.mkdir(parents=True, exist_ok=True)
    if capsys is not None:
        capsys.readouterr()
    values = {name: value for name, value in (
        ("tmp_path", tmp_path), ("monkeypatch", mp), ("capsys", capsys))
        if value is not None}
    del _SCHEDS[:]
    register_vendors()
    try:
        with _fences_recorded(), _swapped_modules(modname, port), \
                contextlib.ExitStack() as stack:
            for name, fx in list(view.items()):
                if isinstance(fx, Fixture) and fx.autouse:
                    _fixture(name, view, values, stack, test)
            fn(**_fixture_args(fn, view, values, stack))
            for s in _SCHEDS:
                with contextlib.suppress(Exception):
                    s.committer.drain(timeout=1.0)
    finally:
        for s in _SCHEDS:
            with contextlib.suppress(Exception):
                s.stop()
        mp.undo()
        reset_vendors()
    # a lease renewed by a ticker thread is written as often as it ran:
    # its (holder, generation) pairs are compared as a set
    leases = {json.dumps(e) for e in _LOG if e[0] == "lease"}
    rest = [json.dumps(to_port_strings(e), sort_keys=True, default=str)
            for e in _LOG if e[0] != "lease"]
    return Record(sorted(rest) + sorted(leases), final_state(_LOG))


class Record(list):
    """A run's record, its writes sorted; ``final``: the apiserver's state
    they leave (final_state)."""

    def __init__(self, writes, final) -> None:
        super().__init__(writes)
        self.final = final


def final_state(log) -> Dict[str, Any]:
    """What the writes of ``log``, in order, leave in the apiserver: each
    pod's annotations (a patch's None removes a key), binding and whether
    it was deleted (a pod patched after its deletion was made again), and
    each node's annotations, after ``vTPU`` -> ``vGPU``. A write the commit
    pipeline queued and a later decision superseded before it was flushed
    leaves no trace here."""
    pods: Dict[str, Dict[str, Any]] = {}
    nodes: Dict[str, Dict[str, Any]] = {}

    def merge(into: Dict[str, Any], annos: Dict[str, Any]) -> None:
        for key, value in annos.items():
            if value is None:
                into.pop(key, None)
            else:
                into[key] = value

    def pod(ns: str, name: str) -> Dict[str, Any]:
        return pods.setdefault(f"{ns}/{name}", {
            "annotations": {}, "node": None, "deleted": False})

    for e in log:
        if e[0] == "pod":
            p = pod(e[1], e[2])
            if p["deleted"]:
                p.update(annotations={}, node=None, deleted=False)
            merge(p["annotations"], e[-1])
        elif e[0] == "delete":
            pod(e[1], e[2]).update(annotations={}, node=None, deleted=True)
        elif e[0] == "bind":
            pod(e[1], e[2])["node"] = e[3]
        elif e[0] == "node":
            merge(nodes.setdefault(e[1], {}), e[2])
    return to_port_strings({"pods": pods, "nodes": nodes})


def replay_cases(files, left_out: Dict[str, Dict[str, str]]):
    """One pytest case for each test function of each module in ``files``
    but those ``left_out`` names (module -> test -> reason)."""
    import pytest

    out = []
    for modname in files:
        mod = importlib.import_module(modname)
        for name in sorted(dir(mod)):
            if name.startswith("test_") and callable(getattr(mod, name)) \
                    and name not in left_out.get(modname, {}):
                out.append(pytest.param(
                    modname, name, id=f"{modname.split('.')[1]}::{name}"))
    return out
