"""The port's node agent held to the JAX package's device plugin.

Every test runs the JAX reference (``vtpu.plugin``, ``vtpu.util``,
``vtpu.device``) and the port (``vtpu_torch.plugin``, ``vtpu_torch.util``,
``vtpu_torch.device``) on the same inputs, on the CPU:

- codec round trips both ways, for seeded inventories and assignments;
- the vendor's request synthesis, admission, priority, host memory and
  type checks under mapped resource names (``google.com/tpu*`` ↔
  ``nvidia.com/gpu*``);
- inventory and replica ids from one two-card fixture, through
  ``FakeTpuLib``, ``FakeNvmlLib`` and ``NvmlLib`` on the mock
  ``libnvidia-ml.so.1``;
- Allocate over real gRPC unix sockets, key by key under the name map of
  :func:`normalise`, with the pod's annotations and the checkpoint records
  after it;
- the end to end on the CPU: the JAX scheduler places a GPU pod reported
  by the port's registrar, the port's plugin answers Allocate, and a child
  Python started with only the response's env (translated as a container
  runtime would) runs under ``libvgpu.so`` on the mock ``libcuda.so.1``,
  its region read by the JAX ``RegionView``.

Importing this module builds ``lib/vtpu`` (the JAX package's native
libraries) once under a file lock, so test workers that load
``lib/vtpu/build/libvtpucore.so`` later never race its build; a failed
build fails this module's collection.
"""

import base64
import dataclasses
import fcntl
import json
import os
import random
import subprocess
import sys
import tempfile
import textwrap
import time

import grpc
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIB_VTPU = os.path.join(REPO, "lib", "vtpu")


def _build_lib_vtpu() -> None:
    """``make -C lib/vtpu all`` once for all test workers: the first to
    take the lock builds, the others find the outputs up to date."""
    lock_path = os.path.join(tempfile.gettempdir(), "vtpu-lib-build.lock")
    with open(lock_path, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        proc = subprocess.run(["make", "-s", "-C", LIB_VTPU, "all"],
                              capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"make -C lib/vtpu all failed:\n{proc.stderr}")


_build_lib_vtpu()

from vtpu import api as jax_api  # noqa: E402
from vtpu import device as jax_device  # noqa: E402
from vtpu.device.tpu import TPUDevices  # noqa: E402
from vtpu.enforce.region import RegionView as JaxRegionView  # noqa: E402
from vtpu.plugin import deviceplugin_pb2 as jax_pb  # noqa: E402
from vtpu.plugin import dp_grpc as jax_dp  # noqa: E402
from vtpu.plugin.config import PluginConfig as JaxPluginConfig  # noqa: E402
from vtpu.plugin.register import Registrar as JaxRegistrar  # noqa: E402
from vtpu.plugin.rm import ResourceManager as JaxRM  # noqa: E402
from vtpu.plugin.server import TPUDevicePlugin  # noqa: E402
from vtpu.plugin.tpulib import ChipInfo as JaxChip  # noqa: E402
from vtpu.plugin.tpulib import FakeTpuLib  # noqa: E402
from vtpu.scheduler import Scheduler  # noqa: E402
from vtpu.scheduler.webhook import handle_admission_review  # noqa: E402
from vtpu.util import codec as jax_codec  # noqa: E402
from vtpu.util import nodelock as jax_nodelock  # noqa: E402
from vtpu.util import podutil as jax_podutil  # noqa: E402
from vtpu.util import types as jax_types  # noqa: E402
from vtpu.util.client import FakeKubeClient as JaxClient  # noqa: E402

from vtpu_torch import api, native  # noqa: E402
from vtpu_torch.device.gpu import GPUDevices  # noqa: E402
from vtpu_torch.plugin import dp_grpc, runtime, server  # noqa: E402
from vtpu_torch.plugin import deviceplugin_pb2 as pb  # noqa: E402
from vtpu_torch.plugin.config import PluginConfig  # noqa: E402
from vtpu_torch.plugin.nvml import FakeNvmlLib, NvmlLib  # noqa: E402
from vtpu_torch.plugin.register import Registrar  # noqa: E402
from vtpu_torch.plugin.rm import ResourceManager  # noqa: E402
from vtpu_torch.plugin.server import GPUDevicePlugin  # noqa: E402
from vtpu_torch.util import codec, nodelock, podutil, types  # noqa: E402
from vtpu_torch.util.client import FakeKubeClient  # noqa: E402

NODE = "gpu-node"
MiB = 1 << 20
H100 = "NVIDIA H100 80GB HBM3"
CARD_MB = 81559
UUIDS = ["GPU-5a155f78-7d1c-f346-7007-f19df08bef28",
         "GPU-6d8918cb-dd60-de32-dcca-2befc483fa72"]
# the same two devices on the TPU side
TPU_UUIDS = [f"{NODE}-tpu-{i}" for i in range(2)]
UUID_MAP = dict(zip(TPU_UUIDS, UUIDS))
TPU_TYPE = "TPU-v4"
GPU_TYPE = f"NVIDIA-{H100}"


def fixture_json(tmp_path, **per_card) -> str:
    """The two-card fixture, FakeNvmlLib's and the mock NVML's."""
    gpus = [dict({"uuid": u, "name": H100, "memory_mb": CARD_MB,
                  "minor": i, "numa": 0, "ecc_uncorrected": 0,
                  "xids": []}, **per_card.get(u, {}))
            for i, u in enumerate(UUIDS)]
    path = tmp_path / "cards.json"
    path.write_text(json.dumps({"gpus": gpus}))
    return str(path)


def tpu_chips():
    return [JaxChip(uuid=u, index=i, type=TPU_TYPE, hbm_mb=CARD_MB,
                    mesh=None, numa=0, health=True,
                    device_paths=[f"/dev/accel{i}"])
            for i, u in enumerate(TPU_UUIDS)]


@pytest.fixture(scope="module")
def libs():
    return native.build_all()


@pytest.fixture
def mock_nvml(tmp_path, monkeypatch, libs):
    """NvmlLib on the mock libnvidia-ml.so.1, serving the fixture."""
    path = fixture_json(tmp_path)
    monkeypatch.setenv("MOCK_NVML_FIXTURE", path)
    lib = NvmlLib(native.mock_nvml_library())
    yield lib, path
    lib.close()


# ---------------------------------------------------------------------------
# codec parity
# ---------------------------------------------------------------------------

def _fields(obj) -> dict:
    """A wire dataclass of either package as a plain dict (mesh as a
    tuple, so the two packages' MeshCoord classes compare)."""
    d = dataclasses.asdict(obj)
    if d.get("mesh") is not None:
        d["mesh"] = tuple(d["mesh"].values())
    return d


def _seeded_devices(seed):
    rnd = random.Random(seed)
    return [dict(id=f"GPU-{rnd.getrandbits(64):016x}", index=i,
                 count=rnd.randint(1, 20), devmem=rnd.randint(1, 1 << 17),
                 devcore=rnd.choice([50, 100, 200]),
                 type=rnd.choice([GPU_TYPE, "NVIDIA-NVIDIA A100-SXM4-40GB",
                                  TPU_TYPE]),
                 numa=rnd.randint(0, 3),
                 mesh=rnd.choice([None, (rnd.randint(0, 3),
                                         rnd.randint(0, 3), 0)]),
                 health=rnd.random() < 0.8)
            for i in range(rnd.randint(1, 8))]


def _seeded_pod(seed):
    rnd = random.Random(seed)
    return [[dict(uuid=f"GPU-{rnd.getrandbits(48):012x}",
                  type=rnd.choice(["NVIDIA", "TPU"]),
                  usedmem=rnd.randint(0, 81559),
                  usedcores=rnd.choice([0, 30, 50, 100]))
             for _ in range(rnd.randint(0, 3))]
            for _ in range(rnd.randint(1, 4))]


def _build(mod, kwargs_list, cls):
    out = []
    for kw in kwargs_list:
        kw = dict(kw)
        if kw.get("mesh") is not None:
            kw["mesh"] = mod.MeshCoord(*kw["mesh"])
        out.append(getattr(mod, cls)(**kw))
    return out


@pytest.mark.parametrize("seed", range(5))
def test_codec_node_devices_round_trip_both_ways(seed):
    spec = _seeded_devices(seed)
    port_devs = _build(types, spec, "DeviceInfo")
    jax_devs = _build(jax_types, spec, "DeviceInfo")
    port_wire = codec.encode_node_devices(port_devs)
    assert port_wire == jax_codec.encode_node_devices(jax_devs)
    assert [_fields(d) for d in jax_codec.decode_node_devices(port_wire)] \
        == [_fields(d) for d in port_devs]
    assert [_fields(d) for d in codec.decode_node_devices(
        jax_codec.encode_node_devices(jax_devs))] == \
        [_fields(d) for d in jax_devs]


@pytest.mark.parametrize("seed", range(5))
def test_codec_pod_devices_round_trip_both_ways(seed):
    spec = _seeded_pod(seed)
    port_pod = [_build(types, c, "ContainerDevice") for c in spec]
    jax_pod = [_build(jax_types, c, "ContainerDevice") for c in spec]
    port_wire = codec.encode_pod_devices(port_pod)
    assert port_wire == jax_codec.encode_pod_devices(jax_pod)
    # one container with no device encodes to "", which both decode to
    # no container at all (the reference's empty-string rule)
    want = spec if port_wire else []
    assert [[_fields(d) for d in c]
            for c in jax_codec.decode_pod_devices(port_wire)] == want
    assert [[_fields(d) for d in c] for c in codec.decode_pod_devices(
        jax_codec.encode_pod_devices(jax_pod))] == want


def test_codec_annotations_decode_across_packages(tmp_path):
    """The node-register annotation the port's registrar writes decodes
    in the JAX codec, and the assignment annotations the JAX scheduler's
    helper writes decode in the port's."""
    client = FakeKubeClient()
    client.add_node(NODE)
    lib = FakeNvmlLib(fixture=fixture_json(tmp_path))
    Registrar(lib, ResourceManager(PluginConfig()), client,
              NODE).register_once()
    annos = client.get_node(NODE)["metadata"]["annotations"]
    assert annos[api.HANDSHAKE_ANNO].startswith("Reported ")
    reg = annos[api.NODE_REGISTER_ANNO]
    assert [_fields(d) for d in jax_codec.decode_node_devices(reg)] == \
        [_fields(d) for d in codec.decode_node_devices(reg)]
    assert [d.id for d in codec.decode_node_devices(reg)] == UUIDS

    spec = _seeded_pod(11)
    jax_annos = jax_podutil.device_annotations(
        NODE, [_build(jax_types, c, "ContainerDevice") for c in spec])
    port_annos = podutil.device_annotations(
        NODE, [_build(types, c, "ContainerDevice") for c in spec])
    for key in (api.ASSIGNED_NODE_ANNO, api.ASSIGNED_IDS_ANNO,
                api.TO_ALLOCATE_ANNO):
        assert port_annos[key] == jax_annos[key]
    assert [[_fields(d) for d in c] for c in codec.decode_pod_devices(
        jax_annos[jax_types.TO_ALLOCATE_ANNO])] == spec
    # the assignment bus is the TPU vendor's; the handshake is not
    assert api.TO_ALLOCATE_ANNO == jax_types.TO_ALLOCATE_ANNO
    assert api.HANDSHAKE_ANNO != jax_types.HANDSHAKE_ANNO
    assert api.NODE_REGISTER_ANNO != jax_types.NODE_REGISTER_ANNO


MALFORMED = [
    ("node", "a,1,2,3,T,0,*"),            # seven fields
    ("node", "a,1,2,3,T,0,*,true,x"),     # nine
    ("node", "a,x,2,3,T,0,*,true"),       # count not an int
    ("node", "a,1,2,3,T,0,1-2,true"),     # two mesh coordinates
    ("pod", "u,NVIDIA,1"),                # three fields
    ("pod", "u,NVIDIA,1,2,3"),            # five
    ("pod", "u,NVIDIA,one,2"),            # usedmem not an int
]


@pytest.mark.parametrize("kind,wire", MALFORMED)
def test_codec_malformed_raises_in_both(kind, wire):
    fn = {"node": "decode_node_devices", "pod": "decode_pod_devices"}[kind]
    with pytest.raises(ValueError):
        getattr(jax_codec, fn)(wire)
    with pytest.raises(ValueError):
        getattr(codec, fn)(wire)


@pytest.mark.parametrize("name", ["H100, PCIe", "H100:SXM", "H100;x"])
def test_codec_refuses_a_card_name_with_a_separator(name):
    """A card name comes from NVML, not from us: one holding a separator
    would decode to other values, so the port refuses it loudly."""
    dev = types.DeviceInfo(id="GPU-1", type=f"NVIDIA-{name}")
    with pytest.raises(codec.CodecError, match="separator"):
        codec.encode_node_devices([dev])
    with pytest.raises(codec.CodecError, match="separator"):
        codec.encode_pod_devices([[types.ContainerDevice(
            uuid="GPU-1", type=f"NVIDIA-{name}")]])


# ---------------------------------------------------------------------------
# vendor parity: TPUDevices and GPUDevices on the same container specs
# ---------------------------------------------------------------------------

RESOURCE_MAP = {
    jax_types.RESOURCE_TPU: types.RESOURCE_GPU,
    jax_types.RESOURCE_MEM: types.RESOURCE_MEM,
    jax_types.RESOURCE_MEM_PERCENT: types.RESOURCE_MEM_PERCENT,
    jax_types.RESOURCE_CORES: types.RESOURCE_CORES,
    jax_types.RESOURCE_PRIORITY: types.RESOURCE_PRIORITY,
    jax_types.RESOURCE_HOST_MEM: types.RESOURCE_HOST_MEM,
}
T = jax_types

CONTAINERS = [
    {"limits": {T.RESOURCE_TPU: 1, T.RESOURCE_MEM: 3000,
                T.RESOURCE_CORES: 50}},
    {"limits": {T.RESOURCE_TPU: 2}},
    {"limits": {T.RESOURCE_TPU: 1, T.RESOURCE_MEM_PERCENT: 25}},
    {"limits": {T.RESOURCE_MEM: "4Gi"}},
    {"requests": {T.RESOURCE_TPU: "1", T.RESOURCE_CORES: "30"}},
    {"limits": {T.RESOURCE_TPU: 1, T.RESOURCE_PRIORITY: 0,
                T.RESOURCE_HOST_MEM: 2048}},
    {"limits": {T.RESOURCE_TPU: 1, T.RESOURCE_PRIORITY: 1}},
    {"limits": {"cpu": "2"}},
    {},
]


def _to_gpu_container(spec):
    return {"name": "c", "resources": {
        sect: {RESOURCE_MAP.get(k, k): v for k, v in res.items()}
        for sect, res in spec.items()}}


@pytest.mark.parametrize("spec", CONTAINERS)
def test_vendor_request_parity(spec):
    tpu_ctr = {"name": "c", "resources": json.loads(json.dumps(spec))}
    gpu_ctr = _to_gpu_container(spec)
    tpu, gpu = TPUDevices(), GPUDevices()
    jreq = tpu.generate_resource_requests(tpu_ctr)
    preq = gpu.generate_resource_requests(gpu_ctr)
    assert (preq.nums, preq.memreq, preq.mem_percentage, preq.coresreq) == \
        (jreq.nums, jreq.memreq, jreq.mem_percentage, jreq.coresreq)
    assert (preq.type == "NVIDIA") == (jreq.type == "TPU") or jreq.nums == 0
    assert gpu.container_task_priority(gpu_ctr) == \
        tpu.container_task_priority(tpu_ctr)
    assert gpu.container_host_mem_mb(gpu_ctr) == \
        tpu.container_host_mem_mb(tpu_ctr)
    assert gpu.mutate_admission(gpu_ctr, {}) == \
        tpu.mutate_admission(tpu_ctr, {})
    jenv = {e["name"]: e["value"] for e in tpu_ctr.get("env", [])}
    penv = {e["name"]: e["value"] for e in gpu_ctr.get("env", [])}
    assert penv == {api.ENV_TASK_PRIORITY: v for v in
                    [jenv.get(jax_api.ENV_TASK_PRIORITY)] if v is not None}


# device types and the annotation values that select them, mapped
TYPE_MAP = {"TPU-v4": "NVIDIA-NVIDIA H100 80GB HBM3",
            "TPU-v5e": "NVIDIA-NVIDIA A100-SXM4-40GB"}
WORD_MAP = {"v4": "h100", "v5e": "a100", "tpu": "nvidia", "V4": "H100"}
ANNOS = [
    {},
    {T.USE_TPUTYPE_ANNO: "v4"},
    {T.USE_TPUTYPE_ANNO: "V4, v5e"},
    {T.NOUSE_TPUTYPE_ANNO: "v5e"},
    {T.USE_TPUTYPE_ANNO: "tpu", T.NOUSE_TPUTYPE_ANNO: "v4"},
    {T.ICI_BIND_ANNO: "true"},
    {T.ICI_BIND_ANNO: "false", T.USE_TPUTYPE_ANNO: "v4"},
]
ANNO_MAP = {T.USE_TPUTYPE_ANNO: types.USE_GPUTYPE_ANNO,
            T.NOUSE_TPUTYPE_ANNO: types.NOUSE_GPUTYPE_ANNO,
            T.ICI_BIND_ANNO: types.NUMA_BIND_ANNO}


def _map_words(value):
    return ",".join(WORD_MAP.get(w.strip(), w.strip())
                    for w in value.split(","))


@pytest.mark.parametrize("annos", ANNOS)
def test_vendor_check_type_parity(annos):
    tpu, gpu = TPUDevices(), GPUDevices()
    gpu_annos = {ANNO_MAP[k]: _map_words(v) for k, v in annos.items()}
    for req_vendor in ("match", "other"):
        jreq = jax_types.ContainerDeviceRequest(
            nums=1, type="TPU" if req_vendor == "match" else "NVIDIA")
        preq = types.ContainerDeviceRequest(
            nums=1, type="NVIDIA" if req_vendor == "match" else "TPU")
        for ttype, gtype in TYPE_MAP.items():
            jv = tpu.check_type(annos, jax_types.DeviceUsage(type=ttype),
                                jreq)
            pv = gpu.check_type(gpu_annos, types.DeviceUsage(type=gtype),
                                preq)
            assert pv == jv, (annos, ttype, req_vendor)
    assert set(gpu.scheduling_annos) == {
        ANNO_MAP[k] for k in tpu.scheduling_annos}


# ---------------------------------------------------------------------------
# inventory and replica parity
# ---------------------------------------------------------------------------

def _register_decoded(lib, rm, client_cls, anno, jax_side):
    client = client_cls()
    client.add_node(NODE)
    (JaxRegistrar if jax_side else Registrar)(lib, rm, client,
                                              NODE).register_once()
    wire = client.get_node(NODE)["metadata"]["annotations"][anno]
    return [_fields(d) for d in codec.decode_node_devices(wire)]


@pytest.mark.parametrize("source", ["FakeNvmlLib", "NvmlLib on mock_nvml"])
def test_inventory_and_replicas_match_the_reference(source, tmp_path,
                                                    request):
    if source == "FakeNvmlLib":
        lib = FakeNvmlLib(fixture=fixture_json(tmp_path))
    else:
        lib, _ = request.getfixturevalue("mock_nvml")
    jax_lib = FakeTpuLib(chips=tpu_chips())
    rm = ResourceManager(PluginConfig(device_split_count=10))
    jrm = JaxRM(JaxPluginConfig(device_split_count=10))
    chips = lib.enumerate()
    assert [(c.uuid, c.hbm_mb, c.type, c.device_paths) for c in chips] == [
        (u, CARD_MB, GPU_TYPE, [f"/dev/nvidia{i}"])
        for i, u in enumerate(UUIDS)]
    port_ids = [d.ID for d in rm.kubelet_devices(chips)]
    jax_ids = [d.ID for d in jrm.kubelet_devices(jax_lib.enumerate())]
    assert len(port_ids) == 20
    assert port_ids == [UUID_MAP[i.rsplit("::", 1)[0]] + "::" +
                        i.rsplit("::", 1)[1] for i in jax_ids]
    port_reg = _register_decoded(lib, rm, FakeKubeClient,
                                 api.NODE_REGISTER_ANNO, False)
    jax_reg = _register_decoded(jax_lib, jrm, JaxClient,
                                jax_types.NODE_REGISTER_ANNO, True)
    for p, j in zip(port_reg, jax_reg, strict=True):
        assert p.pop("type") == GPU_TYPE and j.pop("type") == TPU_TYPE
        p.pop("mesh"), j.pop("mesh")
        assert p == dict(j, id=UUID_MAP[j["id"]])
    assert port_reg[0]["devmem"] == CARD_MB and port_reg[0]["devcore"] == 100


def _flip(kind, lib, fixture, uuid):
    """Make card ``uuid`` unhealthy through the source under test."""
    if kind == "set_health":
        lib.set_health(uuid, False)
    else:
        data = json.load(open(fixture))
        for g in data["gpus"]:
            if g["uuid"] == uuid:
                if kind == "ecc":
                    g["ecc_uncorrected"] += 1
                else:
                    g["xids"].append(79)  # fallen off the bus
        with open(fixture, "w") as f:
            json.dump(data, f)


@pytest.mark.parametrize("kind", ["set_health", "ecc", "xid"])
def test_health_flip_pushes_list_and_watch(kind, tmp_path, request):
    """As tests/test_plugin.py:146-158 and 594-622 check for the JAX
    plugin: a card turning unhealthy (the fake's flag, or an ECC count or
    XID on the mock NVML, through HealthTrackingNvmlLib) reaches kubelet
    as a ListAndWatch update with that card's replicas Unhealthy."""
    from vtpu_torch.plugin.nvml import HealthTrackingNvmlLib

    if kind == "set_health":
        fixture = fixture_json(tmp_path)
        lib = FakeNvmlLib(fixture=fixture)
    else:
        lib, fixture = request.getfixturevalue("mock_nvml")
    tracked = HealthTrackingNvmlLib(lib, recovery_s=30.0)
    plugin = GPUDevicePlugin(
        tracked, PluginConfig(device_split_count=2,
                              socket_dir=str(tmp_path / "sock"),
                              shim_host_dir=str(tmp_path / "vgpu")),
        FakeKubeClient(), NODE)
    plugin.start(register_with_kubelet=False)
    try:
        with grpc.insecure_channel(f"unix://{plugin.socket_path}") as ch:
            stream = dp_grpc.DevicePluginStub(ch).ListAndWatch(
                pb.Empty(), timeout=15)
            first = next(stream)
            assert len(first.devices) == 4
            assert all(d.health == "Healthy" for d in first.devices)
            _flip(kind, lib, fixture, UUIDS[1])
            update = next(stream)
            sick = sorted(d.ID for d in update.devices
                          if d.health == "Unhealthy")
            assert sick == [f"{UUIDS[1]}::0", f"{UUIDS[1]}::1"]
    finally:
        plugin.stop()


# ---------------------------------------------------------------------------
# Allocate parity: the JAX TPUDevicePlugin and the port's GPUDevicePlugin
# serve the same pod with the same assignment
# ---------------------------------------------------------------------------

ENV_MAP = {
    jax_api.ENV_VISIBLE_DEVICES: api.ENV_NVIDIA_VISIBLE_DEVICES,
    jax_api.ENV_DEVICE_MEMORY_LIMIT: api.ENV_DEVICE_MEMORY_LIMIT,
    jax_api.ENV_TENSORCORE_LIMIT: api.ENV_SM_LIMIT,
    jax_api.ENV_HOST_MEMORY_LIMIT: api.ENV_HOST_MEMORY_LIMIT,
    jax_api.ENV_SHARED_CACHE: api.ENV_SHARED_CACHE,
}
# what only the JAX plugin sets: PJRT plugin discovery (a CUDA process is
# reached through the preload alone)
PJRT_ENV = ("TPU_LIBRARY_PATH", jax_api.ENV_REAL_LIBTPU)


def _map_key(key):
    base, _, idx = key.rpartition("_")
    if idx.isdigit() and base in ENV_MAP:
        return f"{ENV_MAP[base]}_{idx}"
    return ENV_MAP.get(key, key)


def _map_value(value):
    """``/usr/local/vtpu`` ↔ ``/usr/local/vgpu``, ``/tmp/vtpulock`` ↔
    ``/tmp/vgpulock``, ``vtpu.cache`` ↔ ``vgpu.cache``, ``libvtpu.so`` ↔
    ``libvgpu.so``, the license and validator paths, the shim host dirs
    (``.../vtpu`` ↔ ``.../vgpu``) and the device ids."""
    for tpu, gpu in UUID_MAP.items():
        value = value.replace(tpu, gpu)
    return value.replace("vtpu", "vgpu")


def normalise(resp, reference: bool):
    """(envs, mounts, device nodes) of one ContainerAllocateResponse, the
    reference's under the name map."""
    envs = dict(resp.envs)
    mounts = sorted((m.container_path, m.host_path, m.read_only)
                    for m in resp.mounts)
    devices = sorted((d.container_path, d.host_path, d.permissions)
                     for d in resp.devices)
    if reference:
        envs = {_map_key(k): _map_value(v) for k, v in envs.items()
                if k not in PJRT_ENV}
        mounts = sorted((_map_value(c), _map_value(h), ro)
                        for c, h, ro in mounts)
    return envs, mounts, devices


class Pair:
    """One node served by each plugin: the JAX one (FakeTpuLib, its own
    FakeKubeClient, shim dir ``<tmp>/vtpu``) and the port's (FakeNvmlLib,
    its own FakeKubeClient, shim dir ``<tmp>/vgpu``)."""

    def __init__(self, tmp_path, split=4):
        self.tmp = tmp_path
        self.jax_client, self.client = JaxClient(), FakeKubeClient()
        self.jax_client.add_node(NODE)
        self.client.add_node(NODE)
        self.jax_lib = FakeTpuLib(chips=tpu_chips())
        self.lib = FakeNvmlLib(fixture=fixture_json(tmp_path))
        self.split = split
        self.jax_plugin = self.plugin = None
        self.start()

    def start(self):
        self.jax_plugin = TPUDevicePlugin(
            self.jax_lib, JaxPluginConfig(
                device_split_count=self.split,
                socket_dir=str(self.tmp / "sock-vtpu"),
                shim_host_dir=str(self.tmp / "vtpu")),
            self.jax_client, NODE)
        self.plugin = GPUDevicePlugin(
            self.lib, PluginConfig(
                device_split_count=self.split,
                socket_dir=str(self.tmp / "sock-vgpu"),
                shim_host_dir=str(self.tmp / "vgpu")),
            self.client, NODE)
        self.jax_plugin.start(register_with_kubelet=False)
        self.plugin.start(register_with_kubelet=False)

    def stop(self):
        self.jax_plugin.stop()
        self.plugin.stop()

    def add_pod(self, name, assignment, env=None, annotations=None,
                containers=None):
        """The pod on both nodes, assigned and bound as the scheduler
        leaves it: ``assignment`` is one list of (device index, usedmem,
        usedcores) per container; the node lock is held."""
        n = containers or len(assignment)
        for side in ("jax", "port"):
            mod_types, mod_podutil, client, nodelock_mod, uuids, vendor = (
                (jax_types, jax_podutil, self.jax_client, jax_nodelock,
                 TPU_UUIDS, "TPU") if side == "jax" else
                (types, podutil, self.client, nodelock, UUIDS, "NVIDIA"))
            devices = [[mod_types.ContainerDevice(
                uuid=uuids[i], type=vendor, usedmem=mem, usedcores=cores)
                for i, mem, cores in ctr] for ctr in assignment]
            annos = mod_podutil.device_annotations(NODE, devices)
            annos[mod_types.ASSIGNED_TIME_ANNO] = "1700000000000000000"
            annos[mod_types.BIND_PHASE_ANNO] = "allocating"
            annos[mod_types.BIND_TIME_ANNO] = str(time.time_ns())
            annos.update(annotations or {})
            ctr_env = [{"name": {"jax": jax_api, "port": api}[side]
                        .ENV_DISABLE_CONTROL, "value": "1"}] if env else []
            client.add_pod({
                "metadata": {"name": name, "namespace": "default",
                             "uid": f"uid-{name}", "annotations": annos},
                "spec": {"nodeName": NODE, "containers": [
                    {"name": f"c{i}", "env": list(ctr_env)}
                    for i in range(n)]},
                "status": {"phase": "Pending"}})
            nodelock_mod.lock_node(client, NODE)

    def allocate(self, n_containers):
        """Allocate over each plugin's socket: (reference, port), each a
        response or the gRPC status code it failed with."""
        out = []
        for plugin, stub_mod, pb_mod in (
                (self.jax_plugin, jax_dp, jax_pb), (self.plugin, dp_grpc, pb)):
            req = pb_mod.AllocateRequest(container_requests=[
                pb_mod.ContainerAllocateRequest(devicesIDs=[f"r{i}"])
                for i in range(n_containers)])
            with grpc.insecure_channel(f"unix://{plugin.socket_path}") as ch:
                try:
                    out.append(stub_mod.DevicePluginStub(ch).Allocate(req))
                except grpc.RpcError as e:
                    out.append(e.code())
        return out

    def annotations(self, name):
        """The pod's annotations and the node lock after Allocate, on both
        sides, in comparable form."""
        out = []
        for client, mod_codec, mod_types in (
                (self.jax_client, jax_codec, jax_types),
                (self.client, codec, types)):
            annos = client.get_pod("default", name)["metadata"][
                "annotations"]
            out.append({
                "bind_phase": annos.get(mod_types.BIND_PHASE_ANNO),
                "to_allocate": [[(UUID_MAP.get(d.uuid, d.uuid), d.usedmem,
                                  d.usedcores) for d in c]
                                for c in mod_codec.decode_pod_devices(
                                    annos[mod_types.TO_ALLOCATE_ANNO])],
                "assigned": [[(UUID_MAP.get(d.uuid, d.uuid), d.usedmem,
                               d.usedcores) for d in c]
                             for c in mod_codec.decode_pod_devices(
                                 annos[mod_types.ASSIGNED_IDS_ANNO])],
                "node_locked": mod_types.NODE_LOCK_ANNO in client.get_node(
                    NODE)["metadata"]["annotations"],
            })
        return out

    def checkpoints(self):
        """Both plugins' checkpoint files, the reference's records under
        the name map; the device nodes (which differ by design, as
        assert_same_responses checks) left out."""
        out = []
        for plugin, reference in ((self.jax_plugin, True),
                                  (self.plugin, False)):
            data = json.load(open(plugin.checkpoint.path))
            for rec in data["allocations"].values():
                rec.pop("time_s")
                rec["containers"] = [
                    normalise(server.record_to_response(c), reference)[:2]
                    for c in rec["containers"]]
            out.append(data)
        return out


@pytest.fixture
def pair(tmp_path):
    p = Pair(tmp_path)
    yield p
    p.stop()


def assert_same_responses(jax_resp, port_resp, n, disabled=False):
    assert len(jax_resp.container_responses) == n
    assert len(port_resp.container_responses) == n
    for j, p in zip(jax_resp.container_responses,
                    port_resp.container_responses):
        jenv, jmounts, jdevs = normalise(j, True)
        penv, pmounts, pdevs = normalise(p, False)
        assert penv == jenv
        assert pmounts == jmounts
        # the intended differences: the PJRT env, and the device nodes
        if disabled:
            assert not set(PJRT_ENV) & set(j.envs)
        else:
            assert dict(j.envs)["TPU_LIBRARY_PATH"] == \
                jax_api.CONTAINER_SHIM_PATH
        assert not {"TPU_LIBRARY_PATH", jax_api.ENV_REAL_LIBTPU} & set(
            p.envs)
        gpus = [TPU_UUIDS.index(u) for u in
                dict(j.envs)[jax_api.ENV_VISIBLE_DEVICES].split(",")]
        assert [d[0] for d in jdevs] == sorted(f"/dev/accel{i}"
                                               for i in gpus)
        assert [d[0] for d in pdevs] == sorted(
            [f"/dev/nvidia{i}" for i in gpus] + list(server.CONTROL_DEVICES))
        assert all(d[0] == d[1] and d[2] == "rw" for d in pdevs)


ALLOCATE_CASES = {
    # name: (assignment per container, containers asked by kubelet)
    "single": ([[(0, 2048, 30)]], 1),
    "multi_container": ([[(0, 1024, 30)], [(1, 1024, 30)]], 2),
    "per_device_cores": ([[(0, 1024, 30), (1, 1024, 70)]], 1),
    "same_cores": ([[(0, 1024, 40), (1, 1024, 40)]], 1),
    "mixed_unlimited_cores": ([[(0, 1024, 50), (1, 1024, 0)]], 1),
    "unlimited": ([[(1, 81559, 0)]], 1),
}


@pytest.mark.parametrize("case", sorted(ALLOCATE_CASES))
def test_allocate_matches_the_reference(case, pair):
    assignment, n = ALLOCATE_CASES[case]
    pair.add_pod("p", assignment)
    jax_resp, port_resp = pair.allocate(n)
    assert_same_responses(jax_resp, port_resp, n)
    jax_annos, port_annos = pair.annotations("p")
    assert port_annos == jax_annos
    assert port_annos["bind_phase"] == "success"
    assert not port_annos["node_locked"]
    assert all(not c for c in port_annos["to_allocate"])
    jax_ckpt, port_ckpt = pair.checkpoints()
    assert port_ckpt == jax_ckpt


def test_allocate_host_memory_mesh_and_migration_env(pair):
    annos = {api.HOST_MEM_ANNO: "2048",
             api.MIGRATED_FROM_ANNO: "3:old-node",
             api.SLICE_BLOCK_ANNO: f"s;{NODE},other;2x1x1;0-0-0|1-0-0"}
    pair.add_pod("h", [[(0, 1024, 25)]], annotations=annos)
    jax_resp, port_resp = pair.allocate(1)
    assert_same_responses(jax_resp, port_resp, 1)
    env = dict(port_resp.container_responses[0].envs)
    assert env[api.ENV_HOST_MEMORY_LIMIT] == str(2048 * MiB)
    assert env[api.ENV_MIGRATED_FROM] == "3:old-node"
    assert env[api.ENV_MESH_SHAPE] == "2,1,1"
    assert env[api.ENV_MESH_COORDS] == "0-0-0"
    assert pair.checkpoints()[1] == pair.checkpoints()[0]


def test_allocate_without_pending_pod_fails_in_both(pair):
    assert pair.allocate(1) == [grpc.StatusCode.FAILED_PRECONDITION] * 2


def test_allocate_disable_control_skips_preload_in_both(pair):
    pair.add_pod("nc", [[(0, 2048, 30)]], env=True)
    jax_resp, port_resp = pair.allocate(1)
    assert_same_responses(jax_resp, port_resp, 1, disabled=True)
    paths = [m.container_path for m in port_resp.container_responses[0]
             .mounts]
    assert api.LD_SO_PRELOAD_PATH not in paths
    assert api.CONTAINER_SHIM_PATH in paths


def test_allocate_fails_in_both_when_the_card_vanished(pair):
    pair.add_pod("gone", [[(0, 2048, 30)]])
    pair.jax_lib.chips = pair.jax_lib.chips[1:]
    pair.lib.chips = pair.lib.chips[1:]
    time.sleep(1.5)  # the 1 Hz health loops ingest the new enumeration
    assert pair.allocate(1) == [grpc.StatusCode.FAILED_PRECONDITION] * 2
    jax_annos, port_annos = pair.annotations("gone")
    assert port_annos == jax_annos
    assert port_annos["bind_phase"] == "failed"
    assert not port_annos["node_locked"]


def test_allocate_license_mounts_match(pair):
    for shim, validator in ((pair.jax_plugin.config.shim_host_dir,
                             "vtpu-validator"),
                            (pair.plugin.config.shim_host_dir,
                             "vgpu-validator")):
        os.makedirs(os.path.join(shim, "license"))
        with open(os.path.join(shim, "license", "license"), "w") as f:
            f.write("product=v\n")
        with open(os.path.join(shim, "license", "license.secret"),
                  "w") as f:
            f.write("secret")
        with open(os.path.join(shim, validator), "w") as f:
            f.write("#!")
    pair.add_pod("lic", [[(0, 2048, 30)]])
    jax_resp, port_resp = pair.allocate(1)
    assert_same_responses(jax_resp, port_resp, 1)
    mounts = {m.container_path: m.host_path
              for m in port_resp.container_responses[0].mounts}
    assert mounts[api.CONTAINER_LICENSE_PATH] == os.path.join(
        pair.plugin.config.shim_host_dir, "license", "license")
    assert api.CONTAINER_VALIDATOR_PATH in mounts


class Killed(BaseException):
    """A SIGKILL at an instruction boundary: no handler runs."""


def test_checkpoint_replay_after_a_plugin_restart(pair, monkeypatch):
    """The plugin dies between recording container 0's response and
    consuming its annotation slot; a new incarnation answers kubelet's
    re-Allocate from the checkpoint with the same wiring, consumes the
    slot, and the pod succeeds — in both packages alike."""
    pair.add_pod("rp", [[(0, 1024, 30)], [(1, 2048, 60)]])
    for mod in (jax_podutil, podutil):
        def die(*a, **k):
            raise Killed()
        monkeypatch.setattr(mod, "erase_next_device_type_from_annotation",
                            die)
    for plugin, pb_mod in ((pair.jax_plugin, jax_pb), (pair.plugin, pb)):
        req = pb_mod.AllocateRequest(container_requests=[
            pb_mod.ContainerAllocateRequest(devicesIDs=["r0"]),
            pb_mod.ContainerAllocateRequest(devicesIDs=["r1"])])
        with pytest.raises(Killed):
            plugin._allocate(req)
    monkeypatch.undo()
    first = pair.checkpoints()
    assert first[1] == first[0]
    assert len(next(iter(first[1]["allocations"].values()))[
        "containers"]) == 1
    pair.stop()
    pair.start()   # new incarnations, the same checkpoint files
    jax_resp, port_resp = pair.allocate(2)
    assert_same_responses(jax_resp, port_resp, 2)
    recorded = next(iter(first[1]["allocations"].values()))["containers"]
    assert normalise(port_resp.container_responses[0], False)[:2] == \
        recorded[0]
    jax_annos, port_annos = pair.annotations("rp")
    assert port_annos == jax_annos
    assert port_annos["bind_phase"] == "success"
    assert pair.checkpoints()[1] == pair.checkpoints()[0]


def test_missing_libvgpu_is_logged_as_the_reference_logs_it(
        tmp_path, monkeypatch, caplog):
    """A shim artifact that is not there: both plugins log it the same
    way, go on, and Allocate still names the mount."""
    from vtpu.plugin.server import install_shim_artifacts as jax_install

    monkeypatch.setenv("VTPU_SHIM_SO", str(tmp_path / "nope" / "libvtpu.so"))
    monkeypatch.setenv(api.ENV_SHIM_SO, str(tmp_path / "nope" / "libvgpu.so"))
    caplog.set_level("WARNING")
    jax_install(str(tmp_path / "vtpu"))
    server.install_shim_artifacts(str(tmp_path / "vgpu"))
    missing = [r.getMessage() for r in caplog.records
               if "shim artifact" in r.getMessage()
               and "nope" in r.getMessage()]
    assert len(missing) == 2
    assert _map_value(missing[0]) == missing[1]
    assert os.path.exists(tmp_path / "vgpu" / "ld.so.preload")
    assert open(tmp_path / "vgpu" / "ld.so.preload").read() == \
        api.CONTAINER_SHIM_PATH + "\n"
    assert not os.path.exists(tmp_path / "vgpu" / "libvgpu.so")
    p = Pair(tmp_path)
    try:
        p.add_pod("m", [[(0, 1024, 30)]])
        jax_resp, port_resp = p.allocate(1)
        assert_same_responses(jax_resp, port_resp, 1)
        assert api.CONTAINER_SHIM_PATH in [
            m.container_path for m in port_resp.container_responses[0]
            .mounts]
    finally:
        p.stop()


# ---------------------------------------------------------------------------
# the end to end on the CPU
# ---------------------------------------------------------------------------

CHILD = textwrap.dedent(r"""
    import ctypes, json, os, sys
    from vtpu_torch.enforce import install
    enf = install()
    cu = ctypes.CDLL("libcuda.so.1")
    free, total = ctypes.c_size_t(), ctypes.c_size_t()
    # the view a CUDA process gets through the interposer
    rc = cu.cuMemGetInfo_v2(ctypes.byref(free), ctypes.byref(total))
    print(json.dumps({"pid": os.getpid(), "interposed": enf.interposed,
                      "limit": enf.limit(), "rc": rc,
                      "total": total.value,
                      "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                      "preload": os.environ.get("LD_PRELOAD")}),
          flush=True)
    sys.stdin.readline()
    enf.stop()
""")


@pytest.fixture
def gpu_vendor_registered():
    """The port's GPUDevices in the JAX scheduler's vendor registry, at
    run time (the TPU vendor stays registered beside it)."""
    jax_device.init_default_devices()
    jax_device.register(GPUDevices())
    yield
    jax_device.reset_registry()


def test_end_to_end_scheduler_to_libvgpu_region(tmp_path, monkeypatch,
                                                mock_nvml, libs,
                                                gpu_vendor_registered):
    nvml_lib, _ = mock_nvml
    client = JaxClient()   # one apiserver for the scheduler and the plugin
    client.add_node(NODE)
    config = PluginConfig(device_split_count=10,
                          socket_dir=str(tmp_path / "sock"),
                          shim_host_dir=str(tmp_path / "vgpu"))
    server.install_shim_artifacts(config.shim_host_dir)
    plugin = GPUDevicePlugin(nvml_lib, config, client, NODE)
    plugin.start(register_with_kubelet=False)
    try:
        Registrar(nvml_lib, plugin.rm, client, NODE).register_once()
        pod = {"metadata": {"name": "g", "namespace": "default",
                            "uid": "uid-g", "annotations": {}},
               "spec": {"containers": [{"name": "main", "resources": {
                   "limits": {types.RESOURCE_GPU: 1, types.RESOURCE_MEM: 3000,
                              types.RESOURCE_CORES: 50}}}]},
               "status": {"phase": "Pending"}}
        review = handle_admission_review(
            {"request": {"uid": "rev-g", "object": pod}})
        assert review["response"]["allowed"] is True
        assert pod["spec"]["schedulerName"] == "vtpu-scheduler"
        client.add_pod(pod)
        sched = Scheduler(client)
        sched.register_from_node_annotations_once()
        winner, failed = sched.filter(client.get_pod("default", "g"))
        assert winner == NODE, failed
        sched.bind("default", "g", NODE)
        annos = client.get_pod("default", "g")["metadata"]["annotations"]
        (placed,) = codec.decode_pod_devices(annos[api.TO_ALLOCATE_ANNO])
        assert [(d.type, d.usedmem, d.usedcores) for d in placed] == [
            ("NVIDIA", 3000, 50)]
        assert placed[0].uuid in UUIDS

        with grpc.insecure_channel(f"unix://{plugin.socket_path}") as ch:
            resp = dp_grpc.DevicePluginStub(ch).Allocate(
                pb.AllocateRequest(container_requests=[
                    pb.ContainerAllocateRequest(
                        devicesIDs=[f"{placed[0].uuid}::0"])]))
        annos = client.get_pod("default", "g")["metadata"]["annotations"]
        assert annos[api.BIND_PHASE_ANNO] == "success"
        (ctr,) = resp.container_responses
        env = runtime.process_env(ctr)
        assert env["LD_PRELOAD"] == os.path.join(config.shim_host_dir,
                                                 "libvgpu.so")
        cache = env[api.ENV_SHARED_CACHE]
        assert cache == os.path.join(config.shim_host_dir, "containers",
                                     "uid-g_0", "vgpu.cache")
        # the response's env and nothing else of the test's, but for what
        # finds the mock driver and the package outside a container
        env.update({"PYTHONPATH": REPO, "PATH": os.environ["PATH"],
                    "LD_LIBRARY_PATH": native.mock_cuda_dir(),
                    "MOCK_CUDA_TOTAL": "16g"})
        proc = subprocess.Popen([sys.executable, "-c", CHILD], env=env,
                                stdin=subprocess.PIPE,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        try:
            line = proc.stdout.readline()
            assert line, proc.stderr.read()
            seen = json.loads(line)
            assert seen["interposed"] is True
            assert seen["limit"] == 3000 * MiB
            assert seen["rc"] == 0 and seen["total"] == 3000 * MiB
            assert seen["visible"] == placed[0].uuid
            with JaxRegionView(cache) as view:
                assert view.hbm_limit(0) == 3000 * MiB
                assert view.core_limit(0) == 50
                assert [p.pid for p in view.procs()] == [seen["pid"]]
            proc.communicate("exit\n", timeout=30)
            assert proc.returncode == 0
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
        with JaxRegionView(cache) as view:
            assert view.procs() == [] and view.used(0) == 0
    finally:
        plugin.stop()


def test_end_to_end_port_scheduler_over_http_to_libvgpu_region(
        tmp_path, mock_nvml, libs):
    """The chain above with the port's scheduler in place of the JAX
    one: its webhook, /filter and /bind answered over its HTTP app, then
    the port's plugin Allocate and a child under libvgpu.so on the mock
    libcuda.so.1 whose region carries the granted quota."""
    import asyncio

    from aiohttp.test_utils import TestClient, TestServer

    from vtpu_torch import device as port_device
    from vtpu_torch.scheduler import Scheduler as PortScheduler
    from vtpu_torch.scheduler.routes import build_app

    nvml_lib, _ = mock_nvml
    port_device.init_default_devices()
    client = FakeKubeClient()   # one apiserver for scheduler and plugin
    client.add_node(NODE)
    config = PluginConfig(device_split_count=10,
                          socket_dir=str(tmp_path / "sock"),
                          shim_host_dir=str(tmp_path / "vgpu"))
    server.install_shim_artifacts(config.shim_host_dir)
    plugin = GPUDevicePlugin(nvml_lib, config, client, NODE)
    plugin.start(register_with_kubelet=False)
    sched = None
    try:
        Registrar(nvml_lib, plugin.rm, client, NODE).register_once()
        sched = PortScheduler(client)
        sched.register_from_node_annotations_once()
        pod = {"metadata": {"name": "g", "namespace": "default",
                            "uid": "uid-g", "annotations": {}},
               "spec": {"containers": [{"name": "main", "resources": {
                   "limits": {types.RESOURCE_GPU: 1, types.RESOURCE_MEM: 3000,
                              types.RESOURCE_CORES: 50,
                              types.RESOURCE_PRIORITY: 0}}}]},
               "status": {"phase": "Pending"}}

        async def extender():
            http = TestClient(TestServer(build_app(sched)))
            await http.start_server()
            try:
                resp = await http.post("/webhook", json={
                    "apiVersion": "admission.k8s.io/v1",
                    "kind": "AdmissionReview",
                    "request": {"uid": "rev-g", "object": pod}})
                review = await resp.json()
                assert resp.status == 200 and \
                    review["response"]["allowed"] is True
                patch = json.loads(base64.b64decode(
                    review["response"]["patch"]))
                spec = patch[0]["value"]
                assert spec["schedulerName"] == "vtpu-scheduler"
                assert {"name": api.ENV_TASK_PRIORITY, "value": "0"} in \
                    spec["containers"][0]["env"]
                mutated = dict(pod, spec=spec)
                for op in patch[1:]:
                    key = op["path"].split("/")[-1].replace("~1", "/")
                    if op["path"] == "/metadata/annotations":
                        mutated["metadata"]["annotations"] = op["value"]
                    else:
                        mutated["metadata"]["annotations"][key] = \
                            op["value"]
                assert mutated["metadata"]["annotations"][
                    api.TASK_PRIORITY_ANNO] == "0"
                client.add_pod(mutated)
                resp = await http.post("/filter", json={
                    "Pod": client.get_pod("default", "g"),
                    "NodeNames": [NODE]})
                body = await resp.json()
                assert resp.status == 200 and body["NodeNames"] == [NODE], \
                    body
                resp = await http.post("/bind", json={
                    "PodName": "g", "PodNamespace": "default",
                    "PodUID": "uid-g", "Node": NODE})
                assert resp.status == 200 and \
                    (await resp.json())["Error"] == ""
            finally:
                await http.close()

        asyncio.new_event_loop().run_until_complete(extender())
        annos = client.get_pod("default", "g")["metadata"]["annotations"]
        assert annos[api.BIND_PHASE_ANNO] == "allocating"
        assert client.bindings[0]["node"] == NODE
        (placed,) = codec.decode_pod_devices(annos[api.TO_ALLOCATE_ANNO])
        assert [(d.type, d.usedmem, d.usedcores) for d in placed] == [
            ("NVIDIA", 3000, 50)]
        assert placed[0].uuid in UUIDS

        with grpc.insecure_channel(f"unix://{plugin.socket_path}") as ch:
            resp = dp_grpc.DevicePluginStub(ch).Allocate(
                pb.AllocateRequest(container_requests=[
                    pb.ContainerAllocateRequest(
                        devicesIDs=[f"{placed[0].uuid}::0"])]))
        annos = client.get_pod("default", "g")["metadata"]["annotations"]
        assert annos[api.BIND_PHASE_ANNO] == "success"
        assert api.NODE_LOCK_ANNO not in client.get_node(NODE)[
            "metadata"]["annotations"]
        (ctr,) = resp.container_responses
        env = runtime.process_env(ctr)
        cache = env[api.ENV_SHARED_CACHE]
        env.update({"PYTHONPATH": REPO, "PATH": os.environ["PATH"],
                    "LD_LIBRARY_PATH": native.mock_cuda_dir(),
                    "MOCK_CUDA_TOTAL": "16g"})
        proc = subprocess.Popen([sys.executable, "-c", CHILD], env=env,
                                stdin=subprocess.PIPE,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        try:
            line = proc.stdout.readline()
            assert line, proc.stderr.read()
            seen = json.loads(line)
            assert seen["interposed"] is True
            assert seen["limit"] == 3000 * MiB
            assert seen["rc"] == 0 and seen["total"] == 3000 * MiB
            assert seen["visible"] == placed[0].uuid
            with JaxRegionView(cache) as view:
                assert view.hbm_limit(0) == 3000 * MiB
                assert view.core_limit(0) == 50
                assert [p.pid for p in view.procs()] == [seen["pid"]]
            proc.communicate("exit\n", timeout=30)
            assert proc.returncode == 0
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
    finally:
        if sched is not None:
            sched.stop()
        plugin.stop()
        port_device.reset_registry()
