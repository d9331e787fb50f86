"""The node agent's NVML layer and entry point on the CPU.

``NvmlLib``'s ctypes code runs against the mock ``libnvidia-ml.so.1``
(vtpu_torch/csrc/mock_nvml.c, built with gcc by vtpu_torch/native.py),
which serves a JSON fixture of cards as FakeNvmlLib reads it; the error
signals, the health tracking, the missing-library refusals, the runtime
stand-in and ``python -m vtpu_torch.plugin``'s ``main`` are held to what
the JAX package's tpulib and plugin tests check for TPUs
(tests/test_plugin.py:507-690).
"""

import json
import os
import subprocess
import sys
import textwrap
import time
from concurrent import futures

import grpc
import pytest

from vtpu_torch import api, native
from vtpu_torch.plugin import deviceplugin_pb2 as pb
from vtpu_torch.plugin import dp_grpc, runtime
from vtpu_torch.plugin.config import PluginConfig, load_node_config
from vtpu_torch.plugin.nvml import (APPLICATION_XIDS, ChipInfo, FakeNvmlLib,
                                    HealthTrackingNvmlLib, NvmlError,
                                    NvmlLib)
from vtpu_torch.plugin.rm import replica_id
from vtpu_torch.plugin.server import GPUDevicePlugin
from vtpu_torch.util import codec
from vtpu_torch.util.client import FakeKubeClient

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NODE = "gpu-node"
H100 = "NVIDIA H100 80GB HBM3"


def card(i, **kw):
    return dict({"uuid": f"GPU-0000000{i}-aaaa-bbbb-cccc-dddddddddddd",
                 "name": H100, "memory_mb": 81559, "minor": i,
                 "ecc_uncorrected": 0, "xids": []}, **kw)


def write_fixture(path, cards):
    path.write_text(json.dumps({"gpus": cards}))
    return str(path)


@pytest.fixture(scope="module")
def mock_path():
    return native.mock_nvml_library()


@pytest.fixture
def nvml(tmp_path, monkeypatch, mock_path):
    """open(cards) -> NvmlLib on the mock serving ``cards``; closed after
    the test."""
    opened = []

    def open_(cards, **kw):
        path = write_fixture(tmp_path / "cards.json", cards)
        monkeypatch.setenv("MOCK_NVML_FIXTURE", path)
        lib = NvmlLib(mock_path, **kw)
        opened.append(lib)
        return lib, path

    yield open_
    for lib in opened:
        lib.close()


def test_nvml_reads_each_card_through_the_c_api(nvml, tmp_path):
    pci = tmp_path / "pci"
    (pci / "0000:3b:00.0").mkdir(parents=True)
    (pci / "0000:3b:00.0" / "numa_node").write_text("1\n")
    lib, _ = nvml([card(0, minor=3, bus_id="00000000:3B:00.0"),
                   card(1, memory_mb=40960, name="NVIDIA A100-SXM4-40GB")],
                  pci_root=str(pci))
    chips = lib.enumerate()
    assert [(c.index, c.uuid, c.type, c.hbm_mb, c.numa, c.device_paths,
             c.mesh, c.health) for c in chips] == [
        (0, card(0)["uuid"], f"NVIDIA-{H100}", 81559, 1, ["/dev/nvidia3"],
         None, True),
        # no PCI bus id reported (as on a machine whose NVML answers
        # NOT_SUPPORTED): NUMA node 0
        (1, card(1)["uuid"], "NVIDIA-NVIDIA A100-SXM4-40GB", 40960, 0,
         ["/dev/nvidia1"], None, True)]


def test_nvml_and_fake_agree_on_one_fixture(nvml):
    lib, path = nvml([card(0), card(1, xids=[79])])
    fake = FakeNvmlLib(fixture=path)
    assert lib.enumerate() == fake.enumerate()
    assert [lib.error_count(c) for c in lib.enumerate()] == \
        [fake.error_count(c) for c in fake.enumerate()] == [0, 1]


def test_nvml_refuses_two_cards_with_one_uuid(nvml):
    lib, _ = nvml([card(0), card(0, minor=1)])
    with pytest.raises(NvmlError, match="two cards"):
        lib.enumerate()


def test_nvml_without_the_library_raises(tmp_path):
    with pytest.raises(NvmlError, match="cannot load NVML"):
        NvmlLib(str(tmp_path / "libnvidia-ml.so.1"))


def test_nvml_init_failure_raises(tmp_path, monkeypatch, mock_path):
    monkeypatch.setenv("MOCK_NVML_FIXTURE", str(tmp_path / "absent.json"))
    with pytest.raises(NvmlError, match="nvmlInit_v2"):
        NvmlLib(mock_path)


DETECT = textwrap.dedent("""
    import ctypes.util, json, sys
    from vtpu_torch.plugin import nvml
    try:
        lib = nvml.detect()
        out = type(lib).__name__
    except nvml.NvmlError as e:
        out = "NvmlError: " + str(e)
    print(json.dumps({"detect": out,
                      "driver": ctypes.util.find_library("nvidia-ml")}))
""")


@pytest.mark.parametrize("with_fixture", [True, False])
def test_detect_takes_the_fixture_env_or_nvml_and_nothing_else(
        with_fixture, tmp_path):
    """A fresh process (this one may hold the mock under the library's
    soname): with VGPU_FAKE_NVML the fixture, without it NVML — which
    raises where the driver's library is absent, with no fallback."""
    env = {k: v for k, v in os.environ.items()
           if k not in (api.ENV_FAKE_NVML, "LD_LIBRARY_PATH",
                        "LD_PRELOAD")}
    env["PYTHONPATH"] = REPO
    if with_fixture:
        env[api.ENV_FAKE_NVML] = write_fixture(tmp_path / "c.json",
                                               [card(0)])
    proc = subprocess.run([sys.executable, "-c", DETECT], env=env,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout)
    if with_fixture:
        assert out["detect"] == "FakeNvmlLib"
    elif out["driver"] is None:
        assert out["detect"].startswith("NvmlError: cannot load NVML")
    else:  # a machine with the driver: NVML itself, never the fake
        assert out["detect"] == "NvmlLib"


def test_error_signals_count_ecc_and_critical_xids(nvml, tmp_path):
    lib, path = nvml([card(0, ecc_uncorrected=2),
                      card(1, ecc_uncorrected=None)])
    chips = lib.enumerate()
    assert [lib.error_count(c) for c in chips] == [2, 0]
    cards = [card(0, ecc_uncorrected=3, xids=[13, 79]),
             card(1, ecc_uncorrected=None, xids=[31, 48, 45])]
    write_fixture(tmp_path / "cards.json", cards)
    # application XIDs (13, 31, 45) are the workload's fault, not the
    # card's
    assert {13, 31, 45} <= APPLICATION_XIDS
    assert [lib.error_count(c) for c in chips] == [4, 1]
    assert [lib.error_count(c) for c in chips] == [4, 1]  # seen once


def test_error_burst_marks_unhealthy_then_recovers(nvml, tmp_path):
    lib, _ = nvml([card(0), card(1)])
    tracked = HealthTrackingNvmlLib(lib, recovery_s=0.2)
    write_fixture(tmp_path / "cards.json", [card(0), card(1,
                  ecc_uncorrected=9)])
    # first sight of a count is its baseline, not an event
    assert all(c.health for c in tracked.enumerate())
    write_fixture(tmp_path / "cards.json", [card(0), card(1,
                  ecc_uncorrected=10)])
    assert [c.health for c in tracked.enumerate()] == [True, False]
    time.sleep(0.25)
    assert all(c.health for c in tracked.enumerate())


def test_error_count_reset_rebaselines():
    lib = FakeNvmlLib(chips=[ChipInfo(uuid="GPU-x", index=0,
                                      device_paths=["/dev/nvidia0"])])
    tracked = HealthTrackingNvmlLib(lib, recovery_s=0.05)
    lib.set_errors("GPU-x", 50)
    tracked.enumerate()                 # baseline 50
    lib.set_errors("GPU-x", 0)          # a driver reload zeroed it
    tracked.enumerate()
    time.sleep(0.06)
    lib.set_errors("GPU-x", 3)          # fresh errors after the reset
    assert not tracked.enumerate()[0].health


def test_vanished_card_kept_unhealthy_and_flaps_back(tmp_path):
    fake = FakeNvmlLib(fixture=write_fixture(tmp_path / "c.json",
                                             [card(0), card(1), card(2)]))
    tracked = HealthTrackingNvmlLib(fake)
    assert len(tracked.enumerate()) == 3
    gone = fake.chips.pop(1)
    chips = {c.uuid: c for c in tracked.enumerate()}
    assert len(chips) == 3 and not chips[gone.uuid].health
    fake.chips.insert(1, gone)
    assert all(c.health for c in tracked.enumerate())
    # the same device node under a new UUID is a rename, not a loss
    fake.chips[2].uuid = "GPU-renamed"
    assert [c.health for c in tracked.enumerate()] == [True] * 3


# ---------------------------------------------------------------------------
# configuration, preferred allocation, the runtime stand-in
# ---------------------------------------------------------------------------

def test_config_refuses_oversubscription_and_reads_node_overrides(
        tmp_path):
    with pytest.raises(ValueError, match="oversubscription"):
        PluginConfig(device_memory_scaling=1.5).validate()
    cfg = tmp_path / "config.json"
    cfg.write_text(json.dumps({"nodeconfig": [
        {"name": NODE, "devicesplitcount": 7, "devicecorescaling": 2.0}]}))
    out = load_node_config(PluginConfig(), NODE, str(cfg))
    assert (out.device_split_count, out.device_cores_scaling) == (7, 2.0)
    assert out.resource_name == "nvidia.com/gpu"
    assert out.shim_host_dir == api.CONTAINER_LIB_DIR


@pytest.fixture
def plugin(tmp_path):
    fake = FakeNvmlLib(fixture=write_fixture(tmp_path / "c.json",
                                             [card(0), card(1), card(2)]))
    p = GPUDevicePlugin(fake, PluginConfig(
        device_split_count=4, socket_dir=str(tmp_path / "sock"),
        shim_host_dir=str(tmp_path / "vgpu")), FakeKubeClient(), NODE)
    p.start(register_with_kubelet=False)
    yield p
    p.stop()


@pytest.mark.parametrize("policy,cards", [("packed", 1), ("spread", 2)])
def test_preferred_allocation_policies(policy, cards, plugin):
    plugin.config.preferred_allocation_policy = policy
    uuids = [c.uuid for c in plugin.chips]
    avail = [replica_id(uuids[0], i) for i in range(4)] + \
        [replica_id(uuids[1], i) for i in range(2)]
    with grpc.insecure_channel(f"unix://{plugin.socket_path}") as ch:
        resp = dp_grpc.DevicePluginStub(ch).GetPreferredAllocation(
            pb.PreferredAllocationRequest(container_requests=[
                pb.ContainerPreferredAllocationRequest(
                    available_deviceIDs=avail, allocation_size=2,
                    must_include_deviceIDs=[])]))
    picked = list(resp.container_responses[0].deviceIDs)
    assert len(picked) == 2
    assert len({p.rsplit("::", 1)[0] for p in picked}) == cards
    # packed takes the card with the most free replicas first
    assert picked[0].startswith(uuids[0])


def test_second_plugin_refuses_a_live_socket(plugin, monkeypatch):
    monkeypatch.setenv(api.ENV_SOCKET_PROBE_TIMEOUT_S, "0.5")
    other = GPUDevicePlugin(plugin.gpulib, plugin.config, FakeKubeClient(),
                            NODE)
    with pytest.raises(RuntimeError, match="refusing to start"):
        other.start(register_with_kubelet=False)


def test_runtime_stand_in_translates_the_response(plugin):
    chips = plugin.chips
    resp = pb.ContainerAllocateResponse(
        envs={api.ENV_NVIDIA_VISIBLE_DEVICES: f"{chips[2].uuid},"
                                              f"{chips[0].uuid}",
              api.ENV_SHARED_CACHE: "/usr/local/vgpu/containers/u_0/"
                                    "vgpu.cache",
              api.ENV_SM_LIMIT: "50"},
        mounts=[pb.Mount(container_path=api.CONTAINER_SHIM_PATH,
                         host_path="/h/libvgpu.so", read_only=True),
                pb.Mount(container_path="/usr/local/vgpu/containers/u_0",
                         host_path="/h/containers/u_0"),
                pb.Mount(container_path=api.LD_SO_PRELOAD_PATH,
                         host_path="/h/ld.so.preload", read_only=True)])
    env = runtime.process_env(resp)
    visible = f"{chips[2].uuid},{chips[0].uuid}"
    assert env == {api.ENV_NVIDIA_VISIBLE_DEVICES: visible,
                   api.ENV_SHARED_CACHE: "/h/containers/u_0/vgpu.cache",
                   api.ENV_SM_LIMIT: "50", "LD_PRELOAD": "/h/libvgpu.so",
                   api.ENV_VISIBLE_DEVICES: visible}
    del resp.mounts[2]   # control disabled: no preload
    assert "LD_PRELOAD" not in runtime.process_env(resp)
    with pytest.raises(ValueError, match="in no mount"):
        runtime.host_path("/etc/other", resp.mounts)


# ---------------------------------------------------------------------------
# python -m vtpu_torch.plugin
# ---------------------------------------------------------------------------

DRIVER = textwrap.dedent("""
    import json, os, signal, sys, threading, time
    from vtpu_torch import api
    from vtpu_torch.plugin.__main__ import main
    from vtpu_torch.util.client import FakeKubeClient

    sock_dir, shim_dir = sys.argv[1], sys.argv[2]
    client = FakeKubeClient()
    client.add_node("n1")

    def report():
        while api.NODE_REGISTER_ANNO not in client.get_node("n1")[
                "metadata"]["annotations"]:
            time.sleep(0.02)
        print(json.dumps({
            "annos": client.get_node("n1")["metadata"]["annotations"],
            "modules": sorted(m for m in sys.modules
                              if m.split(".")[0] in ("torch", "vtpu",
                                                     "jax"))}),
              flush=True)
        sys.stdin.readline()
        os.kill(os.getpid(), signal.SIGINT)

    threading.Thread(target=report, daemon=True).start()
    main(["--node-name", "n1", "--socket-dir", sock_dir,
          "--shim-host-dir", shim_dir, "--health-port", "-1",
          "--node-config-file", os.devnull, "--device-split-count", "3"],
         client=client)
    print("stopped", flush=True)
""")


def test_main_serves_a_fixture_registered_with_kubelet(tmp_path, libs):
    """The entry point with an injected client: it installs libvgpu.so and
    ld.so.preload into the shim dir, registers with a fake kubelet,
    reports the inventory, serves ListAndWatch, imports neither torch nor
    the JAX package, and stops on SIGINT."""
    sock_dir = tmp_path / "dp"
    sock_dir.mkdir()
    received = []

    class FakeKubelet(dp_grpc.RegistrationServicer):
        def Register(self, request, context):
            received.append(request)
            return pb.Empty()

    kubelet = grpc.server(futures.ThreadPoolExecutor(max_workers=2))
    dp_grpc.add_registration_servicer(kubelet, FakeKubelet())
    kubelet.add_insecure_port(f"unix://{sock_dir}/{dp_grpc.KUBELET_SOCKET}")
    kubelet.start()
    env = dict(os.environ, PYTHONPATH=REPO)
    env[api.ENV_FAKE_NVML] = write_fixture(tmp_path / "c.json",
                                           [card(0), card(1)])
    proc = subprocess.Popen(
        [sys.executable, "-c", DRIVER, str(sock_dir),
         str(tmp_path / "vgpu")], env=env, stdin=subprocess.PIPE,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert line, proc.stderr.read()
        seen = json.loads(line)
        assert seen["modules"] == []
        devices = codec.decode_node_devices(
            seen["annos"][api.NODE_REGISTER_ANNO])
        assert [(d.id, d.count, d.devmem) for d in devices] == [
            (card(i)["uuid"], 3, 81559) for i in range(2)]
        deadline = time.monotonic() + 10
        while not received and time.monotonic() < deadline:
            time.sleep(0.02)
        assert received[0].resource_name == "nvidia.com/gpu"
        assert received[0].endpoint == "vgpu.sock"
        with grpc.insecure_channel(f"unix://{sock_dir}/vgpu.sock") as ch:
            first = next(dp_grpc.DevicePluginStub(ch).ListAndWatch(
                pb.Empty(), timeout=10))
        assert len(first.devices) == 6
        assert all(d.health == "Healthy" for d in first.devices)
        assert os.path.exists(tmp_path / "vgpu" / "libvgpu.so")
        assert (tmp_path / "vgpu" / "ld.so.preload").read_text() == \
            api.CONTAINER_SHIM_PATH + "\n"
        out, err = proc.communicate("stop\n", timeout=30)
        assert proc.returncode == 0, err
        assert out.strip() == "stopped"
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        kubelet.stop(0)


@pytest.fixture(scope="module")
def libs():
    return native.build_all()
