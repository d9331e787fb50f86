"""The node agent's rest: the NUMA source where NVML has no PCI id, the
entitlement validator, and the plugin's named locks.

NUMA (``vtpu_torch/plugin/nvml.py``): on the mock ``libnvidia-ml.so.1``,
cards whose fixture has no ``bus_id`` answer ``nvmlDeviceGetPciInfo_v3``
with NOT_SUPPORTED, as the measured H100 machine's NVML does. Their NUMA
node then comes from ``nvidia-smi topo -m`` (the program
``VGPU_NVIDIA_SMI`` names: here a script that prints a fixture under
tests/fixtures/):

- ``nvidia-smi-topo-m.hgx-h100-layout.txt``: an 8-card, two-socket node in
  the layout nvidia-smi prints (tab-separated cells, the header wrapped in
  terminal underline escapes, an empty cell before "GPU NUMA ID"); written
  for the test, not recorded from a machine;
- ``nvidia-smi-topo-m.one-socket-layout.txt``: "N/A" in the NUMA column,
  as a one-socket host prints it; written for the test as well;
- ``nvidia-smi-topo-m.h100-unsupported.txt``: recorded on the machine with the
  H100 that ``chip_smoke.py`` runs on, where ``nvidia-smi topo -m`` exits
  255 with that text.

The JAX package has no counterpart (a TPU chip's NUMA node is read from
sysfs, vtpu/plugin/tpulib.py); the reference reads ``nvidia-smi topo -m``
(SURVEY.md:196).

The validator (``vtpu_torch/csrc/validator.c``, built by
``native.build_all()``) against the JAX package's ``lib/vtpu/validator.c``,
both compiled with gcc here: the same exit code on a valid, an expired, a
tampered, a wrong-node, an unsigned and a wrongly signed license, and
with no secret or no file; the same ``--sign`` line as Python's HMAC.
"""

from __future__ import annotations

import json
import logging
import os
import subprocess
import time

import pytest

from vtpu_torch import api, native
from vtpu_torch.plugin import license as vlicense
from vtpu_torch.plugin import nvml

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures")
H100 = "NVIDIA H100 80GB HBM3"


def topo_fixture(name):
    return os.path.join(FIXTURES, f"nvidia-smi-topo-m.{name}.txt")


def card(i, **kw):
    return dict({"uuid": f"GPU-0000000{i}-aaaa-bbbb-cccc-dddddddddddd",
                 "name": H100, "memory_mb": 81559, "minor": i,
                 "ecc_uncorrected": 0, "xids": []}, **kw)


@pytest.fixture
def mock_nvml(tmp_path, monkeypatch):
    """open(cards, topo=None, rc=0) -> NvmlLib on the mock NVML serving
    ``cards``, with ``nvidia-smi`` a script that prints the ``topo``
    fixture and exits ``rc`` (None: no nvidia-smi at all)"""
    path = native.mock_nvml_library()
    opened = []

    def open_(cards, topo=None, rc=0):
        fixture = tmp_path / "cards.json"
        fixture.write_text(json.dumps({"gpus": cards}))
        monkeypatch.setenv("MOCK_NVML_FIXTURE", str(fixture))
        smi = tmp_path / "nvidia-smi"
        if topo is None:
            smi = tmp_path / "absent" / "nvidia-smi"
        else:
            smi.write_text(f"#!/bin/sh\n[ \"$1 $2\" = \"topo -m\" ] || "
                           f"exit 9\ncat '{topo_fixture(topo)}'\nexit {rc}\n")
            smi.chmod(0o755)
        monkeypatch.setenv(api.ENV_NVIDIA_SMI, str(smi))
        lib = nvml.NvmlLib(path, pci_root=str(tmp_path / "pci"))
        opened.append(lib)
        return lib

    yield open_
    for lib in opened:
        lib.close()


def test_numa_from_nvidia_smi_where_nvml_has_no_pci_id(mock_nvml):
    lib = mock_nvml([card(i) for i in range(8)], topo="hgx-h100-layout")
    chips = lib.enumerate()
    assert [c.numa for c in chips] == [0, 0, 0, 0, 1, 1, 1, 1]
    assert lib.numa_sources == {i: "nvidia-smi" for i in range(8)}
    # read once a process: the 1 Hz health loop's enumerations and other
    # instances do not run it again
    os.unlink(os.environ[api.ENV_NVIDIA_SMI])
    assert [c.numa for c in lib.enumerate()] == [0, 0, 0, 0, 1, 1, 1, 1]
    again = mock_nvml([card(i) for i in range(8)], topo="hgx-h100-layout")
    os.unlink(os.environ[api.ENV_NVIDIA_SMI])
    assert [c.numa for c in again.enumerate()] == [0, 0, 0, 0, 1, 1, 1, 1]


def test_a_pci_id_keeps_sysfs_first(mock_nvml, tmp_path):
    pci = tmp_path / "pci" / "0000:3b:00.0"
    pci.mkdir(parents=True)
    (pci / "numa_node").write_text("1\n")
    lib = mock_nvml([card(0, bus_id="00000000:3B:00.0"), card(1)],
                    topo="hgx-h100-layout")
    assert [c.numa for c in lib.enumerate()] == [1, 0]
    assert lib.numa_sources == {0: "pci", 1: "nvidia-smi"}


@pytest.mark.parametrize("topo,rc", [("one-socket-layout", 0),
                                     ("h100-unsupported", 255), (None, 0)],
                         ids=["one socket N/A", "topo fails (recorded)",
                              "no nvidia-smi"])
def test_numa_zero_with_one_warning_as_the_last_resort(mock_nvml, caplog,
                                                       topo, rc):
    caplog.set_level(logging.WARNING, logger=nvml.log.name)
    lib = mock_nvml([card(0), card(1)], topo=topo, rc=rc)
    assert [c.numa for c in lib.enumerate()] == [0, 0]
    assert [c.numa for c in lib.enumerate()] == [0, 0]
    assert lib.numa_sources == {0: "none", 1: "none"}
    # once a process, not once an instance
    other = mock_nvml([card(0), card(1)], topo=topo, rc=rc)
    assert [c.numa for c in other.enumerate()] == [0, 0]
    warned = [r for r in caplog.records if "NUMA node reads 0" in
              r.getMessage()]
    assert len(warned) == 1


def test_topo_parser_reads_the_numa_column():
    with open(topo_fixture("hgx-h100-layout")) as f:
        text = f.read()
    assert nvml.topo_numa(text) == {i: i // 4 for i in range(8)}
    # a range or a list names its first node; no header, no column
    assert nvml.topo_numa("\tGPU0\tNUMA Affinity\nGPU0\t X \t2-3\n") == \
        {0: 2}
    assert nvml.topo_numa("GPU0\t X \t0\n") == {}
    with open(topo_fixture("h100-unsupported")) as f:
        assert nvml.topo_numa(f.read()) == {}


# ------------------------------------------------------------ validator

@pytest.fixture(scope="module")
def validators(tmp_path_factory):
    """(the JAX validator, the port's), each compiled with gcc"""
    out = tmp_path_factory.mktemp("validator") / "vtpu-validator"
    subprocess.run(["gcc", "-O2", "-o", str(out),
                    os.path.join(REPO, "lib", "vtpu", "validator.c")],
                   check=True, capture_output=True, timeout=120)
    return str(out), native.validator()


SIDES = {"jax": ("vtpu", "VTPU_LICENSE_SECRET", "VTPU_LICENSE_NODE"),
         "port": (api.LICENSE_PRODUCT, api.ENV_LICENSE_SECRET,
                  api.ENV_LICENSE_NODE)}
GOOD = int(time.time()) + 3600


def license_text(product, secret, *, expires=GOOD, nodes="gpu-*",
                 signed=True, tamper=False):
    text = vlicense.mint(secret, expires, nodes, max_chips=8,
                         product=product)
    if not signed:
        text = text[:text.index("sig=")]
    if tamper:
        text = text.replace("max_chips=8", "max_chips=80")
    return text


CASES = {
    "valid": ({}, "gpu-node-3", 0),
    "expired": ({"expires": int(time.time()) - 5}, "gpu-node-3", 1),
    "tampered": ({"tamper": True}, "gpu-node-3", 1),
    "wrong node": ({}, "tpu-node-3", 1),
    "unsigned": ({"signed": False}, "gpu-node-3", 1),
}


@pytest.mark.parametrize("case", list(CASES))
def test_validator_exit_codes_match_the_reference(validators, tmp_path,
                                                  case):
    kw, node, want = CASES[case]
    rcs = {}
    for (side, (product, secret_env, node_env)), binary in zip(
            SIDES.items(), validators):
        lic = tmp_path / f"{side}.license"
        lic.write_text(license_text(product, b"operator-secret", **kw))
        env = dict(os.environ, **{secret_env: "operator-secret",
                                  node_env: node})
        proc = subprocess.run([binary, str(lic)], env=env,
                              capture_output=True, text=True, timeout=60)
        rcs[side] = proc.returncode
    assert rcs == {"jax": want, "port": want}


def test_validator_usage_errors_and_signing_match_the_reference(
        validators, tmp_path):
    import hashlib
    import hmac

    for (side, (product, secret_env, node_env)), binary in zip(
            SIDES.items(), validators):
        clean = {k: v for k, v in os.environ.items()
                 if not k.startswith(("VTPU_LICENSE", "VGPU_LICENSE"))}
        lic = tmp_path / f"{side}.license"
        lic.write_text(license_text(product, b"a"))
        # signed with another secret
        env = dict(clean, **{secret_env: "b", node_env: "gpu-1"})
        assert subprocess.run([binary, str(lic)], env=env,
                              capture_output=True).returncode == 1
        # no secret (the default secret file is absent here), no file
        env = dict(clean, **{secret_env + "_FILE": str(tmp_path / "none")})
        assert subprocess.run([binary, str(lic)], env=env,
                              capture_output=True).returncode == 2
        assert subprocess.run([binary, str(tmp_path / "absent")], env=env,
                              capture_output=True).returncode == 2
        # the secret from a file, the --sign line equal to Python's HMAC
        (tmp_path / "secret").write_text("k" * 100 + "\n")
        env = dict(clean, **{secret_env + "_FILE": str(tmp_path / "secret"),
                             node_env: "gpu-1"})
        body = f"product={product}\nexpires={GOOD}\n"
        lic.write_text(body)
        out = subprocess.run([binary, str(lic), "--sign"], env=env,
                             capture_output=True, text=True).stdout
        want = hmac.new(b"k" * 100, body.encode(), hashlib.sha256)
        assert out.strip() == f"sig={want.hexdigest()}"
        lic.write_text(body + out)
        assert subprocess.run([binary, str(lic)], env=env,
                              capture_output=True).returncode == 0


def test_the_plugin_installs_and_mounts_the_built_validator(tmp_path):
    """install_shim_artifacts copies the validator native.build_all()
    built into the shim host dir, where Allocate's license mount finds it
    (tests/test_torch_plugin.py::test_allocate_license_mounts_match)."""
    from vtpu_torch.plugin import server

    assert "vgpu-validator" in native.build_all()
    server.install_shim_artifacts(str(tmp_path / "vgpu"))
    installed = tmp_path / "vgpu" / "vgpu-validator"
    assert os.access(installed, os.X_OK)
    proc = subprocess.run([str(installed), str(tmp_path / "absent")],
                          capture_output=True, text=True)
    assert proc.returncode == 2 and "cannot open" in proc.stderr


def test_plugin_locks_are_named_for_the_order_checker(tmp_path,
                                                      monkeypatch):
    """With lock debugging on, the plugin's chip table, registration and
    checkpoint locks are lockdebug's named locks (the JAX plugin's
    "plugin.chips" and "plugin.checkpoint" among them), so an acquisition
    against the recorded order raises."""
    from vtpu_torch.plugin.config import PluginConfig
    from vtpu_torch.plugin.nvml import FakeNvmlLib
    from vtpu_torch.plugin.server import GPUDevicePlugin
    from vtpu_torch.util import lockdebug
    from vtpu_torch.util.client import FakeKubeClient

    monkeypatch.setenv(lockdebug.ENV_FLAG, "1")
    lockdebug.reset()
    fixture = tmp_path / "cards.json"
    fixture.write_text(json.dumps({"gpus": [dict(card(0), numa=0)]}))
    plugin = GPUDevicePlugin(
        FakeNvmlLib(fixture=str(fixture)), PluginConfig(
            socket_dir=str(tmp_path / "sock"),
            shim_host_dir=str(tmp_path / "vgpu")),
        FakeKubeClient(), "n1")
    names = {lk.name for lk in (plugin._chips_lock, plugin._register_mu,
                                plugin.checkpoint._lock)}
    assert names == {"plugin.chips", "plugin.register", "plugin.checkpoint"}
    with plugin._register_mu:
        with plugin._chips_lock:
            pass
    with pytest.raises(lockdebug.LockOrderError):
        with plugin._chips_lock:
            with plugin._register_mu:
                pass
    lockdebug.reset()
