"""The memory-space probe (vtpu_torch/bench/memspace.py, the port of
hack/memspace_probe.py) on the CPU: its child places 64 MiB in each memory
kind through the driver's entry points (``cuMemAlloc``, ``cuMemHostAlloc``
for pinned memory, a plain buffer, ``cuMemHostRegister``,
``cuMemAllocManaged`` resolved through ``cuGetProcAddress_v2``) under
libvgpu.so on the mock libcuda.so.1, with a 4 GiB device quota and a 1 GiB
host limit. Every gate is exact. The JAX probe's result (MEMSPACE.json, a
TPU v5e's) is only read, for its keys: the probe needs a TPU and never
runs here."""

import copy
import json
import os
import subprocess
import sys

import pytest

from vtpu_torch.bench import memspace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MiB = 1 << 20


@pytest.fixture(scope="module")
def probe():
    """the probe's result on the mock driver, through its entry point"""
    out = subprocess.run(
        [sys.executable, "-m", "vtpu_torch.bench.memspace", "--backend",
         "mock"], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_every_gate_holds_on_the_mock_driver(probe):
    assert probe["gates"] == {k: True for k in probe["gates"]}
    assert len(probe["gates"]) == 9
    assert probe["ok"] and probe["rc"] == 0
    assert probe["backend"] == "mock"


def test_host_placements_charge_no_device_quota(probe):
    b = 64 * MiB
    assert probe["placement_bytes"] == b
    assert probe["shim_used_device_bytes"] == b
    for kind in ("pinned_host", "unpinned_host", "registered_host"):
        assert probe[f"{kind}_device_bytes"] == 0, kind
    assert probe["shim_charged_for_host_copy_bytes"] == 0
    assert probe["host_put_ok"] is True
    # copies between every kind and the device charge nothing either
    assert probe["copies_rc"] == [0, 0, 0, 0]


def test_the_host_ledger_is_exact(probe):
    b = 64 * MiB
    assert probe["pinned_host_ledger_bytes"] == b
    assert probe["registered_host_ledger_bytes"] == b
    assert probe["unpinned_host_ledger_bytes"] == 0
    assert probe["registered_rc"] == 0
    assert probe["pinned_past_host_limit"] == "refused"
    assert probe["host_limit_bytes"] == 1 << 30


def test_managed_memory_is_charged_and_refused_past_the_quota(probe):
    b = 64 * MiB
    assert probe["managed_hooked"] is True
    assert probe["managed_rc"] == 0
    assert probe["managed_device_bytes"] == b
    assert probe["managed_ledger_bytes"] == 0
    # the whole quota on top of what the pod holds: no oversubscription
    assert probe["managed_past_quota_rc"] == memspace.CUDA_ERROR_OUT_OF_MEMORY
    assert probe["quota_bytes"] == 4 << 30


def test_every_charge_returns_to_zero(probe):
    assert probe["managed_free_rc"] == 0
    assert probe["unregister_rc"] == 0
    assert probe["free_rcs"] == [0, 0]
    assert probe["device_bytes_after_free"] == 0
    assert probe["host_ledger_bytes_after_free"] == 0
    assert probe["region_clean_after_exit"] is True


def test_the_result_carries_every_key_of_the_jax_probe(probe):
    with open(os.path.join(REPO, "MEMSPACE.json")) as f:
        jax = json.load(f)
    assert set(jax) <= set(probe), set(jax) - set(probe)
    # the kinds the JAX probe named, under the same names, and the others
    assert set(jax["memory_kinds"]) <= set(probe["memory_kinds"])
    assert {"registered_host", "managed"} <= set(probe["memory_kinds"])
    assert probe["quota_bytes"] == jax["quota_bytes"]
    # the mock moves no bytes over a link: timings are not measured
    assert probe["in_hbm_touch_s"] is None
    assert probe["roundtrip_penalty_x"] is None


def test_bounds_are_hbm3_and_pcie_gen5_rates():
    b = memspace.bounds(64 * MiB)
    assert b["in_hbm_touch_bound_s"] == pytest.approx(2 * 64 * MiB / 3.35e12)
    assert b["copy_bound_s"] == pytest.approx(64 * MiB / 64e9)
    assert b["host_to_hbm_bound_s"] == pytest.approx(
        b["copy_bound_s"] + b["in_hbm_touch_bound_s"])


@pytest.mark.parametrize("key,value,gate", [
    ("pinned_host_device_bytes", 4096, "host_kinds_charge_no_device_quota"),
    ("registered_host_ledger_bytes", 0,
     "pinned_and_registered_ledger_exact"),
    ("unpinned_host_ledger_bytes", 64 * MiB, "pageable_ledger_zero"),
    ("pinned_past_host_limit", "allocated",
     "pinned_past_host_limit_refused"),
    ("managed_device_bytes", 0, "managed_charged_to_device_quota"),
    ("managed_past_quota_rc", 0, "managed_past_quota_refused"),
    ("host_ledger_bytes_after_free", 64 * MiB, "charges_back_to_zero"),
    ("region_clean_after_exit", False, "region_clean_after_exit"),
    ("shim_used_device_bytes", 0, "device_placement_charged"),
])
def test_each_gate_catches_its_fault(probe, key, value, gate):
    broken = copy.deepcopy(probe)
    broken[key] = value
    got = memspace.gates(broken)
    assert [k for k, ok in got.items() if not ok] == [gate]


def test_no_card_exits_2_and_the_parent_loads_no_torch():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the probe would run on it")
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys\nfrom vtpu_torch.bench import memspace\n"
         "rc = memspace.main([])\n"
         "print(rc, sorted(m for m in sys.modules if m.split('.')[0] in "
         "('torch', 'jax', 'vtpu')))"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.stdout.split("\n")[-2] == "2 []", out.stdout + out.stderr
