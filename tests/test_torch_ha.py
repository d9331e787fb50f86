"""HA, the multi-active shard groups, elastic quotas and live migration on
the port, held to the JAX package's own kill points.

Every fast kill point of tests/test_ha.py, tests/test_ha_chaos.py,
tests/test_group_chaos.py, tests/test_resize_chaos.py,
tests/test_migrate_chaos.py and tests/test_preempt_chaos.py runs twice on the same inputs
(tests/torch_sched_parity.py ``run_reference_test``): as written, against
the JAX package with the port's GPUDevices registered, and with every name
it takes from ``vtpu`` bound to the port's (vtpu_torch.ha,
vtpu_torch.scheduler.{migrate,rebalancer} and what they drive). Both runs
hold the test's own assertions, and their records are equal: every
annotation written (after ``vTPU`` -> ``vGPU``), each lease's holder and
generation, each fenced commit, each recover()'s replay count. The
tolerance is exact. No scenario here reaches F8 (a multi-card
``numa-bind`` request on cards with no coordinate): the kill points place
single-card pods and gangs on hosts with coordinates.

Left out, each for a reason of its own:
- the ``slow`` and parametrized matrices (the tier-1 run skips them);
- the node monitor's halves of the resize and drain protocols, whose
  tests write the JAX region's file names (``vtpu.cache``,
  ``vtpu.drain.json``) as literals: the port's monitor reads ``vgpu.*``,
  and tests/test_torch_monitor.py holds it to the JAX monitor;
- a test that reads a metric family by its ``vTPU`` name.
"""

from __future__ import annotations

import importlib

import pytest

from tests.torch_sched_parity import run_reference_test
from vtpu_torch.contracts import covers_edge

FILES = ("tests.test_ha", "tests.test_ha_chaos", "tests.test_group_chaos",
         "tests.test_resize_chaos", "tests.test_migrate_chaos",
         "tests.test_preempt_chaos")

#: kill points left out, and why (module docstring)
LEFT_OUT = {
    "tests.test_resize_chaos": {
        "test_intent_applies_and_is_exactly_once": "monitor file names",
        "test_block_survives_monitor_restart": "monitor file names",
        "test_garbled_intent_refused_once": "monitor file names",
        "test_multi_container_pod_applies_per_container_segments":
            "monitor file names",
        "test_shrink_clamps_graces_blocks_then_lands": "monitor file names",
        "test_stale_generation_never_rewinds": "monitor file names",
        "test_garbled_high_gen_annotation_never_wedges_the_protocol":
            "monitor file names",
    },
    "tests.test_migrate_chaos": {
        "test_monitor_sigkill_after_intent_replays_from_sidecar":
            "monitor file names",
    },
    "tests.test_group_chaos": {
        "test_two_actives_own_disjoint_groups_and_refuse_cross_routing":
            "reads the vTPUShardGroupOwner family",
    },
}

#: kill points whose writes race a burst of filter threads: both packages
#: hold the test's own assertions, and their records are not compared
RACING = {("tests.test_ha_chaos",
           "test_failover_mid_burst_repopulates_every_shard")}


def kill_points():
    out = []
    for modname in FILES:
        mod = importlib.import_module(modname)
        for name in sorted(dir(mod)):
            fn = getattr(mod, name)
            if not name.startswith("test_") or not callable(fn):
                continue
            marks = {m.name for m in getattr(fn, "pytestmark", [])}
            if marks & {"slow", "parametrize"} or \
                    name in LEFT_OUT.get(modname, {}):
                continue
            out.append(pytest.param(modname, name,
                                    id=f"{modname.split('.')[1]}::{name}"))
    return out


#: the crash edges of vtpu_torch/contracts.py these kill points exercise
#: on the port: each is the edge its JAX kill point tags; the edges whose
#: only kill points are left out above carry a waiver in the registry
@covers_edge(
    "commit:kill-mid-gang", "commit:kill-mid-queue-drain",
    "commit:deposed-inflight-commit", "commit:deposed-mid-bind",
    "commit:kill-during-bind-flush", "resize:deposed-intent",
    "evict:kill-before-stamp", "evict:kill-between-stamp-and-delete",
    "evict:deposed-leader-stamp", "evict:abandoned-gang-unwind",
    "migrate:kill-before-stamp", "migrate:kill-after-stamp",
    "migrate:kill-after-snapshot",
    "migrate:kill-after-cutover-before-release",
    "migrate:rescue-deadline-expiry", "group-lease:owner-kill-mid-burst",
    "group-lease:kill-mid-evict-absorption",
    "group-lease:handoff-vs-queued-commit",
    "group-lease:handoff-mid-resize", "group-lease:lease-split-rejoin")
@pytest.mark.parametrize("modname,test", kill_points())
def test_kill_point_matches_the_reference(modname, test, tmp_path):
    jax = run_reference_test(modname, test, False, tmp_path / "jax")
    port = run_reference_test(modname, test, True, tmp_path / "port")
    if (modname, test) not in RACING:
        assert port == jax


def test_every_file_has_kill_points():
    """The collection above found each file's fast kill points."""
    found = {p.values[0] for p in kill_points()}
    assert found == set(FILES)
    assert len(kill_points()) >= 60
