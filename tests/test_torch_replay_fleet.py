"""The JAX package's own tests of batch admission, preemption, slices,
shards and the trace, run against the port.

Every test function of tests/test_batch_admission.py, test_preempt.py,
test_slice.py, test_shard.py and test_trace.py runs twice on the same
inputs, as tests/test_torch_replay_core.py runs the scheduler's core
(tests/torch_sched_parity.py ``run_reference_test``; the module fixtures,
``tmp_path``, ``capsys`` and the tracer's own reset set up on each side).
Both runs hold the test's own assertions, and what they wrote to their
apiservers is equal after ``vTPU`` -> ``vGPU``. The tolerance is exact.
None is left out.

``PIPELINED`` names the modules whose tests decide again (a preemption,
a gang's re-filter, a shard's) before the asynchronous commit pipeline
has flushed what the last decision queued: such a queued write is written
in one run and dropped in another as the next decision supersedes it, in
either package (more than one record in 25 to 300 runs of the JAX side
alone, as of the port's, for five of their cases; more under the suite's
load). Their runs' final apiserver states are compared instead: every
pod's annotations, binding and deletion, every node's annotations
(``torch_sched_parity.final_state``), one state in every such run.

``RACING`` names the cases whose decisions race threads, so that each
package's own runs end in different states: the bursts (eight filter
threads, or a shard's workers, place the same pods in an order the OS
picks: 6 distinct of 6 runs, or 4 of 6), a gang spanning two shards (3
in 25 under load) and a gang member's commit against the test's deletion
of it (1 in 40 under load). Their two runs
are not compared; both hold every assertion of the test (no card past
its capacity, no host double-booked, every pod placed or refused once,
the reconciled slot placed again).
"""

from __future__ import annotations

import pytest

from tests.torch_sched_parity import replay_cases, run_reference_test

FILES = ("tests.test_batch_admission", "tests.test_preempt",
         "tests.test_slice", "tests.test_shard", "tests.test_trace")

#: modules whose writes race the commit pipeline: final states compared
PIPELINED = {"tests.test_preempt", "tests.test_slice", "tests.test_shard"}

#: decisions that race threads: not compared
RACING = {
    ("tests.test_batch_admission",
     "test_threaded_mixed_shape_burst_never_overcommits"),
    ("tests.test_shard", "test_disjoint_shard_stress_no_double_booking"),
    ("tests.test_shard", "test_gang_stress_across_shards_no_double_host"),
    ("tests.test_shard", "test_overlapping_and_disjoint_stress"),
    # a gang's members placed by two shards' workers (3 states in 25 under
    # load)
    ("tests.test_shard",
     "test_gang_spanning_shards_completes_under_lockdebug"),
    # p2's queued commit races the test's deletion of p2: the reconcile
    # frees its slot only where it was written (1 state in 40 under load)
    ("tests.test_slice", "test_sync_pods_reconciles_dead_gang_members"),
}


@pytest.mark.parametrize("modname,test", replay_cases(FILES, {}))
def test_fleet_matches_the_reference(modname, test, tmp_path, capsys):
    jax = run_reference_test(modname, test, False, tmp_path / "jax", capsys)
    port = run_reference_test(modname, test, True, tmp_path / "port", capsys)
    if (modname, test) in RACING:
        return
    if modname in PIPELINED:
        assert port.final == jax.final
    else:
        assert port == jax


def test_every_fleet_function_is_replayed():
    """10 + 20 + 23 + 12 + 26 test functions, none left out; each racing
    case is one of them."""
    cases = {tuple(p.values) for p in replay_cases(FILES, {})}
    assert len(cases) == 91
    assert RACING <= cases and PIPELINED <= set(FILES)
