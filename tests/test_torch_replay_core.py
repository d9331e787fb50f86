"""The JAX package's own tests of the scheduler's core, run against the
port.

Every test function of tests/test_overlay.py, test_host_quota.py,
test_committer.py, test_scheduler.py and test_routes.py runs twice on the
same inputs (tests/torch_sched_parity.py ``run_reference_test``): as
written, against the JAX scheduler with the port's GPUDevices in its
registry, and with every name it takes from ``vtpu`` bound to the port's
(``vtpu_torch.scheduler.*``, ``vtpu_torch.util.*``). Both runs see the
GPU's device plane: the TPU's resource, type-constraint and ``ici-bind``
names read as ``nvidia.com/*`` (``GPU_NAMES``), and a request a test
builds names the GPU's vendor. Each run sets up the module's own fixtures
from its side's view and holds the test's own assertions; on the port's
side a ``vTPU`` in the test's strings reads ``vGPU``. What the runs wrote
to their apiservers (every pod patch, bind, deletion and node
annotation) is equal after ``vTPU`` -> ``vGPU``. The tolerance is exact.
None is left out.
"""

from __future__ import annotations

import pytest

from tests.torch_sched_parity import replay_cases, run_reference_test

FILES = ("tests.test_overlay", "tests.test_host_quota",
         "tests.test_committer", "tests.test_scheduler", "tests.test_routes")


@pytest.mark.parametrize("modname,test", replay_cases(FILES, {}))
def test_core_matches_the_reference(modname, test, tmp_path, capsys):
    jax = run_reference_test(modname, test, False, tmp_path / "jax", capsys)
    port = run_reference_test(modname, test, True, tmp_path / "port", capsys)
    assert port == jax


def test_every_core_function_is_replayed():
    """8 + 19 + 21 + 28 + 10 test functions, none left out."""
    assert len(replay_cases(FILES, {})) == 86
