"""The JAX package's own tests of its shared ``util`` layer, run against
the port.

Every test function of tests/test_fairqueue.py, test_codec.py,
test_podutil.py, test_nodelock.py, test_lockdebug.py and
test_podcache.py runs twice on the same inputs
(tests/torch_sched_parity.py ``run_reference_test``): as written, and
with every name it takes from ``vtpu`` bound to the port's
(``vtpu_torch.util.*``). Each run sets up the module's own fixtures from
its side's view (``client``, ``tracking``) and holds the test's own
assertions; what each run wrote to its apiserver (the node lock's
annotations, the pod patches) is equal after ``vTPU`` -> ``vGPU``. The
tolerance is exact. None is left out.
"""

from __future__ import annotations

import pytest

from tests.torch_sched_parity import replay_cases, run_reference_test

FILES = ("tests.test_fairqueue", "tests.test_codec", "tests.test_podutil",
         "tests.test_nodelock", "tests.test_lockdebug",
         "tests.test_podcache")


@pytest.mark.parametrize("modname,test", replay_cases(FILES, {}))
def test_util_matches_the_reference(modname, test, tmp_path, capsys):
    jax = run_reference_test(modname, test, False, tmp_path / "jax", capsys)
    port = run_reference_test(modname, test, True, tmp_path / "port", capsys)
    assert port == jax


def test_every_util_function_is_replayed():
    """9 + 14 + 5 + 5 + 7 + 10 test functions, none left out."""
    assert len(replay_cases(FILES, {})) == 50
