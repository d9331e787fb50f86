"""The JAX package's own tests of the device vendor, the mesh solver and
the workload side's enforcement, run against the port.

Every test function of tests/test_device.py, test_mesh.py and
test_enforce.py runs twice (tests/torch_sched_parity.py
``run_reference_test``). The vendor's and the workload's tests are
``AS_WRITTEN`` there: their JAX run is the test exactly as written (the
TPU vendor, ``google.com/tpu``, ``TPU_DEVICE_*`` env), and their port
run reads each TPU name as the GPU's counterpart: ``TPUDevices`` as
``GPUDevices``, the vendor tag ``"TPU"`` as ``"NVIDIA"``,
``use-tputype``/``ici-bind`` as ``nvidia.com/use-gputype``/``numa-bind``,
``ENV_TENSORCORE_LIMIT`` as ``CUDA_DEVICE_SM_LIMIT``. The mesh solver's
tests run on the port's own copy (``vtpu_torch.parallel.mesh``). Both
runs hold the test's own assertions, exactly.

Left out, with its F-number (ROADMAP Queue 3) and the port test that
holds the port's own value:
- F18: ``test_install_rewires_tpu_library_path``. The JAX ``install()``
  points ``TPU_LIBRARY_PATH`` at its shim, for PJRT loads its plugin
  from that path. ``libvgpu.so`` is preloaded before the process starts
  (``Allocate``'s ``/etc/ld.so.preload`` mount); ``install()`` cannot
  inject it and leaves the env as it found it
  (``test_f18_install_leaves_the_env_to_the_preload``).
"""

from __future__ import annotations

import pytest

from tests.torch_sched_parity import replay_cases, run_reference_test

FILES = ("tests.test_device", "tests.test_mesh", "tests.test_enforce")

#: test functions left out, each a deliberate difference (docstring)
LEFT_OUT = {
    "tests.test_enforce": {
        "test_install_rewires_tpu_library_path":
            "F18: no library path to rewire; libvgpu.so is preloaded",
    },
}


@pytest.mark.parametrize("modname,test", replay_cases(FILES, LEFT_OUT))
def test_device_matches_the_reference(modname, test, tmp_path, capsys):
    jax = run_reference_test(modname, test, False, tmp_path / "jax", capsys)
    port = run_reference_test(modname, test, True, tmp_path / "port", capsys)
    assert port == jax


def test_every_device_function_is_replayed_or_left_out_with_a_reason():
    """12 + 19 + 16 test functions; the one left out names its F-number."""
    assert len(replay_cases(FILES, LEFT_OUT)) == 46
    assert len(replay_cases(FILES, {})) == 47
    assert all(r.startswith("F18:") for m in LEFT_OUT.values()
               for r in m.values())


def test_f18_install_leaves_the_env_to_the_preload(tmp_path):
    """F18 on the same inputs: the JAX install() rewires the library
    path to its shim; the port's attaches the region and leaves every
    variable as it was."""
    from vtpu import api as jax_api
    from vtpu.enforce.workload import install as jax_install
    from vtpu_torch import api
    from vtpu_torch.enforce.workload import install

    shim = tmp_path / "libvgpu.so"
    shim.write_bytes(b"")
    jax_env = {jax_api.ENV_DEVICE_MEMORY_LIMIT: "1m",
               jax_api.ENV_SHARED_CACHE: str(tmp_path / "vtpu.cache"),
               "TPU_LIBRARY_PATH": "/lib/libtpu.so",
               "VTPU_SHIM_PATH": str(shim)}
    enf = jax_install(env=jax_env)
    try:
        assert jax_env["TPU_LIBRARY_PATH"] == str(shim)
        assert jax_env[jax_api.ENV_REAL_LIBTPU] == "/lib/libtpu.so"
    finally:
        enf.stop()

    env = {api.ENV_DEVICE_MEMORY_LIMIT: "1m",
           api.ENV_SHARED_CACHE: str(tmp_path / "vgpu.cache"),
           "TPU_LIBRARY_PATH": "/lib/libtpu.so",
           "VTPU_SHIM_PATH": str(shim)}
    before = dict(env)
    enf = install(env=env)
    try:
        assert enf.region is not None
        assert enf.limit() == 1 << 20
        assert env == before
    finally:
        enf.stop()
