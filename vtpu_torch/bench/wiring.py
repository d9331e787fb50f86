"""The children's env: the same workload native and through ``libvgpu.so``
with a quota (bench.py:324-384, :501-523).

The shim child is wired as the device plugin's ``Allocate`` wires a
container (``chip_smoke.child_env``): ``LD_PRELOAD`` of the built
interposer, a fresh region file ``<run dir>/containers/<pod>_0/vgpu.cache``,
``CUDA_DEVICE_MEMORY_LIMIT`` from ``VTPU_BENCH_QUOTA`` (default 12g),
priority 1, log level 1 and a lock directory of the run's own. The native
child's env is the same without the preload and the quota. The mock
backend puts the mock ``libcuda.so.1`` on the library path.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import tempfile

from .. import api, native
from ..enforce.workload import parse_bytes
from . import REPO

SHIM_QUOTA_DEFAULT = "12g"


def backend() -> str:
    """``mock`` or ``cuda`` (the default)."""
    return os.environ.get(api.ENV_BENCH_BACKEND) or "cuda"


def child_cmd(*args: str) -> list:
    return [sys.executable, "-m", "vtpu_torch.bench", *args]


def _child_env(run_dir: str, pod: str, shim: bool, profile: bool) -> dict:
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("CUDA_DEVICE_", "CUDA_DISABLE_CONTROL"))
           and k != "LD_PRELOAD"}
    cache = os.path.join(run_dir, "containers", f"{pod}_0",
                         api.CACHE_FILENAME)
    os.makedirs(os.path.dirname(cache), exist_ok=True)
    locks = os.path.join(run_dir, "locks")
    os.makedirs(locks, exist_ok=True)
    env.update({
        api.ENV_BENCH_CHILD: "1",
        "PYTHONPATH": REPO,
        api.ENV_SHARED_CACHE: cache,
        api.ENV_TASK_PRIORITY: "1",
        api.ENV_LOG_LEVEL: "1",
        api.ENV_LOCK_DIR: locks,
    })
    if profile:
        # the callsite profile, every call timed so short runs' histograms
        # are exact (VTPU_PROFILE_SAMPLE overrides)
        env[api.ENV_PROFILE] = "1"
        env.setdefault(api.ENV_PROFILE_SAMPLE, "1")
    if shim:
        env["LD_PRELOAD"] = native.interposer()
        env[api.ENV_DEVICE_MEMORY_LIMIT] = str(parse_bytes(
            os.environ.get(api.ENV_BENCH_QUOTA, SHIM_QUOTA_DEFAULT)))
    if backend() == "mock":
        env["LD_LIBRARY_PATH"] = os.pathsep.join(
            [native.mock_cuda_dir()]
            + [p for p in os.environ.get("LD_LIBRARY_PATH", "").split(
                os.pathsep) if p])
    return env


def _shim_env(run_dir: str, pod: str = "bench", profile: bool = False
              ) -> dict:
    """A child under libvgpu.so with a quota and its own region file
    (``api.ENV_SHARED_CACHE``) under ``run_dir``."""
    return _child_env(run_dir, pod, shim=True, profile=profile)


def _native_env(run_dir: str, pod: str = "bench-native") -> dict:
    """The native half: ``_shim_env`` without the preload and the quota."""
    return _child_env(run_dir, pod, shim=False, profile=False)


def reexec_with_shim(argv) -> int:
    """``argv`` (``sys.argv``) again, less ``--shim``, in a child under
    libvgpu.so; its return code."""
    run_dir = tempfile.mkdtemp(prefix="vgpu-bench-")
    try:
        child_args = [a for a in argv[1:] if a != "--shim"]
        return subprocess.run(child_cmd(*child_args),
                              env=_shim_env(run_dir)).returncode
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
