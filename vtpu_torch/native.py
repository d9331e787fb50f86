"""Builds the port's native libraries with gcc at first use.

The counterpart of ``lib/vtpu/Makefile``'s ``libvtpucore.so`` and
``libvtpu.so`` targets, without make: each library is compiled from
``vtpu_torch/csrc/`` into ``vtpu_torch/_build/`` (not committed) when it is
missing or older than one of its sources, and a failed build raises.

- ``libvgpucore.so``: the shared-region ABI (``shared_region.c``), loaded by
  :mod:`vtpu_torch.enforce.region` through ctypes.
- ``libvgpu.so``: the CUDA driver-API interposer (``libvgpu.c``), loaded
  with ``LD_PRELOAD`` into a quota-limited process.
- ``libcuda.so.1`` under ``_build/mock_cuda/``: a stand-in driver
  (``mock_cuda.c``) for tests on machines without a GPU; put the directory
  on ``LD_LIBRARY_PATH``.
- ``libnvidia-ml.so.1`` under ``_build/mock_nvml/``: a stand-in NVML
  (``mock_nvml.c``) serving a JSON fixture of cards (``MOCK_NVML_FIXTURE``).
- ``vgpu-validator``: the entitlement validator (``validator.c``), an
  executable the device plugin installs beside ``libvgpu.so`` and mounts
  into a container when the host carries a license.
- ``test/region_test``, ``test/region_stress``, ``test/interposer_test``:
  the native test plane (``csrc/test/``), programs that drive the shared
  region and ``libvgpu.so`` on the mock driver from many threads.

:func:`cuda_fixtures` builds the code-memory probe's CUDA module
(``codemem_fixture.cu``) with nvcc for sm_90a, as a cubin, a fatbin and
PTX, under ``_build/codemem/``: only on a machine with the CUDA toolkit,
never in :func:`build_all`.

:func:`sanitized` builds the same set again (all but the validator) under
``_build/san/`` with ASan+UBSan or ``_build/tsan/`` with ThreadSanitizer,
``lib/vtpu/Makefile``'s ``sanitize`` and ``tsan`` rule: a set never shadows
``_build/``, and its harnesses load its own ``libvgpu.so`` and mock driver.

:func:`preload_file` also writes ``_build/ld.so.preload``, the file the
device plugin installs on the host and mounts over a container's
``/etc/ld.so.preload``: one line naming the interposer's in-container path.

Builds take a file lock per output, so concurrent processes (test workers)
build each library once, and each output is renamed into place whole; a
set's outputs build at once, one gcc each.
"""

from __future__ import annotations

import fcntl
import os
import shutil
import subprocess
from concurrent import futures
from typing import Dict, List, Tuple

from . import api
from .util.env import env_str

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")

CFLAGS = ["-O2", "-g", "-Wall", "-Wextra", "-fPIC", "-pthread"]
# the sanitized sets: variant -> its compiler flags
SANITIZERS: Dict[str, List[str]] = {
    "san": ["-O1", "-g", "-Wall", "-Wextra", "-fPIC", "-pthread",
            "-fsanitize=address,undefined", "-fno-sanitize-recover=all",
            "-fno-omit-frame-pointer"],
    "tsan": ["-O1", "-g", "-Wall", "-fPIC", "-pthread", "-fsanitize=thread"],
}
# bind intra-library calls locally: the interposer defines dlsym and the
# cu* entry points, and must never reach its own exports through the PLT
SOFLAGS = ["-shared", "-Wl,-Bsymbolic-functions"]

_REGION = ["shared_region.c", "shared_region.h", "prof_hook.h"]

# output (relative to BUILD) -> (sources compiled, headers depended on,
# extra link flags)
TARGETS: Dict[str, Tuple[List[str], List[str], List[str]]] = {
    "libvgpucore.so": (["shared_region.c"], _REGION[1:], []),
    "libvgpu.so": (["libvgpu.c", "shared_region.c"],
                   _REGION[1:] + ["cuda_min.h"], ["-ldl", "-lm"]),
    os.path.join("mock_cuda", "libcuda.so.1"): (
        ["mock_cuda.c"], ["cuda_min.h"], ["-Wl,-soname,libcuda.so.1"]),
    os.path.join("mock_nvml", "libnvidia-ml.so.1"): (
        ["mock_nvml.c"], [], ["-Wl,-soname,libnvidia-ml.so.1"]),
    "vgpu-validator": (["validator.c"], [], []),
    os.path.join("test", "region_test"): (
        [os.path.join("test", "region_test.c"), "shared_region.c"],
        _REGION[1:], []),
    os.path.join("test", "region_stress"): (
        [os.path.join("test", "region_stress.c"), "shared_region.c"],
        _REGION[1:], []),
    os.path.join("test", "interposer_test"): (
        [os.path.join("test", "interposer_test.c"), "shared_region.c"],
        _REGION[1:] + ["cuda_min.h"], ["-ldl"]),
}
#: targets linked as programs, not shared libraries
EXECUTABLES = {"vgpu-validator", os.path.join("test", "region_test"),
               os.path.join("test", "region_stress"),
               os.path.join("test", "interposer_test")}


class NativeBuildFailure(RuntimeError):
    """gcc is missing or refused a source."""


def _stale(out: str, deps: List[str]) -> bool:
    if not os.path.exists(out):
        return True
    built = os.path.getmtime(out)
    return any(os.path.getmtime(os.path.join(CSRC, d)) > built for d in deps)


def _compile(out: str, deps: List[str], command) -> str:
    """``out`` built by ``command(tmp)`` (an argv writing the file tmp) when
    it is missing or older than one of ``deps`` (under CSRC), under a file
    lock, renamed into place whole; a failed build raises."""
    if not _stale(out, deps):
        return out
    os.makedirs(os.path.dirname(out), exist_ok=True)
    lock_path = os.path.join(os.path.dirname(out),
                             f".{os.path.basename(out)}.lock")
    with open(lock_path, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not _stale(out, deps):
            return out  # another process built it while we waited
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = command(tmp)
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise NativeBuildFailure(
                f"building {os.path.relpath(out, BUILD)} failed "
                f"({' '.join(cmd)}):\n{proc.stderr}")
        os.replace(tmp, out)
    return out


def build(target: str, variant: str = "") -> str:
    """Path of the built library or program ``target`` (a key of
    :data:`TARGETS`), compiling it first when it is missing or stale; with a
    ``variant`` of :data:`SANITIZERS`, its sanitized build under
    ``_build/<variant>/``."""
    sources, headers, ldflags = TARGETS[target]
    out = os.path.join(BUILD, variant, target)
    if not _stale(out, sources + headers):
        return out
    cc = env_str("CC", "gcc")
    if shutil.which(cc) is None:
        raise NativeBuildFailure(f"{cc} not found; cannot build {target}")
    link = [] if target in EXECUTABLES else SOFLAGS
    flags = SANITIZERS[variant] if variant else CFLAGS
    return _compile(out, sources + headers, lambda tmp: (
        [cc] + flags + link + ["-o", tmp]
        + [os.path.join(CSRC, s) for s in sources] + ldflags))


#: the code-memory probe's fixture (vtpu_torch/bench/codemem.py): a module
#: whose __device__ globals hold PARTS x PART_MIB MiB and one kernel that
#: writes them; output -> (nvcc's flags, parts, MiB a part)
FIXTURE = "codemem_fixture.cu"
FIXTURES: Dict[str, Tuple[List[str], int, int]] = {
    "codemem.cubin": (["-cubin", "-arch=sm_90a"], 1, 256),
    "codemem.fatbin": (["-fatbin", "-gencode=arch=compute_90a,code=sm_90a"],
                       1, 256),
    "codemem.ptx": (["-ptx", "-arch=compute_90a"], 1, 256),
    "codemem_3g.cubin": (["-cubin", "-arch=sm_90a"], 3, 1024),
}


def nvcc() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else the toolkit's
    ``/usr/local/cuda/bin/nvcc``; raises where there is none."""
    for cand in (shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"):
        if cand and os.access(cand, os.X_OK):
            return cand
    raise NativeBuildFailure("nvcc not found; the code-memory fixture "
                             "builds only where the CUDA toolkit is")


def cuda_fixtures() -> Dict[str, str]:
    """The fixture's outputs (:data:`FIXTURES`) built with nvcc for sm_90a
    under ``_build/codemem/`` at first use, one nvcc each, all at once;
    output -> path. Not part of :func:`build_all`, which runs on hosts
    without the CUDA toolkit."""
    compiler = nvcc()
    src = os.path.join(CSRC, FIXTURE)

    def one(name: str) -> str:
        flags, parts, mib = FIXTURES[name]
        return _compile(os.path.join(BUILD, "codemem", name), [FIXTURE],
                        lambda tmp: [compiler] + flags + [
                            f"-DCODEMEM_PARTS={parts}",
                            f"-DCODEMEM_PART_MIB={mib}", "-o", tmp, src])

    with futures.ThreadPoolExecutor(len(FIXTURES)) as pool:
        done = {name: pool.submit(one, name) for name in FIXTURES}
        return {name: f.result() for name, f in done.items()}


def core_library() -> str:
    """``libvgpucore.so``, the shared-region library."""
    return build("libvgpucore.so")


def interposer() -> str:
    """``libvgpu.so``, the LD_PRELOAD interposer."""
    return build("libvgpu.so")


def mock_cuda_dir() -> str:
    """Directory holding the mock ``libcuda.so.1``, for LD_LIBRARY_PATH."""
    return os.path.dirname(build(os.path.join("mock_cuda", "libcuda.so.1")))


def mock_nvml_library() -> str:
    """The mock ``libnvidia-ml.so.1``."""
    return build(os.path.join("mock_nvml", "libnvidia-ml.so.1"))


def validator() -> str:
    """``vgpu-validator``, the entitlement validator program."""
    return build("vgpu-validator")


def preload_file() -> str:
    """``_build/ld.so.preload``: the interposer's in-container path, the
    content of the file mounted over a container's /etc/ld.so.preload."""
    out = os.path.join(BUILD, "ld.so.preload")
    want = api.CONTAINER_SHIM_PATH + "\n"
    try:
        with open(out) as f:
            if f.read() == want:
                return out
    except FileNotFoundError:
        pass
    os.makedirs(BUILD, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        f.write(want)
    os.replace(tmp, out)
    return out


def _build_set(targets: List[str], variant: str = "") -> Dict[str, str]:
    """``targets`` built at once, one gcc each; name -> path"""
    with futures.ThreadPoolExecutor(len(targets)) as pool:
        done = {t: pool.submit(build, t, variant) for t in targets}
        return {t: f.result() for t, f in done.items()}


def build_all() -> Dict[str, str]:
    """Build every library and program; name -> path."""
    return _build_set(list(TARGETS))


def sanitized(variant: str) -> Dict[str, str]:
    """The sanitized set ``variant`` (``san``: ASan+UBSan, ``tsan``:
    ThreadSanitizer) of every library and program but the validator, built
    under ``_build/<variant>/``; name -> path."""
    if variant not in SANITIZERS:
        raise ValueError(f"no sanitized set {variant!r}")
    return _build_set([t for t in TARGETS if t != "vgpu-validator"], variant)
