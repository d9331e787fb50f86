"""One lock between the port's tests that pin busy processes to a core and
those whose children are timed.

tests/test_torch_faults.py's F9 test pins three busy processes and a pod to
one core for ~10 s, so that the pod's host is delayed at random for whole
time slices. A timed child of tests/test_torch_throttle.py (another test
worker under ``pytest -n``) that woke on that core waited behind them: a
1 ms execute of the JAX shim was charged 1.25-1.27x (bound 1.25) beside
three such processes. The pinned window takes the lock exclusively, each
throttle test shares it, so the two never overlap. So do the native test
plane's threaded harnesses (tests/test_torch_native_plane.py), which keep
every core busy for seconds, and their builds. The lock file lies in the
temp dir every test worker shares.
"""

from __future__ import annotations

import contextlib
import fcntl
import os
import tempfile

LOCK = os.path.join(tempfile.gettempdir(), "vgpu-test-pinned-core.lock")


@contextlib.contextmanager
def _locked(mode):
    with open(LOCK, "a") as f:
        fcntl.flock(f, mode)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def exclusive():
    """held while busy processes are pinned to a core, or while a test keeps
    many cores busy"""
    return _locked(fcntl.LOCK_EX)


def timed():
    """held while a test's children are timed"""
    return _locked(fcntl.LOCK_SH)
