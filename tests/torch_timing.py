"""Locks between the port's tests whose children are timed and the tests
that keep the host's cores busy.

Three kinds of window share the test workers' temp dir (``pytest -n``):

- ``timed()``: a test's children are timed against wall-clock bounds
  (tests/test_torch_throttle.py, the charge tests of
  tests/test_torch_faults.py, the native plane's overhead bench);
- ``exclusive()``: busy processes are pinned to one core (F9's window in
  tests/test_torch_faults.py) or a harness keeps every core busy (the
  native plane's builds and threaded harnesses);
- ``heavy()``: a test of a file in :data:`HEAVY_FILES` runs.

A timed window runs beside no other kind, nor beside another timed window;
exclusive windows run beside neither timed nor exclusive ones; heavy
tests run beside each other and beside exclusive windows, as before this
lock knew them. Two flock files carry that:

- ``PINNED``: exclusive windows take it exclusively, timed ones shared;
- ``HEAVY``: timed windows take it exclusively, heavy tests shared. A
  timed window waiting for it holds ``TURN``, which every heavy test
  passes through first, so the heavy tests of five other workers cannot
  keep one waiting for ever: it waits at most for those already running.

Both orders are fixed (``PINNED`` before ``TURN`` before ``HEAVY``), and no
heavy file takes another window, so no two workers wait on each other.

Why: a throttle test's children burn 1 ms kernels on the mock driver for
1.5 s and are held to launch counts, rates and busy time against each
other. Beside the suite's heavy files (flax and PyTorch models whose
thread pools fill several cores, the bench harness, gloo ranks) the
host's eight cores read 93-99% busy and the children got uneven shares of
them: a 50% tenant time-sliced by a neighbour ran 0.63x its count alone
(bound 0.85), an unlimited graph 0.609x (bound 0.4-0.6). F9's pinned
window held this lock before: a 1 ms execute of the JAX shim that woke on
the pinned core was charged 1.25-1.27x (bound 1.25).

The heavy files cannot take the lock themselves (the JAX package's test
files stay as they are), so this module is also a pytest plugin: every
test module that holds a timed window names it in ``pytest_plugins``, and
every test worker collects those modules, so each worker wraps each test
of a heavy file in ``heavy()``. It holds no assert for pytest to rewrite,
and its test modules import it before pytest loads it as a plugin:
PYTEST_DONT_REWRITE.
"""

from __future__ import annotations

import contextlib
import fcntl
import os
import tempfile

import pytest

PINNED = os.path.join(tempfile.gettempdir(), "vgpu-test-pinned-core.lock")
HEAVY = os.path.join(tempfile.gettempdir(), "vgpu-test-heavy.lock")
TURN = os.path.join(tempfile.gettempdir(), "vgpu-test-heavy-turn.lock")

#: the test files that keep more of the host than one core busy: 1.4-2.2
#: cores on average over their tests (their worker's threads and the
#: children it waited for, per second of wall time) under ``pytest -n 6
#: --dist loadfile`` on an 8-core host, or run alone (test_models.py, which the
#: suite's load held to 0.68). The next, test_zero_cooperation.py, used
#: 1.11 alone and 0.30 in the suite.
HEAVY_FILES = frozenset({
    "test_models.py",
    "test_torch_bench.py",
    "test_torch_dist.py",
    "test_torch_models.py",
    "test_torch_serving.py",
    "test_torch_slice.py",
    "test_torch_train.py",
    "test_torch_zoo.py",
})


@contextlib.contextmanager
def _locked(path: str, mode: int):
    """``path`` flocked in ``mode`` (closing the file releases it)"""
    with open(path, "a") as f:
        fcntl.flock(f, mode)
        yield


@contextlib.contextmanager
def _heavy_lock(mode: int):
    """``HEAVY`` in ``mode``, reached through ``TURN``"""
    with open(TURN, "a") as turn, open(HEAVY, "a") as f:
        fcntl.flock(turn, fcntl.LOCK_EX)
        fcntl.flock(f, mode)
        fcntl.flock(turn, fcntl.LOCK_UN)
        yield


def exclusive():
    """held while busy processes are pinned to a core, or while a test keeps
    every core busy"""
    return _locked(PINNED, fcntl.LOCK_EX)


@contextlib.contextmanager
def timed():
    """held while a test's children are timed"""
    with _locked(PINNED, fcntl.LOCK_SH), _heavy_lock(fcntl.LOCK_EX):
        yield


def heavy():
    """held while a test of a heavy file runs"""
    return _heavy_lock(fcntl.LOCK_SH)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_protocol(item, nextitem):
    """each test of a heavy file, its fixtures' set-up and tear-down
    included, inside ``heavy()``"""
    if item.path.name not in HEAVY_FILES:
        return (yield)
    with heavy():
        return (yield)
