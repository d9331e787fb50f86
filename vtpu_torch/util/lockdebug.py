"""Opt-in lock-order tracking for the node daemons' lock hierarchy.

The port's copy of vtpu/util/lockdebug.py.

The concurrency PRs grew a real lock hierarchy — decide lock → pod
cache → overlay, decide lock → committer, monitor region table → region
views — whose ordering is enforced only by convention. A convention
violation is a deadlock that fires at 1024 nodes under apiserver
pressure, never in a 5-node test. This module makes the convention
checkable: with ``VTPU_LOCKDEBUG=1`` every lock constructed through
:func:`lock` / :func:`rlock` records, per thread, which lock *classes*
were held when it was acquired, merges those edges into one global
ordering graph, and raises :class:`LockOrderError` the moment any
acquisition would close a cycle — even when the two conflicting
orderings were observed on different threads, minutes apart, and never
actually deadlocked in this run (the lockdep idea; Go's analog is the
race detector the reference leans on, which Python lacks).

Disabled (the default), :func:`lock`/:func:`rlock` return plain
``threading.Lock``/``RLock`` objects — zero steady-state overhead.
Enabled, acquisition adds one dict probe plus a DFS over the (tiny)
class graph. The committer/podcache stress tests run with it on
(tests/test_committer.py, tests/test_podcache.py, tests/test_lockdebug.py).

Ordering is tracked by lock *name* (role), not instance: "scheduler.pods
before scheduler.overlay" is the invariant; which PodManager instance is
irrelevant. Same-name edges are ignored (two instances of one role never
nest in this codebase, and a same-INSTANCE non-reentrant re-acquire is a
plain deadlock no graph is needed for).
"""

from __future__ import annotations

import threading
import traceback
from typing import Dict, List, Optional, Set, Tuple, Union

from ..api import ENV_LOCKDEBUG
from .env import env_bool

ENV_FLAG = ENV_LOCKDEBUG


class LockOrderError(RuntimeError):
    """Two lock classes were (or would be) acquired in both orders."""


# one global ordering graph: name -> names acquired while it was held,
# plus the call site that first observed each edge (for the error text)
_graph_mu = threading.Lock()
_edges: Dict[str, Set[str]] = {}
_edge_sites: Dict[Tuple[str, str], str] = {}
_held = threading.local()  # per-thread stack of held lock names


def enabled() -> bool:
    """Read the env flag. Evaluated at lock construction, not import, so
    tests can monkeypatch the environment per-case."""
    return env_bool(ENV_FLAG, False)


def lock(name: str) -> Union[threading.Lock, "_DebugLock"]:
    """A mutex participating in order tracking when VTPU_LOCKDEBUG=1."""
    if not enabled():
        return threading.Lock()
    return _DebugLock(threading.Lock(), name, reentrant=False)


def rlock(name: str) -> Union[threading.RLock, "_DebugLock"]:
    if not enabled():
        return threading.RLock()
    return _DebugLock(threading.RLock(), name, reentrant=True)


def reset() -> None:
    """Forget every recorded ordering (test isolation)."""
    with _graph_mu:
        _edges.clear()
        _edge_sites.clear()


def edges() -> Dict[str, Set[str]]:
    """Snapshot of the observed ordering graph (diagnostics/tests)."""
    with _graph_mu:
        return {k: set(v) for k, v in _edges.items()}


def _held_stack() -> List[str]:
    stack = getattr(_held, "stack", None)
    if stack is None:
        stack = _held.stack = []
    return stack


def _call_site() -> str:
    # the acquire() frame and the wrapper frames are the last three;
    # report the first caller outside this module
    for frame in reversed(traceback.extract_stack(limit=8)[:-2]):
        if not frame.filename.endswith("lockdebug.py"):
            return f"{frame.filename}:{frame.lineno}"
    return "<unknown>"


def _path_exists(src: str, dst: str) -> bool:
    # DFS over the class graph (a handful of nodes); _graph_mu held
    seen = set()
    stack = [src]
    while stack:
        n = stack.pop()
        if n == dst:
            return True
        if n in seen:
            continue
        seen.add(n)
        stack.extend(_edges.get(n, ()))
    return False


def _note_acquire(name: str) -> None:
    """Record held->name edges; raise if any would close a cycle."""
    stack = _held_stack()
    site = _call_site()
    with _graph_mu:
        for h in stack:
            if h == name or name in _edges.get(h, ()):
                continue
            if _path_exists(name, h):
                first = _edge_sites.get((name, h)) or next(
                    (s for (a, b), s in _edge_sites.items() if a == name),
                    "<unknown>")
                raise LockOrderError(
                    f"lock-order inversion: acquiring '{name}' while "
                    f"holding '{h}' at {site}, but the opposite order "
                    f"'{name}' -> ... -> '{h}' was already observed "
                    f"(first at {first}); one of the two paths can "
                    f"deadlock")
            _edges.setdefault(h, set()).add(name)
            _edge_sites.setdefault((h, name), site)
    stack.append(name)


def _note_release(name: str) -> None:
    stack = _held_stack()
    # release order may differ from acquire order; drop the last match
    for i in range(len(stack) - 1, -1, -1):
        if stack[i] == name:
            del stack[i]
            return


class _DebugLock:
    """Duck-typed Lock/RLock wrapper feeding the ordering graph.

    Compatible with ``threading.Condition(lock)``: Condition only needs
    acquire/release (its RLock fast paths are optional attributes), and
    its wait() releases/reacquires through these methods, so the held
    stack stays exact across waits.
    """

    __slots__ = ("_inner", "name", "_reentrant", "_owner")

    def __init__(self, inner, name: str, reentrant: bool):
        self._inner = inner
        self.name = name
        self._reentrant = reentrant
        self._owner = threading.local()

    def _depth(self) -> int:
        return getattr(self._owner, "depth", 0)

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        reentry = self._reentrant and self._depth() > 0
        if not reentry:
            # check/record BEFORE blocking: a genuine inversion raises
            # instead of deadlocking the stress test that runs under it
            _note_acquire(self.name)
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            self._owner.depth = self._depth() + 1
        if not ok and not reentry:
            _note_release(self.name)
        return ok

    def release(self) -> None:
        depth = self._depth()
        self._inner.release()
        self._owner.depth = max(0, depth - 1)
        if not (self._reentrant and depth > 1):
            _note_release(self.name)

    def locked(self) -> bool:
        # RLock grows .locked() only in 3.13; report held-depth for it
        inner_locked = getattr(self._inner, "locked", None)
        if inner_locked is not None:
            return bool(inner_locked())
        return self._depth() > 0

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<DebugLock {self.name} inner={self._inner!r}>"
