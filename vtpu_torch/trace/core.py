"""Span/Tracer core: Dapper-style per-pod traces (the port's copy of
vtpu/trace/core.py).

Every placement becomes a reconstructable artifact instead of a scatter
of log lines (Sigelman et al., 2010 — the shape, not the scale): the
admission webhook stamps a trace id onto the pod as an annotation
(api.TRACE_ID_ANNO), and because that id is a pure function of the
pod UID (:func:`trace_id_for_uid`), the scheduler, device plugin,
monitor, and workload shim re-derive the SAME id from the UID alone —
spans emitted in four different processes stitch into one trace with no
context propagation protocol beyond the annotation bus the stack
already speaks.

Design constraints:

- **Context-manager only.** Spans are created exclusively via
  ``with tracer.span(trace_id, stage): ...`` — there is no public
  start()/finish() pair to leak. Queue-wait spans (an interval that ended before any
  code could wrap it) backdate via the ``started_at=`` perf_counter
  stamp with an empty body.
- **Monotonic clocks.** Durations come from ``time.perf_counter``;
  ``time.time`` appears only as a display timestamp.
- **Bounded.** Finished spans land in a per-process ring buffer keyed
  by trace id (``VTPU_TRACE_RING`` traces x ``VTPU_TRACE_SPANS`` spans,
  oldest trace evicted); the optional newline-JSON journal
  (``VTPU_TRACE_JOURNAL=path``, off by default) rotates at
  ``VTPU_TRACE_JOURNAL_MAX_KB``.
- **Always-on cheap.** A span is two perf_counter reads, one dict, one
  ring append; the sched-bench smoke test gates the filter-throughput
  overhead at <=3% (tests/test_sched_bench.py).

Zero hard dependencies: prometheus is optional (vtpu_torch/trace/metrics.py),
everything else is stdlib + vtpu_torch/util/env.
"""

from __future__ import annotations

import hashlib
import itertools
import json
import logging
import os
import sys
import threading
import time
import uuid
from collections import OrderedDict
from typing import Any, Dict, List, Optional

from .. import api
from ..util.env import env_int, env_str
from . import metrics as tmetrics
from .decision import DecisionTrace

log = logging.getLogger("vtpu_torch.trace")

#: span attr that indexes the trace under "namespace/name" for the
#: /trace/{ns}/{name} endpoint
POD_KEY_ATTR = "pod"

_span_ids = itertools.count(1)


def trace_id_for_uid(uid: str) -> str:
    """Deterministic 16-hex trace id from a pod UID — the cross-process
    stitch key. Empty uid (objects that never hit the apiserver) gets a
    random id so spans still group, they just can't stitch."""
    if not uid:
        return uuid.uuid4().hex[:16]
    return hashlib.blake2s(uid.encode(), digest_size=8).hexdigest()


def trace_id_of_pod(pod: Dict[str, Any]) -> str:
    """The pod's trace id: the webhook-stamped annotation when present,
    else re-derived from the UID (identical by construction)."""
    meta = pod.get("metadata", {}) or {}
    annos = meta.get("annotations", {}) or {}
    tid = annos.get(api.TRACE_ID_ANNO)
    return tid if tid else trace_id_for_uid(meta.get("uid", ""))


class Span:
    """One timed stage of a pod's scheduling lifecycle. Construct ONLY
    through ``tracer.span(...)``; use as a context
    manager; annotate via :meth:`set`."""

    __slots__ = ("trace_id", "stage", "span_id", "parent_id", "process",
                 "wall_ts", "duration_s", "attrs", "status", "error",
                 "_start", "_tracer")

    def __init__(self, tracer: "Tracer", trace_id: str, stage: str,
                 attrs: Dict[str, Any],
                 started_at: Optional[float] = None) -> None:
        self.trace_id = trace_id
        self.stage = stage
        self.span_id = f"{next(_span_ids):x}"
        self.parent_id: Optional[str] = None
        self.process = tracer.process
        self.wall_ts = time.time()
        self.duration_s = 0.0
        self.attrs = attrs
        self.status = "ok"
        self.error: Optional[str] = None
        self._start = time.perf_counter() if started_at is None \
            else started_at
        self._tracer = tracer

    def set(self, key: str, value: Any) -> None:
        self.attrs[key] = value

    def __enter__(self) -> "Span":
        stack = self._tracer._stack()
        if stack:
            self.parent_id = stack[-1].span_id
        stack.append(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.duration_s = time.perf_counter() - self._start
        if exc_type is not None:
            self.status = "error"
            self.error = f"{exc_type.__name__}: {exc}"
        stack = self._tracer._stack()
        if stack and stack[-1] is self:
            stack.pop()
        self._tracer._finish(self)
        return False  # never suppress

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "stage": self.stage,
            "process": self.process,
            "ts": self.wall_ts,
            "duration_ms": round(self.duration_s * 1e3, 4),
            "status": self.status,
        }
        if self.parent_id:
            out["parent_id"] = self.parent_id
        if self.error:
            out["error"] = self.error
        if self.attrs:
            out["attrs"] = dict(self.attrs)
        return out


class _NoopSpan:
    """Returned when tracing is disabled (and by ``current()`` with no
    active span) so call sites never need None guards."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False

    def set(self, key: str, value: Any) -> None:
        pass


NOOP_SPAN = _NoopSpan()


class TraceJournal:
    """Size-capped newline-JSON event journal shared (by path) across
    the scheduler, device plugin, and monitor daemons. One json line per
    finished span / recorded decision; when the file would exceed
    ``max_bytes`` it rotates once to ``<path>.1`` (concurrent daemons
    racing the rotation at worst rotate twice — append-only lines stay
    intact either way)."""

    def __init__(self, path: str, max_bytes: int) -> None:
        self.path = path
        self.max_bytes = max(4096, max_bytes)
        self._lock = threading.Lock()

    def write(self, record: Dict[str, Any]) -> None:
        line = json.dumps(record, separators=(",", ":"),
                          default=str) + "\n"
        data = line.encode()
        with self._lock:
            try:
                f = open(self.path, "ab")
                try:
                    # size read from the file itself, never from
                    # per-process bookkeeping: peer daemons append to
                    # the same journal, and a stale local count would
                    # both overshoot the cap and — after a peer's
                    # rotation — clobber the freshly rotated .1 with a
                    # near-empty file
                    if f.tell() + len(data) > self.max_bytes:
                        f.close()
                        os.replace(self.path, self.path + ".1")
                        f = open(self.path, "ab")
                    f.write(data)
                finally:
                    f.close()
            except OSError as e:
                # telemetry must never take a daemon down; complain once
                # per process would be ideal, debug-level keeps it quiet
                log.debug("trace journal write to %s failed: %s",
                          self.path, e)


class TraceStore:
    """Bounded per-process ring of traces: trace id -> spans + the
    decision record, plus a pod-key index for /trace/{ns}/{name}.
    Evicting the oldest trace drops its index entry too, so an evicted
    pod 404s instead of serving a dangling id."""

    def __init__(self, max_traces: int, max_spans: int) -> None:
        self.max_traces = max(1, max_traces)
        self.max_spans = max(1, max_spans)
        self._lock = threading.Lock()
        self._traces: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
        self._keys: Dict[str, str] = {}  # "ns/name" -> trace id

    def _entry_locked(self, trace_id: str) -> Dict[str, Any]:
        entry = self._traces.get(trace_id)
        if entry is None:
            entry = {"spans": [], "decision": None, "key": None,
                     "dropped": 0}
            self._traces[trace_id] = entry
            while len(self._traces) > self.max_traces:
                old_id, old = self._traces.popitem(last=False)
                if old["key"] and self._keys.get(old["key"]) == old_id:
                    del self._keys[old["key"]]
        else:
            self._traces.move_to_end(trace_id)
        return entry

    def add_span(self, span: Span) -> None:
        key = span.attrs.get(POD_KEY_ATTR)
        with self._lock:
            entry = self._entry_locked(span.trace_id)
            if len(entry["spans"]) < self.max_spans:
                entry["spans"].append(span)
            else:
                entry["dropped"] += 1
            if key:
                entry["key"] = key
                self._keys[key] = span.trace_id

    def set_decision(self, trace_id: str, decision: DecisionTrace) -> None:
        with self._lock:
            entry = self._entry_locked(trace_id)
            entry["decision"] = decision
            key = f"{decision.namespace}/{decision.name}"
            entry["key"] = key
            self._keys[key] = trace_id

    def trace_id_for_key(self, key: str) -> Optional[str]:
        with self._lock:
            return self._keys.get(key)

    def render(self, trace_id: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            entry = self._traces.get(trace_id)
            if entry is None:
                return None
            spans = list(entry["spans"])
            decision = entry["decision"]
            dropped = entry["dropped"]
            key = entry["key"]
        spans.sort(key=lambda s: s.wall_ts)
        out: Dict[str, Any] = {
            "trace_id": trace_id,
            "pod": key,
            "spans": [s.to_dict() for s in spans],
        }
        if decision is not None:
            out["decision"] = decision.to_dict()
        if dropped:
            out["spans_dropped"] = dropped
        return out

    def recent(self, limit: int) -> List[Dict[str, Any]]:
        """Newest-first trace summaries for /debug/traces."""
        with self._lock:
            items = list(self._traces.items())[-limit:]
            summaries = []
            for tid, entry in reversed(items):
                spans = entry["spans"]
                summaries.append({
                    "trace_id": tid,
                    "pod": entry["key"],
                    "spans": len(spans) + entry["dropped"],
                    "stages": sorted({s.stage for s in spans}),
                    "errors": sum(1 for s in spans
                                  if s.status == "error"),
                    "duration_ms": round(
                        sum(s.duration_s for s in spans) * 1e3, 3),
                    "decision": entry["decision"] is not None,
                })
        return summaries

    def clear(self) -> None:
        with self._lock:
            self._traces.clear()
            self._keys.clear()


class Tracer:
    """Per-process tracer: thread-safe, ring-buffered, optionally
    journaled. One module-level instance (``vtpu_torch.trace.tracer``) serves
    the whole process so in-process stages share a store."""

    def __init__(self) -> None:
        self.process = os.path.basename(sys.argv[0] or "py") or "py"
        self.enabled = True
        self._local = threading.local()
        self.store = TraceStore(
            env_int(api.ENV_TRACE_RING, 512, minimum=1),
            env_int(api.ENV_TRACE_SPANS, 64, minimum=1))
        self.journal: Optional[TraceJournal] = None
        path = env_str(api.ENV_TRACE_JOURNAL)
        if path:
            self.journal = TraceJournal(
                path,
                env_int(api.ENV_TRACE_JOURNAL_MAX_KB, 65536,
                        minimum=1) * 1024)

    # -- configuration -----------------------------------------------------

    def configure(self, process: Optional[str] = None,
                  max_traces: Optional[int] = None,
                  max_spans: Optional[int] = None,
                  journal_path: Optional[str] = None,
                  journal_max_kb: Optional[int] = None) -> "Tracer":
        """Rewire the process-global tracer (daemon mains, tests).
        ``journal_path=""`` detaches the journal."""
        if process is not None:
            self.process = process
        if max_traces is not None or max_spans is not None:
            self.store = TraceStore(
                max_traces if max_traces is not None
                else self.store.max_traces,
                max_spans if max_spans is not None
                else self.store.max_spans)
        if journal_path is not None:
            if journal_path:
                self.journal = TraceJournal(
                    journal_path, (journal_max_kb or 65536) * 1024)
            else:
                self.journal = None
        return self

    def set_enabled(self, enabled: bool) -> None:
        """Kill switch for A/B overhead measurement (sched_bench); in
        production tracing is always-on."""
        self.enabled = enabled

    # -- span API ----------------------------------------------------------

    def _stack(self) -> List[Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def span(self, trace_id: str, stage: str,
             started_at: Optional[float] = None, **attrs: Any):
        """The only way to create a span. ``started_at`` (a
        time.perf_counter stamp) backdates the start for queue-wait
        intervals that ended before the wrapping code ran."""
        if not self.enabled:
            return NOOP_SPAN
        return Span(self, trace_id, stage, attrs, started_at=started_at)

    def current(self):
        """The innermost active span on this thread (NOOP when none) —
        lets deep code annotate without threading span handles."""
        stack = getattr(self._local, "stack", None)
        return stack[-1] if stack else NOOP_SPAN

    def current_trace_id(self) -> Optional[str]:
        stack = getattr(self._local, "stack", None)
        return stack[-1].trace_id if stack else None

    def _finish(self, span: Span) -> None:
        self.store.add_span(span)
        tmetrics.observe(span.stage, span.duration_s)
        if self.journal is not None:
            self.journal.write({"type": "span", **span.to_dict()})

    # -- decisions ---------------------------------------------------------

    def decision(self, decision: DecisionTrace) -> None:
        if not self.enabled:
            return
        self.store.set_decision(decision.trace_id, decision)
        if self.journal is not None:
            self.journal.write({"type": "decision", **decision.to_dict()})

    # -- query surface (the scheduler's /trace routes) -----------------------

    def trace_for_key(self, key: str) -> Optional[Dict[str, Any]]:
        tid = self.store.trace_id_for_key(key)
        return self.store.render(tid) if tid else None

    def trace_id_for_key(self, key: str) -> Optional[str]:
        return self.store.trace_id_for_key(key)

    def render_trace(self, trace_id: str) -> Optional[Dict[str, Any]]:
        return self.store.render(trace_id)

    def recent(self, limit: int = 20) -> List[Dict[str, Any]]:
        return self.store.recent(limit)

    def reset(self) -> None:
        """Tests: drop every stored trace."""
        self.store.clear()


#: the process-global tracer every component shares
tracer = Tracer()
