"""End-to-end traces: the port's copy of vtpu/trace (docs/observability.md).

Public surface:

- ``tracer`` — the process-global :class:`~vtpu_torch.trace.core.Tracer`;
  create spans with ``with tracer.span(trace_id, stage): ...`` (the
  only form).
- :func:`trace_id_for_uid` / :func:`trace_id_of_pod` — the
  cross-process stitch key: webhook stamps it as a pod annotation,
  every other daemon re-derives it from the pod UID.
- :class:`DecisionTrace` / :class:`Rejection` / :class:`ChipReject` —
  the machine-readable scheduling-decision record the extender's
  FailedNodes strings are rendered from.
"""

from .core import (  # noqa: F401
    NOOP_SPAN,
    Span,
    TraceJournal,
    TraceStore,
    Tracer,
    trace_id_for_uid,
    trace_id_of_pod,
    tracer,
)
from .decision import ChipReject, DecisionTrace, Rejection  # noqa: F401
