"""Shared logging setup of the port's node daemons: the port's copy of
vtpu/util/logsetup.py.

``VTPU_LOG_FORMAT`` selects the format:

- ``text`` (default): the classic ``asctime level name: message`` line.
- ``json``: one JSON object per line (``ts``/``level``/``logger``/
  ``msg``, plus ``exc`` for tracebacks). When the logging call happens
  inside an active trace span, the line carries the span's ``trace`` id
  — grep the journal or hit ``/trace/{ns}/{name}`` with it
  (docs/observability.md).
"""

from __future__ import annotations

import json
import logging
import sys
from typing import Optional

from ..api import ENV_LOG_FORMAT
from .env import env_str

TEXT_FORMAT = "%(asctime)s %(levelname)s %(name)s: %(message)s"


def _current_trace_id() -> Optional[str]:
    try:
        from .. import trace
    except ImportError:
        return None
    return trace.tracer.current_trace_id()


class JsonFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        out = {
            "ts": round(record.created, 3),
            "level": record.levelname,
            "logger": record.name,
            "msg": record.getMessage(),
        }
        tid = _current_trace_id()
        if tid:
            out["trace"] = tid
        if record.exc_info:
            out["exc"] = self.formatException(record.exc_info)
        return json.dumps(out, default=str)


def setup(verbose: int = 0, stream=None) -> None:
    """Configure root logging for a daemon main: DEBUG when `verbose`,
    else INFO; format per VTPU_LOG_FORMAT. Idempotent (force=True), so
    a re-exec (e.g. the plugin's kubelet-restart loop) reconfigures
    cleanly instead of stacking handlers."""
    level = logging.DEBUG if verbose else logging.INFO
    fmt = env_str(ENV_LOG_FORMAT, "text").strip().lower()
    if fmt == "json":
        handler = logging.StreamHandler(stream or sys.stderr)
        handler.setFormatter(JsonFormatter())
        logging.basicConfig(level=level, handlers=[handler], force=True)
    else:
        logging.basicConfig(level=level, format=TEXT_FORMAT, force=True,
                            stream=stream)
        if fmt not in ("", "text"):
            # misconfiguration degrades, never crashes a daemon
            logging.getLogger(__name__).warning(
                "unknown VTPU_LOG_FORMAT=%r; using text", fmt)
