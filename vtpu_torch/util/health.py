"""Node-plane degraded-mode surface of the node agent.

The port's copy of vtpu/util/health.py (docs/node-resilience.md): a node
daemon that cannot reach the apiserver
(or is skipping work it normally does — GC on a stale pod cache,
quarantined region files) keeps serving what it safely can, but must
say so instead of silently limping: every degradation is a named reason
on the ``vGPUNodeDegraded{component,reason}`` gauge and flips the
daemon's ``/readyz`` to 503 while ``/healthz`` stays 200 (alive but
degraded is a rollout/alert signal, not a restart signal — restarting a
daemon because the apiserver is down just adds churn).
"""

from __future__ import annotations

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Tuple

from prometheus_client import Gauge

log = logging.getLogger(__name__)

# its own family name: a process that imports both packages (the parity
# tests) registers both gauges in one prometheus registry
NODE_DEGRADED = Gauge(
    "vGPUNodeDegraded",
    "1 while the named node daemon is running in the named degraded "
    "mode (apiserver_unreachable, podcache_stale, region_quarantine, "
    "kubelet_unregistered, ...); 0 once the condition clears",
    ["component", "reason"])


class DegradedState:
    """Thread-safe set of active degradation reasons for one daemon.

    ``set``/``clear`` are idempotent and log only on the transition, so
    a reason re-asserted every 5s sweep produces one warning, not a
    log stream. Each transition also drives the shared
    ``vTPUNodeDegraded`` gauge."""

    def __init__(self, component: str):
        self.component = component
        self._lock = threading.Lock()
        self._reasons: Dict[str, str] = {}

    def set(self, reason: str, detail: str = "") -> None:
        with self._lock:
            known = reason in self._reasons
            self._reasons[reason] = detail
        if not known:
            log.warning("%s degraded: %s%s", self.component, reason,
                        f" ({detail})" if detail else "")
            NODE_DEGRADED.labels(self.component, reason).set(1)

    def clear(self, reason: str) -> None:
        with self._lock:
            known = self._reasons.pop(reason, None) is not None
        if known:
            log.info("%s recovered from: %s", self.component, reason)
            NODE_DEGRADED.labels(self.component, reason).set(0)

    def assign(self, reason: str, active: bool, detail: str = "") -> None:
        """Sweep-loop convenience: assert or retract in one call."""
        if active:
            self.set(reason, detail)
        else:
            self.clear(reason)

    def reasons(self) -> Dict[str, str]:
        with self._lock:
            return dict(self._reasons)

    def degraded(self) -> bool:
        with self._lock:
            return bool(self._reasons)


def readyz_payload(state: Optional[DegradedState]) -> Tuple[int, bytes]:
    """(status code, JSON body) for a /readyz probe: 200 when no
    degradation reason is active, 503 with the reasons otherwise."""
    reasons = state.reasons() if state is not None else {}
    body = json.dumps({
        "degraded": bool(reasons),
        "component": state.component if state is not None else "",
        "reasons": reasons,
    }).encode()
    return (503 if reasons else 200), body


def start_health_server(state: DegradedState, port: int,
                        bind: str = "127.0.0.1"
                        ) -> Optional[ThreadingHTTPServer]:
    """Minimal /healthz + /readyz HTTP server for daemons that have no
    other HTTP surface (the device plugin). ``port`` 0 picks an
    ephemeral port (tests); pass a negative port to disable."""
    if port < 0:
        return None

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            path = self.path.rstrip("/")
            if path == "/healthz" or path == "":
                code, body = 200, b"ok\n"
            elif path == "/readyz":
                code, body = readyz_payload(state)
            else:
                self.send_error(404)
                return
            self.send_response(code)
            self.send_header("Content-Type",
                             "application/json" if path == "/readyz"
                             else "text/plain")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):  # quiet
            pass

    server = ThreadingHTTPServer((bind, port), Handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    log.info("%s health endpoints on %s:%d (/healthz, /readyz)",
             state.component, bind or "*", server.server_address[1])
    return server
