"""Continuous batching: the gateway's per-replica step loop, the port of
vtpu/gateway/batcher.py.

One :class:`ReplicaBatcher` fronts one serving replica (a
``ShardedServingModel`` of vtpu_torch/models/serving.py, or anything with
the same ``infer`` + ``ServingStats`` contract). Requests land in a bounded
tenant-fair queue (:class:`vtpu_torch.util.fairqueue.FairQueue` — the same
round-robin-by-namespace discipline as the scheduler's /filter
intake) and are drained by ``step()``, which REFILLS the batch every
step: a request admitted mid-flight joins the NEXT step instead of
waiting for the current "generation" of requests to run to
completion. That refill is the canonical serving-throughput
optimization the serve ladder measures (vtpu_torch/bench/serve_ladder.py
gates >=3x sustained QPS over one-request-per-step at the same p99 SLO).

Two disciplines keep the step loop honest:

* **Pad-to-bucket** — the batch is padded to the nearest
  power-of-two bucket (aligned to the replica's local device count, the
  model's divisibility contract) so the model sees a handful of batch
  shapes in all (on the card, each a shape cuBLAS picks its kernels for
  once). ``vGPUGatewayRecompiles`` counts first-seen buckets and MUST stay
  flat at steady state.
* **Adaptive batch size** — the target batch grows toward
  ``VTPU_GW_BATCH_MAX`` while the queue's predicted drain time
  (EWMA step latency x steps-to-drain) says the latency budget
  holds, and shrinks toward ``VTPU_GW_BATCH_MIN`` the moment a
  single step violates it. The EWMA consumes
  ``ServingStats.last_step_seconds`` — the model stamps its own step
  latency (vtpu_torch/models/serving.py); the gateway never re-times.

The batch is one tensor on the model's device (``model.device``), copied
there in one transfer; a step copies the model's output back to the host
once, and each request's ``result`` is its row of that copy (a numpy row).
A model with no ``device`` (a simulated one, a host model) gets the numpy
batch, as the JAX gateway gives every model, and the gateway never imports
torch for it.

When the queue is full ``submit`` sheds with the scheduler's
:class:`~vtpu_torch.scheduler.core.ShedError` (429 semantics: an explicit
retryable refusal, never an opaque timeout), counted per reason in
``vGPUGatewayShed``.
"""

from __future__ import annotations

import math
import sys
import time
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional

import numpy as np

from .. import api
from ..scheduler.core import ShedError
from ..util.env import env_float, env_int
from ..util.fairqueue import FairQueue, FairQueueFull
from . import metrics as metricsmod

#: adaptive-batch defaults (the JAX gateway's, docs/config.md)
BATCH_MIN_DEFAULT = 1
BATCH_MAX_DEFAULT = 64
QUEUE_CAP_DEFAULT = 256
SLO_MS_DEFAULT = 50.0
EWMA_ALPHA_DEFAULT = 0.2
#: fraction of the SLO one step (or one predicted queue drain) may
#: consume — the other half is the request's own step + routing slack
STEP_BUDGET_FRACTION = 0.5
#: request latencies retained for the autoscaler's p99 window
LATENCY_WINDOW = 4096


@dataclass
class GatewayRequest:
    """One inference request riding the gateway."""

    tenant: str
    payload: Any                  # one feature row (model-shaped)
    arrival: float                # submit-time clock reading
    result: Any = None            # this replica's output row when done
    done: bool = False
    shed: bool = False            # explicitly refused (shed budget)
    completed_at: float = 0.0

    @property
    def latency(self) -> float:
        return self.completed_at - self.arrival if self.done else -1.0


@dataclass
class StepResult:
    """What one continuous-batching step did (bench/soak accounting)."""

    requests: List[GatewayRequest] = field(default_factory=list)
    batch: int = 0                # real requests served (pre-padding)
    bucket: int = 0               # padded compiled shape
    step_seconds: float = 0.0


class ReplicaBatcher:
    """The per-replica continuous-batching engine.

    Synchronous and step-driven: callers (a serving thread, the
    simulated-clock benchmark, the soak harness) invoke ``step()`` in
    a loop. An injectable ``clock`` plus an explicit ``now=`` on
    submit/step keep the engine deterministic under simulated time —
    the flake discipline of the reference's tests.
    """

    def __init__(self, model: Any, model_name: str = "default", *,
                 batch_min: Optional[int] = None,
                 batch_max: Optional[int] = None,
                 queue_cap: Optional[int] = None,
                 slo_s: Optional[float] = None,
                 ewma_alpha: Optional[float] = None,
                 clock: Callable[[], float] = time.perf_counter) -> None:
        self.model = model
        self.model_name = model_name
        self.clock = clock
        align = max(1, int(getattr(getattr(model, "stats", None),
                                   "local_devices", 1) or 1))
        self.align = align
        raw_min = (batch_min if batch_min is not None
                   else env_int(api.ENV_GW_BATCH_MIN, BATCH_MIN_DEFAULT,
                                minimum=1))
        raw_max = (batch_max if batch_max is not None
                   else env_int(api.ENV_GW_BATCH_MAX, BATCH_MAX_DEFAULT,
                                minimum=1))
        # buckets are batch_min * 2^k, aligned to the local device
        # count (the model's divisibility contract): a tiny fixed set
        # of shapes no matter what queue depths traffic produces
        self.batch_min = max(raw_min, align)
        self.batch_min = align * math.ceil(self.batch_min / align)
        self.batch_max = max(self.batch_min,
                             align * math.ceil(raw_max / align))
        self.batch = self.batch_min  # current adaptive target
        self.slo_s = (slo_s if slo_s is not None
                      else env_float(api.ENV_GW_SLO_MS, SLO_MS_DEFAULT,
                                     minimum=1.0) / 1e3)
        self.ewma_alpha = (ewma_alpha if ewma_alpha is not None
                           else env_float(api.ENV_GW_EWMA_ALPHA,
                                          EWMA_ALPHA_DEFAULT,
                                          minimum=0.01))
        self.device = getattr(model, "device", None)
        self.queue = FairQueue(
            queue_cap if queue_cap is not None
            else env_int(api.ENV_GW_QUEUE, QUEUE_CAP_DEFAULT, minimum=1))
        self.step_ewma = 0.0          # EWMA of observed step seconds
        self.steps = 0
        self.served = 0
        self.shed_count = 0
        self.recompiles = 0
        self._compiled_buckets: set = set()
        #: completed-request latencies since the last pop_latencies()
        #: (the autoscaler's per-poll p99 window)
        self._latencies: List[float] = []

    # -- intake ------------------------------------------------------------

    def submit(self, tenant: str, payload: Any,
               now: Optional[float] = None) -> GatewayRequest:
        """Queue one request; ShedError (429) when the queue is full."""
        req = GatewayRequest(tenant=tenant, payload=payload,
                             arrival=self.clock() if now is None else now)
        try:
            self.queue.push(tenant, req)
        except FairQueueFull:
            self.shed_count += 1
            req.shed = True
            metricsmod.GW_SHED.labels("queue_full").inc()
            raise ShedError(
                f"gateway queue for model {self.model_name} full "
                f"({self.queue.capacity} queued); retry") from None
        metricsmod.GW_QUEUE_DEPTH.labels(self.model_name).set(
            len(self.queue))
        return req

    @property
    def depth(self) -> int:
        return len(self.queue)

    # -- the step loop -----------------------------------------------------

    def _bucket_of(self, n: int) -> int:
        b = self.batch_min
        while b < n and b < self.batch_max:
            b *= 2
        return min(b, self.batch_max)

    def step(self, now: Optional[float] = None) -> Optional[StepResult]:
        """Serve ONE batch: drain up to the current adaptive target
        from the tenant-fair queue, pad to the compile bucket, run the
        model, complete the requests, adapt the target. Returns None
        when the queue is empty (an idle tick)."""
        n = min(len(self.queue), self.batch)
        if n == 0:
            metricsmod.GW_QUEUE_DEPTH.labels(self.model_name).set(0)
            return None
        reqs = self.queue.take(n)
        bucket = self._bucket_of(n)
        if bucket not in self._compiled_buckets:
            # first time this shape reaches the model: its kernels are
            # picked once; steady-state traffic must reuse the set
            self._compiled_buckets.add(bucket)
            self.recompiles += 1
            metricsmod.GW_RECOMPILES.inc()
        rows = [np.asarray(r.payload, np.float32) for r in reqs]
        pad = np.zeros_like(rows[0])
        batch = np.stack(rows + [pad] * (bucket - n))
        if self.device is not None:
            import torch
            batch = torch.from_numpy(batch).to(torch.device(self.device))
        out = self.model.infer(batch)
        # one copy of the whole output to the host, never one per row
        torch = sys.modules.get("torch")
        out = (out.detach().cpu().numpy()
               if torch is not None and torch.is_tensor(out)
               else np.asarray(out))
        # the model stamped its own step latency (the ServingStats
        # accessor): consume it, never re-time around the call
        step_s = float(self.model.stats.last_step_seconds)
        done_at = (self.clock() if now is None else now + step_s)
        for i, req in enumerate(reqs):
            req.result = out[i]
            req.done = True
            req.completed_at = done_at
            self._latencies.append(req.latency)
        del self._latencies[:-LATENCY_WINDOW]
        self.steps += 1
        self.served += n
        self.step_ewma = (step_s if self.steps == 1
                          else self.ewma_alpha * step_s
                          + (1.0 - self.ewma_alpha) * self.step_ewma)
        self._adapt()
        metricsmod.GW_BATCH_SIZE.observe(n)
        metricsmod.GW_STEP_LATENCY.observe(step_s)
        metricsmod.GW_QUEUE_DEPTH.labels(self.model_name).set(
            len(self.queue))
        return StepResult(requests=reqs, batch=n, bucket=bucket,
                          step_seconds=step_s)

    def _adapt(self) -> None:
        """Grow while the predicted queue drain fits the step budget,
        shrink the moment one step violates it: grow while step latency
        x queue depth says the SLO holds, shrink on violation."""
        budget = self.slo_s * STEP_BUDGET_FRACTION
        depth = len(self.queue)
        if self.step_ewma > budget:
            self.batch = max(self.batch_min, self.batch // 2)
            return
        drain_s = self.step_ewma * math.ceil(
            depth / max(1, self.batch))
        if depth > self.batch and drain_s > budget \
                and self.batch < self.batch_max:
            self.batch = min(self.batch_max, self.batch * 2)

    # -- autoscaler / drain surface ---------------------------------------

    def pop_latencies(self) -> List[float]:
        """Completed-request latencies since the last call (the
        autoscaler's per-poll p99 window)."""
        out = self._latencies
        self._latencies = []
        return out

    def drain(self) -> List[GatewayRequest]:
        """Remove and return every queued (not yet served) request —
        the preemption path: a replica being reclaimed hands its
        queue back to the router for re-routing, never silently
        dropping in-flight work."""
        reqs = [req for _tenant, req in self.queue.drain_items()]
        metricsmod.GW_QUEUE_DEPTH.labels(self.model_name).set(0)
        return reqs
