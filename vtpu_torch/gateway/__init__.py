"""Serving gateway: the traffic plane above the mesh-served models, the
port of vtpu/gateway/ (docs/serving.md). It fronts N replicas of a
``vtpu_torch.models.serving.ShardedServingModel``:

  * :mod:`vtpu_torch.gateway.batcher` — continuous batching: per-model
    bounded tenant-fair queues (vtpu_torch/util/fairqueue.py, shared with
    the scheduler's /filter intake) drained into model steps that REFILL
    every step, padded to a small set of batch buckets; batch size adapts
    between VTPU_GW_BATCH_MIN/MAX under the latency budget.
  * :mod:`vtpu_torch.gateway.router` — latency-aware routing across
    replicas by EWMA step latency x queue depth, tie-broken by the node
    monitors' quota-pressure counters (the rebalancer's
    ``HTTPNodeInfoSource``, not a second scraper).
  * :mod:`vtpu_torch.gateway.autoscaler` — the leader-gated SLO control
    loop growing/shrinking the replica set; spawned replicas are
    best-effort priority so guaranteed work can preempt them, and
    scale-downs prefer migration-candidate replicas.
"""

from .autoscaler import Autoscaler, ReplicaSet
from .batcher import GatewayRequest, ReplicaBatcher, StepResult
from .router import Replica, Router

__all__ = [
    "Autoscaler",
    "GatewayRequest",
    "Replica",
    "ReplicaBatcher",
    "ReplicaSet",
    "Router",
    "StepResult",
]
