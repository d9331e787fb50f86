"""Serving-gateway Prometheus metrics: the port of vtpu/gateway/metrics.py,
its families renamed ``vTPU...`` -> ``vGPU...`` as the port's scheduler
metrics are (two packages' families cannot share one ``prometheus_client``
registry in a process that imports both).

The six families mirror the gateway's three loops: queue depth + shed
are the intake (continuous batching's bounded front door), batch size
+ step latency + recompiles are the batcher's adaptive step (recompiles
MUST stay flat at steady state — pad-to-bucket exists precisely so
steps hit a handful of batch shapes), and replicas is the
autoscaler's output tracking demand.
"""

from __future__ import annotations

from prometheus_client import Counter, Gauge, Histogram

#: the JAX gateway's families -> the port's
METRIC_NAMES = {f"vTPUGateway{f}": f"vGPUGateway{f}" for f in (
    "QueueDepth", "BatchSize", "StepLatency", "Shed", "Recompiles",
    "Replicas")}

GW_QUEUE_DEPTH = Gauge(
    "vGPUGatewayQueueDepth",
    "requests queued in the gateway awaiting a batch slot",
    ["model"],
)
# buckets match the pad-to-bucket grid (powers of two between
# VTPU_GW_BATCH_MIN and _MAX): mass moving right = the adaptive loop
# growing batches under load
GW_BATCH_SIZE = Histogram(
    "vGPUGatewayBatchSize",
    "requests served per continuous-batching step (pre-padding)",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256),
)
GW_STEP_LATENCY = Histogram(
    "vGPUGatewayStepLatency",
    "seconds per model step as recorded by ServingStats "
    "(vtpu_torch/models/serving.py record_step — the gateway never re-times)",
    buckets=(0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
             0.5, 1.0, 2.5),
)
GW_SHED = Counter(
    "vGPUGatewayShed",
    "gateway requests shed with a retryable refusal (reason: "
    "queue_full / no_replica / drain_overflow) instead of queueing "
    "unboundedly past the latency SLO",
    ["reason"],
)
GW_RECOMPILES = Counter(
    "vGPUGatewayRecompiles",
    "batch buckets compiled for the first time; flat at steady state "
    "(a per-request shape would recompile every step)",
)
GW_REPLICAS = Gauge(
    "vGPUGatewayReplicas",
    "serving replicas per model currently routable by the gateway",
    ["model"],
)
