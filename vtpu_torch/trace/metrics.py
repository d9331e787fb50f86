"""Stage-latency histogram bridging the tracer to Prometheus (the port's
copy of vtpu/trace/metrics.py).

vtpu_torch/trace is a zero-hard-dependency layer (workload processes import
it via vtpu_torch.enforce without prometheus_client installed), so the metric
lives here behind a guarded import and the tracer observes it only when
present. One labeled family instead of one histogram per stage: a
Grafana spike in ``vGPUSchedulingStageLatency{stage="commit.patch"}``
names the stage, and the journal / ``/trace`` endpoint then yields the
exact pods (docs/observability.md has the worked walkthrough).
"""

from __future__ import annotations

try:
    from prometheus_client import Histogram

    STAGE_LATENCY = Histogram(
        "vGPUSchedulingStageLatency",
        "per-stage pod scheduling latency in seconds "
        "(stage taxonomy: docs/observability.md)",
        ["stage"],
        buckets=(0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
                 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0),
    )
except ImportError:  # pragma: no cover - prometheus absent in workloads
    STAGE_LATENCY = None

# per-stage child cache: Histogram.labels() takes the family lock and
# hashes the label tuple on every call (~4us); the stage vocabulary is
# a dozen constants, so resolve each child once. Benign data race: two
# threads resolving the same stage install the same child twice.
_children = {}


def observe(stage: str, seconds: float) -> None:
    """Record one finished span's duration; no-op without prometheus."""
    if STAGE_LATENCY is None:
        return
    child = _children.get(stage)
    if child is None:
        child = _children[stage] = STAGE_LATENCY.labels(stage=stage)
    child.observe(seconds)
