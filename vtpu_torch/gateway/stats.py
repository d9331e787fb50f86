"""A serving model's step statistics, the contract between a model and the
gateway (vtpu/models/serving.py's ``ServingStats``). It lives with the
gateway, which imports no torch, so host programs (the serve ladder, the
soak's serving leg) can run replicas of a simulated model without it;
``vtpu_torch.models.serving`` re-exports it."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class ServingStats:
    member: int = 0
    members: int = 1
    local_devices: int = 1
    hidden_shard: int = 0      # hidden units THIS member holds
    param_bytes: int = 0       # bytes of this member's parameter shard
    requests: int = 0          # batches served
    #: wall-clock seconds of the most recent infer() step (dispatch +
    #: device completion). The gateway's per-replica EWMA consumes THIS
    #: (vtpu_torch/gateway/router.py) instead of re-timing around the
    #: call: one clock, owned by the model that did the work.
    last_step_seconds: float = 0.0
    #: summed step seconds across every infer() (mean = total/requests)
    step_seconds_total: float = 0.0

    def record_step(self, seconds: float) -> None:
        self.requests += 1
        self.last_step_seconds = seconds
        self.step_seconds_total += seconds

    @property
    def mean_step_seconds(self) -> float:
        """Lifetime mean step latency; 0.0 before the first step."""
        return (self.step_seconds_total / self.requests
                if self.requests else 0.0)
