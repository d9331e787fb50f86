"""BatchNorm with flax's semantics (flax ``nn.BatchNorm`` as used at
vtpu/models/resnet.py:81-84).

Differs from ``torch.nn.BatchNorm2d`` where the reference is held to:

- The math runs in float32 whatever the input type, and the output is cast
  to the compute dtype: flax's ``_normalize`` promotes a bfloat16 input
  against the float32 statistics and casts the result to ``dtype``.
- ``momentum`` is flax's: running = momentum * running + (1 - momentum) *
  batch (flax 0.9 is torch 0.1).
- The running variance takes the *biased* batch variance, E[x²] - E[x]²
  (torch's BatchNorm updates with the unbiased one).
- A batch with one value per channel is normalised, not refused.
- With ``process_group`` set (the dp group of a sharded step), training
  takes its statistics over the global batch, as ``jax.jit`` does for a
  batch sharded over dp: Σx, Σx² and the count are summed in float32
  across the group with an autograd-aware all-reduce, so each rank's
  backward carries every rank's loss through the statistics.

Parameters and statistics keep torch's names (``weight``, ``bias``,
``running_mean``, ``running_var``) so a state dict carries across.
"""

from __future__ import annotations

import torch
from torch import nn


class BatchNorm(nn.Module):
    """Normalises dim 1 (channels) of an NCHW or (N, C) tensor."""

    def __init__(self, num_features: int, *, momentum: float = 0.9,
                 eps: float = 1e-5, dtype: torch.dtype = torch.bfloat16,
                 device=None, process_group=None):
        super().__init__()
        f32 = {"device": device, "dtype": torch.float32}
        self.num_features = num_features
        self.momentum = momentum
        self.eps = eps
        self.dtype = dtype
        self.process_group = process_group
        self.weight = nn.Parameter(torch.ones(num_features, **f32))
        self.bias = nn.Parameter(torch.zeros(num_features, **f32))
        self.register_buffer("running_mean", torch.zeros(num_features, **f32))
        self.register_buffer("running_var", torch.ones(num_features, **f32))

    def _global_moments(self, xf: torch.Tensor, dims):
        """(E[x], E[x²]) over the batch of every rank in the group."""
        from torch.distributed.nn.functional import all_reduce

        count = xf.new_full((1,), xf.numel() // xf.shape[1])
        sums = torch.cat([xf.sum(dim=dims), xf.square().sum(dim=dims), count])
        sums = all_reduce(sums, group=self.process_group)
        c = self.num_features
        return sums[:c] / sums[-1], sums[c:2 * c] / sums[-1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if self.training:
            dims = [d for d in range(xf.dim()) if d != 1]
            if self.process_group is None:
                mean, mean_sq = xf.mean(dim=dims), xf.square().mean(dim=dims)
            else:
                mean, mean_sq = self._global_moments(xf, dims)
            # flax's fast variance, E[x²] - E[x]², clamped at 0
            var = (mean_sq - mean.square()).clamp_min(0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_(mean.detach(), alpha=1 - m)
                self.running_var.mul_(m).add_(var.detach(), alpha=1 - m)
        else:
            mean, var = self.running_mean, self.running_var
        shape = (1, -1) + (1,) * (xf.dim() - 2)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)
        return y.to(self.dtype)

    def extra_repr(self) -> str:
        return (f"{self.num_features}, momentum={self.momentum}, "
                f"eps={self.eps}, dtype={self.dtype}")
