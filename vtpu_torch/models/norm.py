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
                 device=None):
        super().__init__()
        f32 = {"device": device, "dtype": torch.float32}
        self.num_features = num_features
        self.momentum = momentum
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(num_features, **f32))
        self.bias = nn.Parameter(torch.zeros(num_features, **f32))
        self.register_buffer("running_mean", torch.zeros(num_features, **f32))
        self.register_buffer("running_var", torch.ones(num_features, **f32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if self.training:
            dims = [d for d in range(xf.dim()) if d != 1]
            mean = xf.mean(dim=dims)
            var = (xf.square().mean(dim=dims) - mean.square()).clamp_min(0.0)
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
