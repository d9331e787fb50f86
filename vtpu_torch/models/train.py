"""Initialisation, the inference step and the loss (the inference half of
vtpu/models/train.py: 63-77, 110-116).

The train step and the sharded step are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from .norm import BatchNorm

# flax's lecun_normal draws from a normal truncated at +-2 standard
# deviations and divides by that distribution's std so the variance is
# exactly 1/fan_in (jax.nn.initializers.variance_scaling)
_TRUNC_STD = 0.87962566103423978


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood in float32 over every label position
    (segmentation logits are [b, h, w, c])."""
    logp = F.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels.long().unsqueeze(-1)).mean()


def _lecun_normal_(w: torch.Tensor, generator: torch.Generator) -> None:
    fan_in = w[0].numel()  # in_channels * kh * kw, or in_features
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    draw = torch.empty(w.shape, dtype=torch.float32)
    nn.init.trunc_normal_(draw, mean=0.0, std=std, a=-2 * std, b=2 * std,
                          generator=generator)
    w.copy_(draw)


@torch.no_grad()
def init_model(model: nn.Module, example_x: torch.Tensor,
               generator: Optional[torch.Generator] = None) -> nn.Module:
    """Initialise ``model`` in place with flax's default distributions and
    run it once on ``example_x`` (NHWC, as flax's ``init`` traces it).

    Conv and Dense kernels: lecun_normal; Dense biases: zeros; BatchNorm:
    scale ones, bias zeros, running mean zeros, running var ones. The draws
    come from ``generator`` on the CPU and are copied to the model's device,
    so a seed gives the same weights on every device."""
    generator = generator if generator is not None \
        else torch.Generator().manual_seed(0)
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            _lecun_normal_(m.weight, generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, BatchNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
    make_infer_step(model)(example_x)
    return model


def make_infer_step(model: nn.Module) -> Callable[[torch.Tensor],
                                                  torch.Tensor]:
    """Inference step over NHWC input (the JAX package's layout) returning
    float32 logits. Puts ``model`` in eval mode: BatchNorm uses its running
    statistics. The NHWC -> NCHW permute is a view, so a contiguous NHWC
    batch reaches the convs as a channels_last tensor without a copy."""
    model.eval()

    def step(x: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return model(x.permute(0, 3, 1, 2))

    return step
