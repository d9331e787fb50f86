"""Stacked LSTM for the ai-benchmark cases 5.x (the port of
vtpu/models/lstm.py:20-83).

Inference batch=100 seq=1024 hidden=300, training batch=10 of the same
shape (reference README.md:250-251). Each layer is one fused cell whose
four gates come from one matmul over ``cat([x, h])``, in i, f, g, o order,
with +1.0 added to the forget pre-activation in float32 after the matmul;
the cell state is float32 across the whole sequence and ``h`` is in the
compute dtype. Hidden 300 is padded to 384 (``_round_up(300, 128)``) so
flax weights load as they are; the output is mean-pooled over time in
float32 and ends in a float32 ``head``.

The time loop is a Python loop over steps, the counterpart of ``nn.scan``:
``torch.nn.LSTM`` (cuDNN) orders its gates, splits its biases and rounds
bf16 differently from the reference. Input is ``[batch, time, features]``.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from .resnet import Linear


def _round_up(n: int, m: int) -> int:
    return (n + m - 1) // m * m


class FusedLSTMCell(nn.Module):
    """One LSTM step with a single fused gate matmul (lstm.py:23-45)."""

    def __init__(self, in_features: int, hidden: int,
                 dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        self.dtype = dtype
        self.gates = Linear(in_features + hidden, 4 * hidden, dtype=dtype,
                            device=device)

    def forward(self, carry: Tuple[torch.Tensor, torch.Tensor],
                x: torch.Tensor):
        h, c = carry
        i, f, g, o = self.gates(torch.cat([x, h], dim=-1)).chunk(4, dim=-1)
        new_c = (torch.sigmoid(f.float() + 1.0) * c
                 + torch.sigmoid(i.float()) * torch.tanh(g.float()))
        new_h = (torch.sigmoid(o.float()) * torch.tanh(new_c)).to(self.dtype)
        return (new_h, new_c), new_h


class StackedLSTM(nn.Module):
    """``num_layers`` LSTM layers over time, mean-pooled classifier."""

    def __init__(self, in_features: int, hidden: int = 300,
                 num_layers: int = 2, num_classes: int = 10,
                 dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        self.dtype = dtype
        self.width = _round_up(hidden, 128)
        self.num_layers = num_layers
        features = in_features
        for layer in range(num_layers):
            self.add_module(f"lstm{layer}", FusedLSTMCell(
                features, self.width, dtype=dtype, device=device))
            features = self.width
        self.head = Linear(self.width, num_classes, dtype=torch.float32,
                           device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        x = x.to(self.dtype)
        for layer in range(self.num_layers):
            cell = getattr(self, f"lstm{layer}")
            carry = (x.new_zeros((b, self.width)),
                     x.new_zeros((b, self.width), dtype=torch.float32))
            outs = []
            for t in range(x.shape[1]):
                carry, h = cell(carry, x[:, t])
                outs.append(h)
            x = torch.stack(outs, dim=1)
        return self.head(x.float().mean(dim=1))


def lstm(hidden: int = 300, num_classes: int = 10, dtype=torch.bfloat16,
         device=None, in_features: int = 300) -> StackedLSTM:
    return StackedLSTM(in_features, hidden=hidden, num_classes=num_classes,
                       dtype=dtype, device=device)
