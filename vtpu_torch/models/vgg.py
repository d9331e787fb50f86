"""VGG-16 for the ai-benchmark cases 3.x (the port of vtpu/models/vgg.py:23-50).

Inference batch=20 224x224, training batch=2 224x224 (reference
README.md:246-247). Thirteen 3x3 convolutions with bias (padding 1) and
five 2x2/2 max-pools, then ``fc1`` and ``fc2`` (4096 wide) and the float32
``head``. Parameters are float32 and compute runs in ``dtype``, cast where
flax casts: each conv's and dense layer's input, kernel and bias.

Two places differ in layout from a NCHW torch model and follow the flax
one instead: the flatten before ``fc1`` reads the features in NHWC order
(vgg.py:38 flattens an NHWC tensor), so flax's ``fc1`` kernel carries
across by a transpose alone; and ``fc1``'s width follows from
``input_size`` (7x7x512 at 224). Dropout 0.5 after ``fc1`` and ``fc2`` runs
in training only, drawn from the ``generator`` the caller passes.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .resnet import Conv2d, Linear

# channels per conv block; "M" = 2x2 max-pool (vgg.py:17-18)
VGG16_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
             512, 512, 512, "M", 512, 512, 512, "M")
FC_WIDTH = 4096
DROPOUT = 0.5  # after fc1 and fc2, in training


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout: each unit kept with probability 1 - rate and
    scaled by 1 / (1 - rate), as flax's ``nn.Dropout``; the mask is drawn
    from ``generator`` (on ``x``'s device)."""
    if rate <= 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class VGG16(nn.Module):
    """VGG-16 on NCHW input; returns float32 logits."""

    # the train step hands a dropout generator to forward
    takes_generator = True

    def __init__(self, num_classes: int = 1000,
                 dtype: torch.dtype = torch.bfloat16,
                 cfg: Sequence = VGG16_CFG, input_size: int = 224,
                 in_channels: int = 3, device=None):
        super().__init__()
        self.dtype = dtype
        self.cfg = tuple(cfg)
        channels, size = in_channels, input_size
        for i, v in enumerate(self.cfg):
            if v == "M":
                size //= 2
            else:
                self.add_module(f"conv{i}", Conv2d(
                    channels, int(v), 3, padding=1, bias=True, dtype=dtype,
                    device=device))
                channels = int(v)
        self.fc1 = Linear(size * size * channels, FC_WIDTH, dtype=dtype,
                          device=device)
        self.fc2 = Linear(FC_WIDTH, FC_WIDTH, dtype=dtype, device=device)
        self.head = Linear(FC_WIDTH, num_classes, dtype=torch.float32,
                           device=device)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = x.to(self.dtype)
        for i, v in enumerate(self.cfg):
            if v == "M":
                x = F.max_pool2d(x, 2, stride=2)
            else:
                x = F.relu(getattr(self, f"conv{i}")(x))
        x = x.permute(0, 2, 3, 1).flatten(1)  # flax's NHWC feature order
        rate = DROPOUT if self.training else 0.0
        x = dropout(F.relu(self.fc1(x)), rate, generator)
        x = dropout(F.relu(self.fc2(x)), rate, generator)
        return self.head(x).float()


def vgg16(num_classes: int = 1000, dtype=torch.bfloat16, device=None,
          input_size: int = 224) -> VGG16:
    return VGG16(num_classes=num_classes, dtype=dtype, input_size=input_size,
                 device=device)
