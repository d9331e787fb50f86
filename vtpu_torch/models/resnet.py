"""ResNet-V2 (pre-activation) for the ai-benchmark cases 1.x / 2.x.

The port of vtpu/models/resnet.py:23-107: Resnet-V2-50 inference batch=50
346x346, training batch=20 346x346; Resnet-V2-152 at 256x256 (reference
README.md:242-245).

Same numerics as the flax model: parameters in float32, compute in ``dtype``
(bfloat16 by default). The casts are explicit where flax makes them — the
input at resnet.py:85, each conv's input and kernel, BatchNorm's float32
math (models/norm.py), and the float32 head at resnet.py:96 — not through
``torch.autocast``. Modules take NCHW tensors; on the card the activations
are ``torch.channels_last`` (NHWC in memory, what cuDNN's fast kernels
want), which the step in models/train.py gets for free from the JAX
layout's NHWC input.

Child names follow the flax module names (``conv_root``,
``stage{i}_block{j}``, ``preact_bn``, ``proj``, ``conv1``..``conv3``,
``bn1``, ``bn2``, ``final_bn``, ``head``), so models/convert.py carries a
flax checkpoint across by name.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .norm import BatchNorm


class Conv2d(nn.Conv2d):
    """Conv with float32 weights (and bias, with ``bias``), computed in
    ``dtype``."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int, *,
                 stride: int = 1, padding: int = 0, dilation: int = 1,
                 bias: bool = False, dtype: torch.dtype = torch.bfloat16,
                 device=None):
        super().__init__(in_channels, out_channels, kernel, stride=stride,
                         padding=padding, dilation=dilation, bias=bias,
                         device=device, dtype=torch.float32)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = self.bias.to(dt) if self.bias is not None else None
        return self._conv_forward(x.to(dt), self.weight.to(dt), bias)


class Linear(nn.Linear):
    """flax ``nn.Dense``: float32 parameters, computed in ``dtype``."""

    def __init__(self, in_features: int, out_features: int, *,
                 dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__(in_features, out_features, device=device,
                         dtype=torch.float32)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class BottleneckV2(nn.Module):
    """Pre-activation bottleneck: BN-ReLU-1x1 / BN-ReLU-3x3 / BN-ReLU-1x1.

    ``rate`` > 1 makes the 3x3 atrous (dilated); strides and rate are
    mutually exclusive by construction. The identity shortcut takes ``x``;
    the projection takes the pre-activation (resnet.py:42-49).
    """

    def __init__(self, in_features: int, filters: int, strides: int = 1,
                 rate: int = 1, dtype: torch.dtype = torch.bfloat16,
                 norm: Callable[..., nn.Module] = BatchNorm, device=None):
        super().__init__()
        conv = partial(Conv2d, dtype=dtype, device=device)
        out = filters * 4
        self.preact_bn = norm(in_features, dtype=dtype, device=device)
        self.needs_proj = in_features != out or strides != 1
        if self.needs_proj:
            self.proj = conv(in_features, out, 1, stride=strides)
        self.conv1 = conv(in_features, filters, 1)
        self.bn1 = norm(filters, dtype=dtype, device=device)
        self.conv2 = conv(filters, filters, 3, stride=strides,
                          padding=rate, dilation=rate)
        self.bn2 = norm(filters, dtype=dtype, device=device)
        self.conv3 = conv(filters, out, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        preact = F.relu(self.preact_bn(x))
        shortcut = self.proj(preact) if self.needs_proj else x
        y = F.relu(self.bn1(self.conv1(preact)))
        y = F.relu(self.bn2(self.conv2(y)))
        return shortcut + self.conv3(y)


def resnet_stem(x: torch.Tensor, conv_root: Conv2d) -> torch.Tensor:
    """7x7/2 conv + 3x3/2 max-pool root shared by ResNet and DeepLab;
    ``conv_root`` is a 7x7 stride-2 pad-3 :class:`Conv2d`. The pool pads
    with -inf, as flax's ``nn.max_pool`` does."""
    return F.max_pool2d(conv_root(x), 3, stride=2, padding=1)


def stem_conv(in_channels: int, width: int,
              dtype: torch.dtype = torch.bfloat16, device=None) -> Conv2d:
    return Conv2d(in_channels, width, 7, stride=2, padding=3, dtype=dtype,
                  device=device)


class ResNetV2(nn.Module):
    """Pre-activation ResNet; stage_sizes (3,4,6,3)=50, (3,8,36,3)=152.

    Inference uses BatchNorm's running statistics (``eval()``); training
    mode (batch statistics, running update) is the flax ``train=True``.
    """

    def __init__(self, stage_sizes: Sequence[int], num_classes: int = 1000,
                 width: int = 64, dtype: torch.dtype = torch.bfloat16,
                 in_channels: int = 3, device=None):
        super().__init__()
        self.dtype = dtype
        norm = partial(BatchNorm, momentum=0.9, eps=1e-5)
        self.conv_root = stem_conv(in_channels, width, dtype, device)
        features = width
        self.block_names = []
        for i, block_count in enumerate(stage_sizes):
            for j in range(block_count):
                strides = 2 if i > 0 and j == 0 else 1
                filters = width * 2 ** i
                name = f"stage{i}_block{j}"
                self.add_module(name, BottleneckV2(
                    features, filters, strides=strides, dtype=dtype,
                    norm=norm, device=device))
                self.block_names.append(name)
                features = filters * 4
        self.final_bn = norm(features, dtype=dtype, device=device)
        self.head = nn.Linear(features, num_classes, device=device,
                              dtype=torch.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = resnet_stem(x.to(self.dtype), self.conv_root)
        for name in self.block_names:
            x = getattr(self, name)(x)
        x = F.relu(self.final_bn(x))
        x = x.mean(dim=(2, 3))  # global average pool
        return self.head(x.float()).float()


def resnet_v2_50(num_classes: int = 1000, dtype=torch.bfloat16,
                 device=None) -> ResNetV2:
    return ResNetV2(stage_sizes=(3, 4, 6, 3), num_classes=num_classes,
                    dtype=dtype, device=device)


def resnet_v2_152(num_classes: int = 1000, dtype=torch.bfloat16,
                  device=None) -> ResNetV2:
    return ResNetV2(stage_sizes=(3, 8, 36, 3), num_classes=num_classes,
                    dtype=dtype, device=device)
