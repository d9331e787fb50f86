"""DeepLab-v3 semantic segmentation for the ai-benchmark cases 4.x (the port
of vtpu/models/deeplab.py:23-101).

Inference batch=2 512x512, training batch=1 384x384 (reference
README.md:248-249). A ResNet-V2-50 backbone at output stride 16: stages
0-2 as in ResNet, stage 3 atrous at rate 2 instead of strided (the port's
``BottleneckV2`` takes the rate); an ASPP head with rates 6/12/18 and an
image-pool branch, concatenated in the reference's order (1x1, the three
atrous, the pool); a float32 1x1 ``logits`` conv with bias; and a bilinear
upsample back to the input size (``jax.image.resize(bilinear)`` is
``F.interpolate(bilinear, align_corners=False)``).

Input is NCHW; the logits come back NHWC, ``[b, h, w, classes]``, as the
reference returns them, which is what ``cross_entropy`` and the
``[b, h, w]`` labels expect. The image-pool branch's BatchNorm sees one
value per channel at batch 1 in training (case 4.2); the port's
``BatchNorm`` normalises it as flax does, where torch's would raise.
"""

from __future__ import annotations

from functools import partial
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .norm import BatchNorm
from .resnet import BottleneckV2, Conv2d, resnet_stem, stem_conv


class ASPP(nn.Module):
    """Atrous spatial pyramid pooling head (deeplab.py:23-55)."""

    def __init__(self, in_features: int, features: int = 256,
                 rates: Sequence[int] = (6, 12, 18),
                 dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        conv = partial(Conv2d, dtype=dtype, device=device)
        norm = partial(BatchNorm, momentum=0.9, eps=1e-5, dtype=dtype,
                       device=device)
        self.features = features
        self.rates = tuple(rates)
        self.b0 = conv(in_features, features, 1)
        self.b0_bn = norm(features)
        for i, r in enumerate(self.rates):
            self.add_module(f"b{i + 1}", conv(in_features, features, 3,
                                              padding=r, dilation=r))
            self.add_module(f"b{i + 1}_bn", norm(features))
        self.pool_conv = conv(in_features, features, 1)
        self.pool_bn = norm(features)
        self.out = conv(features * (len(self.rates) + 2), features, 1)
        self.out_bn = norm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        branches = [F.relu(self.b0_bn(self.b0(x)))]
        for i in range(len(self.rates)):
            b = getattr(self, f"b{i + 1}")(x)
            branches.append(F.relu(getattr(self, f"b{i + 1}_bn")(b)))
        pooled = x.mean(dim=(2, 3), keepdim=True)  # image-level pooling
        pooled = F.relu(self.pool_bn(self.pool_conv(pooled)))
        branches.append(pooled.expand(-1, -1, x.shape[2], x.shape[3]))
        y = torch.cat(branches, dim=1)
        return F.relu(self.out_bn(self.out(y)))


class DeepLabV3(nn.Module):
    """DeepLab-v3, ResNet-V2-50 backbone, output stride 16."""

    def __init__(self, num_classes: int = 21,
                 dtype: torch.dtype = torch.bfloat16,
                 backbone_stages: Sequence[int] = (3, 4, 6, 3),
                 width: int = 64, in_channels: int = 3, device=None):
        super().__init__()
        self.dtype = dtype
        norm = partial(BatchNorm, momentum=0.9, eps=1e-5)
        self.conv_root = stem_conv(in_channels, width, dtype, device)
        features = width
        self.block_names = []
        for i, blocks in enumerate(backbone_stages):
            for j in range(blocks):
                # stages 0-2 as stock ResNet; stage 3 atrous at rate 2
                strides = 2 if 0 < i < 3 and j == 0 else 1
                name = f"stage{i}_block{j}"
                filters = width * 2 ** i
                self.add_module(name, BottleneckV2(
                    features, filters, strides=strides,
                    rate=2 if i == 3 else 1, dtype=dtype, norm=norm,
                    device=device))
                self.block_names.append(name)
                features = filters * 4
        self.final_bn = norm(features, dtype=dtype, device=device)
        self.aspp = ASPP(features, dtype=dtype, device=device)
        self.logits = nn.Conv2d(self.aspp.features, num_classes, 1,
                                device=device, dtype=torch.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[2], x.shape[3]
        x = resnet_stem(x.to(self.dtype), self.conv_root)
        for name in self.block_names:
            x = getattr(self, name)(x)
        x = self.aspp(F.relu(self.final_bn(x)))
        x = self.logits(x.float())
        x = F.interpolate(x, size=(h, w), mode="bilinear",
                          align_corners=False)
        return x.permute(0, 2, 3, 1)  # NHWC logits, as the reference's


def deeplab_v3(num_classes: int = 21, dtype=torch.bfloat16,
               device=None) -> DeepLabV3:
    return DeepLabV3(num_classes=num_classes, dtype=dtype, device=device)
