"""Model registry + the reference benchmark test matrix (the port of
vtpu/models/registry.py:18-52).

The 10 cases mirror the reference's published matrix (reference
README.md:240-252); shapes are (H, W, C) for vision and (seq, feat) for the
LSTM, after the batch. ``case_model`` builds a case's model with the
arguments its shape sets: VGG's input size (``fc1``'s width follows from
it) and the LSTM's input features.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Tuple

from .deeplab import deeplab_v3
from .lstm import lstm
from .resnet import resnet_v2_50, resnet_v2_152
from .vgg import vgg16

MODELS: Dict[str, Callable] = {
    "resnet_v2_50": resnet_v2_50,
    "resnet_v2_152": resnet_v2_152,
    "vgg16": vgg16,
    "deeplab_v3": deeplab_v3,
    "lstm": lstm,
}


def get_model(name: str, **kw):
    return MODELS[name](**kw)


@dataclass(frozen=True)
class BenchCase:
    case: str              # reference case number, e.g. "1.1"
    model: str
    mode: str              # "inference" | "training"
    batch: int
    shape: Tuple[int, ...]  # input shape after batch (H, W, C) or (T, F)
    classes: int = 1000


BENCH_CASES = [
    BenchCase("1.1", "resnet_v2_50", "inference", 50, (346, 346, 3)),
    BenchCase("1.2", "resnet_v2_50", "training", 20, (346, 346, 3)),
    BenchCase("2.1", "resnet_v2_152", "inference", 10, (256, 256, 3)),
    BenchCase("2.2", "resnet_v2_152", "training", 10, (256, 256, 3)),
    BenchCase("3.1", "vgg16", "inference", 20, (224, 224, 3)),
    BenchCase("3.2", "vgg16", "training", 2, (224, 224, 3)),
    BenchCase("4.1", "deeplab_v3", "inference", 2, (512, 512, 3), 21),
    BenchCase("4.2", "deeplab_v3", "training", 1, (384, 384, 3), 21),
    BenchCase("5.1", "lstm", "inference", 100, (1024, 300), 10),
    BenchCase("5.2", "lstm", "training", 10, (1024, 300), 10),
]


def case_model(case: BenchCase, dtype, device=None):
    """``case``'s model at its published shape."""
    kw = {}
    if case.model == "vgg16":
        kw["input_size"] = case.shape[0]
    elif case.model == "lstm":
        kw["in_features"] = case.shape[-1]
    return get_model(case.model, num_classes=case.classes, dtype=dtype,
                     device=device, **kw)
