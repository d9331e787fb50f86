"""ai-benchmark workload suite in PyTorch (the port of vtpu/models).

What runs inside a quota-limited container on an NVIDIA GPU: ResNet-V2-50
and -152, VGG-16, DeepLab-v3 and the stacked LSTM, every case of the
reference's matrix. Compute is bfloat16 with float32 parameters,
BatchNorm statistics and head, as in the flax models; activations are
channels_last on the card.
"""

from .registry import (  # noqa: F401
    BENCH_CASES,
    MODELS,
    BenchCase,
    case_model,
    get_model,
)
