"""ai-benchmark workload suite in PyTorch (the port of vtpu/models).

What runs inside a quota-limited container on an NVIDIA GPU: so far
ResNet-V2-50/152 inference. Compute is bfloat16 with float32 parameters,
BatchNorm statistics and head, as in the flax models; activations are
channels_last on the card.
"""

from .registry import BENCH_CASES, MODELS, BenchCase, get_model  # noqa: F401
