"""vtpu_torch — the vTPU accelerator-sharing stack ported to PyTorch and CUDA.

A second package beside ``vtpu`` (the JAX/TPU reference, which it never
imports): the ai-benchmark models in PyTorch (``vtpu_torch.models``), the
workload-side quota plumbing (``vtpu_torch.enforce``) and the CUDA
driver-API interposer ``libvgpu.so`` (``vtpu_torch/csrc``, built by
``vtpu_torch.native``). Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``; without a GPU they raise.
"""

from __future__ import annotations


def resolve_device(device=None):
    """``torch.device`` for ``device`` (default ``cuda``); raises when CUDA
    is asked for and there is none, instead of falling back to the CPU."""
    import torch

    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run on the CPU")
    return dev


def entry(device=None):
    """Forward step on the flagship model (ResNet-V2-50, ai-benchmark case
    1.x) plus example args, the counterpart of __graft_entry__.entry():
    batch 8, 224x224x3 NHWC input of ones, weights from seed 0. Returns
    ``(fn, args)``; ``fn(*args)`` gives float32 logits."""
    import torch

    from .models import get_model
    from .models.train import init_model, make_infer_step

    dev = resolve_device(device)
    model = get_model("resnet_v2_50", device=dev)
    if dev.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    x = torch.ones((8, 224, 224, 3), dtype=torch.float32, device=dev)
    init_model(model, x, torch.Generator().manual_seed(0))
    return make_infer_step(model), (x,)
