"""vtpu_torch — the vTPU accelerator-sharing stack ported to PyTorch and CUDA.

A second package beside ``vtpu`` (the JAX/TPU reference, which it never
imports): the ai-benchmark models in PyTorch (``vtpu_torch.models``), the
workload-side quota plumbing (``vtpu_torch.enforce``) and the CUDA
driver-API interposer ``libvgpu.so`` (``vtpu_torch/csrc``, built by
``vtpu_torch.native``). Entry points (``entry``, ``dryrun_multichip``) run
on ``cuda`` unless the caller passes ``device="cpu"``; without a GPU they
raise.
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


def dryrun_multichip(n_devices: int, device=None) -> None:
    """One step of the full sharded training path over an ``n_devices``
    (dp, tp) mesh, the counterpart of __graft_entry__.dryrun_multichip():
    tp = 2 when n is even, dp = n // tp; ResNet-V2-50 with 16 classes on a
    batch of max(n, dp) 32x32x3 ones with labels 0. Spawns ``n_devices``
    ranks: NCCL with one visible GPU each on ``cuda`` (raises when fewer
    are visible), gloo on ``device="cpu"``. Raises unless the loss is
    finite."""
    import torch

    from .models.train import run_ranks

    dev = resolve_device(device)
    if dev.type == "cuda" and torch.cuda.device_count() < n_devices:
        raise RuntimeError(f"dryrun_multichip({n_devices}) needs {n_devices} "
                           f"GPUs, {torch.cuda.device_count()} visible")
    run_ranks(_dryrun_rank, n_devices, dev.type, args=(n_devices, dev.type))


def _dryrun_rank(rank: int, n: int, device_type: str) -> None:
    import torch

    from .models import get_model
    from .models.train import build_sharded_train_step, make_mesh

    tp = 2 if n % 2 == 0 and n >= 2 else 1
    mesh = make_mesh(device_type, dp=n // tp, tp=tp)
    dev = torch.device(device_type, rank) if device_type == "cuda" \
        else torch.device("cpu")
    model = get_model("resnet_v2_50", num_classes=16, device=dev)
    if dev.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    batch = max(n, n // tp)  # divisible by dp
    x = torch.ones((batch, 32, 32, 3), dtype=torch.float32, device=dev)
    y = torch.zeros((batch,), dtype=torch.int64, device=dev)
    step, _ = build_sharded_train_step(model, x, y, mesh)
    loss = step(x, y)
    if not bool(torch.isfinite(loss)):
        raise RuntimeError(f"non-finite loss {float(loss)} in multichip "
                           f"dryrun (rank {rank})")
