"""Initialisation, the train and inference steps, the loss, and the sharded
train step (the port of vtpu/models/train.py).

The sharded step is where the models meet ``torch.distributed``: a (dp, tp)
``DeviceMesh`` over the initialised process group, parameters stored as
DTensors under the reference's sharding rule, the batch split over dp, and
BatchNorm statistics taken over the global batch, so one step gives the
loss and parameters of the unsharded step on the whole batch, as
``jax.jit`` does for the reference's sharded step.
"""

from __future__ import annotations

import math
import os
import shutil
import tempfile
import time
from datetime import timedelta
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .norm import BatchNorm

# flax's lecun_normal draws from a normal truncated at +-2 standard
# deviations and divides by that distribution's std so the variance is
# exactly 1/fan_in (jax.nn.initializers.variance_scaling)
_TRUNC_STD = 0.87962566103423978

# _param_pspec (vtpu/models/train.py:45): only kernels whose output features
# reach this width are sharded over tp
TP_MIN_FEATURES = 256


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
    run it once on ``example_x`` (NHWC, or ``[b, T, F]`` for the LSTM, as
    flax's ``init`` traces it).

    Conv and Dense kernels (the LSTM cell's fused gate kernel too):
    lecun_normal; conv and Dense biases: zeros; BatchNorm:
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


def to_model_layout(x: torch.Tensor) -> torch.Tensor:
    """An image batch in the JAX package's NHWC layout as the NCHW the
    port's vision models take; anything else (the LSTM's ``[b, T, F]``)
    as it is. The permute is a view, so a contiguous NHWC batch reaches
    the convs as a channels_last tensor without a copy."""
    return x.permute(0, 3, 1, 2) if x.dim() == 4 else x


def _forward(model: nn.Module, x: torch.Tensor,
             generator: Optional[torch.Generator]) -> torch.Tensor:
    """``model`` on a batch in the JAX layout; a model that draws dropout
    (``takes_generator``) draws from ``generator``."""
    if getattr(model, "takes_generator", False):
        return model(to_model_layout(x), generator=generator)
    return model(to_model_layout(x))


def make_infer_step(model: nn.Module) -> Callable[[torch.Tensor],
                                                  torch.Tensor]:
    """Inference step over a batch in the JAX package's layout (NHWC
    images, ``[b, T, F]`` sequences) returning float32 logits. Puts
    ``model`` in eval mode: BatchNorm uses its running statistics and
    dropout is off."""
    model.eval()

    def step(x: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return model(to_model_layout(x))

    return step


def default_optimizer(params) -> torch.optim.Optimizer:
    """``optax.sgd(1e-2, momentum=0.9)``: optax's trace is g + 0.9·trace
    from a zero trace, torch's buffer is g + 0.9·buffer from g — the same
    sequence."""
    return torch.optim.SGD(params, lr=1e-2, momentum=0.9, dampening=0,
                           nesterov=False)


def _check_batch_stats(model: nn.Module, has_batch_stats: bool) -> None:
    # flax refuses to update statistics of an immutable collection; a model
    # with BatchNorm needs has_batch_stats=True in the reference too
    if not has_batch_stats and any(isinstance(m, BatchNorm)
                                   for m in model.modules()):
        raise ValueError("the model has BatchNorm: has_batch_stats=False "
                         "would leave its statistics unupdated")


def make_train_step(model: nn.Module,
                    optimizer: Optional[torch.optim.Optimizer] = None,
                    has_batch_stats: bool = True
                    ) -> Tuple[Callable, torch.optim.Optimizer]:
    """SGD-with-momentum train step (vtpu/models/train.py:80-107); returns
    ``(step, optimizer)``.

    ``step(x, y, generator=None)`` puts the model in train mode
    (BatchNorm takes batch statistics and updates its running ones),
    computes the float32 cross-entropy, backpropagates, steps the optimizer
    and returns the detached loss. ``x`` is in the JAX layout (NHWC images,
    ``[b, T, F]`` sequences). ``generator`` stands where the reference
    step takes its dropout key: VGG's dropout draws its masks from it (a
    generator on the batch's device); the other models draw nothing."""
    _check_batch_stats(model, has_batch_stats)
    optimizer = optimizer if optimizer is not None \
        else default_optimizer(model.parameters())

    def step(x: torch.Tensor, y: torch.Tensor,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
        model.train()
        optimizer.zero_grad(set_to_none=True)
        loss = cross_entropy(_forward(model, x, generator), y)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step, optimizer


# ------------------------------------------------------------ sharded step


def make_mesh(device_type: str = "cuda", dp: Optional[int] = None,
              tp: int = 1):
    """A (dp, tp) ``DeviceMesh`` with dims ("dp", "tp") over the initialised
    process group (vtpu/models/train.py:25-34); ``dp`` defaults to
    world_size // tp."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group")
    n = dist.get_world_size()
    dp = n // tp if dp is None else dp
    if dp * tp != n:
        raise ValueError(f"mesh {dp}x{tp} != {n} ranks")
    return init_device_mesh(device_type, (dp, tp),
                            mesh_dim_names=("dp", "tp"))


def param_placements(shape, tp: int):
    """Placements over ("dp", "tp") of a parameter of ``shape``: the rule of
    _param_pspec/shard_params (vtpu/models/train.py:37-60) in torch's
    layout. flax's last axis (output features) is dim 0 of a torch Conv
    [out, in, kh, kw] or Linear [out, in] weight; a tensor of rank >= 2
    whose dim 0 is >= 256 and divisible by tp is Shard(0) over tp,
    everything else is replicated."""
    from torch.distributed.tensor import Replicate, Shard

    if len(shape) >= 2 and shape[0] >= TP_MIN_FEATURES and shape[0] % tp == 0:
        return [Replicate(), Shard(0)]
    return [Replicate(), Replicate()]


def build_sharded_train_step(model: nn.Module, example_x: torch.Tensor,
                             example_y: torch.Tensor, mesh,
                             generator: Optional[torch.Generator] = None,
                             has_batch_stats: bool = True):
    """Initialise ``model`` from ``generator``, store its parameters and SGD
    momentum as DTensors under :func:`param_placements`, and return
    ``(step, state)`` (vtpu/models/train.py:119-154).

    ``state = (params, momentum, batch_stats)``: dicts by parameter or
    buffer name of the live tensors the step updates in place (momentum
    starts at zero, as ``tx.init``). ``step(x, y, generator=None)`` takes
    the global batch; each rank computes on its dp share of the rows, with
    every parameter gathered whole for compute (redistribute to
    Replicate, then ``to_local``) so no convolution is sharded. Autograd
    returns each gradient summed over dp and split to its shard over tp,
    and the loss each rank backpropagates is divided by dp, so the
    gradients are the dp average. BatchNorm takes its statistics over the
    global batch (the dp group), as the reference's jit does. The step
    returns the loss of the global batch."""
    import torch.distributed as dist
    from torch.distributed.tensor import Partial, Replicate, distribute_tensor
    from torch.func import functional_call

    _check_batch_stats(model, has_batch_stats)
    dp, tp = mesh.size(0), mesh.size(1)
    if example_x.shape[0] % dp or example_y.shape[0] != example_x.shape[0]:
        raise ValueError(f"batch {example_x.shape[0]} does not split over "
                         f"dp={dp}")
    init_model(model, example_x, generator)
    dp_group = mesh.get_group("dp")
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.process_group = dp_group
        for name, p in list(m.named_parameters(recurse=False)):
            m.register_parameter(name, nn.Parameter(distribute_tensor(
                p.detach(), mesh, param_placements(p.shape, tp))))
    params = dict(model.named_parameters())
    optimizer = default_optimizer(params.values())
    momentum = {}
    for name, p in params.items():
        momentum[name] = torch.zeros_like(p)
        optimizer.state[p]["momentum_buffer"] = momentum[name]
    batch_stats = dict(model.named_buffers())

    whole = [Replicate(), Replicate()]
    grad_back = [Partial(), Replicate()]  # each rank's share of the sum
    rank_dp = mesh.get_local_rank("dp")

    def step(x: torch.Tensor, y: torch.Tensor,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
        rows = x.shape[0] // dp
        xs = x[rank_dp * rows:(rank_dp + 1) * rows]
        ys = y[rank_dp * rows:(rank_dp + 1) * rows]
        model.train()
        optimizer.zero_grad(set_to_none=True)
        full = {n: p.redistribute(mesh, whole).to_local(
            grad_placements=grad_back) for n, p in params.items()}
        logits = functional_call(model, full, (to_model_layout(xs),))
        loss = cross_entropy(logits, ys)
        (loss / dp).backward()
        optimizer.step()
        total = loss.detach() / dp
        dist.all_reduce(total, group=dp_group)
        return total

    return step, (params, momentum, batch_stats)


# ------------------------------------------------------------------ ranks


def _rank_entry(rank: int, fn: Callable, n: int, device_type: str,
                init_file: str, timeout_s: float, args: tuple) -> None:
    import torch.distributed as dist

    if device_type == "cuda":
        torch.cuda.set_device(rank)
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                            init_method=f"file://{init_file}",
                            world_size=n, rank=rank,
                            timeout=timedelta(seconds=timeout_s))
    try:
        # every rank joined before any runs: a rank whose fn ends (or
        # raises) at once must not tear its group down while a peer is
        # still connecting, which fails the peer's init instead
        dist.barrier()
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def run_ranks(fn: Callable, n: int, device_type: str, args: tuple = (),
              init_file: Optional[str] = None,
              timeout_s: float = 600.0) -> None:
    """Run ``fn(rank, *args)`` in ``n`` spawned processes, each a rank of a
    process group (NCCL with one GPU per rank on ``cuda``, gloo on the
    CPU) that meets at ``init_file`` (a fresh temporary file by default),
    not at a TCP port. ``fn`` must be importable by name. Raises when a
    rank raises or the ranks outlast ``timeout_s``; every process is gone
    when it returns."""
    import torch.multiprocessing as mp

    tmp = None
    if init_file is None:
        tmp = tempfile.mkdtemp(prefix="vtpu-ranks-")
        init_file = os.path.join(tmp, "rendezvous")
    ctx = mp.start_processes(
        _rank_entry, args=(fn, n, device_type, init_file, timeout_s, args),
        nprocs=n, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{n} ranks still running after "
                                   f"{timeout_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(timeout=60)
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
