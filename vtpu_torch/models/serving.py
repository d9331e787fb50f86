"""Mesh-aware sharded inference model: the port of vtpu/models/serving.py.

One model served across a gang of cooperating pods, each holding only its
shard of the parameters, driven by the ``VTPU_MESH_*`` env the device
plugin writes at Allocate (``vtpu_torch/plugin/server.py`` ``_pod_mesh_env``):

* ``VTPU_MESH_SHAPE``/``VTPU_MESH_COORDS``/``VTPU_MESH_AXES`` describe the
  gang's host-level sub-mesh and this member's position in it.
* The host axis is model-parallel in the Megatron layout: member *m* holds
  the *m*-th column block of the hidden layer (``W1[:, lo:hi]``,
  ``b1[lo:hi]``) and the *m*-th row block of the output layer
  (``W2[lo:hi, :]``), so the full logits are the sum of the members'
  partial outputs (:func:`combine_partials` stands in for the cross-host
  reduction). Members draw the full weights from one host
  ``torch.Generator`` seeded alike and copy only their slice to the card,
  so serving needs no weight distribution and a member's device peak is
  its shard.
* Within a pod the local batch splits across the visible CUDA devices
  (``torch.cuda.device_count()``), in place of the reference's
  ``shard_map`` over a data axis: each device holds a replica of the shard
  and computes its rows.

A class of plain tensors, no ``nn.Module``, like the reference. It runs on
the card unless ``device`` says otherwise (the tests pass ``"cpu"``). The
two matmuls are ``torch.matmul``: the reference computes them with XLA,
outside any Pallas kernel. Torch cannot replay the JAX PRNG, so parity
with the reference runs on weights carried across
(:func:`vtpu_torch.models.convert.serving_params_from_jax`, loaded through
``setup(params=...)``).
"""

from __future__ import annotations

import logging
import os
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import api
from ..gateway.stats import ServingStats

log = logging.getLogger(__name__)

#: the full model's weights, (W1 [dim, hidden], b1 [hidden],
#: W2 [hidden, classes]), f32
Params = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


@dataclass(frozen=True)
class MeshSpec:
    """The VTPU_MESH_* contract, parsed: the gang's host-block box, this
    member's block-relative coordinate, and the positional axis names.
    ``linear_index``/``num_members`` order the members row-major over the
    shape: the parameter-shard selector."""

    shape: Tuple[int, ...] = (1, 1, 1)
    coord: Tuple[int, ...] = (0, 0, 0)
    axes: Tuple[str, ...] = ("x", "y", "z")

    @classmethod
    def from_env(cls, env: Optional[Dict[str, str]] = None) -> "MeshSpec":
        """Parse the Allocate-injected env (or any mapping). Absent or
        malformed values degrade to the solo 1x1x1 mesh: a pod launched
        outside a gang still serves, as shard 0 of 1."""
        src = os.environ if env is None else env
        raw_shape = src.get(api.ENV_MESH_SHAPE, "")
        raw_coord = src.get(api.ENV_MESH_COORDS, "")
        raw_axes = src.get(api.ENV_MESH_AXES, "")
        if not raw_shape or not raw_coord:
            return cls()
        try:
            shape = tuple(int(d) for d in raw_shape.split(","))
            coord = tuple(int(c) for c in raw_coord.split("-"))
            if len(shape) != len(coord) or not shape \
                    or any(d <= 0 for d in shape) \
                    or any(not (0 <= c < d)
                           for c, d in zip(coord, shape)):
                raise ValueError((raw_shape, raw_coord))
        except ValueError:
            log.warning("malformed mesh env (%r, %r); serving as solo "
                        "member", raw_shape, raw_coord)
            return cls()
        axes = tuple(a for a in raw_axes.split(",") if a) or tuple(
            f"ax{i}" for i in range(len(shape)))
        if len(axes) != len(shape):
            axes = tuple(f"ax{i}" for i in range(len(shape)))
        return cls(shape=shape, coord=coord, axes=axes)

    @property
    def num_members(self) -> int:
        return int(np.prod(self.shape))

    @property
    def linear_index(self) -> int:
        """Row-major member index in the block (the shard selector)."""
        idx = 0
        for c, d in zip(self.coord, self.shape):
            idx = idx * d + c
        return idx


def _local_devices(device) -> List[torch.device]:
    """The devices a member's batch splits across: every visible card for
    a bare ``cuda``, each of a sequence of devices (``["cpu"] * 8`` stands
    for the JAX tests' eight virtual CPU devices), else the one device
    named."""
    if isinstance(device, (list, tuple)):
        return [torch.device(d) for d in device]
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("no CUDA device visible; pass device='cpu' "
                               "to serve on the host")
        return [torch.device("cuda", i) for i in range(n)]
    return [device]


class ShardedServingModel:
    """One member's view of the gang-served MLP classifier.

    ``dim -> hidden -> classes``; the hidden dimension is partitioned
    across gang members (model parallel, host axis), the batch across
    local devices (data parallel). ``infer`` returns this member's
    PARTIAL logits; summing every member's partials
    (:func:`combine_partials`) yields the full model's output."""

    def __init__(self, mesh: Optional[MeshSpec] = None,
                 dim: int = 64, hidden: int = 256, classes: int = 16,
                 seed: int = 0,
                 env: Optional[Dict[str, str]] = None,
                 device="cuda") -> None:
        self.mesh = mesh if mesh is not None else MeshSpec.from_env(env)
        if hidden % self.mesh.num_members:
            raise ValueError(
                f"hidden={hidden} not divisible by the gang's "
                f"{self.mesh.num_members} member(s)")
        self.dim = dim
        self.hidden = hidden
        self.classes = classes
        self.seed = seed
        #: what ``device`` named (one device, or a sequence); ``device``
        #: is where a batch is handed in and the output comes back
        self._device_arg = device
        self.device = torch.device(
            device[0] if isinstance(device, (list, tuple)) else device)
        self.stats = ServingStats(member=self.mesh.linear_index,
                                  members=self.mesh.num_members)
        #: one copy of the member's shard per local device
        self._replicas: Optional[List[Params]] = None
        self._devices: List[torch.device] = []

    # -- parameters --------------------------------------------------------

    def _full_params(self) -> Params:
        """The WHOLE model's weights from the shared seed, on the host:
        every member derives the same tensors and slices locally, so
        serving needs no weight-distribution channel."""
        g = torch.Generator(device="cpu").manual_seed(self.seed)
        w1 = torch.randn(self.dim, self.hidden, generator=g) * 0.05
        b1 = torch.randn(self.hidden, generator=g) * 0.01
        w2 = torch.randn(self.hidden, self.classes, generator=g) * 0.05
        return w1, b1, w2

    def shard(self, params: Optional[Params] = None) -> Params:
        """This member's slice of ``params`` (the seed's when None), on
        the host: the Megatron layout, column-parallel first linear (the
        member owns hidden units [lo:hi) end to end) and row-parallel
        second, so partial logits sum to the full output because tanh is
        applied before the partition boundary."""
        w1, b1, w2 = params if params is not None else self._full_params()
        if tuple(w1.shape) != (self.dim, self.hidden) \
                or tuple(b1.shape) != (self.hidden,) \
                or tuple(w2.shape) != (self.hidden, self.classes):
            raise ValueError(
                f"params {tuple(w1.shape)}, {tuple(b1.shape)}, "
                f"{tuple(w2.shape)} do not fit dim={self.dim} "
                f"hidden={self.hidden} classes={self.classes}")
        m, n = self.mesh.linear_index, self.mesh.num_members
        shard = self.hidden // n
        lo, hi = m * shard, (m + 1) * shard
        return (w1[:, lo:hi].contiguous(), b1[lo:hi].contiguous(),
                w2[lo:hi, :].contiguous())

    def setup(self, params: Optional[Params] = None,
              host_shard: Optional[Params] = None) -> ServingStats:
        """Copy this member's shard to each local device. ``params`` are
        the full model's weights (the seed's when None); ``host_shard`` a
        slice :meth:`shard` already took."""
        host = host_shard if host_shard is not None else self.shard(params)
        self.stats.hidden_shard = int(host[1].shape[0])
        self.stats.param_bytes = sum(
            int(t.numel()) * t.element_size() for t in host)
        self._devices = _local_devices(self._device_arg)
        self.stats.local_devices = len(self._devices)
        self._replicas = [tuple(t.to(d, torch.float32) for t in host)
                          for d in self._devices]
        return self.stats

    # -- serving -----------------------------------------------------------

    def _sync(self) -> None:
        for d in self._devices:
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    def infer(self, x) -> torch.Tensor:
        """This member's partial logits for a batch, on the first local
        device. Rows of ``x`` must divide the local device count (the
        serving batcher's pad contract); each device computes its block of
        rows."""
        if self._replicas is None:
            self.setup()
        x = torch.as_tensor(x, dtype=torch.float32)
        if x.shape[0] % self.stats.local_devices:
            raise ValueError(
                f"batch {x.shape[0]} not divisible by "
                f"{self.stats.local_devices} local device(s)")
        blocks = [b.to(d, non_blocking=True) for b, d in zip(
            x.chunk(len(self._devices)), self._devices)]
        self._sync()
        start = time.perf_counter()
        outs = [torch.tanh(xb @ w1 + b1) @ w2
                for xb, (w1, b1, w2) in zip(blocks, self._replicas)]
        out = torch.cat([o.to(self._devices[0]) for o in outs]) \
            if len(outs) > 1 else outs[0]
        # a serving step is only done when the device is: synchronise
        # before stamping the latency the gateway's EWMA will route on
        self._sync()
        self.stats.record_step(time.perf_counter() - start)
        return out

    def close(self) -> None:
        self._replicas = None
        self._devices = []


def combine_partials(partials: Sequence[torch.Tensor]) -> torch.Tensor:
    """The cross-host reduction (sum of the members' row-parallel partial
    logits). In production a collective over the gang's host axis; here
    the gathered partials are summed: the math is identical."""
    if not partials:
        raise ValueError("no partial outputs to combine")
    total = torch.as_tensor(partials[0])
    for i, p in enumerate(partials[1:], start=1):
        p = torch.as_tensor(p)
        if p.shape != total.shape:
            # a shape mismatch means the members disagreed about the
            # batch (or the gang about classes): name WHICH member
            raise ValueError(
                f"partial {i} shape {tuple(p.shape)} != partial 0 shape "
                f"{tuple(total.shape)}; gang members must serve the same "
                f"batch")
        total = total + p.to(total.device)
    return total


def reference_logits(x, dim: int = 64, hidden: int = 256,
                     classes: int = 16, seed: int = 0, device="cuda",
                     params: Optional[Params] = None) -> torch.Tensor:
    """Unsharded forward pass with the same derived weights (or
    ``params``): the ground truth the combined gang output must match."""
    model = ShardedServingModel(mesh=MeshSpec(), dim=dim, hidden=hidden,
                                classes=classes, seed=seed, device=device)
    w1, b1, w2 = (t.to(model.device) for t in (
        params if params is not None else model._full_params()))
    x = torch.as_tensor(x, dtype=torch.float32).to(model.device)
    return torch.tanh(x @ w1 + b1) @ w2


def run_member(env: Dict[str, str], x, params: Optional[Params] = None,
               **kw) -> Tuple[torch.Tensor, ServingStats]:
    """One gang member's whole serving lifecycle against an Allocate env
    mapping: parse the mesh contract, build the sharded model, serve one
    batch, return (partial logits, stats)."""
    model = ShardedServingModel(env=env, **kw)
    try:
        model.setup(params)
        return model.infer(x), model.stats
    finally:
        model.close()
