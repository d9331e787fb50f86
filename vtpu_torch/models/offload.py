"""Host-offload training workload, and its migratable form.

The port of vtpu/models/offload.py. The model keeps its master parameters
and both Adam moments in host memory, streams them to the card for each
step, and writes the updated values back into the same host tensors; the
bytes it holds on the host are accounted against the pod's host-memory
reservation (``CUDA_HOST_MEMORY_LIMIT``, the region's host ledger).

On the card the host state lives in pinned (page-locked) tensors, so each
step's copies are DMA transfers. Two accounting paths cover the two
deployment shapes, as in the JAX package:

  * under ``libvgpu.so`` (``Enforcer.interposed``), the pinned tensors are
    charged to the host ledger where the driver pins them
    (``cuMemHostAlloc``), with no cooperation; :meth:`OffloadModel.setup`
    only checks the headroom first, so an unpayable workload is refused
    before it pins anything (a second, cooperative charge would count the
    bytes twice);
  * without it (the CPU, a plain process), :meth:`OffloadModel.setup`
    charges the host-resident bytes itself through the
    :class:`~vtpu_torch.enforce.workload.Enforcer`: the same ledger, the
    same refusal.

The step is a plain MLP (``tanh`` hidden layers, a scalar head, mean
squared error) with the reference's hand-written Adam and its float step
counter in the bias correction. Entry points run on the card unless the
caller passes ``device="cpu"``.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..enforce.workload import (
    DRAIN_PHASE_REFUSED,
    DRAIN_PHASE_SNAPSHOTTED,
    Enforcer,
)

log = logging.getLogger(__name__)

#: a model's parameters (or one Adam moment): one {"w", "b"} per layer
Params = List[Dict[str, torch.Tensor]]

B1, B2, LR, EPS = 0.9, 0.999, 1e-3, 1e-8


def _tree_bytes(tree: Params) -> int:
    return sum(t.numel() * t.element_size()
               for layer in tree for t in layer.values())


def params_from_jax(params: Sequence) -> Params:
    """The JAX OffloadModel's parameter list (one ``{"w", "b"}`` of arrays
    per layer, ``w`` as [in, out]) as the port's f32 CPU tensors, in the
    same layout."""
    return [{k: torch.from_numpy(np.array(layer[k], dtype=np.float32))
             for k in ("w", "b")} for layer in params]


def train_step(params: Params, m: Params, v: Params, x: torch.Tensor,
               y: torch.Tensor, t: float) -> Tuple[Params, Params, Params,
                                                   torch.Tensor]:
    """One step on whatever device the tensors are on: the loss and its
    gradients, then Adam with ``t`` as an f32 step count (the reference's
    ``step``, vtpu/models/offload.py:175-194). Returns new tensors; the
    inputs are not modified."""
    leaves = [{k: p.detach().requires_grad_(True) for k, p in layer.items()}
              for layer in params]
    h = x
    for layer in leaves[:-1]:
        h = torch.tanh(h @ layer["w"] + layer["b"])
    pred = h @ leaves[-1]["w"] + leaves[-1]["b"]
    loss = torch.mean((pred[:, 0] - y) ** 2)
    flat = [layer[k] for layer in leaves for k in ("w", "b")]
    grads = iter(torch.autograd.grad(loss, flat))
    tt = torch.tensor(float(t), dtype=torch.float32, device=x.device)
    c1 = 1 - torch.pow(torch.tensor(B1, device=x.device), tt)
    c2 = 1 - torch.pow(torch.tensor(B2, device=x.device), tt)
    new_p, new_m, new_v = [], [], []
    with torch.no_grad():
        for layer, lm, lv in zip(params, m, v):
            pp, mm, vv = {}, {}, {}
            for k in ("w", "b"):
                g = next(grads)
                mm[k] = B1 * lm[k] + (1 - B1) * g
                vv[k] = B2 * lv[k] + (1 - B2) * g * g
                pp[k] = layer[k] - LR * (mm[k] / c1) / (
                    torch.sqrt(vv[k] / c2) + EPS)
            new_p.append(pp)
            new_m.append(mm)
            new_v.append(vv)
    return new_p, new_m, new_v, loss.detach()


class HostQuotaExceeded(RuntimeError):
    """The workload's host-resident state does not fit its host-memory
    reservation (the cooperative twin of the interposer's refusal)."""


@dataclass
class OffloadStats:
    steps: int = 0
    host_bytes: int = 0        # params + Adam moments held on the host
    offloaded: bool = False    # True when that state is pinned for a card
    #: last loss value (proof the step actually trained)
    loss: float = float("nan")


class OffloadModel:
    """MLP whose parameters and Adam moments live in host memory.

    ``enforcer`` (optional) wires the accounting: the host-resident bytes
    are charged against the pod's host quota at :meth:`setup` (raising
    :class:`HostQuotaExceeded` when they do not fit) and released at
    :meth:`close`.
    """

    def __init__(self, layers=(256, 256, 128), dim: int = 64,
                 batch: int = 32, enforcer: Optional[Enforcer] = None,
                 device=None) -> None:
        self.layers = tuple(layers)
        self.dim = dim
        self.batch = batch
        self.enforcer = enforcer
        self.device = torch.device("cuda" if device is None else device)
        self.stats = OffloadStats()
        self._charged = 0
        self._params: Optional[Params] = None
        self._opt: Optional[Tuple[Params, Params]] = None

    @property
    def sizes(self) -> Tuple[int, ...]:
        return (self.dim,) + self.layers + (1,)

    def host_bytes(self) -> int:
        """Parameters and both Adam moments, f32."""
        s = self.sizes
        return 3 * sum(4 * (s[i] * s[i + 1] + s[i + 1])
                       for i in range(len(s) - 1))

    # -- lifecycle ---------------------------------------------------------

    def _host(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` where the model keeps its host state: pinned for a card."""
        return t.pin_memory() if self.device.type == "cuda" else t

    def setup(self, seed: int = 0) -> OffloadStats:
        host_bytes = self.host_bytes()
        pinned = self.device.type == "cuda"
        # who accounts? Under libvgpu.so the pinned tensors below are
        # charged where the driver pins them; a cooperative charge on top
        # would count them twice, so only the headroom is checked, before
        # anything is pinned
        if self.enforcer is not None:
            if pinned and self.enforcer.interposed:
                limit = self.enforcer.host_limit()
                if limit and host_bytes > max(
                        0, limit - self.enforcer.host_used()):
                    raise HostQuotaExceeded(
                        f"offload state of {host_bytes} B does not fit "
                        "the pod's host-memory reservation")
            elif not self.enforcer.host_charge(host_bytes):
                raise HostQuotaExceeded(
                    f"offload state of {host_bytes} B does not fit the "
                    "pod's host-memory reservation")
            else:
                self._charged = host_bytes
        gen = torch.Generator().manual_seed(seed)
        sizes = self.sizes
        params = [{"w": self._host(torch.randn(
                       (sizes[i], sizes[i + 1]), generator=gen) * 0.05),
                   "b": self._host(torch.zeros(sizes[i + 1]))}
                  for i in range(len(sizes) - 1)]
        opt = tuple([{k: self._host(torch.zeros_like(t))
                      for k, t in layer.items()} for layer in params]
                    for _ in range(2))
        assert host_bytes == _tree_bytes(params) + sum(
            _tree_bytes(o) for o in opt)
        self._params, self._opt = params, opt
        self.stats.host_bytes = host_bytes
        self.stats.offloaded = pinned
        return self.stats

    def load(self, params: Params, m: Optional[Params] = None,
             v: Optional[Params] = None) -> None:
        """Copy ``params`` (and the moments, when given) into the model's
        host tensors, in place."""
        if self._params is None:
            self.setup()
        for dst, src in ((self._params, params), (self._opt[0], m),
                         (self._opt[1], v)):
            if src is None:
                continue
            for dl, sl in zip(dst, src):
                for k in ("w", "b"):
                    dl[k].copy_(sl[k])

    def _batch(self, gen: torch.Generator) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
        """One batch drawn from ``gen`` on the host: x [batch, dim] and
        y [batch], standard normal."""
        x = torch.randn((self.batch, self.dim), generator=gen)
        y = torch.randn((self.batch,), generator=gen)
        return x, y

    def _step(self, x: torch.Tensor, y: torch.Tensor, t: int) -> float:
        """Stream the host state to the device, step, and copy the result
        back into the same host tensors (fresh pinned tensors every step
        would grow the host allocator's cache and the ledger with it)."""
        dev = self.device

        def to_dev(tree):
            return [{k: u.to(dev, non_blocking=True)
                     for k, u in layer.items()} for layer in tree]

        m, v = self._opt
        new = train_step(to_dev(self._params), to_dev(m), to_dev(v),
                         x.to(dev, non_blocking=True),
                         y.to(dev, non_blocking=True), float(t))
        for host, out in zip((self._params, m, v), new[:3]):
            for hl, ol in zip(host, out):
                for k in ("w", "b"):
                    hl[k].copy_(ol[k], non_blocking=True)
        # the loss is read on the same stream, after the copies back
        return float(new[3])

    def train(self, steps: int = 4, seed: int = 1) -> OffloadStats:
        """Run ``steps`` steps on batches from a generator seeded ``seed``."""
        if self._params is None:
            self.setup()
        gen = torch.Generator().manual_seed(seed)
        for t in range(1, steps + 1):
            x, y = self._batch(gen)
            self.stats.loss = self._step(x, y, t)
            self.stats.steps += 1
        return self.stats

    def close(self) -> None:
        """Release the cooperative host charge (byte-exact: the ledger
        returns to its pre-setup value) and the host state."""
        if self._charged and self.enforcer is not None:
            self.enforcer.host_release(self._charged)
        self._charged = 0
        self._params = self._opt = None
        if self.device.type == "cuda":
            # hand cached pinned blocks back to the driver (and, under
            # libvgpu.so, their charge back to the ledger)
            empty = getattr(torch._C, "_host_emptyCache", None)
            if empty is not None:
                empty()


@dataclass
class MigrationBlob:
    """Everything a resumed replica needs to continue the same stream
    (docs/migration.md): parameters, both Adam moments, the step counter
    and the batch generator's state, in pageable host tensors. Charged to
    the source's host ledger until :meth:`MigratableModel.release_snapshot`.
    """

    params: Params
    m: Params
    v: Params
    t: int
    gen_state: torch.Tensor
    host_bytes: int = 0
    gen: int = 0


class MigratableModel(OffloadModel):
    """OffloadModel that takes part in the live-migration drain protocol
    (docs/migration.md).

    The step counter and the batch generator persist across :meth:`train`
    calls, so snapshot, then resume on another replica, continues the same
    loss stream an unmigrated control produces. Between steps the model
    polls the Enforcer's drain surface; on a request it gathers its state
    into pageable host tensors, charges their bytes to the host ledger (a
    refusal acks ``refused`` and training goes on: the planner falls back
    to preemption), acks ``snapshotted``, and stops stepping. The
    snapshot's charge is released only at :meth:`release_snapshot`, once
    the destination's region attached.
    """

    def __init__(self, layers=(256, 256, 128), dim: int = 64,
                 batch: int = 32, enforcer: Optional[Enforcer] = None,
                 device=None) -> None:
        super().__init__(layers=layers, dim=dim, batch=batch,
                         enforcer=enforcer, device=device)
        self._t = 0
        self._gen: Optional[torch.Generator] = None
        self._snap_charge = 0
        self.drained = False
        self.blob: Optional[MigrationBlob] = None
        #: the last drain generation whose snapshot the ledger refused
        self.refused = 0
        #: loss of each step this replica ran, in order
        self.losses: List[float] = []

    # -- deterministic stepping -------------------------------------------

    def train(self, steps: int = 4, seed: int = 1) -> OffloadStats:
        """Like OffloadModel.train, but resumable: the generator and step
        counter survive across calls (and across migration). Stops early
        when a drain request lands."""
        if self._params is None:
            self.setup()
        if self._gen is None:
            self._gen = torch.Generator().manual_seed(seed)
        for _ in range(steps):
            # poll even while drained: an aborted or expired move retracts
            # the request and the model un-drains in place
            self.maybe_drain()
            if self.drained:
                break
            self._t += 1
            x, y = self._batch(self._gen)
            self.stats.loss = self._step(x, y, self._t)
            self.losses.append(self.stats.loss)
            self.stats.steps += 1
        return self.stats

    # -- drain / snapshot / resume ----------------------------------------

    def maybe_drain(self) -> Optional[int]:
        """Poll the drain surface; on a pending request snapshot and ack.
        Returns the acked generation, or None when nothing is pending (or
        the ledger refused the snapshot and training goes on). A drained
        model polls for retraction instead: when the move is aborted or
        expires, the request is withdrawn and the model un-drains, its
        snapshot charge released byte-exactly."""
        if self.enforcer is None:
            return None
        if self.drained:
            gen = self.blob.gen if self.blob is not None else 0
            if gen and self.enforcer.drain_retracted(gen):
                log.info("drain gen %d retracted without cutover; "
                         "resuming at the source", gen)
                self.release_snapshot()
                self.drained = False
            return None
        gen = self.enforcer.drain_requested()
        if not gen:
            return None
        blob = self.snapshot(gen)
        if blob is None:
            self.enforcer.drain_ack(gen, DRAIN_PHASE_REFUSED)
            self.refused = gen
            return None
        self.enforcer.drain_ack(gen, DRAIN_PHASE_SNAPSHOTTED,
                                blob.host_bytes)
        return gen

    def snapshot(self, gen: int = 0) -> Optional[MigrationBlob]:
        """Gather the whole training state into pageable host tensors (as
        ``jax.device_get`` does), charged to the host ledger before the
        gather, so an unpayable snapshot is refused while refusing is free
        (None). On success the model is drained."""
        if self._params is None:
            self.setup()
        snap_bytes = self.stats.host_bytes
        # pageable memory is not pinned through the driver, so this charge
        # is explicit under libvgpu.so too
        if self.enforcer is not None \
                and not self.enforcer.host_charge(snap_bytes):
            log.warning("snapshot of %d B refused by host ledger; "
                        "migration falls back to preemption", snap_bytes)
            return None
        self._snap_charge = snap_bytes
        if self._gen is None:
            self._gen = torch.Generator().manual_seed(1)

        def gather(tree):
            return [{k: u.detach().to("cpu", copy=True)
                     for k, u in layer.items()} for layer in tree]

        m, v = self._opt
        self.blob = MigrationBlob(
            params=gather(self._params), m=gather(m), v=gather(v),
            t=self._t, gen_state=self._gen.get_state(),
            host_bytes=snap_bytes, gen=gen)
        self.drained = True
        return self.blob

    def resume(self, blob: MigrationBlob) -> OffloadStats:
        """Adopt a source replica's snapshot on this (destination) model:
        setup() first (its own host state, charged to its own region),
        then the blob's values copied in, step counter and generator
        state included, so the next train() continues the source's
        stream."""
        if self._params is None:
            self.setup()
        self.load(blob.params, blob.m, blob.v)
        self._t = blob.t
        self._gen = torch.Generator()
        self._gen.set_state(blob.gen_state)
        self.stats.steps = blob.t
        self.drained = False
        return self.stats

    def release_snapshot(self) -> None:
        """Byte-exact release of the snapshot's charge, once the
        destination's region attached (the make-before-break edge)."""
        if self._snap_charge and self.enforcer is not None:
            self.enforcer.host_release(self._snap_charge)
        self._snap_charge = 0
        self.blob = None

    def close(self) -> None:
        self.release_snapshot()
        super().close()
        self._t = 0
        self._gen = None
        self.drained = False


def run_offload_workload(enforcer: Optional[Enforcer] = None,
                         steps: int = 4,
                         layers: Tuple[int, ...] = (256, 256, 128),
                         device=None) -> OffloadStats:
    """One-shot convenience: setup, train, close."""
    model = OffloadModel(layers=layers, enforcer=enforcer, device=device)
    try:
        model.setup()
        return model.train(steps=steps)
    finally:
        model.close()


def pod_main(argv=None) -> int:
    """A migratable offload pod: ``python -m vtpu_torch.models.offload
    --dim D --layers A,B,C --batch N [--device cpu]``, started with the env
    an Allocate response gives (its region, its limits, ``libvgpu.so``
    preloaded). It attaches to its region, then answers one JSON command a
    line on stdin with one JSON line on stdout:

    - ``setup``: the model's host state made (``seed``); the host ledger
      before and after;
    - ``train``: ``steps`` steps, or with ``until_drained`` steps until a
      drain request is acked, snapshotted or refused (or ``timeout_s``
      passes); each step's loss and ms, the step counter, whether drained,
      the drain generation, the refused one;
    - ``save``: the drained model's snapshot written to ``path``;
    - ``resume``: the snapshot at ``path`` adopted;
    - ``release``: the snapshot's charge released;
    - ``ledger``: the host ledger and whether libvgpu.so interposes;
    - ``exit``."""
    import argparse
    import json
    import sys
    import time

    from ..enforce import install

    p = argparse.ArgumentParser("vtpu_torch.models.offload")
    p.add_argument("--dim", type=int, default=64)
    p.add_argument("--layers", default="256,256,128")
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--device", default=None)
    args = p.parse_args(argv)
    enforcer = install()
    model = MigratableModel(
        layers=tuple(int(x) for x in args.layers.split(",")), dim=args.dim,
        batch=args.batch, enforcer=enforcer, device=args.device)
    dev = model.device
    if dev.type == "cuda":
        torch.zeros(1, device=dev)  # the context, before any command

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def ledger():
        return {"host_used": enforcer.host_used(),
                "interposed": enforcer.interposed}

    out = sys.stdout
    print(json.dumps({"ready": True, **ledger()}), file=out, flush=True)
    for line in sys.stdin:
        cmd = json.loads(line)
        op = cmd["op"]
        if op == "exit":
            break
        if op == "setup":
            before = enforcer.host_used()
            model.setup(seed=cmd.get("seed", 0))
            sync()
            reply = {"host_bytes": model.stats.host_bytes,
                     "before": before, "after": enforcer.host_used()}
        elif op == "train":
            losses, ms = [], []
            deadline = time.monotonic() + cmd.get("timeout_s", 600)
            steps = cmd.get("steps", 0)
            refused = model.refused
            while (len(losses) < steps or cmd.get("until_drained")) \
                    and not model.drained and model.refused == refused \
                    and time.monotonic() < deadline:
                t0 = time.perf_counter()
                model.train(steps=1, seed=cmd.get("seed", 1))
                if model.drained or model.refused != refused:
                    break
                losses.append(model.stats.loss)
                ms.append((time.perf_counter() - t0) * 1e3)
            reply = {"losses": losses, "ms": ms, "t": model._t,
                     "drained": model.drained,
                     "gen": model.blob.gen if model.blob else 0,
                     "refused": model.refused,
                     "host_used": enforcer.host_used()}
        elif op == "save":
            blob = model.blob
            torch.save({"params": blob.params, "m": blob.m, "v": blob.v,
                        "t": blob.t, "gen_state": blob.gen_state,
                        "host_bytes": blob.host_bytes, "gen": blob.gen},
                       cmd["path"])
            reply = {"t": blob.t}
        elif op == "resume":
            model.resume(MigrationBlob(**torch.load(cmd["path"])))
            sync()
            reply = {"t": model._t, "host_used": enforcer.host_used()}
        elif op == "release":
            model.release_snapshot()
            reply = {"host_used": enforcer.host_used()}
        else:
            reply = ledger()
        print(json.dumps(reply), file=out, flush=True)
    model.close()
    enforcer.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(pod_main())
