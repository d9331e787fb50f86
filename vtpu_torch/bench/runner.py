"""One benchmark case, rep by rep (bench.py:125-321).

A case's model is built as ``chip_smoke.py`` and ``vtpu_torch.entry`` build
it: the port's ``case_model`` with seed-0 weights, bf16 compute, f32
parameters, ``channels_last`` on the card. Its sizes are the reference's:
the published batch and 30 iterations a rep on the card, batch 2 and 3
iterations on the CPU or with ``--quick``. Each iteration has its own batch
(a generator on the device seeded ``100 + i``, labels ``200 + i``), since
identical steps could be de-duplicated. A rep queues all its iterations and
forces completion once, with one ``.item()`` over the sum of the outputs;
its rate is the host clock's, its step time CUDA events' on the card.
Training steps in place: the port's step owns the model and optimizer.

FLOPs: XLA's cost analysis has no counterpart. The warm-up step runs under
``FlopCounterMode``, which counts matmuls and convolutions (every tap, the
padding's too) and no elementwise op, where XLA counts the taps inside the
image and the elementwise work; the reference's honesty rules stay: no MFU
under ``2 * params * batch`` or for the LSTM.
"""

from __future__ import annotations

import os
import statistics
import time

import torch
from torch.utils.flop_counter import FlopCounterMode

from .. import api, resolve_device
from ..models import case_model
from ..models.train import init_model, make_infer_step, make_train_step
from . import SCAN_MODELS, peak_flops


def bench_device() -> torch.device:
    """The card; the CPU only where ``VTPU_BENCH_BACKEND=mock`` asks for it
    (the mock libcuda.so.1, which no CPU tensor reaches). Raises without a
    card otherwise."""
    if os.environ.get(api.ENV_BENCH_BACKEND) == "mock":
        return torch.device("cpu")
    return resolve_device("cuda")


def device_name(device: torch.device) -> str:
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else device.type)


def _peak_flops(device: torch.device) -> float:
    return peak_flops(device_name(device))


def _generator(device: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


class CaseRunner:
    """One benchmark case, decomposed so reps can be driven one at a time
    (the interleaved A/B protocol needs rep-level control)."""

    def __init__(self, case, device: torch.device, quick: bool):
        self.case = case
        self.dev = device
        on_cpu = device.type == "cpu"
        self.batch = 2 if (on_cpu or quick) else case.batch
        self.iters = 3 if (on_cpu or quick) else 30
        self.tiny = on_cpu or quick

        batch, iters = self.batch, self.iters
        shape = (batch,) + case.shape
        model = case_model(case, torch.bfloat16, device=device)
        if device.type == "cuda":
            model = model.to(memory_format=torch.channels_last)
        x0 = torch.randn(shape, generator=_generator(device, 0),
                         device=device)
        init_model(model, x0, torch.Generator().manual_seed(0))
        self.n_params = sum(p.numel() for p in model.parameters())

        if case.mode == "inference":
            infer = make_infer_step(model)

            def dispatch(x, y, seed):
                return infer(x)

            y_shape = None
        else:
            train, _ = make_train_step(model)
            dropout = torch.Generator(device=device)

            def dispatch(x, y, seed):
                dropout.manual_seed(seed)
                return train(x, y, dropout)

            # segmentation labels are [b, h, w]
            y_shape = (batch,) + (case.shape[:2]
                                  if case.model == "deeplab_v3" else ())
        self.dispatch = dispatch

        def labels(seed):
            return torch.randint(0, case.classes, y_shape,
                                 generator=_generator(device, seed),
                                 device=device)

        self.xs = [torch.randn(shape, generator=_generator(device, 100 + i),
                               device=device) for i in range(iters)]
        self.ys = ([labels(200 + i) for i in range(iters)]
                   if y_shape else None)
        # warm-up: one step, its FLOPs counted, drained by a scalar fetch
        with FlopCounterMode(display=False) as counter:
            out = dispatch(x0, labels(8) if y_shape else None, 2)
        self.flops = float(counter.get_total_flops())
        float(out.sum())

    def one_rep(self):
        """One timed repetition: queue every iteration, then force
        completion with one scalar fetch over every output. (rate, ms per
        step): the rate by the host clock, the step by CUDA events on the
        card, by the host clock on the CPU."""
        events = None
        if self.dev.type == "cuda":
            events = [torch.cuda.Event(enable_timing=True) for _ in "se"]
        t0 = time.perf_counter()
        if events:
            events[0].record()
        outs = [self.dispatch(self.xs[i], self.ys[i] if self.ys else None,
                              300 + i) for i in range(self.iters)]
        total = torch.stack([o.sum() for o in outs]).sum()
        if events:
            events[1].record()
        total.item()
        dt = time.perf_counter() - t0
        step_s = (events[0].elapsed_time(events[1]) / 1e3 if events
                  else dt) / self.iters
        return self.batch * self.iters / dt, 1000 * step_s

    def result(self, rates, step_ms, primed: bool):
        case, batch = self.case, self.batch
        med_rate = statistics.median(rates)
        med_step = statistics.median(step_ms)
        peak = _peak_flops(self.dev)
        # MFU honesty gates (bench.py:252-265): the LSTM never gets an MFU;
        # everything else must clear one forward matmul pass
        # (2*params*batch), a hard lower bound below which the count is an
        # undercount, not a measurement
        flops = self.flops
        flops_floor = 2.0 * self.n_params * batch
        flops_sane = (flops >= flops_floor
                      and case.model not in SCAN_MODELS)
        mfu = ((flops / (med_step / 1000) / peak)
               if (peak and flops and flops_sane) else None)
        return {
            "case": case.case,
            "model": case.model,
            "mode": case.mode,
            "batch": batch,
            "shape": list(case.shape),
            "full_case": batch == case.batch,
            "throughput": round(med_rate, 2),
            "throughput_min": round(min(rates), 2),
            "throughput_max": round(max(rates), 2),
            "rates_per_rep": [round(r, 2) for r in rates],
            "primed": primed,
            "reps": len(rates),
            "iters": self.iters,
            "unit": ("images/sec" if case.model != "lstm"
                     else "sequences/sec"),
            "step_ms": round(med_step, 2),
            "flops_per_step": flops,
            # None = no MFU (the LSTM, or a count below the one-pass
            # floor); 0.0 would read as a measured zero, which it is not
            "mfu": round(mfu, 4) if mfu is not None else None,
            "device": device_name(self.dev),
        }


def run_case(case, device: torch.device, quick: bool, reps: int) -> dict:
    """A result dict for one benchmark case."""
    r = CaseRunner(case, device, quick)
    if r.tiny:
        reps = 1
        primed = False
    else:
        # priming rep, discarded: the first rep after warm-up still runs
        # lazily loaded kernels' first launches (libvgpu.so measures each
        # under the node's lock where NVML cannot tell processes apart)
        r.one_rep()
        primed = True
    rates, step_ms = [], []
    for _ in range(reps):
        rate, sms = r.one_rep()
        rates.append(rate)
        step_ms.append(sms)
    return r.result(rates, step_ms, primed)
