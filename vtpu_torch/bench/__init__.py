"""The benchmark harness on a GPU: the reference's ai-benchmark matrix,
native and under ``libvgpu.so`` (the port of the JAX package's
``bench.py``).

The reference publishes a 10-case shared-vs-native throughput matrix
(reference README.md:240-252: ResNet-V2-50/152, VGG-16, DeepLab, LSTM;
inference and training) with results only as charts. This harness runs the
same cases and reports machine-readable numbers: img/s (seq/s for the
LSTM), the step time, an MFU column (FLOPs of one step counted by
``torch.utils.flop_counter.FlopCounterMode`` / step time / the card's
published dense bf16 peak) and the shim/native ratio, the cost a tenant
pays for sharing the card.

    python -m vtpu_torch.bench                        # case 1.1, one JSON line
    python -m vtpu_torch.bench --all --interleave     # BENCH_GPU_MATRIX.json
    python -m vtpu_torch.bench --profile --cases 1.1  # libvgpu.so's callsites
    python -m vtpu_torch.bench --parity               # the gated A/B
    VTPU_BENCH_BACKEND=mock python -m vtpu_torch.bench --quick   # no card

Flags (bench.py's): ``--all``, ``--cases 1.1,..``, ``--shim`` (re-exec
under ``libvgpu.so`` with a quota), ``--both`` (with ``--all``: native,
then shim), ``--interleave`` (native and shim reps alternated in one
window), ``--serve`` (the child half of the A/B protocols), ``--profile``
(``--profile-out`` Markdown, ``--profile-json``, ``--profile-baseline``),
``--parity``, ``--reps N`` (default 4, the median reported), ``--quick``
(batch 2, 3 iterations, 1 rep).

Every entry point runs on the card and fails without one, unless
``VTPU_BENCH_BACKEND=mock`` asks for the CPU over the mock ``libcuda.so.1``.
The port writes ``BENCH_GPU_MATRIX.json``, never the JAX package's
``BENCH_MATRIX.json``.

Modules: :mod:`.runner` (``CaseRunner``, ``run_case``), :mod:`.wiring`
(the children's env), :mod:`.serve` (the ``--serve`` protocol and
``run_interleaved``), :mod:`.profile` (``--profile``), :mod:`.parity`
(``--parity``), :mod:`.matrix` (the matrix file), :mod:`.prof` (the reader
of the interposer's callsite profile), ``__main__`` (``main``).

Beside it, each a ``python -m`` entry point of its own: :mod:`.memspace`
(the memory-space probe, hack/memspace_probe.py's port), and the control
plane's host harnesses, which import no torch: :mod:`.sched`
(benchmarks/sched_bench.py), :mod:`.monitor` (benchmarks/monitor_bench.py),
:mod:`.soak` (benchmarks/soak.py, over :mod:`.chaos`'s ``ChaosCluster``)
and :mod:`.serve_ladder` (benchmarks/serve_bench.py).
"""

from __future__ import annotations

import os

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# the published artifact of the port: per-case results of both halves and
# their ratio
MATRIX_FILE = os.path.join(REPO, "BENCH_GPU_MATRIX.json")

# the flagship line's nominal: 390 img/s for one NVIDIA V100, the
# reference's hardware, from public ai-benchmark V100 results scaled to the
# 346x346 case (the reference publishes no number)
V100_NOMINAL_IMGS_PER_SEC = 390.0

# models whose step is a recurrence over timesteps: the reference's FLOP
# estimate counts its body once, so no MFU is ever derived for them
SCAN_MODELS = {"lstm"}

# dense bf16 FLOP/s of a card (the MFU denominator), by a part of
# torch.cuda.get_device_name(); the first match wins
PEAK_FLOPS_BY_NAME = [
    # NVIDIA H100 Tensor Core GPU datasheet, H100 PCIe: 756 TFLOPS bf16
    # dense (1,513 with sparsity)
    ("H100 PCIe", 756e12),
    # the same datasheet, H100 SXM ("NVIDIA H100 80GB HBM3"): 989.4 TFLOPS
    # bf16 dense (1,979 with sparsity)
    ("H100 80GB HBM3", 989.4e12),
]


def peak_flops(device_name: str) -> float:
    """The card's dense bf16 peak; 0 for a card not in the table (its MFU
    is then None) and for the CPU."""
    for key, peak in PEAK_FLOPS_BY_NAME:
        if key in device_name:
            return peak
    return 0.0
