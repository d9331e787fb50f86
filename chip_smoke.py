#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (vtpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path at full width, from a checkout with nothing
built:

1. prints the card (``nvidia-smi`` name and power limit) and the
   torch/CUDA versions;
2. builds the native libraries (vtpu_torch/native.py: libvgpucore.so,
   libvgpu.so) with gcc, beside phases 3-5, which load none of them;
3. case 1.1 phase: ai-benchmark case 1.1, ResNet-V2-50 inference at batch
   50, 346x346x3, 1000 classes, bf16 compute with f32 parameters,
   channels_last, weights from a seeded generator. Warm-up, then timed
   steps (CUDA events); checks the logits' shape, type and finiteness and
   their relative L2 error against the port's own f32 forward of the same
   weights (TF32 off), within the bf16 tolerance of the CPU parity tests
   (5e-2); also runs ``vtpu_torch.entry()`` on the card;
4. case 1.2 phase: ResNet-V2-50 training at batch 20, 346x346x3, 1000
   classes, bf16 compute, the default SGD. Warm-up, then timed steps on
   distinct seeded batches; every loss finite. From the same weights and
   batch, one step three ways: bf16 and f32 (TF32 off) on the card, and
   f32 on the host CPU. The f32 step on the card holds the whole step to
   the CPU's (loss within 1e-4 relative, parameter update within relative
   L2 5e-2); the bf16 step's loss is within 5e-2 of the f32 step's. The
   bf16 update's distance from the f32 update is printed, not gated: at
   initialisation bf16 rounding moves the whole update by about its own
   size, in the JAX reference too (PERF.md). Prints ms/step, img/s and
   peak memory;
5. sharded phase: ``build_sharded_train_step`` on a 1x1 mesh over an NCCL
   group of one rank, from the same weights and batch as the plain step,
   in bf16 and in f32 (TF32 off): in f32 the loss within 1e-4 relative
   and the whole update within relative L2 5e-2 of the plain step's, in
   bf16 the loss within 5e-2. Once case 1.2's steps are timed (phase 4),
   beside the rest of phases 4 and 5, which time nothing:
   ``vtpu_torch.dryrun_multichip(1)`` and case 1.2's peak
   ``max_memory_reserved()`` alone under the two other allocators (phase
   7), each a process of its own outside the interposer;
6. F1 fill phase: at a 3 GiB and a 12 GiB quota a child under
   ``libvgpu.so`` allocates 64 MiB at a time until refused. libvgpu.so
   charges the process's footprint (the memory the driver holds for it
   that no allocation call reaches: the context, modules) beside its
   allocations, so the card's used memory grows by at most 1.02x the
   quota while the child holds its fill (and, where NVML lists the child
   under a pid of its own, so does its ``used_memory``). No quota'd child
   of the script may log that NVML was unavailable (its footprint
   unmeasured). Then a neighbour: one child allocates 4 GiB while another,
   at a 3 GiB quota, makes its context (the first once its lock is taken;
   the neighbour runs outside the interposer, since an interposed one holds
   its allocations while a measurement runs).
   Where NVML cannot tell processes apart, the growth the second measured
   holds the 4 GiB, and it must be charged the node's context size (the
   run's record of quiet readings) and fill its quota less that; where
   NVML lists it under a pid of its own, its charge must not hold the
   neighbour's bytes. Tried up to 3 times until the allocation lands inside
   the measurement. Every interposed child shares the run's own lock
   directory (``VGPU_LOCK_DIR``), under the run's temp dir. Then F6: a
   child at a 3 GiB quota runs case 1.1 for 5 steps (its kernels loaded
   lazily, its local memory grown: where NVML cannot tell processes apart,
   libvgpu.so measures the card's growth at each function's first launch)
   and fills its quota: the card grows by at most 1.02x the quota, what it
   shows beyond the region's charge is at most 2% of the quota, and the
   charge beyond the card's growth at most 5% (so a blanket allowance
   fails); the first step's time and the first launches' cost are printed,
   and the residue's split: the pages the card grew by across allocations
   that are not whole 2 MiB pages and across streams made (a cuDNN
   handle's), each measured and charged as footprint;
   after F6 (before the neighbour), phase (r), code memory
   (``vtpu_torch.bench.codemem``): a child under ``libvgpu.so`` at a 2 GiB
   quota, with no torch, reaches each of the nine routes that load code
   (``cuModuleLoad``, ``cuModuleLoadData``, ``cuModuleLoadDataEx`` on PTX,
   ``cuModuleLoadFatBinary``, ``cuLibraryLoadData``,
   ``cuLibraryLoadFromFile``, ``cuLibraryGetKernel`` with
   ``cuKernelGetFunction``, the globals, a tenant's own ``cuFuncLoad``)
   through ``cuGetProcAddress_v2`` on a module of 256 MiB of ``__device__``
   globals (``vtpu_torch/csrc/codemem_fixture.cu``, built with nvcc for
   sm_90a beside the gcc build), launches its kernel and unloads it: after
   the launch and after the unload the card's growth against the region's
   charge holds F6's two bounds, and where each route's growth landed
   (load, look-up, launch) is printed; 50 load/unload cycles end within
   them, the charge within them of where it began; a 3 GiB module is
   refused with CUDA_ERROR_OUT_OF_MEMORY (the card back within 256 MiB,
   the charge unmoved, a later load served), and a second child under
   ``ACTIVE_OOM_KILLER`` dies by SIGKILL at that load; the region is clean
   after exit; then phase (s), CUDA 13.0's entry points
   (``vtpu_torch.bench.cuda13``): a child under ``libvgpu.so`` resolves
   ``cuCtxSynchronize`` at 13000 and is handed the interposer's
   ``cuCtxSynchronize_v2``, whose call (rc 0) ends the span an f32 GEMM
   opened and charges it within 0.8-1.25x of the GEMM's CUDA-event time,
   and copies through each variant of ``cuMemcpyBatchAsync`` and
   ``cuMemcpy3DBatchAsync`` (12080 and 13000, with and without the
   per-thread stream): each hooked, its bytes arrived, one TRANSFER each
   with them in the region;
   Phases 6 and 7 run one child on the card at a time; each next child
   (and phase 8's children after the last) is started ahead of its turn
   and waits, before its first CUDA call, for the parent to read the card
   and send "go" (``VGPU_SMOKE_HOLD``), so its interpreter loads while the
   child before it runs;
7. quota phases, for case 1.1 (a 12 GiB quota) and case 1.2, each under
   the three PyTorch allocators (the default caching allocator,
   ``expandable_segments:True``, ``backend:cudaMallocAsync``). Case 1.2's
   quota under an allocator is its peak ``max_memory_reserved()`` alone
   under that allocator (phase 4 for the default one, a child without the
   interposer for the others, phase 5) plus the footprint charge of phase 6,
   plus
   25%, rounded up to whole GiB:
   a child started with ``LD_PRELOAD=libvgpu.so`` and its own region file
   calls ``vtpu_torch.enforce.install()`` and runs the case's steps; it
   checks that ``torch.cuda.mem_get_info()`` shows the quota, that the
   region's charge less the footprint charge matches
   ``torch.cuda.memory_reserved()`` within a stated margin, and that one
   allocation past the quota raises
   ``torch.OutOfMemoryError`` and the case still runs after it. The
   parent reads the region as the node monitor does (``RegionView``): the
   child had a slot while it ran, and the region is clean after it exits;
   it also counts the times the interposer trimmed a memory pool at the
   quota (from its log). The card's growth while the child ran, less the
   region's charge (unaccounted), is at most 2% of the quota, and the
   charge less the growth (over-charged) at most 5%;
8. compute-plane phases, each in children with their own region file
   (``--sm-child``, one JSON command and reply per line; every child's
   context made before any is timed; each builds its models one at a
   time, as it is asked: with the children building at once, (b) at 100
   read +23.20% on an H100, where it reads under 1% built in turn), every
   number printed on its own line:

   (a) launch visibility: under ``libvgpu.so`` with no SM limit, the
       region's launch count over one case 1.1 step is at least the number
       of kernels ``torch.profiler`` traces for it; and over one step from
       a host batch to host logits, the region's TRANSFER calls (the copy
       hooks' profile) are at least the Memcpy records it traces, and more
       than none;
   (b) unthrottled cost: case 1.1 and case 1.2 ms/step alone, under
       ``libvgpu.so`` with no SM limit and with ``CUDA_DEVICE_SM_LIMIT=100``
       (where each launch's device time is still measured and charged),
       each the best of 3 timings in turns; case 1.1 within 3% of alone
       (case 1.2's printed: host-bound, it
       spreads between processes);
   (c) solo throttle: case 1.1 at a 50% limit for 6 s, each step
       synchronised, runs at 0.40-0.60x its unthrottled img/s, and the
       device time the region was charged (the slot's ``launch_ns``) is
       0.8-1.1x the unthrottled CUDA-event step time over those steps;
       the run's charges by a kernel key (shape and argument bytes) seen
       before, by a new one, and the argument words left out of their
       function's key (they vary without changing its time) are printed,
       and the new keys' charges stay under 5% of the run's launches;
   (d) two case 1.1 tenants at 70% and 30% at once for 6 s: img/s ratio
       in (1.7, 3.2), each below 0.9x and 0.55x of the solo rate; then,
       printed as their reference, two pods with no limit at once;
   (e) case 1.1's step captured with ``torch.cuda.CUDAGraph`` at a 50%
       limit: the capture succeeds, its logits match the eager step's, and
       replays run at 0.40-0.60x the unthrottled replays;
   (f) feedback: the parent sets ``recent_kernel = FEEDBACK_BLOCK`` on the
       30% tenant's region (priority 1): its region launch count stands
       still while blocked and moves after; ``utilization_switch = 1``
       lifts its throttle (above 0.8x solo);
   (g) gate: the parent lowers the 50% child's region limit to its usage;
       its next step raises an out-of-memory error from the refused
       launch, and after the limit is restored it runs on;
   (h) host ledger: pinned tensors up to a 1 GiB
       ``CUDA_HOST_MEMORY_LIMIT`` are charged to the region's host ledger,
       one past it raises and the process runs on, ``cudaHostRegister``
       and ``cudaHostUnregister`` charge and uncharge; each child's region
       is clean after it exits;
9. phase (k), the other models: every case of the reference's matrix
   (ResNet-V2-50 and -152, VGG-16, DeepLab-v3, the stacked LSTM;
   inference and training) alone at its published batch and shape, bf16,
   seeded weights (one warm-up step and 2 timed steps for an inference
   case past 1.x, 1 for a training case), in one child
   under ``libvgpu.so`` with no limit, whose context is made with phase
   8's children and which idles while they run: step
   ms, img/s (sequences/s for the LSTM), peak ``memory_reserved()``, the
   region's launches a step, finite logits and losses; then each of cases
   3.1-5.2 in a quota child with the default allocator, its quota the
   peak alone plus the footprint charge plus 25%, whole GiB, held to the
   quota phases' checks; case 3.1 also in an F6 run-then-fill child at
   its quota;
10. phase (i), the node agent (vtpu_torch/plugin): NVML enumerates the
   cards in this process (its time printed), each card's UUID, name and
   MiB equal to torch's and ``nvidia-smi``'s and its ``/dev/nvidia<minor>``,
   ``/dev/nvidiactl`` and ``/dev/nvidia-uvm`` present; each card's NUMA
   node and the source that answered (NVML's PCI bus id and sysfs, else
   ``nvidia-smi topo -m``, else 0) are printed. The chart
   deploy/helm/vgpu is rendered (``vtpu_torch.deploy``) with only its
   node-local paths and ports replaced through its own values (the shim
   host dir, kubelet's socket dir, a serving cert made with openssl, free
   ports), and the argv it gives the device plugin, the scheduler
   extender and the monitor is printed on one line. The device plugin
   then runs in a child through its entry point
   (``vtpu_torch.plugin.__main__.main``, the chart's argv, ``NODE_NAME``
   as the DaemonSet sets it) with an in-memory apiserver
   (``FakeKubeClient``); it registers with a fake kubelet, ListAndWatch gives
   10 x cards healthy replicas and the register annotation decodes to the
   NVML inventory. The port's scheduler (``vtpu_torch.scheduler.__main__
   .main``, the chart's argv: TLS, ``--ha`` on the in-memory lease) then
   runs in a thread of the plugin's process on the same apiserver, its
   HTTPS app on the chart's webhook port; the script plays only the
   API server and kube-scheduler: it POSTs an AdmissionReview to
   ``/webhook`` (the patch sets ``schedulerName`` vtpu-scheduler and
   injects the priority), creates the mutated pod, POSTs ``/filter`` with
   the node list (the winner is the card's node) and ``/bind``; the
   assignment names the card's UUID at ``gpumem`` 12288 MiB and
   ``gpucores`` 50 at bind-phase ``allocating``, each call's latency
   printed. A license minted with a test secret for this host lies in the
   shim host dir. Then kubelet: Allocate over the plugin's socket (its
   latency printed); bind-phase turns ``success``; the response mounts the
   license and the ``vgpu-validator`` the plugin installed, which the pod
   child (the secret in its env, as from a Secret) runs from the mount's
   host path: exit 0 on the license, 1 on a copy with one signed line
   changed. The plugin process imported no
   torch and took no device memory or context. A case 1.1
   ``--sm-child`` started with only the response's env and mounts
   (vtpu_torch/plugin/runtime.py) sees a
   12 GiB ``mem_get_info`` total, is refused one allocation past it and
   runs on, runs at 0.40-0.60x phase (c)'s unthrottled img/s for 6 s, and
   its region at the mount's host path carries the limit, the SM limit 50
   and its slot, and is clean after it exits. One scrape of the
   scheduler's metrics port holds every selector of the GPU dashboards
   (docs/gpu/dashboard.json, deploy/grafana/gpu-shim-profile.json) that
   names a scheduler family (vtpu_torch/dashboards.py): each names a
   family the scheduler declares and a sample its type serves, and each
   family this phase fills (``SCHEDULER_FILLED``) has one;
11. phase (j), the node monitor (vtpu_torch/monitor) over phase (i)'s
   plugin: the monitor runs in a child through its entry point
   (``vtpu_torch.monitor.__main__.main``, the chart's argv:
   ``--sweep-interval 1``) with an in-memory apiserver, over the plugin's
   containers directory, and pods
   are case 1.1 ``--sm-child`` children started from Allocate responses
   (``gpumem`` 12288 MiB): pods H, L and F are allocated and their
   processes started ahead of their turns (``VGPU_SMOKE_HOLD``): H as the
   monitor starts, L beside U's and U2's step, F as L exits (a held pod's
   region exists from its import on, so never while a pod alone is
   measured). Pod H alone (priority 0, ``gpucores`` 50) is
   released (``utilization_switch`` 1) within 3 sweeps and runs at >= 0.95x
   phase (c)'s unthrottled img/s; the memory gauges match its quota, its
   ``memory_reserved()`` and footprint charge (within 256 MiB), NVML's
   capacity and the pods' sum; ``HostCoreUtilization`` over two scrapes
   10 s apart is 0.8-1.1x its busy share (phase (b)'s CUDA-event step time
   over wall time), and so it is for pod U with no SM limit alone; pod U2,
   case 1.2 (host bound) with no SM limit, is held to its own device time
   (torch.profiler's kernels, copies and sets per step, over wall time),
   since a host-bound step's CUDA-event time holds its host's gaps and
   (b)'s was another process's on another moment's host (its ratio to
   that, libvgpu.so's charge over its run and its region's share of the
   window are printed beside). Pod L (priority 1, ``gpucores`` 50) joins
   while H runs: both throttled and L blocked within 3 sweeps, L's region
   launches stand still for 5 s, H runs at 0.40-0.60x; inside those 5 s
   one scrape of the monitor holds the dashboards' monitor selectors as
   (i) holds the scheduler's (``MONITOR_FILLED``), and the quota-leakage
   panel, evaluated by hand on it, reads under 0.02 for every pod. H exits: L is
   unblocked within 3 sweeps and, once H's directory is gone, released
   and at >= 0.95x. Pod F alone under ``GPU_CORE_UTILIZATION_POLICY=force``
   stays throttled at 0.40-0.60x. ``/nodeinfo`` lists each live pod with
   its limit and usage; the sweep latency is printed; the monitor took no
   context and no device memory; every region is clean after its pod
   exits; the phase takes under 120 s, pod U2's time apart;
11a. phase (o), one live move (``python -m vtpu_torch.scheduler.livemove``
   in a child that imports no torch): the port's scheduler with the
   rebalancer and the migration planner on (``VTPU_REBALANCE_S``,
   ``VTPU_MIGRATE_S``), a device plugin and a node monitor (its drain
   coordinator, feedback loop and ``/nodeinfo``) for each of two nodes
   that both register this card (node to node for the scheduler, card to
   the same card physically), on one in-memory apiserver; MigratableModel
   pods (``vtpu_torch.models.offload``: dim 1024, layers 4096 x 3, batch
   256, 453,181,452 B of f32 parameters and Adam moments pinned on the
   host under a 1 GiB ``CUDA_HOST_MEMORY_LIMIT``) under ``libvgpu.so``,
   each started from its node's ``Allocate`` response. The source's host
   ledger grows at setup by 1.00-1.01x the state (charged by libvgpu.so
   where the driver pins it, no cooperative charge beside), its snapshot
   adds exactly the state, its region launches stand still from the
   monitor's block to 2 s past the cutover, the cutover moves the
   assignment to the second node, the destination resumes and attaches,
   then the source's snapshot charge is released to the byte; the
   destination's 3 losses after the resume equal a control pod's (rel
   1e-6, abs 1e-7); the card's used memory is back within 256 MiB; each
   protocol step's time, the planner's blackout and the step's ms are
   printed;
11b. phase (p), serving (vtpu_torch.models.serving,
   vtpu_torch.gateway), alone on the card, its three children (under
   ``libvgpu.so``, each its own region file) and the parent's reference
   weights started beside phase (o), drawing their weights on the host
   before any touches the card: the model at
   dim 8192, hidden 28672, classes 8192, f32 (Llama-2-70B's hidden and
   MLP widths). (p1) a gang of two pods with the mesh env the plugin's
   ``_pod_mesh_env`` writes for a 2x1x1 slice gang (set here, as the north
   star sets Allocate's env: a two-host gang on one card needs host
   coordinates NVML does not give), 3 GiB each: each holds its 14,336-wide
   shard (939,581,440 B), serves the same 8 seeded batches of 64 rows,
   and its region's charge is at least its shard and under its quota; the
   partials summed equal the unsharded forward on the card (f32, TF32
   off) within relative L2 1e-5, and at the JAX defaults (64/256/16)
   within max abs 1e-4; the regions are clean after the exits. (p2) one
   pod under 8 GiB holds two solo replicas (1,879,162,880 B each) behind
   ``ReplicaSet`` and ``Router`` with ``ReplicaBatcher``'s defaults (batch
   1-64, queue 256, SLO 50 ms); after a first pass over every batch
   bucket, 3 tenants' open-loop arrivals at 2,000 requests/s for 5 s (the
   loop submits and steps on ``time.perf_counter``): every request done
   exactly once, none shed, each result row within relative L2 1e-4 of
   its replica's forward of that row alone, recompiles equal to the
   buckets reached and none past the first pass, both replicas served,
   the region's charge at least both replicas and under the quota. The
   request latency p50/p99, requests/s, mean batch and step ms are
   printed with the card's name and power limit;
11bb. phase (q), the memory-space probe (``vtpu_torch.bench.memspace``,
   the port of hack/memspace_probe.py), alone on the card after (p): its
   child, started ahead and held, runs under ``libvgpu.so`` with a 4 GiB
   device quota and a 1 GiB host limit and places 64 MiB (16 Mi f32) in
   device memory, pinned host memory (``pin_memory=True``), pageable host
   memory, registered host memory (``cudaHostRegister``) and managed
   memory (``cuMemAllocManaged`` through ``cuGetProcAddress_v2``). Gates,
   exact: the device placement charged its bytes; the pinned, pageable and
   registered ones 0 B of the device quota (the charge less the footprint
   charge, after a warm-up); pinned and registered charged their bytes to
   the host ledger, pageable 0 B; a pinned allocation past the host limit
   refused; managed memory charged to the device quota and an allocation
   past the quota refused with CUDA_ERROR_OUT_OF_MEMORY; every charge back
   to 0 after the frees; the region clean after the child exits. The
   in-device touch and the copies (CUDA events, median of 20) printed
   beside their bounds (HBM3 3.35 TB/s, PCIe Gen5 x16 64 GB/s), not gated;
11c. phase (n), the scheduler at cluster scale: ``python -m
   vtpu_torch.scheduler.loadtest`` in a child that imports no torch runs
   the port's scheduler daemon on an in-memory apiserver of 1,024 nodes x
   8 of this card (its NVML type string and MiB, 10 replicas a card, NUMA
   0,0,0,0,1,1,1,1, no mesh coordinate) and sends 8,192 seeded pods
   (1-card at 3,072 / 12,288 / 20,480 MiB and 25 / 50 / 100 cores, 2- and
   4-card with and without ``numa-bind``, whole-node 8-card) through
   ``/webhook``, ``/filter`` and ``/bind``. Gates, from the pods'
   annotations: no card past its replicas, MiB or 100 cores; every
   numa-bind pod inside one NUMA node; no pod refused that a plain
   first-fit over the same recomputed usage places at that point of the
   stream; the card's used memory and compute processes unmoved while it
   runs (5 s alone, then beside phase (l)). Prints /filter p50 and p99
   (and /webhook's, /bind's), binds a
   second, placed and refused counts and the phase's time;
12. phase (l), the north star: ``python -m vtpu_torch.northstar`` with 4
   pods of case 1.1 at 3 GiB each for 6 s (each a child under
   ``libvgpu.so`` with its own region), then ``--tight`` (calibrated
   quotas that bind, a training configuration, quotas summing past the
   card) at 4 s. Every pod exits clean, the last pod's allocation past its
   quota is refused, every pod's leakage is under 2% by the card's drop at
   its exit, the leakage is cross-checked, the headroom canary's
   under-count is under 2% of the quotas, and ``tight_met`` holds; the
   phase prints its time. Once (n) has ended, the control plane's host
   harnesses run one after another beside (l), each a short process that
   imports no torch (``python -m vtpu_torch.bench.sched --smoke``,
   ``vtpu_torch.bench.monitor --smoke``, ``vtpu_torch.bench.soak``'s four
   legs at the JAX smoke tests' arguments, the elastic and migrate legs
   with ``--waves``). Gates: each exits 0 with its result's gates held
   (overlay drift and double-booked cards 0, the monitor's steady-state
   LIST count 0), no torch, jax or vtpu module loaded, and none of their
   processes holding a device file or a CUDA library, (n)'s check beside
   (l);
13. phase (m), the bench (``python -m vtpu_torch.bench``, each mode a
   command as a user runs it, from a temp dir): the default mode (case
   1.1 at batch 50) within 0.9-1.1x phase (b)'s img/s alone, its MFU in
   (0, 1]; ``--profile --cases 1.1`` (every libvgpu.so call timed): its
   ``execute`` calls within 1% of the child's region launches, ``buf_alloc``
   calls, the top cost centers printed; ``--parity --cases 1.1 --reps 1``
   against that profile as its baseline (``VTPU_PARITY_P50X=0.5``: a
   self-check that the profile half runs): the shim/native best-rep ratio
   at least 0.95; ``--interleave --quick --cases 1.1,3.1``, beside the
   profile mode (no gate times either): both halves of both cases,
   nothing written; the profile's table has ``transfer`` and
   ``done_with_buffer`` rows; then case 1.1 under libvgpu.so with the
   profile on and off (``VTPU_PROFILE=0``), one rep each, the cost
   printed, not gated;
14. prints the port's native components (the JAX package has no TPU kernel,
   so ``kernels`` is empty) and, last, ``{"ok": true, "device": ...}``.

Every phase prints its wall time on a line of its own ("... the phase took
N s"), and the script its own before the JSON lines.

Any failed phase ends the run with a non-zero exit and no final line. So
does a machine without CUDA, or a directory without the repository.
"""

from __future__ import annotations

import contextlib
import fcntl
import json
import math
import os
import re
import select
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time
from concurrent import futures

T_START = time.perf_counter()  # the script's start, for its wall time
ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# The measured machine's interpreter runs with PYTHONDONTWRITEBYTECODE=1
# over site-packages that hold no bytecode, so each process compiled
# torch's Python sources anew: `import torch` took 8.9-10.7 s there, and
# the run starts some hundred such processes (PERF.md section 4). The run
# keeps the bytecode its processes compile in a temp dir of its own, which
# every child inherits, and removes it at its exit.
PYCACHE_ENV = "VGPU_SMOKE_PYCACHE"
if not os.environ.get(PYCACHE_ENV):
    import atexit

    os.environ[PYCACHE_ENV] = tempfile.mkdtemp(prefix="vgpu-smoke-pyc-")
    atexit.register(shutil.rmtree, os.environ[PYCACHE_ENV], True)
os.environ["PYTHONPYCACHEPREFIX"] = os.environ[PYCACHE_ENV]
os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
sys.pycache_prefix = os.environ[PYCACHE_ENV]
sys.dont_write_bytecode = False
T_IMPORT = time.perf_counter()

import torch  # noqa: E402

from vtpu_torch import api, dashboards, native  # noqa: E402
from vtpu_torch.bench import codemem, cuda13, memspace  # noqa: E402
from vtpu_torch.enforce import install  # noqa: E402
from vtpu_torch.enforce.region import (  # noqa: E402
    FEEDBACK_BLOCK,
    FEEDBACK_IDLE,
    RegionView,
)
from vtpu_torch.models import BENCH_CASES, case_model, get_model  # noqa: E402
from vtpu_torch.models.train import (  # noqa: E402
    build_sharded_train_step,
    init_model,
    make_infer_step,
    make_mesh,
    make_train_step,
)

IMPORT_S = time.perf_counter() - T_IMPORT  # torch and the port, compiled
CASES = {c.case: c for c in BENCH_CASES}
GiB = 1 << 30
MiB = 1 << 20
INFER_QUOTA = 12 * GiB
ALLOCATORS = ("", "expandable_segments:True", "backend:cudaMallocAsync")
# bf16 against the f32 computation: the CPU parity tests' tolerance
BF16_REL = 5e-2
# two f32 implementations of one loss (card without TF32, host CPU)
F32_REL = 1e-4
# region charge minus the footprint charge (the memory the driver holds for
# the process that no allocation call reaches, which libvgpu.so charges
# too) minus torch.cuda.memory_reserved(): device memory that libraries in
# the process take with cuMemAlloc outside PyTorch's allocator, per thread
# that uses them. Measured on an H100 (PERF.md) at 67,266,308 B for
# inference and twice that for training, whose backward runs on autograd's
# own thread; the margin leaves room for library versions that take more.
RESERVED_MARGIN = 256 << 20
# a training case's quota under an allocator, and each new case's quota in
# phase (k): its peak reserved memory alone under that allocator plus the
# process's footprint charge, plus this share (a cudaMallocAsync pool
# reserves ~1.3x what the caching allocator does for the same steps,
# PERF.md)
TRAIN_HEADROOM = 0.25
# what libvgpu.so logs (LIBCUDA_LOG_LEVEL=3) when it trims a pool at the quota
TRIM_LOG = "memory pool at the quota, trimmed"
WARMUP = 3
# timed steps: 10 for cases 1.x; phase (k) times the other cases' steps
# fewer (the LSTM's training step runs ~96,000 launches, 2.2-2.4 s), after
# one warm-up step (its kernels loaded, its allocator's cache grown), to
# keep the script inside its time: 2 an inference case, 1 a training case
# (3 and 2 before the script was cut to 1,000 s; (k)'s gates are finite
# outputs and the quota checks, none a time)
STEPS = {c.case: 10 if c.case.startswith("1.") else
         2 if c.mode == "inference" else 1 for c in BENCH_CASES}
WARMUPS = {c.case: WARMUP if c.case.startswith("1.") else 1
           for c in BENCH_CASES}
CHILD_TIMEOUT_S = 300
# what libvgpu.so logs, whatever its log level, when NVML cannot measure a
# quota'd process's footprint at all, and when it can measure only its
# context's size at creation
NVML_MISSING_LOG = "NVML unavailable"
CONTEXT_ONLY_LOG = "cannot tell this process apart"
# a child started ahead of its turn ("held") reads one line from stdin
# before it does anything else: its interpreter and imports load while the
# child before it runs, and it reaches the card only once the parent has
# read the card and sent "go"
HOLD_ENV = "VGPU_SMOKE_HOLD"
# children started ahead of their turn, stopped at exit where still running
_HELD: list = []


class SmokeFailure(Exception):
    pass


# A host's probe outside every process list makes a CUDA context for ~110 ms
# every 120 s (~0.5 GB; NVML sampled every ms on the H100 host, PERF.md):
# it only adds to the card's used memory, for less than CARD_READ_S. What
# the card holds for the run's processes, read while they hold still, is the
# least it shows over CARD_READ_S.
CARD_READ_S = 0.25


def card_free() -> int:
    """the card's free bytes (torch.cuda.mem_get_info), the most over
    CARD_READ_S"""
    most, until = 0, time.perf_counter() + CARD_READ_S
    while True:
        most = max(most, torch.cuda.mem_get_info()[0])
        if time.perf_counter() >= until:
            return most
        time.sleep(0.01)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def phase_took(label: str, t0: float, name: str) -> float:
    """prints the wall time of the phase ``label`` begun at ``t0``
    (time.perf_counter) on a line of its own; its seconds"""
    took = time.perf_counter() - t0
    print(f"{label} the phase took {took:.1f} s; on {name}", flush=True)
    return took


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


def per_pixel(case) -> bool:
    """whether ``case`` labels every pixel (segmentation)"""
    return case.model == "deeplab_v3"


def unit(case) -> str:
    return "seq/s" if case.model == "lstm" else "img/s"


def make_batch(case, seed: int):
    """A seeded batch of ``case`` on the card in the JAX layout (NHWC
    images, [b, T, F] sequences), and its labels ([b, h, w] for
    segmentation)."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((case.batch,) + case.shape, generator=gen)
    labels = (case.batch,) + (case.shape[:2] if per_pixel(case) else ())
    y = torch.randint(0, case.classes, labels, generator=gen)
    return x.cuda(), y.cuda()


def build_model(case, dtype: torch.dtype, seed: int = 0):
    """``case``'s model at its published shape on the card, channels_last
    (the LSTM has no 4-d tensor to lay out), with weights from ``seed``."""
    model = case_model(case, dtype, device="cuda").to(
        memory_format=torch.channels_last)
    init_model(model, make_batch(case, seed)[0],
               torch.Generator().manual_seed(seed + 1))
    return model


def time_steps(run, steps: int, warmup: int = WARMUP):
    """``warmup`` calls, then ``steps`` calls of ``run(i)``: (outputs of
    the timed calls, device ms per step from CUDA events, host ms per
    step)."""
    for i in range(warmup):
        run(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    outs = [run(warmup + i) for i in range(steps)]
    end.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / steps
    return outs, start.elapsed_time(end) / steps, host_ms


def run_case(case, model, steps: int, warmup=None):
    """The case's steps on its model, after ``warmup`` steps (its WARMUPS
    unless given): (last output, ms, host ms, img/s). Inference reuses one
    batch; training takes a distinct seeded batch each step and checks that
    every loss is finite."""
    warmup = WARMUPS[case.case] if warmup is None else warmup
    if case.mode == "inference":
        x, _ = make_batch(case, 0)
        step = make_infer_step(model)
        outs, ms, host_ms = time_steps(lambda i: step(x), steps, warmup)
        check_logits(case, outs[-1])
    else:
        batches = [make_batch(case, 100 + i) for i in range(warmup + steps)]
        step, _ = make_train_step(model)
        dropout = torch.Generator(device="cuda").manual_seed(7)
        outs, ms, host_ms = time_steps(
            lambda i: step(*batches[i], dropout), steps, warmup)
        losses = torch.stack(outs)
        check(bool(torch.isfinite(losses).all()),
              f"case {case.case}: non-finite loss in {losses.tolist()}")
    return outs[-1], ms, host_ms, case.batch / (ms / 1e3)


def check_logits(case, out: torch.Tensor) -> None:
    want = (case.batch,) + (case.shape[:2] if per_pixel(case) else ()) + (
        case.classes,)
    check(tuple(out.shape) == want, f"case {case.case}: logits shape "
          f"{tuple(out.shape)}, not {want}")
    check(out.dtype == torch.float32, f"logits dtype {out.dtype}")
    check(bool(torch.isfinite(out).all()), "non-finite logits")


class NoTF32:
    def __enter__(self):
        self.saved = (torch.backends.cudnn.allow_tf32,
                      torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = self.saved


def rel_l2(got: torch.Tensor, ref: torch.Tensor) -> float:
    return float((got.double() - ref.double()).norm() / ref.double().norm())


def infer_phase(name: str) -> dict:
    case = CASES["1.1"]
    model = build_model(case, torch.bfloat16)
    torch.cuda.reset_peak_memory_stats()
    out, ms, host_ms, img_s = run_case(case, model, STEPS["1.1"])
    peak = torch.cuda.max_memory_allocated()
    x, _ = make_batch(case, 0)
    with NoTF32():
        ref_model = get_model(case.model, num_classes=case.classes,
                              dtype=torch.float32, device="cuda").to(
            memory_format=torch.channels_last)
        ref_model.load_state_dict(model.state_dict())
        ref = make_infer_step(ref_model)(x)
    rel = rel_l2(out, ref)
    check(rel <= BF16_REL, f"bf16 logits rel L2 {rel} > {BF16_REL}")

    import vtpu_torch
    fn, args = vtpu_torch.entry()
    eout = fn(*args)
    check(tuple(eout.shape) == (8, 1000)
          and bool(torch.isfinite(eout).all()), "entry() logits")

    print(f"case 1.1 native: ResNet-V2-50 bf16 batch {case.batch} "
          f"{case.shape[0]}x{case.shape[1]}: {ms:.3f} ms/step (CUDA events, "
          f"{STEPS['1.1']} steps), host {host_ms:.3f} ms/step, "
          f"{img_s:.1f} img/s, bf16-vs-f32 rel L2 {rel:.3e}, peak allocated "
          f"{peak} B; on {name}", flush=True)
    del model, ref_model, x, out, ref, fn, args, eout
    torch.cuda.empty_cache()
    return {"phase": "case 1.1 native", "step_ms": ms,
            "host_step_ms": host_ms, "img_s": img_s,
            "rel_l2_bf16_vs_f32": rel, "peak_allocated_bytes": peak}


def one_step(model, params, step, x, y):
    """(loss, {name: new - old}) of one ``step`` over ``params``."""
    def whole(p):
        p = p.detach()
        return p.full_tensor() if hasattr(p, "full_tensor") else p
    old = {n: whole(p).clone() for n, p in params.items()}
    loss = step(x, y)
    return float(loss), {n: whole(p) - old[n] for n, p in params.items()}


def flat(update: dict, names=None) -> torch.Tensor:
    return torch.cat([update[n].double().flatten()
                      for n in sorted(names or update)])


def train_phase(name: str, timed) -> dict:
    """Case 1.2's timed steps, then ``timed()`` (work that may run beside
    what follows, which times nothing), then one step three ways."""
    case = CASES["1.2"]
    model = build_model(case, torch.bfloat16)
    torch.cuda.reset_peak_memory_stats()
    _, ms, host_ms, img_s = run_case(case, model, STEPS["1.2"])
    peak_alloc = torch.cuda.max_memory_allocated()
    peak_reserved = torch.cuda.max_memory_reserved()
    del model
    torch.cuda.empty_cache()
    timed()

    # one step from the same weights and batch: bf16 and f32 (TF32 off) on
    # the card, and f32 on the host CPU as an independent implementation
    x, y = make_batch(case, 0)
    model = build_model(case, torch.bfloat16)
    with NoTF32():
        ref_model = get_model(case.model, num_classes=case.classes,
                              dtype=torch.float32, device="cuda").to(
            memory_format=torch.channels_last)
        ref_model.load_state_dict(model.state_dict())
        ref_loss, ref_up = one_step(ref_model,
                                    dict(ref_model.named_parameters()),
                                    make_train_step(ref_model)[0], x, y)
    del ref_model
    cpu_model = get_model(case.model, num_classes=case.classes,
                          dtype=torch.float32, device="cpu")
    cpu_model.load_state_dict(model.state_dict())
    t0 = time.perf_counter()
    cpu_loss, cpu_up = one_step(cpu_model, dict(cpu_model.named_parameters()),
                                make_train_step(cpu_model)[0], x.cpu(),
                                y.cpu())
    cpu_s = time.perf_counter() - t0
    del cpu_model
    loss, up = one_step(model, dict(model.named_parameters()),
                        make_train_step(model)[0], x, y)
    del model
    torch.cuda.empty_cache()
    cpu_up = {n: u.cuda() for n, u in cpu_up.items()}
    f32_loss_rel = abs(ref_loss - cpu_loss) / abs(cpu_loss)
    f32_up_rel = rel_l2(flat(ref_up), flat(cpu_up))
    loss_rel = abs(loss - ref_loss) / abs(ref_loss)
    head = ["head.weight", "head.bias"]
    head_rel = rel_l2(flat(up, head), flat(ref_up, head))
    whole_rel = rel_l2(flat(up), flat(ref_up))
    print(f"case 1.2 native: ResNet-V2-50 training bf16 batch {case.batch} "
          f"{case.shape[0]}x{case.shape[1]}, SGD momentum 0.9: {ms:.3f} "
          f"ms/step (CUDA events, {STEPS['1.2']} steps), host "
          f"{host_ms:.3f} ms/step, {img_s:.1f} img/s; "
          f"max_memory_allocated {peak_alloc} B, max_memory_reserved "
          f"{peak_reserved} B; on {name}", flush=True)
    print(f"case 1.2 one step, same weights and batch: f32 on the card (TF32 "
          f"off) vs f32 on the host CPU ({cpu_s:.1f} s): loss {ref_loss:.6f} "
          f"vs {cpu_loss:.6f} (rel {f32_loss_rel:.3e}), update rel L2 "
          f"{f32_up_rel:.3e}; bf16 vs f32 on the card: loss {loss:.6f} (rel "
          f"{loss_rel:.3e}), head update rel L2 {head_rel:.3e}, whole-model "
          f"update rel L2 {whole_rel:.3e}; on {name}", flush=True)
    check(all(bool(torch.isfinite(u).all()) for u in up.values()),
          "non-finite parameter update")
    check(f32_loss_rel <= F32_REL, f"f32 card vs CPU loss rel "
          f"{f32_loss_rel} > {F32_REL}")
    check(f32_up_rel <= BF16_REL, f"f32 card vs CPU update rel L2 "
          f"{f32_up_rel} > {BF16_REL}")
    check(loss_rel <= BF16_REL, f"bf16 vs f32 loss rel {loss_rel}")
    return {"phase": "case 1.2 native", "step_ms": ms,
            "host_step_ms": host_ms, "img_s": img_s,
            "peak_allocated_bytes": peak_alloc,
            "peak_reserved_bytes": peak_reserved,
            "f32_card_vs_cpu_loss_rel": f32_loss_rel,
            "f32_card_vs_cpu_update_rel_l2": f32_up_rel,
            "loss_rel_bf16_vs_f32": loss_rel,
            "head_update_rel_l2_bf16_vs_f32": head_rel,
            "update_rel_l2_bf16_vs_f32": whole_rel}


def sharded_phase(name: str) -> dict:
    """The sharded step on a 1x1 mesh (NCCL, one rank) against the plain
    step from the same weights and batch, in bf16 and in f32 (TF32 off).
    The f32 pair is held to the f32 tolerance of the loss and to 5e-2 on
    the whole update; the bf16 pair's loss to 5e-2, its update printed
    (bf16 rounding, PERF.md). dryrun_multichip(1) runs beside it
    (:func:`dryrun`)."""
    import torch.distributed as dist

    case = CASES["1.2"]
    x, y = make_batch(case, 0)
    dtypes = {"bf16": (torch.bfloat16, contextlib.nullcontext),
              "f32": (torch.float32, NoTF32)}
    plain, sharded = {}, {}
    for kind, (dtype, mode) in dtypes.items():
        with mode():
            model = build_model(case, dtype)
            plain[kind] = one_step(model, dict(model.named_parameters()),
                                   make_train_step(model)[0], x, y)
        del model
    tmp = tempfile.mkdtemp(prefix="vgpu-smoke-pg-")
    dist.init_process_group("nccl", init_method=f"file://{tmp}/pg",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh("cuda", dp=1, tp=1)
        for kind, (dtype, mode) in dtypes.items():
            with mode():
                model = get_model(case.model, num_classes=case.classes,
                                  dtype=dtype, device="cuda").to(
                    memory_format=torch.channels_last)
                step, (params, _, _) = build_sharded_train_step(
                    model, x, y, mesh, torch.Generator().manual_seed(1))
                sharded[kind] = one_step(model, params, step, x, y)
            del model, params, step
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    result = {"phase": "case 1.2 sharded 1x1"}
    for kind in dtypes:
        (s_loss, s_up), (loss, up) = sharded[kind], plain[kind]
        result[f"{kind}_loss_rel_vs_plain"] = abs(s_loss - loss) / abs(loss)
        result[f"{kind}_update_rel_l2_vs_plain"] = rel_l2(flat(s_up),
                                                          flat(up))
        print(f"case 1.2 sharded {kind}, 1x1 mesh over NCCL: loss "
              f"{s_loss:.6f} vs plain {loss:.6f} (rel "
              f"{result[f'{kind}_loss_rel_vs_plain']:.3e}), update rel L2 "
              f"{result[f'{kind}_update_rel_l2_vs_plain']:.3e}; on {name}",
              flush=True)
    check(result["f32_loss_rel_vs_plain"] <= F32_REL,
          f"sharded vs plain f32 loss rel {result['f32_loss_rel_vs_plain']}")
    check(result["f32_update_rel_l2_vs_plain"] <= BF16_REL,
          f"sharded vs plain f32 update rel L2 "
          f"{result['f32_update_rel_l2_vs_plain']}")
    check(result["bf16_loss_rel_vs_plain"] <= BF16_REL,
          f"sharded vs plain bf16 loss rel {result['bf16_loss_rel_vs_plain']}")
    return result


def dryrun() -> float:
    """``vtpu_torch.dryrun_multichip(1)`` (one spawned rank over NCCL):
    its seconds"""
    import vtpu_torch

    t0 = time.perf_counter()
    vtpu_torch.dryrun_multichip(1)
    return time.perf_counter() - t0


def quota_child(case_name: str, quota: int) -> None:
    """Runs in the child under LD_PRELOAD=libvgpu.so."""
    case = CASES[case_name]
    enf = install()
    check(enf.interposed, "libvgpu.so is not active in the child")
    check(enf.limit() == quota, f"quota {enf.limit()} != {quota}")
    model = build_model(case, torch.bfloat16)
    out, ms, host_ms, img_s = run_case(case, model, STEPS[case_name])
    free, total = torch.cuda.mem_get_info()
    used = enf.used()
    fp = enf.footprint()
    reserved = torch.cuda.memory_reserved()
    check(total == quota, f"mem_get_info total {total} != quota {quota}")
    check(free == quota - used, f"mem_get_info free {free} != quota - "
          f"region used {quota - used}")
    check(fp["mode"] in ("nvml_pid", "context"),
          f"no footprint charged: {fp}")
    gap = used - fp["bytes"] - reserved
    check(0 <= gap <= RESERVED_MARGIN,
          f"region used {used} less the footprint charge {fp['bytes']} vs "
          f"memory_reserved {reserved}: gap {gap} B outside [0, "
          f"{RESERVED_MARGIN}]")
    try:
        torch.empty(quota, dtype=torch.uint8, device="cuda")
        raise SmokeFailure("an allocation past the quota succeeded")
    except torch.OutOfMemoryError:
        pass
    # the case runs on past the refusal: one step, its kernels warm
    after, _, _, _ = run_case(case, model, 1, warmup=0)
    torch.cuda.synchronize()
    if case.mode == "inference":
        drift = rel_l2(after, out)
        check(drift <= BF16_REL, f"logits moved by {drift} after the "
              f"refusal")
    print(json.dumps({"pid": os.getpid(), "step_ms": ms,
                      "host_step_ms": host_ms, "img_s": img_s,
                      "footprint": fp,
                      "loss_after_refusal": float(after)
                      if case.mode == "training" else None,
                      "region_used": enf.used(),
                      "reserved_at_check": reserved,
                      "used_at_check": used,
                      "memory_reserved": torch.cuda.memory_reserved(),
                      "max_memory_reserved": torch.cuda.max_memory_reserved(),
                      "max_memory_allocated":
                          torch.cuda.max_memory_allocated()}),
          flush=True)
    sys.stdin.readline()  # the parent reads the region meanwhile


def peak_child(case_name: str) -> None:
    """Runs in a child, alone, under the allocator its env names: the
    case's steps, then its peak reserved memory as one JSON line."""
    case = CASES[case_name]
    run_case(case, build_model(case, torch.bfloat16), STEPS[case_name])
    print(json.dumps({"max_memory_reserved":
                      torch.cuda.max_memory_reserved()}), flush=True)


def alone_peak(case_name: str, alloc_conf: str) -> int:
    """``case_name``'s peak ``max_memory_reserved()`` under ``alloc_conf``
    (PYTORCH_CUDA_ALLOC_CONF), from a child without the interposer."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("CUDA_DEVICE_", "CUDA_DISABLE", "LD_PRELOAD",
                                "PYTORCH_CUDA_ALLOC_CONF"))}
    env.update({"PYTHONPATH": ROOT, "PYTORCH_CUDA_ALLOC_CONF": alloc_conf})
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--peak-child",
         case_name], env=env, capture_output=True, text=True,
        timeout=CHILD_TIMEOUT_S)
    check(proc.returncode == 0, f"case {case_name} peak child "
          f"({alloc_conf}) rc {proc.returncode}:\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])[
        "max_memory_reserved"]


_LOCK_DIR = []


def run_lock_dir() -> str:
    """The node's lock directory of this run (libvgpu.so's context lock and
    its record of context sizes), shared by the run's interposed children
    and made under the run's own temp dir; main removes it."""
    if not _LOCK_DIR:
        _LOCK_DIR.append(tempfile.mkdtemp(prefix="vgpu-smoke-locks-"))
    return _LOCK_DIR[0]


def child_env(alloc_conf: str, quota):
    """(temp dir, region file, env) for a quota child: libvgpu.so
    preloaded, ``quota`` bytes (None: no memory limit), its own region file
    under .../containers/<pod uid>_0/, the run's lock directory, and
    ``alloc_conf`` as PYTORCH_CUDA_ALLOC_CONF ("" = PyTorch's default
    allocator)."""
    tmp = tempfile.mkdtemp(prefix="vgpu-smoke-")
    cache = os.path.join(tmp, "containers", "smoke-pod_0", "vgpu.cache")
    os.makedirs(os.path.dirname(cache))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("CUDA_DEVICE_", "CUDA_DISABLE",
                                "PYTORCH_CUDA_ALLOC_CONF"))}
    env.update({
        "LD_PRELOAD": native.interposer(),
        "CUDA_DEVICE_MEMORY_SHARED_CACHE": cache,
        api.ENV_LOCK_DIR: run_lock_dir(),
        "PYTHONPATH": ROOT,
    })
    if quota is not None:
        env["CUDA_DEVICE_MEMORY_LIMIT"] = str(quota)
    if alloc_conf:
        env["PYTORCH_CUDA_ALLOC_CONF"] = alloc_conf
    return tmp, cache, env


def check_nvml(err: str, who: str) -> None:
    """``who``'s libvgpu.so measured its footprint: it did not log that
    NVML was unavailable (which leaves the quota blind to the context)."""
    check(NVML_MISSING_LOG not in err, f"{who}: libvgpu.so could not "
          f"measure the footprint: "
          f"{[t for t in err.splitlines() if NVML_MISSING_LOG in t][:1]}")


def check_clean(cache: str) -> None:
    with RegionView(cache) as view:
        check(view.procs() == [] and view.used(0) == 0,
              "region not clean after the child exited")


def held_env(env: dict) -> dict:
    """``env`` for a child started ahead of its turn (HOLD_ENV)"""
    return dict(env, **{HOLD_ENV: "1"})


def stop_held() -> None:
    for child in _HELD:
        if child.proc.poll() is None:
            child.proc.kill()
            child.proc.wait(timeout=60)
        shutil.rmtree(child.tmp, ignore_errors=True)


def pipelined(steps: list, first, name: str) -> list:
    """Runs ``steps``, (start, run) pairs, in order: ``run(child)`` gets
    what ``start()`` returned, its children started ahead. Step k+1's
    ``start`` is called as step k starts, so its interpreters load while
    step k runs; ``first`` is step 0's, started earlier still (step 0's
    ``start`` is not called). Each step's wall time is printed."""
    results, child = [], first
    for k, (_, run) in enumerate(steps):
        upcoming = steps[k + 1][0]() if k + 1 < len(steps) else None
        t0 = time.perf_counter()
        results.append(run(child))
        if isinstance(results[-1], dict):
            phase_took(f"{results[-1]['phase']}:", t0, name)
        child = upcoming
    return results


class QuotaChild:
    """A --quota-child process under libvgpu.so with its own region file
    (LIBCUDA_LOG_LEVEL=3), started ahead of its turn (:meth:`go` gives it
    the card)."""

    def __init__(self, case_name: str, quota: int, alloc_conf: str):
        self.tmp, self.cache, env = child_env(alloc_conf, quota)
        env["LIBCUDA_LOG_LEVEL"] = "3"
        self.errf = open(os.path.join(self.tmp, "child.err"), "w+")
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--quota-child",
             case_name, str(quota)],
            env=held_env(env), stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, stderr=self.errf, text=True)
        _HELD.append(self)

    def go(self) -> None:
        self.proc.stdin.write("go\n")
        self.proc.stdin.flush()


def quota_phase(name: str, case_name: str, quota: int,
                alloc_conf: str, child: QuotaChild) -> dict:
    """``case_name`` under ``quota`` and ``alloc_conf`` in ``child``, a
    QuotaChild of the same arguments; see the module docstring."""
    label = alloc_conf or "default allocator"
    free0 = card_free()
    child.go()
    tmp, cache, errf, proc = child.tmp, child.cache, child.errf, child.proc
    try:
        ready, _, _ = select.select([proc.stdout], [], [], CHILD_TIMEOUT_S)
        line = proc.stdout.readline() if ready else ""
        if not line:
            proc.kill()
            proc.wait(timeout=60)
            errf.seek(0)
            raise SmokeFailure(f"case {case_name} quota child ({label}) "
                               f"failed, rc {proc.returncode}:\n"
                               f"{errf.read()[-4000:]}")
        report = json.loads(line)
        free1 = card_free()
        footprint = free0 - free1  # the child's real device memory
        with RegionView(cache) as view:
            pids = [p.pid for p in view.procs()]
            check(pids == [proc.pid], f"region slots {pids}, child "
                  f"{proc.pid}")
            check(view.hbm_limit(0) == quota, "region limit")
            region_used = view.used(0)
            check(region_used == report["region_used"],
                  f"monitor reads {region_used} B, child charged "
                  f"{report['region_used']} B")
        proc.communicate("exit\n", timeout=CHILD_TIMEOUT_S)
        errf.seek(0)
        err = errf.read()
        check(proc.returncode == 0,
              f"quota child rc {proc.returncode}:\n{err[-4000:]}")
        check_nvml(err, f"case {case_name} quota child ({label})")
        check_clean(cache)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
        errf.close()
        shutil.rmtree(tmp, ignore_errors=True)
    result = dict(report, phase=f"case {case_name} quota ({label})",
                  quota_bytes=quota, device_footprint_bytes=footprint,
                  unaccounted_bytes=footprint - region_used,
                  over_charge_bytes=region_used - footprint,
                  pool_trims=err.count(TRIM_LOG))
    fp = report["footprint"]
    print(f"case {case_name} under libvgpu.so, {quota} B quota, {label}: "
          f"{report['step_ms']:.3f} ms/step (CUDA events), "
          f"{report['img_s']:.1f} {unit(CASES[case_name])}; region charge "
          f"{region_used} B vs memory_reserved {report['memory_reserved']} B "
          f"(at the check: {report['used_at_check']} vs "
          f"{report['reserved_at_check']}), of the charge {fp['bytes']} B "
          f"the process's footprint ({fp['mode']}, {fp['reads']} NVML "
          f"re-reads of {fp['read_ns'] / max(1, fp['reads']) / 1e3:.1f} us "
          f"mean, {fp['read_max_ns'] / 1e3:.1f} us at most); the card's "
          f"memory moved by {footprint} B while the child ran, of it not "
          f"charged {footprint - region_used} B "
          f"({(footprint - region_used) / quota:.4%} of the quota; "
          f"{fp['calls_measured']} first launches, module loads and "
          f"look-ups measured: {fp['load_bytes']} B at loads before a "
          f"launch, {fp['call_bytes']} B across the calls, in "
          f"{fp['measure_ns'] / 1e6:.1f} ms); "
          f"{result['pool_trims']} pool trims at the quota; on {name}",
          flush=True)
    check_f6(f"case {case_name} quota child ({label})", quota, footprint,
             region_used)
    return result


# ---------------------------------------------- F1: the whole footprint.
# A child under libvgpu.so fills its quota 64 MiB at a time until refused;
# the card's used memory says what the process really holds.

FILL_QUOTAS = (3 * GiB, 12 * GiB)
FILL_STEP = 64 << 20
# the process's device memory against its quota: the system's target, under
# 2% leakage (BASELINE.md:29-31)
FILL_LEAKAGE = 0.02


def compute_apps_memory() -> list:
    """(pid, used MiB) of each of the card's compute processes, as
    nvidia-smi lists them"""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader,nounits"], check=True, capture_output=True,
        text=True, timeout=60).stdout
    apps = []
    for line in out.splitlines():
        fields = [v.strip() for v in line.split(",")]
        if len(fields) == 2 and all(v.isdigit() for v in fields):
            apps.append((int(fields[0]), int(fields[1])))
    return apps


def fill_child(quota: int) -> SmChild:
    """F1's child at ``quota``, started ahead"""
    return SmChild(f"F1 fill {quota >> 30} GiB", quota=quota, ahead=True)


def fill_phase(name: str, quota: int, child: SmChild) -> dict:
    """F1: at ``quota`` ``child`` (:func:`fill_child`) allocates 64 MiB at a
    time until libvgpu.so refuses; the card's used memory grew by what the
    process holds, context and all, which must stay within 2% of the
    quota. Where NVML lists the child under a pid of its own, its
    used_memory is held to the same bound."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    free0 = card_free()
    child.go()
    try:
        r = child.ask("fill")
        free1 = card_free()
        apps = compute_apps_memory()
        with child.view() as view:
            region_used = view.used(0)
        child.ask("release")
        child.close()
    finally:
        if child.proc.poll() is None:
            child.proc.kill()
            child.proc.wait(timeout=60)
    fp = r["footprint"]
    held = free0 - free1  # the child's device memory, by the card
    nvml_pid = fp["nvml_pid"] if fp["mode"] == "nvml_pid" else r["pid"]
    own = [mib for pid, mib in apps if pid == nvml_pid]
    nvml_used = own[0] * MiB if len(own) == 1 else None
    print(f"F1 fill at a {quota} B quota: {r['filled']} B in "
          f"{FILL_STEP >> 20} MiB allocations until refused; region "
          f"charge {region_used} B, of it the footprint {fp['bytes']} B "
          f"({fp['mode']}; the card grew by {fp['growth']} B across the "
          f"context's creation, the node's context size on record "
          f"{fp['node_context']} B); mem_get_info free {r['free']} B of "
          f"{r['total']} B; the card's used memory grew by {held} B, "
          f"{held / quota:.4f}x the quota; NVML's compute processes "
          f"(pid, MiB) {apps}: "
          + (f"the child's used_memory {nvml_used} B, "
             f"{nvml_used / quota:.4f}x the quota"
             if nvml_used is not None else
             f"no entry of the child's own (NVML pid {nvml_pid})")
          + (f"; the footprint is the context's size at creation, not "
             f"re-read" if child.context_only else "")
          + f"; on {name}", flush=True)
    check(r["total"] == quota, f"F1 fill: mem_get_info total "
          f"{r['total']}")
    check(fp["mode"] in ("nvml_pid", "context") and fp["bytes"] > 0,
          f"F1 fill: no footprint charged: {fp}")
    check(region_used == r["used"] <= quota
          and r["filled"] + fp["bytes"] <= quota,
          f"F1 fill: charge {region_used} B past the quota")
    check(held <= (1 + FILL_LEAKAGE) * quota, f"F1 fill: the process "
          f"holds {held} B, {held / quota:.4f}x its quota")
    if nvml_used is not None:
        check(nvml_used <= (1 + FILL_LEAKAGE) * quota, f"F1 fill: NVML "
              f"used_memory {nvml_used} B, {nvml_used / quota:.4f}x")
    return {"phase": f"F1 fill {quota >> 30} GiB",
            "quota_bytes": quota, "filled_bytes": r["filled"],
            "region_used": region_used, "footprint": fp,
            "card_delta_bytes": held, "leakage": held / quota - 1,
            "nvml_used_bytes": nvml_used,
            "context_only": child.context_only}


# ------------------------ F6: memory a context takes after its creation.
# Where NVML cannot tell processes apart, libvgpu.so measures the card's
# growth at each function's first launch (lazily loaded modules, local
# memory) as well as at the context's creation.

# what the card shows a quota child holds beyond its region's charge, and
# the charge beyond what the card shows (a blanket allowance would pass the
# first and fail the second), each against the quota
UNACCOUNTED_MAX = 0.02
OVER_CHARGE_MAX = 0.05
# the run-then-fill children: a case's steps, then its quota filled
F6_STEPS = 5


def check_f6(who: str, quota: int, grew: int, region_used: int) -> None:
    """the card's growth while ``who`` ran against its region's charge"""
    check(grew - region_used <= UNACCOUNTED_MAX * quota,
          f"{who}: the card grew by {grew} B, {grew - region_used} B past "
          f"the region's charge of {region_used} B: over "
          f"{UNACCOUNTED_MAX:.0%} of the {quota} B quota unaccounted")
    check(region_used - grew <= OVER_CHARGE_MAX * quota,
          f"{who}: charged {region_used} B, {region_used - grew} B past "
          f"the card's growth of {grew} B: over {OVER_CHARGE_MAX:.0%} of "
          f"the {quota} B quota over-charged")


def run_fill_child(case_name: str, quota: int) -> SmChild:
    """F6's child, started ahead"""
    return SmChild(f"F6 case {case_name} run then fill", quota=quota,
                   ahead=True)


def run_fill_phase(name: str, case_name: str, quota: int,
                   child: SmChild) -> dict:
    """F6: at ``quota`` ``child`` (:func:`run_fill_child`) runs
    ``case_name`` for F6_STEPS steps (its kernels loaded, its local memory
    grown), then fills its quota 64 MiB at a time until refused. The
    card's used memory grows by at most 1.02x the quota; what the card
    shows beyond the region's charge is at most 2% of the quota, the
    charge beyond the card's growth at most 5%."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    free0 = card_free()
    child.go()
    try:
        r = child.ask("run_fill", case=case_name, steps=F6_STEPS)
        free1 = card_free()
        with child.view() as view:
            region_used = view.used(0)
        child.ask("release")
        child.close()
    finally:
        if child.proc.poll() is None:
            child.proc.kill()
            child.proc.wait(timeout=60)
    fp = r["footprint"]
    held = free0 - free1
    print(f"F6 case {case_name} for {F6_STEPS} steps, then a fill at a "
          f"{quota} B quota: {r['filled']} B filled; region charge "
          f"{region_used} B, of it the footprint {fp['bytes']} B ({fp['mode']}"
          f"; {fp['calls_measured']} first launches, module loads and "
          f"look-ups measured: the card grew by {fp['load_bytes']} B at loads "
          f"before a launch and {fp['call_bytes']} B across the calls, "
          f"{fp['shrank']} readings it shrank in, "
          f"{fp['measure_ns'] / 1e6:.1f} ms in all, "
          f"{fp['measure_max_ns'] / 1e6:.3f} ms at most); the card grew "
          f"by {held} B, {held / quota:.4f}x the quota; unaccounted "
          f"{held - region_used} B, over-charged {region_used - held} B; "
          f"first step {r['first_step_ms']:.1f} ms, then "
          f"{r['step_ms']:.1f} ms/step (host clock); on {name}", flush=True)
    print(f"F6 case {case_name}: the residue split: the card grew "
          f"{fp['small_alloc_pages']} B across allocations that are not "
          f"whole pages ({fp['small_alloc_live']} B of them live) and "
          f"{fp['stream_pages']} B across streams made, in "
          f"{fp['object_calls']} calls measured; their pages charged "
          f"{fp['page_charge']} B past the allocations' own; unaccounted "
          f"{held - region_used} B; on {name}", flush=True)
    check(r["total"] == quota, f"F6 fill: mem_get_info total {r['total']}")
    check(region_used == r["used"] <= quota,
          f"F6 fill: charge {region_used} B past the quota")
    check(held <= (1 + FILL_LEAKAGE) * quota, f"F6 fill: the process holds "
          f"{held} B, {held / quota:.4f}x its quota")
    check_f6(f"F6 case {case_name} run then fill", quota, held, region_used)
    return {"phase": f"F6 case {case_name} run then fill",
            "quota_bytes": quota, "filled_bytes": r["filled"],
            "region_used": region_used, "footprint": fp,
            "card_delta_bytes": held, "leakage": held / quota - 1,
            "unaccounted_bytes": held - region_used,
            "first_step_ms": r["first_step_ms"], "step_ms": r["step_ms"]}


# ------------------------------------------------------ (r) code memory.
def codemem_children(fixtures: str) -> dict:
    """phase (r)'s two children (vtpu_torch.bench.codemem), started ahead
    and held before their first CUDA call"""
    tmp = tempfile.mkdtemp(prefix="vgpu-smoke-codemem-")
    children = codemem.start(tmp, "cuda", run_lock_dir(), fixtures=fixtures)
    for child in children.values():
        child.tmp = tmp
        _HELD.append(child)
    return children


def codemem_phase(name: str, children: dict) -> dict:
    """Phase (r), alone on the card (it reads the card's memory): every
    entry point that loads code charged against the card's growth, a load
    past the quota refused (killed under ACTIVE_OOM_KILLER), an unload's
    charge given back; see the module docstring."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    total = torch.cuda.mem_get_info()[1]
    try:
        res = codemem.phase(children, lambda: total - card_free())
    finally:
        for child in children.values():
            child.kill()
        shutil.rmtree(children["pod"].tmp, ignore_errors=True)
    q = res["quota_bytes"]
    print(f"(r) code memory at a {q} B quota, a {res['fixture_bytes']} B "
          f"module: footprint mode {res['footprint_mode']}, context "
          f"{res['context_charge']} B in {res['context_ms']:.1f} ms; every "
          f"entry point hooked {all(res['hooked'].values())}; on {name}",
          flush=True)
    for route, r in res["routes"].items():
        (grew, charged), (grew2, charged2) = r["open"], r["closed"]
        print(f"(r) {route}: charged {r['charged']} (lands at the "
              f"{r['lands']}); the card grew by {r['card_grew']} B; after "
              f"the launch unaccounted {grew - charged} B, over-charged "
              f"{charged - grew} B; the unload released {r['released']} B, "
              f"then unaccounted {grew2 - charged2} B, over-charged "
              f"{charged2 - grew2} B; on {name}", flush=True)
    churn, ref = res.get("churn", {}), res.get("refusal", {})
    print(f"(r) churn: {churn.get('cycles')} load/unload cycles of "
          f"{churn.get('route')} in {churn.get('seconds', 0):.3f} s, "
          f"(card growth, charge) {churn.get('start')} -> "
          f"{churn.get('end')}; a {codemem.BIG_BYTES} B module: rc "
          f"{ref.get('rc')}, (card growth, charge) {ref.get('before')} -> "
          f"{ref.get('after')}, a later load and unload rc "
          f"{ref.get('later_rc')}; under ACTIVE_OOM_KILLER rc "
          f"{res.get('killer_rc')} ({res.get('killer_oom_events')} refusal "
          f"in its region); counters {res.get('counters')}; gates "
          f"{res['gates']}; errors {res['errors']}; on {name}", flush=True)
    failed = [k for k, ok in res["gates"].items() if not ok]
    check(res["ok"], f"(r) failed gates {failed}: {res['errors']}\n"
          f"{res.get('pod_stderr', '')[-2000:]}")
    return {"phase": "(r) code memory", **{
        k: v for k, v in res.items() if not k.endswith("_stderr")}}


# ------------------------------------- (s) CUDA 13.0's entry points.
def cuda13_phase(name: str) -> dict:
    """Phase (s), alone on the card (vtpu_torch.bench.cuda13): a child
    under libvgpu.so resolves cuCtxSynchronize at 13000 and is handed the
    interposer's cuCtxSynchronize_v2, whose call (rc 0, with the context
    and with NULL) ends the span an f32 GEMM opened and charges it within
    0.8-1.25x of its CUDA-event time; each batch copy variant
    (cuMemcpyBatchAsync and cuMemcpy3DBatchAsync at 12080 and 13000, with
    and without the per-thread stream) is hooked, copies its bytes and is
    one TRANSFER with them in the region, and a refused one an error."""
    res = cuda13.run("cuda", run_lock_dir())
    print(f"(s) CUDA 13.0: cuCtxSynchronize at 13000 hooked "
          f"{res.get('sync_hooked')}; with the context and with NULL: rc "
          f"{res.get('sync_rc')}, the span uncharged until it "
          f"{res.get('uncharged_while_open')}, charged "
          f"{res.get('sync_charged_ms')} ms at it against the GEMM's "
          f"{res.get('kernel_ms', 0):.3f} ms; batch copies {res.get('batches')}"
          f", copied {res.get('copied')}, a refused one rc "
          f"{res.get('refused_rc')}, TRANSFER (calls, errors, bytes) "
          f"+{res.get('transfer')}; gates {res['gates']}; on {name}",
          flush=True)
    failed = [k for k, ok in res["gates"].items() if not ok]
    check(res["ok"], f"(s) failed gates {failed}: {res.get('stderr', '')}")
    return {"phase": "(s) CUDA 13.0 entry points", **{
        k: v for k, v in res.items() if k != "stderr"}}


# ---------------------------- F1: a neighbour inside a context's measure.
NEIGHBOUR_BYTES = 4 * GiB
# after the lock is taken: past the card's reads before the creation (two
# NVML reads 2 ms apart), well inside the creation (PyTorch's primary
# context takes ~100 ms and more, printed)
NEIGHBOUR_AFTER_MS = 20
NEIGHBOUR_TRIES = 3


def neighbour_children() -> tuple:
    """F1 beside a neighbour: pod B outside the interposer and the first
    try's pod A, both started ahead"""
    return (SmChild("F1 neighbour", interposed=False, quota=None,
                    ahead=True),
            SmChild("F1 pod beside the neighbour", quota=FILL_QUOTAS[0],
                    ahead=True))


def neighbour_phase(name: str, ahead: tuple) -> dict:
    """F1 beside a neighbour: pod B, a process outside the interposer,
    allocates NEIGHBOUR_BYTES while pod A (a 3 GiB quota) makes its
    context. Where NVML cannot tell processes
    apart, A's footprint is the card's growth across the creation, which
    then holds B's bytes: A must be charged the node's context size (the
    run's record of quiet readings, which earlier children made) and fill
    its quota less that. Where NVML lists A under a pid of its own, A's
    charge is its own usedGpuMemory and must not hold B's bytes. Tried up
    to NEIGHBOUR_TRIES times until B's allocation lands inside A's
    measurement. ``ahead``: B and the first try's A, from
    :func:`neighbour_children`."""
    quota = FILL_QUOTAS[0]
    # outside the interposer: an interposed neighbour holds its allocations
    # while another process's context or first launch is measured (F6)
    b, a = ahead
    try:
        b.go()
        for attempt in range(1, NEIGHBOUR_TRIES + 1):
            b.send("alloc_when_locked", bytes=NEIGHBOUR_BYTES,
                   after_ms=NEIGHBOUR_AFTER_MS)
            if attempt > 1:
                a = SmChild("F1 pod beside the neighbour", quota=quota,
                            ahead=True)
            try:
                first = a.go()
                landed = b.read()["landed"]
                fill = a.ask("fill")
                a.ask("release")
                a.close()
            finally:
                if a.proc.poll() is None:
                    a.proc.kill()
                    a.proc.wait(timeout=60)
            b.ask("release")
            fp = first["footprint"]
            inside = fp["growth"] >= NEIGHBOUR_BYTES \
                if fp["mode"] == "context" else landed
            print(f"F1 neighbour, try {attempt}: a neighbour allocated "
                  f"{NEIGHBOUR_BYTES} B {NEIGHBOUR_AFTER_MS} ms after a pod "
                  f"took the context lock (still held once allocated: "
                  f"{landed}); the pod's context took "
                  f"{first['context_ms']:.1f} ms; footprint mode "
                  f"{fp['mode']}, the card grew by {fp['growth']} B across "
                  f"the creation, the node's context size on record "
                  f"{fp['node_context']} B, charged {fp['bytes']} B; then "
                  f"{fill['filled']} B filled at a {quota} B quota; on "
                  f"{name}", flush=True)
            if inside:
                break
        check(inside, f"F1 neighbour: the allocation never landed inside "
              f"a context's measurement in {NEIGHBOUR_TRIES} tries")
        b.close()
    finally:
        if b.proc.poll() is None:
            b.proc.kill()
            b.proc.wait(timeout=60)
    if fp["mode"] == "context":
        check(0 < fp["node_context"] == fp["bytes"], f"F1 neighbour: "
              f"charged {fp['bytes']} B, not the node's context size "
              f"{fp['node_context']} B: the neighbour's allocation landed "
              f"in the pod's footprint")
    else:
        check(fp["mode"] == "nvml_pid" and fp["bytes"] < NEIGHBOUR_BYTES,
              f"F1 neighbour: the pod's footprint {fp} holds the "
              f"neighbour's allocation")
    check(quota - fp["bytes"] - FILL_STEP - RESERVED_MARGIN
          <= fill["filled"] <= quota - fp["bytes"],
          f"F1 neighbour: {fill['filled']} B filled at a {quota} B quota "
          f"less a {fp['bytes']} B footprint")
    return {"phase": "F1 neighbour", "tries": attempt, "landed": landed,
            "context_ms": first["context_ms"], "footprint": fp,
            "filled_bytes": fill["filled"], "quota_bytes": quota}


# ------------------------------------------------- (k) the other models.
ZOO_CASES = ("3.1", "3.2", "4.1", "4.2", "5.1", "5.2")
F6_ZOO_CASE = "3.1"  # run then filled at its quota (VGG-16's 411 MB fc1)


def zoo_phase(name: str, alone: SmChild) -> list:
    """Phase (k): every case of BENCH_CASES alone, at its published batch
    and shape, bf16, seeded weights, in ``alone``, one --sm-child under
    libvgpu.so with no limit (for its launch counts; started and ready
    beside the compute plane's children, idle while they ran): step ms,
    img/s (sequences/s for the LSTM), peak memory_reserved(), the region's
    launches a step, finite logits or losses. Then each of ZOO_CASES under
    its own quota, its peak alone plus the footprint charge plus 25%, whole
    GiB, held to the quota phases' checks; each quota child is started
    ahead, the first as soon as its quota is known."""
    start = time.perf_counter()
    results, quotas, first = [], {}, None
    try:
        for case in BENCH_CASES:
            r = alone.ask("zoo", case=case.case)
            results.append(dict(r, phase=f"(k) case {case.case} alone"))
            print(f"(k) case {case.case}, {case.model} {case.mode} batch "
                  f"{case.batch} {'x'.join(map(str, case.shape))}: "
                  f"{r['ms']:.3f} ms/step (CUDA events, "
                  f"{STEPS[case.case]} steps), host {r['host_ms']:.3f} "
                  f"ms/step, {r['rate']:.1f} {unit(case)}; peak "
                  f"memory_reserved {r['peak_reserved']} B; "
                  f"{r['launches_per_step']:.0f} region launches a step; "
                  f"model built in {r['build_s']:.1f} s; on {name}",
                  flush=True)
            check(r["finite"], f"(k) case {case.case}: non-finite output")
            if case.case in ZOO_CASES:
                peak, fp = r["peak_reserved"], r["footprint"]["bytes"]
                quotas[case.case] = math.ceil(
                    (peak + fp) * (1 + TRAIN_HEADROOM) / GiB) * GiB
                if case.case == ZOO_CASES[0]:
                    first = QuotaChild(case.case, quotas[case.case], "")
        alone.close()
    finally:
        if alone.proc.poll() is None:
            alone.proc.kill()
            alone.proc.wait(timeout=60)
    phase_took("(k) every case alone:", start, name)
    by_case = {r["phase"].split()[2]: r for r in results}

    def quota_step(case_name, child):
        peak = by_case[case_name]["peak_reserved"]
        fp = by_case[case_name]["footprint"]["bytes"]
        print(f"(k) case {case_name} quota: max_memory_reserved alone {peak} "
              f"B + footprint {fp} B, + {TRAIN_HEADROOM:.0%}, rounded up to "
              f"whole GiB: {quotas[case_name]} B", flush=True)
        return dict(quota_phase(name, case_name, quotas[case_name], "",
                                child),
                    max_memory_reserved_alone=peak, footprint_alone=fp)

    steps = []
    for c in ZOO_CASES:
        steps.append((lambda c=c: QuotaChild(c, quotas[c], ""),
                      lambda child, c=c: quota_step(c, child)))
        if c == F6_ZOO_CASE:
            steps.append((
                lambda c=c: run_fill_child(c, quotas[c]),
                lambda child, c=c: run_fill_phase(name, c, quotas[c],
                                                  child)))
    results += pipelined(steps, first, name)
    took = time.perf_counter() - start
    print(f"(k) the phase took {took:.1f} s; on {name}", flush=True)
    results.append({"phase": "(k) time", "phase_s": took})
    return results


# ------------------------------------------------------ the compute plane.
# Children answer one JSON command per line of stdin with one JSON line
# (--sm-child). Each has its own region file; all but "alone" run under
# libvgpu.so with a 12 GiB quota and the SM limit, priority and host limit
# of their phase.

SM_RUN_S = 6.0      # (c), (d), (i): throttled runs, after warm-up
REF_RUN_S = 3.0     # the unthrottled run they are held to
GRAPH_RUN_S = 4.0   # (e)
SWITCH_RUN_S = 3.0  # (f)
BLOCK_S = 1.0       # (f): how long the block is held
HOST_LIMIT = 1 * GiB
PINNED = 256 << 20  # (h): pinned tensors of this size up to the limit
REGISTERED = 64 << 20
# (b): case 1.1 with no SM limit and at 100 against the same call's run
# alone, each the best of UNTHROTTLED_REPS timings in turns (as (m)'s
# profile cost): something outside the run delays the card's work now and
# then (on the H100 host, a 24 ms step took 25.7-89.7 ms about every 31 s:
# PERF.md), which only adds time
UNTHROTTLED_COST = 0.03
UNTHROTTLED_REPS = 3
# (c): launches charged by an argument key never seen before (their shape's
# least time), against the run's launches
NEW_KEY_MAX = 0.05


class SmChild:
    """A --sm-child process and its region file."""

    def __init__(self, label: str, interposed: bool = True, sm_limit=None,
                 priority=None, host_limit=None, given=None,
                 quota=INFER_QUOTA, wait: bool = True, extra_env=None,
                 ahead: bool = False):
        """``given`` = (env, region file) replaces the env this class
        builds (phases (i) and (j): the env of an Allocate response, given
        the run's lock directory, which Allocate mounts from the node);
        ``quota`` None runs with no memory limit; ``extra_env`` is added to
        the env. Unless ``wait`` is False (then call :meth:`ready`),
        returns once the child's context is made; with ``ahead``, the child
        is started ahead of its turn and :meth:`go` gives it the card."""
        self.label = label
        self.context_only = False
        if given is not None:
            env, self.cache = given
            env = dict(env, **{api.ENV_LOCK_DIR: run_lock_dir()})
            self.tmp = tempfile.mkdtemp(prefix="vgpu-smoke-")
        else:
            self.tmp, self.cache, env = child_env("", quota)
        if not interposed:
            env = {k: v for k, v in env.items() if not k.startswith(
                ("LD_PRELOAD", "CUDA_DEVICE_MEMORY"))}
        for key, value in (("CUDA_DEVICE_SM_LIMIT", sm_limit),
                           ("CUDA_TASK_PRIORITY", priority),
                           ("CUDA_HOST_MEMORY_LIMIT", host_limit)):
            if value is not None:
                env[key] = str(value)
        env.update(extra_env or {})
        self.errf = open(os.path.join(self.tmp, "child.err"), "w+")
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--sm-child"],
            env=held_env(env) if ahead else env, stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, stderr=self.errf, text=True)
        if ahead:
            _HELD.append(self)
        elif wait:
            self.ready()

    def go(self, wait: bool = True):
        """a child started ahead: its turn; unless ``wait`` is False
        (then call :meth:`ready`), returns once its context is made"""
        self.proc.stdin.write("go\n")
        self.proc.stdin.flush()
        return self.ready() if wait else None

    def ready(self) -> dict:
        """the child's first line: its context is made (the footprint
        libvgpu.so charged for it, and how long it took)"""
        return self.read()

    def send(self, op: str, **args) -> None:
        self.proc.stdin.write(json.dumps(dict(args, op=op)) + "\n")
        self.proc.stdin.flush()

    def read(self) -> dict:
        ready, _, _ = select.select([self.proc.stdout], [], [],
                                    CHILD_TIMEOUT_S)
        line = self.proc.stdout.readline() if ready else ""
        if not line:
            self.errf.seek(0)
            raise SmokeFailure(f"{self.label} child gave no answer, rc "
                               f"{self.proc.poll()}:\n"
                               f"{self.errf.read()[-4000:]}")
        reply = json.loads(line)
        check("error" not in reply, f"{self.label} child: {reply.get('error')}")
        return reply

    def ask(self, op: str, **args) -> dict:
        self.send(op, **args)
        return self.read()

    def view(self) -> RegionView:
        return RegionView(self.cache)

    def close(self) -> None:
        try:
            if self.proc.poll() is None:
                self.proc.communicate("", timeout=CHILD_TIMEOUT_S)
            rc = self.proc.returncode
            self.errf.seek(0)
            err = self.errf.read()
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.wait(timeout=60)
            self.errf.close()
        check(rc == 0, f"{self.label} child rc {rc}:\n{err[-4000:]}")
        check_nvml(err, f"{self.label} child")
        self.context_only = CONTEXT_ONLY_LOG in err
        if os.path.exists(self.cache):
            check_clean(self.cache)
        shutil.rmtree(self.tmp, ignore_errors=True)


def sm_child() -> None:
    """Runs in a --sm-child process: one JSON reply per JSON command,
    after a first line once its CUDA context is made."""
    enf = install()
    t0 = time.perf_counter()
    torch.empty(1, device="cuda")
    print(json.dumps({"ready": True, "footprint": enf.footprint(),
                      "context_ms": (time.perf_counter() - t0) * 1e3}),
          flush=True)
    models = {}

    def model(case_name):
        if case_name not in models:
            case = CASES[case_name]
            models[case_name] = build_model(case, torch.bfloat16)
        return models[case_name]

    def slot():
        """this process's slot in its region, everything published"""
        torch.cuda.synchronize()
        enf.flush_launches()
        with RegionView(enf.quota.cache_path) as view:
            (mine,) = [p for p in view.procs() if p.pid == os.getpid()]
        return mine

    def transfers():
        """(calls, bytes) of the region's TRANSFER class, this thread's
        notes published"""
        slot()
        with RegionView(enf.quota.cache_path) as view:
            cell = view.snapshot().prof["transfer"]
        return cell.calls, cell.bytes

    def infer():
        case = CASES["1.1"]
        x, _ = make_batch(case, 0)
        return make_infer_step(model("1.1")), x

    def op_time(cmd):
        case = CASES[cmd["case"]]
        _, ms, host_ms, img_s = run_case(case, model(cmd["case"]),
                                         STEPS[cmd["case"]])
        return {"ms": ms, "host_ms": host_ms, "img_s": img_s}

    def op_profile(cmd):
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        step, x = infer()
        for _ in range(WARMUP):
            step(x)
        before = slot().launches
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            step(x)
            torch.cuda.synchronize()
        after = slot().launches
        kernels = sum(1 for e in prof.events()
                      if e.device_type == DeviceType.CUDA
                      and not e.name.startswith(("Memcpy", "Memset")))
        # a serving step: the batch from the host, the logits back to it
        xh = x.cpu()

        def host_step():
            return step(xh.to("cuda")).float().cpu()

        for _ in range(WARMUP):
            host_step()
        t0 = transfers()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            host_step()
            torch.cuda.synchronize()
        t1 = transfers()
        copies = [e.name for e in prof.events()
                  if e.device_type == DeviceType.CUDA
                  and e.name.startswith("Memcpy")]
        return {"region_launches": after - before,
                "profiler_kernels": kernels,
                "region_transfers": t1[0] - t0[0],
                "region_transfer_bytes": t1[1] - t0[1],
                "profiler_memcpys": len(copies),
                "memcpy_kinds": sorted(set(copies))}

    def timed(fn, seconds):
        """fn() then a synchronisation, over and over for ``seconds``:
        (calls, wall s, the slot's launches and launch_ns over them, and
        libvgpu.so's sampled spans: how many in the run, and the busy
        fraction of the recent ones at its end)"""
        fn()
        torch.cuda.synchronize()
        first = slot() if enf.interposed else None
        spans = enf.span_busy()
        n, t0 = 0, time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            fn()
            torch.cuda.synchronize()
            n += 1
        wall = time.perf_counter() - t0
        res = {"calls": n, "wall_s": wall}
        if first is not None:
            last = slot()
            end = enf.span_busy()
            res.update(launches=last.launches - first.launches,
                       launch_ns=last.launch_ns - first.launch_ns,
                       span_samples=end["samples"] - spans["samples"],
                       span_busy=end["busy_fraction"])
        return res

    def stepper(case_name):
        """one step of the case on a fixed batch, as a function"""
        case = CASES[case_name]
        x, y = make_batch(case, 0)
        if case.mode == "inference":
            step = make_infer_step(model(case_name))
            return lambda: step(x)
        step, _ = make_train_step(model(case_name))
        return lambda: step(x, y)

    def op_run(cmd):
        case_name = cmd.get("case", "1.1")
        fn = stepper(case_name)
        for _ in range(WARMUP):
            fn()
        res = timed(fn, cmd["seconds"])
        res["img_s"] = res["calls"] * CASES[case_name].batch / res["wall_s"]
        return res

    def op_device_ms(cmd):
        """the device's time per step of the case (torch.profiler's
        kernels, copies and sets over ``steps`` steps), and the wall time
        per step meanwhile"""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        fn, steps = stepper(cmd["case"]), cmd["steps"]
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        busy_us = sum(e.time_range.elapsed_us() for e in prof.events()
                      if e.device_type == DeviceType.CUDA)
        return {"device_ms": busy_us / 1e3 / steps,
                "wall_ms": wall * 1e3 / steps}

    def op_zoo(cmd):
        """phase (k): the case alone, at its published batch and shape,
        then its model freed"""
        case = CASES[cmd["case"]]
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        net = build_model(case, torch.bfloat16)
        built = time.perf_counter() - t0
        before = slot().launches
        out, ms, host_ms, rate = run_case(case, net, STEPS[case.case])
        launches = slot().launches - before
        finite = bool(torch.isfinite(out).all())
        del net, out
        peak = torch.cuda.max_memory_reserved()
        torch.cuda.empty_cache()
        return {"ms": ms, "host_ms": host_ms, "rate": rate,
                "peak_reserved": peak, "finite": finite,
                "launches_per_step": launches / (WARMUPS[case.case]
                                                 + STEPS[case.case]),
                "build_s": built, "footprint": enf.footprint()}

    def op_graph(cmd):
        step, x = infer()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(WARMUP):
                step(x)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = step(x)
        ref = step(x)
        graph.replay()
        torch.cuda.synchronize()
        drift = rel_l2(out, ref)
        res = timed(graph.replay, cmd["seconds"])
        res.update(replays_s=res["calls"] / res["wall_s"],
                   replay_vs_eager_rel_l2=drift)
        return res

    def op_step(cmd):
        step, x = infer()
        try:
            out = step(x)
            torch.cuda.synchronize()
        except RuntimeError as e:
            return {"raised": str(e).splitlines()[0]}
        return {"finite": bool(torch.isfinite(out).all())}

    def op_host(cmd):
        res = {}
        pinned = []
        while (len(pinned) + 1) * PINNED <= HOST_LIMIT:
            pinned.append(torch.empty(PINNED, dtype=torch.uint8,
                                      pin_memory=True))
        res["pinned"] = len(pinned) * PINNED
        res["charged"] = enf.host_used()
        try:
            torch.empty(PINNED, dtype=torch.uint8, pin_memory=True)
            res["past_limit"] = "allocated"
        except RuntimeError as e:
            res["past_limit"] = str(e).splitlines()[0]
        # one pinned tensor less: the process runs on and pins again
        pinned.pop()
        torch._C._host_emptyCache()
        res["after_release"] = enf.host_used()
        small = torch.ones(1 << 20).pin_memory()
        res["runs_on"] = bool(small.cuda().sum().item() == (1 << 20))
        plain = torch.empty(REGISTERED, dtype=torch.uint8)
        cudart = torch.cuda.cudart()
        before = enf.host_used()
        check(int(cudart.cudaHostRegister(plain.data_ptr(), REGISTERED,
                                          0)) == 0, "cudaHostRegister")
        res["registered"] = enf.host_used() - before
        check(int(cudart.cudaHostUnregister(plain.data_ptr())) == 0,
              "cudaHostUnregister")
        res["unregistered"] = enf.host_used() - before
        return res

    def op_quota(cmd):
        """the quota as the process sees it, with the model and a step's
        memory charged; then one allocation of the whole quota, which
        cannot fit, and a step after it"""
        step, x = infer()
        step(x)
        torch.cuda.synchronize()
        free, total = torch.cuda.mem_get_info()
        try:
            torch.empty(total, dtype=torch.uint8, device="cuda")
            refused = None
        except torch.OutOfMemoryError as e:
            refused = ". ".join(str(e).split(". ")[:2])
        out = step(x)
        torch.cuda.synchronize()
        return {"total": total, "free": free, "refused": refused,
                "finite_after": bool(torch.isfinite(out).all()),
                "pid": os.getpid()}

    def op_mem(cmd):
        torch.cuda.synchronize()
        return {"reserved": torch.cuda.memory_reserved(), "pid": os.getpid(),
                "footprint": enf.footprint()}

    def op_keys(cmd):
        return enf.kernel_keys()

    def op_fill(cmd):
        """F1: 64 MiB at a time until the quota refuses one; the memory
        stays held until the next command"""
        held = []
        try:
            while True:
                held.append(torch.empty(FILL_STEP, dtype=torch.uint8,
                                        device="cuda"))
        except torch.OutOfMemoryError:
            pass
        torch.cuda.synchronize()
        free, total = torch.cuda.mem_get_info()
        fills.append(held)
        return {"filled": len(held) * FILL_STEP, "free": free,
                "total": total, "used": enf.used(),
                "reserved": torch.cuda.memory_reserved(),
                "footprint": enf.footprint(), "pid": os.getpid()}

    def op_run_fill(cmd):
        """F6: the case's steps (the first one timed apart: it loads the
        case's kernels), then 64 MiB at a time until the quota refuses
        one; the memory stays held until the next command"""
        fn = stepper(cmd["case"])
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        for _ in range(cmd["steps"] - 1):
            fn()
        torch.cuda.synchronize()
        rest_ms = (time.perf_counter() - t0) * 1e3 / max(1, cmd["steps"] - 1)
        return dict(op_fill(cmd), first_step_ms=first_ms, step_ms=rest_ms)

    def op_validate(cmd):
        """the entitlement validator at its mount's host path, on the
        license mounted beside it and on a copy with one signed line
        changed: (exit codes, what each said)"""
        with open(cmd["license"]) as f:
            text = f.read()
        tampered = os.path.join(tempfile.mkdtemp(prefix="vgpu-lic-"),
                                "license")
        with open(tampered, "w") as f:
            f.write(text.replace("max_chips=1", "max_chips=9"))
        out = {}
        for key, path in (("valid", cmd["license"]),
                          ("tampered", tampered)):
            proc = subprocess.run([cmd["validator"], path],
                                  capture_output=True, text=True,
                                  timeout=60)
            out[key] = [proc.returncode,
                        (proc.stdout + proc.stderr).strip()]
        shutil.rmtree(os.path.dirname(tampered), ignore_errors=True)
        return out

    def op_release(cmd):
        fills.clear()
        torch.cuda.empty_cache()
        return {"used": enf.used()}

    def op_alloc_when_locked(cmd):
        """F1's neighbour: once another process holds the node's context
        lock (it is making its first context, between the card's reads),
        wait cmd["after_ms"], then allocate cmd["bytes"] and hold them;
        landed: the lock was still held once the allocation was made"""
        path = os.path.join(os.environ[api.ENV_LOCK_DIR],
                            "vgpu-context.lock")
        until = time.monotonic() + CHILD_TIMEOUT_S / 2
        with open(path, "a") as f:
            while True:
                try:
                    fcntl.flock(f, fcntl.LOCK_EX | fcntl.LOCK_NB)
                except BlockingIOError:
                    break
                fcntl.flock(f, fcntl.LOCK_UN)
                if time.monotonic() > until:
                    raise TimeoutError("no process took the context lock")
                time.sleep(0.0005)
            time.sleep(cmd["after_ms"] / 1e3)
            fills.append(torch.empty(cmd["bytes"], dtype=torch.uint8,
                                     device="cuda"))
            torch.cuda.synchronize()
            try:
                fcntl.flock(f, fcntl.LOCK_EX | fcntl.LOCK_NB)
                fcntl.flock(f, fcntl.LOCK_UN)
                landed = False
            except BlockingIOError:
                landed = True
        return {"landed": landed, "used": enf.used()}

    fills = []
    ops = {"time": op_time, "profile": op_profile, "run": op_run,
           "graph": op_graph, "step": op_step, "host": op_host,
           "quota": op_quota, "mem": op_mem, "keys": op_keys,
           "device_ms": op_device_ms, "zoo": op_zoo, "fill": op_fill,
           "release": op_release, "alloc_when_locked": op_alloc_when_locked,
           "run_fill": op_run_fill, "validate": op_validate}
    for line in sys.stdin:
        cmd = json.loads(line)
        try:
            reply = ops[cmd["op"]](cmd)
        except Exception as e:  # reported to the parent, which fails
            reply = {"error": f"{type(e).__name__}: {e}"}
        print(json.dumps(reply), flush=True)


# phase (k)'s child alone (:func:`zoo_phase`), started with the compute
# plane's children
ZOO_ALONE = "(k) every case alone"


def compute_children() -> dict:
    """The compute plane's --sm-children and phase (k)'s child alone, by
    label, all started ahead"""
    kinds = {"alone": {"interposed": False}, "no SM limit": {},
             "SM limit 100": {"sm_limit": 100},
             "SM limit 50": {"sm_limit": 50},
             "SM limit 70": {"sm_limit": 70},
             "SM limit 30": {"sm_limit": 30, "priority": 1},
             "host limit": {"host_limit": HOST_LIMIT},
             ZOO_ALONE: {"quota": None}}
    return {label: SmChild(label, ahead=True, **kw)
            for label, kw in kinds.items()}


def compute_phases(name: str, children: dict) -> tuple:
    """Phases (a)-(h) of the compute plane, in ``children`` (from
    :func:`compute_children`); see the module docstring. Returns (the
    phases, phase (k)'s child alone, ready and idle while they ran)."""
    children = dict(children)
    phases = []
    lap = [time.perf_counter()]

    def took(label: str) -> None:
        phase_took(label, lap[0], name)
        lap[0] = time.perf_counter()

    try:
        # every child started, its context made, before any is timed: a
        # process starting beside a timed run would skew its time
        for child in children.values():
            child.go(wait=False)
        for child in children.values():
            child.ready()
        zoo = children.pop(ZOO_ALONE)
        alone, free, full, half, hi, lo, host = (children[label] for label in (
            "alone", "no SM limit", "SM limit 100", "SM limit 50",
            "SM limit 70", "SM limit 30", "host limit"))

        # (b) unthrottled cost, then (a) launch visibility
        times = {}
        for case_name in ("1.1", "1.2"):
            for _ in range(UNTHROTTLED_REPS):
                for child in (alone, free, full):
                    times.setdefault((case_name, child.label), []).append(
                        child.ask("time", case=case_name)["ms"])
        cost = {}
        for case_name in ("1.1", "1.2"):
            base = min(times[case_name, "alone"])
            res = {"phase": f"(b) case {case_name} unthrottled cost"}
            for child in (alone, free, full):
                ms = min(times[case_name, child.label])
                res[child.label] = ms
                res[f"{child.label} vs alone"] = ms / base - 1
                res[f"{child.label} each"] = times[case_name, child.label]
            each = "; ".join(
                f"{c.label} " + ", ".join(
                    f"{v:.3f}" for v in times[case_name, c.label])
                for c in (alone, free, full))
            print(f"(b) case {case_name} ms/step (CUDA events, "
                  f"{STEPS[case_name]} steps, the best of "
                  f"{UNTHROTTLED_REPS} in turns: {each}): alone "
                  f"{base:.3f}; under "
                  f"libvgpu.so with no SM limit "
                  f"{res['no SM limit']:.3f} "
                  f"({res['no SM limit vs alone']:+.2%}), at 100 "
                  f"{res['SM limit 100']:.3f} "
                  f"({res['SM limit 100 vs alone']:+.2%}); on {name}",
                  flush=True)
            phases.append(res)
            cost[case_name] = res
        for label in ("no SM limit", "SM limit 100"):
            slower = cost["1.1"][f"{label} vs alone"]
            check(slower <= UNTHROTTLED_COST, f"(b) case 1.1 under "
                  f"libvgpu.so ({label}) {slower:+.2%} slower than alone")
        took("(b) (its children's contexts and models included)")
        seen = free.ask("profile")
        print(f"(a) case 1.1, one step under libvgpu.so: "
              f"{seen['region_launches']} launches in the region, "
              f"{seen['profiler_kernels']} kernels traced by torch.profiler;"
              f" on {name}", flush=True)
        check(seen["region_launches"] >= seen["profiler_kernels"] > 0,
              "(a) launches escaped the interposer")
        print(f"(a) case 1.1, one step from the host's batch to the host's "
              f"logits under libvgpu.so: {seen['region_transfers']} copies "
              f"in the region's TRANSFER ({seen['region_transfer_bytes']} "
              f"B), {seen['profiler_memcpys']} Memcpy records traced by "
              f"torch.profiler {seen['memcpy_kinds']}; on {name}",
              flush=True)
        check(seen["region_transfers"] >= seen["profiler_memcpys"] > 0,
              "(a) copies escaped the interposer's profile")
        phases.append(dict(seen, phase="(a) launch visibility"))
        took("(a)")

        # the unthrottled references, then (c) and (e) at 50%
        ref = free.ask("run", seconds=REF_RUN_S)
        ref_graph = free.ask("graph", seconds=GRAPH_RUN_S)
        solo = ref["img_s"]
        step_ms = cost["1.1"]["no SM limit"]
        keys0 = half.ask("keys")
        run = half.ask("run", seconds=SM_RUN_S)
        keys = half.ask("keys")
        ran = {k: keys[k] - keys0[k] for k in keys}
        share = run["img_s"] / solo
        debit = run["launch_ns"] / 1e6 / (run["calls"] * step_ms)
        print(f"(c) case 1.1 at a 50% SM limit for {run['wall_s']:.1f} s: "
              f"{run['img_s']:.1f} img/s, {share:.3f}x the unthrottled "
              f"{solo:.1f} img/s; debited device time "
              f"{run['launch_ns'] / 1e6 / run['calls']:.3f} ms/step, "
              f"{debit:.3f}x the unthrottled CUDA-event step of "
              f"{step_ms:.3f} ms; on {name}", flush=True)
        new_share = ran["new"] / max(1, run["launches"])
        print(f"(c) kernels keyed by shape and argument bytes, over the "
              f"run's {run['launches']} launches: {ran['seen']} charges by "
              f"an argument key seen before, {ran['new']} by a new one "
              f"({new_share:.2%} of the launches, charged the shape's least "
              f"time), {ran['shape_only']} by the shape alone, "
              f"{ran['table_full']} past a full shape table; in the "
              f"process, {keys['left_out']} argument words left out of "
              f"their function's key ({ran['left_out']} during the run), "
              f"{keys['layouts']} functions with an argument layout, "
              f"{keys['no_layout']} without; on {name}", flush=True)
        phases.append({"phase": "(c) case 1.1 at 50%", "img_s": run["img_s"],
                       "unthrottled_img_s": solo, "share": share,
                       "debit_vs_event_time": debit, "kernel_keys": keys,
                       "kernel_keys_in_run": ran, "new_key_share": new_share,
                       **run})
        check(0.40 <= share <= 0.60, f"(c) 50% ran at {share:.3f}x")
        check(0.8 <= debit <= 1.1, f"(c) debited {debit:.3f}x the step time")
        check(new_share < NEW_KEY_MAX, f"(c) {new_share:.2%} of the launches "
              f"charged by a new argument key")
        took("(c) (the unthrottled references included)")
        g = half.ask("graph", seconds=GRAPH_RUN_S)
        gshare = g["replays_s"] / ref_graph["replays_s"]
        print(f"(e) case 1.1 captured as a CUDA graph: replays at a 50% SM "
              f"limit {g['replays_s']:.2f}/s, {gshare:.3f}x the unthrottled "
              f"{ref_graph['replays_s']:.2f}/s; replay vs eager logits rel "
              f"L2 {g['replay_vs_eager_rel_l2']:.3e}; charged "
              f"{g['launch_ns'] / 1e6 / g['calls']:.3f} ms/replay over "
              f"{g['launches']} launches; on {name}", flush=True)
        phases.append({"phase": "(e) graph replay at 50%", "share": gshare,
                       "unthrottled_replays_s": ref_graph["replays_s"], **g})
        check(0.40 <= gshare <= 0.60, f"(e) 50% replays at {gshare:.3f}x")
        check(g["replay_vs_eager_rel_l2"] <= BF16_REL, "(e) replay logits")
        took("(e)")

        # (g) the gate
        ok = half.ask("step")
        with half.view() as view:
            gated = view.pressure()["near_limit_failures"]
            _, applied = view.set_limit_checked(1)
            refused = half.ask("step")
            gated = view.pressure()["near_limit_failures"] - gated
            view.set_limit_checked(INFER_QUOTA)
        again = half.ask("step")
        print(f"(g) limit lowered to the usage ({applied} B): the next step "
              f"raised \"{refused.get('raised')}\" after {gated} refused "
              f"launch(es); restored, the step ran (finite logits "
              f"{again.get('finite')}); on {name}", flush=True)
        phases.append({"phase": "(g) gate", "lowered_to": applied,
                       "raised": refused.get("raised"),
                       "gate_refusals": gated,
                       "finite_after": again.get("finite")})
        check(ok.get("finite") is True, "(g) step before the gate")
        check("out of memory" in refused.get("raised", "") and gated >= 1,
              f"(g) step past the lowered limit: {refused}, {gated} gate "
              f"refusals")
        check(again.get("finite") is True, "(g) step after the restore")
        took("(g)")

        # (d) two tenants at once
        for child in (hi, lo):
            child.send("run", seconds=SM_RUN_S)
        pair = {child.label: child.read() for child in (hi, lo)}
        r70, r30 = (pair[c.label]["img_s"] for c in (hi, lo))
        c70, c30 = (pair[c.label]["launch_ns"] / 1e9 / pair[c.label]["wall_s"]
                    for c in (hi, lo))
        ratio = r70 / r30
        print(f"(d) two case 1.1 tenants at once for {SM_RUN_S:.0f} s: 70% "
              f"{r70:.1f} img/s ({r70 / solo:.3f}x solo, charged {c70:.3f} "
              f"of wall time), 30% {r30:.1f} img/s ({r30 / solo:.3f}x solo, "
              f"charged {c30:.3f}), ratio {ratio:.3f}; on {name}",
              flush=True)
        phases.append({"phase": "(d) 70/30 pair", "img_s_70": r70,
                       "img_s_30": r30, "ratio": ratio, "solo_img_s": solo,
                       "charged_share_70": c70, "charged_share_30": c30})
        check(1.7 < ratio < 3.2, f"(d) ratio {ratio:.3f}")
        check(r70 < 0.9 * solo and r30 < 0.55 * solo, "(d) shares")
        # what the card gives two contexts with no limit: the pair's
        # reference (printed, not gated)
        for child in (free, full):
            child.send("run", seconds=REF_RUN_S)
        both = [child.read()["img_s"] / solo for child in (free, full)]
        print(f"(d) two case 1.1 pods with no SM limit at once for "
              f"{REF_RUN_S:.0f} s: {both[0]:.3f}x and {both[1]:.3f}x solo, "
              f"{sum(both):.3f} of one card together; on {name}", flush=True)
        phases[-1]["unlimited_pair_shares"] = both
        took("(d)")

        # (f) feedback on the 30% tenant (priority 1)
        with lo.view() as view:
            lo.send("run", seconds=3 * BLOCK_S)
            time.sleep(BLOCK_S / 2)
            view.set_recent_kernel(FEEDBACK_BLOCK)
            time.sleep(0.3)
            held = view.total_launches()
            time.sleep(BLOCK_S)
            still = view.total_launches()
            view.set_recent_kernel(FEEDBACK_IDLE)
            lo.read()
            resumed = view.total_launches()
            spins = view.pressure()["contention_spins"]
            limited = lo.ask("run", seconds=SWITCH_RUN_S)["img_s"]
            view.set_utilization_switch(1)
            lifted = lo.ask("run", seconds=SWITCH_RUN_S)["img_s"]
            view.set_utilization_switch(0)
        print(f"(f) priority-1 tenant blocked for {BLOCK_S:.1f} s: region "
              f"launches {held} -> {still} while blocked, {resumed} after; "
              f"{spins} contention spins; at 30% {limited:.1f} img/s, with "
              f"utilization_switch=1 {lifted:.1f} img/s "
              f"({lifted / solo:.3f}x solo); on {name}", flush=True)
        phases.append({"phase": "(f) feedback", "held": held,
                       "still": still, "resumed": resumed,
                       "img_s_30": limited, "img_s_switch": lifted})
        check(still == held and resumed > still, "(f) block did not hold")
        check(limited < 0.55 * solo and lifted > 0.8 * solo,
              "(f) utilization_switch did not lift the throttle")
        took("(f)")

        # (h) the host ledger
        h = host.ask("host")
        print(f"(h) {h['pinned']} B pinned under a {HOST_LIMIT} B host "
              f"limit, {h['charged']} B charged; one more raised "
              f"\"{h['past_limit']}\"; {h['after_release']} B charged "
              f"after one was released; cudaHostRegister charged "
              f"{h['registered']} B, unregister left {h['unregistered']} B; "
              f"on {name}", flush=True)
        phases.append(dict(h, phase="(h) host ledger"))
        check(h["charged"] == h["pinned"] == HOST_LIMIT // PINNED * PINNED,
              "(h) pinned memory not charged")
        check("out of memory" in h["past_limit"], "(h) past the limit")
        check(h["after_release"] == h["pinned"] - PINNED and h["runs_on"],
              "(h) release")
        check(h["registered"] == REGISTERED and h["unregistered"] == 0,
              "(h) register")
        took("(h)")
        # the children exit at once; each close still checks its exit code
        # and its region
        closing = [children.pop(label) for label in list(children)]
        with futures.ThreadPoolExecutor(len(closing)) as pool:
            for done in [pool.submit(child.close) for child in closing]:
                done.result()
    finally:
        for child in children.values():
            if child.proc.poll() is None:
                child.proc.kill()
                child.proc.wait(timeout=60)
            child.errf.close()
            shutil.rmtree(child.tmp, ignore_errors=True)
    return phases, zoo


# ------------------------------------------------------ (i) the node agent.
# The device plugin runs in its own process, started through its entry
# point with an in-memory apiserver (FakeKubeClient) that this script reads
# and writes through the child's stdin/stdout (one JSON command and reply
# per line). The port's scheduler runs in a thread of the same process,
# through its own entry point, on the same apiserver: the script reaches
# its extender and webhook over HTTPS. The child imports vtpu_torch's
# plugin and scheduler only: no torch. Both daemons, and (j)'s monitor, run
# with the argv the chart deploy/helm/vgpu gives their containers
# (chart_daemons), and the node name its DaemonSet gives through NODE_NAME.

PLUGIN_CHILD = r"""
import json, os, signal, sys, threading, time
from vtpu_torch.plugin.__main__ import main
from vtpu_torch.plugin.nvml import NvmlLib
from vtpu_torch.scheduler.__main__ import main as scheduler_main
from vtpu_torch.util.client import FakeKubeClient

plugin_argv, scheduler_argv = map(json.loads, sys.argv[1:3])
node = os.environ["NODE_NAME"]
# NVML's cost in a process that never initialised CUDA, as the plugin's
t0 = time.perf_counter()
lib = NvmlLib()
t1 = time.perf_counter()
lib.enumerate()
t2 = time.perf_counter()
lib.close()
cold = {"init_ms": (t1 - t0) * 1e3, "enumerate_ms": (t2 - t1) * 1e3}
client = FakeKubeClient()
client.add_node(node)
out = sys.stdout
sys.stdout = sys.stderr  # the replies own the real stdout


def serve():
    for line in sys.stdin:
        cmd = json.loads(line)
        op = cmd["op"]
        if op == "stop":
            os.kill(os.getpid(), signal.SIGINT)
            return
        if op == "add_pod":
            reply = client.add_pod(cmd["pod"])
        elif op == "get_pod":
            reply = client.get_pod("default", cmd["name"])
        elif op == "get_node":
            reply = client.get_node(node)
        elif op == "patch_node":
            reply = client.patch_node_annotations(node, cmd["annos"])
        elif op == "nvml":
            reply = cold
        elif op == "scheduler":
            # the port's scheduler daemon on the same apiserver, serving
            # its extender and webhook where the chart's argv says
            threading.Thread(target=scheduler_main, args=(scheduler_argv,),
                             kwargs={"client": client}, daemon=True).start()
            reply = {"started": True}
        else:
            reply = {"modules": sorted(
                m for m in sys.modules
                if m.split(".")[0] in ("torch", "jax", "vtpu"))}
        out.write(json.dumps(reply) + "\n")
        out.flush()


threading.Thread(target=serve, daemon=True).start()
main(plugin_argv, client=client)
print("stopped", file=out, flush=True)
"""

NODE_NAME = "smoke-gpu-node"
SPLIT = 10                   # device_split_count, the plugin's default
NODE_QUOTA_MB = 12288        # (i): the pod's gpumem ...
NODE_SM_LIMIT = 50           # ... and gpucores
# the HMAC secret the (i) license is minted with, and the pod's env holds
LICENSE_SECRET = "chip-smoke-test-secret"
# a CUDA context holds ~0.6 GB of the card (PERF.md); the plugin process
# must not move the card's used memory by a fraction of that
CONTEXT_MARGIN_MB = 256


def smi(query: str) -> list:
    """One ``nvidia-smi --query-gpu`` field per card (no units)."""
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader,"
         "nounits"], check=True, capture_output=True, text=True,
        timeout=60).stdout
    return [line.strip() for line in out.strip().splitlines()]


def card_used_mb() -> int:
    """the card's used memory (nvidia-smi, MiB), the least over
    CARD_READ_S"""
    least, until = None, time.perf_counter() + CARD_READ_S
    while True:
        used = int(smi("memory.used")[0])
        least = used if least is None else min(least, used)
        if time.perf_counter() >= until:
            return least
        time.sleep(0.01)


def compute_apps() -> int:
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return len([line for line in out.splitlines() if line.strip()])


def chart_daemons(tmp: str) -> dict:
    """The argv the chart deploy/helm/vgpu gives the device plugin, the
    scheduler extender and the node monitor (rendered by vtpu_torch.deploy,
    which tests/test_torch_deploy.py holds to the chart), with only
    node-local paths and ports replaced, through the chart's own values:
    the shim and kubelet socket dirs under ``tmp``, the webhook's serving
    cert (made here with openssl, as the chart's certgen job makes it) and
    free ports. Printed on one line."""
    from vtpu_torch import deploy

    dirs = {d: os.path.join(tmp, d) for d in ("vgpu", "device-plugins",
                                              "tls")}
    os.makedirs(dirs["device-plugins"])
    os.makedirs(dirs["tls"])
    subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
         "-days", "1", "-subj", "/CN=127.0.0.1",
         "-keyout", os.path.join(dirs["tls"], "tls.key"),
         "-out", os.path.join(dirs["tls"], "tls.crt")],
        check=True, capture_output=True, timeout=60)
    ports = {k: free_port() for k in ("health", "webhook", "sched_metrics",
                                      "metrics", "info")}
    objs = deploy.objects({
        "devicePlugin": {"shimHostDir": dirs["vgpu"],
                         "socketDir": dirs["device-plugins"],
                         "healthPort": ports["health"]},
        "scheduler": {"webhookPort": ports["webhook"],
                      "metricsPort": ports["sched_metrics"],
                      "tlsDir": dirs["tls"]},
        "monitor": {"metricsPort": ports["metrics"],
                    "infoPort": ports["info"]}})
    argv = {name: deploy.daemon_argv(objs, name) for name in deploy.DAEMONS}
    print("(i) the daemons' argv from deploy/helm/vgpu: "
          + json.dumps(argv), flush=True)
    check(f"--device-split-count={SPLIT}" in argv["device-plugin"]
          and f"--sweep-interval={SWEEP_S:g}" in argv["monitor"],
          f"the chart's split count or sweep interval moved: {argv}")
    return {"argv": argv, "ports": ports, "dirs": dirs}


class PluginChild:
    """The device plugin process and its in-memory apiserver."""

    def __init__(self, tmp: str):
        self.chart = chart_daemons(tmp)
        self.sock_dir = self.chart["dirs"]["device-plugins"]
        self.shim_dir = self.chart["dirs"]["vgpu"]
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("CUDA_", "LD_PRELOAD", "VGPU_"))}
        env["PYTHONPATH"] = ROOT
        env[api.ENV_NODE_NAME] = NODE_NAME
        self.errf = open(os.path.join(tmp, "plugin.err"), "w+")
        argv = self.chart["argv"]
        self.proc = subprocess.Popen(
            [sys.executable, "-c", PLUGIN_CHILD,
             json.dumps(argv["device-plugin"]),
             json.dumps(argv["vgpu-scheduler-extender"])],
            env=env, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=self.errf, text=True)

    def err(self) -> str:
        self.errf.seek(0)
        return self.errf.read()[-4000:]

    def ask(self, op: str, **args):
        self.proc.stdin.write(json.dumps(dict(args, op=op)) + "\n")
        self.proc.stdin.flush()
        ready, _, _ = select.select([self.proc.stdout], [], [], 60)
        line = self.proc.stdout.readline() if ready else ""
        if not line:
            raise SmokeFailure(f"plugin child gave no answer to {op}, rc "
                               f"{self.proc.poll()}:\n{self.err()}")
        return json.loads(line)

    def stop(self) -> str:
        try:
            self.proc.stdin.write(json.dumps({"op": "stop"}) + "\n")
            self.proc.stdin.flush()
            out, _ = self.proc.communicate(timeout=60)
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.wait(timeout=60)
        check(self.proc.returncode == 0 and out.strip() == "stopped",
              f"plugin child rc {self.proc.returncode}:\n{self.err()}")
        return out


class Extender:
    """The port's scheduler over HTTPS, as kube-scheduler and the API
    server reach it (the chart's extender config skips the cert check:
    tlsConfig insecure)."""

    def __init__(self, port: int):
        import http.client
        import ssl

        self.conn = http.client.HTTPSConnection(
            "127.0.0.1", port, timeout=60,
            context=ssl._create_unverified_context())

    def call(self, method: str, path: str, body=None):
        t0 = time.perf_counter()
        self.conn.request(method, path,
                          body=None if body is None else json.dumps(body),
                          headers={"Content-Type": "application/json"})
        resp = self.conn.getresponse()
        raw = resp.read()
        ms = (time.perf_counter() - t0) * 1e3
        try:
            return resp.status, json.loads(raw), ms
        except ValueError:
            return resp.status, raw.decode(errors="replace"), ms


def start_scheduler(plugin: "PluginChild") -> int:
    """The port's scheduler, started through its entry point in the
    plugin's process on the same apiserver; its HTTPS port."""
    plugin.ask("scheduler")
    return plugin.chart["ports"]["webhook"]


def extender_phase(name: str, plugin: "PluginChild", port: int,
                   chip) -> dict:
    """Phase (i)'s assignment: the port's scheduler (start_scheduler, on
    ``port``) admits the pod through /webhook (schedulerName and the
    injected priority in the patch), and places it through /filter and
    /bind on the card's node, at gpumem 12288 MiB and gpucores 50."""
    import base64
    import urllib.error

    from vtpu_torch.scheduler.loadtest import apply_patch
    from vtpu_torch.util import codec

    deadline = time.monotonic() + 60
    while True:
        try:
            ext = Extender(port)
            if ext.call("GET", "/healthz")[0] == 200:
                break
        except (urllib.error.URLError, ConnectionError, OSError):
            pass
        check(time.monotonic() < deadline,
              f"(i) the scheduler is not serving:\n{plugin.err()}")
        time.sleep(0.1)
    # its first registration poll, one period (15 s) in, takes the
    # plugin's report
    while not plugin.ask("get_node")["metadata"]["annotations"].get(
            api.HANDSHAKE_ANNO, "").startswith("Requesting"):
        check(time.monotonic() < deadline,
              "(i) the scheduler did not take the node's report")
        time.sleep(0.1)
    pod = {"metadata": {"name": "smoke-pod", "namespace": "default",
                        "uid": "smoke-uid", "annotations": {}},
           "spec": {"containers": [{
               "name": "main", "resources": {"limits": {
                   api.RESOURCE_GPU: 1, api.RESOURCE_MEM: NODE_QUOTA_MB,
                   api.RESOURCE_CORES: NODE_SM_LIMIT,
                   api.RESOURCE_PRIORITY: 1}}}]},
           "status": {"phase": "Pending"}}
    status, review, webhook_ms = ext.call("POST", "/webhook", {
        "apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview",
        "request": {"uid": "smoke-review", "operation": "CREATE",
                    "object": pod}})
    resp = review.get("response", {}) if status == 200 else {}
    check(resp.get("allowed") is True and "patch" in resp,
          f"(i) /webhook {status}: {review}")
    patch = json.loads(base64.b64decode(resp["patch"]))
    apply_patch(pod, patch)
    env = pod["spec"]["containers"][0].get("env", [])
    check(pod["spec"].get("schedulerName") == "vtpu-scheduler"
          and {"name": api.ENV_TASK_PRIORITY, "value": "1"} in env
          and pod["metadata"]["annotations"].get(
              api.TASK_PRIORITY_ANNO) == "1",
          f"(i) the webhook's patch {patch}")
    plugin.ask("add_pod", pod=pod)
    stored = plugin.ask("get_pod", name="smoke-pod")
    status, body, filter_ms = ext.call("POST", "/filter", {
        "Pod": stored, "NodeNames": [NODE_NAME]})
    check(status == 200 and body.get("NodeNames") == [NODE_NAME],
          f"(i) /filter {status}: {body}")
    status, body, bind_ms = ext.call("POST", "/bind", {
        "PodName": "smoke-pod", "PodNamespace": "default",
        "PodUID": "smoke-uid", "Node": NODE_NAME})
    check(status == 200 and body == {"Error": ""},
          f"(i) /bind {status}: {body}")
    annos = plugin.ask("get_pod", name="smoke-pod")["metadata"][
        "annotations"]
    (placed,) = codec.decode_pod_devices(annos[api.TO_ALLOCATE_ANNO])
    got = [(d.uuid, d.usedmem, d.usedcores) for d in placed]
    locked = api.NODE_LOCK_ANNO in plugin.ask("get_node")["metadata"][
        "annotations"]
    print(f"(i) the port's scheduler over HTTPS: /webhook {webhook_ms:.3f} "
          f"ms (schedulerName {pod['spec']['schedulerName']}, "
          f"{api.ENV_TASK_PRIORITY}=1 and {api.TASK_PRIORITY_ANNO} 1 "
          f"injected), /filter {filter_ms:.3f} ms (winner {NODE_NAME}), "
          f"/bind {bind_ms:.3f} ms; assignment {got}, bind-phase "
          f"{annos.get(api.BIND_PHASE_ANNO)}, node locked {locked}; on "
          f"{name}", flush=True)
    check(got == [(chip.uuid, NODE_QUOTA_MB, NODE_SM_LIMIT)]
          and annos.get(api.ASSIGNED_NODE_ANNO) == NODE_NAME
          and annos.get(api.BIND_PHASE_ANNO) == "allocating" and locked,
          f"(i) after /bind: {annos}")
    return {"webhook_ms": webhook_ms, "filter_ms": filter_ms,
            "bind_ms": bind_ms}


def node_agent_phase(name: str, solo_img_s: float,
                     step_ms: dict) -> list:
    """Phase (i): the device plugin enumerates the card through NVML,
    advertises its replicas to a fake kubelet, reports the inventory, and
    answers Allocate for a pod the port's scheduler admitted and placed
    over HTTP (extender_phase); a case 1.1 child started with that
    response's env alone runs under libvgpu.so at the granted quota and
    SM limit. Then phase (j), the node monitor, over the same plugin's
    pods."""
    import grpc

    from vtpu_torch.plugin import deviceplugin_pb2 as pb
    from vtpu_torch.plugin import dp_grpc, runtime
    from vtpu_torch.plugin import license as vlicense
    from vtpu_torch.plugin.nvml import NvmlLib
    from vtpu_torch.plugin.rm import replica_id
    from vtpu_torch.util import codec

    # enumeration, in this process, against torch and nvidia-smi
    start = t0 = time.perf_counter()
    nvml = NvmlLib()
    t1 = time.perf_counter()
    chips = nvml.enumerate()
    t2 = time.perf_counter()
    numa_sources = dict(nvml.numa_sources)
    nvml.close()
    init_ms, enum_ms = (t1 - t0) * 1e3, (t2 - t1) * 1e3
    check(len(chips) == torch.cuda.device_count() >= 1,
          f"NVML sees {len(chips)} cards, torch "
          f"{torch.cuda.device_count()}")
    smi_mib, smi_uuid = smi("memory.total"), smi("uuid")
    for i, chip in enumerate(chips):
        props = torch.cuda.get_device_properties(i)
        torch_uuid = "GPU-" + str(props.uuid)
        check(chip.type == "NVIDIA-" + torch.cuda.get_device_name(i),
              f"card {i}: NVML type {chip.type!r}, torch name "
              f"{torch.cuda.get_device_name(i)!r}")
        check(chip.hbm_mb == int(smi_mib[i]), f"card {i}: NVML "
              f"{chip.hbm_mb} MiB, nvidia-smi {smi_mib[i]}")
        check(chip.uuid == smi_uuid[i], f"card {i}: NVML uuid {chip.uuid}, "
              f"nvidia-smi {smi_uuid[i]}")
        check(chip.uuid == torch_uuid, f"card {i}: NVML uuid {chip.uuid}, "
              f"torch {torch_uuid}")
        for path in chip.device_paths + ["/dev/nvidiactl",
                                         "/dev/nvidia-uvm"]:
            check(os.path.exists(path), f"{path} missing")
    cards = "; ".join(
        f"{c.type}, {c.hbm_mb} MiB, {c.device_paths[0]}, NUMA {c.numa}, "
        f"uuid {c.uuid}, as torch's and nvidia-smi's" for c in chips)
    print(f"(i) NVML in this process (CUDA initialised): {len(chips)} "
          f"card(s) in {enum_ms:.3f} ms (nvmlInit_v2 and binding "
          f"{init_ms:.3f} ms): {cards}; on {name}", flush=True)
    numa = "; ".join(f"card {i}: NUMA {chips[i].numa} from "
                     f"{numa_sources.get(i)}" for i in range(len(chips)))
    print(f"(i) NUMA source (NVML's PCI bus id and sysfs, else nvidia-smi "
          f"topo -m, else 0): {numa}; on {name}", flush=True)

    tmp = tempfile.mkdtemp(prefix="vgpu-smoke-node-")
    registered = []

    class FakeKubelet(dp_grpc.RegistrationServicer):
        def Register(self, request, context):
            registered.append(request)
            return pb.Empty()

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    used0, apps0 = card_used_mb(), compute_apps()
    kubelet = None
    plugin = None
    workload = None
    try:
        plugin = PluginChild(tmp)
        # the scheduler first takes the node's report one registration
        # period (15 s) after it starts: it starts now, and that period
        # runs while the plugin registers and advertises
        sched_port = start_scheduler(plugin)
        kubelet = grpc.server(futures.ThreadPoolExecutor(max_workers=2))
        dp_grpc.add_registration_servicer(kubelet, FakeKubelet())
        kubelet.add_insecure_port(
            f"unix://{plugin.sock_dir}/{dp_grpc.KUBELET_SOCKET}")
        kubelet.start()
        deadline = time.monotonic() + 120
        annos = {}
        while time.monotonic() < deadline and not (
                registered and api.NODE_REGISTER_ANNO in annos):
            time.sleep(0.1)
            annos = plugin.ask("get_node")["metadata"]["annotations"]
        check(bool(registered), f"no Register from the plugin:\n"
              f"{plugin.err()}")
        check(registered[0].resource_name == api.RESOURCE_GPU,
              f"registered {registered[0].resource_name}")
        sock = f"unix://{plugin.sock_dir}/{registered[0].endpoint}"

        # advertisement
        with grpc.insecure_channel(sock) as ch:
            first = next(dp_grpc.DevicePluginStub(ch).ListAndWatch(
                pb.Empty(), timeout=30))
        ids = sorted(d.ID for d in first.devices)
        check(ids == sorted(replica_id(c.uuid, r) for c in chips
                            for r in range(SPLIT)), f"ListAndWatch {ids}")
        check(all(d.health == "Healthy" for d in first.devices),
              "an unhealthy replica")
        inventory = codec.decode_node_devices(annos[api.NODE_REGISTER_ANNO])
        check([(d.id, d.count, d.devmem, d.devcore, d.type, d.health)
               for d in inventory] ==
              [(c.uuid, SPLIT, c.hbm_mb, 100, c.type, True) for c in chips],
              f"register annotation {annos[api.NODE_REGISTER_ANNO]}")

        # the assignment, from the port's scheduler: this script plays
        # only the API server's admission call and kube-scheduler
        extender = extender_phase(name, plugin, sched_port, chips[0])

        # a license on the node, minted with a test secret: Allocate then
        # mounts it and the vgpu-validator the plugin installed
        license_file = os.path.join(plugin.shim_dir, "license", "license")
        os.makedirs(os.path.dirname(license_file))
        with open(license_file, "w") as f:
            f.write(vlicense.mint(LICENSE_SECRET.encode(),
                                  int(time.time()) + 3600,
                                  nodes=socket.gethostname(), max_chips=1))

        # Allocate, as kubelet calls it
        with grpc.insecure_channel(sock) as ch:
            stub = dp_grpc.DevicePluginStub(ch)
            t0 = time.perf_counter()
            resp = stub.Allocate(pb.AllocateRequest(container_requests=[
                pb.ContainerAllocateRequest(
                    devicesIDs=[replica_id(chips[0].uuid, 0)])]))
            alloc_ms = (time.perf_counter() - t0) * 1e3
        phase = plugin.ask("get_pod", name="smoke-pod")["metadata"][
            "annotations"][api.BIND_PHASE_ANNO]
        locked = api.NODE_LOCK_ANNO in plugin.ask("get_node")["metadata"][
            "annotations"]
        check(phase == "success" and not locked,
              f"after Allocate: bind-phase {phase}, node locked {locked}")
        extender["dashboards"] = dashboard_check(
            name, "(i)", "scheduler", plugin.chart["ports"]["sched_metrics"],
            SCHEDULER_FILLED)
        (ctr,) = resp.container_responses
        print(f"(i) Allocate over the plugin's socket: {alloc_ms:.3f} ms; "
              f"bind-phase {phase}, node lock released; response env "
              f"{dict(sorted(ctr.envs.items()))}, "
              f"{len(ctr.mounts)} mounts, device nodes "
              f"{sorted(d.host_path for d in ctr.devices)}; on {name}",
              flush=True)

        # the plugin process holds no CUDA context: it imported no torch,
        # and the card's used memory and compute processes did not move
        # (NVML itself maps libcuda.so at nvmlInit_v2 with this driver, so
        # a mapping is no evidence of a context)
        modules = plugin.ask("modules")["modules"]
        cold = plugin.ask("nvml")
        with open(f"/proc/{plugin.proc.pid}/maps") as f:
            libcuda = sorted({line.split()[-1] for line in f
                              if "libcuda" in line})
        used1, apps1 = card_used_mb(), compute_apps()
        print(f"(i) plugin process: NVML without CUDA in the process: "
              f"nvmlInit_v2 and binding {cold['init_ms']:.3f} ms, "
              f"enumeration {cold['enumerate_ms']:.3f} ms; modules of "
              f"torch/jax/vtpu {modules}; "
              f"card memory used {used0} -> {used1} MiB, compute "
              f"processes {apps0} -> {apps1}; libcuda mapped "
              f"{libcuda or 'no'}; on {name}", flush=True)
        check(modules == [], f"the plugin imported {modules}")
        check(used1 - used0 < CONTEXT_MARGIN_MB and apps1 == apps0,
              "the plugin process took device memory or a context")

        # the workload: a case 1.1 child with only the response's env and
        # mounts applied (runtime.process_env: the host paths of the
        # libvgpu.so and region mounts, CUDA_VISIBLE_DEVICES =
        # NVIDIA_VISIBLE_DEVICES), over this machine's own environment
        # with every CUDA_/NVIDIA_/LD_PRELOAD key of it removed. Nothing
        # else is set by hand.
        env = {k: v for k, v in os.environ.items() if not k.startswith(
            ("CUDA_", "NVIDIA_", "LD_PRELOAD", "PYTORCH_CUDA_ALLOC_CONF"))}
        env["PYTHONPATH"] = ROOT
        env.update(runtime.process_env(ctr))
        # the license secret, as a pod spec's env from a Secret
        env[api.ENV_LICENSE_SECRET] = LICENSE_SECRET
        cache = env[api.ENV_SHARED_CACHE]
        check(env["LD_PRELOAD"] == os.path.join(plugin.shim_dir,
                                                "libvgpu.so"),
              f"LD_PRELOAD {env.get('LD_PRELOAD')}")
        workload = SmChild("(i) Allocate's pod", given=(env, cache))
        mounted = {m.container_path: m.host_path for m in ctr.mounts}
        check(mounted.get(api.CONTAINER_LICENSE_PATH) == license_file
              and api.CONTAINER_VALIDATOR_PATH in mounted,
              f"(i) license and validator mounts: {sorted(mounted)}")
        validated = workload.ask(
            "validate", license=runtime.host_path(
                api.CONTAINER_LICENSE_PATH, ctr.mounts),
            validator=runtime.host_path(api.CONTAINER_VALIDATOR_PATH,
                                        ctr.mounts))
        print(f"(i) vgpu-validator in the pod, from its mount: the license "
              f"exit {validated['valid'][0]} "
              f"(\"{validated['valid'][1]}\"), a tampered copy exit "
              f"{validated['tampered'][0]} "
              f"(\"{validated['tampered'][1]}\"); on {name}", flush=True)
        check(validated["valid"][0] == 0 and validated["tampered"][0] == 1,
              f"(i) validator {validated}")
        q = workload.ask("quota")
        run = workload.ask("run", seconds=SM_RUN_S)
        share = run["img_s"] / solo_img_s
        with workload.view() as view:
            limit, core = view.hbm_limit(0), view.core_limit(0)
            pids = [p.pid for p in view.procs()]
        print(f"(i) case 1.1 started from the response alone: "
              f"mem_get_info total {q['total']} B; past it "
              f"\"{q['refused']}\", then the step ran (finite "
              f"{q['finite_after']}); {run['img_s']:.1f} img/s for "
              f"{run['wall_s']:.1f} s, {share:.3f}x the unthrottled "
              f"{solo_img_s:.1f}; region at {cache}: limit {limit} B, SM "
              f"limit {core}, slots {pids}; on {name}", flush=True)
        check(q["total"] == NODE_QUOTA_MB * MiB,
              f"mem_get_info total {q['total']}")
        check(q["refused"] is not None and q["finite_after"],
              "(i) allocation past the quota")
        check(0.40 <= share <= 0.60, f"(i) ran at {share:.3f}x")
        check(limit == NODE_QUOTA_MB * MiB and core == NODE_SM_LIMIT
              and pids == [q["pid"]], "(i) region")
        workload.close()   # checks the region is clean after the exit
        workload = None
        took = phase_took("(i) (the node agent; (j) apart)", start, name)
        # the exited pod's region directory goes, as the monitor's GC
        # removes it 300 s after the pod is deleted
        shutil.rmtree(os.path.dirname(cache))
        monitor = monitor_phase(name, solo_img_s, step_ms, plugin, sock,
                                chips[0], tmp)
        plugin.stop()
        plugin = None
    finally:
        if workload is not None and workload.proc.poll() is None:
            workload.proc.kill()
            workload.proc.wait(timeout=60)
        if plugin is not None and plugin.proc.poll() is None:
            plugin.proc.kill()
            plugin.proc.wait(timeout=60)
        if kubelet is not None:
            kubelet.stop(0)
        shutil.rmtree(tmp, ignore_errors=True)
    return [{"phase": "(i) node agent", "cards": len(chips),
            "nvml_init_ms": init_ms, "nvml_enumerate_ms": enum_ms,
            "plugin_nvml_init_ms": cold["init_ms"],
            "plugin_nvml_enumerate_ms": cold["enumerate_ms"],
            "phase_s": took,
            "allocate_ms": alloc_ms, "scheduler": extender,
            "numa_sources": {str(i): v for i, v in numa_sources.items()},
            "validator_exit": [validated["valid"][0],
                               validated["tampered"][0]],
            "quota_bytes": q["total"], "img_s": run["img_s"],
            "unthrottled_img_s": solo_img_s, "share": share,
            "plugin_used_mib_delta": used1 - used0,
            "plugin_libcuda_mapped": bool(libcuda)}, monitor]


# ------------------------------------------------------ (j) the node monitor.
# The monitor runs in its own process through its entry point
# (vtpu_torch.monitor.__main__.main) with an in-memory apiserver this script
# writes through the child's stdin/stdout, over phase (i)'s plugin's
# containers directory. It holds no CUDA context: NVML only.

MONITOR_CHILD = r"""
import json, os, signal, sys, threading, time
from vtpu_torch.monitor import daemon
from vtpu_torch.monitor.__main__ import main
from vtpu_torch.util.client import FakeKubeClient

argv = json.loads(sys.argv[1])
node = os.environ["NODE_NAME"]
# each sweep's latency, for the report (the histogram's buckets are coarse)
sweeps = []
sweep_once = daemon.MonitorDaemon.sweep_once


def timed(self):
    t0 = time.perf_counter()
    sweep_once(self)
    sweeps.append(time.perf_counter() - t0)


daemon.MonitorDaemon.sweep_once = timed
client = FakeKubeClient()
client.add_node(node)
out = sys.stdout
sys.stdout = sys.stderr


def serve():
    for line in sys.stdin:
        cmd = json.loads(line)
        op = cmd["op"]
        if op == "stop":
            os.kill(os.getpid(), signal.SIGINT)
            return
        if op == "add_pod":
            reply = client.add_pod(cmd["pod"])
        elif op == "delete_pod":
            client.delete_pod("default", cmd["name"])
            reply = {}
        elif op == "sweeps":
            reply = {"sweeps": list(sweeps)}
        else:
            reply = {"modules": sorted(
                m for m in sys.modules
                if m.split(".")[0] in ("torch", "jax", "vtpu"))}
        out.write(json.dumps(reply) + "\n")
        out.flush()


threading.Thread(target=serve, daemon=True).start()
main(argv, client=client)
print("stopped", file=out, flush=True)
"""

SWEEP_S = 1.0          # the monitor's sweep interval in (j)
# a released pod with an SM limit alone against the unthrottled img/s: it
# times spans as an unlimited pod does (+0.3-0.6%, phase (b))
RELEASED_SHARE = 0.95
SWEEPS_TO_ACT = 3      # what the monitor must do, it does within 3 sweeps
UTIL_WINDOW_S = 10.0   # two scrapes this far apart give HostCoreUtilization
MONITOR_PHASE_S = 120.0


# The GPU dashboards (docs/gpu/dashboard.json, deploy/grafana/
# gpu-shim-profile.json) held to one scrape of each daemon on the card:
# every selector naming a family the daemon serves must name a sample its
# family's type serves; the families below, which (i) and (j) fill, must
# hold one. Any other selector is printed as declared, with no sample: a
# preemption, an admission shed, a stage the monitor does not record.
MONITOR_FILLED = (
    "HostGPUMemoryCapacity", "HostGPUMemoryUsage", "HostCoreUtilization",
    "vGPU_device_memory_usage_in_bytes", "vGPU_device_memory_limit_in_bytes",
    "vGPUPodGPUMemoryLimit", "vGPU_container_program_launches",
    "vGPU_container_oom_events", "vGPUShimStale", "vGPUShimHeartbeatAge",
    "vGPUShimCallsiteLatency", "vGPUShimCallsiteCalls",
    "vGPUShimCallsiteErrors", "vGPUShimQuotaPressure",
    "vGPUShimPodQuotaPressure", "vGPUShimPodSeconds", "vGPUHostMemUsed",
    "vGPUHostMemLimit", "vGPUHostMemOOMEvents", "vGPUResizeApplied",
    "vGPUResizeClamped", "vGPUResizeBlocked", "vGPUResizeRefused",
    "vGPUHostQuotaOver", "vGPUHostQuotaBlocked", "vGPUHostQuotaUnblocked")
SCHEDULER_FILLED = (
    "vGPUDeviceMemoryAllocated", "vGPUDeviceMemoryLimit",
    "vGPUSchedulingStageLatency", "vGPUCommitQueueDepth",
    "vGPUAdmissionBatchSize", "vGPUCommitCoalesced", "vGPUCommitBulkWrites",
    "vGPURebalanceGrows", "vGPURebalanceShrinks",
    "vGPURebalanceSkippedHeadroom", "vGPUMigrationCandidates",
    "vGPUPreemptionVictims", "vGPUGangGroupTakeovers",
    "vGPUShardGroupOwner", "vGPUShardGroupTransitions")


def get_text(port: int, path: str = "/metrics") -> str:
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=10) as resp:
        return resp.read().decode()


def dashboard_check(name: str, label: str, exporter: str, port: int,
                    filled) -> dict:
    """One scrape of ``exporter`` on ``port`` held to the GPU dashboards
    (vtpu_torch.dashboards.hold); on the monitor, the quota-leakage panel
    evaluated on the same scrape and held under 0.02. One line for the
    selectors, one for the verdict (and one for the panel)."""
    t0 = time.perf_counter()
    text = get_text(port)
    lines, failures = dashboards.hold(text, exporter, filled)
    sampled = [t for t in lines if "matching" in t]
    print(f"{label} the GPU dashboards' selectors on one scrape of the "
          f"{exporter} (:{port}): " + "; ".join(lines) + f"; on {name}",
          flush=True)
    res = {"selectors": len(lines), "sampled": len(sampled),
           "declared_no_sample": len(lines) - len(sampled),
           "failures": failures}
    if exporter == "monitor":
        leak = dashboards.leakage(text)
        res["leakage"] = leak
        worst = max(leak.values()) if leak else None
        print(f"{label} the quota-leakage panel on that scrape, "
              f"{dashboards.LEAKAGE_EXPR}: "
              + ", ".join(f"{pod} {v:+.4f}" for pod, v in sorted(
                  leak.items()))
              + f"; the most {worst}, bound < {dashboards.LEAKAGE_BOUND}; "
              f"on {name}", flush=True)
        check(worst is not None and worst < dashboards.LEAKAGE_BOUND,
              f"{label} the leakage panel reads {leak}")
    res["check_s"] = time.perf_counter() - t0
    print(f"{label} the {exporter}'s dashboard selectors: {len(lines)}, "
          f"{len(sampled)} with samples, {len(lines) - len(sampled)} "
          f"declared with no sample, {len(failures)} failed; the checks "
          f"took {res['check_s']:.3f} s; on {name}", flush=True)
    check(not failures, f"{label} dashboards: {failures}")
    return res


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class MonitorChild:
    """The node monitor process and its in-memory apiserver, started with
    the chart's argv (chart_daemons)."""

    def __init__(self, tmp: str, chart: dict):
        self.metrics_port = chart["ports"]["metrics"]
        self.info_port = chart["ports"]["info"]
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("CUDA_", "LD_PRELOAD", "VGPU_"))}
        env["PYTHONPATH"] = ROOT
        env[api.ENV_NODE_NAME] = NODE_NAME
        self.errf = open(os.path.join(tmp, "monitor.err"), "w+")
        self.proc = subprocess.Popen(
            [sys.executable, "-c", MONITOR_CHILD,
             json.dumps(chart["argv"]["monitor"])],
            env=env, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=self.errf, text=True)

    def err(self) -> str:
        self.errf.seek(0)
        return self.errf.read()[-4000:]

    def ask(self, op: str, **args):
        self.proc.stdin.write(json.dumps(dict(args, op=op)) + "\n")
        self.proc.stdin.flush()
        ready, _, _ = select.select([self.proc.stdout], [], [], 60)
        line = self.proc.stdout.readline() if ready else ""
        if not line:
            raise SmokeFailure(f"monitor child gave no answer to {op}, rc "
                               f"{self.proc.poll()}:\n{self.err()}")
        return json.loads(line)

    def get(self, port: int, path: str) -> bytes:
        import urllib.request

        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=10) as resp:
            return resp.read()

    def wait_ready(self, timeout_s: float = 60.0) -> None:
        import urllib.error

        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            try:
                self.get(self.info_port, "/healthz")
                self.get(self.metrics_port, "/metrics")
                return
            except (urllib.error.URLError, ConnectionError, OSError):
                check(self.proc.poll() is None,
                      f"monitor child exited:\n{self.err()}")
                time.sleep(0.2)
        raise SmokeFailure(f"monitor not serving:\n{self.err()}")

    def scrape(self) -> dict:
        """family -> {frozenset(labels): value}, one GET /metrics"""
        from prometheus_client.parser import text_string_to_metric_families

        text = get_text(self.metrics_port)
        return {f.name: {frozenset(s.labels.items()): s.value
                         for s in f.samples}
                for f in text_string_to_metric_families(text)}

    def nodeinfo(self) -> dict:
        return json.loads(self.get(self.info_port, "/nodeinfo"))

    def stop(self) -> None:
        try:
            self.proc.stdin.write(json.dumps({"op": "stop"}) + "\n")
            self.proc.stdin.flush()
            out, _ = self.proc.communicate(timeout=60)
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.wait(timeout=60)
        check(self.proc.returncode == 0 and out.strip() == "stopped",
              f"monitor child rc {self.proc.returncode}:\n{self.err()}")


def card_gauge(fams: dict, family: str, uuid: str) -> float:
    (value,) = [v for labels, v in fams[family].items()
                if dict(labels)["deviceuuid"] == uuid]
    return value


def pod_gauge(fams: dict, family: str, uid: str) -> float:
    (value,) = [v for labels, v in fams[family].items()
                if dict(labels)["poduid"] == uid]
    return value


def nvml_utilization(uuid: str):
    """NVML's own utilization of the card, in percent (printed beside
    HostCoreUtilization, not gated)."""
    import ctypes

    from vtpu_torch.plugin.nvml import NvmlLib

    class Rates(ctypes.Structure):
        _fields_ = [("gpu", ctypes.c_uint), ("memory", ctypes.c_uint)]

    lib = NvmlLib()
    try:
        lib.enumerate()
        rates = Rates()
        rc = lib._lib.nvmlDeviceGetUtilizationRates(
            ctypes.c_void_p(lib.handle(uuid)), ctypes.byref(rates))
        return rates.gpu if rc == 0 else f"NVML error {rc}"
    finally:
        lib.close()


def monitor_phase(name: str, solo_img_s: float, step_ms: dict, plugin,
                  sock: str, chip, tmp: str) -> dict:
    """Phase (j): the node monitor over phase (i)'s plugin. Pods are case
    1.1 --sm-children started from Allocate responses (gpumem 12288 MiB),
    H, L and F ahead of their turns and held until then (as the compute
    children are);
    the monitor writes their feedback plane, exports the reference's
    families and serves /nodeinfo. Steps:

    1. pod H alone (priority 0, gpucores 50): released within 3 sweeps and
       runs at >= 0.95x unthrottled (a released pod times spans, not every
       launch); the memory gauges; HostCoreUtilization over two scrapes 10 s
       apart within 0.8-1.1x H's busy share (its CUDA-event step time over
       wall time);
    2. pod U with no gpucores alone: the same utilization bound (busy time
       is charged on a card with no SM limit); then pod U2, case 1.2 (host
       bound) with no gpucores alone: its HostCoreUtilization within
       0.8-1.1x its device-time share (torch.profiler's device time per
       step, in its own process, over its steps' wall time); its ratio to
       phase (b)'s CUDA-event step share printed;
    3. pod L (priority 1, gpucores 50) joins while H runs: both throttled
       and L blocked within 3 sweeps; L's launches stand still for 5 s and
       H runs at 0.40-0.60x;
    4. H exits: L unblocked within 3 sweeps; once H's directory is gone,
       released and at >= 0.95x;
    5. pod F alone under GPU_CORE_UTILIZATION_POLICY=force: never released,
       0.40-0.60x;
    6. the monitor's /nodeinfo, sweep latency, no context and no device
       memory; every region clean after its pod exits; under 120 s."""
    import grpc

    from vtpu_torch.plugin import deviceplugin_pb2 as pb
    from vtpu_torch.plugin import dp_grpc, runtime
    from vtpu_torch.plugin.rm import replica_id
    from vtpu_torch.util import nodelock, podutil, types

    start = time.perf_counter()
    containers = os.path.join(plugin.shim_dir, "containers")
    quota = NODE_QUOTA_MB * MiB
    pods = {}
    replicas = iter(range(1, SPLIT))

    def preallocate(label: str, cores: int, **env_extra) -> SmChild:
        """The pod, assigned as the scheduler would, allocated over the
        plugin's socket and its process started from the response (its
        container env adds only CUDA_TASK_PRIORITY and the policy, as a pod
        spec's would), held: it makes no CUDA context until
        :func:`allocate` gives it its turn."""
        pod_name, uid = f"smoke-{label.lower()}", f"smoke-uid-{label}"
        grant = types.ContainerDevice(uuid=chip.uuid, usedmem=NODE_QUOTA_MB,
                                      usedcores=cores)
        annos = podutil.device_annotations(NODE_NAME, [[grant]])
        annos[api.BIND_PHASE_ANNO] = types.BindPhase.ALLOCATING.value
        annos[api.BIND_TIME_ANNO] = str(time.time_ns())
        pod = {"metadata": {"name": pod_name, "namespace": "default",
                            "uid": uid, "annotations": annos},
               "spec": {"nodeName": NODE_NAME, "containers": [{
                   "name": "main", "resources": {"limits": {
                       api.RESOURCE_GPU: 1, api.RESOURCE_MEM: NODE_QUOTA_MB,
                       api.RESOURCE_CORES: cores}}}]},
               "status": {"phase": "Running"}}
        plugin.ask("add_pod", pod=pod)
        plugin.ask("patch_node", annos={api.NODE_LOCK_ANNO:
                                        nodelock.now_str()})
        with grpc.insecure_channel(sock) as ch:
            resp = dp_grpc.DevicePluginStub(ch).Allocate(pb.AllocateRequest(
                container_requests=[pb.ContainerAllocateRequest(
                    devicesIDs=[replica_id(chip.uuid, next(replicas))])]))
        (ctr,) = resp.container_responses
        env = {k: v for k, v in os.environ.items() if not k.startswith(
            ("CUDA_", "NVIDIA_", "LD_PRELOAD", "PYTORCH_CUDA_ALLOC_CONF"))}
        env["PYTHONPATH"] = ROOT
        env.update(runtime.process_env(ctr))
        env.update({k: str(v) for k, v in env_extra.items()})
        child = SmChild(f"(j) pod {label}", ahead=True,
                        given=(env, env[api.ENV_SHARED_CACHE]))
        child.uid, child.pod_name, child.pod = uid, pod_name, pod
        return child

    def allocate(label: str) -> SmChild:
        """The pod's turn: the monitor's apiserver learns of it, and its
        process (:func:`preallocate`) makes its context."""
        child = ahead.pop(label)
        monitor.ask("add_pod", pod=child.pod)
        child.go()
        pods[label] = child
        return child

    def gone(label: str) -> None:
        """The exited pod deleted, and its region directory with it (what
        the monitor's GC does 300 s after the deletion)."""
        child = pods.pop(label)
        monitor.ask("delete_pod", name=child.pod_name)
        shutil.rmtree(os.path.dirname(child.cache))
        # A card's HostCoreUtilization is the growth of its pods' summed
        # busy time between two scrapes, so a region that leaves between
        # them takes its busy time out of the sum and that scrape reads 0
        # (the JAX monitor's rule too, ROADMAP queue 3): the next reading
        # starts once the monitor's sweeps no longer list the pod.
        within_sweeps(lambda: all(
            dict(labels)["poduid"] != child.uid for labels in monitor.scrape(
            ).get("vGPU_device_memory_usage_in_bytes", {})),
            f"{label}'s region dropped by the monitor")

    def feedback(child: SmChild):
        with child.view() as view:
            return (view.recent_kernel, view.utilization_switch,
                    view.total_launches())

    def within_sweeps(cond, what: str) -> float:
        """Seconds until cond() held; fails past SWEEPS_TO_ACT sweeps
        (and one sweep of slack for the interposer's 100 ms publish)."""
        t0 = time.monotonic()
        while not cond():
            check(time.monotonic() - t0 <= (SWEEPS_TO_ACT + 1) * SWEEP_S,
                  f"(j) {what}: not within {SWEEPS_TO_ACT} sweeps")
            time.sleep(0.05)
        return time.monotonic() - t0

    def region_busy(child: SmChild):
        """(the child's region's busy ns, monotonic s when read)"""
        with child.view() as view:
            return view.busy_ns(), time.monotonic()

    def utilization(child: SmChild, seconds: float, case_name: str = "1.1"):
        """HostCoreUtilization over two scrapes UTIL_WINDOW_S apart while
        child runs the case alone; (gauge share, the child's busy share by
        phase (b)'s step time, the run, NVML's utilization meanwhile, and
        the window: the region's own busy share between the scrapes and
        the age of the snapshot each scrape served)"""
        child.send("run", seconds=seconds, case=case_name)
        time.sleep(0.5)
        ages = [monitor.scrape()["vGPUMonitorSnapshotAge"][frozenset()]]
        b0, t0 = region_busy(child)
        time.sleep(UTIL_WINDOW_S / 2)
        nvml = nvml_utilization(chip.uuid)
        time.sleep(max(0.0, t0 + UTIL_WINDOW_S - time.monotonic()))
        fams = monitor.scrape()
        b1, t1 = region_busy(child)
        ages.append(fams["vGPUMonitorSnapshotAge"][frozenset()])
        gauge = card_gauge(fams, "HostCoreUtilization", chip.uuid) / 100.0
        run = child.read()
        busy = run["calls"] * step_ms[case_name] / 1e3 / run["wall_s"]
        window = {"region_share": (b1 - b0) / 1e9 / (t1 - t0),
                  "snapshot_ages_s": ages}
        return gauge, busy, run, nvml, window

    used0, apps0 = card_used_mb(), compute_apps()
    check(f"--containers-dir={containers}" in plugin.chart["argv"]["monitor"],
          f"the monitor's argv {plugin.chart['argv']['monitor']}")
    monitor = MonitorChild(tmp, plugin.chart)
    ahead = {}
    try:
        # pod H's interpreter loads while the monitor starts
        ahead["H"] = preallocate("H", NODE_SM_LIMIT, CUDA_TASK_PRIORITY=0)
        monitor.wait_ready()
        time.sleep(3 * SWEEP_S)
        used1, apps1 = card_used_mb(), compute_apps()
        modules = monitor.ask("modules")["modules"]
        check(modules == [], f"(j) the monitor imported {modules}")
        check(used1 - used0 < CONTEXT_MARGIN_MB and apps1 == apps0,
              f"(j) the monitor took device memory ({used0} -> {used1} "
              f"MiB) or a context ({apps0} -> {apps1} processes)")

        # 1. pod H alone
        h = allocate("H")
        h.ask("step")
        lift_s = within_sweeps(lambda: feedback(h)[1] == 1,
                               "H alone released")
        gauge, busy, run, nvml, _ = utilization(h, UTIL_WINDOW_S + 1.5)
        share = run["img_s"] / solo_img_s
        mem = h.ask("mem")
        reserved, fp = mem["reserved"], mem["footprint"]["bytes"]
        time.sleep(1.5 * SWEEP_S)
        fams = monitor.scrape()
        usage = pod_gauge(fams, "vGPU_device_memory_usage_in_bytes", h.uid)
        limit = pod_gauge(fams, "vGPU_device_memory_limit_in_bytes", h.uid)
        capacity = card_gauge(fams, "HostGPUMemoryCapacity", chip.uuid)
        host_usage = card_gauge(fams, "HostGPUMemoryUsage", chip.uuid)
        pod_usage = sum(fams["vGPU_device_memory_usage_in_bytes"].values())
        print(f"(j) 1. pod H alone (priority 0, gpucores 50): released "
              f"(utilization_switch 1) {lift_s:.2f} s after its first step; "
              f"{run['img_s']:.1f} img/s, {share:.3f}x the unthrottled "
              f"{solo_img_s:.1f}; HostCoreUtilization over "
              f"{UTIL_WINDOW_S:.0f} s {gauge:.4f} against its busy share "
              f"{busy:.4f} ({gauge / busy:.3f}x; NVML utilization {nvml}%); "
              f"usage {usage:.0f} B, of it the footprint {fp} B, vs "
              f"memory_reserved {reserved} B (+"
              f"{(usage - fp - reserved) / MiB:.1f} MiB), limit {limit:.0f} B, "
              f"card capacity {capacity:.0f} B, HostGPUMemoryUsage "
              f"{host_usage:.0f} B; on {name}", flush=True)
        check(share >= RELEASED_SHARE, f"(j) H alone ran at {share:.3f}x")
        check(0.8 <= gauge / busy <= 1.1,
              f"(j) H's utilization {gauge:.4f} vs busy {busy:.4f}")
        check(limit == quota, f"(j) limit gauge {limit}")
        check(0 <= usage - fp - reserved <= RESERVED_MARGIN,
              f"(j) usage gauge {usage} less the footprint {fp} vs reserved "
              f"{reserved}")
        check(capacity == chip.hbm_mb * MiB, f"(j) capacity {capacity}")
        check(host_usage == pod_usage, f"(j) HostGPUMemoryUsage "
              f"{host_usage} vs the pods' {pod_usage}")
        result = {"phase": "(j) node monitor", "h_release_s": lift_s,
                  "h_share": share, "h_util_gauge": gauge, "h_busy": busy,
                  "h_nvml_util": nvml, "h_footprint": fp,
                  "h_usage_minus_footprint_minus_reserved":
                      usage - fp - reserved}

        # 2. pod U with no gpucores, alone (H idle); pod U2 (case 1.2) starts
        # beside it and warms up before either is measured. Pod L's
        # interpreter loads meanwhile: held and idle, it changes nothing
        # this step measures (U and U2 run with no SM limit), and its
        # region is made as torch loads (libvgpu.so attaches at the first
        # resolution of a hooked entry point), so it starts no sooner:
        # before H alone was measured it would have made H share the card
        ahead["U"] = preallocate("U", 0)
        ahead["U2"] = preallocate("U2", 0)
        u = allocate("U")
        u2_start = time.perf_counter()
        u2 = allocate("U2")
        ahead["L"] = preallocate("L", NODE_SM_LIMIT, CUDA_TASK_PRIORITY=1)
        u.ask("step")
        u2.ask("run", case="1.2", seconds=0.5)
        u2_s = time.perf_counter() - u2_start
        gauge, busy, run, nvml, window = utilization(u, UTIL_WINDOW_S + 1.5)
        print(f"(j) 2. pod U with no SM limit alone: HostCoreUtilization "
              f"over {UTIL_WINDOW_S:.0f} s {gauge:.4f} against its busy "
              f"share {busy:.4f} ({gauge / busy:.3f}x; NVML utilization "
              f"{nvml}%); its region {window['region_share']:.4f} of the "
              f"window; {run['img_s']:.1f} img/s; on {name}", flush=True)
        check(0.8 <= gauge / busy <= 1.1,
              f"(j) U's utilization {gauge:.4f} vs busy {busy:.4f}")
        result.update(u_util_gauge=gauge, u_busy=busy, u_nvml_util=nvml)
        u.close()
        gone("U")
        u2_start = time.perf_counter()
        gauge, step_busy, run, nvml, window = utilization(
            u2, UTIL_WINDOW_S + 1.5, "1.2")
        dev = u2.ask("device_ms", case="1.2", steps=5)
        busy = run["calls"] * dev["device_ms"] / 1e3 / run["wall_s"]
        charged = run["launch_ns"] / 1e9 / run["wall_s"]
        print(f"(j) 2b. pod U2, case 1.2 (host bound) with no SM limit alone: "
              f"HostCoreUtilization over {UTIL_WINDOW_S:.0f} s {gauge:.4f} "
              f"against its busy share {busy:.4f} ({gauge / busy:.3f}x; "
              f"torch.profiler: {dev['device_ms']:.3f} ms of device time in "
              f"a {dev['wall_ms']:.3f} ms step) and phase (b)'s CUDA-event "
              f"step share {step_busy:.4f} ({gauge / step_busy:.3f}x; "
              f"{step_ms['1.2']:.3f} ms a step, another process's, host "
              f"gaps in it); libvgpu.so charged it {charged:.4f} of its run "
              f"({charged / busy:.3f}x its busy share), its region "
              f"{window['region_share']:.4f} of the window (snapshots "
              f"{window['snapshot_ages_s'][0]:.3f} s and "
              f"{window['snapshot_ages_s'][1]:.3f} s old at the scrapes); "
              f"its sampled spans busy {run['span_busy']:.4f} of their time "
              f"at the run's end ({run['span_samples']} samples in it); "
              f"NVML utilization {nvml}%; {run['img_s']:.1f} img/s; on "
              f"{name}", flush=True)
        check(0.8 <= gauge / busy <= 1.1,
              f"(j) U2's utilization {gauge:.4f} vs busy {busy:.4f}")
        result.update(u2_util_gauge=gauge, u2_busy=busy,
                      u2_step_busy=step_busy, u2_charged=charged,
                      u2_region_share=window["region_share"],
                      u2_snapshot_ages_s=window["snapshot_ages_s"],
                      u2_nvml_util=nvml, u2_device_ms=dev["device_ms"],
                      u2_wall_ms=dev["wall_ms"],
                      u2_span_busy=run["span_busy"],
                      u2_span_samples=run["span_samples"])
        u2.close()
        gone("U2")
        u2_s += time.perf_counter() - u2_start

        # 3. pod L joins while H runs
        lo = allocate("L")
        lo.ask("step")
        within_sweeps(lambda: feedback(h)[1] == 0 and feedback(lo)[1] == 0,
                      "H and L both throttled")
        h.send("run", seconds=12.0)
        block_s = within_sweeps(lambda: feedback(lo)[0] == FEEDBACK_BLOCK,
                                "L blocked while H runs")
        lo.send("run", seconds=4.0)
        time.sleep(0.5)
        held = feedback(lo)[2]
        info = {e["entry"]: e for e in monitor.nodeinfo()["containers"]}
        # the dashboards on the live scrape, inside the 5 s L stands still
        t0 = time.monotonic()
        dash = dashboard_check(name, "(j)", "monitor", monitor.metrics_port,
                               MONITOR_FILLED)
        time.sleep(max(0.0, 5.0 - (time.monotonic() - t0)))
        still = feedback(lo)[2]
        h_run = h.read()
        h_share = h_run["img_s"] / solo_img_s
        live = {os.path.basename(os.path.dirname(c.cache)): c
                for c in pods.values()}
        print(f"(j) 3. pod L (priority 1) joins while H runs: both "
              f"throttled, L blocked {block_s:.2f} s after H started; L's "
              f"region launches {held} -> {still} over 5 s; H at "
              f"{h_share:.3f}x; /nodeinfo "
              f"{[(e, info[e]['pod_name'], info[e]['hbm_limit'], info[e]['hbm_used']) for e in sorted(info)]}; "
              f"on {name}", flush=True)
        check(still == held, f"(j) L launched while blocked: {held} -> "
              f"{still}")
        check(0.40 <= h_share <= 0.60, f"(j) H beside L at {h_share:.3f}x")
        check(sorted(info) == sorted(live), f"(j) /nodeinfo lists "
              f"{sorted(info)}, live {sorted(live)}")
        for entry, child in live.items():
            check(info[entry]["pod_name"] == child.pod_name
                  and info[entry]["hbm_limit"] == [quota]
                  and info[entry]["hbm_used"][0] > 0,
                  f"(j) /nodeinfo entry {info[entry]}")
        result.update(l_block_s=block_s, h_share_beside_l=h_share,
                      dashboards=dash)

        # 4. H exits
        h.close()
        unblock_s = within_sweeps(
            lambda: feedback(lo)[0] != FEEDBACK_BLOCK, "L unblocked")
        lo.read()
        moved = feedback(lo)[2]
        gone("H")
        release_s = within_sweeps(lambda: feedback(lo)[1] == 1,
                                  "L alone released")
        l_share = lo.ask("run", seconds=4.0)["img_s"] / solo_img_s
        print(f"(j) 4. H exits: L unblocked within {unblock_s:.2f} s, its "
              f"region launches {still} -> {moved}; with H's directory "
              f"gone, released within {release_s:.2f} s; L at "
              f"{l_share:.3f}x; on {name}", flush=True)
        check(moved > still, "(j) L did not launch after H exited")
        check(l_share >= RELEASED_SHARE, f"(j) L alone ran at {l_share:.3f}x")
        result.update(l_unblock_s=unblock_s, l_release_s=release_s,
                      l_share=l_share)
        # pod F's interpreter loads while L exits
        ahead["F"] = preallocate("F", NODE_SM_LIMIT,
                                GPU_CORE_UTILIZATION_POLICY="force")
        lo.close()
        gone("L")

        # 5. pod F alone under the force policy
        f = allocate("F")
        f.ask("step")
        f.send("run", seconds=8.0)
        switches = set()
        t0 = time.monotonic()
        while time.monotonic() - t0 < 7.0:
            switches.add(feedback(f)[1])
            time.sleep(0.25)
        f_share = f.read()["img_s"] / solo_img_s
        print(f"(j) 5. pod F alone under the force policy: "
              f"utilization_switch {sorted(switches)} over 7 s, "
              f"{f_share:.3f}x; on {name}", flush=True)
        check(switches == {0}, f"(j) F released: {switches}")
        check(0.40 <= f_share <= 0.60, f"(j) F at {f_share:.3f}x")
        result["f_share"] = f_share
        f.close()
        gone("F")

        # 6. the monitor process
        sweeps = sorted(monitor.ask("sweeps")["sweeps"])
        p50, top = sweeps[len(sweeps) // 2] * 1e3, sweeps[-1] * 1e3
        used2, apps2 = int(smi("memory.used")[0]), compute_apps()
        # pod U2 is this phase's addition: its time is accounted apart, and
        # the steps the bound was set for are held to it
        took = time.perf_counter() - start - u2_s
        print(f"(j) 6. the monitor: {len(sweeps)} sweeps, latency p50 "
              f"{p50:.3f} ms, max {top:.3f} ms; card memory used {used0} -> "
              f"{used1} MiB with the monitor alone ({used2} at the end), "
              f"compute processes {apps0} -> {apps1}; no torch/jax/vtpu "
              f"module; every region clean after its pod exited; the phase "
              f"took {took:.1f} s, and pod U2 {u2_s:.1f} s more; on {name}",
              flush=True)
        phase_took(f"(j) (pod U2's {u2_s:.1f} s included)", start, name)
        check(took < MONITOR_PHASE_S, f"(j) took {took:.1f} s")
        result.update(sweeps=len(sweeps), sweep_p50_ms=p50,
                      sweep_max_ms=top, monitor_used_mib_delta=used1 - used0,
                      phase_s=took, u2_s=u2_s)
        monitor.stop()
        monitor = None
    finally:
        for child in list(pods.values()) + list(ahead.values()):
            if child.proc.poll() is None:
                child.proc.kill()
                child.proc.wait(timeout=60)
        if monitor is not None and monitor.proc.poll() is None:
            monitor.proc.kill()
            monitor.proc.wait(timeout=60)
    return result


# ------------------------------------- (n) the scheduler at cluster scale.
# python -m vtpu_torch.scheduler.loadtest: the port's scheduler daemon on
# an in-memory apiserver of 1,024 nodes x 8 of this card (NVML's type
# string and MiB, 10 replicas a card, NUMA 0,0,0,0,1,1,1,1, no mesh
# coordinate), a seeded stream of 8,192 pods through /webhook, /filter
# and /bind, in a child that imports no torch
CLUSTER_NODES = 1024
CLUSTER_PODS = 8192
CLUSTER_SEED = 0
CLUSTER_TIMEOUT_S = 600
# the load test runs beside phase (l), whose gates read only the card's
# memory (the scheduler takes none); before (l) starts it runs alone for
# this long, its daemon up and serving, while the card is watched (10 s
# before the script was cut to 1,000 s: whether the scheduler's processes
# hold a context or device memory does not grow with the watch)
CLUSTER_ALONE_S = 5.0


# phase (o): one live move at livemove's defaults, the offload model at a
# realistic size (dim 1024, layers 4096 x 3, batch 256: 37,765,121 f32
# parameters, 453,181,452 B of parameters and Adam moments on the host,
# under a 1 GiB host limit)
MOVE_TIMEOUT_S = 240
# the card's used memory after the phase against before it: the pods'
# contexts and caches gone (what a context holds, PERF.md)
MOVE_MEMORY_MARGIN_MB = 256


def livemove_phase(name: str) -> dict:
    """Phase (o): ``python -m vtpu_torch.scheduler.livemove`` on the card:
    the port's scheduler with the rebalancer and the migration planner on,
    a device plugin and a node monitor for each of two nodes (both register
    this card: node to node for the scheduler, card to the same card), and
    MigratableModel pods under libvgpu.so started from Allocate responses.
    Its gates, held there: the source's host ledger grows at setup by
    1.00-1.01x the model's host bytes (libvgpu.so charges the pinned
    tensors; no second, cooperative charge), the snapshot adds exactly the
    host bytes, the drained source's region launches stand still from the
    monitor's block to 2 s past the cutover, the cutover rewrites the
    assignment to the destination node, the destination attaches and the
    source's snapshot charge is then released to the byte, and the
    destination's 3 losses after the resume equal a control pod's 3 after
    the same prefix (rel 1e-6, abs 1e-7). Here: the card's used memory is
    back within 256 MiB of its value before the phase; each protocol
    step's time and the step's ms are printed."""
    t0 = time.perf_counter()
    before = card_used_mb()
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("CUDA_", "LD_PRELOAD", "VGPU_",
                                "PYTORCH_CUDA_ALLOC_CONF"))}
    env.update({"PYTHONPATH": ROOT, api.ENV_LOCK_DIR: run_lock_dir()})
    tmp = tempfile.mkdtemp(prefix="vgpu-smoke-move-")
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "vtpu_torch.scheduler.livemove"],
            env=dict(env, TMPDIR=tmp), cwd=tmp,
            capture_output=True, text=True, timeout=MOVE_TIMEOUT_S)
    except subprocess.TimeoutExpired as e:
        said = e.stderr.decode(errors="replace") if isinstance(
            e.stderr, bytes) else e.stderr or ""
        raise SmokeFailure(f"(o) no result in {MOVE_TIMEOUT_S} s:\n"
                           f"{said[-4000:]}") from None
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    try:
        res = json.loads(proc.stdout.strip().splitlines()[-1])
    except (ValueError, IndexError):
        res = {"ok": False}
    check(proc.returncode == 0 and res.get("ok"),
          f"(o) live move rc {proc.returncode}: {res}\n"
          f"{proc.stderr[-4000:]}")
    time.sleep(1.0)  # the pods' contexts leave the card
    after = card_used_mb()
    check(abs(after - before) <= MOVE_MEMORY_MARGIN_MB,
          f"(o) the card's used memory {before} -> {after} MiB")
    step_ms = sorted(res["step_ms"])[len(res["step_ms"]) // 2]
    print(f"(o) live move: {res['host_bytes']} B of host state, setup "
          f"grew the ledger {res['setup_growth']:.6f}x, the snapshot "
          f"{res['snapshot_growth_bytes']} B, released "
          f"{res['release_bytes']} B; {res['steps_before_drain']} steps "
          f"before the drain, step {step_ms:.2f} ms (median); mark to "
          f"stamp {res['mark_to_stamp_s']:.3f} s, drain to ack "
          f"{res['stamp_to_ack_s']:.3f} s, ack to cutover "
          f"{res['ack_to_cutover_s']:.3f} s, blackout (planner) "
          f"{res['blackout_s']:.4f} s, cutover to complete "
          f"{res['cutover_to_complete_s']:.3f} s; launches while drained "
          f"{res['blocked_launches']}; losses max rel err "
          f"{res['loss_max_rel_err']:.3g}; card {before} -> {after} MiB; "
          f"phase {time.perf_counter() - t0:.1f} s; on {name}", flush=True)
    phase_took("(o)", t0, name)
    return {"phase": "(o) live move", **{k: v for k, v in res.items()
                                         if k != "ok"},
            "step_ms_median": step_ms, "card_used_mib": [before, after],
            "took_s": time.perf_counter() - t0}


# ----------------------------------------------------------- (p) serving.
# One tenant's model split across a gang of two pods, each under its own
# quota on the card, then a fleet of two solo replicas behind the gateway.
# The configuration: dim 8192, hidden 28672, classes 8192, f32: the hidden
# and MLP widths of Llama-2-70B's published config (hidden_size 8192,
# intermediate_size 28672), as one tanh MLP layer and a classifier.
SERVE_DIM, SERVE_HIDDEN, SERVE_CLASSES, SERVE_SEED = 8192, 28672, 8192, 0
# a member of two holds W1[:, 14336-wide], b1 and W2's 14336 rows; a solo
# replica the whole model (f32)
SERVE_MEMBER_BYTES = 939_581_440
SERVE_SOLO_BYTES = 1_879_162_880
SERVE_MEMBER_QUOTA = 3 * GiB
SERVE_FLEET_QUOTA = 8 * GiB
SERVE_BATCHES, SERVE_ROWS, SERVE_BATCH_SEED = 8, 64, 11
# the gang against the unsharded forward on the card (f32, TF32 off), and
# at the JAX defaults as tests/test_e2e.py holds them
SERVE_REL_L2 = 1e-5
SERVE_SMALL_MAX_ABS = 1e-4
# (p2): open-loop arrivals from 3 tenants at 2,000 requests/s for 5 s;
# each result row against its replica's forward of that row alone
FLEET_RATE, FLEET_SECONDS, FLEET_TENANTS = 2000.0, 5.0, ("a", "b", "c")
FLEET_ROW_REL_L2 = 1e-4


def serve_batches() -> list:
    """(p1)'s batches, drawn on the host from one seed: every member and
    the parent hold the same rows"""
    g = torch.Generator().manual_seed(SERVE_BATCH_SEED)
    return [torch.randn(SERVE_ROWS, SERVE_DIM, generator=g)
            for _ in range(SERVE_BATCHES)]


def serve_small_batch():
    """the JAX end to end's gang input (tests/test_e2e.py): 8 rows of the
    default model's 64 features, RandomState(7)"""
    import numpy as np
    return np.random.RandomState(7).randn(8, 64).astype("float32")


def serve_child(role: str) -> None:
    """Runs in a --serve-child process (``role`` member or fleet) under
    libvgpu.so: draws the model's weights on the host (a member keeps its
    shard of them), says so, and touches the card only at the parent's
    command; one JSON reply per JSON command."""
    import numpy as np

    from vtpu_torch.gateway import (Replica, ReplicaBatcher, ReplicaSet,
                                    Router)
    from vtpu_torch.models import serving
    from vtpu_torch.scheduler.core import ShedError

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    model = serving.ShardedServingModel(dim=SERVE_DIM, hidden=SERVE_HIDDEN,
                                        classes=SERVE_CLASSES,
                                        seed=SERVE_SEED)
    full = model._full_params()
    host = model.shard(full) if role == "member" else full
    del full
    if role == "member":
        batches = serve_batches()
    else:
        rng = np.random.default_rng(SERVE_BATCH_SEED)
        n = int(FLEET_RATE * FLEET_SECONDS)
        rows = rng.standard_normal((n, SERVE_DIM), dtype=np.float32)
    print(json.dumps({"staged": True,
                      "host_s": time.perf_counter() - t0}), flush=True)

    def op_member(cmd):
        enf = install()
        t = time.perf_counter()
        model.setup(host_shard=host)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t
        outs, step_ms = [], []
        for x in batches:
            outs.append(model.infer(x))
            step_ms.append(model.stats.last_step_seconds * 1e3)
        np.save(cmd["out"], torch.cat(outs).cpu().numpy())
        small, small_stats = serving.run_member(dict(os.environ),
                                                serve_small_batch(),
                                                hidden=256)
        np.save(cmd["out_small"], small.cpu().numpy())
        stats = model.stats
        return {"member": stats.member, "members": stats.members,
                "hidden_shard": stats.hidden_shard,
                "param_bytes": stats.param_bytes,
                "local_devices": stats.local_devices,
                "small_members": small_stats.members,
                "setup_s": setup_s, "step_ms": step_ms, "used": enf.used(),
                "footprint": enf.footprint()}

    def op_fleet(cmd):
        enf = install()
        t = time.perf_counter()
        rs = ReplicaSet("p2")
        for i in range(2):
            m = serving.ShardedServingModel(
                dim=SERVE_DIM, hidden=SERVE_HIDDEN, classes=SERVE_CLASSES,
                seed=SERVE_SEED)
            m.setup(params=host)
            # the process's one-time costs (cuBLAS's handle, each shape's
            # kernels) paid here, outside both batchers: the replica
            # stepped first would otherwise carry them in its latency
            # EWMA, and the router, which scores by that EWMA, would
            # never pick it again
            for bucket in (1, 2, 4, 8, 16, 32, 64):
                m.infer(torch.from_numpy(rows[:bucket]))
            rs.add(Replica(name=f"r{i}", batcher=ReplicaBatcher(m)))
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t
        replicas = rs.list()
        # the first pass: every bucket of each replica once
        buckets = {r.name: set() for r in replicas}
        for r in replicas:
            b, bucket = r.batcher, r.batcher.batch_min
            while True:
                saved, b.batch = b.batch, bucket
                for _ in range(bucket):
                    b.submit("warmup", rows[0])
                buckets[r.name].add(b.step().bucket)
                b.batch = saved
                if bucket >= b.batch_max:
                    break
                bucket *= 2
        first = {r.name: (r.batcher.recompiles, r.batcher.steps,
                          r.batcher.model.stats.step_seconds_total)
                 for r in replicas}
        router = Router(rs)
        n = len(rows)
        served_by, done, shed = {}, [], 0
        t0 = time.perf_counter()
        i = 0
        while len(done) + shed < n:
            now = time.perf_counter()
            while i < n and t0 + i / FLEET_RATE <= now:
                try:
                    router.submit(FLEET_TENANTS[i % 3], rows[i],
                                  now=t0 + i / FLEET_RATE)
                except ShedError:
                    shed += 1
                i += 1
            for r in replicas:
                res = r.batcher.step()
                if res is not None:
                    buckets[r.name].add(res.bucket)
                    for req in res.requests:
                        served_by[id(req)] = r.name
                    done.extend(res.requests)
        wall = max(req.completed_at for req in done) - t0
        lat = sorted(req.latency for req in done)
        steps = {r.name: r.batcher.steps - first[r.name][1]
                 for r in replicas}
        step_ms = {r.name: (r.batcher.model.stats.step_seconds_total
                            - first[r.name][2]) / max(1, steps[r.name])
                   * 1e3 for r in replicas}
        # each result row against its replica's forward of that row alone
        models = {r.name: r.batcher.model for r in replicas}
        worst = 0.0
        t = time.perf_counter()
        for req in done:
            solo = models[served_by[id(req)]].infer(
                torch.from_numpy(req.payload[None]))[0].double().cpu()
            got = torch.from_numpy(req.result).double()
            worst = max(worst, float((got - solo).norm() / solo.norm()))
        check_s = time.perf_counter() - t
        return {"requests": n, "completed": len(done),
                "unique": len({id(req) for req in done}),
                "all_done": all(req.done for req in done), "shed": shed,
                "p50_ms": lat[len(lat) // 2] * 1e3,
                "p99_ms": lat[min(len(lat) - 1, int(0.99 * len(lat)))]
                * 1e3, "rps": len(done) / wall, "wall_s": wall,
                "served": {name: sum(1 for q in done
                                     if served_by[id(q)] == name)
                           for name in models},
                "steps": steps, "mean_batch": len(done) / sum(
                    steps.values()), "step_ms": step_ms,
                "recompiles": {r.name: r.batcher.recompiles
                               for r in replicas},
                "recompiles_first_pass": {k: v[0]
                                          for k, v in first.items()},
                "buckets": {k: sorted(v) for k, v in buckets.items()},
                "row_rel_l2_max": worst, "check_s": check_s,
                "setup_s": setup_s, "param_bytes": [
                    m.stats.param_bytes for m in models.values()],
                "used": enf.used(), "footprint": enf.footprint()}

    op = {"member": op_member, "fleet": op_fleet}[role]
    for line in sys.stdin:
        try:
            reply = op(json.loads(line))
        except Exception as e:  # reported to the parent, which fails
            reply = {"error": f"{type(e).__name__}: {e}"}
        print(json.dumps(reply), flush=True)


class ServeChild(SmChild):
    """A --serve-child process under libvgpu.so with its own region file
    and ``quota``: it draws its weights on the host at once and reaches the
    card only at its command (:meth:`ready` reads its "staged" line)."""

    def __init__(self, label: str, role: str, quota: int, extra_env=None):
        self.label = label
        self.context_only = False
        self.tmp, self.cache, env = child_env("", quota)
        env.update(extra_env or {})
        self.errf = open(os.path.join(self.tmp, "child.err"), "w+")
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--serve-child",
             role], env=env, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=self.errf, text=True)
        _HELD.append(self)

    def charged(self) -> int:
        """the bytes the child's region holds now (its footprint charge
        and every allocation)"""
        with self.view() as view:
            return view.used(0)


def serve_children() -> dict:
    """Phase (p)'s three children and the parent's reference weights,
    started ahead, beside phase (o): each child draws its weights on the
    host and waits; none touches the card before its turn."""
    from vtpu_torch.models import serving

    mesh = {api.ENV_MESH_SHAPE: "2,1,1", api.ENV_MESH_AXES: "x,y,z"}
    model = serving.ShardedServingModel(
        mesh=serving.MeshSpec(), dim=SERVE_DIM, hidden=SERVE_HIDDEN,
        classes=SERVE_CLASSES, seed=SERVE_SEED)
    return {"members": [ServeChild(
                f"(p1) member {m}", "member", SERVE_MEMBER_QUOTA,
                dict(mesh, **{api.ENV_MESH_COORDS: f"{m}-0-0"}))
                for m in range(2)],
            "fleet": ServeChild("(p2) fleet", "fleet", SERVE_FLEET_QUOTA),
            "reference": futures.ThreadPoolExecutor(1).submit(
                model._full_params)}


def serving_phase(name: str, children: dict) -> list:
    """Phase (p), its children started ahead (:func:`serve_children`):
    (p1) a gang of two pods, each under libvgpu.so with its
    own region and a 3 GiB quota, serves one model split the Megatron way
    (the mesh env the plugin's ``_pod_mesh_env`` writes for a 2x1x1 slice
    gang, set by this script as the north star sets Allocate's: a two-host
    gang on one card needs host coordinates NVML does not give). Each
    member serves the same 8 batches of 64 rows; their partials summed
    equal the unsharded forward on the card (f32, TF32 off) within
    relative L2 1e-5, and at the JAX defaults (64/256/16) within max abs
    1e-4; each member holds exactly its shard (939,581,440 B) and its
    region's charge is at least that and under its quota; the regions are
    clean after the members exit. (p2) one pod under an 8 GiB quota holds
    two solo replicas (1,879,162,880 B each) behind ReplicaSet and Router
    with ReplicaBatcher's defaults (batch 1-64, queue 256, SLO 50 ms): 3
    tenants' open-loop arrivals at 2,000 requests/s for 5 s, each request
    done exactly once and none shed, each result row within relative L2
    1e-4 of its replica's forward of that row alone, recompiles equal to
    the distinct buckets reached and none after the first pass, both
    replicas served, the region's charge at least both replicas and under
    the quota. The request latency p50/p99, requests/s, mean batch and
    step ms are printed, not gated."""
    import numpy as np

    from vtpu_torch.models import serving

    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="vgpu-smoke-serve-")
    members, fleet = children["members"], children["fleet"]
    try:
        ref_params = children["reference"].result()
        staged = [c.ready()["host_s"] for c in members]
        for m, c in enumerate(members):
            c.send("serve", out=os.path.join(tmp, f"p{m}.npy"),
                   out_small=os.path.join(tmp, f"s{m}.npy"))
        got = [c.read() for c in members]
        charged = [c.charged() for c in members]
        for m, c in enumerate(members):
            c.close()   # checks the region is clean after the exit
        with NoTF32():
            x = torch.cat(serve_batches())
            ref = serving.reference_logits(
                x, SERVE_DIM, SERVE_HIDDEN, SERVE_CLASSES,
                params=ref_params)
            combined = serving.combine_partials([
                torch.from_numpy(np.load(os.path.join(tmp, f"p{m}.npy")))
                for m in range(2)]).cuda()
            err = rel_l2(combined, ref)
            small = serving.combine_partials([
                torch.from_numpy(np.load(os.path.join(tmp, f"s{m}.npy")))
                for m in range(2)]).cuda()
            small_err = float((small - serving.reference_logits(
                serve_small_batch())).abs().max())
        del ref_params, ref, combined
        torch.cuda.empty_cache()
        p1_s = time.perf_counter() - t0
        step_ms = [sorted(g["step_ms"])[len(g["step_ms"]) // 2]
                   for g in got]
        print(f"(p1) gang of 2 at dim {SERVE_DIM}, hidden {SERVE_HIDDEN}, "
              f"classes {SERVE_CLASSES}, f32: members "
              f"{[g['member'] for g in got]} of "
              f"{[g['members'] for g in got]}, hidden shard "
              f"{[g['hidden_shard'] for g in got]}, param bytes "
              f"{[g['param_bytes'] for g in got]}, region charge "
              f"{charged} B (quota {SERVE_MEMBER_QUOTA} B, footprint "
              f"{[g['footprint']['bytes'] for g in got]} B); "
              f"{SERVE_BATCHES} batches of {SERVE_ROWS}: step ms (median) "
              f"{[round(v, 3) for v in step_ms]}, combined vs the "
              f"unsharded forward rel L2 {err:.3g} (bound "
              f"{SERVE_REL_L2:g}); at 64/256/16 max abs {small_err:.3g} "
              f"(bound {SERVE_SMALL_MAX_ABS:g}); host weights "
              f"{[round(v, 2) for v in staged]} s, setup "
              f"{[round(g['setup_s'], 3) for g in got]} s; {p1_s:.1f} s; "
              f"on {name}", flush=True)
        for g, c in zip(got, charged):
            check(g["members"] == 2 and g["small_members"] == 2
                  and g["hidden_shard"] == SERVE_HIDDEN // 2
                  and g["param_bytes"] == SERVE_MEMBER_BYTES,
                  f"(p1) member stats {g}")
            check(SERVE_MEMBER_BYTES <= c < SERVE_MEMBER_QUOTA,
                  f"(p1) region charge {c} B")
        check(sorted(g["member"] for g in got) == [0, 1],
              "(p1) members")
        check(err <= SERVE_REL_L2, f"(p1) combined rel L2 {err}")
        check(small_err < SERVE_SMALL_MAX_ABS,
              f"(p1) 64/256/16 max abs {small_err}")

        # (p2) the fleet
        t1 = time.perf_counter()
        fleet.ready()
        f = fleet.ask("serve")
        charge = fleet.charged()
        fleet.close()
        p2_s = time.perf_counter() - t1
        smi_line = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
        print(f"(p2) fleet of 2 solo replicas ({f['param_bytes']} B each) "
              f"behind the router, 3 tenants at {FLEET_RATE:.0f} "
              f"requests/s for {FLEET_SECONDS:.0f} s: {f['completed']} "
              f"done of {f['requests']}, {f['shed']} shed; latency p50 "
              f"{f['p50_ms']:.3f} ms, p99 {f['p99_ms']:.3f} ms; "
              f"{f['rps']:.1f} requests/s; mean batch "
              f"{f['mean_batch']:.3f}; step ms {f['step_ms']}; served "
              f"{f['served']}; recompiles {f['recompiles']} (first pass "
              f"{f['recompiles_first_pass']}), buckets {f['buckets']}; "
              f"row rel L2 max {f['row_rel_l2_max']:.3g} (bound "
              f"{FLEET_ROW_REL_L2:g}, {f['check_s']:.1f} s); region charge "
              f"{charge} B (quota {SERVE_FLEET_QUOTA} B); {p2_s:.1f} s; "
              f"{smi_line}", flush=True)
        check(f["completed"] == f["unique"] == f["requests"]
              and f["all_done"], f"(p2) requests done {f['completed']}, "
              f"unique {f['unique']}, of {f['requests']}")
        check(f["shed"] == 0, f"(p2) {f['shed']} shed")
        check(f["row_rel_l2_max"] <= FLEET_ROW_REL_L2,
              f"(p2) row rel L2 {f['row_rel_l2_max']}")
        check(all(f["recompiles"][k] == len(f["buckets"][k])
                  == f["recompiles_first_pass"][k] for k in f["buckets"]),
              f"(p2) recompiles {f['recompiles']}, first pass "
              f"{f['recompiles_first_pass']}, buckets {f['buckets']}")
        check(all(v > 0 for v in f["served"].values()),
              f"(p2) served {f['served']}")
        check(f["param_bytes"] == [SERVE_SOLO_BYTES] * 2,
              f"(p2) param bytes {f['param_bytes']}")
        check(2 * SERVE_SOLO_BYTES <= charge < SERVE_FLEET_QUOTA,
              f"(p2) region charge {charge} B")
    finally:
        for c in members + [fleet]:
            if c.proc.poll() is None:
                c.proc.kill()
                c.proc.wait(timeout=60)
        shutil.rmtree(tmp, ignore_errors=True)
    took = time.perf_counter() - t0
    print(f"(p) the serving phase took {took:.1f} s; on {name}",
          flush=True)
    return [{"phase": "(p1) serving gang", "members": got,
             "region_charge": charged, "rel_l2": err,
             "small_max_abs": small_err, "took_s": p1_s},
            {"phase": "(p2) serving fleet", **f, "region_charge": charge,
             "took_s": p2_s, "phase_s": took}]


# --------------------------------------------- (q) the memory-space probe.
class ProbeChild:
    """Phase (q)'s child (vtpu_torch.bench.memspace), started ahead of its
    turn and held before its first CUDA call."""

    def __init__(self):
        self.tmp = tempfile.mkdtemp(prefix="vgpu-smoke-memspace-")
        self.probe = memspace.Probe(self.tmp, hold=True,
                                    lock_dir=run_lock_dir())
        self.proc = self.probe.proc
        _HELD.append(self)


def memspace_phase(name: str, child: ProbeChild) -> dict:
    """Phase (q): the probe alone on the card, every gate of
    vtpu_torch.bench.memspace exact, its timings beside their bounds."""
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    child.probe.go()
    res = child.probe.finish()
    shutil.rmtree(child.tmp, ignore_errors=True)
    check("error" not in res, f"(q) the probe's child gave no result, rc "
          f"{res.get('rc')}:\n{res.get('error')}")
    b = res["placement_bytes"]
    print(f"(q) memory kinds {res['memory_kinds']}; {b} B placed in each "
          f"under a {res['quota_bytes']} B device quota and a "
          f"{res['host_limit_bytes']} B host limit (footprint mode "
          f"{res['footprint_mode']}): device charge device "
          f"{res['shim_used_device_bytes']} B, pinned "
          f"{res['pinned_host_device_bytes']} B, pageable "
          f"{res['unpinned_host_device_bytes']} B, registered "
          f"{res['registered_host_device_bytes']} B, managed "
          f"{res['managed_device_bytes']} B (its entry point hooked "
          f"{res['managed_hooked']}); host ledger pinned "
          f"{res['pinned_host_ledger_bytes']} B, pageable "
          f"{res['unpinned_host_ledger_bytes']} B, registered "
          f"{res['registered_host_ledger_bytes']} B, managed "
          f"{res['managed_ledger_bytes']} B; pinned past the host limit: "
          f"{res['pinned_past_host_limit']}; managed past the quota: rc "
          f"{res['managed_past_quota_rc']}; after the frees device "
          f"{res['device_bytes_after_free']} B, host "
          f"{res['host_ledger_bytes_after_free']} B; region clean after "
          f"exit {res['region_clean_after_exit']}; on {name}", flush=True)
    for key, bound in (("in_hbm_touch_s", "in_hbm_touch_bound_s"),
                       ("host_to_hbm_64mb_s", "host_to_hbm_bound_s"),
                       ("pinned_to_hbm_copy_s", "copy_bound_s"),
                       ("unpinned_to_hbm_copy_s", "copy_bound_s"),
                       ("hbm_to_host_copy_s", "copy_bound_s")):
        print(f"(q) {key} {res[key] * 1e3:.4f} ms (median of "
              f"{res['timing_reps']}, CUDA events), bound "
              f"{res[bound] * 1e3:.4f} ms ({res[bound] / res[key]:.1%} of "
              f"it); on {name}", flush=True)
    print(f"(q) roundtrip_penalty_x {res['roundtrip_penalty_x']}; copies "
          f"equal {res['copies_equal']}; gates {res['gates']}; on {name}",
          flush=True)
    failed = [k for k, ok in res["gates"].items() if not ok]
    check(res["rc"] == 0 and not failed and res["copies_equal"]
          and res["host_copy_equal"], f"(q) failed gates {failed}, rc "
          f"{res['rc']}")
    took = phase_took("(q)", t0, name)
    return {"phase": "(q) memory-space probe", **res, "took_s": took}


def process_tree(root: int) -> list:
    """``root`` and its descendants' pids, from /proc."""
    parents = {}
    for entry in os.listdir("/proc"):
        if entry.isdigit():
            try:
                with open(f"/proc/{entry}/stat") as f:
                    parents[int(entry)] = int(f.read().rsplit(")", 1)[1]
                                              .split()[1])
            except (OSError, IndexError, ValueError):
                pass
    tree, todo = [], [root]
    while todo:
        pid = todo.pop()
        tree.append(pid)
        todo.extend(c for c, pp in parents.items() if pp == pid)
    return tree


def device_handles(pid: int) -> list:
    """What of the CUDA stack the process holds: open /dev/nvidia* files
    and mapped libcuda / libnvidia-ml (a context needs both)."""
    held = []
    try:
        for fd in os.listdir(f"/proc/{pid}/fd"):
            try:
                target = os.readlink(f"/proc/{pid}/fd/{fd}")
            except OSError:
                continue
            if target.startswith("/dev/nvidia"):
                held.append(target)
        with open(f"/proc/{pid}/maps") as f:
            held += sorted({line.split()[-1] for line in f
                            if "libcuda" in line or "libnvidia-ml" in line})
    except OSError:
        pass
    return held


class ClusterRun:
    """Phase (n): ``python -m vtpu_torch.scheduler.loadtest`` in a child
    that imports no torch. Gates: no card past its replicas, MiB or cores
    by the pods' annotations, every numa-bind pod inside one NUMA node, no
    refusal a plain first-fit could place at that point of the stream; the
    card's used memory and compute processes unmoved while the load test
    runs alone (its daemon started and serving), and none of its processes
    holding a device file or the CUDA libraries at any point."""

    def __init__(self, name: str):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        card_type = "NVIDIA-" + torch.cuda.get_device_name(0)
        card_mb = int(smi("memory.total")[0])
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("CUDA_", "LD_PRELOAD", "VGPU_"))}
        env["PYTHONPATH"] = ROOT
        self.tmp = tempfile.mkdtemp(prefix="vgpu-smoke-cluster-")
        self.out = open(os.path.join(self.tmp, "out"), "w+")
        self.err = open(os.path.join(self.tmp, "err"), "w+")
        self.used0, self.apps0 = card_used_mb(), compute_apps()
        self.used_max, self.apps_max = self.used0, self.apps0
        self.handles: list = []
        self.pids: set = set()
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "vtpu_torch.scheduler.loadtest",
             "--nodes", str(CLUSTER_NODES), "--pods", str(CLUSTER_PODS),
             "--seed", str(CLUSTER_SEED), "--card-type", card_type,
             "--card-mb", str(card_mb)],
            env=env, cwd=self.tmp, stdout=self.out, stderr=self.err)
        self.watcher = threading.Thread(target=self._watch, daemon=True)
        self.watcher.start()
        while time.perf_counter() - self.t0 < CLUSTER_ALONE_S:
            self.used_max = max(self.used_max, int(smi("memory.used")[0]))
            self.apps_max = max(self.apps_max, compute_apps())
            time.sleep(1.0)
        self.alone_s = time.perf_counter() - self.t0
        print(f"(n) the load test alone for {self.alone_s:.1f} s, its daemon "
              f"serving; then beside phase (l); on {name}", flush=True)

    def _watch(self) -> None:
        while self.proc.poll() is None:
            for pid in process_tree(self.proc.pid):
                self.pids.add(pid)
                self.handles += device_handles(pid)
            time.sleep(1.0)

    def finish(self, name: str) -> list:
        try:
            self.proc.wait(timeout=max(
                1.0, CLUSTER_TIMEOUT_S - (time.perf_counter() - self.t0)))
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait(timeout=60)
        self.watcher.join(timeout=30)
        took = time.perf_counter() - self.t0
        self.out.seek(0)
        lines = self.out.read().strip().splitlines()
        self.err.seek(0)
        tail = self.err.read()[-4000:]
        self.out.close()
        self.err.close()
        shutil.rmtree(self.tmp, ignore_errors=True)
        check(bool(lines), f"(n) no result, rc {self.proc.returncode}:\n"
              f"{tail}")
        res = json.loads(lines[-1])
        ms = res["ms"]
        print(f"(n) the port's scheduler at cluster scale: {res['nodes']} "
              f"nodes x {res['cards_per_node']} {res['card_type']} "
              f"({res['card_mb']} MiB, {res['replicas']} replicas a card, "
              f"NUMA 0,0,0,0,1,1,1,1, no mesh coordinate), {res['pods']} "
              f"seeded pods ({res['numa_bind_pods']} numa-bind): "
              f"{res['placed']} placed, {res['refused']} refused; /filter "
              f"p50 {ms['filter']['p50']:.3f} ms, p99 "
              f"{ms['filter']['p99']:.3f} ms; /webhook p50 "
              f"{ms['webhook']['p50']:.3f} ms, p99 "
              f"{ms['webhook']['p99']:.3f} ms; /bind p50 "
              f"{ms['bind']['p50']:.3f} ms, p99 {ms['bind']['p99']:.3f} ms; "
              f"{res['binds_per_s']:.1f} binds/s over the "
              f"{res['stream_s']:.1f} s stream (beside phase (l) after the "
              f"first {self.alone_s:.0f} s); {res['cards_used']} cards in "
              f"use; the load test {res['wall_s']:.1f} s, of it "
              f"{res['registered_s']:.1f} s to the daemon's first "
              f"registration poll; on {name}", flush=True)
        print(f"(n) gates: cards past replicas/MiB/cores "
              f"{res['overcommitted_cards']}, numa-bind pods split across "
              f"NUMA nodes {res['numa_split_pods']}, refusals a first-fit "
              f"places {res['n_wrong_refusals']} "
              f"{res['wrong_refusals'][:3]}, errors {res['n_errors']} "
              f"{res['errors'][:3]}; modules of torch/jax/vtpu "
              f"{res['modules']}; alone: card memory used {self.used0} -> "
              f"max {self.used_max} MiB, compute processes {self.apps0} -> "
              f"max {self.apps_max}; device files or CUDA libraries held by "
              f"its {len(self.pids)} processes {sorted(set(self.handles))}; "
              f"rc {self.proc.returncode}; it took {took:.1f} s; on {name}",
              flush=True)
        check(self.proc.returncode == 0 and res["ok"],
              f"(n) failed:\n{tail}")
        check(res["placed"] + res["refused"] == CLUSTER_PODS
              and res["refused"] < CLUSTER_PODS // 2,
              f"(n) {res['placed']} placed, {res['refused']} refused")
        check(res["modules"] == [],
              f"(n) the child imported {res['modules']}")
        check(self.used_max - self.used0 < CONTEXT_MARGIN_MB
              and self.apps_max == self.apps0,
              "(n) the scheduler took device memory or a context")
        check(len(self.pids) >= 2 and not self.handles,
              f"(n) the scheduler's processes {sorted(self.pids)} held "
              f"{sorted(set(self.handles))}")
        phase_took("(n) (beside (l) after its first "
                   f"{self.alone_s:.0f} s)", self.t0, name)
        return [{"phase": "(n) scheduler at cluster scale", "took_s": took,
                 "alone_s": self.alone_s,
                 "card_memory_used_mib": [self.used0, self.used_max],
                 "compute_processes": [self.apps0, self.apps_max],
                 **{k: res[k] for k in (
                     "nodes", "cards_per_node", "pods", "placed", "refused",
                     "numa_bind_pods", "ms", "binds_per_s", "stream_s",
                     "wall_s")}}]


# -------------------------------- the control plane's harnesses beside (l).
# the JAX smoke tests' arguments (tests/test_soak.py, tests/test_sched_bench.py,
# tests/test_monitor.py), the elastic and migrate legs in simulated time
SOAK = ["--tenants", "3", "--rate", "30", "--duration", "8", "--nodes", "8",
        "--waves", "80"]
HARNESSES = (
    ("sched", ["vtpu_torch.bench.sched", "--smoke"]),
    ("monitor", ["vtpu_torch.bench.monitor", "--smoke"]),
    ("soak", ["vtpu_torch.bench.soak", "--duration", "5", "--nodes", "24",
              "--pools", "2", "--tenants", "3", "--rate", "40",
              "--chaos-every", "1.6", "--diurnal-period", "2.5",
              "--p99-slo-ms", "20000", "--tenant-quota", "8"]),
    ("soak --elastic", ["vtpu_torch.bench.soak", "--elastic", *SOAK]),
    ("soak --migrate", ["vtpu_torch.bench.soak", "--migrate", *SOAK]),
    ("soak --serving", ["vtpu_torch.bench.soak", "--serving", "--duration",
                        "20", "--tenants", "3"]),
)
HARNESS_TIMEOUT_S = 180
# runs ``python -m MODULE ARGS`` as -m does, then writes the torch, jax and
# vtpu modules it loaded to OUT
HARNESS_RUNNER = """
import json, runpy, sys
out, mod = sys.argv[1], sys.argv[2]
sys.argv = [mod] + sys.argv[3:]
rc = 0
try:
    runpy.run_module(mod, run_name="__main__", alter_sys=True)
except SystemExit as e:
    rc = e.code if isinstance(e.code, int) else int(e.code is not None)
with open(out, "w") as f:
    json.dump(sorted(m for m in sys.modules if m.split(".")[0] in
                     ("torch", "jax", "jaxlib", "vtpu")), f)
sys.exit(rc)
"""


def harness_gates(label: str, res: dict) -> list:
    """what failed of the harness's own result"""
    if label == "sched":
        return [] if res["scheduled"] == res["iters"] else ["scheduled"]
    if label == "monitor":
        return ([] if res["steady_state_list_calls"] == 0
                else ["steady_state_list_calls"])
    bad = [] if res["ok"] else ["ok"]
    phases = [res[k] for k in ("static", "elastic", "elastic_only",
                               "migrate") if k in res] or [res]
    for ph in phases:
        bad += [k for k in ("overlay_drift", "double_booked_chips",
                            "quota_violations") if ph.get(k, 0)]
    return bad


class HostHarnesses:
    """The control plane's benches and the soak's four legs as a user runs
    them (``python -m vtpu_torch.bench.sched`` ...), one after another on
    the card's host once phase (n)'s process has ended: beside (l), which
    times no host work. Their processes are watched as (n)'s are."""

    def __init__(self, after: subprocess.Popen):
        self.after = after
        self.tmp = tempfile.mkdtemp(prefix="vgpu-smoke-harness-")
        self.env = {k: v for k, v in os.environ.items()
                    if not k.startswith(("CUDA_", "LD_PRELOAD", "VGPU_",
                                         "VTPU_"))}
        self.env["PYTHONPATH"] = ROOT
        self.results: list = []
        self.handles: list = []
        self.pids: set = set()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self) -> None:
        self.after.wait()
        self.t0 = time.perf_counter()
        for label, argv in HARNESSES:
            out = os.path.join(self.tmp, "modules.json")
            t0 = time.perf_counter()
            proc = subprocess.Popen(
                [sys.executable, "-c", HARNESS_RUNNER, out, *argv],
                env=self.env, cwd=self.tmp, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)
            self.pids.add(proc.pid)
            watch = threading.Thread(target=self._watch, args=(proc,),
                                     daemon=True)
            watch.start()
            try:
                stdout, stderr = proc.communicate(timeout=HARNESS_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                proc.kill()
                stdout, stderr = proc.communicate()
            watch.join(timeout=10)
            lines = stdout.strip().splitlines()
            try:
                res = json.loads(lines[-1])
                with open(out) as f:
                    modules = json.load(f)
            except (IndexError, ValueError, OSError):
                res, modules = None, None
            self.results.append({"harness": label, "rc": proc.returncode,
                                 "took_s": time.perf_counter() - t0,
                                 "result": res, "modules": modules,
                                 "stderr": stderr[-2000:]})
        self.end = time.perf_counter()

    def _watch(self, proc: subprocess.Popen) -> None:
        while proc.poll() is None:
            for pid in process_tree(proc.pid):
                self.pids.add(pid)
                self.handles += device_handles(pid)
            time.sleep(0.2)

    def finish(self, name: str, l_ended: float) -> list:
        self.thread.join(timeout=len(HARNESSES) * HARNESS_TIMEOUT_S)
        shutil.rmtree(self.tmp, ignore_errors=True)
        check(len(self.results) == len(HARNESSES),
              f"(l') {len(self.results)} of {len(HARNESSES)} harnesses ran")
        out = []
        for r in self.results:
            res = r["result"]
            check(res is not None, f"(l') {r['harness']}: no result, rc "
                  f"{r['rc']}:\n{r['stderr']}")
            keys = ("scheduled", "filters_per_sec", "p99_ms",
                    "steady_state_list_calls", "collect_speedup", "ok",
                    "overlay_drift", "double_booked_chips", "bound",
                    "failovers", "node_chaos_events", "p99_latency_ms",
                    "density_gain", "completed_moves", "blackout_p99_ms",
                    "requests", "completed", "dropped", "shed_fraction",
                    "gang_bound", "preempted_replicas")
            shown = {k: res[k] for k in keys if k in res}
            bad = harness_gates(r["harness"], res)
            print(f"(l') python -m vtpu_torch.bench.{r['harness']}: rc "
                  f"{r['rc']} in {r['took_s']:.1f} s; {shown}; failed "
                  f"{bad}; torch/jax/vtpu modules {r['modules']}; on "
                  f"{name}", flush=True)
            check(r["rc"] == 0 and not bad and r["modules"] == [],
                  f"(l') {r['harness']}: rc {r['rc']}, failed {bad}, "
                  f"modules {r['modules']}:\n{r['stderr']}")
            out.append({"harness": r["harness"], "rc": r["rc"],
                        "took_s": r["took_s"], **shown})
        took = self.end - self.t0
        print(f"(l') the harnesses took {took:.1f} s, "
              f"{max(0.0, self.end - l_ended):.1f} s of it after (l) "
              f"ended; device files or CUDA libraries held by their "
              f"{len(self.pids)} processes {sorted(set(self.handles))}; "
              f"on {name}", flush=True)
        check(len(self.pids) >= len(HARNESSES) and not self.handles,
              f"(l') the harnesses' processes held "
              f"{sorted(set(self.handles))}")
        return [{"phase": "(l') control-plane harnesses", "runs": out,
                 "took_s": took,
                 "after_l_s": max(0.0, self.end - l_ended)}]



# ------------------------------------------------------- (l) the north star.
NS_DEFAULT = ["--pods", "4", "--case", "1.1", "--quota", "3g",
              "--seconds", "6"]
# tight mode at a smaller depth: fewer seconds, the same models
NS_TIGHT = ["--tight", "--pods", "4", "--seconds", "4"]
NS_TIMEOUT_S = 600
NS_LEAKAGE_PCT = 2.0


def northstar_run(name: str, label: str, argv: list, tmp: str) -> dict:
    """``python -m vtpu_torch.northstar`` with ``argv``, its result read
    from its --out file"""
    out = os.path.join(tmp, f"{label}.json")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("CUDA_DEVICE_", "CUDA_DISABLE", "LD_PRELOAD",
                                "PYTORCH_CUDA_ALLOC_CONF"))}
    env["PYTHONPATH"] = ROOT
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "vtpu_torch.northstar", "--out", out,
             *argv], env=env, cwd=tmp, capture_output=True, text=True,
            timeout=NS_TIMEOUT_S)
    except subprocess.TimeoutExpired as e:
        # what it said before it was stopped (bytes, whatever text= says)
        said = e.stderr.decode(errors="replace") if isinstance(
            e.stderr, bytes) else e.stderr or ""
        raise SmokeFailure(f"(l) {label}: no result in {NS_TIMEOUT_S} s; "
                           f"its stderr:\n{said[-4000:]}") from None
    took = time.perf_counter() - t0
    check(os.path.exists(out), f"(l) {label}: no result, rc "
          f"{proc.returncode}:\n{proc.stderr[-4000:]}")
    with open(out) as f:
        res = json.load(f)
    res["rc"], res["took_s"] = proc.returncode, took
    if proc.returncode:
        print(proc.stderr[-4000:], file=sys.stderr, flush=True)
    return res


def _pod_lines(label: str, pods: list) -> None:
    for p in pods:
        print(f"(l) {label} pod {p['pod']}: rc {p['rc']}, "
              f"{p.get('imgs_per_sec', 0):.1f} img/s over {p.get('steps', 0)} "
              f"steps; quota {p['quota_bytes']} B, region peak "
              f"{p['peak_used_bytes']} B, at the barrier "
              f"{p.get('held_region_bytes')} B; the card dropped by "
              f"{p.get('card_drop_bytes')} B at its exit (accounting error "
              f"{p.get('accounting_error_bytes')} B); leakage "
              f"{p['leakage_pct']}% ({p['leakage_source']}), the region's "
              f"own {p['shim_leakage_pct']}%; NVML per-process: "
              f"{p.get('nvml_channel')}", flush=True)


def northstar_phase(name: str) -> list:
    """Phase (l): the north star, ``python -m vtpu_torch.northstar`` at 4
    pods x 3 GiB on case 1.1 for 6 s, then ``--tight`` at 4 s. Every pod
    exits clean, the allocation past a quota is refused, every pod's
    leakage is under 2% by the card's drop at its exit, the leakage is
    cross-checked, the canary under-counts under 2% of the quotas, and
    the tight run meets its verdict."""
    start = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()  # this process's memory stays put meanwhile
    tmp = tempfile.mkdtemp(prefix="vgpu-smoke-ns-")
    try:
        ns = northstar_run(name, "north star", NS_DEFAULT, tmp)
        _pod_lines("north star", ns["pods"])
        c = ns["headroom_canary"]
        edge = c.get("alloc_to_oom", {})
        print(f"(l) north star: {ns['pods_per_chip']} pods, "
              f"{ns['aggregate_imgs_per_sec']} img/s together, max leakage "
              f"{ns['max_leakage_pct']}%, cross-checked "
              f"{ns['leakage_cross_checked']}, breach refused "
              f"{ns['breach_probe_rejected']}; canary ({c.get('channel')}): "
              f"free {c.get('free_while_pods_hold_bytes')} B while the pods "
              f"hold, {c.get('free_after_pods_exit_bytes')} B after they exit"
              f": their footprint {c.get('true_combined_footprint_bytes')} B "
              f"(NVML: {c.get('nvml_combined_footprint_bytes')} B) against "
              f"{c.get('shim_accounted_bytes')} B charged, under-count "
              f"{c.get('undercount_pct_of_quota')}% of the quotas; "
              f"allocate-to-OOM while they hold {edge.get('allocated_bytes')}"
              f" B at {edge.get('resolution_bytes')} B resolution, "
              f"{edge.get('vs_free_bytes')} B from the free reading; card "
              f"{ns['card']}; rc {ns['rc']} in {ns['took_s']:.1f} s; on "
              f"{name}", flush=True)
        check(ns["rc"] == 0 and ns["ok"], f"(l) north star rc {ns['rc']}")
        check(all(p["rc"] == 0 for p in ns["pods"]), "(l) a pod failed")
        check(ns["breach_probe_rejected"], "(l) the breach was not refused")
        for p in ns["pods"]:
            check(p["leakage_source"] == "card_drop_at_exit"
                  and p["leakage_pct"] < NS_LEAKAGE_PCT,
                  f"(l) pod {p['pod']}: leakage {p['leakage_pct']}% "
                  f"({p['leakage_source']})")
        check(ns["leakage_cross_checked"], "(l) leakage not cross-checked")
        check(c.get("available") and c.get("discriminating")
              and c["undercount_pct_of_quota"] < NS_LEAKAGE_PCT,
              f"(l) canary: {c}")
        tight = northstar_run(name, "tight", NS_TIGHT, tmp)
        for cfg, r in tight["configs"].items():
            if "pods" in r:
                _pod_lines(f"tight {cfg}", r["pods"])
            print(f"(l) tight {cfg}: "
                  + ", ".join(f"{k} {r[k]}" for k in (
                      "calibrated_peak_bytes", "quota_bytes_per_pod",
                      "quota_over_peak", "pods_count", "ballast_bytes_per_pod",
                      "expected_pods_holding", "pods_holding_ballast",
                      "backend_oom_pods", "shim_oom_pods", "skipped", "error")
                      if k in r), flush=True)
        tc = tight.get("headroom_canary", {})
        print(f"(l) tight: tight_met {tight.get('tight_met')}, "
              f"{tight.get('met_breakdown')}, cross-checked "
              f"{tight.get('leakage_cross_checked')}; canary under-count "
              f"{tc.get('undercount_pct_of_quota')}% of the quotas; rc "
              f"{tight['rc']} in {tight['took_s']:.1f} s; on {name}",
              flush=True)
        check(tight["rc"] == 0 and tight.get("tight_met") is True,
              f"(l) tight: {tight.get('met_breakdown')}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    took = time.perf_counter() - start
    print(f"(l) the phase took {took:.1f} s; on {name}", flush=True)
    return [{"phase": "(l) north star", **{k: ns[k] for k in (
                "pods", "max_leakage_pct", "leakage_cross_checked",
                "breach_probe_rejected", "headroom_canary",
                "aggregate_imgs_per_sec", "took_s")}},
            {"phase": "(l) tight", **{k: tight.get(k) for k in (
                "tight_met", "met_breakdown", "leakage_cross_checked",
                "configs", "headroom_canary", "took_s")}},
            {"phase": "(l) time", "phase_s": took}]


# ------------------------------------------------------------ (m) the bench.
# python -m vtpu_torch.bench in its modes, each a command as a user runs it
BENCH_TIMEOUT_S = 300
# the default mode's case 1.1 img/s against phase (b)'s alone
BENCH_RATE_BAND = (0.9, 1.1)
# the profile's execute calls against the child's region launch count
PROFILE_LAUNCHES_TOL = 0.01
# the parity run's execute p50 may be at most 2x the profile run's minutes
# earlier on the same tree: a self-check that the profile half runs, not a
# speed-up claim (bench.py's 3x is against a baseline before a rebuild)
PARITY_P50X = "0.5"
# the profiling cost: timings of case 1.1 under libvgpu.so, profile on
# (every call timed) and off, in turns
COST_REPS = 1


def bench_cmd(name: str, label: str, args: list, tmp: str,
              **env_extra) -> tuple:
    """``python -m vtpu_torch.bench *args`` from ``tmp`` (nothing is
    written to the checkout): (stdout lines, stderr). Fails on a non-zero
    exit."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("CUDA_DEVICE_", "CUDA_DISABLE", "LD_PRELOAD",
                                "PYTORCH_CUDA_ALLOC_CONF", "VTPU_"))}
    env["PYTHONPATH"] = ROOT
    env.update(env_extra)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "vtpu_torch.bench", *args],
                          env=env, cwd=tmp, capture_output=True, text=True,
                          timeout=BENCH_TIMEOUT_S)
    took = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    print(f"(m) {label}: `python -m vtpu_torch.bench {' '.join(args)}` rc "
          f"{proc.returncode} in {took:.1f} s; on {name}", flush=True)
    check(proc.returncode == 0, f"(m) {label}: rc {proc.returncode}:\n"
          f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    return lines, proc.stderr


def profile_children() -> dict:
    """Two case 1.1 --sm-children under libvgpu.so (12 GiB, no SM limit):
    the profile on (every call timed) and off; started, not waited for."""
    return {"on": SmChild("profile on", wait=False, extra_env={
                api.ENV_PROFILE: "1", api.ENV_PROFILE_SAMPLE: "1"}),
            "off": SmChild("profile off", wait=False,
                           extra_env={api.ENV_PROFILE: "0"})}


def profile_cost(name: str, children: dict) -> dict:
    """Case 1.1's ms/step (CUDA events, as phase (b)) in ``children``, in
    turns: the best of each and the cost of the profile."""
    try:
        for child in children.values():
            child.ready()
        ms = {k: [] for k in children}
        for _ in range(COST_REPS):
            for label in ("off", "on"):
                ms[label].append(children[label].ask("time",
                                                     case="1.1")["ms"])
    finally:
        for child in children.values():
            child.close()
    best = {k: min(v) for k, v in ms.items()}
    cost = best["on"] / best["off"] - 1
    print(f"(m) profiling cost, case 1.1 under libvgpu.so, ms/step (CUDA "
          f"events, {STEPS['1.1']} steps), best of {COST_REPS} in turns: "
          f"VTPU_PROFILE=0 {best['off']:.3f}, VTPU_PROFILE=1 (every call "
          f"timed) {best['on']:.3f}: {cost:+.2%} (printed, not gated); on "
          f"{name}", flush=True)
    return {"ms": ms, "best_ms": best, "cost": cost}


def bench_phase(name: str, alone_ms: float) -> dict:
    """Phase (m): ``python -m vtpu_torch.bench`` in its modes on case 1.1
    (and 3.1 in the interleaved smoke); see the module docstring."""
    start = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    alone = CASES["1.1"].batch / (alone_ms / 1e3)
    tmp = tempfile.mkdtemp(prefix="vgpu-smoke-bench-")
    res = {"phase": "(m) bench"}
    cost_children = {}
    try:
        lines, _ = bench_cmd(name, "default", [], tmp)
        flag = json.loads(lines[-1])
        ratio = flag["value"] / alone
        print(f"(m) default: {flag['metric']} {flag['value']} img/s "
              f"(spread {flag['spread']}), {ratio:.3f}x phase (b)'s "
              f"{alone:.1f} img/s alone; MFU {flag['mfu']}; vs the V100 "
              f"nominal {flag['vs_baseline']}; on {name}", flush=True)
        res["default"] = dict(flag, vs_alone=ratio)
        check(flag["metric"].endswith("_imgs_per_sec"),
              f"(m) default: {flag['metric']}")
        check(BENCH_RATE_BAND[0] <= ratio <= BENCH_RATE_BAND[1],
              f"(m) default: {ratio:.3f}x phase (b)'s img/s")
        check(0 < flag["mfu"] <= 1, f"(m) default: MFU {flag['mfu']}")

        # the profiling cost's children make their contexts, and the
        # interleaved smoke (no gate times it) runs beside the profile
        # mode, whose gates are counts; both are done before parity
        cost_children = profile_children()
        side = futures.ThreadPoolExecutor(1)
        smoke = side.submit(bench_cmd, name, "interleave",
                            ["--interleave", "--quick", "--cases", "1.1,3.1"],
                            tmp)
        side.shutdown(wait=False)
        prof_json = os.path.join(tmp, "profile.json")
        lines, _ = bench_cmd(name, "profile",
                             ["--profile", "--cases", "1.1",
                              "--profile-json", prof_json], tmp)
        with open(prof_json) as f:
            data = json.load(f)
        agg, launches = data["cases"]["1.1"], data["region_launches"]["1.1"]
        cs = agg["callsites"]
        top = [t for t in lines if t.startswith("top shim cost centers:")]
        ex = cs.get("execute", {})
        print(f"(m) profile, case 1.1: "
              + "; ".join(f"{k} {c['calls']} calls, {c['errors']} err, p50 "
                          f"{c['p50_us']} us, p99 {c['p99_us']} us, "
                          f"{c['est_total_ms']} ms ({c['share_pct']}%)"
                          for k, c in cs.items())
              + f"; shim time {agg['shim_total_ms']} ms; region launches "
              f"{launches}; {top[0] if top else 'no top cost centers'}; on "
              f"{name}", flush=True)
        res["profile"] = {"callsites": {k: {f: c[f] for f in (
            "calls", "errors", "bytes", "p50_us", "p99_us", "est_total_ms",
            "share_pct")} for k, c in cs.items()},
            "shim_total_ms": agg["shim_total_ms"], "region_launches": launches}
        check(launches > 0 and abs(ex.get("calls", 0) / launches - 1)
              <= PROFILE_LAUNCHES_TOL, f"(m) profile: {ex.get('calls')} "
              f"execute calls against {launches} region launches")
        check(cs.get("buf_alloc", {}).get("calls", 0) > 0,
              "(m) profile: no buf_alloc call")
        check(bool(top), "(m) profile: no top cost centers printed")
        for row in ("transfer", "done_with_buffer"):
            check(cs.get(row, {}).get("calls", 0) > 0,
                  f"(m) profile: no {row} row")

        lines, err = smoke.result()
        halves = [t.strip() for t in err.splitlines()
                  if t.strip().startswith(("[native]", "[shim]"))]
        for t in halves:
            print(f"(m) interleave {t}", flush=True)
        res["interleave"] = halves
        check(sorted(t.split()[0] + t.split()[2] for t in halves) == [
            "[native]1.1", "[native]3.1", "[shim]1.1", "[shim]3.1"],
            f"(m) interleave: {halves}")
        check(not any(f.startswith("BENCH") for f in os.listdir(tmp)),
              "(m) interleave at --quick wrote a matrix file")

        lines, err = bench_cmd(name, "parity",
                               ["--parity", "--cases", "1.1", "--reps", "1",
                                "--profile-baseline", prof_json], tmp,
                               VTPU_PARITY_P50X=PARITY_P50X)
        parity = json.loads(lines[-1])
        for t in err.splitlines():
            if t.startswith("[parity]"):
                print(f"(m) {t}", flush=True)
        res["parity"] = parity
        check(parity["pass"] and parity["ratios"].get("1.1", 0) >= 0.95,
              f"(m) parity: {parity}")

        res["profile_cost"] = profile_cost(name, cost_children)
    finally:
        for child in cost_children.values():  # a check failed meanwhile
            if child.proc.poll() is None:
                child.proc.kill()
                child.proc.wait(timeout=60)
        shutil.rmtree(tmp, ignore_errors=True)
    res["phase_s"] = time.perf_counter() - start
    print(f"(m) the phase took {res['phase_s']:.1f} s; on {name}",
          flush=True)
    return res


NATIVE = [
    {"name": "libvgpu.so", "route": "gcc", "source":
     "vtpu_torch/csrc/libvgpu.c", "replaces": "lib/vtpu/libvtpu.c:1007",
     "hooks": "its exported cu* entry points and dlsym (below)"},
    {"name": "libvgpucore.so", "route": "gcc", "source":
     "vtpu_torch/csrc/shared_region.c", "replaces":
     "lib/vtpu/shared_region.c:476"},
    {"name": "vgpu-validator", "route": "gcc", "source":
     "vtpu_torch/csrc/validator.c", "replaces": "lib/vtpu/validator.c:197"},
    {"name": "libnvidia-ml.so.1 (mock, CPU tests only)", "route": "gcc",
     "source": "vtpu_torch/csrc/mock_nvml.c", "replaces":
     "vtpu/plugin/tpulib.py:65"},
    {"name": "codemem.{cubin,fatbin,ptx}, codemem_3g.cubin (phase (r)'s "
     "module)", "route": "nvcc", "source":
     "vtpu_torch/csrc/codemem_fixture.cu", "replaces":
     "lib/vtpu/mock_pjrt.c:636"},
] + [{"name": f"{prog} (the native test plane, CPU tests only)",
      "route": "gcc", "source": f"vtpu_torch/csrc/test/{prog}.c",
      "replaces": f"lib/vtpu/test/{ref}.c:1"}
     for prog, ref in (("region_test", "region_test"),
                       ("region_stress", "region_stress"),
                       ("interposer_test", "shim_test"))]


def native_libs() -> list:
    """NATIVE, with libvgpu.so's hooks read from the built library's dynamic
    symbols (the cu* entry points and dlsym it exports)."""
    out = subprocess.run(["nm", "-D", "--defined-only", native.interposer()],
                         check=True, capture_output=True, text=True,
                         timeout=60).stdout
    names = [line.split()[-1] for line in out.splitlines() if line.strip()]
    hooks = sorted(n for n in names
                   if n == "dlsym" or re.match(r"cu[A-Z]", n))
    return [dict(lib, hooks=hooks) if lib["name"] == "libvgpu.so" else lib
            for lib in NATIVE]


def main() -> int:
    if os.environ.pop(HOLD_ENV, None) and sys.stdin.readline() != "go\n":
        return 0  # started ahead, its turn never came
    if len(sys.argv) > 1 and sys.argv[1] == "--quota-child":
        quota_child(sys.argv[2], int(sys.argv[3]))
        return 0
    if len(sys.argv) > 1 and sys.argv[1] == "--peak-child":
        peak_child(sys.argv[2])
        return 0
    if len(sys.argv) > 1 and sys.argv[1] == "--sm-child":
        sm_child()
        return 0
    if len(sys.argv) > 1 and sys.argv[1] == "--serve-child":
        serve_child(sys.argv[2])
        return 0
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    name = card()
    driver = subprocess.run(
        ["nvidia-smi", "--query-gpu=driver_version", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
        timeout=60).stdout.split()[0]
    print(f"card: {name}; driver {driver}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, cuDNN {torch.backends.cudnn.version()}, "
          f"{sys.executable}; torch and the port imported in {IMPORT_S:.2f} "
          f"s, their bytecode kept under {os.environ[PYCACHE_ENV]} for the "
          f"run's children", flush=True)
    # the libraries build (gcc, on the host) while the native, training
    # and sharded phases run: none of them loads one
    t0 = time.perf_counter()
    side = futures.ThreadPoolExecutor(len(ALLOCATORS) + 1)
    build = side.submit(
        lambda: ({**native.build_all(), **native.cuda_fixtures()},
                 time.perf_counter() - t0))
    beside = {}

    def start_beside():
        """Once case 1.2's steps are timed, beside the rest of the training
        phase and the sharded phase, which time nothing:
        dryrun_multichip(1), case 1.2's peak alone under the other
        allocators (each a process of its own, none under the interposer),
        and the first F1 child, started ahead (it waits before its first
        CUDA call)."""
        beside["dryrun"] = side.submit(dryrun)
        beside["peaks"] = {conf: side.submit(alone_peak, "1.2", conf)
                           for conf in ALLOCATORS[1:]}
        build.result()
        beside["fill"] = fill_child(FILL_QUOTAS[0])

    phases = []
    for label, phase, args in (
            ("case 1.1 native:", infer_phase, (name,)),
            ("case 1.2 native:", train_phase, (name, start_beside)),
            ("case 1.2 sharded 1x1:", sharded_phase, (name,))):
        t0 = time.perf_counter()
        phases.append(phase(*args))
        phase_took(label, t0, name)
    phases[-1]["dryrun_multichip_1_s"] = dry_s = beside["dryrun"].result()
    print(f"dryrun_multichip(1) passed in {dry_s:.1f} s, beside the "
          f"training and sharded phases; on {name}", flush=True)
    peaks = {conf: f.result() for conf, f in beside["peaks"].items()}
    peaks[""] = phases[1]["peak_reserved_bytes"]
    libs, build_s = build.result()
    side.shutdown()
    print(f"built {sorted(libs)} in {build_s:.2f} s, beside the phases "
          f"above", flush=True)

    # the memory phases, one child at a time on the card, each next child
    # started ahead (its interpreter loads while the one before it runs)
    fills, train_quotas = [], {}

    def fill_step(quota):
        def run(child):
            fills.append(fill_phase(name, quota, child))
            return fills[-1]
        return (lambda: fill_child(quota), run)

    def train_quota(alloc_conf: str) -> int:
        """case 1.2's quota under ``alloc_conf``, once F1 has measured the
        footprint charge"""
        if not train_quotas:
            fp = fills[-1]["footprint"]["bytes"]
            for conf in ALLOCATORS:
                peak = peaks[conf]
                train_quotas[conf] = math.ceil(
                    (peak + fp) * (1 + TRAIN_HEADROOM) / GiB) * GiB
                print(f"case 1.2 quota, {conf or 'default allocator'}: "
                      f"max_memory_reserved alone {peak} B + footprint "
                      f"{fp} B, + {TRAIN_HEADROOM:.0%}, rounded up to "
                      f"whole GiB: {train_quotas[conf]} B", flush=True)
        return train_quotas[alloc_conf]

    def quota_step(case_name, alloc_conf):
        def quota():
            return INFER_QUOTA if case_name == "1.1" else \
                train_quota(alloc_conf)

        def run(child):
            res = quota_phase(name, case_name, quota(), alloc_conf, child)
            if case_name == "1.2":
                res["max_memory_reserved_alone"] = peaks[alloc_conf]
            return res
        return (lambda: QuotaChild(case_name, quota(), alloc_conf), run)

    steps = [fill_step(q) for q in FILL_QUOTAS]
    steps.append((lambda: run_fill_child("1.1", FILL_QUOTAS[0]),
                  lambda child: run_fill_phase(name, "1.1", FILL_QUOTAS[0],
                                               child)))
    fixtures = os.path.dirname(libs["codemem.cubin"])
    steps.append((lambda: codemem_children(fixtures),
                  lambda children: codemem_phase(name, children)))
    steps.append((lambda: None, lambda _: cuda13_phase(name)))
    steps.append((neighbour_children,
                  lambda pair: neighbour_phase(name, pair)))
    steps += [quota_step(case_name, conf) for case_name in ("1.1", "1.2")
              for conf in ALLOCATORS]
    # then the compute plane's children and phase (k)'s child alone, all
    # started ahead as the last memory phase starts
    steps.append((compute_children,
                  lambda children: compute_phases(name, children)))
    t0 = time.perf_counter()
    *memory, (compute, zoo_alone) = pipelined(steps, beside["fill"], name)
    phase_took("the memory phases and (a)-(h):", t0, name)
    phases += memory + compute
    (solo,) = [p["unthrottled_img_s"] for p in phases
               if p["phase"] == "(c) case 1.1 at 50%"]
    step_ms = {p["phase"].split()[2]: p["no SM limit"] for p in phases
               if p["phase"].startswith("(b) case ")}
    phases += zoo_phase(name, zoo_alone)
    phases += node_agent_phase(name, solo, step_ms)
    serve = serve_children()
    phases.append(livemove_phase(name))
    probe = ProbeChild()
    phases += serving_phase(name, serve)
    phases.append(memspace_phase(name, probe))
    cluster = ClusterRun(name)
    harnesses = HostHarnesses(cluster.proc)
    phases += northstar_phase(name)
    l_ended = time.perf_counter()
    phases += cluster.finish(name)
    phases += harnesses.finish(name, l_ended)
    (b11,) = [p for p in phases
              if p["phase"] == "(b) case 1.1 unthrottled cost"]
    phases.append(bench_phase(name, b11["alone"]))
    print(f"chip_smoke.py took {time.perf_counter() - T_START:.1f} s "
          f"from its start to its last phase; on {name}", flush=True)
    print(json.dumps({"card": name, "phases": phases}), flush=True)
    print(json.dumps({"kernels": [], "native": native_libs()}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        sys.exit(1)
    finally:
        stop_held()
        for d in _LOCK_DIR:
            shutil.rmtree(d, ignore_errors=True)
