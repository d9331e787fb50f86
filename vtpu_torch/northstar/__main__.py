"""``python -m vtpu_torch.northstar``: the north-star run (northstar.py's
``main``, :1026). Default: 4 pods of case 1.1 at 3 GiB each for 30 s on
card 0; ``--tight`` for quotas that bind; ``--backend mock`` for the mock
``libcuda.so.1`` and mock NVML (no card). With no card and no ``--backend
mock`` it exits non-zero: it never falls back to the mock or the CPU.
Writes the result to ``--out`` (``NORTHSTAR_GPU.json``) and prints it as
the last line."""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

from vtpu_torch import native

from . import parse_size
from .canary import Card
from .run import CARD_DROP, REPO, PodFailed, run_pods
from .tight import tight_main

# the mock card: one H100-named card of this much memory, contexts of
# 64 MiB, 2 MiB a function loaded, 0.2 ms a kernel (the caller's env wins)
MOCK_ENV = {"MOCK_CUDA_TOTAL": "4g", "MOCK_CUDA_CTX_BYTES": "64m",
            "MOCK_CUDA_FUNC_BYTES": "2m", "MOCK_CUDA_KERNEL_NS": "200000"}


def _mock_card(root: str) -> Card:
    """the mock driver and NVML for this process and its pods"""
    native.build_all()
    for k, v in MOCK_ENV.items():
        os.environ.setdefault(k, v)
    procs = os.path.join(root, "procs")
    os.makedirs(procs, exist_ok=True)
    os.environ.setdefault("MOCK_GPU_PROCS", procs)
    if "MOCK_NVML_FIXTURE" not in os.environ:
        fixture = os.path.join(root, "cards.json")
        with open(fixture, "w") as f:
            json.dump({"gpus": [{
                "uuid": "GPU-00000000-0000-0000-0000-000000000000",
                "name": "NVIDIA H100 80GB HBM3",
                "memory_mb": parse_size(os.environ["MOCK_CUDA_TOTAL"]) >> 20,
                "minor": 0}]}, f)
        os.environ["MOCK_NVML_FIXTURE"] = fixture
    nvml = native.mock_nvml_library()
    os.environ["LD_LIBRARY_PATH"] = os.pathsep.join(
        [native.mock_cuda_dir(), os.path.dirname(nvml)]
        + [p for p in os.environ.get("LD_LIBRARY_PATH", "").split(os.pathsep)
           if p])
    return Card("mock", nvml)


def _args(argv):
    ap = argparse.ArgumentParser(prog="python -m vtpu_torch.northstar")
    ap.add_argument("--pods", type=int, default=4)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--quota", default="3g",
                    help="device-memory quota per pod (suffix k/m/g); in "
                         "--tight mode only the calibration's floor")
    ap.add_argument("--case", default="1.1")
    ap.add_argument("--batch", type=int, default=0,
                    help="override the case's batch (0: its published one)")
    ap.add_argument("--backend", choices=["cuda", "mock"], default="cuda")
    ap.add_argument("--cores", default="",
                    help="comma list of per-pod SM limits in %% (e.g. "
                         "'70,30'); empty: none")
    ap.add_argument("--priorities", default="",
                    help="comma list of per-pod task priorities (0 high, 1 "
                         "low); the parent runs the node monitor's feedback "
                         "loop over the pods' regions")
    ap.add_argument("--tight", action="store_true",
                    help="quotas that bind: calibrate, run at --tight-margin "
                         "x the peak, a training configuration near its "
                         "cap, an oversubscribed one, and the canary")
    ap.add_argument("--tight-margin", type=float, default=1.15)
    ap.add_argument("--tight-train-case", default="1.2")
    ap.add_argument("--hbm", default="",
                    help="the card's memory for the oversubscribed "
                         "configuration (default: NVML's total)")
    ap.add_argument("--out", default=os.path.join(REPO, "NORTHSTAR_GPU.json"))
    return ap.parse_args(argv)


def _finish(args, result: dict, card: Card, met: bool) -> int:
    result["pods_per_chip"] = args.pods
    result["seconds"] = args.seconds
    result["card"] = card.describe()
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    return 0 if met else 1


def main(argv=None) -> int:
    args = _args(argv)
    cores = [int(c) for c in args.cores.split(",")] if args.cores else []
    priorities = ([int(p) for p in args.priorities.split(",")]
                  if args.priorities else [])
    root = tempfile.mkdtemp(prefix="vgpu_northstar_")
    try:
        try:
            card = _mock_card(root) if args.backend == "mock" \
                else Card("cuda")
        except RuntimeError as e:
            print(f"northstar: {e}", file=sys.stderr)
            return 2
        try:
            if args.tight:
                result = tight_main(args, args.backend, card, root)
                return _finish(args, result, card, result["tight_met"])
            quota = parse_size(args.quota)
            run = run_pods(backend=args.backend, card=card, pods=args.pods,
                           seconds=args.seconds, quotas=[quota] * args.pods,
                           case=args.case, batch=args.batch, cores=cores,
                           priorities=priorities, canary=True,
                           oom_channel=args.backend == "cuda", root=root)
        except PodFailed as e:
            print(f"northstar: {e}", file=sys.stderr, flush=True)
            return 1
        pods = run["pods"]
        result = {
            "backend": args.backend, "case": args.case,
            "quota_bytes_per_pod": quota, "pods": pods,
            "max_leakage_pct": max((p["leakage_pct"] for p in pods),
                                   default=0.0),
            # every pod graded by a ground truth other than its region
            "leakage_cross_checked": bool(pods) and all(
                p.get("leakage_source") == CARD_DROP for p in pods),
            "held_sample_bytes": run["held_sample_bytes"],
            "headroom_canary": run.get("headroom_canary",
                                       {"available": False}),
            "breach_probe_rejected": run["breach_probe_rejected"],
            "aggregate_imgs_per_sec": round(
                sum(p.get("imgs_per_sec", 0) for p in pods), 2),
            **({"timeline": run["timeline"]} if run["timeline"] else {}),
            "ok": run["ok"],
        }
        # the bar: >= 4 pods exit clean, every pod's leakage under 2%, and
        # the deliberate allocation past the quota was refused
        result["north_star_met"] = bool(
            run["ok"] and args.pods >= 4 and run["breach_probe_rejected"]
            and all(p["rc"] == 0 and p["leakage_pct"] < 2.0 for p in pods))
        return _finish(args, result, card, run["ok"])
    finally:
        shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
