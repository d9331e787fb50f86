"""``python -m vtpu_torch.bench``: bench.py's ``main`` (:935-1110) on the
card. See :mod:`vtpu_torch.bench` for the flags."""

from __future__ import annotations

import json
import os
import sys

from .. import api
from ..models import BENCH_CASES
from . import V100_NOMINAL_IMGS_PER_SEC
from .matrix import _publishable, _run_matrix, write_half, write_interleaved
from .parity import run_parity_mode
from .profile import run_profile_mode
from .runner import bench_device
from .serve import _serve, run_interleaved
from .wiring import reexec_with_shim


def _failed(cases, results) -> list:
    """The cases of ``cases`` with no error-free result in ``results``."""
    ran = {r.get("case") for r in results if "error" not in r}
    return [c.case for c in cases if c.case not in ran]


def main(argv=None) -> int:
    """``argv`` as ``sys.argv`` (the program first); the return code."""
    argv = list(sys.argv if argv is None else argv)
    quick = "--quick" in argv
    run_all = "--all" in argv
    shim = "--shim" in argv
    both = "--both" in argv
    serve = "--serve" in argv
    interleave = "--interleave" in argv
    profile = "--profile" in argv
    parity = "--parity" in argv
    is_child = os.environ.get(api.ENV_BENCH_CHILD) == "1"
    reps = 4
    wanted = None
    profile_out = profile_json = profile_baseline = ""
    for i, a in enumerate(argv):
        if i + 1 >= len(argv):
            break
        if a == "--cases":
            wanted = set(argv[i + 1].split(","))
        elif a == "--reps":
            reps = int(argv[i + 1])
        elif a == "--profile-out":
            profile_out = argv[i + 1]
        elif a == "--profile-json":
            profile_json = argv[i + 1]
        elif a == "--profile-baseline":
            profile_baseline = argv[i + 1]

    if parity and not is_child:
        ids = sorted(wanted) if wanted else ["1.1", "2.2"]
        return run_parity_mode(ids, quick, reps,
                               baseline_path=profile_baseline)
    if profile and not is_child:
        # the flagship short-step cases by default (bench.py's choice)
        ids = sorted(wanted) if wanted else ["1.1", "2.2"]
        return run_profile_mode(ids, quick, reps, out_path=profile_out,
                                json_out=profile_json,
                                baseline_path=profile_baseline)
    if shim and not is_child:
        return reexec_with_shim(argv)

    try:
        device = bench_device()
    except RuntimeError as e:
        print(f"bench: {e}", file=sys.stderr)
        return 2

    if serve and is_child:
        _serve(device, quick)
        return 0

    if run_all or wanted:
        cases = [c for c in BENCH_CASES
                 if wanted is None or c.case in wanted]
    else:
        cases = [c for c in BENCH_CASES if c.case == "1.1"]
    label = "shim" if is_child else "native"

    shim_results = None
    if interleave and not is_child:
        results, shim_results = run_interleaved(cases, device, quick, reps)
        # BOTH halves must be at the published batch, or the ratio would
        # compare different workloads
        if ((run_all or wanted) and not quick and _publishable(results)
                and _publishable(shim_results)):
            write_interleaved(results, shim_results, run_all)
    else:
        results = _run_matrix(cases, device, quick, reps, label)
        if (run_all or wanted) and not quick and _publishable(results):
            write_half(results, "shim_results" if is_child else "results",
                       run_all)

    # when asked for both: the shim half after the native half
    # (--interleave already produced a window-paired shim half)
    shim_rc = 0
    if both and run_all and not is_child and not shim and not interleave:
        shim_rc = reexec_with_shim([a for a in argv if a != "--both"]
                                   + ["--shim"])
        if shim_rc != 0:
            print("shim half failed", file=sys.stderr)
    # every case ran in every half, or the run failed (the matrix file and
    # the lines above still hold what did run)
    failed = _failed(cases, results) + (
        _failed(cases, shim_results) if shim_results is not None else [])
    if failed:
        print(f"bench: cases without a result: {failed}", file=sys.stderr)
    rc = 1 if (failed or shim_rc) else 0
    if not any(c.case == "1.1" for c in cases):
        return rc

    flag = next((r for r in results
                 if r.get("case") == "1.1" and "error" not in r), None)
    if flag is None:
        print(json.dumps({"metric": "bench_failed", "value": 0,
                          "unit": "images/sec", "vs_baseline": 0.0}))
        return 1
    full = flag["full_case"]
    print(json.dumps({
        # a degraded batch (CPU / --quick) is a different workload: name it
        # so it can never be confused with the published case
        "metric": ("resnet_v2_50_inference_346x346_imgs_per_sec" if full
                   else f"resnet_v2_50_inference_346x346_"
                        f"b{flag['batch']}_smoke"),
        "value": flag["throughput"],
        "unit": "images/sec",
        "vs_baseline": (round(flag["throughput"]
                              / V100_NOMINAL_IMGS_PER_SEC, 3)
                        if full else 0.0),
        "mfu": flag["mfu"] if flag["mfu"] is not None else 0.0,
        "spread": [flag["throughput_min"], flag["throughput_max"]],
        "env": label,
    }))
    return rc


if __name__ == "__main__":
    sys.exit(main())
