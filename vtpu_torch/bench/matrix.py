"""The matrix run and its published file (bench.py:893-1077).

``BENCH_GPU_MATRIX.json`` is the port's published artifact: only runs at
the published batch sizes may touch it (a ``--quick`` smoke or a CPU run at
batch 2 is a different workload), and a partial ``--cases`` rerun merges
case by case into the saved file instead of clobbering the other cases.
"""

from __future__ import annotations

import json
import os
import sys

from . import MATRIX_FILE
from .runner import run_case


def _run_matrix(cases, device, quick: bool, reps: int, label: str) -> list:
    results = []
    for case in cases:
        try:
            r = run_case(case, device, quick, reps)
        except Exception as e:  # one sick case must not kill the matrix
            r = {"case": case.case, "model": case.model,
                 "mode": case.mode, "error": f"{type(e).__name__}: {e}"}
        results.append(r)
        if "error" in r:
            print(f"  [{label}] case {r['case']} {r['model']}/{r['mode']}: "
                  f"ERROR {r['error']}", file=sys.stderr)
        else:
            mfu_s = (f"{100 * r['mfu']:.1f}%" if r["mfu"] is not None
                     else "n/a")
            print(f"  [{label}] case {r['case']} {r['model']}/{r['mode']} "
                  f"b={r['batch']}: {r['throughput']} {r['unit']} "
                  f"(min {r['throughput_min']}, max {r['throughput_max']}; "
                  f"step {r['step_ms']} ms, MFU {mfu_s}; {r['device']})",
                  file=sys.stderr)
    return results


def _merge_cases(old, new):
    """Replace old entries case by case with the rerun's (stable case
    order)."""
    by_case = {r.get("case"): r for r in old if isinstance(r, dict)}
    for r in new:
        by_case[r.get("case")] = r
    return [by_case[c] for c in sorted(by_case, key=str)]


def _ratio_map(native_results, shim_results) -> dict:
    nat = {r["case"]: r for r in native_results if "error" not in r}
    shm = {r["case"]: r for r in shim_results if "error" not in r}
    return {
        c: round(shm[c]["throughput"] / nat[c]["throughput"], 4)
        for c in sorted(set(nat) & set(shm))
        if nat[c]["throughput"]
    }


def _publishable(rs) -> bool:
    """Whether results ``rs`` may touch the matrix file: some ran, and
    every one that ran is at its published batch."""
    ok = [r for r in rs if "error" not in r]
    return bool(ok) and all(r.get("full_case") for r in ok)


def _read(path: str) -> dict:
    if not os.path.exists(path):
        return {}
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return {}


def _write(path: str, data: dict, what: str) -> None:
    with open(path, "w") as f:
        json.dump(data, f, indent=1)
    print(f"wrote {path} ({what})", file=sys.stderr)


def write_interleaved(results, shim_results, run_all: bool,
                      path: str = MATRIX_FILE) -> None:
    """Both halves of an interleaved run, window-paired."""
    if run_all:
        data = {
            "interleaved": True,
            "results": results,
            "shim_results": shim_results,
            # the ratio column (the reference's chart: vGPU against native
            # per case), both halves from the SAME window
            "shim_native_ratio": _ratio_map(results, shim_results),
        }
    else:
        data = _read(path)
        data["results"] = _merge_cases(data.get("results", []), results)
        data["shim_results"] = _merge_cases(data.get("shim_results", []),
                                            shim_results)
        # the rerun cases are window-paired; the flag only stays True if
        # the rest of the file already was
        data["interleaved"] = bool(data.get("interleaved"))
        data["shim_native_ratio"] = _ratio_map(data["results"],
                                               data["shim_results"])
    _write(path, data, "interleaved")


def write_half(results, key: str, run_all: bool,
               path: str = MATRIX_FILE) -> None:
    """One half (``results`` or ``shim_results``) of a plain run."""
    prior = _read(path)
    prior[key] = results if run_all else _merge_cases(prior.get(key, []),
                                                      results)
    prior.pop("interleaved", None)  # the halves are no longer paired
    prior["shim_native_ratio"] = _ratio_map(prior.get("results", []),
                                            prior.get("shim_results", []))
    _write(path, prior, key)
