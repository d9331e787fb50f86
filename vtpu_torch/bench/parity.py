"""``--parity``: the gated shim/native A/B (bench.py:525-673).

Two ``--serve`` children, one native and one under libvgpu.so with a
quota, alternate reps within the same window; each case's ratio of the
two sides' best reps must clear ``VTPU_PARITY_MIN`` (default 0.95), with
up to three rounds a case. Then the profile half runs each case again with
the callsite profile on and demands ``execute``'s p50 speedup against the
``--profile-baseline`` (``VTPU_PARITY_P50X``, default 3x). With no
baseline the mode fails, as the reference does.
"""

from __future__ import annotations

import json
import shutil
import sys
import tempfile

from .. import api
from ..util.env import env_float
from . import prof
from .profile import _load_profile_baseline, profile_case
from .serve import _child_cmd, _reply, _send, _spawn_serve_child, _stop
from .wiring import _native_env, _shim_env, backend

PARITY_MIN_RATIO_DEFAULT = 0.95
PARITY_P50_SPEEDUP_DEFAULT = 3.0


def _parity_case(child_nat, child_shm, cid, reps):
    """Alternate reps native/shim for one case; returns (ratio, native
    result, shim result) or (None, reason, None) on a lost child.

    The ratio compares each side's BEST rep (the least wall time): each
    side's best rep is its measurement with the least interference from
    the host's other work. The median-based results are still returned
    and printed for the record."""
    # both set up at once; no rep starts before both are ready
    sent = [_send(child, f"CASE {cid}") for child in (child_nat, child_shm)]
    for ok, child, label in zip(sent, (child_nat, child_shm),
                                ("native", "shim")):
        msg = _reply(child, 1200.0) if ok else None
        if msg is None or "error" in msg:
            return None, f"{label} child failed case setup: {msg}", None
    rates = {"native": [], "shim": []}
    for _ in range(reps):
        for child, label in ((child_nat, "native"), (child_shm, "shim")):
            msg = _child_cmd(child, "REP", 600.0)
            if msg is None or "error" in msg:
                return None, f"{label} child failed a rep: {msg}", None
            rates[label].append(msg["rate"])
    out = {}
    for child, label in ((child_nat, "native"), (child_shm, "shim")):
        msg = _child_cmd(child, "ENDCASE", 600.0)
        if msg is None or "result" not in msg:
            return None, f"{label} child failed ENDCASE: {msg}", None
        out[label] = msg["result"]
    best_nat = max(rates["native"]) if rates["native"] else 0.0
    best_shm = max(rates["shim"]) if rates["shim"] else 0.0
    ratio = best_shm / best_nat if best_nat else 0.0
    return ratio, out["native"], out["shim"]


def run_parity_mode(case_ids, quick: bool, reps: int,
                    baseline_path: str = "") -> int:
    min_ratio = env_float(api.ENV_PARITY_MIN, PARITY_MIN_RATIO_DEFAULT)
    min_speedup = env_float(api.ENV_PARITY_P50X, PARITY_P50_SPEEDUP_DEFAULT)
    label = backend()
    print(f"[parity] backend {label}: gating shim/native >= {min_ratio} on "
          f"cases {','.join(case_ids)}", file=sys.stderr)
    failures = []
    ratios = {}
    run_dir = tempfile.mkdtemp(prefix="vgpu-bench-parity-")
    try:
        children = [_spawn_serve_child(quick, _native_env(run_dir)),
                    _spawn_serve_child(quick, _shim_env(run_dir))]
        try:
            for cid in case_ids:
                # up to 3 measurement rounds a case: one noisy round (a
                # neighbour stealing the host's cores mid-window) must not
                # fail the gate when a clean round clears it
                ratio = None
                for attempt in range(3):
                    ratio, nat, shm = _parity_case(*children, cid, reps)
                    if ratio is None:
                        break
                    print(f"[parity] case {cid} round {attempt + 1}: "
                          f"native {nat['throughput']} vs shim "
                          f"{shm['throughput']} {nat['unit']} -> best-rep "
                          f"ratio {ratio:.4f}", file=sys.stderr)
                    if ratio >= min_ratio:
                        break
                if ratio is None:
                    failures.append(f"case {cid}: {nat}")
                    continue
                ratios[cid] = round(ratio, 4)
                print(f"[parity] case {cid}: ratio {ratio:.4f} "
                      f"({'PASS' if ratio >= min_ratio else 'FAIL'} "
                      f">= {min_ratio})", file=sys.stderr)
                if ratio < min_ratio:
                    failures.append(f"case {cid}: shim/native ratio "
                                    f"{ratio:.4f} < {min_ratio}")
        finally:
            for child in children:
                _stop(child)

        # profile half: execute's p50 against the baseline's
        baseline = _load_profile_baseline(baseline_path)
        if not baseline:
            failures.append("no profile baseline "
                            f"(--profile-baseline {baseline_path!r})")
        for cid in case_ids:
            if cid not in baseline:
                if baseline:
                    # a partial baseline must not silently waive this
                    # case's p50 criterion
                    failures.append(f"case {cid}: not in the profile "
                                    "baseline — p50 gate not evaluated")
                continue
            rc, agg, _ = profile_case(run_dir, cid, quick, reps)
            if rc != 0 or not agg["callsites"]:
                failures.append(f"case {cid}: profile child rc {rc}, "
                                f"{len(agg['callsites'])} callsite(s) "
                                "recorded")
                continue
            diff = prof.diff_aggregates(baseline[cid], agg)
            ex = diff["callsites"].get("execute", {})
            speedup = ex.get("p50_speedup")
            print(f"[parity] case {cid}: execute p50 "
                  f"{ex.get('base_p50_us')} -> {ex.get('cur_p50_us')} us "
                  f"({speedup}x vs baseline; need >= {min_speedup}x)",
                  file=sys.stderr)
            if speedup is None or speedup < min_speedup:
                failures.append(
                    f"case {cid}: execute p50 speedup {speedup} < "
                    f"{min_speedup}x vs the baseline")
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)

    print(json.dumps({
        "metric": "shim_parity",
        "backend": label,
        "ratios": ratios,
        "min_ratio": min_ratio,
        "min_p50_speedup": min_speedup,
        "failures": failures,
        "pass": not failures,
    }))
    if failures:
        for f in failures:
            print(f"[parity] FAIL: {f}", file=sys.stderr)
        return 1
    return 0
