"""``--profile``: each case's cost inside libvgpu.so, callsite by callsite
(bench.py:386-499).

Each case runs in its own shim child against a fresh region with the
callsite profile on and every call timed, so the table attributes cleanly
to one case; the parent then reads the region with :mod:`.prof` and names
the case's top cost centers. A child that fails, or a region with no
callsite, fails the mode. The reference's default baseline is a TPU
shim's profile, so the port's default is none: the diff is then skipped.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile

from .. import api
from ..enforce.region import RegionView
from . import prof
from .wiring import _shim_env, backend, child_cmd


def _load_profile_baseline(path: str) -> dict:
    """{case_id: aggregate} from a saved ``--profile-json`` (or an empty
    dict when absent or unreadable: the diff is then skipped)."""
    if not path:
        return {}
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, json.JSONDecodeError):
        return {}
    return data.get("cases", {})


def _case_child(cid: str, quick: bool, reps: int, env: dict) -> int:
    """Case ``cid``'s matrix run in a child with ``env``; its return
    code."""
    args = ["--cases", cid, "--reps", str(reps)] + (["--quick"] if quick
                                                     else [])
    return subprocess.run(child_cmd(*args), env=env,
                          stdout=subprocess.DEVNULL).returncode


def profile_case(run_dir: str, cid: str, quick: bool, reps: int):
    """Case ``cid`` under libvgpu.so with the profile on, in a region of
    its own under ``run_dir``: (child rc, aggregate, the region's
    launches)."""
    env = _shim_env(run_dir, pod=f"prof-{cid.replace('.', '-')}",
                    profile=True)
    cache = env[api.ENV_SHARED_CACHE]
    rc = _case_child(cid, quick, reps, env)
    agg = prof.aggregate(prof.collect_local([os.path.dirname(cache)]))
    launches = 0
    if os.path.exists(cache):
        with RegionView(cache) as view:
            launches = view.total_launches()
    return rc, agg, launches


def run_profile_mode(case_ids, quick: bool, reps: int, out_path: str = "",
                     json_out: str = "", baseline_path: str = "") -> int:
    baseline = _load_profile_baseline(baseline_path)
    label = backend()
    done, failed, md = [], [], []
    aggs, launches = {}, {}
    run_dir = tempfile.mkdtemp(prefix="vgpu-bench-prof-")
    try:
        for cid in case_ids:
            print(f"[profile] case {cid} through libvgpu.so ({label})...",
                  file=sys.stderr)
            rc, agg, n = profile_case(run_dir, cid, quick, reps)
            if rc != 0 or not agg["callsites"]:
                print(f"[profile] case {cid}: child rc {rc}, "
                      f"{len(agg['callsites'])} callsite(s) recorded",
                      file=sys.stderr)
                failed.append(cid)
                continue
            top = prof.top_cost_centers(agg, 2)
            done.append(cid)
            aggs[cid], launches[cid] = agg, n
            title = f"== case {cid} per-callsite libvgpu.so profile =="
            table = prof.render_table(agg, title=title)
            print(table)
            print(f"top shim cost centers: {', '.join(top) or 'none'}")
            print(f"region launches: {n}")
            entry = (f"## Case {cid}\n\n```\n{table}\n```\n\n"
                     f"Top shim cost centers: **{', '.join(top) or 'none'}**"
                     f"\n")
            if cid in baseline:
                diff = prof.diff_aggregates(baseline[cid], agg)
                dtable = prof.render_diff_table(
                    diff, title=f"== case {cid} vs {baseline_path} ==")
                print(dtable)
                entry += (f"\nVersus {baseline_path}:\n\n```\n{dtable}\n"
                          f"```\n")
            print()
            md.append(entry)
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
    if out_path and done:
        with open(out_path, "w") as f:
            f.write(
                "# libvgpu.so callsite profile — bench matrix\n\n"
                f"Generated by `python -m vtpu_torch.bench --profile --cases "
                f"{','.join(case_ids)}{' --quick' if quick else ''}` "
                f"(backend: {label}). The per-callsite numbers are the\n"
                "interposer's own cost (the time spent in libcuda "
                "excluded); `quota_check` is the launch\nadmission inside "
                "`execute`, `charge`/`uncharge` the region's ledger inside "
                "`buf_alloc`/`buf_free`.\n\n" + "\n".join(md))
        print(f"wrote {out_path}", file=sys.stderr)
    if json_out and done:
        with open(json_out, "w") as f:
            json.dump({"backend": label, "cases": aggs,
                       "region_launches": launches}, f, indent=1)
        print(f"wrote {json_out}", file=sys.stderr)
    return 0 if done and not failed else 1
