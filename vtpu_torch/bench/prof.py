"""Read libvgpu.so's callsite profile out of shared regions (the port of
hack/vtpuprof.py's reader).

libvgpu.so records per-callsite latency histograms, exact call, error and
byte counters and quota-pressure signals into every region's profile block
(vtpu_torch/csrc/shared_region.h): BUF_ALLOC and BUF_FREE around its
allocation and free hooks, TRANSFER around its copy hooks, EXECUTE around
its launch hooks with the admission (gate, feedback block, SM bucket) as
QUOTA_CHECK inside it, DONE_WITH_BUFFER for each finished bracket or span
of launches it charges, and CHARGE/UNCHARGE in the region's own
primitives. This tool turns them into the per-callsite table:

    callsite      calls  err   p50(us)  p99(us)  est total(ms)  share
    execute        9120    0      1.1      4.2          11.20   61.3%
    buf_alloc       310    1      3.9     18.6           2.80   15.3%
    ...

Modes
-----
node-local (default): aggregate every readable region under one or more
    containers dirs / entry dirs / cache files (default: the device
    plugin's host containers dir, ``vtpu_torch.api.HOST_CONTAINERS_DIR``).
fleet (``--scrape URL[,URL...]``): GET each monitor's /nodeinfo endpoint
    and aggregate the ``profile`` summaries it publishes.
overhead (``--overhead``): the profile's own cost, on this host's CPU over
    the mock driver (hack/vtpuprof.py's A/B): the native test plane's
    ``profbench`` modes, ``region_test`` (the region's charge pair) and
    ``interposer_test`` (cuMemAlloc_v2 + cuMemFree_v2 through libvgpu.so,
    with the hooks' unit cost decomposed), gated at OVERHEAD_BUDGET_PCT.

    python -m vtpu_torch.bench.prof <containers dir> [--json] [--baseline F]
    python -m vtpu_torch.bench.prof --overhead [--json]

``python -m vtpu_torch.bench --profile`` drives the bench cases through
libvgpu.so and reads their regions with this module.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from typing import Dict, Iterable, List, Optional, Tuple

from .. import api, native
from ..enforce.region import (
    PROF_CALLSITE_NAMES,
    PROF_PRESSURE_NAMES,
    VTPU_PROF_BUCKETS,
    RegionCorruptError,
    RegionView,
    prof_percentile_ns,
)

CACHE_FILENAME = api.CACHE_FILENAME
DEFAULT_DIR = api.HOST_CONTAINERS_DIR

#: pressure kinds whose mere presence deserves a flag in the table
#: (at_limit_ns is wall time and only flags above this many ms)
AT_LIMIT_FLAG_MS = 1.0

#: classes that run INSIDE another measured class (shared_region.h:
#: CHARGE/UNCHARGE are nested in BUF_ALLOC/BUF_FREE, QUOTA_CHECK is a
#: component of EXECUTE): their time is already counted in the enclosing
#: row, so summing them into the share denominator would double-count.
#: They fall back into the denominator only when NO outer class recorded
#: time (region-API consumers without the interposer, where
#: charge/uncharge are top level).
NESTED_CALLSITES = frozenset({"charge", "uncharge", "quota_check"})


# ---------------------------------------------------------------------------
# collection
# ---------------------------------------------------------------------------

def _region_files(paths: Iterable[str]) -> List[str]:
    """Expand containers dirs / entry dirs / cache files into cache-file
    paths."""
    out: List[str] = []
    for p in paths:
        if os.path.isfile(p):
            out.append(p)
            continue
        direct = os.path.join(p, CACHE_FILENAME)
        if os.path.isfile(direct):
            out.append(direct)
            continue
        if os.path.isdir(p):
            for name in sorted(os.listdir(p)):
                cache = os.path.join(p, name, CACHE_FILENAME)
                if os.path.isfile(cache):
                    out.append(cache)
    return out


def collect_local(paths: Iterable[str]) -> List[Tuple[str, dict]]:
    """[(label, profile_summary dict)] for every readable region."""
    out: List[Tuple[str, dict]] = []
    for cache in _region_files(paths):
        label = os.path.basename(os.path.dirname(cache)) or cache
        try:
            with RegionView(cache) as v:
                snap = v.snapshot()
                summary = snap.profile_summary()
                # the v8 host ledger rides the same table (bytes + limit +
                # rejected/over events per region)
                summary["host"] = snap.host_summary()
                out.append((label, summary))
        except RegionCorruptError as e:
            print(f"[prof] skipping corrupt region {cache}: {e}",
                  file=sys.stderr)
        except (OSError, ValueError) as e:
            print(f"[prof] skipping {cache}: {e}", file=sys.stderr)
    return out


def collect_scrape(urls: Iterable[str]) -> List[Tuple[str, dict]]:
    """[(label, profile summary)] from monitor /nodeinfo endpoints."""
    from urllib.request import urlopen
    out: List[Tuple[str, dict]] = []
    for url in urls:
        if "://" not in url:
            url = "http://" + url
        if not url.rstrip("/").endswith("/nodeinfo"):
            url = url.rstrip("/") + "/nodeinfo"
        try:
            with urlopen(url, timeout=10) as resp:
                info = json.load(resp)
        except Exception as e:
            print(f"[prof] scrape of {url} failed: {e}", file=sys.stderr)
            continue
        node = info.get("node", "") or url
        for entry in info.get("containers", []):
            prof = entry.get("profile")
            if not prof:
                continue  # export toggled off
            pod = (f"{entry.get('pod_namespace', '')}/"
                   f"{entry.get('pod_name', '') or entry.get('entry', '')}")
            if "host" not in prof:
                # fleet mode: /nodeinfo carries the host ledger as
                # first-class entry fields (daemon._render_nodeinfo)
                prof = dict(prof)
                prof["host"] = {
                    "host_limit": int(entry.get("host_limit", 0) or 0),
                    "host_used": int(entry.get("host_used", 0) or 0),
                    "host_oom_events": int(
                        entry.get("host_oom_events", 0) or 0),
                }
            out.append((f"{node}:{pod}", prof))
    return out


# ---------------------------------------------------------------------------
# aggregation
# ---------------------------------------------------------------------------

def aggregate(summaries: Iterable[Tuple[str, dict]]) -> dict:
    """Merge profile summaries into one per-callsite aggregate.

    Histograms and exact counters add; percentile estimates come from
    the MERGED histogram (never averaged from per-region percentiles)."""
    cs_acc: Dict[str, dict] = {}
    pressure: Dict[str, int] = {k: 0 for k in PROF_PRESSURE_NAMES}
    busy_ms = 0.0
    regions = 0
    host = {"host_limit": 0, "host_used": 0, "host_oom_events": 0,
            "limited_regions": 0}
    for _label, summary in summaries:
        regions += 1
        busy_ms += float(summary.get("busy_ms", 0.0))
        h = summary.get("host") or {}
        host["host_used"] += int(h.get("host_used", 0))
        host["host_oom_events"] += int(h.get("host_oom_events", 0))
        if int(h.get("host_limit", 0)):
            host["host_limit"] += int(h.get("host_limit", 0))
            host["limited_regions"] += 1
        for name, cell in summary.get("callsites", {}).items():
            acc = cs_acc.setdefault(name, {
                "calls": 0, "errors": 0, "bytes": 0, "sampled": 0,
                "est_total_ms": 0.0, "hist": [0] * VTPU_PROF_BUCKETS,
            })
            acc["calls"] += int(cell.get("calls", 0))
            acc["errors"] += int(cell.get("errors", 0))
            acc["bytes"] += int(cell.get("bytes", 0))
            acc["sampled"] += int(cell.get("sampled", 0))
            acc["est_total_ms"] += float(cell.get("est_total_ms", 0.0))
            for b, v in enumerate(cell.get("hist", [])):
                if b < VTPU_PROF_BUCKETS:
                    acc["hist"][b] += int(v)
        for kind, v in summary.get("pressure", {}).items():
            pressure[kind] = pressure.get(kind, 0) + int(v)
    outer_ms = sum(a["est_total_ms"] for n, a in cs_acc.items()
                   if n not in NESTED_CALLSITES)
    total_ms = outer_ms if outer_ms > 0 else sum(
        a["est_total_ms"] for a in cs_acc.values())
    nested_excluded = outer_ms > 0
    callsites = {}
    # stable callsite order (the header's class order, extras appended)
    order = [n for n in PROF_CALLSITE_NAMES if n in cs_acc]
    order += [n for n in sorted(cs_acc) if n not in PROF_CALLSITE_NAMES]
    for name in order:
        acc = cs_acc[name]
        callsites[name] = {
            "calls": acc["calls"],
            "errors": acc["errors"],
            "bytes": acc["bytes"],
            "sampled": acc["sampled"],
            "p50_us": round(prof_percentile_ns(acc["hist"], 0.50) / 1e3, 3),
            "p99_us": round(prof_percentile_ns(acc["hist"], 0.99) / 1e3, 3),
            "est_total_ms": round(acc["est_total_ms"], 3),
            "share_pct": round(100.0 * acc["est_total_ms"] / total_ms, 1)
                         if total_ms > 0 else 0.0,
            "nested": nested_excluded and name in NESTED_CALLSITES,
            "hist": acc["hist"],
        }
    return {
        "regions": regions,
        "busy_ms": round(busy_ms, 3),
        "shim_total_ms": round(total_ms, 3),
        "callsites": callsites,
        "pressure": pressure,
        "host": host,
    }


def pressure_flags(agg: dict) -> List[str]:
    """Human-readable quota-pressure warnings (empty = no pressure)."""
    flags: List[str] = []
    p = agg.get("pressure", {})
    if p.get("near_limit_failures"):
        flags.append(f"near_limit_failures={p['near_limit_failures']} "
                     "(allocations rejected at >=7/8 of the HBM quota)")
    if p.get("charge_retries"):
        flags.append(f"charge_retries={p['charge_retries']} "
                     "(charge path re-attached and retried)")
    if p.get("contention_spins"):
        flags.append(f"contention_spins={p['contention_spins']} "
                     "(launch throttle / feedback wait iterations)")
    at_ms = p.get("at_limit_ns", 0) / 1e6
    if at_ms >= AT_LIMIT_FLAG_MS:
        flags.append(f"at_limit={at_ms:.1f}ms "
                     "(wall time launches spent blocked at a limit)")
    if p.get("table_drops"):
        flags.append(f"table_drops={p['table_drops']} "
                     "(object-table inserts dropped on table-full: those "
                     "objects' bytes run UNACCOUNTED — quota leakage)")
    if p.get("host_near_limit_failures"):
        flags.append(
            f"host_near_limit_failures={p['host_near_limit_failures']} "
            "(host-memory allocations rejected at >=7/8 of the host "
            "quota)")
    if p.get("host_over_events"):
        flags.append(
            f"host_over_events={p['host_over_events']} "
            "(force charges pushed host usage OVER its quota — the "
            "monitor's clamp/grace/block escalation signal)")
    return flags


# ---------------------------------------------------------------------------
# baseline diff: before/after comparisons in one command
# ---------------------------------------------------------------------------

def load_baseline(path: str) -> dict:
    """A saved `--json` aggregate (or a bench per-case wrapper, in which
    case the caller picks the case)."""
    with open(path) as f:
        return json.load(f)


def diff_aggregates(base: dict, cur: dict) -> dict:
    """Per-callsite Δp50/Δp99/Δshare between two aggregates (same JSON
    shape `aggregate()` emits). `ratio` fields are base/current — >1
    means the callsite got FASTER by that factor."""
    out = {}
    names = [n for n in base.get("callsites", {})] + [
        n for n in cur.get("callsites", {})
        if n not in base.get("callsites", {})]
    for name in names:
        b = base.get("callsites", {}).get(name, {})
        c = cur.get("callsites", {}).get(name, {})
        bp50, cp50 = float(b.get("p50_us", 0)), float(c.get("p50_us", 0))
        bp99, cp99 = float(b.get("p99_us", 0)), float(c.get("p99_us", 0))
        bsh, csh = float(b.get("share_pct", 0)), float(c.get("share_pct", 0))
        out[name] = {
            "base_p50_us": bp50, "cur_p50_us": cp50,
            "delta_p50_us": round(cp50 - bp50, 3),
            "p50_speedup": round(bp50 / cp50, 2) if cp50 > 0 else None,
            "base_p99_us": bp99, "cur_p99_us": cp99,
            "delta_p99_us": round(cp99 - bp99, 3),
            "base_share_pct": bsh, "cur_share_pct": csh,
            "delta_share_pct": round(csh - bsh, 1),
        }
    return {
        "callsites": out,
        "base_shim_total_ms": base.get("shim_total_ms", 0.0),
        "cur_shim_total_ms": cur.get("shim_total_ms", 0.0),
    }


def render_diff_table(diff: dict, title: str = "") -> str:
    lines: List[str] = []
    if title:
        lines.append(title)
    lines.append(f"shim time (est): {diff['base_shim_total_ms']:.2f} -> "
                 f"{diff['cur_shim_total_ms']:.2f} ms")
    hdr = (f"{'callsite':<17}{'p50(us)':>18}{'x':>7}{'p99(us)':>18}"
           f"{'share':>16}")
    lines.append(hdr)
    lines.append("-" * len(hdr))
    for name, d in diff["callsites"].items():
        speed = (f"{d['p50_speedup']:.1f}x" if d["p50_speedup"]
                 else "n/a")
        lines.append(
            f"{name:<17}"
            f"{d['base_p50_us']:>8.1f}->{d['cur_p50_us']:<8.1f}"
            f"{speed:>7}"
            f"{d['base_p99_us']:>8.1f}->{d['cur_p99_us']:<8.1f}"
            f"{d['base_share_pct']:>6.1f}->{d['cur_share_pct']:<5.1f}"
            f"({d['delta_share_pct']:+.1f})")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# rendering
# ---------------------------------------------------------------------------

def render_table(agg: dict, title: str = "") -> str:
    lines: List[str] = []
    if title:
        lines.append(title)
    lines.append(f"regions: {agg['regions']}   "
                 f"shim time (est): {agg['shim_total_ms']:.2f} ms   "
                 f"device busy: {agg['busy_ms']:.2f} ms")
    hdr = (f"{'callsite':<17}{'calls':>9}{'err':>6}{'p50(us)':>10}"
           f"{'p99(us)':>10}{'est total(ms)':>15}{'share':>8}")
    lines.append(hdr)
    lines.append("-" * len(hdr))
    any_nested = False
    for name, c in agg["callsites"].items():
        nested = c.get("nested", False)
        any_nested = any_nested or nested
        lines.append(
            f"{name:<17}{c['calls']:>9}{c['errors']:>6}"
            f"{c['p50_us']:>10.1f}{c['p99_us']:>10.1f}"
            f"{c['est_total_ms']:>15.2f}{c['share_pct']:>7.1f}%"
            + (" *" if nested else ""))
    if any_nested:
        lines.append("* nested inside the rows above (charge/uncharge in "
                     "buf_alloc/buf_free/transfer, quota_check in "
                     "execute); excluded from the shim-time total")
    if not agg["callsites"]:
        lines.append("(no recorded callsites — profiling off, or no "
                     "shim traffic yet)")
    host = agg.get("host") or {}
    if host.get("host_limit") or host.get("host_used") \
            or host.get("host_oom_events"):
        lines.append(
            f"host ledger: {host.get('host_used', 0) / 2**20:.1f} MiB "
            f"used / "
            f"{host.get('host_limit', 0) / 2**20:.1f} MiB limit over "
            f"{host.get('limited_regions', 0)} limited region(s), "
            f"{host.get('host_oom_events', 0)} rejection/over event(s)")
    flags = pressure_flags(agg)
    if flags:
        lines.append("quota pressure:")
        lines.extend(f"  ! {f}" for f in flags)
    else:
        lines.append("quota pressure: none")
    return "\n".join(lines)


def top_cost_centers(agg: dict, n: int = 2) -> List[str]:
    ranked = sorted(agg["callsites"].items(),
                    key=lambda kv: kv[1]["est_total_ms"], reverse=True)
    return [name for name, _ in ranked[:n]]


# ---------------------------------------------------------------------------
# overhead A/B (the native test plane's profbench modes)
# ---------------------------------------------------------------------------

#: the profile's cost on the deployed charge path, at most (the reference's
#: budget, hack/vtpuprof.py)
OVERHEAD_BUDGET_PCT = 1.0


def _run_profbench(binary: str, env: Optional[dict] = None) -> dict:
    """The JSON line of ``binary profbench`` (a program of the native test
    plane, built first when stale)."""
    path = native.build(os.path.join("test", binary))
    r = subprocess.run([path, "profbench"], capture_output=True, text=True,
                       env=env, timeout=600)
    if r.returncode != 0:
        raise RuntimeError(f"{binary} profbench failed:\n"
                           f"{r.stdout}{r.stderr}")
    for line in r.stdout.splitlines():
        line = line.strip()
        if line.startswith("{"):
            return json.loads(line)
    raise RuntimeError(f"{binary} profbench printed no JSON:\n{r.stdout}")


def run_overhead() -> dict:
    """Both profiling-cost A/Bs on this CPU host, libvgpu.so's over the
    mock driver; their JSON with a verdict against OVERHEAD_BUDGET_PCT, under
    the keys of hack/vtpuprof.py's run_overhead."""
    core = _run_profbench("region_test")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("CUDA_", "LD_PRELOAD", "MOCK_", "VGPU_",
                                "VTPU_PROFILE", "LIBCUDA_"))}
    env["LD_LIBRARY_PATH"] = native.mock_cuda_dir()
    env["LIBVGPU_SO"] = native.interposer()
    shim = _run_profbench("interposer_test", env=env)
    gated = float(shim["decomposed_overhead_pct"])
    return {
        "core_charge_path": core,
        "shim_charge_path": shim,
        "gated_overhead_pct": gated,
        "budget_pct": OVERHEAD_BUDGET_PCT,
        "pass": gated <= OVERHEAD_BUDGET_PCT,
    }


def _print_overhead(res: dict) -> None:
    c, s = res["core_charge_path"], res["shim_charge_path"]
    print("the profile's cost on this CPU host, libvgpu.so over the mock "
          "driver (not a GPU's figure):")
    print(f"core charge path (try_alloc+free): "
          f"off {c['off_ns_per_op']:.0f} ns/op, "
          f"on {c['on_ns_per_op']:.0f} ns/op "
          f"({c['overhead_pct']:+.2f}% wall)")
    print(f"interposer charge path (cuMemAlloc_v2+cuMemFree_v2): "
          f"off {s['charge_pair_off_ns']:.0f} ns, "
          f"on {s['charge_pair_on_ns']:.0f} ns "
          f"({s['wall_overhead_pct']:+.2f}% wall, noise-prone); "
          f"decomposed {s['prof_event_ns']:.1f} ns/event x "
          f"{s['events_per_pair']:.0f} events = "
          f"{s['decomposed_overhead_pct']:.3f}%")
    print(f"a launch: off {s['launch_off_ns']:.0f} ns, on "
          f"{s['launch_on_ns']:.0f} ns; a 256 B copy: off "
          f"{s['copy_off_ns']:.0f} ns, on {s['copy_on_ns']:.0f} ns, the "
          f"driver's alone {s['copy_direct_ns']:.0f} ns")
    verdict = "PASS" if res["pass"] else "FAIL"
    print(f"overhead gate: {res['gated_overhead_pct']:.3f}% <= "
          f"{res['budget_pct']}% ... {verdict}")


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m vtpu_torch.bench.prof", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("paths", nargs="*",
                    help=f"containers dir(s), entry dir(s) or "
                         f"{CACHE_FILENAME} file(s); default {DEFAULT_DIR}")
    ap.add_argument("--scrape", metavar="URL[,URL...]",
                    help="fleet mode: aggregate monitor /nodeinfo "
                         "endpoints instead of local region files")
    ap.add_argument("--json", action="store_true",
                    help="emit the aggregate as one JSON object")
    ap.add_argument("--per-region", action="store_true",
                    help="print one table per region before the "
                         "aggregate")
    ap.add_argument("--overhead", action="store_true",
                    help="run the profiling-overhead A/B on this CPU host "
                         "(profiling on vs VTPU_PROFILE=0, libvgpu.so over "
                         "the mock driver) and gate it at "
                         f"<={OVERHEAD_BUDGET_PCT}%% of the charge path")
    ap.add_argument("--baseline", metavar="SAVED.json",
                    help="diff the aggregate against a previously saved "
                         "--json aggregate: per-callsite Δp50/Δp99/"
                         "Δshare in one command")
    args = ap.parse_args(argv)

    if args.overhead:
        res = run_overhead()
        if args.json:
            print(json.dumps(res, indent=1))
        else:
            _print_overhead(res)
        return 0 if res["pass"] else 1

    if args.scrape:
        summaries = collect_scrape(args.scrape.split(","))
    else:
        summaries = collect_local(args.paths or [DEFAULT_DIR])
    if args.per_region and not args.json:
        for label, summary in summaries:
            print(render_table(aggregate([(label, summary)]),
                               title=f"== {label} =="))
            print()
    agg = aggregate(summaries)
    diff = None
    if args.baseline:
        base = load_baseline(args.baseline)
        if "callsites" not in base:
            print(f"[prof] {args.baseline} is not a saved aggregate "
                  "(no 'callsites' key)", file=sys.stderr)
            return 2
        diff = diff_aggregates(base, agg)
    if args.json:
        out = dict(agg)
        if diff is not None:
            out["baseline_diff"] = diff
        print(json.dumps(out, indent=1))
    else:
        print(render_table(agg, title="== aggregate =="))
        if diff is not None:
            print()
            print(render_diff_table(
                diff, title=f"== vs baseline {args.baseline} =="))
    return 0


if __name__ == "__main__":
    sys.exit(main())
