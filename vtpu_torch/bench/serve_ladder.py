"""Serving-gateway ladder: offered-QPS rungs + diurnal autoscale, the port
of benchmarks/serve_bench.py onto vtpu_torch.gateway.

An open-loop offered-QPS arrival process drives the gateway
(vtpu_torch/gateway/) against replicas of a deterministic step-cost
model on a SIMULATED clock — no sleeps, no wall time, no randomness,
so the smoke run is flake-free on any CI box and the full ladder
measures the gateway's algorithms, not the host's scheduler.

Two phases, two acceptance gates:

* **Ladder** (`run_serve_ladder`): each rung offers R requests/sec
  for D seconds to (a) a ONE-REQUEST-PER-STEP baseline (batch pinned
  to 1 — the run-to-completion strawman every replica starts from)
  and (b) the continuous batcher (per-step refill, pad-to-bucket,
  adaptive batch). A rung is CLEAN when nothing shed, everything
  completed, and p99 held the SLO. `--check` gates the batched
  best-clean rung >= SERVE_SPEEDUP_FLOOR x the baseline's at the
  SAME p99 SLO, with ZERO steady-state recompiles (every bucket
  compiles once in warmup; per-request shapes would recompile every
  step).
* **Diurnal** (`run_diurnal_case`): a sinusoidal day of traffic
  through router + SLO autoscaler. `--check` gates p99 <= SLO over
  the whole day, sheds within the budget, and the replica count
  actually TRACKING demand (peak fleet > trough fleet, scale-down
  after the peak).

    python -m vtpu_torch.bench.serve_ladder            # quick dev run
    python -m vtpu_torch.bench.serve_ladder --smoke    # smoke (seconds)
    python -m vtpu_torch.bench.serve_ladder --ladder --check

It measures the gateway's algorithms on a simulated clock, not a card:
the card's serving path is ``chip_smoke.py`` phase (p). The smoke's
results equal benchmarks/serve_bench.py's exactly
(tests/test_torch_gateway.py).
"""

from __future__ import annotations

import argparse
import heapq
import json
import math
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..gateway import Autoscaler, Replica, ReplicaBatcher, ReplicaSet, Router
from ..gateway.stats import ServingStats
from ..scheduler.core import ShedError

#: acceptance floor: continuous batching vs one-request-per-step at
#: the same p99 SLO (docs/serving.md)
SERVE_SPEEDUP_FLOOR = 3.0
#: p99 latency SLO the whole bench gates against (simulated seconds)
SLO_S_DEFAULT = 0.05
#: diurnal shed budget: explicit retryable refusals per offered
#: request the day may burn (docs/serving.md "shed budget")
DIURNAL_SHED_BUDGET = 0.005
LADDER_DEFAULT_RATES = (100, 200, 400, 800, 1600, 3200)
SMOKE_RATES = (100, 400)

FEATURE_DIM = 8
_ROW = np.zeros(FEATURE_DIM, np.float32)
TENANTS = ("team-a", "team-b", "team-c")


class SimModel:
    """Deterministic step-cost serving model: a step over a batch of
    n rows costs ``base + per_row * n`` SIMULATED seconds, plus a
    one-time ``compile`` penalty the first time a batch SHAPE is
    seen — the XLA-compile behaviour pad-to-bucket exists to bound.
    Latency is stamped through the real :class:`ServingStats`
    accessor, exactly like ``ShardedServingModel.infer``, so the
    gateway's EWMA consumes the same contract in bench and prod."""

    def __init__(self, base_s: float = 0.004,
                 per_row_s: float = 0.00025,
                 compile_s: float = 0.030,
                 devices: int = 1) -> None:
        self.base_s = base_s
        self.per_row_s = per_row_s
        self.compile_s = compile_s
        self.stats = ServingStats(local_devices=devices)
        self.compiled: set = set()

    def infer(self, x):
        n = len(x)
        secs = self.base_s + self.per_row_s * n
        if n not in self.compiled:
            self.compiled.add(n)
            secs += self.compile_s
        self.stats.record_step(secs)
        return x


def _pct(samples: List[float], p: float) -> float:
    if not samples:
        return 0.0
    ordered = sorted(samples)
    return ordered[min(len(ordered) - 1,
                       int(round(p * (len(ordered) - 1))))]


def _warm_buckets(batcher: ReplicaBatcher, t: float = 0.0) -> int:
    """Compile every pad bucket once before measurement (a real
    gateway does this at replica spin-up): steady state must then be
    recompile-free."""
    bucket = batcher.batch_min
    warmed = 0
    while True:
        saved = batcher.batch
        batcher.batch = bucket
        for _ in range(bucket):
            batcher.submit("warmup", _ROW, now=t)
        batcher.step(now=t)
        batcher.batch = saved
        warmed += 1
        if bucket >= batcher.batch_max:
            return warmed
        bucket *= 2


def simulate(router: Router, replicas: ReplicaSet,
             arrivals: List[Tuple[float, str]], *,
             autoscaler: Optional[Autoscaler] = None,
             autoscale_s: float = 5.0,
             pressure_s: float = 0.0,
             now_box: Optional[List[float]] = None) -> Dict:
    """Discrete-event simulation: arrivals route through the gateway,
    each replica steps serially (busy until the step's simulated
    completion), the autoscaler polls on its own cadence. Fully
    deterministic — ties in the event heap break on a sequence
    number, and nothing reads the wall clock."""
    busy: Dict[str, float] = {}
    completed: List = []
    shed = 0
    replica_timeline: List[Tuple[float, int]] = []
    heap: List[Tuple[float, int, str, object]] = []
    seq = 0

    def push(t: float, kind: str, data: object = None) -> None:
        nonlocal seq
        heapq.heappush(heap, (t, seq, kind, data))
        seq += 1

    for t, tenant in arrivals:
        push(t, "arr", tenant)
    if autoscaler is not None and autoscale_s > 0:
        push(autoscale_s, "scale", None)
    if pressure_s > 0 and router.source is not None:
        push(pressure_s, "pressure", None)

    def kick(t: float) -> None:
        # start a step on every idle replica with queued work (drains
        # re-routed queues too — a drained survivor may be idle)
        for r in router.live_replicas():
            if busy.get(r.name, 0.0) <= t and r.batcher.depth:
                res = r.batcher.step(now=t)
                if res is not None:
                    busy[r.name] = t + res.step_seconds
                    completed.extend(res.requests)
                    push(busy[r.name], "free", r.name)

    while heap:
        t, _seq, kind, data = heapq.heappop(heap)
        if now_box is not None:
            now_box[0] = t
        if kind == "arr":
            try:
                router.submit(data, _ROW, now=t)
            except ShedError:
                shed += 1
        elif kind == "scale":
            autoscaler.poll_once()
            replica_timeline.append(
                (t, len(router.live_replicas())))
            if heap or any(r.batcher.depth
                           for r in router.live_replicas()):
                push(t + autoscale_s, "scale", None)
        elif kind == "pressure":
            router.refresh_pressure()
            if heap:
                push(t + pressure_s, "pressure", None)
        kick(t)

    return {
        "completed": completed,
        "shed": shed,
        "replica_timeline": replica_timeline,
    }


def one_rung(rate: int, duration_s: float, slo_s: float,
             batched: bool, devices: int = 1) -> Dict:
    """One offered-QPS rung against a single fresh replica."""
    model = SimModel(devices=devices)
    if batched:
        batcher = ReplicaBatcher(model, batch_min=1, batch_max=64,
                                 queue_cap=512, slo_s=slo_s)
    else:
        # the one-request-per-step strawman: no refill, no buckets
        batcher = ReplicaBatcher(model, batch_min=1, batch_max=1,
                                 queue_cap=512, slo_s=slo_s)
    warmed = _warm_buckets(batcher)
    recompiles_warm = batcher.recompiles
    assert recompiles_warm == warmed
    rs = ReplicaSet("bench")
    rs.add(Replica(name="r0", batcher=batcher))
    router = Router(rs)
    n = max(8, int(rate * duration_s))
    arrivals = [(i / rate, TENANTS[i % len(TENANTS)])
                for i in range(n)]
    sim = simulate(router, rs, arrivals)
    lat = [r.latency for r in sim["completed"]
           if r.tenant != "warmup"]
    served = len(lat)
    last = max((r.completed_at for r in sim["completed"]
                if r.tenant != "warmup"), default=duration_s)
    p50, p99 = _pct(lat, 0.50), _pct(lat, 0.99)
    achieved = round(served / max(last, duration_s), 2)
    steady_recompiles = batcher.recompiles - recompiles_warm
    clean = (sim["shed"] == 0 and served == n and p99 <= slo_s
             and steady_recompiles == 0)
    return {
        "offered_qps": rate,
        "requests": n,
        "served": served,
        "shed": sim["shed"],
        "achieved_qps": achieved,
        "p50_latency_ms": round(p50 * 1e3, 2),
        "p99_latency_ms": round(p99 * 1e3, 2),
        "steady_recompiles": steady_recompiles,
        "compiled_buckets": warmed,
        "clean": clean,
    }


def run_serve_ladder(rates=LADDER_DEFAULT_RATES,
                     duration_s: float = 10.0,
                     slo_s: float = SLO_S_DEFAULT) -> Dict:
    """Phase (a): continuous batching vs one-request-per-step, same
    SLO, same offered-rate rungs."""
    result: Dict = {
        "metric": "serve_ladder",
        "slo_ms": round(slo_s * 1e3, 2),
        "duration_s": duration_s,
        "rungs": [],
        "unit": "requests/sec",
    }
    best = {"baseline": 0.0, "batched": 0.0}
    for rate in rates:
        rung: Dict = {"offered_qps": rate}
        for mode, batched in (("baseline", False), ("batched", True)):
            r = one_rung(rate, duration_s, slo_s, batched)
            rung[mode] = r
            if r["clean"]:
                best[mode] = max(best[mode], r["achieved_qps"])
        result["rungs"].append(rung)
    result["best_clean_baseline_qps"] = best["baseline"]
    result["best_clean_qps"] = best["batched"]
    result["speedup_vs_unbatched"] = (
        round(best["batched"] / best["baseline"], 2)
        if best["baseline"] else None)
    result["steady_recompiles"] = sum(
        r["batched"]["steady_recompiles"] for r in result["rungs"])
    return result


def diurnal_arrivals(period_s: float, trough_qps: float,
                     peak_qps: float) -> List[Tuple[float, str]]:
    """One deterministic 'day': per-second rates follow
    trough + (peak-trough) * sin^2(pi t/period), arrivals evenly
    spaced within each second, tenants round-robin."""
    arrivals: List[Tuple[float, str]] = []
    i = 0
    for sec in range(int(period_s)):
        rate = trough_qps + (peak_qps - trough_qps) * (
            math.sin(math.pi * sec / period_s) ** 2)
        k = int(round(rate))
        for j in range(k):
            arrivals.append((sec + j / max(1, k), TENANTS[i % 3]))
            i += 1
    return arrivals


def run_diurnal_case(period_s: float = 240.0,
                     trough_qps: float = 100.0,
                     peak_qps: float = 4000.0,
                     slo_s: float = SLO_S_DEFAULT,
                     max_replicas: int = 8,
                     autoscale_s: float = 5.0) -> Dict:
    """Phase (b): router + leader-less autoscaler through one traffic
    day; replica count must track the swing while p99 holds."""
    rs = ReplicaSet("diurnal")
    now_box = [0.0]
    spawn_seq = [0]

    def make_replica() -> Replica:
        model = SimModel(devices=1)
        batcher = ReplicaBatcher(model, batch_min=1, batch_max=64,
                                 queue_cap=512, slo_s=slo_s)
        _warm_buckets(batcher, t=now_box[0])
        # warm-start the EWMA from the fleet so the router does not
        # funnel the whole arrival stream at a zero-scored newcomer
        live = [r.batcher.step_ewma for r in rs.list() if r.live]
        if live:
            batcher.step_ewma = max(live)
        name = f"rep-{spawn_seq[0]}"
        spawn_seq[0] += 1
        return Replica(name=name, batcher=batcher,
                       node=f"node-{name}")

    rs.add(make_replica())
    router = Router(rs)
    autoscaler = Autoscaler(
        rs, make_replica,
        lambda r: router.drain_replica(r, now=now_box[0]),
        slo_s=slo_s, min_replicas=1, max_replicas=max_replicas,
        idle_rounds=3, period_s=autoscale_s)
    arrivals = diurnal_arrivals(period_s, trough_qps, peak_qps)
    sim = simulate(router, rs, arrivals, autoscaler=autoscaler,
                   autoscale_s=autoscale_s, now_box=now_box)
    lat = [r.latency for r in sim["completed"]
           if r.tenant != "warmup"]
    timeline = sim["replica_timeline"]
    peak_window = [n for t, n in timeline
                   if period_s * 0.25 <= t <= period_s * 0.75]
    tail_window = [n for t, n in timeline if t >= period_s]
    peak_replicas = max(peak_window, default=1)
    final_replicas = min(tail_window, default=peak_replicas)
    shed_fraction = (sim["shed"] / len(arrivals)) if arrivals else 0.0
    p99 = _pct(lat, 0.99)
    return {
        "metric": "serve_diurnal",
        "period_s": period_s,
        "trough_qps": trough_qps,
        "peak_qps": peak_qps,
        "slo_ms": round(slo_s * 1e3, 2),
        "requests": len(arrivals),
        "served": len(lat),
        "shed": sim["shed"],
        "shed_fraction": round(shed_fraction, 5),
        "p50_latency_ms": round(_pct(lat, 0.50) * 1e3, 2),
        "p99_latency_ms": round(p99 * 1e3, 2),
        "peak_replicas": peak_replicas,
        "final_replicas": final_replicas,
        "grows": autoscaler.grows,
        "shrinks": autoscaler.shrinks,
        "slo_held": p99 <= slo_s,
        "tracked_demand": (peak_replicas > 1
                           and final_replicas < peak_replicas
                           and autoscaler.shrinks > 0),
        "shed_within_budget": shed_fraction <= DIURNAL_SHED_BUDGET,
    }


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="CI-speed run: two rungs + a 60s simulated "
                         "day (deterministic — simulated clock, no "
                         "randomness)")
    ap.add_argument("--ladder", action="store_true",
                    help="full offered-QPS ladder + diurnal day; with "
                         "--check gates the floors "
                         f"(>= {SERVE_SPEEDUP_FLOOR}x over "
                         "one-request-per-step at the same p99 SLO, "
                         "zero steady-state recompiles, diurnal SLO "
                         "held while replicas track demand)")
    ap.add_argument("--rates", default=None,
                    help="comma-separated offered-QPS rungs")
    ap.add_argument("--duration", type=float, default=None,
                    help="simulated seconds per rung (default 10; "
                         "2 with --smoke)")
    ap.add_argument("--slo-ms", type=float, default=SLO_S_DEFAULT * 1e3,
                    help="p99 latency SLO in ms (default 50)")
    ap.add_argument("--check", action="store_true",
                    help="exit 1 unless the serving gates hold")
    ap.add_argument("--out", default=None,
                    help="append each JSON result line to this file "
                         "too")
    args = ap.parse_args(argv)
    slo_s = args.slo_ms / 1e3
    rates = ([int(x) for x in args.rates.split(",")] if args.rates
             else SMOKE_RATES if args.smoke else LADDER_DEFAULT_RATES)
    duration = (args.duration if args.duration is not None
                else 2.0 if args.smoke else 10.0)

    def emit(res: Dict) -> None:
        line = json.dumps(res)
        print(line)
        if args.out:
            with open(args.out, "a", encoding="utf-8") as f:
                f.write(line + "\n")

    ladder = run_serve_ladder(rates=rates, duration_s=duration,
                              slo_s=slo_s)
    emit(ladder)
    if args.smoke:
        diurnal = run_diurnal_case(period_s=60.0, trough_qps=50.0,
                                   peak_qps=1200.0, slo_s=slo_s,
                                   autoscale_s=2.0)
    else:
        diurnal = run_diurnal_case(slo_s=slo_s)
    emit(diurnal)
    if args.check:
        ok = True
        speedup = ladder["speedup_vs_unbatched"] or 0.0
        if speedup < SERVE_SPEEDUP_FLOOR:
            ok = False
        if ladder["steady_recompiles"] != 0:
            ok = False
        if not (diurnal["slo_held"] and diurnal["tracked_demand"]
                and diurnal["shed_within_budget"]):
            ok = False
        if not ok:
            emit({"metric": "serve_check", "ok": False,
                  "speedup_floor": SERVE_SPEEDUP_FLOOR,
                  "speedup": speedup,
                  "steady_recompiles": ladder["steady_recompiles"],
                  "diurnal_slo_held": diurnal["slo_held"],
                  "diurnal_tracked_demand": diurnal["tracked_demand"],
                  "diurnal_shed_within_budget":
                      diurnal["shed_within_budget"]})
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
