"""The control plane's benches on the port, held to the JAX package's:
``vtpu_torch.bench.sched`` to benchmarks/sched_bench.py and
``vtpu_torch.bench.monitor`` to benchmarks/monitor_bench.py.

The scheduler's cases run at the JAX tests' sizes (tests/test_sched_bench.py)
on both packages with the same inputs: the JAX bench's functions run with
their ``vtpu`` names bound as tests/torch_sched_parity.py binds them (the
port's GPUDevices in the JAX registry, ``types``' TPU resource and handshake
names read as the NVIDIA ones, a recording apiserver and scheduler), and
its ``_inventory`` gives the port's cards (an H100's type string and MiB,
10 replicas, no mesh coordinate, the JAX bench's card ids). A
single-threaded case's apiserver records are equal after ``vTPU`` ->
``vGPU``, and every count is equal exactly; a concurrent case's threads
interleave their placements, so its counts are equal and its overlay drift
0. Rates and latencies are this host's wall clock: printed by the benches,
never compared or gated here. The tracing budget's verdict is computed by
the JAX rule from a given unit cost.

The monitor bench's regions are written once, by the port's C library, and
collected by the JAX legacy collector (through a hard link named
``vtpu.cache``, read with the JAX package's own libvtpucore.so in a process
of its own), the port's
legacy collector and the port's snapshot data plane: every sample is equal
after ``METRIC_NAMES``, and the snapshot path LISTs no pod in steady state.
"""

import json
import os
import subprocess
import sys

import pytest

import tests.torch_sched_parity as tsp
from tests import torch_jaxlib
from vtpu.util.types import DeviceInfo as JaxDeviceInfo

from vtpu_torch.bench import monitor as port_monitor
from vtpu_torch.bench import sched as port_sched

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ------------------------------------------------------------ sched_bench

@pytest.fixture
def jax_bench():
    """benchmarks/sched_bench.py's globals for the JAX run, its cards the
    port's"""
    import benchmarks.sched_bench as jb

    view = tsp.module_view("benchmarks.sched_bench", False)

    def inventory(node, chips, devmem=port_sched.CARD_MB):
        return [JaxDeviceInfo(id=d.id, index=d.index, count=d.count,
                              devmem=d.devmem, devcore=d.devcore,
                              type=d.type, numa=d.numa)
                for d in port_sched._inventory(node, chips, devmem)]

    saved = {k: view[k] for k in ("_inventory", "LatencyFakeKubeClient")}
    view["_inventory"] = inventory
    # a class of the JAX module, not rebound: its methods call super()
    view["LatencyFakeKubeClient"] = jb.LatencyFakeKubeClient
    yield view
    view.update(saved)


def recorded(fn, port, monkeypatch, modules=(port_sched,)):
    """``fn()``'s result and the apiserver's records of the run, sorted,
    after ``vTPU`` -> ``vGPU``; on the port's side its modules' apiserver
    and scheduler classes are the recording ones"""
    with monkeypatch.context() as mp:
        if port:
            for mod in modules:
                for name in ("FakeKubeClient", "Scheduler"):
                    if hasattr(mod, name):
                        mp.setattr(mod, name, tsp._recording(True)[name])
        del tsp._LOG[:]
        del tsp._SCHEDS[:]
        tsp.register_vendors()
        try:
            res = fn()
        finally:
            for s in tsp._SCHEDS:
                s.stop()
            tsp.reset_vendors()
    return res, sorted(json.dumps(tsp.to_port_strings(e), sort_keys=True,
                                  default=str) for e in tsp._LOG)


def both(jax_bench, monkeypatch, name, *args, **kw):
    """``name(*args, **kw)`` of each bench: (JAX, port), each (result,
    records)"""
    return (recorded(lambda: jax_bench[name](*args, **kw), False,
                     monkeypatch),
            recorded(lambda: getattr(port_sched, name)(*args, **kw), True,
                     monkeypatch))


def test_filter_case_records_and_counts_match(jax_bench, monkeypatch):
    (jr, jrec), (pr, prec) = both(jax_bench, monkeypatch, "run_case",
                                  nodes=8, chips_per_node=4,
                                  pods_per_node=1, iters=5, warmup=1)
    assert pr["metric"] == "sched_filter"
    assert pr["scheduled"] == jr["scheduled"] == 5
    for k in ("nodes", "chips_per_node", "standing_pods", "iters", "unit"):
        assert pr[k] == jr[k], k
    assert prec == jrec
    # each probe pod's assignment and deletion reached the apiserver
    assert sum(r.startswith('["pod"') for r in prec) == 6
    assert pr["filters_per_sec"] > 0 and 0 < pr["p50_ms"] <= pr["p99_ms"]


def test_cli_smoke_records_and_counts_match(jax_bench, monkeypatch, capsys):
    (jrc, jrec), (prc, prec) = both(jax_bench, monkeypatch, "main",
                                    ["--smoke"])
    jl, pl = [json.loads(line) for line in
              capsys.readouterr().out.strip().splitlines()]
    assert jrc == prc == 0
    assert pl["metric"] == jl["metric"] == "sched_filter"
    assert pl["scheduled"] == jl["scheduled"] == 5
    assert prec == jrec


def test_pipeline_case_counts_match(jax_bench, monkeypatch):
    (jr, _), (pr, _) = both(jax_bench, monkeypatch, "run_pipeline_case",
                            nodes=6, pods=4, latency_ms=2.0, bind_workers=4)
    assert pr["metric"] == "sched_pipeline" and pr["pods"] == 4
    for k in ("sync_scheduled", "pipelined_scheduled", "pods",
              "standing_pods"):
        assert pr[k] == jr[k], k
    assert pr["sync_scheduled"] == pr["pipelined_scheduled"] == 4
    assert pr["overlay_drift"] == jr["overlay_drift"] == 0
    assert "speedup_vs_sync" in pr


def test_pipeline_cli_smoke_counts_match(jax_bench, monkeypatch, capsys):
    argv = ["--smoke", "--apiserver-latency-ms", "2", "--pipeline-pods",
            "3", "--bind-workers", "2"]
    (jrc, _), (prc, _) = both(jax_bench, monkeypatch, "main", argv)
    jl, pl = [json.loads(line) for line in
              capsys.readouterr().out.strip().splitlines()]
    assert jrc == prc == 0
    for k in ("metric", "sync_scheduled", "pipelined_scheduled",
              "overlay_drift"):
        assert pl[k] == jl[k], k
    assert pl["overlay_drift"] == 0 and pl["pipelined_scheduled"] == 3


def test_multi_fleet_case_counts_match(jax_bench, monkeypatch):
    (jr, _), (pr, _) = both(jax_bench, monkeypatch, "run_multi_fleet_case",
                            nodes=32, chips_per_node=4, pools=4, threads=4,
                            schedulers=(1, 2), pods=24)
    assert [r["schedulers"] for r in pr["rungs"]] == [1, 2]
    for j, p in zip(jr["rungs"], pr["rungs"]):
        for k in ("schedulers", "pods", "admitted", "bound",
                  "overlay_drift"):
            assert p[k] == j[k], k
        assert p["bound"] == p["admitted"] > 0
        assert p["overlay_drift"] == 0
        assert len(p["per_instance_s"]) == p["schedulers"]
    assert "speedup_vs_single_active" in pr["rungs"][1]


def test_multi_fleet_cli_smoke_writes_its_bench_json(jax_bench, monkeypatch,
                                                     capsys, tmp_path):
    argv = ["--smoke", "--fleet", "--schedulers", "1,2", "--bench-json"]
    (jrc, _), (prc, _) = (
        recorded(lambda: jax_bench["main"](argv + [str(tmp_path / "j")]),
                 False, monkeypatch),
        recorded(lambda: port_sched.main(argv + [str(tmp_path / "p")]),
                 True, monkeypatch))
    jl, pl = [json.loads(line) for line in
              capsys.readouterr().out.strip().splitlines()]
    assert jrc == prc == 0
    # the --bench-json file is the printed result
    assert json.loads((tmp_path / "p").read_text()) == pl
    assert [(r["schedulers"], r["admitted"], r["bound"], r["overlay_drift"])
            for r in pl["rungs"]] == [
        (r["schedulers"], r["admitted"], r["bound"], r["overlay_drift"])
        for r in jl["rungs"]]


@pytest.mark.parametrize("argv,keys", [
    (["--smoke", "--sharded"],
     ("single_lock_scheduled", "sharded_scheduled",
      "single_lock_overlay_drift", "sharded_overlay_drift")),
    (["--smoke", "--fleet"], ("pods", "admitted", "bound",
                              "overlay_drift")),
])
def test_concurrent_cli_smokes_count_alike(jax_bench, monkeypatch, capsys,
                                           argv, keys):
    (jrc, _), (prc, _) = both(jax_bench, monkeypatch, "main", argv)
    jl, pl = [json.loads(line) for line in
              capsys.readouterr().out.strip().splitlines()]
    assert jrc == prc == 0
    assert {k: pl[k] for k in keys} == {k: jl[k] for k in keys}
    assert all(pl[k] == 0 for k in keys if "drift" in k)


def test_ladder_smoke_every_rung_clean(jax_bench, monkeypatch, capsys):
    (jrc, _), (prc, _) = both(jax_bench, monkeypatch, "main",
                              ["--smoke", "--ladder"])
    jl, pl = [json.loads(line) for line in
              capsys.readouterr().out.strip().splitlines()]
    assert jrc == prc == 0
    for j, p in zip(jl["rungs"], pl["rungs"]):
        for k in ("offered_pods_per_sec", "pods", "no_fit", "errors",
                  "overlay_drift"):
            assert p[k] == j[k], k
        assert p["bound"] == p["pods"] - p["no_fit"]
        assert p["overlay_drift"] == 0 and p["errors"] == 0


@pytest.mark.parametrize("unit_us,runs", [
    (12.5, [(900.0, 0.40), (800.0, 0.31), (950.0, 0.38), (850.0, 0.29)]),
    (41.0, [(500.0, 0.70), (480.0, 0.50), (510.0, 0.66), (470.0, 0.60)]),
    (20.0, [(300.0, 0.30), (200.0, 0.15), (310.0, 0.20), (190.0, 0.17)]),
])
def test_trace_overhead_verdict_is_the_jax_rule(jax_bench, unit_us, runs):
    """run_trace_overhead_case over a given unit cost and given filter
    runs (tracing off, on, off, on; no live timing): the same result on
    both packages, and the port's verdict is the JAX test's gate
    (tests/test_sched_bench.py: <= 40 us a pod, <= 10% of the p50)"""
    results = []
    for side in (jax_bench, vars(port_sched)):
        given = iter(runs)
        saved = {k: side[k] for k in ("run_case", "_trace_unit_cost_us")}
        side["run_case"] = lambda nodes, **kw: dict(zip(
            ("filters_per_sec", "p50_ms"), next(given)))
        side["_trace_unit_cost_us"] = lambda: unit_us
        try:
            results.append(side["run_trace_overhead_case"](
                nodes=256, iters=40, rounds=2))
        finally:
            side.update(saved)
    jax, port = results
    assert port == jax
    jax_gate = (jax["trace_unit_cost_us"] <= 40.0
                and jax["per_filter_overhead_pct"] <= 10.0)
    assert port_sched.trace_overhead_ok(
        port["trace_unit_cost_us"],
        port["per_filter_overhead_pct"]) == jax_gate


def test_trace_unit_cost_runs_the_port_tracer():
    assert port_sched._trace_unit_cost_us(iters=500) > 0


def test_host_harnesses_import_no_torch_jax_or_vtpu():
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys\nfrom vtpu_torch.bench import sched, monitor, soak, "
         "chaos\nprint(sorted(m for m in sys.modules if m.split('.')[0] "
         "in ('torch', 'jax', 'jaxlib', 'vtpu')))"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


# ---------------------------------------------------------- monitor_bench

@pytest.fixture(scope="module")
def jax_core(tmp_path_factory):
    """the JAX package's libvtpucore.so (tests/torch_jaxlib.py), loaded
    only by the JAX collector's process"""
    return torch_jaxlib.core(tmp_path_factory)


#: the JAX legacy collector over a containers directory, in a process of
#: its own: argv[1] is [dir, cards, pods, node]; prints its samples
JAX_COLLECT = """
import json, sys
from benchmarks import monitor_bench
from vtpu.monitor.pathmonitor import ContainerRegions
from vtpu.plugin.tpulib import ChipInfo, FakeTpuLib
from vtpu.util.client import FakeKubeClient
path, chips, pods, node = json.loads(sys.argv[1])
client = FakeKubeClient()
for pod in pods:
    client.add_pod(pod)
collector = monitor_bench.LegacyMonitorCollector(
    ContainerRegions(path), FakeTpuLib(chips=[ChipInfo(**c) for c in chips]),
    client, node)
print(json.dumps([[s.name, sorted(s.labels.items()), s.value]
                  for f in collector.collect() for s in f.samples]))
"""


def _samples(families):
    return sorted((s.name, tuple(sorted(s.labels.items())), s.value)
                  for f in families for s in f.samples)


@pytest.mark.parametrize("n_regions", [16, 64])
def test_monitor_samples_match_the_jax_legacy_collector(jax_core, tmp_path,
                                                        n_regions):
    from vtpu_torch.monitor.daemon import MonitorDaemon
    from vtpu_torch.monitor.metrics import METRIC_NAMES
    from vtpu_torch.monitor.pathmonitor import ContainerRegions
    from vtpu_torch.plugin.nvml import FakeNvmlLib
    from vtpu_torch.util.client import FakeKubeClient

    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    chips = port_monitor.bench_chips(4)
    pods = port_monitor.bench_pods(n_regions)
    port_monitor.synthesize(str(port_dir), n_regions, chips)
    for entry in os.listdir(port_dir):
        (jax_dir / entry).mkdir(parents=True)
        os.link(port_dir / entry / "vgpu.cache",
                jax_dir / entry / "vtpu.cache")
    out = subprocess.run(
        [sys.executable, "-c", JAX_COLLECT, json.dumps(
            [str(jax_dir), [dict(uuid=c.uuid, index=c.index, type=c.type,
                                 hbm_mb=c.hbm_mb) for c in chips],
             pods, port_monitor.NODE])],
        cwd=REPO, env=dict(os.environ, VTPU_CORE_LIB=jax_core),
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    names = dict(METRIC_NAMES)
    names.update({k + "_total": v + "_total"
                  for k, v in METRIC_NAMES.items()})
    want = sorted((names.get(n, n), tuple(map(tuple, labels)), v)
                  for n, labels, v in json.loads(out.stdout))
    clients = [FakeKubeClient(), FakeKubeClient()]
    for pod in pods:
        for c in clients:
            c.add_pod(json.loads(json.dumps(pod)))
    legacy = port_monitor.LegacyMonitorCollector(
        ContainerRegions(str(port_dir)), FakeNvmlLib(chips=chips),
        clients[0], port_monitor.NODE)
    got = _samples(legacy.collect())
    assert got == want
    assert len(got) == 4 * 3 + n_regions * 5
    # the snapshot data plane: its families that the legacy one exports
    daemon = MonitorDaemon(str(port_dir), gpulib=FakeNvmlLib(chips=chips),
                           client=clients[1], node_name=port_monitor.NODE,
                           info_port=0)
    try:
        daemon.podcache.sync_once()
        daemon.sweep_once()
        clients[1].reset_call_counts()
        daemon.sweep_once()
        kept = {s[0] for s in got}
        snap = [s for s in _samples(daemon.collector.collect())
                if s[0] in kept]
        daemon.node_info()
        assert snap == got
        assert clients[1].list_pod_calls == 0
    finally:
        daemon.regions.close()


def test_monitor_bench_cli_smoke(capsys):
    assert port_monitor.main(["--smoke"]) == 0
    (line,) = capsys.readouterr().out.strip().splitlines()
    res = json.loads(line)
    assert res["metric"] == "monitor_scrape" and res["regions"] == 16
    assert res["steady_state_list_calls"] == 0
    assert res["legacy_lists_per_scrape"] == 1.0
    assert res["legacy_collect_ms_p50"] > 0 and res["snapshot_collect_ms_p50"] > 0
