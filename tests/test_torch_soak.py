"""The soak's four legs on the port (vtpu_torch/bench/soak.py and
vtpu_torch/bench/chaos.py), held to benchmarks/soak.py.

The simulated legs (``ElasticSoak`` and ``MigrateSoak`` with ``waves=``,
``ServingSoak``, whose day is always simulated) run on both packages with
the same inputs: the JAX soak's classes with their ``vtpu`` names bound as
tests/torch_sched_parity.py binds them (the port's GPUDevices in the JAX
registry, ``types``' TPU names read as the NVIDIA ones, a recording
apiserver and scheduler), the port's with its apiserver and scheduler
classes the recording ones. Their results are equal field for field
(timings are simulated, so nothing is left out) and so are their apiserver
records after ``vTPU`` -> ``vGPU``. Simulated time paces the arrivals, not
the async commit pipeline's worker threads, whose patches interleave with
the rebalancer's rounds differently from run to run in either package; so
the comparison runs with the pipeline inline (``VTPU_COMMIT_PIPELINE=0``,
the same setting on both), and the CLI case of each leg runs the default
pipeline and holds the JAX smoke tests' gates. The wall-clock chaos soak
is held to tests/test_soak.py's own gates at its arguments.
"""

import json
import os
import subprocess
import sys

import pytest

import tests.torch_sched_parity as tsp
from vtpu_torch import api
from vtpu_torch.bench import chaos as port_chaos
from vtpu_torch.bench import soak as port_soak
from vtpu_torch import device as port_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIMULATED = {
    "elastic": ("ElasticSoak", dict(duration_s=8.0, nodes=8, tenants=3,
                                    rate=30.0, waves=80)),
    "migrate": ("MigrateSoak", dict(duration_s=8.0, nodes=8, tenants=3,
                                    rate=30.0, waves=80)),
    "serving": ("ServingSoak", dict(duration_s=20.0, trough_qps=80.0,
                                    peak_qps=1200.0, autoscale_s=1.0)),
}


@pytest.fixture
def jax_soak():
    """benchmarks/soak.py's globals for the JAX run; MigrateSoak's base is
    the bound ElasticSoak (a class is rebound alone, with its own base)"""
    view = tsp.module_view("benchmarks.soak", False)
    saved = view["MigrateSoak"]
    body = {k: v for k, v in vars(saved).items()
            if k not in ("__dict__", "__weakref__")}
    view["MigrateSoak"] = type("MigrateSoak", (view["ElasticSoak"],), body)
    yield view
    view["MigrateSoak"] = saved


def recorded(fn, port, monkeypatch):
    """``fn()``'s result and the records of its apiserver, sorted, after
    ``vTPU`` -> ``vGPU``"""
    with monkeypatch.context() as mp:
        if port:
            for mod in (port_soak, port_chaos):
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


@pytest.mark.parametrize("leg", sorted(SIMULATED))
def test_simulated_leg_equals_the_jax_soak(jax_soak, monkeypatch, leg):
    monkeypatch.setenv(api.ENV_COMMIT_PIPELINE, "0")
    cls, kw = SIMULATED[leg]
    jax, jrec = recorded(lambda: jax_soak[cls](**kw).run(), False,
                         monkeypatch)
    port, prec = recorded(lambda: getattr(port_soak, cls)(**kw).run(), True,
                          monkeypatch)
    assert port == jax
    assert prec == jrec
    assert len(prec) > 50
    assert port["ok"], port


def test_elastic_leg_gates_with_the_default_pipeline():
    """tests/test_soak.py's elastic smoke, on the port"""
    port_device.init_default_devices()
    try:
        res = port_soak.ElasticSoak(duration_s=8.0, nodes=8, tenants=3,
                                    rate=30.0, waves=80).run()
    finally:
        port_device.reset_registry()
    assert res["static"]["quota_violations"] == 0
    assert res["elastic"]["quota_violations"] == 0
    assert res["static"]["overlay_drift"] == 0
    assert res["elastic"]["overlay_drift"] == 0
    assert res["elastic"]["resizes"] > 0
    assert res["density_up"], res
    assert res["ok"], res


def test_chaos_soak_survives_with_slos_green():
    """tests/test_soak.py's wall-clock chaos smoke, its arguments and its
    gates, on the port"""
    port_device.init_default_devices()
    try:
        res = port_soak.Soak(duration_s=5.0, nodes=24, pools=2, tenants=3,
                             rate=40.0, chaos_every_s=1.6,
                             diurnal_period_s=2.5, p99_slo_ms=20000.0,
                             tenant_quota=8).run()
    finally:
        port_device.reset_registry()
    assert res["overlay_drift"] == 0, res.get("drift_samples")
    assert res["double_booked_chips"] == 0
    assert res["dropped"] == 0
    assert res["slo_ok"], res
    assert res["ok"], res
    assert res["failovers"] >= 1
    assert res["node_chaos_events"] >= 1
    assert res["bound"] >= 40
    assert res["bound"] == res["admitted"] - res["no_fit"]


def _cli(*argv):
    out = subprocess.run([sys.executable, "-m", "vtpu_torch.bench.soak",
                          *argv], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    return out.returncode, json.loads(out.stdout.strip().splitlines()[-1])


def test_cli_elastic(tmp_path):
    rc, res = _cli("--elastic", "--duration", "8", "--nodes", "8",
                   "--tenants", "3", "--rate", "30", "--waves", "80",
                   "--bench-json", str(tmp_path / "elastic.json"))
    assert rc == 0 and res["ok"], res
    assert res["metric"] == "soak_elastic" and res["density_up"]
    assert json.loads((tmp_path / "elastic.json").read_text()) == res


def test_cli_migrate():
    rc, res = _cli("--migrate", "--duration", "8", "--nodes", "8",
                   "--tenants", "3", "--rate", "30", "--waves", "80")
    assert rc == 0 and res["ok"], res
    assert res["metric"] == "soak_migrate"
    assert res["migrate"]["quota_violations"] == 0
    assert res["elastic_only"]["overlay_drift"] == 0
    assert res["migrate"]["overlay_drift"] == 0
    assert res["completed_moves"] >= 2
    assert res["min_moves_per_wave"] >= 1
    assert res["blackout_p99_ms"] <= res["blackout_p99_gate_ms"]


def test_cli_serving():
    rc, res = _cli("--serving", "--duration", "20", "--tenants", "3")
    assert rc == 0 and res["ok"], res
    assert res["metric"] == "soak_serving"
    assert res["dropped"] == 0
    assert res["shed_fraction"] <= res["shed_budget"]
    assert res["overlay_drift"] == 0 and res["double_booked_chips"] == 0
    assert res["failovers"] == 1 and res["gated_polls"] == 1
    assert res["gang_bound"] >= 1 and res["preempted_replicas"] >= 1
    assert res["completed"] + res["shed_submit"] + res["drain_shed"] == \
        res["requests"] > 1000


def test_cli_blackout_gate_from_the_env():
    """VTPU_MIGRATE_BLACKOUT_P99_MS below the simulated blackout fails the
    migrate leg with exit 1, as the JAX soak's"""
    env = dict(os.environ, **{api.ENV_MIGRATE_BLACKOUT_P99_MS: "1"})
    out = subprocess.run([sys.executable, "-m", "vtpu_torch.bench.soak",
                          "--migrate", "--duration", "8", "--nodes", "8",
                          "--tenants", "3", "--rate", "30", "--waves", "80"],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert out.returncode == 1 and not res["ok"]
    assert res["blackout_p99_gate_ms"] == 1.0
    assert res["blackout_p99_ms"] > 1.0
