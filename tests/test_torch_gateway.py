"""The port's serving gateway held to the JAX package's.

- Every case of tests/test_gateway.py runs twice (the machinery of
  tests/torch_sched_parity.py ``run_reference_test``): as written, on
  ``vtpu.gateway``, and with every name it takes from ``vtpu`` bound to
  the port's (``vtpu_torch.gateway``, ``vtpu_torch.models.serving``,
  ``vtpu_torch.scheduler``). Both runs hold the test's own assertions, on
  the same fake model and simulated clock, and their traces are equal:
  every submit (queued or shed), every step's ``StepResult`` (batch,
  bucket, step seconds, each request's tenant, arrival, completion and
  result row) with the adaptive target after it, every router pick and
  every autoscaler round's action and fleet size. Tolerance: exact.
- The case that serves the real ``ShardedServingModel`` builds it on the
  card in the port; here it runs on the CPU with the JAX model's weights
  carried across, each result row within rtol 1e-5 of the JAX batcher's.
- The serve ladder (``python -m vtpu_torch.bench.serve_ladder``, the port
  of benchmarks/serve_bench.py): its smoke rungs and short diurnal day
  equal the JAX bench's results exactly (simulated clock).
"""

from __future__ import annotations

import contextlib
import importlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import benchmarks.serve_bench as jax_bench
from tests.torch_sched_parity import run_reference_test
from vtpu import gateway as jax_gateway
from vtpu.models import serving as jax_serving
from vtpu_torch import gateway
from vtpu_torch.bench import serve_ladder
from vtpu_torch.models import convert, serving

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULE = "tests.test_gateway"
#: the case that builds the real model, on the card in the port: held to
#: the reference below, on the CPU
REAL_MODEL = "test_batcher_serves_real_sharded_model"


def _row(value):
    return None if value is None else np.asarray(value).tolist()


@contextlib.contextmanager
def traced():
    """Record what both packages' gateways decide: submits, steps, picks
    and autoscaler rounds, in the order they happen."""
    log = []
    saved = []

    def wrap(cls, name, record):
        orig = getattr(cls, name)

        def fn(self, *a, **kw):
            try:
                out = orig(self, *a, **kw)
            except Exception as e:
                log.append((name, type(e).__name__))
                raise
            log.append(record(self, out))
            return out
        saved.append((cls, name, orig))
        setattr(cls, name, fn)

    for pkg in (jax_gateway, gateway):
        wrap(pkg.ReplicaBatcher, "submit", lambda b, req: (
            "submit", b.model_name, req.tenant, req.arrival, b.depth))
        wrap(pkg.ReplicaBatcher, "step", lambda b, res: (
            "step", None if res is None else (
                res.batch, res.bucket, res.step_seconds,
                [(r.tenant, r.arrival, r.completed_at, r.done, r.shed,
                  _row(r.result)) for r in res.requests]),
            b.batch, b.step_ewma, b.recompiles))
        wrap(pkg.Router, "pick", lambda r, rep: (
            "pick", None if rep is None else rep.name))
        wrap(pkg.Router, "drain_replica", lambda r, out: ("drain", out))
        wrap(pkg.Autoscaler, "poll_once", lambda a, actions: (
            "poll", actions, len(a.replicas), a.grows, a.shrinks,
            a.last_p99))
    try:
        yield log
    finally:
        for cls, name, orig in saved:
            setattr(cls, name, orig)


def cases():
    mod = importlib.import_module(MODULE)
    return sorted(n for n in dir(mod)
                  if n.startswith("test_") and n != REAL_MODEL)


@pytest.mark.parametrize("test", cases())
def test_gateway_case_matches_the_reference(test, tmp_path):
    with traced() as jax_log:
        run_reference_test(MODULE, test, False, tmp_path / "jax")
    with traced() as port_log:
        run_reference_test(MODULE, test, True, tmp_path / "port")
    assert jax_log, "the case drove no gateway call"
    assert port_log == jax_log


def test_every_case_is_driven():
    """Every case of tests/test_gateway.py is above or is the real-model
    case below."""
    mod = importlib.import_module(MODULE)
    every = {n for n in dir(mod) if n.startswith("test_")}
    assert every == set(cases()) | {REAL_MODEL}
    assert len(cases()) >= 18


def test_batcher_over_the_real_model_matches_the_reference():
    """tests/test_gateway.py's real-model case on both packages: the same
    three rows through each batcher, one step, each request's result row
    against the JAX batcher's and against the model's own padded forward,
    on weights carried from JAX's ``_full_params()``."""
    jm = jax_serving.ShardedServingModel(dim=8, hidden=16, classes=4)
    params = convert.serving_params_from_jax(
        *[np.asarray(a) for a in jm._full_params()])
    jm.setup()
    # the JAX model splits its batch over the eight virtual CPU devices
    # of tests/conftest.py: the port's over eight CPU devices alike
    pm = serving.ShardedServingModel(dim=8, hidden=16, classes=4,
                                     device=["cpu"] * 8)
    pm.setup(params=params)
    rng = np.random.RandomState(0)
    rows = [rng.randn(8).astype(np.float32) for _ in range(3)]
    results = []
    for pkg, model in ((jax_gateway, jm), (gateway, pm)):
        b = pkg.ReplicaBatcher(model, batch_min=1, batch_max=8,
                               queue_cap=16, slo_s=1.0)
        b.batch = 8
        reqs = [b.submit("t", row, now=0.0) for row in rows]
        res = b.step(now=0.0)
        pad = [np.zeros(8, np.float32)] * (b._bucket_of(3) - 3)
        solo = np.asarray(model.infer(np.stack(rows + pad)))
        for i, req in enumerate(reqs):
            assert req.done
            np.testing.assert_allclose(np.asarray(req.result), solo[i],
                                       rtol=1e-5)
        results.append(([np.asarray(r.result) for r in reqs],
                        (res.batch, res.bucket, b.recompiles)))
    (jrows, jmeta), (prows, pmeta) = results
    assert pmeta == jmeta == (3, 8, 1)
    assert isinstance(prows[0], np.ndarray)
    np.testing.assert_allclose(np.stack(prows), np.stack(jrows), rtol=1e-5,
                               atol=1e-7)
    jm.close()
    pm.close()


def test_one_step_copies_the_output_to_the_host_once(monkeypatch):
    """The port's step hands the model one batch tensor on the model's
    device and reads its output back with one copy, not one per row."""
    import torch

    copies = []
    cpu = torch.Tensor.cpu

    def counted(self, *a, **kw):
        copies.append(tuple(self.shape))
        return cpu(self, *a, **kw)

    class Model:
        device = torch.device("cpu")
        stats = serving.ServingStats()

        def infer(self, x):
            assert torch.is_tensor(x) and x.device == self.device
            self.stats.record_step(0.001)
            return x * 2

    b = gateway.ReplicaBatcher(Model(), batch_min=1, batch_max=8,
                               queue_cap=16, slo_s=1.0)
    b.batch = 8
    reqs = [b.submit("t", np.full(4, float(i), np.float32), now=0.0)
            for i in range(5)]
    monkeypatch.setattr(torch.Tensor, "cpu", counted)
    res = b.step(now=0.0)
    monkeypatch.undo()
    assert copies == [(8, 4)] and (res.batch, res.bucket) == (5, 8)
    for i, req in enumerate(reqs):
        assert isinstance(req.result, np.ndarray)
        np.testing.assert_array_equal(req.result, np.full(4, 2.0 * i))


def test_serve_ladder_smoke_equals_the_reference():
    port = serve_ladder.run_serve_ladder(rates=serve_ladder.SMOKE_RATES,
                                         duration_s=2.0)
    ref = jax_bench.run_serve_ladder(rates=jax_bench.SMOKE_RATES,
                                     duration_s=2.0)
    assert port == ref
    assert port["speedup_vs_unbatched"] >= serve_ladder.SERVE_SPEEDUP_FLOOR
    assert serve_ladder.SERVE_SPEEDUP_FLOOR == jax_bench.SERVE_SPEEDUP_FLOOR
    assert port["steady_recompiles"] == 0


def test_serve_diurnal_day_equals_the_reference():
    kw = dict(period_s=60.0, trough_qps=50.0, peak_qps=1200.0,
              autoscale_s=2.0)
    port = serve_ladder.run_diurnal_case(**kw)
    assert port == jax_bench.run_diurnal_case(**kw)
    assert port["slo_held"] and port["shed_within_budget"]
    assert port["tracked_demand"]


def test_sim_model_and_one_rung_equal_the_reference():
    for batched in (False, True):
        assert serve_ladder.one_rung(400, 1.0, 0.05, batched) == \
            jax_bench.one_rung(400, 1.0, 0.05, batched)
    m, jm = serve_ladder.SimModel(per_row_s=0.001, compile_s=0.1), \
        jax_bench.SimModel(per_row_s=0.001, compile_s=0.1)
    for n in (8, 8, 4):
        m.infer([0.0] * n)
        jm.infer([0.0] * n)
        assert m.stats.last_step_seconds == jm.stats.last_step_seconds


def test_serve_ladder_cli_gates_and_writes_no_benchmark(tmp_path):
    """``python -m vtpu_torch.bench.serve_ladder --smoke --check`` exits
    0, prints the ladder and the day (equal to the functions' results),
    appends them to ``--out`` and writes nothing else."""
    out = tmp_path / "ladder.jsonl"
    proc = subprocess.run(
        [sys.executable, "-m", "vtpu_torch.bench.serve_ladder", "--smoke",
         "--check", "--out", str(out)],
        capture_output=True, text=True, timeout=300, cwd=tmp_path,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stderr
    lines = [json.loads(t) for t in proc.stdout.splitlines()]
    assert [d["metric"] for d in lines] == ["serve_ladder", "serve_diurnal"]
    assert lines[0] == serve_ladder.run_serve_ladder(
        rates=serve_ladder.SMOKE_RATES, duration_s=2.0)
    assert out.read_text().splitlines() == proc.stdout.splitlines()
    assert sorted(p.name for p in tmp_path.iterdir()) == ["ladder.jsonl"]


def test_autoscaler_is_gated_by_the_ports_ha_coordinator():
    """The autoscaler over each package's real HA pair on one in-memory
    apiserver: the standby observes nothing and mutates nothing, the
    leader grows the fleet under SLO pressure fenced by its lease's
    generation, and both packages decide alike."""
    from vtpu.ha import ClusterLease as JaxLease
    from vtpu.ha import HACoordinator as JaxCoordinator
    from vtpu.util.client import FakeKubeClient as JaxClient
    from vtpu_torch.ha import ClusterLease, HACoordinator
    from vtpu_torch.util.client import FakeKubeClient

    decisions = []
    for pkg, client_cls, lease_cls, coord_cls in (
            (jax_gateway, JaxClient, JaxLease, JaxCoordinator),
            (gateway, FakeKubeClient, ClusterLease, HACoordinator)):
        client = client_cls()
        leader, standby = (coord_cls(lease_cls(client, identity=who))
                           for who in ("a", "b"))
        leader.poll_once()
        standby.poll_once()
        sim = jax_bench.SimModel if pkg is jax_gateway \
            else serve_ladder.SimModel
        out = []
        for ha in (standby, leader):
            rs = pkg.ReplicaSet("m")
            rs.add(pkg.Replica(name="r0", batcher=pkg.ReplicaBatcher(
                sim(), batch_min=1, batch_max=16, queue_cap=64,
                slo_s=0.05)))
            spawned = []

            def spawn(pkg=pkg, sim=sim, spawned=spawned):
                spawned.append(pkg.Replica(
                    name=f"auto{len(spawned)}",
                    batcher=pkg.ReplicaBatcher(sim())))
                return spawned[-1]

            a = pkg.Autoscaler(rs, spawn, lambda r: None, ha=ha,
                               fence=lambda ha=ha: ha.generation,
                               slo_s=0.05, min_replicas=1, max_replicas=4,
                               idle_rounds=2)
            rs.get("r0").batcher._latencies = [0.049] * 100
            out.append((ha.is_leader(), ha.generation > 0, a.poll_once(),
                        len(rs)))
        decisions.append(out)
    assert decisions[1] == decisions[0]
    assert decisions[1] == [(False, False, 0, 1), (True, True, 1, 2)]
