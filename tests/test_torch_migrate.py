"""Live migration on the port: the planner and the rebalancer held to the
JAX package's decisions, one move end to end on the mock ``libcuda.so.1``,
and the offload workload held to vtpu/models/offload.py.

1. Every scheduler-side test of tests/test_migrate.py (destination stamp
   and reservation, concurrent arrivals excluded, gang members never
   planned, the byte-exact cutover with the host axis at both ends, a
   refused drain's abort, the deadline, preempt-rescue and its fallbacks,
   ``fragment_value``'s ranking, the webhook's front door, the monitor's
   drain handshake) runs against both packages on the same inputs
   (tests/torch_sched_parity.py ``run_reference_test``): each holds the
   test's own assertions, and their records (every annotation written,
   fenced commits, replay counts) are equal. Its two workload tests fail
   in the JAX package on this tree (``_host_memory_space`` meets JAX's
   "Memory kind mismatch"); group 3 holds the port's model to them.
2. ``python -m vtpu_torch.scheduler.livemove`` on the mock driver: the
   port's scheduler with the planner and the rebalancer on, a device
   plugin and a node monitor (drain coordinator) per node, and
   MigratableModel pods under libvgpu.so started from Allocate responses:
   request, snapshot, ack, quiesce block, cutover, resume, release, the
   moved stream equal to the control's; then a snapshot refused by
   ``CUDA_HOST_MEMORY_LIMIT``, acked ``refused``, the move aborted.
3. The offload model against vtpu/models/offload.py (the reference's
   ``_host_memory_space`` patched to None at run time, which gives its
   loss stream on this JAX): one step from identical numpy state within
   rtol 1e-5, a stream of 6 steps on the reference's own batches within
   rtol 1e-5; and the port's invariants: snapshot then resume reproduces
   the control's losses (rel 1e-6, abs 1e-7), a retracted drain
   un-drains with its charge released to the byte.
"""

from __future__ import annotations

import importlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.torch_sched_parity import run_reference_test
from vtpu_torch import api, native
from vtpu_torch.enforce.region import SharedRegion
from vtpu_torch.enforce.workload import (
    DRAIN_ACK_FILE,
    DRAIN_REQUEST_FILE,
    Enforcer,
    Quota,
)
from vtpu_torch.models import offload
from vtpu_torch.util.atomicio import atomic_write_json, read_json

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKLOAD_TESTS = {"test_migratable_model_resume_is_deterministic",
                  "test_model_undrains_when_request_retracted"}


def scheduler_tests():
    mod = importlib.import_module("tests.test_migrate")
    return [n for n in sorted(dir(mod)) if n.startswith("test_")
            and n not in WORKLOAD_TESTS and not {
                m.name for m in getattr(getattr(mod, n), "pytestmark", [])}
            & {"slow", "parametrize"}]


# ---------------------------------------------------------------------------
# 1. the planner and the rebalancer against the JAX package's decisions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("test", scheduler_tests())
def test_planner_matches_the_reference(test, tmp_path):
    jax = run_reference_test("tests.test_migrate", test, False,
                             tmp_path / "jax")
    port = run_reference_test("tests.test_migrate", test, True,
                              tmp_path / "port")
    assert port == jax


def test_every_planner_test_is_collected():
    assert len(scheduler_tests()) == 27


# ---------------------------------------------------------------------------
# 2. one move end to end on the mock driver
# ---------------------------------------------------------------------------

def _livemove(tmp_path, *argv):
    native.build_all()
    fixture = tmp_path / "cards.json"
    fixture.write_text(json.dumps({"gpus": [{
        "uuid": "GPU-00000000-0000-0000-0000-000000000000",
        "name": "NVIDIA H100 80GB HBM3", "memory_mb": 81559, "minor": 0}]}))
    procs = tmp_path / "procs"
    procs.mkdir()
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("CUDA_", "LD_PRELOAD", "MOCK_", "VGPU_"))}
    env.update({
        "PYTHONPATH": REPO, "TMPDIR": str(tmp_path),
        api.ENV_FAKE_NVML: str(fixture),
        "MOCK_NVML_FIXTURE": str(fixture), "MOCK_CUDA_TOTAL": "4g",
        "MOCK_GPU_PROCS": str(procs),
        api.ENV_LOCK_DIR: str(tmp_path / "locks"),
        "LD_LIBRARY_PATH": os.pathsep.join([
            native.mock_cuda_dir(),
            os.path.dirname(native.mock_nvml_library())]),
    })
    p = subprocess.run([sys.executable, "-m", "vtpu_torch.scheduler.livemove",
                        "--device", "cpu", *argv], env=env, cwd=str(tmp_path),
                       capture_output=True, text=True, timeout=240)
    assert p.stdout.strip(), p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert p.returncode == 0 and res["ok"], (res, p.stderr[-3000:])
    return res


def test_live_move_on_the_mock_driver(tmp_path):
    res = _livemove(tmp_path, "--dim", "16", "--layers", "32,16",
                    "--batch", "8")
    assert res["interposed"] is True
    # on the CPU the workload charges its state itself, exactly
    assert res["setup_growth"] == 1.0
    assert res["snapshot_growth_bytes"] == res["host_bytes"]
    assert res["release_bytes"] == res["host_bytes"]
    assert res["assigned_node"] == "127.0.0.3"
    b0, b1 = res["blocked_launches"]
    assert b0 == b1
    assert res["losses"]["moved"] == pytest.approx(
        res["losses"]["control"], rel=1e-6, abs=1e-7)
    for key in ("mark_to_stamp_s", "stamp_to_ack_s", "ack_to_cutover_s",
                "cutover_to_complete_s"):
        assert 0 <= res[key] < 60, (key, res)
    assert res["blackout_s"] >= 0


def test_refused_snapshot_aborts_the_move(tmp_path):
    """A 1 MiB host reservation holds the 595,980 B state but not a
    snapshot beside it: the snapshot is refused, acked ``refused``, the
    planner clears the stamp and the pod stays at the source, its ledger
    at the state alone."""
    res = _livemove(tmp_path, "--dim", "64", "--layers", "256,128",
                    "--batch", "8", "--host-limit-mib", "1", "--refuse")
    assert res["host_bytes"] == 595_980
    assert res["aborted"] and res["assigned_node"] == "127.0.0.2"
    assert res["refused_host_used"] == res["host_bytes"]


# ---------------------------------------------------------------------------
# 3. the offload workload against vtpu/models/offload.py
# ---------------------------------------------------------------------------

@pytest.fixture
def ref(monkeypatch):
    import vtpu.models.offload as jo

    monkeypatch.setattr(jo, "_host_memory_space", lambda device: None)
    return jo


def _jax_batches(seed, n, batch, dim):
    """The reference's batches: its split chain (offload.py:209-212)."""
    import jax
    import jax.numpy as jnp

    key, out = jax.random.PRNGKey(seed), []
    for _ in range(n):
        key, kx, ky = jax.random.split(key, 3)
        out.append((np.asarray(jax.random.normal(kx, (batch, dim),
                                                 jnp.float32)),
                    np.asarray(jax.random.normal(ky, (batch,),
                                                 jnp.float32))))
    return out


def _close(got, want, rtol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                               atol=1e-7)


def test_offload_step_matches_the_reference(ref):
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(11)
    jm = ref.OffloadModel(layers=(32, 16), dim=8, batch=4)
    jm.setup()
    sizes = (8, 32, 16, 1)
    state = [[{"w": rng.standard_normal((sizes[i], sizes[i + 1]),
                                        dtype=np.float32) * s,
               "b": rng.standard_normal(sizes[i + 1], dtype=np.float32) * s}
              for i in range(3)] for s in (0.1, 0.01, 0.001)]
    state[2] = [{k: np.abs(a) for k, a in layer.items()}
                for layer in state[2]]
    x = rng.standard_normal((4, 8), dtype=np.float32)
    y = rng.standard_normal(4, dtype=np.float32)
    jp, jmom, jv, jloss = jm._step_fn(
        *[jax.tree_util.tree_map(jnp.asarray, tree) for tree in state],
        jnp.asarray(x), jnp.asarray(y), jnp.float32(3))
    pp, pm, pv, ploss = offload.train_step(
        *[offload.params_from_jax(tree) for tree in state],
        torch.from_numpy(x), torch.from_numpy(y), 3.0)
    assert float(ploss) == pytest.approx(float(jloss), rel=1e-5)
    for got, want in ((pp, jp), (pm, jmom), (pv, jv)):
        for gl, wl in zip(got, want):
            for k in ("w", "b"):
                _close(gl[k], wl[k], 1e-5)


def test_offload_stream_matches_the_reference(ref):
    jm = ref.MigratableModel(layers=(32, 16), dim=8, batch=4)
    jm.setup()
    pm = offload.MigratableModel(layers=(32, 16), dim=8, batch=4,
                                 device="cpu")
    pm.setup()
    pm.load(offload.params_from_jax(
        [{k: np.asarray(a) for k, a in layer.items()}
         for layer in jm._params]))
    batches = iter(_jax_batches(1, 6, 4, 8))
    pm._batch = lambda gen: tuple(torch.from_numpy(a.copy())
                                  for a in next(batches))
    want = []
    for _ in range(6):
        jm.train(steps=1, seed=1)
        want.append(jm.stats.loss)
    pm.train(steps=6, seed=1)
    assert pm.losses == pytest.approx(want, rel=1e-5)
    assert pm.stats.host_bytes == 3 * 4 * (8 * 32 + 32 + 32 * 16 + 16 + 17)


def _mk_model(**kw):
    return offload.MigratableModel(layers=(8, 8), dim=4, batch=2,
                                   device="cpu", **kw)


def test_resume_reproduces_the_control():
    """tests/test_migrate.py:884-905 on the port: the loss stream after
    snapshot, then resume on a fresh model, equals the unmigrated
    control's."""
    control = _mk_model()
    control.train(steps=3, seed=7)
    control_losses = [control.train(steps=1).loss for _ in range(3)]
    source = _mk_model()
    source.train(steps=3, seed=7)
    blob = source.snapshot(gen=1)
    assert blob is not None and source.drained
    steps_before = source.stats.steps
    source.train(steps=2)
    assert source.stats.steps == steps_before
    dest = _mk_model()
    dest.resume(blob)
    resumed = [dest.train(steps=1).loss for _ in range(3)]
    assert resumed == pytest.approx(control_losses, rel=1e-6, abs=1e-7)
    for m in (control, source, dest):
        m.close()


def test_retracted_drain_undrains_byte_exactly(tmp_path):
    """tests/test_migrate.py:908-944 on the port, over a real region: the
    acked drain's request retracts without a cutover; the model un-drains,
    its snapshot charge released to the byte, and a re-planned move at a
    higher generation drains it again."""
    entry = tmp_path / "entry"
    entry.mkdir()
    cache = str(entry / api.CACHE_FILENAME)
    region = SharedRegion(cache)
    region.configure([1 << 30], [0])
    region.configure_host(1 << 20)
    region.attach()
    enf = Enforcer(Quota(cache_path=cache, host_limit=1 << 20), region)
    model = _mk_model(enforcer=enf)
    model.train(steps=2, seed=7)
    state = enf.host_used()
    assert state == model.stats.host_bytes
    atomic_write_json(str(entry / DRAIN_REQUEST_FILE),
                      {"gen": 5, "dest": "n2"})
    model.train(steps=2)
    assert model.drained and model.blob is not None
    assert enf.host_used() == 2 * state
    assert read_json(str(entry / DRAIN_ACK_FILE))["gen"] == 5
    steps = model.stats.steps
    os.unlink(str(entry / DRAIN_REQUEST_FILE))
    os.unlink(str(entry / DRAIN_ACK_FILE))
    stats = model.train(steps=2)
    assert not model.drained and model.blob is None
    assert enf.host_used() == state
    assert stats.steps == steps + 2
    atomic_write_json(str(entry / DRAIN_REQUEST_FILE),
                      {"gen": 6, "dest": "n3"})
    model.train(steps=2)
    assert model.drained
    assert read_json(str(entry / DRAIN_ACK_FILE))["gen"] == 6
    model.close()
    assert enf.host_used() == 0
    enf.stop()


def test_offload_imports_neither_jax_nor_vtpu():
    code = ("import json, sys, vtpu_torch.models.offload; "
            "print(json.dumps(sorted(m for m in sys.modules if "
            "m.split('.')[0] in ('jax', 'vtpu'))))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout) == []


def test_offload_runs_on_the_card_unless_told_otherwise():
    """No fallback: the default device is the card; without one the
    model's setup fails rather than running on the CPU."""
    model = offload.OffloadModel(layers=(8,), dim=4, batch=2)
    assert model.device.type == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            model.setup()
