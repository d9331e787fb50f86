"""The bench harness (vtpu_torch.bench) held to the JAX package's bench.py
on the CPU.

- The matrix file's helpers (``_merge_cases``, ``_ratio_map``,
  ``_publishable``) give bench.py's output on the same inputs: the cases
  of tests/test_bench.py, errors and partial reruns.
- ``CaseRunner.result`` gives bench.py's dict key for key from the same
  rates, step times, FLOPs, parameter count and peak, the MFU's ``None``
  rules included.
- The FLOP count of case 3.1 (VGG-16 at batch 2, 224x224) against XLA's
  cost analysis of the reference's step.
- The children's wiring: the quota bench.py's ``parse_size`` gives, the
  port's preload, region file and priority names.
- The ``--serve`` protocol and ``run_interleaved`` on the mock backend
  (the models on the CPU, the shim child under libvgpu.so over the mock
  libcuda.so.1); without a card and without the mock, the entry point
  fails.
"""

import importlib.util
import os
import types
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import pytest
import torch

from vtpu.models import BENCH_CASES as JAX_CASES
from vtpu.models import get_model as jax_get_model
from vtpu.models.train import init_model as jax_init_model
from vtpu.models.train import make_infer_step as jax_make_infer_step
from vtpu.util import parse_size
from vtpu_torch import api, native
from vtpu_torch.bench import matrix, runner, serve, wiring
from vtpu_torch.bench.__main__ import main
from vtpu_torch.models import BENCH_CASES

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "bench_ref", os.path.join(REPO, "bench.py"))
bench = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(bench)
# bench.py's _publishable is local to its main(): the same code object, as
# a function over bench.py's globals
_ref_publishable = types.FunctionType(
    next(c for c in bench.main.__code__.co_consts
         if getattr(c, "co_name", "") == "_publishable"), bench.__dict__)

CASES = {c.case: c for c in BENCH_CASES}
REF_CASES = {c.case: c for c in JAX_CASES}


def _res(case, tput, full=True, err=None):
    r = {"case": case, "throughput": tput, "full_case": full}
    if err:
        r["error"] = err
        r.pop("throughput")
    return r


MERGES = {
    # tests/test_bench.py's
    "replaces_only_rerun": ([_res("1.1", 100.0), _res("2.1", 50.0),
                             _res("5.2", 7.0)], [_res("2.1", 80.0)]),
    "from_empty": ([], [_res("1.1", 10.0)]),
    "rerun_errors": ([_res("1.1", 100.0), _res("3.1", 9.0)],
                     [_res("3.1", 0, err="boom")]),
    "error_replaced": ([_res("4.1", 0, err="oom"), _res("1.2", 3.0)],
                       [_res("4.1", 12.5), _res("5.1", 2.0)]),
    "junk_in_file": (["garbage", _res("2.2", 1.0)], [_res("1.1", 2.0)]),
}
RATIOS = {
    "pairs_and_skips_errors": ([_res("1.1", 100.0), _res("2.1", 50.0),
                                _res("3.1", 0, err="boom")],
                               [_res("1.1", 97.0), _res("3.1", 40.0)]),
    "zero_native": ([_res("1.1", 0.0)], [_res("1.1", 5.0)]),
    "shim_error": ([_res("1.1", 100.0), _res("1.2", 20.0)],
                   [_res("1.1", 0, err="lost"), _res("1.2", 19.0)]),
    "partial_rerun": ([_res("2.2", 61.6), _res("1.1", 2000.0)],
                      [_res("1.1", 1990.0)]),
}
PUBLISHABLE = {
    "all_full": [_res("1.1", 1.0), _res("1.2", 2.0)],
    "one_smoke": [_res("1.1", 1.0), _res("1.2", 2.0, full=False)],
    "errors_only": [_res("1.1", 0, err="x")],
    "full_and_error": [_res("1.1", 1.0), _res("2.1", 0, err="x")],
    "empty": [],
    "smoke_only": [_res("1.1", 1.0, full=False)],
}


@pytest.mark.parametrize("name", MERGES)
def test_merge_cases_matches_bench(name):
    old, new = MERGES[name]
    assert matrix._merge_cases(old, new) == bench._merge_cases(old, new)


@pytest.mark.parametrize("name", RATIOS)
def test_ratio_map_matches_bench(name):
    nat, shm = RATIOS[name]
    assert matrix._ratio_map(nat, shm) == bench._ratio_map(nat, shm)


@pytest.mark.parametrize("name", PUBLISHABLE)
def test_publishable_matches_bench(name):
    rs = PUBLISHABLE[name]
    assert matrix._publishable(rs) == _ref_publishable(rs)


def test_matrix_file_merges_partial_reruns(tmp_path):
    """A partial rerun merges into the saved file; a plain half unpairs
    it; the ratio column follows both halves."""
    path = str(tmp_path / "m.json")
    matrix.write_interleaved([_res("1.1", 100.0)], [_res("1.1", 98.0)],
                             run_all=True, path=path)
    matrix.write_interleaved([_res("2.1", 50.0)], [_res("2.1", 45.0)],
                             run_all=False, path=path)
    data = matrix._read(path)
    assert data["interleaved"] is True
    assert data["shim_native_ratio"] == {"1.1": 0.98, "2.1": 0.9}
    matrix.write_half([_res("1.1", 49.0)], "results", run_all=False,
                      path=path)
    data = matrix._read(path)
    assert "interleaved" not in data
    assert data["shim_native_ratio"] == {"1.1": 2.0, "2.1": 0.9}


# (case, batch, flops, n_params, peak, rates, step times)
RESULTS = {
    "resnet_mfu": ("1.1", 50, 8.7e11, 25_600_000, 989.4e12,
                   [2040.1, 2051.7, 2049.3, 2012.0], [24.4, 24.3, 24.4,
                                                       24.9]),
    "lstm_never": ("5.1", 100, 5e12, 3_000_000, 989.4e12, [300.0],
                   [333.3]),
    "below_floor": ("3.1", 20, 1e6, 138_357_544, 989.4e12, [5900.0, 5800.0],
                    [3.4, 3.5]),
    "no_flops": ("2.2", 10, 0.0, 60_000_000, 989.4e12, [70.0], [140.0]),
    "unknown_card": ("1.2", 20, 2.6e12, 25_600_000, 0.0, [250.0, 260.0],
                     [80.0, 77.0]),
    "smoke": ("4.1", 2, 4e11, 40_000_000, 756e12, [140.0], [14.0]),
}


@pytest.mark.parametrize("name", RESULTS)
def test_result_matches_bench(name, monkeypatch):
    cid, batch, flops, n_params, peak, rates, steps = RESULTS[name]
    monkeypatch.setattr(bench, "_peak_flops", lambda dev: peak)
    monkeypatch.setattr(runner, "_peak_flops", lambda dev: peak)
    ref = object.__new__(bench.CaseRunner)
    port = object.__new__(runner.CaseRunner)
    for obj, case in ((ref, REF_CASES[cid]), (port, CASES[cid])):
        obj.case, obj.batch, obj.iters = case, batch, 30
        obj.flops, obj.n_params = flops, n_params
    ref.dev = SimpleNamespace(device_kind="cpu", platform="cpu")
    port.dev = torch.device("cpu")
    want = bench.CaseRunner.result(ref, rates, steps, True)
    got = port.result(rates, steps, True)
    assert got == want
    assert list(got) == list(want)
    if name in ("resnet_mfu", "smoke"):
        assert 0 < got["mfu"] <= 1
    else:
        assert got["mfu"] is None


def test_peak_is_by_card_name():
    from vtpu_torch.bench import peak_flops
    assert peak_flops("NVIDIA H100 80GB HBM3") == 989.4e12
    assert peak_flops("NVIDIA H100 PCIe") == 756e12
    assert peak_flops("NVIDIA A100-SXM4-80GB") == 0.0
    assert peak_flops("cpu") == 0.0


# FlopCounterMode counts every convolution tap (the padding's too) and the
# dense layers, no elementwise op; XLA's cost analysis counts only the taps
# inside the image and adds the elementwise work (bias adds, ReLUs, pools).
# For VGG-16 at 224x224 the padding's taps are 3.23% of the count (from the
# layer shapes: 2,001,761,280 of 61,881,057,280 FLOPs at batch 2), the
# elementwise work under 1% the other way; measured here, the count is
# 2.45% above XLA's. 5% holds both and fails a count that misses a layer
# kind, the batch or the 2 of a multiply-add.
FLOP_TOLERANCE = 0.05


def test_flop_count_matches_xla_on_vgg16():
    case, ref_case = CASES["3.1"], REF_CASES["3.1"]
    port = runner.CaseRunner(case, torch.device("cpu"), quick=True)
    assert port.batch == 2 and port.tiny and port.iters == 3
    model = jax_get_model(ref_case.model, num_classes=ref_case.classes)
    x0 = jax.random.normal(jax.random.PRNGKey(0), (2,) + ref_case.shape,
                           jnp.float32)
    params, stats = jax_init_model(model, x0)
    step = jax.jit(jax_make_infer_step(model, has_batch_stats=bool(stats)))
    xla = bench._case_flops(step, params, stats, x0)
    assert xla > 0
    assert abs(port.flops / xla - 1) <= FLOP_TOLERANCE, (port.flops, xla)
    assert port.n_params == sum(
        p.size for p in jax.tree_util.tree_leaves(params))
    rate, step_ms = port.one_rep()
    assert rate > 0 and step_ms > 0


@pytest.mark.parametrize("quota", [None, "3g"])
def test_shim_env_matches_bench(tmp_path, monkeypatch, quota):
    if quota:
        monkeypatch.setenv(api.ENV_BENCH_QUOTA, quota)
    else:
        monkeypatch.delenv(api.ENV_BENCH_QUOTA, raising=False)
    monkeypatch.delenv(api.ENV_BENCH_BACKEND, raising=False)
    monkeypatch.delenv(api.ENV_PROFILE_SAMPLE, raising=False)
    ref = bench._shim_env(cache_dir=str(tmp_path / "ref"), profile=True)
    env = wiring._shim_env(str(tmp_path / "run"), profile=True)
    assert env[api.ENV_DEVICE_MEMORY_LIMIT] == \
        ref["TPU_DEVICE_MEMORY_LIMIT_0"] == str(parse_size(quota or "12g"))
    assert env["LD_PRELOAD"] == native.interposer()
    cache = env[api.ENV_SHARED_CACHE]
    assert cache == str(tmp_path / "run" / "containers" / "bench_0"
                        / api.CACHE_FILENAME)
    assert os.path.isdir(os.path.dirname(cache))
    assert env[api.ENV_TASK_PRIORITY] == ref["TPU_TASK_PRIORITY"] == "1"
    assert env[api.ENV_LOG_LEVEL] == ref["LIBVTPU_LOG_LEVEL"] == "1"
    for k in (api.ENV_BENCH_CHILD, api.ENV_PROFILE, api.ENV_PROFILE_SAMPLE):
        assert env[k] == ref[k] == "1"
    assert env[api.ENV_LOCK_DIR] == str(tmp_path / "run" / "locks")
    native_env = wiring._native_env(str(tmp_path / "run"))
    assert "LD_PRELOAD" not in native_env
    assert api.ENV_DEVICE_MEMORY_LIMIT not in native_env
    assert native_env[api.ENV_SHARED_CACHE] != cache
    assert api.ENV_PROFILE not in wiring._shim_env(str(tmp_path / "b"))


def test_no_card_and_no_mock_fails(monkeypatch, capsys):
    """The default backend runs on the card, never silently on the CPU."""
    monkeypatch.delenv(api.ENV_BENCH_BACKEND, raising=False)
    monkeypatch.delenv(api.ENV_BENCH_CHILD, raising=False)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default backend runs on it")
    assert main(["bench", "--quick"]) == 2
    assert "no CUDA device" in capsys.readouterr().err


@pytest.fixture
def mock_backend(monkeypatch, libs):
    monkeypatch.setenv(api.ENV_BENCH_BACKEND, "mock")
    monkeypatch.delenv(api.ENV_BENCH_QUOTA, raising=False)
    monkeypatch.delenv(api.ENV_BENCH_SHIM_FIRST, raising=False)


@pytest.fixture(scope="module")
def libs():
    return native.build_all()


def test_serve_protocol_on_the_mock_backend(tmp_path, mock_backend):
    """CASE gives ready, REP a rate, ENDCASE a result with bench.py's keys,
    an unknown command an error, QUIT bye. (The child runs under
    libvgpu.so, which a CPU model never calls: the interposer's side is in
    tests/test_torch_prof.py.)"""
    env = wiring._shim_env(str(tmp_path))
    child = serve._spawn_serve_child(True, env)
    try:
        assert serve._child_cmd(child, "CASE 3.1", 600) == {"ready": "3.1"}
        rep = serve._child_cmd(child, "REP", 600)
        assert rep["rate"] > 0 and rep["step_ms"] > 0
        res = serve._child_cmd(child, "ENDCASE", 600)["result"]
        ref = object.__new__(bench.CaseRunner)
        ref.case, ref.batch, ref.iters = REF_CASES["3.1"], 2, 3
        ref.flops, ref.n_params = res["flops_per_step"], 1
        ref.dev = SimpleNamespace(device_kind="cpu", platform="cpu")
        want = bench.CaseRunner.result(ref, [rep["rate"]], [rep["step_ms"]],
                                       False)
        assert list(res) == list(want)
        assert {k: res[k] for k in ("case", "batch", "full_case", "reps",
                                    "iters", "primed", "unit", "device")} \
            == {k: want[k] for k in ("case", "batch", "full_case", "reps",
                                     "iters", "primed", "unit", "device")}
        assert res["rates_per_rep"] == [round(rep["rate"], 2)]
        assert "error" in serve._child_cmd(child, "BOGUS", 60)
        assert serve._child_cmd(child, "QUIT", 60) == {"bye": 1}
        assert child.wait(timeout=60) == 0
    finally:
        serve._stop(child, alive=False)


def test_run_interleaved_on_the_mock_backend(mock_backend):
    """One case: a native result from this process, a shim result from the
    child, and their ratio."""
    nat, shm = serve.run_interleaved([CASES["1.1"]], torch.device("cpu"),
                                     quick=True, reps=4)
    assert [r["case"] for r in nat] == [r["case"] for r in shm] == ["1.1"]
    assert all("error" not in r and r["reps"] == 1 and not r["full_case"]
               for r in nat + shm)
    assert set(matrix._ratio_map(nat, shm)) == {"1.1"}
