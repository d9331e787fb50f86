"""The north-star harness's port (vtpu_torch.northstar) held to the JAX
package's northstar.py on the CPU: the same formulas on the same inputs,
the reference's run_pods and tight_main driven with fake pods (monkeypatched
process launches, region views and canaries) beside the port's, and the
port end to end on the mock libcuda.so.1 and mock NVML.

The reference grades a pod by its backend's per-session pool (pool capacity
less the headroom an in-session probe finds); the port by the card's drop
at the pod's exit. Fed the same real footprint, both must give the same
leakage."""

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

import pytest

from vtpu_torch import northstar as port
from vtpu_torch.northstar import canary as port_canary
from vtpu_torch.northstar import run as port_run
from vtpu_torch.northstar import tight as port_tight

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MiB = 1 << 20
GiB = 1 << 30


@pytest.fixture(scope="module")
def ref():
    """northstar.py imported as a module; its main never runs"""
    spec = importlib.util.spec_from_file_location(
        "northstar_reference", os.path.join(REPO, "northstar.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("pods", [1, 2, 4, 8, 16])
def test_probe_hold_window_matches_reference(ref, pods):
    assert port.probe_hold_window_s(pods) == ref.probe_hold_window_s(pods)


@pytest.mark.parametrize("v,mult", [(0, 64 * MiB), (1, 64 * MiB),
                                    (64 * MiB, 64 * MiB),
                                    (int(1.15 * 1_234_567_890), 64 * MiB),
                                    (3 * GiB + 1, 2 * MiB), (7, 3)])
def test_round_up_matches_reference(ref, v, mult):
    assert port._round_up(v, mult) == ref._round_up(v, mult)


@pytest.mark.parametrize("s", ["3g", "256m", "1.5G", "4096k", "123"])
def test_parse_size_matches_reference(ref, s):
    assert port.parse_size(s) == ref.parse_size(s)


# -------------------------------------------- the reference, with fakes

class _FakeView:
    """a region view whose charge is the pod's peak at its first reading
    and its barrier charge after (the pod index is in the region's path)"""
    ticks = {}
    values = {}

    def __init__(self, path):
        self.i = int(path.split("pod")[-1].split("_")[0])

    def used(self, dev=0):
        peak, held = self.values[self.i]
        n = self.ticks.get(self.i, 0)
        self.ticks[self.i] = n + 1
        return peak if n == 0 else held

    def close(self):
        pass


class _FakePopen:
    """a pod already at the barrier, which exits once the parent removes
    the hold flag (or after 40 polls, whatever the parent does)"""

    def __init__(self, args, env=None, **kw):
        self.env = env
        self.polls = 0
        self.returncode = None
        pod = int(env["NS_POD"])
        with open(os.path.join(env["NS_HOLD_DIR"], f"pod{pod}.done"),
                  "w") as f:
            f.write("1")

    def poll(self):
        self.polls += 1
        held = os.path.exists(os.path.join(self.env["NS_HOLD_DIR"], "hold"))
        if not held or self.polls > 40:
            self.returncode = 0
        return self.returncode

    def kill(self):
        self.returncode = -9

    def communicate(self):
        return json.dumps({"pod": int(self.env["NS_POD"]),
                           "oom_probe_rejected": 0}) + "\n", ""


# (quota, peak charge, barrier charge, real footprint at the barrier)
PODS = [
    (3 * GiB, 2_700_000_000, 2_600_000_000, 2_600_000_000),   # exact
    (3 * GiB, 2_700_000_000, 2_600_000_000, 2_700_000_000),   # under by 0.1 GB
    (3 * GiB, 3 * GiB, 3 * GiB - 100 * MiB, 3 * GiB + 20 * MiB),  # past it
    (1 * GiB, 900 * MiB, 800 * MiB, 700 * MiB),               # over-counted
    (1 * GiB, 1 * GiB, 1 * GiB, 1 * GiB + 300 * MiB),         # 29% leak
]


def test_leakage_arithmetic_matches_reference(ref, tmp_path, monkeypatch):
    """Five pods through the reference's run_pods (fake processes and
    regions; its in-session probe reports pool - real footprint) and the
    same numbers through the port's pod_leakage (the card's drop at exit
    = the real footprint): the same leakage and shim leakage, pod by pod,
    each graded by a source other than the region."""
    import vtpu.enforce.region as ref_region
    pool = 64 * GiB
    _FakeView.values = {i: (peak, held) for i, (_, peak, held, _) in
                        enumerate(PODS)}
    _FakeView.ticks = {}
    monkeypatch.setattr(ref_region, "RegionView", _FakeView)
    monkeypatch.setattr(ref.subprocess, "Popen", _FakePopen)
    monkeypatch.setattr(ref, "_run_headroom_probes", lambda *a: [
        {"headroom_bytes": pool - real, "resolution_bytes": 0,
         "reached_oom": True} for (_, _, _, real) in PODS])
    out = ref.run_pods(backend="mock", pods=len(PODS), seconds=0.0,
                       quotas=[q for q, _, _, _ in PODS],
                       headroom_probe=True, pool_bytes=pool,
                       breach_last=False, root=str(tmp_path), label="ref")
    assert out["held_sample_bytes"] == [h for _, _, h, _ in PODS]
    for rec, (quota, peak, held, real) in zip(out["pods"], PODS):
        mine = port_run.pod_leakage(quota, peak, held, real)
        assert rec["leakage_source"] == "in_session_oom_probe"
        assert mine["leakage_source"] == port_run.CARD_DROP
        assert rec["peak_used_bytes"] == mine["peak_used_bytes"] == peak
        assert rec["shim_leakage_pct"] == mine["shim_leakage_pct"]
        assert rec["leakage_pct"] == mine["leakage_pct"], (rec, mine)
        assert rec["probe_accounting_error_bytes"] == \
            mine["accounting_error_bytes"]
    # without a ground truth both fall back to the region's own view
    for quota, peak, held, _ in PODS:
        mine = port_run.pod_leakage(quota, peak, held, None)
        assert mine["leakage_pct"] == mine["shim_leakage_pct"]
        assert mine["leakage_source"] == port_run.SHIM_ONLY


# ------------------------------------------------ the tight verdict

def _args(**kw):
    base = dict(pods=4, seconds=6.0, quota="3g", case="1.1", batch=0,
                tight_margin=1.15, tight_train_case="1.2", hbm="16g",
                headroom_probe=False, out="")
    base.update(kw)
    return argparse.Namespace(**base)


# each scenario: what the fake pods report
BASE = dict(peak_inf=2_000_000_000, peak_tr=5_000_000_000,
            inf_leak=[0.0, 0.0, 0.0, 0.0], inf_loop_oom=[0, 0, 0, 0],
            breach=True, tr_leak=[0.0, 0.0], held=[2_100_000_000] * 4,
            canary_mid=6 * GiB, canary_post=6 * GiB + 8_400_000_000,
            over_holding=None, over_shim=0, over_rc=0)
SCENARIOS = {
    "met": {},
    "a_pod_leaks": {"inf_leak": [0.0, 2.5, 0.0, 0.0]},
    "loop_oom": {"inf_loop_oom": [0, 0, 1, 0]},
    "breach_not_refused": {"breach": False},
    "quota_not_binding": {"margin": 1.40},
    "training_leaks": {"tr_leak": [0.0, 3.0]},
    "canary_undercount": {"canary_post": 6 * GiB + 8_400_000_000
                          + 500_000_000},
    "canary_blind": {"canary_post": 6 * GiB + 100_000_000},
    "oversum_two_off": {"over_holding": 1},
    "oversum_shim_refused": {"over_shim": 1},
}


def _scenario(name):
    sc = dict(BASE)
    sc.update(SCENARIOS[name])
    return sc


def _fake_pods(sc, label, n, ballast):
    """what run_pods gives for configuration ``label`` (both harnesses)"""
    if label.startswith("cal_"):
        peak = sc["peak_inf"] if label == "cal_inf" else sc["peak_tr"]
        return {"ok": True, "pods": [{"rc": 0, "peak_used_bytes": peak}],
                "breach_probe_rejected": False}
    if label == "tight_inf":
        pods = [{"rc": 0, "leakage_pct": leak, "loop_oom_shim": oom,
                 "loop_oom_backend": 0,
                 "leakage_source": "in_session_oom_probe"}
                for leak, oom in zip(sc["inf_leak"], sc["inf_loop_oom"])]
        return {"ok": True, "pods": pods,
                "breach_probe_rejected": sc["breach"]}
    if label == "tight_train":
        return {"ok": True, "pods": [{"rc": 0, "leakage_pct": leak}
                                     for leak in sc["tr_leak"][:n]]
                + [{"rc": 0, "leakage_pct": 0.0}] * max(0, n - 2)}
    # oversum: the first `holding` pods hold their ballast
    holding = sc["over_holding"]
    pods = []
    for i in range(n):
        holds = holding is None or i < holding
        pods.append({"rc": sc["over_rc"],
                     "ballast_bytes_held": ballast if holds else 0,
                     "ballast_oom": "" if holds else
                     ("shim" if i < holding + sc["over_shim"] else
                      "backend")})
    if sc["over_shim"] and holding is None:
        pods[-1].update(ballast_bytes_held=0, ballast_oom="shim")
    return {"ok": True, "pods": pods, "breach_probe_rejected": False}


def _reference_tight(ref, sc, args, monkeypatch):
    calls = []

    def run_pods(**kw):
        label = kw["label"]
        calls.append(dict(kw))
        out = _fake_pods(sc, label, kw["pods"],
                         (kw.get("ballast") or [0])[0])
        if label == "tight_inf" and kw.get("during_hold"):
            out["hold_extra"] = kw["during_hold"](sc["held"])
        return out

    canaries = iter([{"allocated_bytes": sc["canary_mid"],
                      "resolution_bytes": 0}]
                    + [{"allocated_bytes": sc["canary_post"],
                        "resolution_bytes": 0}] * 3)
    finished = {}
    monkeypatch.setattr(ref, "run_pods", run_pods)
    monkeypatch.setattr(ref, "run_canary", lambda *a, **k: next(canaries))
    monkeypatch.setattr(ref.time, "sleep", lambda s: None)
    monkeypatch.setattr(ref, "_finish",
                        lambda a, result, met: finished.update(result))
    ref.tight_main(args, "libtpu", "")
    return finished, calls


class _Card:
    def total(self):
        return 16 * GiB


def _port_tight(sc, args, monkeypatch):
    calls = []

    def run_pods(**kw):
        label = kw["label"]
        calls.append(dict(kw))
        out = _fake_pods(sc, label, kw["pods"],
                         (kw.get("ballast") or [0])[0])
        if label == "tight_inf":
            for p in out["pods"]:
                p["leakage_source"] = port_run.CARD_DROP
            out["headroom_canary"] = port_canary.canary_result(
                {"mem_get_info_free_bytes": sc["canary_mid"],
                 "nvml_used_bytes": 0},
                {"mem_get_info_free_bytes": sc["canary_post"],
                 "nvml_used_bytes": 0},
                sum(sc["held"]), sum(kw["quotas"]))
        return out

    monkeypatch.setattr(port_tight, "run_pods", run_pods)
    return port_tight.tight_main(args, "cuda", _Card(), ""), calls


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_tight_verdict_matches_reference(ref, name, monkeypatch):
    """The reference's tight_main (on a backend with the canary) and the
    port's (on the card), each fed the same fake pods and canary: the
    same quotas, pod counts and ballast, the same verdict, part by part,
    and the same cross-check."""
    sc = _scenario(name)
    args = _args(tight_margin=sc.get("margin", 1.15))
    theirs, ref_calls = _reference_tight(ref, sc, args, monkeypatch)
    mine, port_calls = _port_tight(sc, args, monkeypatch)
    assert [c["label"] for c in ref_calls] == [c["label"] for c in
                                               port_calls]
    for a, b in zip(ref_calls, port_calls):
        for key in ("pods", "quotas", "case", "mode", "ballast",
                    "breach_last"):
            assert a.get(key) == b.get(key), (a["label"], key)
    for cfg in ("inference_tight", "training_tight", "oversum"):
        for key in ("quota_bytes_per_pod", "quota_over_peak", "pods_count",
                    "expected_pods_holding", "ballast_bytes_per_pod",
                    "pods_holding_ballast", "shim_oom_pods"):
            assert theirs["configs"][cfg].get(key) == \
                mine["configs"][cfg].get(key), (cfg, key)
    assert theirs["met_breakdown"] == mine["met_breakdown"]
    assert theirs["tight_met"] == mine["tight_met"]
    assert theirs["leakage_cross_checked"] == mine["leakage_cross_checked"]
    ref_canary = theirs["headroom_canary"]
    for key in ("true_combined_footprint_bytes", "accounting_error_bytes",
                "undercount_pct_of_quota", "discriminating"):
        assert ref_canary[key] == mine["headroom_canary"][key], key


# ------------------------------------------------------ end to end

def _clean_env(**extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("CUDA_", "LD_PRELOAD", "LD_LIBRARY_PATH",
                                "MOCK_", "VGPU_", "NS_"))}
    env.update(PYTHONPATH=REPO, **extra)
    return env


def test_mock_north_star_end_to_end(tmp_path):
    """python -m vtpu_torch.northstar --backend mock --pods 2 --quota 256m
    --seconds 2: both pods exit clean under libvgpu.so on the mock driver,
    the last pod's allocation past its quota is refused, each pod's leakage
    is graded by the mock card's drop at its exit and is under 2%, and the
    canary's count of the pods' footprint is the regions' to the page."""
    out = tmp_path / "ns.json"
    p = subprocess.run(
        [sys.executable, "-m", "vtpu_torch.northstar", "--backend", "mock",
         "--pods", "2", "--quota", "256m", "--seconds", "2", "--out",
         str(out)], env=_clean_env(), cwd=str(tmp_path),
        capture_output=True, text=True, timeout=60)
    assert p.returncode == 0, p.stderr[-2000:]
    d = json.loads(out.read_text())
    assert json.loads(p.stdout.strip().splitlines()[-1]) == d
    assert d["ok"] and d["breach_probe_rejected"]
    assert d["leakage_cross_checked"] is True
    assert [p["rc"] for p in d["pods"]] == [0, 0]
    for pod in d["pods"]:
        assert pod["leakage_source"] == "card_drop_at_exit", pod
        assert pod["leakage_pct"] < 2.0, pod
        assert pod["steps"] > 0 and pod["card_drop_bytes"] > 0, pod
        # where NVML lists the pod's own pid, its count is the second
        # channel, and agrees
        assert pod["nvml_used_bytes"] == pod["card_drop_bytes"], pod
    c = d["headroom_canary"]
    assert c["available"] and c["discriminating"]
    assert abs(c["accounting_error_bytes"]) < 4096, c
    assert c["true_combined_footprint_bytes"] == c["shim_accounted_bytes"]
    assert c["undercount_pct_of_quota"] < 2.0
    assert d["card"] == {"name": "mock", "power_limit": None}


def test_mock_north_star_with_cores_and_priorities(tmp_path):
    """--cores and --priorities on the mock: each pod gets its SM limit
    (under the force policy) and its priority, the parent runs the node
    monitor's feedback loop over their regions, and the per-second
    timeline of their launches is in the result (northstar.py:600-622)."""
    out = tmp_path / "ns.json"
    p = subprocess.run(
        [sys.executable, "-m", "vtpu_torch.northstar", "--backend", "mock",
         "--pods", "2", "--quota", "256m", "--seconds", "3", "--cores",
         "50,0", "--priorities", "0,1", "--out", str(out)],
        env=_clean_env(), cwd=str(tmp_path), capture_output=True, text=True,
        timeout=60)
    assert p.returncode == 0, p.stderr[-2000:]
    d = json.loads(out.read_text())
    assert [(q.get("core_limit_pct"), q["priority"]) for q in d["pods"]] \
        == [(50, 0), (None, 1)]
    assert len(d["timeline"]) >= 2
    first, last = d["timeline"][0], d["timeline"][-1]
    assert len(last["launches"]) == len(last["blocked"]) == 2
    assert last["launches"][0] > first["launches"][0]


def test_mock_tight_end_to_end(tmp_path):
    """--tight on the mock: the calibrated quota binds the inference pods,
    the breach is refused, the oversubscribed pods hold their ballast under
    their quotas, and tight_met holds (no training step and no canary on
    the mock, as in the reference)."""
    out = tmp_path / "tight.json"
    p = subprocess.run(
        [sys.executable, "-m", "vtpu_torch.northstar", "--backend", "mock",
         "--tight", "--pods", "2", "--quota", "256m", "--seconds", "2",
         "--out", str(out)], env=_clean_env(), cwd=str(tmp_path),
        capture_output=True, text=True, timeout=60)
    assert p.returncode == 0, p.stderr[-2000:] + p.stdout[-2000:]
    d = json.loads(out.read_text())
    assert d["tight_met"] is True, d["met_breakdown"]
    inf = d["configs"]["inference_tight"]
    assert inf["breach_probe_rejected"]
    assert all(p["leakage_source"] == "card_drop_at_exit" and
               p["leakage_pct"] < 2.0 for p in inf["pods"])
    assert inf["quota_bytes_per_pod"] % (64 * MiB) == 0
    assert "skipped" in d["configs"]["training_tight"]
    over = d["configs"]["oversum"]
    assert over["pods_holding_ballast"] == 2 and over["shim_oom_pods"] == 0


def test_no_card_and_no_mock_exits_nonzero(tmp_path):
    """With no card and no --backend mock the harness stops: it never falls
    back to the mock or the CPU, and writes no result. (No card is visible
    to it on a machine that has one either.)"""
    out = tmp_path / "ns.json"
    p = subprocess.run(
        [sys.executable, "-m", "vtpu_torch.northstar", "--seconds", "1",
         "--out", str(out)], env=_clean_env(CUDA_VISIBLE_DEVICES=""),
        cwd=str(tmp_path), capture_output=True, text=True, timeout=60)
    assert p.returncode != 0
    assert not out.exists()
    assert p.stdout.strip() == ""


# a parent whose pod 1 exits with code 3 at once, before its barrier
_DIES_BEFORE_BARRIER = r"""
import subprocess, sys
real = subprocess.Popen


class Popen(real):
    def __init__(self, args, env=None, **kw):
        if env is not None and env.get("NS_POD") == "1":
            args = [sys.executable, "-c", "import sys; sys.stderr.write("
                    "'pod one gave up\\n'); sys.exit(3)"]
        super().__init__(args, env=env, **kw)


subprocess.Popen = Popen
from vtpu_torch.northstar.__main__ import main
sys.exit(main(sys.argv[1:]))
"""


def test_a_pod_that_dies_before_its_barrier_fails_the_run_fast(tmp_path):
    """F10: pod 1 exits with rc 3 before its barrier while pod 0 runs a
    30 s loop. The parent fails within 30 s (not at its deadline, 900 s
    past the loop), names the pod, its rc and its pod1.err, stops pod 0
    and leaves no run directory behind."""
    run_tmp = tmp_path / "tmp"
    run_tmp.mkdir()
    out = tmp_path / "ns.json"
    t0 = time.monotonic()
    p = subprocess.run(
        [sys.executable, "-c", _DIES_BEFORE_BARRIER, "--backend", "mock",
         "--pods", "2", "--quota", "256m", "--seconds", "30", "--out",
         str(out)], env=_clean_env(TMPDIR=str(run_tmp)), cwd=str(tmp_path),
        capture_output=True, text=True, timeout=120)
    took = time.monotonic() - t0
    assert p.returncode == 1, p.stderr[-2000:]
    assert took < 30, took
    assert "pod 1 exited with rc 3 before its barrier" in p.stderr
    assert "pod one gave up" in p.stderr
    assert not out.exists()
    assert list(run_tmp.iterdir()) == []
