"""``run_pods`` (northstar.py:492-747): launch N pods, sample their
regions, and grade each pod's leakage against a ground truth the pod's
own region cannot give.

At the hold barrier, once every pod finished its timed loop and holds its
state, the parent reads each region's charge (the shim's ledger), NVML's
process list (the second channel), and the headroom canary; then it
releases the pods one at a time and reads how far the card's used memory
drops at each exit: that pod's whole footprint (``card_drop_at_exit``).
Its estimated real peak is the region's peak plus what the drop shows the
region missed at the barrier, the reference's in-session-probe formula
(northstar.py:722-728), and its leakage is that peak past the quota.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from typing import Optional

from vtpu_torch import api, native
from vtpu_torch.enforce.region import FEEDBACK_BLOCK, RegionView

from . import HOLD_FILE, done_file, probe_hold_window_s, release_file
from .canary import Card, alloc_to_oom, canary_result

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
EXIT_WAIT_S = 60.0

CARD_DROP = "card_drop_at_exit"


class PodFailed(RuntimeError):
    """A pod exited before it reached its hold barrier: the run stops at
    once (the other pods would hold their state until the deadline)."""
SHIM_ONLY = "shim_region (card drop n/a)"


def _pod_env(backend: str, cache: str, lock_dir: str) -> dict:
    """The env ``Allocate`` gives a container (northstar.py:402): the
    interposer preloaded, the pod's region file, the run's lock directory;
    nothing of the caller's quota or preload leaks in."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("CUDA_DEVICE_", "CUDA_DISABLE", "CUDA_TASK_",
                                "GPU_CORE_", "LD_PRELOAD", "NS_",
                                "PYTORCH_CUDA_ALLOC_CONF"))}
    env.update({
        "LD_PRELOAD": native.interposer(),
        api.ENV_SHARED_CACHE: cache,
        api.ENV_LOCK_DIR: lock_dir,
        "PYTHONPATH": REPO,
        "NS_BACKEND": backend,
    })
    return env


def pod_leakage(quota: int, peak: int, held: Optional[int],
                drop: Optional[int]) -> dict:
    """One pod's leakage (northstar.py:683-731): the region's own view,
    and, where the card's drop at the pod's exit was read, the pod's real
    peak estimated from it, graded against the quota."""
    rec = {"peak_used_bytes": peak,
           "shim_leakage_pct": round(
               max(0, peak - quota) * 100.0 / quota, 3)}
    if drop is not None and held is not None:
        err = drop - held
        real_peak_est = peak + max(0, err)
        rec.update(card_drop_bytes=drop, accounting_error_bytes=err,
                   real_peak_est_bytes=real_peak_est,
                   leakage_pct=round(
                       max(0, real_peak_est - quota) * 100.0 / quota, 3),
                   leakage_source=CARD_DROP)
    else:
        rec.update(leakage_pct=rec["shim_leakage_pct"],
                   leakage_source=SHIM_ONLY)
    return rec


def _view_field(views, i, fn, default):
    """one field of pod i's region view, tolerating a pod's teardown"""
    try:
        return fn(views[f"pod{i}_0"]) if f"pod{i}_0" in views else default
    except (OSError, ValueError):
        return default


def _measure_at_barrier(card: Card, run_root: str, procs, region_paths,
                        canary: bool, oom_channel: bool) -> dict:
    """Everything read while the pods hold, then their releases one at a
    time with the card's drop at each exit."""
    out = {"held": [], "nvml": card.processes(), "drops": []}
    for path in region_paths:
        with RegionView(path) as v:
            out["held"].append(v.used(0))
    if canary:
        out["canary_mid"] = card.reading()
        if oom_channel:
            edge = alloc_to_oom()
            edge["vs_free_bytes"] = edge["allocated_bytes"] - \
                out["canary_mid"]["mem_get_info_free_bytes"]
            out["alloc_to_oom"] = edge
    for i, p in enumerate(procs):
        if p.poll() is not None:
            out["drops"].append(None)
            continue
        before = card.settled_used()
        with open(os.path.join(run_root, release_file(i)), "w") as f:
            f.write("1")
        try:
            p.wait(timeout=EXIT_WAIT_S)
        except subprocess.TimeoutExpired:
            out["drops"].append(None)
            continue
        out["drops"].append(before - card.settled_used())
    if canary:
        out["canary_post"] = card.reading()
    return out


def _fail_on_early_exit(run_root: str, procs: list, errs: list) -> None:
    """Raise PodFailed, naming the pod, its exit code and the end of its
    ``pod<i>.err``, when a pod exited without its ``pod<i>.done``; the
    caller's cleanup then releases the barrier and stops the others."""
    for i, p in enumerate(procs):
        if p.poll() is None or os.path.exists(
                os.path.join(run_root, done_file(i))):
            continue
        errs[i].flush()
        errs[i].seek(0)
        tail = errs[i].read()[-4000:]
        raise PodFailed(f"pod {i} exited with rc {p.returncode} before its "
                        f"barrier; its pod{i}.err:\n{tail}")


def run_pods(*, backend: str, card: Card, pods: int, seconds: float,
             quotas, case: str = "1.1", batch: int = 0,
             mode: str = "inference", ballast=None, cores=(),
             priorities=(), breach_last: bool = True, hold: bool = True,
             canary: bool = False, oom_channel: bool = False,
             stagger_s: float = 0.0, root: str, label: str = "run") -> dict:
    """Launch N pods and grade them; the core of every configuration.
    ``quotas``/``ballast``: per-pod bytes. With ``hold`` the pods keep their
    state after their timed loop until the parent has read the card's drop
    at each one's exit (without it, leakage falls back to the region's
    view). ``canary`` adds the headroom canary at the barrier and
    ``oom_channel`` its allocate-to-OOM second channel."""
    run_root = os.path.join(root, label)
    lock_dir = os.path.join(root, "locks")
    os.makedirs(run_root, exist_ok=True)
    os.makedirs(lock_dir, exist_ok=True)
    hold_flag = os.path.join(run_root, HOLD_FILE)
    if hold:
        with open(hold_flag, "w") as f:
            f.write("1")
    procs, region_paths, errs = [], [], []
    for pod in range(pods):
        cdir = os.path.join(run_root, "containers", f"pod{pod}_0")
        os.makedirs(cdir, exist_ok=True)
        cache = os.path.join(cdir, "vgpu.cache")
        region_paths.append(cache)
        env = _pod_env(backend, cache, lock_dir)
        env.update({
            "NS_POD": str(pod),
            "NS_START_DELAY": str(pod * stagger_s),
            "NS_SECONDS": str(seconds),
            "NS_CASE": case,
            "NS_MODE": mode,
            api.ENV_DEVICE_MEMORY_LIMIT + "_0": str(quotas[pod]),
            api.ENV_TASK_PRIORITY: str(priorities[pod]
                                       if pod < len(priorities) else 1),
        })
        if pod < len(cores) and cores[pod]:
            env[api.ENV_SM_LIMIT] = str(cores[pod])
            # a per-pod limit must bind even for a tenant alone
            env[api.ENV_CORE_UTILIZATION_POLICY] = \
                api.CORE_UTIL_POLICY_FORCE
        if batch:
            env["NS_BATCH"] = str(batch)
        if ballast and ballast[pod]:
            env["NS_BALLAST_BYTES"] = str(ballast[pod])
        if hold:
            env["NS_HOLD_DIR"] = run_root
            env["NS_HOLD_MAX"] = str(probe_hold_window_s(pods))
        if breach_last and pod == pods - 1:
            env["NS_TRY_BREACH"] = "1"
        errs.append(open(os.path.join(run_root, f"pod{pod}.err"), "w+"))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "vtpu_torch.northstar.pod"], env=env,
            cwd=run_root, stdout=subprocess.PIPE, stderr=errs[-1],
            text=True))

    # sample the regions while the pods run; with priorities, run the
    # monitor's feedback loop over them as the node monitor would
    fb = None
    if priorities:
        from vtpu_torch.monitor.feedback import FeedbackLoop
        fb = FeedbackLoop()
    last_fb, peak, timeline = 0.0, [0] * pods, []
    barrier: Optional[dict] = None
    t_start = time.time()
    deadline = t_start + seconds + (
        probe_hold_window_s(pods) if hold else 600)
    try:
        while any(p.poll() is None for p in procs):
            if time.time() > deadline:
                for p in procs:
                    p.kill()
                break
            views = {}
            try:
                for i, path in enumerate(region_paths):
                    try:
                        v = RegionView(path)
                    except (OSError, ValueError):
                        continue  # a region racing its pod's start
                    views[f"pod{i}_0"] = v
                    peak[i] = max(peak[i], v.used(0))
                if fb is not None and time.time() - last_fb >= 1.0:
                    fb.observe(views)
                    timeline.append({
                        "t": round(time.time() - t_start, 1),
                        "launches": [_view_field(
                            views, i, lambda v: v.total_launches(), 0)
                            for i in range(pods)],
                        "blocked": [_view_field(
                            views, i,
                            lambda v: v.recent_kernel == FEEDBACK_BLOCK,
                            False) for i in range(pods)]})
                    last_fb = time.time()
            finally:
                for v in views.values():
                    v.close()
            if hold and barrier is None:
                _fail_on_early_exit(run_root, procs, errs)
            if (hold and barrier is None and all(
                    os.path.exists(os.path.join(run_root, done_file(i)))
                    for i in range(pods))):
                # every pod idle at the barrier, its state resident: the
                # moment the ledger, NVML and the card measure one thing
                barrier = _measure_at_barrier(card, run_root, procs,
                                              region_paths, canary,
                                              oom_channel)
                for i, h in enumerate(barrier["held"]):
                    peak[i] = max(peak[i], h)
                os.unlink(hold_flag)
            time.sleep(0.25)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        if os.path.exists(hold_flag):
            os.unlink(hold_flag)

    listed = {pid: used for pid, used in (barrier or {}).get("nvml", [])}
    pods_out, ok = [], True
    for i, p in enumerate(procs):
        out, _ = p.communicate(timeout=EXIT_WAIT_S)
        rec = {"pod": i, "rc": p.returncode}
        try:
            rec.update(json.loads(out.strip().splitlines()[-1]))
        except (ValueError, IndexError):
            errs[i].seek(0)
            rec["stderr"] = errs[i].read()[-2000:]
            ok = False
        errs[i].close()
        rec["quota_bytes"] = quotas[i]
        if i < len(cores) and cores[i]:
            rec["core_limit_pct"] = cores[i]
        if i < len(priorities):
            rec["priority"] = priorities[i]
        held = barrier["held"][i] if barrier else None
        drop = barrier["drops"][i] if barrier else None
        rec["held_region_bytes"] = held
        rec.update(pod_leakage(quotas[i], peak[i], held, drop))
        # NVML's per-process count is a channel only where it lists the
        # pod under its own pid (a machine whose processes NVML reports as
        # one pid lists none of them)
        used = listed.get(rec.get("pid", p.pid))
        rec["nvml_used_bytes"] = used if used is not None and used >= 0 \
            else None
        rec["nvml_channel"] = "own pid" if rec["nvml_used_bytes"] is not None \
            else "unavailable: NVML does not list the pod's pid"
        pods_out.append(rec)

    res = {
        "pods": pods_out,
        "breach_probe_rejected": any(
            p.get("oom_probe_rejected", 0) > 0 for p in pods_out),
        "held_sample_bytes": barrier["held"] if barrier else None,
        "timeline": timeline,
        "ok": bool(ok and (barrier is not None or not hold)
                   and all(p["rc"] == 0 for p in pods_out)),
    }
    if barrier and canary:
        quota_sum = sum(quotas[:pods])
        res["headroom_canary"] = dict(
            canary_result(barrier["canary_mid"], barrier["canary_post"],
                          sum(barrier["held"]), quota_sum),
            canary_mid=barrier["canary_mid"],
            canary_post=barrier["canary_post"])
        if "alloc_to_oom" in barrier:
            res["headroom_canary"]["alloc_to_oom"] = barrier["alloc_to_oom"]
    return res

