"""The interleaved A/B protocol (bench.py:675-877).

A child runs ``--serve``: one command per stdin line (``CASE <id>``,
``REP``, ``ENDCASE``, ``QUIT``), one ``@@ {json}`` stdout line per reply.
Reps alternate native/shim within the same minutes-wide window, so load
drift on the card cannot masquerade as the interposer's cost; each case's
two setups coexist on the card (two contexts time-slice, and only one side
runs a rep at a time). Both sides set up at once (neither setup is timed)
and no rep starts before both are ready, so a setup never overlaps the
other side's timed reps.
"""

from __future__ import annotations

import json
import os
import queue
import shutil
import subprocess
import sys
import tempfile
import threading

from .. import api
from ..models import BENCH_CASES
from .runner import CaseRunner
from .wiring import _shim_env, child_cmd

# generous: a first step builds and loads every kernel, and a training rep
# at the published batch runs tens of seconds
SETUP_TIMEOUT_S = 1200.0
REP_TIMEOUT_S = 600.0


def _serve(device, quick: bool) -> None:
    """Child half of the interleaved protocol."""
    def reply(obj):
        sys.stdout.write("@@ " + json.dumps(obj) + "\n")
        sys.stdout.flush()

    runner = None
    rates, steps = [], []
    primed = False
    for line in sys.stdin:
        cmd = line.strip().split()
        if not cmd:
            continue
        try:
            if cmd[0] == "CASE":
                case = next(c for c in BENCH_CASES if c.case == cmd[1])
                runner = CaseRunner(case, device, quick)
                rates, steps = [], []
                primed = not runner.tiny
                if primed:
                    runner.one_rep()  # priming rep, discarded
                reply({"ready": cmd[1]})
            elif cmd[0] == "REP":
                rate, sms = runner.one_rep()
                rates.append(rate)
                steps.append(sms)
                reply({"rate": rate, "step_ms": sms})
            elif cmd[0] == "ENDCASE":
                res = runner.result(rates, steps, primed)
                runner = None
                reply({"result": res})
            elif cmd[0] == "QUIT":
                reply({"bye": 1})
                return
            else:
                reply({"error": f"unknown command {cmd[0]}"})
        except Exception as e:
            runner = None
            reply({"error": f"{type(e).__name__}: {e}"})


def _spawn_serve_child(quick: bool, env: dict) -> subprocess.Popen:
    args = ["--serve"] + (["--quick"] if quick else [])
    child = subprocess.Popen(child_cmd(*args), env=env,
                             stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                             text=True, bufsize=1)
    # a dedicated reader thread feeds a queue: select()-on-fd plus
    # buffered readline() would lose replies that arrive in the same pipe
    # chunk as a stray line (the reply sits in the text buffer while
    # select sees an empty fd)
    child._reply_q = queue.Queue()

    def _pump():
        for line in child.stdout:
            if line.startswith("@@ "):
                child._reply_q.put(line[3:])
            else:
                sys.stderr.write(line)  # stray output: pass it on
        child._reply_q.put(None)  # EOF

    threading.Thread(target=_pump, daemon=True).start()
    return child


def _send(child, cmd: str) -> bool:
    """Send one command; False when the child is gone."""
    try:
        child.stdin.write(cmd + "\n")
        child.stdin.flush()
    except (BrokenPipeError, OSError):
        return False
    return True


def _child_cmd(child, cmd: str, timeout: float):
    """Send one command, wait for its '@@' reply; None = child gone or
    silent past the timeout (the caller degrades to native-only)."""
    return _reply(child, timeout) if _send(child, cmd) else None


def _reply(child, timeout: float):
    """The child's next '@@' reply; None = child gone or silent past the
    timeout."""
    try:
        line = child._reply_q.get(timeout=timeout)
    except queue.Empty:
        return None
    if line is None:
        return None  # child EOF
    try:
        return json.loads(line)
    except json.JSONDecodeError:
        return None


def _stop(child, alive: bool = True) -> None:
    """QUIT (when the child still answers), then make sure it is gone."""
    if alive:
        _child_cmd(child, "QUIT", 30.0)
    try:
        child.terminate()
        child.wait(timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        child.kill()
        child.wait(timeout=30)


def _error(case, msg: str) -> dict:
    return {"case": case.case, "model": case.model, "mode": case.mode,
            "error": msg}


def run_interleaved(cases, device, quick: bool, reps: int):
    """(native_results, shim_results) with reps alternated A/B/A/B per
    case in the same window: the native half in this process, the shim
    half in a ``--serve`` child under libvgpu.so. A lost child is reported
    and the run goes on native-only."""
    run_dir = tempfile.mkdtemp(prefix="vgpu-bench-")
    child = _spawn_serve_child(quick, _shim_env(run_dir))
    native_results, shim_results = [], []
    child_alive = True
    try:
        for case in cases:
            shim_ready = False
            # the child sets up while this process does
            sent = child_alive and _send(child, f"CASE {case.case}")
            runner = None
            rates, steps = [], []
            primed = False
            try:
                runner = CaseRunner(case, device, quick)
                primed = not runner.tiny
                if primed:
                    runner.one_rep()  # priming rep, discarded
            except Exception as e:
                native_results.append(
                    _error(case, f"{type(e).__name__}: {e}"))
                runner = None
            if child_alive:
                msg = _reply(child, SETUP_TIMEOUT_S) if sent else None
                if msg is None:
                    child_alive = False
                    print(f"  [interleave] shim child lost at case "
                          f"{case.case}; continuing native-only",
                          file=sys.stderr)
                elif "error" in msg:
                    shim_results.append(_error(case, msg["error"]))
                else:
                    shim_ready = True
            n_reps = 1 if (runner is not None and runner.tiny) else reps
            # the order within each pair is swappable to expose order
            # effects (a systematically faster second slot would indict
            # the protocol, not the interposer)
            shim_first = os.environ.get(api.ENV_BENCH_SHIM_FIRST) == "1"

            def native_rep():
                nonlocal runner
                if runner is None:
                    return
                try:
                    rate, sms = runner.one_rep()
                    rates.append(rate)
                    steps.append(sms)
                except Exception as e:
                    native_results.append(
                        _error(case, f"{type(e).__name__}: {e}"))
                    runner = None

            def shim_rep():
                nonlocal child_alive, shim_ready
                if not shim_ready:
                    return
                msg = _child_cmd(child, "REP", REP_TIMEOUT_S)
                if msg is None:
                    child_alive = shim_ready = False
                    print("  [interleave] shim child lost mid-case; "
                          "continuing native-only", file=sys.stderr)
                elif "error" in msg:
                    shim_results.append(_error(case, msg["error"]))
                    shim_ready = False

            for _ in range(n_reps):
                for rep in ((shim_rep, native_rep) if shim_first
                            else (native_rep, shim_rep)):
                    rep()
            if runner is not None and rates:
                r = runner.result(rates, steps, primed)
                native_results.append(r)
                print(f"  [native] case {r['case']} {r['model']}/"
                      f"{r['mode']} b={r['batch']}: {r['throughput']} "
                      f"{r['unit']} reps {r['rates_per_rep']}",
                      file=sys.stderr)
            runner = None  # its tensors go before the next case's
            if shim_ready:
                msg = _child_cmd(child, "ENDCASE", REP_TIMEOUT_S)
                if msg and "result" in msg:
                    r = msg["result"]
                    shim_results.append(r)
                    print(f"  [shim]   case {r['case']} {r['model']}/"
                          f"{r['mode']} b={r['batch']}: {r['throughput']} "
                          f"{r['unit']} reps {r['rates_per_rep']}",
                          file=sys.stderr)
                elif msg is None:
                    child_alive = False
    finally:
        _stop(child, child_alive)
        shutil.rmtree(run_dir, ignore_errors=True)
    return native_results, shim_results
