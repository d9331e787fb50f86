"""Workload-side quota plumbing: what runs inside a quota-limited container.

The port of vtpu/enforce/workload.py:61-280. The enforcing is done by the
interposer libvgpu.so (vtpu_torch/csrc/libvgpu.c), LD_PRELOADed by the
device plugin (``/etc/ld.so.preload`` or ``LD_PRELOAD``): every device
allocation is charged against the shared region before the driver makes it,
with no cooperation from the workload. This module is the thin cooperative
layer on top:

- :func:`quota_from_env` — parse the Allocate env (vtpu_torch/api) the way
  the interposer's load_config does.
- :func:`install` — attach this process to the shared region and heartbeat
  it. Unlike the TPU side, which rewrites TPU_LIBRARY_PATH before jax loads
  the plugin (workload.py:298-305), it cannot inject the interposer: a CUDA
  process resolves the driver at its first CUDA call, so the library must
  be preloaded when the process starts. install() says so when it is not.
- :class:`Enforcer` — usage/limit/headroom introspection, the v8 host
  ledger and the workload's half of the live-migration drain handshake
  (workload.py:191-269): the node monitor's drain coordinator
  (vtpu_torch/monitor/migrate.py) writes the request sidecar beside the
  container's region file, the workload acks it.
"""

from __future__ import annotations

import ctypes
import logging
import os
import threading
from dataclasses import dataclass, field
from typing import List, Optional

from .. import api
from ..util.atomicio import atomic_write_json, read_json
from .region import (
    SharedRegion,
    UTIL_POLICY_DEFAULT,
    UTIL_POLICY_DISABLE,
    UTIL_POLICY_FORCE,
)

log = logging.getLogger("vtpu_torch.enforce")

HEARTBEAT_INTERVAL_S = 5.0

# the drain handshake's two sidecar files beside the container's region
# file (names declared in vtpu_torch/api): the monitor atomically writes the
# request ({"gen", "dest", "deadline"}), the workload polls it between steps
# and atomically writes the ack ({"gen", "phase", "host_bytes"}). Both sides
# exchange only complete files, so a kill on either side at any boundary
# replays from durable state.
DRAIN_REQUEST_FILE = api.DRAIN_REQUEST_FILE
DRAIN_ACK_FILE = api.DRAIN_ACK_FILE
#: ack phases, in protocol order
DRAIN_PHASE_SNAPSHOTTED = "snapshotted"
DRAIN_PHASE_REFUSED = "refused"
DRAIN_PHASE_RESUMED = "resumed"


def parse_bytes(s: str) -> int:
    """'3g' / '512m' / '1024' → bytes (the interposer's parse_bytes)."""
    s = (s or "").strip()
    if not s:
        return 0
    mul = 1
    if s[-1] in "kK":
        mul, s = 1 << 10, s[:-1]
    elif s[-1] in "mM":
        mul, s = 1 << 20, s[:-1]
    elif s[-1] in "gG":
        mul, s = 1 << 30, s[:-1]
    try:
        return int(float(s) * mul)
    except ValueError:
        return 0


@dataclass
class Quota:
    hbm_limits: List[int] = field(default_factory=list)  # bytes per device
    core_limit: int = 0          # SM percent, 0 = unlimited
    host_limit: int = 0          # host-memory bytes, 0 = unlimited
    cache_path: str = ""
    priority: int = 1
    util_policy: int = UTIL_POLICY_DEFAULT
    disabled: bool = False

    @property
    def enforced(self) -> bool:
        return bool(self.cache_path) and not self.disabled


def quota_from_env(env=None) -> Quota:
    env = env if env is not None else os.environ
    default = parse_bytes(env.get(api.ENV_DEVICE_MEMORY_LIMIT, ""))
    # scan all indices and fill gaps with the default, exactly like the
    # interposer's load_config: both consumers of the env contract must
    # agree on the device count and per-device limits
    limits = []
    last_present = -1
    for i in range(16):
        per = env.get(f"{api.ENV_DEVICE_MEMORY_LIMIT}_{i}")
        limits.append(parse_bytes(per) if per is not None else default)
        if per is not None:
            last_present = i
    limits = limits[:last_present + 1]
    if not limits and default:
        limits = [default]
    policy = {
        api.CORE_UTIL_POLICY_FORCE: UTIL_POLICY_FORCE,
        api.CORE_UTIL_POLICY_DISABLE: UTIL_POLICY_DISABLE,
    }.get(env.get(api.ENV_CORE_UTILIZATION_POLICY, ""), UTIL_POLICY_DEFAULT)
    return Quota(
        hbm_limits=limits,
        core_limit=int(env.get(api.ENV_SM_LIMIT, "0") or 0),
        host_limit=parse_bytes(env.get(api.ENV_HOST_MEMORY_LIMIT, "")),
        cache_path=env.get(api.ENV_SHARED_CACHE, ""),
        priority=int(env.get(api.ENV_TASK_PRIORITY, "1") or 1),
        util_policy=policy,
        disabled=api.ENV_DISABLE_CONTROL in env,
    )


def interposer_active() -> bool:
    """True when libvgpu.so is loaded in this process and enforcing."""
    fn = getattr(ctypes.CDLL(None), "vgpu_interposer_active", None)
    if fn is None:
        return False
    fn.restype = ctypes.c_int
    fn.argtypes = []
    return bool(fn())


class Enforcer:
    def __init__(self, quota: Quota, region: Optional[SharedRegion],
                 interposed: bool = False):
        self.quota = quota
        self.region = region
        #: libvgpu.so enforces this process's allocations
        self.interposed = interposed
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start_heartbeat(self,
                        interval_s: float = HEARTBEAT_INTERVAL_S) -> None:
        if self.region is None or self._thread is not None:
            return
        region = self.region  # local ref: stop() nulls self.region

        def beat():
            while not self._stop.wait(interval_s):
                region.heartbeat()
                # slot GC runs here, inside the container's pid namespace
                region.gc()

        self._thread = threading.Thread(target=beat, daemon=True,
                                        name="vgpu-heartbeat")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2 * HEARTBEAT_INTERVAL_S)
            self._thread = None
        if self.region is not None:
            # under the interposer the slot holds the charges of live
            # allocations; the interposer detaches it at process exit
            if not self.interposed:
                self.region.detach()
            self.region.close()
            self.region = None

    def flush_launches(self) -> None:
        """Have libvgpu.so charge the launches whose device work is done and
        publish its launch counts to the region now; it does so by itself
        every 100 ms and every 256 launches. For a reader of the region
        right after a synchronisation."""
        if self.interposed:
            ctypes.CDLL(None).vgpu_flush_launches()

    def footprint(self, dev: int = 0) -> dict:
        """libvgpu.so's device-footprint charge of this process on ``dev``
        (the memory the driver holds for it that no allocation call
        reached): how it was measured (``mode``: "unseen", "nvml_pid"
        re-read every 100 ms, "context" the card's growth across its
        context's creation and each function's first launch, "none"),
        NVML's pid of the process, the bytes charged, the re-reads' count,
        total and longest ns, and in "context" mode the card's growth
        across the creation, the node's context size it was held to (0: none
        on record), and the calls measured in that mode (first launches,
        module loads, first look-ups): their count, the bytes the card grew
        by at a function's load before its first launch and across the
        calls, the readings the card shrank in, their total and longest ns;
        and the driver objects measured there (streams, allocations that
        are not whole 2 MiB pages): their calls, the card's net growth
        across the allocations and across the streams, the small
        allocations' bytes live and the footprint's charge for the pages
        past them. Zeros without the interposer."""
        out = (ctypes.c_uint64 * 8)()
        fn = getattr(ctypes.CDLL(None), "vgpu_footprint", None) \
            if self.interposed else None
        if fn is not None:
            fn.restype = None
            fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
            fn(dev, out)
        mode = {2: "nvml_pid", 3: "context", 4: "none"}.get(int(out[0]),
                                                            "unseen")
        first = (ctypes.c_uint64 * 6)()
        fn = getattr(ctypes.CDLL(None), "vgpu_footprint_launches", None) \
            if self.interposed else None
        if fn is not None:
            fn.restype = None
            fn.argtypes = [ctypes.c_void_p]
            fn(first)
        objs = (ctypes.c_uint64 * 5)()
        fn = getattr(ctypes.CDLL(None), "vgpu_objects", None) \
            if self.interposed else None
        if fn is not None:
            fn.restype = None
            fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
            fn(dev, objs)
        signed = [int(v) - (1 << 64) if v >= 1 << 63 else int(v)
                  for v in objs]
        return {"mode": mode, "nvml_pid": int(out[1]), "bytes": int(out[2]),
                "reads": int(out[3]), "read_ns": int(out[4]),
                "read_max_ns": int(out[5]), "growth": int(out[6]),
                "node_context": int(out[7]),
                "calls_measured": int(first[0]),
                "load_bytes": int(first[1]), "call_bytes": int(first[2]),
                "shrank": int(first[3]), "measure_ns": int(first[4]),
                "measure_max_ns": int(first[5]),
                "object_calls": signed[0], "small_alloc_pages": signed[1],
                "stream_pages": signed[2], "small_alloc_live": signed[3],
                "page_charge": signed[4]}

    def kernel_keys(self) -> dict:
        """How libvgpu.so keyed the kernels it charged on a limited device:
        charges by an argument key seen before, by a new one (charged its
        shape's least time), by the shape's key alone, past a full shape
        table (as measured), the functions with and without an argument
        layout, and the argument words left out of their function's key
        (they vary without changing its time). Zeros without the
        interposer."""
        out = (ctypes.c_uint64 * 7)()
        fn = getattr(ctypes.CDLL(None), "vgpu_kernel_keys", None) \
            if self.interposed else None
        if fn is not None:
            fn.restype = None
            fn.argtypes = [ctypes.c_void_p]
            fn(out)
        names = ("seen", "new", "shape_only", "table_full", "layouts",
                 "no_layout", "left_out")
        return dict(zip(names, (int(v) for v in out)))

    def span_busy(self) -> dict:
        """libvgpu.so's sampled spans (one in each 32, at a random place,
        on a card with no SM limit): how many were measured and the recent ones' busy fraction,
        by which every span's charge is scaled. Zeros without the
        interposer."""
        out = (ctypes.c_uint64 * 2)()
        fn = getattr(ctypes.CDLL(None), "vgpu_span_busy", None) \
            if self.interposed else None
        if fn is not None:
            fn.restype = None
            fn.argtypes = [ctypes.c_void_p]
            fn(out)
        return {"samples": int(out[0]), "busy_fraction": out[1] / 1e6}

    def used(self, dev: int = 0) -> int:
        return self.region.used(dev) if self.region else 0

    def limit(self, dev: int = 0) -> int:
        if dev < len(self.quota.hbm_limits):
            return self.quota.hbm_limits[dev]
        return 0

    def headroom(self, dev: int = 0) -> int:
        lim = self.limit(dev)
        return max(0, lim - self.used(dev)) if lim else 2 ** 63 - 1

    # -- cooperative host-memory accounting (v8 host ledger) --------------

    def host_charge(self, bytes_: int) -> bool:
        """Reserve ``bytes_`` of the pod's host-memory quota; False when the
        charge would breach it (the caller sheds cleanly)."""
        if self.region is None or bytes_ <= 0:
            return True
        return self.region.host_try_alloc(bytes_)

    def host_release(self, bytes_: int) -> None:
        if self.region is not None and bytes_ > 0:
            self.region.host_free(bytes_)

    def host_used(self) -> int:
        return self.region.host_used() if self.region else 0

    def host_limit(self) -> int:
        return self.quota.host_limit

    # -- cooperative drain handshake (live migration) ----------------------
    # Poll drain_requested() between steps; on a non-zero generation,
    # snapshot into host_charge-accounted memory and drain_ack(gen,
    # DRAIN_PHASE_SNAPSHOTTED, bytes), or DRAIN_PHASE_REFUSED when the
    # ledger refuses the snapshot's charge (the scheduler then falls back to
    # preemption).

    def _entry_dir(self) -> str:
        return os.path.dirname(self.quota.cache_path) \
            if self.quota.cache_path else ""

    def _request(self) -> Optional[dict]:
        d = self._entry_dir()
        if not d:
            return None
        req = read_json(os.path.join(d, DRAIN_REQUEST_FILE))
        return req if isinstance(req, dict) else None

    def drain_requested(self) -> int:
        """Generation of the pending drain request, 0 when none; one
        already acked (any phase) is no longer pending."""
        req = self._request()
        if req is None:
            return 0
        try:
            gen = int(req.get("gen", 0))
        except (TypeError, ValueError):
            return 0
        if gen <= 0:
            return 0
        ack = read_json(os.path.join(self._entry_dir(), DRAIN_ACK_FILE))
        if isinstance(ack, dict):
            try:
                if int(ack.get("gen", 0)) >= gen:
                    return 0
            except (TypeError, ValueError):
                pass
        return gen

    def drain_deadline(self) -> float:
        """Absolute epoch-seconds deadline of the pending request, 0.0 when
        none was stamped."""
        req = self._request()
        if req is None:
            return 0.0
        try:
            return float(req.get("deadline", 0.0))
        except (TypeError, ValueError):
            return 0.0

    def drain_retracted(self, gen: int) -> bool:
        """True when drain generation ``gen``, requested and acked by this
        workload, is no longer what the request asks for: the monitor
        retracted the move (the sidecar is gone) or superseded it. A
        drained workload may then release its snapshot and resume."""
        if not self._entry_dir() or gen <= 0:
            return False
        req = self._request()
        if req is None:
            return True
        try:
            return int(req.get("gen", 0)) != int(gen)
        except (TypeError, ValueError):
            return True

    def drain_ack(self, gen: int, phase: str, host_bytes: int = 0) -> None:
        """Durably acknowledge drain generation ``gen``; the monitor reads
        it back (after its own restart too) and publishes the phase as
        /nodeinfo's migrate_state."""
        d = self._entry_dir()
        if not d:
            return
        atomic_write_json(os.path.join(d, DRAIN_ACK_FILE),
                          {"gen": int(gen), "phase": phase,
                           "host_bytes": int(host_bytes)})


def install(env=None) -> Enforcer:
    """Attach this process to its container's shared region and heartbeat
    it. Safe no-op without the env contract: returns a pass-through
    Enforcer.

    Enforcement itself needs libvgpu.so preloaded before the process
    starts (``LD_PRELOAD`` or ``/etc/ld.so.preload``); this call cannot
    inject it and logs a warning when the quota is configured but the
    interposer is absent."""
    environ = env if env is not None else os.environ
    quota = quota_from_env(environ)
    if not quota.enforced:
        log.debug("GPU quota enforcement not configured; pass-through")
        return Enforcer(quota, None)
    interposed = interposer_active()
    if not interposed:
        log.warning(
            "libvgpu.so is not preloaded in this process: device memory is "
            "accounted only by what the workload charges itself (set "
            "LD_PRELOAD before the process starts)")
    region = None
    try:
        region = SharedRegion(quota.cache_path)
        visible = environ.get(api.ENV_VISIBLE_DEVICES, "")
        region.configure(quota.hbm_limits or [0],
                         [quota.core_limit] * max(1, len(quota.hbm_limits)),
                         priority=quota.priority,
                         util_policy=quota.util_policy,
                         dev_uuids=[u for u in visible.split(",") if u]
                         or None)
        if quota.host_limit:
            region.configure_host(quota.host_limit)
        region.attach()
    except OSError as e:
        log.warning("cannot attach shared region %s: %s",
                    quota.cache_path, e)
        if region is not None:
            region.close()
        region = None
    enforcer = Enforcer(quota, region, interposed=interposed)
    enforcer.start_heartbeat()
    return enforcer
