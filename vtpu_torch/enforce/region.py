"""ctypes binding of the shared region (vtpu_torch/csrc/shared_region.h).

The port's own copy of vtpu/enforce/region.py:97-560 and 608-880: the same
ABI v8 struct, read and written through the port's ``libvgpucore.so``
(built from the unchanged copy of ``shared_region.c``).

- :class:`SharedRegion` — lock-correct access through the C library
  (configure, attach/detach, GC, charges, the host ledger); what the
  workload side uses.
- :class:`RegionView` / :class:`RegionSnapshot` — the monitor's mmap of a
  region file: limits, used bytes, process slots, heartbeat age; the view
  also reads the compute plane (launch counts, measured device time, the
  feedback fields and the pressure counters) and writes what the monitor
  writes (the feedback fields, a checked limit resize).

The layout must track shared_region.h exactly. tests/test_torch_enforce.py
holds it to the JAX package's mirror byte for byte: a region this module
writes is read back by ``vtpu.enforce.region.RegionView``.
"""

from __future__ import annotations

import ctypes
import functools
import mmap
import os
import time
from dataclasses import dataclass
from typing import List, Optional

from .. import native

VTPU_SHARED_MAGIC = 0x76545055
VTPU_SHARED_VERSION = 8
VTPU_MAX_DEVICES = 16
VTPU_MAX_PROCS = 64
VTPU_UUID_LEN = 64
VTPU_PROF_BUCKETS = 24
VTPU_PROF_CALLSITES = 8
VTPU_PROF_PRESSURE_KINDS = 7

UTIL_POLICY_DEFAULT = 0
UTIL_POLICY_FORCE = 1
UTIL_POLICY_DISABLE = 2

# recent_kernel feedback states: the monitor blocks a low-priority
# container's launches with FEEDBACK_BLOCK and releases it with IDLE
FEEDBACK_BLOCK = -1
FEEDBACK_IDLE = 0

# return codes of the checked limit resize
RESIZE_APPLIED = 0
RESIZE_CLAMPED = 1

# the pressure counters (VTPU_PROF_PK_*), in the region's order
PROF_PRESSURE_NAMES = (
    "charge_retries", "contention_spins", "at_limit_ns",
    "near_limit_failures", "table_drops",
    "host_near_limit_failures", "host_over_events",
)

# pthread_mutex_t is 40 bytes on x86-64 glibc; the C struct embeds it, so
# it is mirrored as an opaque blob (checked against the C sizeof)
_MUTEX_SIZE = 40


class ProfCallsite(ctypes.Structure):
    _fields_ = [
        ("calls", ctypes.c_uint64),
        ("errors", ctypes.c_uint64),
        ("bytes", ctypes.c_uint64),
        ("sampled", ctypes.c_uint64),
        ("total_ns", ctypes.c_uint64),
        ("hist", ctypes.c_uint64 * VTPU_PROF_BUCKETS),
    ]


class ProcSlot(ctypes.Structure):
    _fields_ = [
        ("pid", ctypes.c_int32),
        ("status", ctypes.c_int32),
        ("hbm_used", ctypes.c_uint64 * VTPU_MAX_DEVICES),
        ("launches", ctypes.c_uint64),
        ("launch_ns", ctypes.c_uint64),
        ("last_seen_ns", ctypes.c_int64),
        ("inflight", ctypes.c_int32),
        ("reserved1", ctypes.c_int32),
        ("host_used", ctypes.c_uint64),
    ]


class SharedRegionStruct(ctypes.Structure):
    _fields_ = [
        ("magic", ctypes.c_uint32),
        ("version", ctypes.c_uint32),
        ("initialized", ctypes.c_int32),
        ("owner_pid", ctypes.c_int32),
        ("lock", ctypes.c_byte * _MUTEX_SIZE),
        ("num_devices", ctypes.c_int32),
        ("priority", ctypes.c_int32),
        ("hbm_limit", ctypes.c_uint64 * VTPU_MAX_DEVICES),
        ("core_limit", ctypes.c_uint32 * VTPU_MAX_DEVICES),
        ("recent_kernel", ctypes.c_int32),
        ("utilization_switch", ctypes.c_int32),
        ("util_policy", ctypes.c_int32),
        ("reserved0", ctypes.c_int32),
        ("oom_events", ctypes.c_uint64),
        ("total_launches", ctypes.c_uint64),
        ("dev_uuid", (ctypes.c_char * VTPU_UUID_LEN) * VTPU_MAX_DEVICES),
        ("procs", ProcSlot * VTPU_MAX_PROCS),
        ("util_tokens_ns", ctypes.c_int64 * VTPU_MAX_DEVICES),
        ("util_refill_ns", ctypes.c_int64 * VTPU_MAX_DEVICES),
        ("util_prev_switch", ctypes.c_int32),
        ("reserved2", ctypes.c_int32),
        ("header_checksum", ctypes.c_uint64),
        ("header_heartbeat_ns", ctypes.c_int64),
        ("prof_enabled", ctypes.c_uint32),
        ("prof_sample", ctypes.c_uint32),
        ("prof_cs", ProfCallsite * VTPU_PROF_CALLSITES),
        ("prof_pressure", ctypes.c_uint64 * VTPU_PROF_PRESSURE_KINDS),
        ("usage_epoch", ctypes.c_uint64),
        ("hbm_used_agg", ctypes.c_uint64 * VTPU_MAX_DEVICES),
        ("host_limit", ctypes.c_uint64),
        ("host_used_agg", ctypes.c_uint64),
        ("host_oom_events", ctypes.c_uint64),
    ]


@functools.lru_cache(maxsize=None)
def _load(path: str):
    lib = ctypes.CDLL(path)
    P = ctypes.POINTER(SharedRegionStruct)
    u64, i32 = ctypes.c_uint64, ctypes.c_int32
    lib.vtpu_region_open.restype = P
    lib.vtpu_region_open.argtypes = [ctypes.c_char_p]
    lib.vtpu_region_close.argtypes = [P]
    lib.vtpu_region_configure.restype = ctypes.c_int
    lib.vtpu_region_configure.argtypes = [
        P, ctypes.c_int, ctypes.POINTER(u64), ctypes.POINTER(ctypes.c_uint32),
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_char_p)]
    lib.vtpu_region_attach.restype = ctypes.c_int
    lib.vtpu_region_attach.argtypes = [P, i32]
    lib.vtpu_region_detach.restype = ctypes.c_int
    lib.vtpu_region_detach.argtypes = [P, i32]
    lib.vtpu_region_gc.restype = ctypes.c_int
    lib.vtpu_region_gc.argtypes = [P]
    lib.vtpu_try_alloc.restype = ctypes.c_int
    lib.vtpu_try_alloc.argtypes = [P, i32, ctypes.c_int, u64]
    lib.vtpu_free.argtypes = [P, i32, ctypes.c_int, u64]
    lib.vtpu_region_used.restype = u64
    lib.vtpu_region_used.argtypes = [P, ctypes.c_int]
    lib.vtpu_heartbeat.argtypes = [P, i32]
    lib.vtpu_region_configure_host.restype = ctypes.c_int
    lib.vtpu_region_configure_host.argtypes = [P, u64]
    lib.vtpu_host_try_alloc.restype = ctypes.c_int
    lib.vtpu_host_try_alloc.argtypes = [P, i32, u64]
    lib.vtpu_host_free.argtypes = [P, i32, u64]
    lib.vtpu_region_host_used.restype = u64
    lib.vtpu_region_host_used.argtypes = [P]
    lib.vtpu_region_header_checksum.restype = u64
    lib.vtpu_region_header_checksum.argtypes = [P]
    lib.vtpu_region_set_limit_checked.restype = ctypes.c_int
    lib.vtpu_region_set_limit_checked.argtypes = [
        P, ctypes.c_int, u64, ctypes.POINTER(u64)]
    lib.vtpu_region_sizeof.restype = ctypes.c_size_t
    lib.vtpu_region_sizeof.argtypes = []
    c_size = lib.vtpu_region_sizeof()
    if c_size != ctypes.sizeof(SharedRegionStruct):
        raise OSError(
            f"shared-region ABI mismatch: C sizeof={c_size}, ctypes mirror="
            f"{ctypes.sizeof(SharedRegionStruct)}; adjust _MUTEX_SIZE for "
            "this platform")
    return lib


def load_core_library(path: Optional[str] = None):
    """The port's ``libvgpucore.so`` with prototypes declared and its
    struct size checked against this mirror; ``VGPU_CORE_LIB`` overrides
    the built one."""
    return _load(path or os.environ.get("VGPU_CORE_LIB")
                 or native.core_library())


class RegionCorruptError(ValueError):
    """Definitive corruption (bad magic, foreign version, truncation,
    header-checksum mismatch), as opposed to the transient 'not initialized
    yet' a plain ValueError reports."""


def _check_header(struct: SharedRegionStruct, path: str) -> None:
    magic = int(struct.magic)
    if magic != VTPU_SHARED_MAGIC:
        if magic == 0:
            raise ValueError(f"{path}: not initialized")
        raise RegionCorruptError(f"{path}: bad magic 0x{magic:x}")
    if int(struct.version) != VTPU_SHARED_VERSION:
        raise RegionCorruptError(
            f"{path}: unsupported version {int(struct.version)} "
            f"(want {VTPU_SHARED_VERSION})")
    digest = load_core_library().vtpu_region_header_checksum(
        ctypes.byref(struct))
    if int(struct.header_checksum) != int(digest):
        raise RegionCorruptError(f"{path}: header checksum mismatch")


class SharedRegion:
    """Lock-correct access to a region file through libvgpucore.so."""

    def __init__(self, path: str):
        self._lib = load_core_library()
        self._ptr = self._lib.vtpu_region_open(path.encode())
        if not self._ptr:
            raise OSError(f"cannot open shared region at {path}")
        self.path = path

    @property
    def raw(self) -> SharedRegionStruct:
        return self._ptr.contents

    def close(self) -> None:
        if self._ptr:
            self._lib.vtpu_region_close(self._ptr)
            self._ptr = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def configure(self, hbm_limits: List[int], core_limits: List[int],
                  priority: int = 1,
                  util_policy: int = UTIL_POLICY_DEFAULT,
                  dev_uuids: Optional[List[str]] = None) -> None:
        """First writer wins: later calls leave the limits as they are."""
        hbm = (ctypes.c_uint64 * VTPU_MAX_DEVICES)(*hbm_limits)
        core = (ctypes.c_uint32 * VTPU_MAX_DEVICES)(*core_limits)
        uuids = None
        if dev_uuids:
            uuids = (ctypes.c_char_p * VTPU_MAX_DEVICES)(
                *[u.encode() for u in dev_uuids[:VTPU_MAX_DEVICES]])
        if self._lib.vtpu_region_configure(self._ptr, len(hbm_limits), hbm,
                                           core, priority, util_policy,
                                           uuids) != 0:
            raise OSError("vtpu_region_configure failed")

    def configure_host(self, host_limit: int) -> None:
        if self._lib.vtpu_region_configure_host(self._ptr, host_limit) != 0:
            raise OSError("vtpu_region_configure_host failed")

    def attach(self, pid: Optional[int] = None) -> int:
        return self._lib.vtpu_region_attach(self._ptr, pid or os.getpid())

    def detach(self, pid: Optional[int] = None) -> int:
        return self._lib.vtpu_region_detach(self._ptr, pid or os.getpid())

    def gc(self) -> int:
        return self._lib.vtpu_region_gc(self._ptr)

    def heartbeat(self, pid: Optional[int] = None) -> None:
        self._lib.vtpu_heartbeat(self._ptr, pid or os.getpid())

    def try_alloc(self, bytes_: int, dev: int = 0,
                  pid: Optional[int] = None) -> bool:
        return self._lib.vtpu_try_alloc(
            self._ptr, pid or os.getpid(), dev, bytes_) == 0

    def free(self, bytes_: int, dev: int = 0,
             pid: Optional[int] = None) -> None:
        self._lib.vtpu_free(self._ptr, pid or os.getpid(), dev, bytes_)

    def used(self, dev: int = 0) -> int:
        return self._lib.vtpu_region_used(self._ptr, dev)

    def host_try_alloc(self, bytes_: int,
                       pid: Optional[int] = None) -> bool:
        return self._lib.vtpu_host_try_alloc(
            self._ptr, pid or os.getpid(), bytes_) == 0

    def host_free(self, bytes_: int, pid: Optional[int] = None) -> None:
        self._lib.vtpu_host_free(self._ptr, pid or os.getpid(), bytes_)

    def host_used(self) -> int:
        return self._lib.vtpu_region_host_used(self._ptr)


@dataclass
class ProcUsage:
    pid: int
    hbm_used: List[int]
    last_seen_ns: int
    launches: int = 0
    launch_ns: int = 0
    inflight: int = 0
    host_used: int = 0


class RegionSnapshot:
    """Immutable parsed copy of one region, taken from one bulk copy of the
    mmap (region.py:608-700 of the JAX package, the fields this slice
    reads)."""

    def __init__(self, struct: SharedRegionStruct, path: str = ""):
        _check_header(struct, path)
        self.path = path
        self.taken_monotonic_ns = time.monotonic_ns()
        n = max(1, min(int(struct.num_devices), VTPU_MAX_DEVICES))
        self.num_devices = n
        self.header_heartbeat_ns = int(struct.header_heartbeat_ns)
        self._hbm_limits = [int(x) for x in struct.hbm_limit[:n]]
        self._uuids = [struct.dev_uuid[i].value.decode("utf-8", "replace")
                       for i in range(n)]
        used = [0] * n
        procs: List[ProcUsage] = []
        for slot in struct.procs:
            if not slot.status:
                continue
            hbm = [int(x) for x in slot.hbm_used[:n]]
            for d in range(n):
                used[d] += hbm[d]
            procs.append(ProcUsage(pid=int(slot.pid), hbm_used=hbm,
                                   last_seen_ns=int(slot.last_seen_ns)))
        self._used = used
        self._procs = procs

    def hbm_limit(self, dev: int = 0) -> int:
        return self._hbm_limits[dev]

    def used(self, dev: int = 0) -> int:
        return self._used[dev]

    def procs(self) -> List[ProcUsage]:
        return list(self._procs)

    def dev_uuids(self) -> List[str]:
        return list(self._uuids)

    def header_heartbeat_age_s(self) -> float:
        """Seconds since any process of the container heartbeat the region
        (both sides CLOCK_MONOTONIC on one host)."""
        return max(0.0, (self.taken_monotonic_ns
                         - self.header_heartbeat_ns) / 1e9)


class RegionView:
    """The monitor's read-mostly mmap of a region file."""

    def __init__(self, path: str):
        load_core_library()  # checks the struct size against the C one
        size = ctypes.sizeof(SharedRegionStruct)
        self.path = path
        self._f = open(path, "r+b")
        try:
            if os.fstat(self._f.fileno()).st_size < size:
                raise RegionCorruptError(f"{path}: truncated (< {size} B)")
            self._mm = mmap.mmap(self._f.fileno(), size)
        except BaseException:
            self._f.close()
            raise
        self._s = SharedRegionStruct.from_buffer(self._mm)
        try:
            _check_header(self._s, path)
        except BaseException:
            self.close()
            raise

    def close(self) -> None:
        self._s = None
        if getattr(self, "_mm", None) is not None:
            try:
                self._mm.close()
            except BufferError:
                # a struct view is still referenced (a reader's snapshot
                # in progress, an exception's frame); GC finishes the unmap
                pass
            self._mm = None
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def snapshot(self) -> RegionSnapshot:
        if self._mm is None:
            raise ValueError(f"{self.path}: region closed")
        return RegionSnapshot(
            SharedRegionStruct.from_buffer_copy(self._mm), self.path)

    @property
    def num_devices(self) -> int:
        return max(1, int(self._s.num_devices))

    def hbm_limit(self, dev: int = 0) -> int:
        return int(self._s.hbm_limit[dev])

    def used(self, dev: int = 0) -> int:
        return sum(int(s.hbm_used[dev]) for s in self._s.procs if s.status)

    def procs(self) -> List[ProcUsage]:
        n = self.num_devices
        return [ProcUsage(pid=int(s.pid),
                          hbm_used=[int(x) for x in s.hbm_used[:n]],
                          last_seen_ns=int(s.last_seen_ns),
                          launches=int(s.launches),
                          launch_ns=int(s.launch_ns),
                          inflight=int(s.inflight),
                          host_used=int(s.host_used))
                for s in self._s.procs if s.status]

    def set_limit_checked(self, value: int, dev: int = 0):
        """Write device ``dev``'s limit live through the checked C call
        (``vtpu_region_set_limit_checked``): under the region lock a shrink
        below the usage is clamped to the usage, the header checksum is
        restamped and the usage epoch bumped, so the launch gate sees the
        new limit at its next launch. ``(rc, applied)``, rc
        :data:`RESIZE_APPLIED` or :data:`RESIZE_CLAMPED`."""
        applied = ctypes.c_uint64(0)
        rc = int(load_core_library().vtpu_region_set_limit_checked(
            ctypes.byref(self._s), dev, value, ctypes.byref(applied)))
        if rc < 0:
            raise ValueError(f"{self.path}: set_limit_checked(dev={dev}) "
                             "refused")
        return rc, int(applied.value)

    # -- the compute plane (vtpu/enforce/region.py:991-1080) --------------
    def core_limit(self, dev: int = 0) -> int:
        return int(self._s.core_limit[dev])

    def total_launches(self) -> int:
        """Launches of the container's lifetime (per-slot counts end with
        their process)."""
        return int(self._s.total_launches)

    @property
    def recent_kernel(self) -> int:
        return int(self._s.recent_kernel)

    def set_recent_kernel(self, v: int) -> None:
        self._s.recent_kernel = v

    @property
    def utilization_switch(self) -> int:
        return int(self._s.utilization_switch)

    def set_utilization_switch(self, v: int) -> None:
        self._s.utilization_switch = v

    # -- the host-memory ledger ------------------------------------------
    def host_limit(self) -> int:
        return int(self._s.host_limit)

    def host_used(self) -> int:
        return sum(int(s.host_used) for s in self._s.procs if s.status)

    def pressure(self) -> dict:
        """The pressure counters by name (:data:`PROF_PRESSURE_NAMES`)."""
        return {name: int(self._s.prof_pressure[i])
                for i, name in enumerate(PROF_PRESSURE_NAMES)}
