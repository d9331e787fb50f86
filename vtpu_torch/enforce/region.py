"""ctypes binding of the shared region (vtpu_torch/csrc/shared_region.h).

The port's own copy of vtpu/enforce/region.py:97-560 and 608-880: the same
ABI v8 struct, read and written through the port's ``libvgpucore.so``
(built from the unchanged copy of ``shared_region.c``).

- :class:`SharedRegion` — lock-correct access through the C library
  (configure, attach/detach, GC, charges, the host ledger); what the
  workload side uses.
- :class:`RegionView` / :class:`RegionSnapshot` — the monitor's mmap of a
  region file and the immutable parsed copy each sweep takes of it
  (vtpu/enforce/region.py:571-1081): limits, usage, process slots, the
  compute plane (launch counts, measured device time, in-flight launches,
  the feedback fields), the profile and pressure counters and the host
  ledger; the view writes what the monitor writes (the feedback fields, a
  checked device- or host-limit resize).

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
from typing import List, Optional, Tuple

from .. import api, native
from ..util.env import env_bool, env_str

VTPU_SHARED_MAGIC = 0x76545055
VTPU_SHARED_VERSION = 8
# rolling-upgrade floor (shared_region.h): a region left by an interposer
# of any ABI in [MIN_COMPAT, VERSION) is a transient skip, never corrupt
VTPU_SHARED_VERSION_MIN_COMPAT = 5
VTPU_MAX_DEVICES = 16
VTPU_MAX_PROCS = 64
VTPU_UUID_LEN = 64
VTPU_PROF_BUCKETS = 24
VTPU_PROF_BUCKET_MIN_SHIFT = 7
# libvgpu.so samples 1 call in this many per thread unless VTPU_PROFILE_SAMPLE
# says otherwise (shared_region.c)
VTPU_PROF_SAMPLE_DEFAULT = 64
# the callsite classes' indices (shared_region.h VTPU_PROF_CS_*)
VTPU_PROF_CS_BUF_ALLOC = 0
VTPU_PROF_CS_BUF_FREE = 1
VTPU_PROF_CS_CHARGE = 2
VTPU_PROF_CS_UNCHARGE = 3
VTPU_PROF_CS_EXECUTE = 4
VTPU_PROF_CS_TRANSFER = 5
VTPU_PROF_CS_DONE_WITH_BUFFER = 6
VTPU_PROF_CS_QUOTA_CHECK = 7
VTPU_PROF_CALLSITES = 8
# the pressure counters' indices (shared_region.h VTPU_PROF_PK_*)
VTPU_PROF_PK_CHARGE_RETRIES = 0
VTPU_PROF_PK_CONTENTION_SPINS = 1
VTPU_PROF_PK_AT_LIMIT_NS = 2
VTPU_PROF_PK_NEAR_LIMIT_FAILURES = 3
VTPU_PROF_PK_TABLE_DROPS = 4
VTPU_PROF_PK_HOST_NEAR_LIMIT_FAILURES = 5
VTPU_PROF_PK_HOST_OVER_EVENTS = 6
VTPU_PROF_PRESSURE_KINDS = 7
# the header digest's FNV-1a parameters (shared_region.h): the monitor and
# libvgpu.so must digest the same bytes alike, or every region is corrupt
VTPU_HEADER_CSUM_INIT = 0xCBF29CE484222325
VTPU_HEADER_CSUM_PRIME = 0x100000001B3

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

# the callsite classes of the profile plane (VTPU_PROF_CS_*), in the
# region's order: the label values of vGPUShimCallsite*{callsite}
PROF_CALLSITE_NAMES = (
    "buf_alloc", "buf_free", "charge", "uncharge", "execute",
    "transfer", "done_with_buffer", "quota_check",
)
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
    lib.vtpu_force_alloc.argtypes = [P, i32, ctypes.c_int, u64]
    lib.vtpu_free.argtypes = [P, i32, ctypes.c_int, u64]
    lib.vtpu_region_used.restype = u64
    lib.vtpu_region_used.argtypes = [P, ctypes.c_int]
    lib.vtpu_heartbeat.argtypes = [P, i32]
    lib.vtpu_note_launch.argtypes = [P, i32, u64]
    lib.vtpu_note_complete.argtypes = [P, i32, u64, ctypes.c_uint32]
    lib.vtpu_inflight.restype = i32
    lib.vtpu_inflight.argtypes = [P, ctypes.c_int64]
    lib.vtpu_util_try_acquire.restype = ctypes.c_int
    lib.vtpu_util_try_acquire.argtypes = [P, ctypes.c_int, ctypes.c_uint32,
                                          ctypes.c_int64]
    lib.vtpu_util_debit.argtypes = [P, ctypes.c_uint32, u64]
    lib.vtpu_prof_configure.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.vtpu_prof_flush.restype = ctypes.c_int
    lib.vtpu_prof_flush.argtypes = [P]
    lib.vtpu_prof_bucket_index.restype = ctypes.c_int
    lib.vtpu_prof_bucket_index.argtypes = [u64]
    lib.vtpu_region_configure_host.restype = ctypes.c_int
    lib.vtpu_region_configure_host.argtypes = [P, u64]
    lib.vtpu_host_try_alloc.restype = ctypes.c_int
    lib.vtpu_host_try_alloc.argtypes = [P, i32, u64]
    lib.vtpu_host_force_alloc.argtypes = [P, i32, u64]
    lib.vtpu_host_free.argtypes = [P, i32, u64]
    lib.vtpu_region_host_used.restype = u64
    lib.vtpu_region_host_used.argtypes = [P]
    lib.vtpu_region_header_checksum.restype = u64
    lib.vtpu_region_header_checksum.argtypes = [P]
    lib.vtpu_region_set_limit_checked.restype = ctypes.c_int
    lib.vtpu_region_set_limit_checked.argtypes = [
        P, ctypes.c_int, u64, ctypes.POINTER(u64)]
    lib.vtpu_region_set_host_limit_checked.restype = ctypes.c_int
    lib.vtpu_region_set_host_limit_checked.argtypes = [
        P, u64, ctypes.POINTER(u64)]
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
    return _load(path or env_str(api.ENV_CORE_LIB)
                 or native.core_library())


class RegionCorruptError(ValueError):
    """Definitive corruption (bad magic, foreign version, truncation,
    header-checksum mismatch), as opposed to the transient states a plain
    ValueError reports (not initialized yet, a region of a previous ABI).
    The monitor's quarantine counts only this class."""


def prof_bucket_index(ns: int) -> int:
    """The log2 bucket libvgpu.so bins a latency of ``ns`` into
    (shared_region.c vtpu_prof_bucket_index): bucket 0 holds latencies
    under 2**MIN_SHIFT ns, bucket b [2**(MIN_SHIFT+b-1), 2**(MIN_SHIFT+b)),
    the last one overflows."""
    v = ns >> VTPU_PROF_BUCKET_MIN_SHIFT
    if v <= 0:
        return 0
    return min(v.bit_length(), VTPU_PROF_BUCKETS - 1)


def prof_bucket_bounds() -> List[float]:
    """Upper bounds in ns of each log2 latency bucket of the profile plane
    (the last is +inf), from the header constants the C writer bins with
    (vtpu/enforce/region.py:283-288)."""
    return [float(1 << (VTPU_PROF_BUCKET_MIN_SHIFT + b))
            for b in range(VTPU_PROF_BUCKETS - 1)] + [float("inf")]


def prof_percentile_ns(hist: List[int], q: float) -> float:
    """Percentile estimate from a log2 histogram: the upper bound of the
    bucket where the cumulative count crosses q (the overflow bucket's
    lower bound for the last); 0.0 for an empty histogram."""
    total = sum(hist)
    if total <= 0:
        return 0.0
    bounds = prof_bucket_bounds()
    need = q * total
    cum = 0
    for b, n in enumerate(hist):
        cum += n
        if cum >= need and n:
            if bounds[b] == float("inf"):
                return float(1 << (VTPU_PROF_BUCKET_MIN_SHIFT
                                   + VTPU_PROF_BUCKETS - 2))
            return bounds[b]
    return bounds[-2]


#: the static header fields the v5 digest covers, in the C digest's order
#: (shared_region.c vtpu_region_header_checksum); the magic is digested as
#: the constant, since init stamps the digest before the magic is stored
_CSUM_FIELDS = ("version", "num_devices", "priority", "hbm_limit",
                "core_limit", "util_policy", "dev_uuid", "host_limit")


def _py_header_checksum(struct: SharedRegionStruct) -> int:
    """FNV-1a over the static header fields' bytes in Python, the C
    digest's twin bit for bit (vtpu/enforce/region.py:352-370)."""
    mask = (1 << 64) - 1
    h = VTPU_HEADER_CSUM_INIT

    def mix(h: int, data: bytes) -> int:
        for b in data:
            h = ((h ^ b) * VTPU_HEADER_CSUM_PRIME) & mask
        return h

    h = mix(h, VTPU_SHARED_MAGIC.to_bytes(4, "little"))
    cls = type(struct)
    base = ctypes.addressof(struct)
    for name in _CSUM_FIELDS:
        f = getattr(cls, name)
        h = mix(h, ctypes.string_at(base + f.offset, f.size))
    return h


def header_checksum_of(struct: SharedRegionStruct) -> int:
    """The v5 header digest of a struct (live view or bulk copy), by the C
    library's own function, or in Python where it cannot be loaded."""
    try:
        lib = load_core_library()
    except OSError:
        return _py_header_checksum(struct)
    return int(lib.vtpu_region_header_checksum(ctypes.byref(struct)))


def _prev_abi(magic: int, version: int) -> bool:
    return (magic == VTPU_SHARED_MAGIC
            and VTPU_SHARED_VERSION_MIN_COMPAT <= version
            < VTPU_SHARED_VERSION)


def _check_header(struct: SharedRegionStruct, path: str,
                  file_size: Optional[int] = None) -> None:
    """The validity gate of RegionView and RegionSnapshot
    (vtpu/enforce/region.py:356-402): transient states raise ValueError
    (skip this sweep), definitive corruption raises RegionCorruptError.

    A workload that started under a previous ABI keeps its mapped old
    interposer for its whole life, so its region is legal residue of a
    rolling upgrade, skipped as transient: a durable quarantine would
    silence the pod until it restarts."""
    magic, version = int(struct.magic), int(struct.version)
    prev_abi = _prev_abi(magic, version)
    if file_size is not None and file_size < ctypes.sizeof(struct):
        if prev_abi and file_size >= 8:  # magic+version prefix intact
            raise ValueError(f"{path}: pre-upgrade ABI v{version} region "
                             "(interposer predates the monitor); skipping")
        raise RegionCorruptError(
            f"{path}: truncated ({file_size} B < "
            f"{ctypes.sizeof(struct)} B region)")
    if magic != VTPU_SHARED_MAGIC:
        if magic == 0:
            raise ValueError(f"{path}: not initialized")
        raise RegionCorruptError(f"{path}: bad magic 0x{magic:x}")
    if version != VTPU_SHARED_VERSION:
        if prev_abi:
            raise ValueError(f"{path}: pre-upgrade ABI v{version} region "
                             "(interposer predates the monitor); skipping")
        raise RegionCorruptError(
            f"{path}: unsupported version {version} "
            f"(want {VTPU_SHARED_VERSION})")
    if not env_bool(api.ENV_REGION_CHECKSUM, True):
        return
    if int(struct.header_checksum) != header_checksum_of(struct):
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

    def force_alloc(self, bytes_: int, dev: int = 0,
                    pid: Optional[int] = None) -> None:
        """Charge past the limit (what the interposer charges after the
        fact, e.g. memory a first launch grew)."""
        self._lib.vtpu_force_alloc(self._ptr, pid or os.getpid(), dev,
                                   bytes_)

    def free(self, bytes_: int, dev: int = 0,
             pid: Optional[int] = None) -> None:
        self._lib.vtpu_free(self._ptr, pid or os.getpid(), dev, bytes_)

    def used(self, dev: int = 0) -> int:
        return self._lib.vtpu_region_used(self._ptr, dev)

    def host_try_alloc(self, bytes_: int,
                       pid: Optional[int] = None) -> bool:
        return self._lib.vtpu_host_try_alloc(
            self._ptr, pid or os.getpid(), bytes_) == 0

    def host_force_alloc(self, bytes_: int,
                         pid: Optional[int] = None) -> None:
        self._lib.vtpu_host_force_alloc(self._ptr, pid or os.getpid(),
                                        bytes_)

    def host_free(self, bytes_: int, pid: Optional[int] = None) -> None:
        self._lib.vtpu_host_free(self._ptr, pid or os.getpid(), bytes_)

    def host_used(self) -> int:
        return self._lib.vtpu_region_host_used(self._ptr)

    # -- the compute plane, as libvgpu.so drives it -----------------------
    def note_launch(self, est_ns: int = 0,
                    pid: Optional[int] = None) -> None:
        self._lib.vtpu_note_launch(self._ptr, pid or os.getpid(), est_ns)

    def note_complete(self, ns: int = 0, pid: Optional[int] = None,
                      dev_mask: int = 1) -> None:
        self._lib.vtpu_note_complete(self._ptr, pid or os.getpid(), ns,
                                     dev_mask)

    def inflight(self, max_age_ns: int = 0) -> int:
        return self._lib.vtpu_inflight(self._ptr, max_age_ns)

    def util_try_acquire(self, limit_pct: int,
                         burst_ns: int = 200_000_000,
                         dev: int = 0) -> bool:
        return bool(self._lib.vtpu_util_try_acquire(
            self._ptr, dev, limit_pct, burst_ns))

    def util_debit(self, ns: int, dev_mask: int = 1) -> None:
        """Debit the SM-limit bucket only (no process slot is touched)."""
        self._lib.vtpu_util_debit(self._ptr, dev_mask, ns)

    # -- the profile plane of this process's copy of the C library --------
    def prof_configure(self, enabled: bool, sample_every: int = 1) -> None:
        """This process's profiling switch and sampling (libvgpu.so reads
        ``VTPU_PROFILE`` instead)."""
        self._lib.vtpu_prof_configure(1 if enabled else 0, sample_every)

    def prof_flush(self) -> int:
        """Drain the calling thread's batched profile counters into the
        region; the number of callsite cells flushed."""
        return self._lib.vtpu_prof_flush(self._ptr)

    def prof_bucket_index(self, ns: int) -> int:
        """The C library's own log2 bin of ``ns`` (prof_bucket_index's
        twin)."""
        return self._lib.vtpu_prof_bucket_index(ns)


@dataclass
class ProfStats:
    """One callsite class's cell of the profile plane: ``calls``,
    ``errors`` and ``bytes`` exact; ``sampled``, ``total_ns`` and ``hist``
    over the 1-in-N latency-sampled calls. ``est_total_ns`` scales the
    sampled time to every call."""

    calls: int
    errors: int
    bytes: int
    sampled: int
    total_ns: int
    hist: List[int]

    @property
    def est_total_ns(self) -> float:
        if not self.sampled:
            return 0.0
        return self.total_ns * (self.calls / self.sampled)

    def p50_ns(self) -> float:
        return prof_percentile_ns(self.hist, 0.50)

    def p99_ns(self) -> float:
        return prof_percentile_ns(self.hist, 0.99)


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
    """Immutable parsed copy of one region, from one bulk copy of the mmap
    (vtpu/enforce/region.py:608-784): the monitor's sweep takes one per
    region and the collector, the feedback loop's reads and /nodeinfo share
    it. Its reads mirror :class:`RegionView`'s; ``inflight(max_age_ns)``
    judges heartbeat freshness against the snapshot's own capture time."""

    __slots__ = ("path", "taken_monotonic_ns", "num_devices", "priority",
                 "oom_events", "util_policy", "recent_kernel",
                 "utilization_switch", "_hbm_limits", "_core_limits",
                 "_used", "_total_launches", "_busy_ns", "_uuids",
                 "_procs", "header_heartbeat_ns", "prof", "pressure",
                 "prof_enabled", "prof_sample", "usage_epoch",
                 "_host_limit", "_host_used", "host_oom_events",
                 "footprint_unmeasured")

    def __init__(self, struct: SharedRegionStruct, path: str = ""):
        _check_header(struct, path)
        self.path = path
        self.header_heartbeat_ns = int(struct.header_heartbeat_ns)
        self.usage_epoch = int(struct.usage_epoch)
        self.taken_monotonic_ns = time.monotonic_ns()
        n = max(1, min(int(struct.num_devices), VTPU_MAX_DEVICES))
        self.num_devices = n
        self.priority = int(struct.priority)
        self.oom_events = int(struct.oom_events)
        self.util_policy = int(struct.util_policy)
        self.recent_kernel = int(struct.recent_kernel)
        self.utilization_switch = int(struct.utilization_switch)
        self._hbm_limits = [int(x) for x in struct.hbm_limit[:n]]
        self._core_limits = [int(x) for x in struct.core_limit[:n]]
        self._total_launches = int(struct.total_launches)
        self._uuids = [struct.dev_uuid[i].value.decode("utf-8", "replace")
                       for i in range(n)]
        used = [0] * n
        busy = 0
        host_used = 0
        procs: List[ProcUsage] = []
        for slot in struct.procs:
            if not slot.status:
                continue
            hbm = [int(x) for x in slot.hbm_used[:n]]
            for d in range(n):
                used[d] += hbm[d]
            busy += int(slot.launch_ns)
            host_used += int(slot.host_used)
            procs.append(ProcUsage(
                pid=int(slot.pid), hbm_used=hbm,
                last_seen_ns=int(slot.last_seen_ns),
                launches=int(slot.launches),
                launch_ns=int(slot.launch_ns),
                inflight=int(slot.inflight),
                host_used=int(slot.host_used)))
        self._used = used
        self._busy_ns = busy
        self._procs = procs
        # the slot sum is the ground truth of the host ledger: a torn read
        # of the lock-free aggregate must not skew the host guard
        self._host_limit = int(struct.host_limit)
        self._host_used = host_used
        self.host_oom_events = int(struct.host_oom_events)
        # profile plane: dynamic, unchecked fields, parsed defensively
        self.prof_enabled = bool(struct.prof_enabled)
        self.prof_sample = max(1, int(struct.prof_sample))
        prof = {}
        for i, cs_name in enumerate(PROF_CALLSITE_NAMES):
            cell = struct.prof_cs[i]
            prof[cs_name] = ProfStats(
                calls=int(cell.calls), errors=int(cell.errors),
                bytes=int(cell.bytes), sampled=int(cell.sampled),
                total_ns=int(cell.total_ns),
                hist=[int(x) for x in cell.hist])
        self.prof = prof
        self.pressure = {name: int(struct.prof_pressure[i])
                         for i, name in enumerate(PROF_PRESSURE_NAMES)}
        # libvgpu.so's count of devices whose footprint it does not re-read
        # (the header's reserved2; the JAX shim leaves it 0)
        self.footprint_unmeasured = int(struct.reserved2)

    def hbm_limit(self, dev: int = 0) -> int:
        return self._hbm_limits[dev]

    def host_limit(self) -> int:
        return self._host_limit

    def host_used(self) -> int:
        return self._host_used

    def core_limit(self, dev: int = 0) -> int:
        return self._core_limits[dev]

    def used(self, dev: int = 0) -> int:
        return self._used[dev]

    def procs(self) -> List[ProcUsage]:
        return list(self._procs)

    def total_launches(self) -> int:
        return self._total_launches

    def busy_ns(self) -> int:
        """Device time charged to the container's live processes."""
        return self._busy_ns

    def dev_uuids(self) -> List[str]:
        return list(self._uuids)

    def inflight(self, max_age_ns: int = 0) -> int:
        if max_age_ns > 0:
            now = self.taken_monotonic_ns
            return sum(p.inflight for p in self._procs
                       if p.inflight > 0
                       and now - p.last_seen_ns <= max_age_ns)
        return sum(p.inflight for p in self._procs if p.inflight > 0)

    def age_s(self) -> float:
        return max(0.0,
                   (time.monotonic_ns() - self.taken_monotonic_ns) / 1e9)

    def header_heartbeat_age_s(self) -> float:
        """Seconds since any process of the container heartbeat the region
        (both sides CLOCK_MONOTONIC on one host), at capture time."""
        return max(0.0, (self.taken_monotonic_ns
                         - self.header_heartbeat_ns) / 1e9)

    def profile_summary(self) -> dict:
        """The profile plane as JSON (/nodeinfo): active callsites with
        exact counters and percentile estimates in us, the charged device
        time and the pressure counters."""
        callsites = {}
        for name, st in self.prof.items():
            if not st.calls:
                continue
            callsites[name] = {
                "calls": st.calls,
                "errors": st.errors,
                "bytes": st.bytes,
                "sampled": st.sampled,
                "p50_us": round(st.p50_ns() / 1e3, 3),
                "p99_us": round(st.p99_ns() / 1e3, 3),
                "est_total_ms": round(st.est_total_ns / 1e6, 3),
                "hist": st.hist,
            }
        return {
            "enabled": self.prof_enabled,
            "sample": self.prof_sample,
            "busy_ms": round(self._busy_ns / 1e6, 3),
            "callsites": callsites,
            "pressure": dict(self.pressure),
        }

    def host_summary(self) -> dict:
        return {
            "host_limit": self._host_limit,
            "host_used": self._host_used,
            "host_oom_events": self.host_oom_events,
        }


class RegionView:
    """The monitor's read-mostly mmap of a region file
    (vtpu/enforce/region.py:787-1081)."""

    def __init__(self, path: str):
        load_core_library()  # checks the struct size against the C one
        size = ctypes.sizeof(SharedRegionStruct)
        self.path = path
        self._mm = None
        self._s = None
        self._f = open(path, "r+b")
        try:
            st_size = os.fstat(self._f.fileno()).st_size
            if st_size < size:
                # a previous ABI's smaller region is transient residue,
                # anything else this short is truncation (zero length too:
                # quarantine needs several sweeps in a row, and the
                # interposer's create-and-size window is microseconds)
                head = self._f.read(8)
                if len(head) == 8 and _prev_abi(
                        int.from_bytes(head[:4], "little"),
                        int.from_bytes(head[4:8], "little")):
                    raise ValueError(
                        f"{path}: pre-upgrade ABI "
                        f"v{int.from_bytes(head[4:8], 'little')} region "
                        "(interposer predates the monitor); skipping")
                raise RegionCorruptError(
                    f"{path}: truncated ({st_size} B < {size} B region)")
            self._mm = mmap.mmap(self._f.fileno(), size)
        except BaseException:
            self._f.close()
            self._f = None
            raise
        self._s = SharedRegionStruct.from_buffer(self._mm)
        try:
            _check_header(self._s, path)
        except BaseException:
            self.close()
            raise

    def close(self) -> None:
        self._s = None
        if self._mm is not None:
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
        """One bulk copy of the struct, parsed; ValueError on a closed view
        or a header torn or reinitialised mid-copy."""
        if self._mm is None:
            raise ValueError(f"{self.path}: region closed")
        return RegionSnapshot(
            SharedRegionStruct.from_buffer_copy(self._mm), self.path)

    # -- reads -------------------------------------------------------------
    @property
    def num_devices(self) -> int:
        return max(1, int(self._s.num_devices))

    @property
    def priority(self) -> int:
        return int(self._s.priority)

    @property
    def oom_events(self) -> int:
        return int(self._s.oom_events)

    @property
    def util_policy(self) -> int:
        return int(self._s.util_policy)

    def hbm_limit(self, dev: int = 0) -> int:
        return int(self._s.hbm_limit[dev])

    def core_limit(self, dev: int = 0) -> int:
        return int(self._s.core_limit[dev])

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

    def dev_uuids(self) -> List[str]:
        """The cards' ids by visible-device index ("" if unknown)."""
        return [self._s.dev_uuid[i].value.decode("utf-8", "replace")
                for i in range(self.num_devices)]

    def header_heartbeat_ns(self) -> int:
        return int(self._s.header_heartbeat_ns)

    # -- the compute plane (vtpu/enforce/region.py:991-1080) ---------------
    def total_launches(self) -> int:
        """Launches of the container's lifetime (per-slot counts end with
        their process)."""
        return int(self._s.total_launches)

    def inflight(self, max_age_ns: int = 0) -> int:
        """Launches dispatched and not yet charged, summed over live
        slots; ``max_age_ns`` > 0 skips slots whose heartbeat is older (a
        process killed mid-kernel leaves its count behind)."""
        if max_age_ns > 0:
            now = time.monotonic_ns()
            return sum(int(s.inflight) for s in self._s.procs
                       if s.status and s.inflight > 0
                       and now - s.last_seen_ns <= max_age_ns)
        return sum(int(s.inflight) for s in self._s.procs
                   if s.status and s.inflight > 0)

    def busy_ns(self) -> int:
        """Device time charged to the live slots, in ns."""
        return sum(int(s.launch_ns) for s in self._s.procs if s.status)

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

    def pressure(self) -> dict:
        """The pressure counters by name (:data:`PROF_PRESSURE_NAMES`)."""
        return {name: int(self._s.prof_pressure[i])
                for i, name in enumerate(PROF_PRESSURE_NAMES)}

    @property
    def footprint_unmeasured(self) -> int:
        """Devices of the container's processes whose footprint libvgpu.so
        does not re-read, counted at each one's first context (the header's
        reserved2)."""
        return int(self._s.reserved2)

    # -- the limits the monitor writes -------------------------------------
    def set_limit_checked(self, value: int, dev: int = 0) -> Tuple[int, int]:
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

    def set_hbm_limit(self, value: int, dev: int = 0) -> int:
        """:meth:`set_limit_checked`, returning the limit applied."""
        _rc, applied = self.set_limit_checked(value, dev)
        return applied

    def host_limit(self) -> int:
        return int(self._s.host_limit)

    def host_used(self) -> int:
        return sum(int(s.host_used) for s in self._s.procs if s.status)

    @property
    def host_oom_events(self) -> int:
        return int(self._s.host_oom_events)

    def set_host_limit_checked(self, value: int) -> Tuple[int, int]:
        """The host ledger's twin of :meth:`set_limit_checked`
        (``vtpu_region_set_host_limit_checked``)."""
        applied = ctypes.c_uint64(0)
        rc = int(load_core_library().vtpu_region_set_host_limit_checked(
            ctypes.byref(self._s), value, ctypes.byref(applied)))
        if rc < 0:
            raise ValueError(f"{self.path}: set_host_limit_checked refused")
        return rc, int(applied.value)

    def restamp_header(self) -> None:
        """Recompute and store the header checksum after a legitimate write
        of a static field (a harness poking ``dev_uuid``); the C calls
        restamp their own writes."""
        self._s.header_checksum = header_checksum_of(self._s)
