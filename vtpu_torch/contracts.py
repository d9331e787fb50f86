"""The port's wire-protocol contract registry.

The counterpart of vtpu/contracts.py, stated in the port's terms. Four
programs (the scheduler and its webhook, the device plugin, the node
monitor, and libvgpu.so inside each container) share no memory and no
RPC surface: their only shared truth is a protocol of pod and node
annotations, injected env knobs, durable node files and the
shared-region ABI. This module declares each of those with its owning
layer, its allowed writer modules and its fencing, and
``python -m vtpu_torch.lint`` (vtpu_torch/lint/) holds the tree to the
declarations:

  * a naked ``vtpu.io/...`` / ``nvidia.com/...`` literal outside this
    registry and vtpu_torch/api/ fails lint (VTPU019), and so does an env
    read of a name no :class:`EnvKnob` declares;
  * write-shaped uses of a writer-confined annotation constant outside
    its ``writers=`` modules fail lint (VTPU020);
  * docs/gpu/config.md's env table is diffed against ``ENV_KNOBS``
    (VTPU021), and docs/gpu/protocols.md is generated from this registry
    (VTPU022);
  * every crash edge of a fenced protocol has a test tagged with
    :func:`covers_edge`, or a waiver on the edge (VTPU023).

The names themselves stay in :mod:`vtpu_torch.api`, the home of the
port's vocabulary: this module imports them from there and adds what the
lint needs. It imports nothing else of the port, and nothing of ``vtpu``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

from vtpu_torch import api

# ---------------------------------------------------------------------------
# Wire domains, annotation keys and resource names (vtpu_torch/api)
# ---------------------------------------------------------------------------

DOMAIN = api.DOMAIN
NVIDIA_DOMAIN = api.NVIDIA_DOMAIN
#: the TPU vendor's domain: the slice-gang keys the shared scheduler reads
TPU_DOMAIN = "tpu.google.com"
LEASE_NAME_DEFAULT = api.LEASE_NAME_DEFAULT

RESOURCES = (api.RESOURCE_GPU, api.RESOURCE_MEM, api.RESOURCE_MEM_PERCENT,
             api.RESOURCE_CORES, api.RESOURCE_HOST_MEM,
             api.RESOURCE_PRIORITY)


# ---------------------------------------------------------------------------
# Registry record types (vtpu/contracts.py:131-274)
# ---------------------------------------------------------------------------

#: a module-confinement site: (parent package dir, basename); "*" as the
#: basename means the whole package, "*" as the package matches any
#: parent directory
Site = Tuple[str, str]


@dataclass(frozen=True)
class AnnotationKey:
    """One wire-protocol annotation key. ``writers=()`` leaves it
    unconfined; a non-empty tuple confines write-shaped uses of the
    constant (dict-literal key, subscript store, ``setdefault``/``pop``)
    to those modules (VTPU020)."""

    const: str                    # the constant's name in vtpu_torch.api
    key: str                      # the wire string
    layer: str                    # owning layer: scheduler/plugin/monitor/user
    writers: Tuple[Site, ...]     # () = unconfined
    readers: Tuple[str, ...]      # descriptive reader set (docs)
    fencing: str                  # "" = none; else the precondition
    doc: str


@dataclass(frozen=True)
class EnvKnob:
    """One env knob a daemon, libvgpu.so or the workload reads.
    ``documented`` knobs each have a row in docs/gpu/config.md (VTPU021);
    a read through vtpu_torch/util/env.py must name a registered knob
    (VTPU019)."""

    name: str
    component: str                # plugin/monitor/scheduler/gateway/...
    doc: str
    documented: bool = True


@dataclass(frozen=True)
class DurableFile:
    """One durable node-plane file (crash-replay state)."""

    name: str                     # the on-disk basename
    layer: str
    writers: Tuple[str, ...]      # descriptive writer set
    readers: Tuple[str, ...]
    fencing: str
    doc: str


@dataclass(frozen=True)
class CrashEdge:
    """One declared crash boundary of a fenced protocol. ``waiver``
    non-empty: the edge is deliberately uncovered, with the reason."""

    name: str                     # short slug, e.g. "kill-after-stamp"
    at: str                       # where the crash lands
    expect: str                   # the recovery obligation
    waiver: str = ""


@dataclass(frozen=True)
class FencedProtocol:
    """One fenced multi-process protocol and its crash-edge state
    machine; tests register the edges they exercise with
    ``@covers_edge("<protocol>:<edge>")`` (VTPU023)."""

    name: str                     # slug used in covers_edge ids
    title: str
    layers: Tuple[str, ...]
    fencing: str
    states: Tuple[str, ...]       # ordered happy-path states
    edges: Tuple[CrashEdge, ...]
    doc: str                      # the owning design doc

    def edge_ids(self) -> Tuple[str, ...]:
        return tuple(f"{self.name}:{e.name}" for e in self.edges)


@dataclass(frozen=True)
class GuardRule:
    """One declarative guarded-by/confined-to rule over call sites, run
    by vtpu_torch/lint/engine.py inside the per-file walk.

    Selectors (``methods``, ``suffix``, ``bare_name``, the receiver
    qualifiers, ``requires_kwarg``) pick the call sites; ``confined_to``
    names the legal modules, ``guarded_by`` the lock convention that must
    hold lexically (``"decide"``, ``"shard"`` or ``"batch"``), limited to
    names ending in ``guard_suffix`` when that is set; ``forbid_guard``
    inverts the check. Messages may use ``{name}`` and ``{recv}``."""

    rule: str
    methods: Tuple[str, ...] = ()
    suffix: str = ""
    bare_name: bool = False
    receiver_self_attrs: Tuple[str, ...] = ()
    receiver_attr: str = ""
    receiver_names: Tuple[str, ...] = ()
    receiver_contains: str = ""
    requires_kwarg: str = ""
    confined_to: Tuple[Site, ...] = ()
    guarded_by: str = ""
    guard_suffix: str = ""
    forbid_guard: str = ""
    confine_message: str = ""
    guard_message: str = ""


@dataclass(frozen=True)
class StoreRule:
    """One declarative rule over store sites (``x.attr = ...`` /
    ``x.attr[...] = ...``); ``{attr}`` is available in the message."""

    rule: str
    attr_targets: Tuple[str, ...] = ()
    subscript_of: Tuple[str, ...] = ()
    confined_to: Tuple[Site, ...] = ()
    guarded_by: str = ""
    message: str = ""


# ---------------------------------------------------------------------------
# Annotation registry
# ---------------------------------------------------------------------------

def _anno(const, layer, writers, readers, fencing, doc) -> AnnotationKey:
    return AnnotationKey(const, getattr(api, const), layer, writers,
                         readers, fencing, doc)


ANNOTATIONS: Tuple[AnnotationKey, ...] = (
    _anno("HANDSHAKE_ANNO", "plugin", (), ("scheduler (liveness)",), "",
          "node->scheduler liveness handshake of the NVIDIA vendor "
          "(Requesting/Reported/Deleted timestamps); stale past 60 s, the "
          "node's inventory is dropped."),
    _anno("NODE_REGISTER_ANNO", "plugin", (),
          ("scheduler (inventory ingest)",), "",
          "encoded card inventory (uuid/index/count/devmem/devcore/type/"
          "numa) the plugin registers on its node."),
    _anno("ASSIGNED_NODE_ANNO", "scheduler", (), ("plugin", "monitor"),
          "committer uid precondition",
          "the node the scheduler assigned the pod to."),
    _anno("ASSIGNED_IDS_ANNO", "scheduler", (),
          ("plugin (Allocate)", "monitor (drain/usage)",
           "scheduler (recover rebuild)"), "committer uid precondition",
          "the pod's full card assignment in the pod-devices wire form; "
          "recover() rebuilds the overlay from these."),
    _anno("TO_ALLOCATE_ANNO", "scheduler", (),
          ("plugin (consumed per container)",),
          "committer uid precondition",
          "per-container allocation worklist, consumed one container at a "
          "time by the plugin's Allocate."),
    _anno("ASSIGNED_TIME_ANNO", "scheduler", (),
          ("scheduler (staleness sweep)",), "committer uid precondition",
          "assignment timestamp driving the unbound-pod staleness sweep."),
    _anno("BIND_TIME_ANNO", "scheduler", (), ("observability",),
          "committer uid precondition", "bind completion timestamp."),
    _anno("BIND_PHASE_ANNO", "scheduler", (),
          ("scheduler (recover)", "plugin (gate)"),
          "committer uid precondition",
          "allocating/success/failed bind-phase state machine."),
    _anno("NODE_LOCK_ANNO", "scheduler", (), ("scheduler", "plugin"),
          "timestamped holder, stale-broken",
          "per-node annotation mutex: Bind takes it, Allocate releases "
          "it."),
    _anno("SCHED_GEN_ANNO", "scheduler",
          (("scheduler", "committer.py"), ("scheduler", "core.py"),
           ("scheduler", "migrate.py"), ("scheduler", "rebalancer.py"),
           ("ha", "*")),
          ("committer (fencing precondition)", "monitor (resize fencing)"),
          "IS the fencing token",
          "the leader's (per-group) fencing generation; rides every "
          "assignment commit so a deposed leader's patches are refused."),
    _anno("TASK_PRIORITY_ANNO", "user", (),
          ("scheduler (preemption tiers)", "plugin (CUDA_TASK_PRIORITY)"),
          "", "user-facing task priority; 0 = guaranteed, 1 = best "
          "effort (default)."),
    _anno("PREEMPTED_BY_ANNO", "scheduler",
          (("scheduler", "core.py"), ("scheduler", "preempt.py"),
           ("scheduler", "migrate.py")),
          ("scheduler (replay on promotion)", "monitor (launch block)"),
          "uid + leadership-generation preconditions",
          "durable phase-1 stamp of the two-phase evict, written on the "
          "victim before the delete."),
    _anno("HOST_MEM_ANNO", "user", (),
          ("scheduler (node-level fit)", "plugin (CUDA_HOST_MEMORY_LIMIT)"),
          "", "pod host-RAM quota in MB, synthesized by the webhook from "
          "nvidia.com/gpuhostmem or written directly."),
    _anno("NODE_HOST_MEM_ANNO", "plugin", (),
          ("scheduler (host-mem axis)",), "",
          "node schedulable host-RAM capacity in MB."),
    _anno("HBM_LIMIT_ANNO", "scheduler",
          (("scheduler", "rebalancer.py"), ("scheduler", "core.py")),
          ("monitor (checked apply + crash replay)",),
          "uid + generation preconditions; generation must grow",
          "the rebalancer's durable resize intent "
          "\"<gen>:<mb,..>;<mb,..>\"; the monitor applies it through the "
          "checked region API and replays it from vgpu.resize.json."),
    _anno("MIGRATION_CANDIDATE_ANNO", "scheduler",
          (("scheduler", "rebalancer.py"), ("scheduler", "migrate.py")),
          ("scheduler (victim preference, migration planner)",), "",
          "defragmentation mark; consumed by the preemption engine and "
          "the migration planner."),
    _anno("MIGRATING_TO_ANNO", "scheduler",
          (("scheduler", "core.py"), ("scheduler", "migrate.py"),
           ("util", "codec.py")),
          ("monitor (drain coordinator)", "scheduler (replay)"),
          "uid + group-generation preconditions",
          "durable phase-A stamp of drain->snapshot->reschedule->resume "
          "(\"<gen>:<node>;<cards>\")."),
    _anno("MIGRATED_FROM_ANNO", "scheduler",
          (("scheduler", "core.py"), ("scheduler", "migrate.py"),
           ("util", "codec.py")),
          ("monitor (source release)", "plugin (VTPU_MIGRATED_FROM)"),
          "uid + group-generation preconditions",
          "phase-B cutover record \"<gen>:<node>\" naming the source "
          "node; cleared when the destination region attaches."),
    _anno("MIGRATE_DEADLINE_ANNO", "scheduler",
          (("scheduler", "core.py"), ("scheduler", "migrate.py")),
          ("scheduler (rescue watchdog)",),
          "stamped beside migrating-to in the same fenced commit",
          "preempt-rescue deadline (epoch seconds)."),
    _anno("TRACE_ID_ANNO", "scheduler", (),
          ("all daemons (span stitch key)",), "",
          "end-to-end trace id, re-derivable from the pod UID."),
    _anno("USE_GPUTYPE_ANNO", "user", (), ("scheduler (type filter)",), "",
          "comma list of acceptable card types."),
    _anno("NOUSE_GPUTYPE_ANNO", "user", (), ("scheduler (type filter)",),
          "", "comma list of excluded card types."),
    _anno("NUMA_BIND_ANNO", "user", (), ("scheduler (NUMA filter)",), "",
          "a multi-card request takes cards of one NUMA node (F8)."),
    _anno("NODE_SLICE_ANNO", "plugin", (), ("scheduler (slice solver)",),
          "", "the host's slice membership (empty on a GPU node)."),
    _anno("SLICE_GROUP_ANNO", "user", (), ("scheduler (gang placement)",),
          "", "gang group name a multi-host member belongs to."),
    _anno("SLICE_HOSTS_ANNO", "user", (), ("scheduler (gang placement)",),
          "", "gang width: number of hosts the group spans."),
    _anno("SLICE_BLOCK_ANNO", "scheduler",
          (("scheduler", "core.py"), ("scheduler", "slice.py"),
           ("scheduler", "committer.py")),
          ("scheduler (SliceReservations rebuild)",
           "plugin (VTPU_MESH_* env)"),
          "committed with the member's assignment (uid precondition)",
          "the gang's solved host block \"<slice>;host0,host1,...\"."),
)

#: constant name -> AnnotationKey
ANNOTATION_BY_CONST = {a.const: a for a in ANNOTATIONS}

#: every string literal this registry owns (the VTPU019 allow-list)
WIRE_LITERALS = frozenset(
    {a.key for a in ANNOTATIONS}
    | {DOMAIN, NVIDIA_DOMAIN, TPU_DOMAIN, LEASE_NAME_DEFAULT}
    | set(RESOURCES))


# ---------------------------------------------------------------------------
# Env-knob registry
# ---------------------------------------------------------------------------

def _knobs(component: str, *rows: Tuple) -> Tuple[EnvKnob, ...]:
    return tuple(EnvKnob(getattr(api, row[0]), component, row[1],
                         row[2] if len(row) > 2 else True)
                 for row in rows)


ENV_KNOBS: Tuple[EnvKnob, ...] = (
    *_knobs(
        "plugin",
        ("ENV_NODE_NAME", "the node the agent runs on (downward API)",
         False),
        ("ENV_FAKE_NVML", "a JSON fixture of cards enumerated instead of "
                          "NVML", False),
        ("ENV_NVIDIA_SMI", "the nvidia-smi program read for NUMA "
                           "affinity"),
        ("ENV_ALLOCATE_BACKOFF_S", "Allocate retry backoff"),
        ("ENV_ALLOCATE_RETRIES", "Allocate retry budget"),
        ("ENV_CHECKPOINT_PATH", "allocation checkpoint path"),
        ("ENV_CHECKPOINT_TTL_S", "checkpoint staleness bound"),
        ("ENV_KUBELET_WATCH_S", "kubelet socket re-registration poll"),
        ("ENV_PLUGIN_HEALTH_BIND", "plugin health endpoint bind address"),
        ("ENV_PLUGIN_HEALTH_PORT", "plugin health endpoint port"),
        ("ENV_HEALTH_RECOVERY_S", "device health flap recovery window"),
        ("ENV_REGISTER_BACKOFF_S", "node-register retry backoff"),
        ("ENV_REGISTER_BACKOFF_CAP_S", "node-register backoff cap"),
        ("ENV_HOST_MEM_CAPACITY_MB",
         "schedulable host-RAM capacity override"),
        ("ENV_SOCKET_PROBE_TIMEOUT_S", "kubelet socket probe timeout"),
        ("ENV_RECONCILE_S", "plugin reconcile and scheduler assignment "
                            "sweep cadence"),
        ("ENV_SHIM_SO", "libvgpu.so source override for the shim dir",
         False),
        ("ENV_PRELOAD_SRC", "ld.so.preload source override", False),
        ("ENV_VALIDATOR_BIN", "vgpu-validator source override", False),
        ("ENV_API_TIMEOUT_S", "apiserver client timeout", False),
        ("ENV_KUBERNETES_SERVICE_HOST", "in-cluster apiserver host",
         False),
        ("ENV_KUBERNETES_SERVICE_PORT", "in-cluster apiserver port",
         False),
    ),
    *_knobs(
        "monitor",
        ("ENV_QUARANTINE_AFTER", "corrupt-region strikes before "
                                 "quarantine"),
        ("ENV_REGION_CHECKSUM", "header checksum verification toggle"),
        ("ENV_CORE_LIB", "libvgpucore.so path override", False),
        ("ENV_RESIZE_GRACE_S", "shrink-below-usage grace before block"),
        ("ENV_HOST_GRACE_S", "host-ledger overage grace before block"),
        ("ENV_SHIM_STALE_S", "stale libvgpu.so heartbeat bound"),
        ("ENV_MONITOR_PROFILE_EXPORT", "profile-plane export toggle"),
        ("ENV_MONITOR_LIST_FALLBACK_S", "pod-cache LIST fallback cadence",
         False),
        ("ENV_MONITOR_URL_TEMPLATE", "the /nodeinfo URL the scheduler "
                                     "reads"),
    ),
    *_knobs(
        "scheduler",
        ("ENV_DECIDE_SHARDS", "decide-state shard count"),
        ("ENV_DECIDE_LOCK_TIMEOUT_S", "bounded decide-lock acquire"),
        ("ENV_FILTER_BATCH", "batched-admission group size"),
        ("ENV_FILTER_BATCH_WINDOW_MS", "batch coalesce window"),
        ("ENV_FILTER_INTAKE", "tenant-fair intake queue depth"),
        ("ENV_FILTER_SHARD_SLOTS", "per-shard in-flight slots"),
        ("ENV_COMMIT_COALESCE", "same-node bind patch coalescing"),
        ("ENV_COMMIT_PIPELINE", "decision/commit split toggle", False),
        ("ENV_COMMIT_QUEUE", "commit queue depth", False),
        ("ENV_COMMIT_RETRIES", "commit retry budget", False),
        ("ENV_COMMIT_WORKERS", "commit worker count", False),
        ("ENV_EXECUTOR_WORKERS", "filter executor workers", False),
        ("ENV_FLUSH_TIMEOUT_S", "commit-queue flush bound", False),
        ("ENV_WEBHOOK_WORKERS", "webhook thread pool size"),
        ("ENV_HOST_MEM_MAX_MB", "cluster cap on a pod's host-memory "
                                "reservation"),
        ("ENV_MIGRATION_WRITERS", "service accounts allowed to write the "
                                  "migration annotations"),
        ("ENV_LEASE_NAME", "election Lease name"),
        ("ENV_LEASE_NAMESPACE", "election Lease namespace"),
        ("ENV_LEASE_EXPIRE_S", "lease expiry window"),
        ("ENV_SCHEDULER_ORDINAL", "this instance's stable ordinal"),
        ("ENV_SCHEDULER_PEERS", "fleet size for group fan-out"),
        ("ENV_POD_NAME", "the scheduler's identity (downward API)",
         False),
        ("ENV_SHARD_GROUPS", "shard-group (lease) count"),
        ("ENV_SHARD_KEY_LABEL", "pool label routing pods to groups"),
        ("ENV_READYZ_COMMIT_FAILURES",
         "commit failures a minute before not-ready"),
        ("ENV_OVERLAY_AUDIT_S", "overlay drift audit cadence", False),
        ("ENV_REBALANCE_S", "elastic-quota rebalancer cadence"),
        ("ENV_RESIZE_HEADROOM_PCT", "grow-on-pressure headroom cap"),
        ("ENV_PREEMPT_MAX_NODES", "victim-search node budget"),
        ("ENV_MIGRATE_S", "migration planner cadence"),
        ("ENV_MIGRATE_MAX_INFLIGHT", "concurrent live moves cap"),
        ("ENV_MIGRATE_DEADLINE_S", "preempt-rescue deadline"),
        ("ENV_LOCKDEBUG", "lock-order assertion plane", False),
    ),
    *_knobs(
        "gateway",
        ("ENV_GW_QUEUE", "per-model request queue depth"),
        ("ENV_GW_BATCH_MIN", "continuous-batching floor"),
        ("ENV_GW_BATCH_MAX", "continuous-batching ceiling"),
        ("ENV_GW_SLO_MS", "p99 inference SLO target"),
        ("ENV_GW_EWMA_ALPHA", "per-replica latency EWMA weight"),
        ("ENV_GW_AUTOSCALE_S", "autoscaler poll cadence"),
        ("ENV_GW_HEADROOM", "scale-up pressure headroom"),
        ("ENV_GW_IDLE_ROUNDS", "scale-down idle rounds"),
        ("ENV_GW_MIN_REPLICAS", "replica floor"),
        ("ENV_GW_MAX_REPLICAS", "replica ceiling"),
    ),
    *_knobs(
        "observability",
        ("ENV_LOG_FORMAT", "text|json structured logging"),
        ("ENV_TRACE_SPANS", "span emission toggle"),
        ("ENV_TRACE_RING", "per-process span ring size"),
        ("ENV_TRACE_JOURNAL", "span journal path"),
        ("ENV_TRACE_JOURNAL_MAX_KB", "journal rotation bound"),
    ),
    # written by Allocate, read by libvgpu.so's load_config (libvgpu.c)
    # and vtpu_torch/enforce/workload.py
    *_knobs(
        "shim",
        ("ENV_DEVICE_MEMORY_LIMIT",
         "per-visible-device memory cap (indexed _0.._N forms per card)"),
        ("ENV_SM_LIMIT",
         "per-card SM-percent launch limit (indexed forms per card)"),
        ("ENV_HOST_MEMORY_LIMIT", "pinned host-memory cap in bytes"),
        ("ENV_SHARED_CACHE", "the container's shared-region file"),
        ("ENV_TASK_PRIORITY", "throttle tier under contention"),
        ("ENV_CORE_UTILIZATION_POLICY", "SM throttle policy"),
        ("ENV_DISABLE_CONTROL", "enforcement kill switch"),
        ("ENV_LOG_LEVEL", "interposer log verbosity"),
        ("ENV_ACTIVE_OOM_KILLER", "kill instead of refusing at the "
                                  "quota"),
        ("ENV_LOCK_DIR", "the node's interposer lock directory", False),
        ("ENV_VISIBLE_DEVICES", "device visibility list", False),
        ("ENV_NVIDIA_VISIBLE_DEVICES", "the cards the container runtime "
                                       "exposes", False),
        ("ENV_NVIDIA_DRIVER_CAPABILITIES", "the driver libraries the "
                                           "container runtime mounts",
         False),
        ("ENV_PROFILE", "callsite profile toggle"),
        ("ENV_PROFILE_SAMPLE", "profile sampling stride"),
        ("ENV_LICENSE_SECRET", "vgpu-validator's HMAC secret", False),
        ("ENV_LICENSE_SECRET_FILE", "file holding that secret", False),
        ("ENV_LICENSE_NODE", "node name matched against the license",
         False),
    ),
    *_knobs(
        "workload",
        ("ENV_MESH_SHAPE", "solved sub-mesh shape \"x,y,z\""),
        ("ENV_MESH_AXES", "mesh axis names"),
        ("ENV_MESH_COORDS", "this member's mesh coordinates"),
        ("ENV_MIGRATED_FROM", "resume-from-snapshot marker Allocate "
                              "injects", False),
    ),
    *_knobs(
        "bench",
        ("ENV_PARITY_MIN", "shim/native throughput parity floor"),
        ("ENV_PARITY_P50X", "execute p50 speedup floor"),
        ("ENV_SOAK_S", "soak duration"),
        ("ENV_SOAK_P99_SLO_MS", "soak p99 admission SLO"),
        ("ENV_MIGRATE_BLACKOUT_P99_MS", "soak blackout p99 gate"),
        ("ENV_BENCH_BACKEND", "card|mock backend pick", False),
        ("ENV_BENCH_CHILD", "marks a bench child process", False),
        ("ENV_BENCH_QUOTA", "a shim child's device-memory quota", False),
        ("ENV_BENCH_SHIM_FIRST", "shim rep first in interleaved pairs",
         False),
    ),
)

ENV_KNOB_BY_NAME = {k.name: k for k in ENV_KNOBS}


# ---------------------------------------------------------------------------
# Durable node files
# ---------------------------------------------------------------------------

DURABLE_FILES: Tuple[DurableFile, ...] = (
    DurableFile(
        "allocations.ckpt.json", "plugin",
        ("plugin checkpoint (atomicio)",), ("plugin (restart recovery)",),
        "TTL-bounded (VTPU_CHECKPOINT_TTL_S); atomic replace only",
        "the device plugin's allocation checkpoint: survives a plugin "
        "SIGKILL between kubelet Allocate and pod start."),
    DurableFile(
        api.RESIZE_RECORD, "monitor",
        ("monitor ResizeApplier (atomicio intent record)",),
        ("monitor (crash replay)",),
        "resize generation monotonic; replayed exactly-once",
        "the two-phase resize intent, recorded before the checked region "
        "apply."),
    DurableFile(
        api.DRAIN_REQUEST_FILE, "monitor",
        ("monitor DrainCoordinator (atomicio)",),
        ("workload (cooperative snapshot)", "monitor (replay)"),
        "carries the migration generation from the stamp",
        "the drain coordinator's crash-replayable request record."),
    DurableFile(
        api.DRAIN_ACK_FILE, "workload",
        ("workload drain_ack API (vtpu_torch/enforce)",),
        ("monitor (cutover release)",),
        "echoes the request generation",
        "the workload's durable answer: snapshot bytes accounted, safe to "
        "cut over."),
    DurableFile(
        api.QUARANTINE_MARKER, "monitor",
        ("monitor path-monitor (atomicio)",),
        ("monitor", "plugin (region skip)"),
        "strike-counted (VTPU_QUARANTINE_AFTER)",
        "corrupt-region quarantine marker."),
    DurableFile(
        api.HOSTGUARD_RECORD, "monitor",
        ("monitor HostLedgerGuard (atomicio)",),
        ("monitor (restart replay)",),
        "grace deadline persisted with the block decision",
        "host-ledger overage state (grace, block, release) surviving a "
        "monitor restart."),
)

DURABLE_FILE_BY_NAME = {f.name: f for f in DURABLE_FILES}


# ---------------------------------------------------------------------------
# Fenced protocols and their crash edges: the port runs the JAX protocols
# (vtpu/contracts.py:274-414), so the edges are the same
# ---------------------------------------------------------------------------

#: why an edge has no port test: its JAX kill point is the tier-1 run's
#: ``slow`` set, or writes the JAX region's file names
#: (tests/test_torch_ha.py LEFT_OUT)
_SLOW = ("its JAX kill point is marked slow; tests/test_torch_ha.py "
         "replays only the fast kill points")
_MONITOR_FILES = ("its JAX kill point writes the JAX region's file names "
                  "(vtpu.cache, vtpu.*.json); the port's monitor reads "
                  "vgpu.*, so tests/test_torch_ha.py leaves it out")

PROTOCOLS: Tuple[FencedProtocol, ...] = (
    FencedProtocol(
        "commit", "Decision/commit/bind pipeline", ("scheduler", "plugin"),
        "uid + scheduler/group generation preconditions on every patch",
        ("decided", "queued", "patched", "bound"),
        (
            CrashEdge("kill-mid-gang",
                      "leader SIGKILL between gang members' commits",
                      "promotion completes or unwinds the block"),
            CrashEdge("kill-mid-queue-drain",
                      "leader SIGKILL mid commit-queue drain",
                      "stragglers re-filter on the successor"),
            CrashEdge("deposed-inflight-commit",
                      "deposed leader's in-flight commit reaches the "
                      "apiserver after the new leader is active",
                      "generation precondition refuses the patch"),
            CrashEdge("deposed-mid-bind",
                      "leadership lost between patch and bind",
                      "nothing durable is half-written"),
            CrashEdge("kill-during-bind-flush",
                      "leader SIGKILL during the bind flush",
                      "members rebind on the successor exactly once"),
            CrashEdge("double-failover",
                      "two consecutive leader kills (A->B->C)",
                      "every shard repopulates; zero double-booked cards",
                      waiver=_SLOW),
        ),
        "docs/ha.md"),
    FencedProtocol(
        "resize", "Elastic-quota live resize",
        ("scheduler", "monitor", "shim"),
        "annotation gen monotonic + uid precondition; monitor intent "
        "record replayed exactly-once",
        ("marked", "intent-stamped", "recorded", "applied", "confirmed"),
        (
            CrashEdge("kill-between-intent-and-apply",
                      "monitor SIGKILL after the durable intent record, "
                      "before the checked region apply",
                      "restart replays the apply exactly once",
                      waiver=_MONITOR_FILES),
            CrashEdge("kill-mid-block",
                      "monitor SIGKILL while a shrink-below-usage block "
                      "is in force",
                      "the block survives restart until usage complies",
                      waiver=_MONITOR_FILES),
            CrashEdge("deposed-intent",
                      "deposed leader emits a resize intent",
                      "the commit precondition refuses it"),
            CrashEdge("stale-generation",
                      "an older-generation intent arrives after a newer "
                      "apply", "never rewinds: generation must grow",
                      waiver=_MONITOR_FILES),
            CrashEdge("garbled-intent",
                      "corrupt/garbled intent annotation",
                      "refused once, never wedges the protocol",
                      waiver=_MONITOR_FILES),
            CrashEdge("failover-mid-rebalance",
                      "leader failover mid rebalancer pass",
                      "successor recomputes; no double-apply",
                      waiver=_SLOW),
        ),
        "docs/elastic-quotas.md"),
    FencedProtocol(
        "evict", "Two-phase priority preemption",
        ("scheduler", "monitor"),
        "durable preempted-by stamp (uid + generation) precedes the "
        "delete",
        ("planned", "stamped", "deleted", "completed"),
        (
            CrashEdge("kill-before-stamp",
                      "leader SIGKILL before the phase-1 stamp",
                      "victim untouched; successor re-preempts"),
            CrashEdge("kill-between-stamp-and-delete",
                      "leader SIGKILL between stamp and delete",
                      "promotion replays the delete exactly once"),
            CrashEdge("deposed-leader-stamp",
                      "paused/deposed leader attempts the protocol",
                      "fenced out; the standby preempts instead"),
            CrashEdge("abandoned-gang-unwind",
                      "gang preempts then the incoming gang abandons",
                      "stamps unwind cleanly; victims keep running"),
        ),
        "docs/multihost.md"),
    FencedProtocol(
        "migrate", "Transparent live migration",
        ("scheduler", "monitor", "workload"),
        "migrating-to stamp carries uid + group generation; every later "
        "phase preconditions on it",
        ("marked", "reserved", "stamped", "draining", "snapshotted",
         "cutover", "released"),
        (
            CrashEdge("kill-before-stamp",
                      "owner SIGKILL before the phase-A stamp",
                      "no trace: reservation unwinds, pod untouched"),
            CrashEdge("kill-after-stamp",
                      "owner SIGKILL after the durable stamp",
                      "absorption replays the move exactly once"),
            CrashEdge("kill-after-snapshot",
                      "owner SIGKILL after the workload snapshot",
                      "successor cuts over exactly once"),
            CrashEdge("kill-after-cutover-before-release",
                      "owner SIGKILL between cutover and source release",
                      "replay releases the source; nothing re-moves"),
            CrashEdge("monitor-kill-after-drain-intent",
                      "monitor SIGKILL after the drain request record",
                      "restart replays the drain from the sidecar",
                      waiver=_MONITOR_FILES),
            CrashEdge("rescue-deadline-expiry",
                      "preempt-rescue deadline expires mid-move",
                      "watchdog falls back to the phase-2 delete once"),
        ),
        "docs/migration.md"),
    FencedProtocol(
        "group-lease", "Per-shard-group lease handoff/absorption",
        ("scheduler",),
        "per-group fencing generation bumps on every ownership change",
        ("acquired", "rebuilt", "admitted", "active"),
        (
            CrashEdge("owner-kill-mid-burst",
                      "arbitrary owner SIGKILL mid admission burst",
                      "a survivor absorbs the groups with fencing"),
            CrashEdge("kill-mid-evict-absorption",
                      "owner SIGKILL mid two-phase evict; another "
                      "instance absorbs the group",
                      "scoped recover replays the delete exactly once"),
            CrashEdge("handoff-vs-queued-commit",
                      "group handed off while a commit for it is queued "
                      "on the old owner",
                      "the absorbed group's queued commit is fenced"),
            CrashEdge("handoff-mid-resize",
                      "group handoff mid resize-intent emission",
                      "stale group generation is fenced at the wire"),
            CrashEdge("lease-split-rejoin",
                      "lease-table partition splits and rejoins",
                      "unique owner per group holds throughout"),
        ),
        "docs/ha.md"),
)

#: every declared "protocol:edge" id
ALL_EDGE_IDS = frozenset(eid for p in PROTOCOLS for eid in p.edge_ids())


def covers_edge(*edge_ids: str):
    """Mark a test as exercising declared protocol crash edges. A
    pass-through at run time (it only tags the function); the lint reads
    the tags statically (VTPU023)."""
    def deco(fn):
        fn._vgpu_kill_edges = tuple(
            getattr(fn, "_vgpu_kill_edges", ())) + edge_ids
        return fn
    return deco


# ---------------------------------------------------------------------------
# Declarative guarded-by / confined-to rules (vtpu/contracts.py:444-714,
# at the port's sites)
# ---------------------------------------------------------------------------

#: scheduler-state mutators guarded by the decide-lock convention
STATE_ATTRS = ("pods", "overlay", "slices")
STATE_MUTATORS = (
    "add_pod", "del_pod", "replace_all", "clear", "add_usage",
    "remove_usage", "apply_delta", "reset_usage", "reset_inventory",
    "set_node_inventory", "drop_node_inventory", "confirm_placed",
    "release_pod", "invalidate", "reconcile", "rebuild",
)
#: SliceReservations mutators (node_for assigns a slot, so it mutates)
GANG_MUTATORS = ("node_for", "confirm_placed", "release_pod",
                 "invalidate", "reconcile", "rebuild")
#: container mutators that rewrite a shard scoreboard in place
BOARD_MUTATORS = ("pop", "popitem", "clear", "move_to_end",
                  "setdefault", "update")

_PREEMPT_CONFINE = (
    "preemption mutator {name}(...) outside "
    "vtpu_torch/scheduler/{{core,preempt}}.py: victim search and the "
    "two-phase evict run only on the decide-locked, leader-gated "
    "preemption path")
_PREEMPT_GUARD = (
    "call to {name}(...) outside the shard-lock convention: the victim "
    "search reads the overlay and retracts victims under the owning "
    "decide lock(s) (shard.lock / route.lockset / self._decide_lock, or "
    "a *_locked caller)")

GUARD_RULES: Tuple[GuardRule, ...] = (
    GuardRule(
        rule="VTPU002", methods=STATE_MUTATORS,
        receiver_self_attrs=STATE_ATTRS, guarded_by="decide",
        guard_message=(
            "mutation self.{recv}.{name}(...) outside the decide lock and "
            "not in a *_locked function: concurrent filters can "
            "double-book cards against the intermediate state")),
    GuardRule(
        rule="VTPU008", methods=GANG_MUTATORS,
        receiver_names=("slices", "_slices"),
        confined_to=(("scheduler", "core.py"), ("scheduler", "slice.py"),
                     ("scheduler", "preempt.py")),
        confine_message=(
            "gang-state mutation {recv}.{name}(...) outside the "
            "leader-gated decide path: only vtpu_torch/scheduler/core.py "
            "and slice.py may mutate SliceReservations")),
    GuardRule(
        rule="VTPU010", suffix="_shard_locked", guarded_by="shard",
        guard_message=(
            "call to {name}(...) outside the shard-lock convention: "
            "`*_shard_locked` methods require the owning shard's lock")),
    GuardRule(
        rule="VTPU010", methods=BOARD_MUTATORS, receiver_attr="boards",
        guarded_by="shard",
        guard_message=(
            "scoreboard mutation ...boards.{name}(...) outside the "
            "shard-lock convention")),
    GuardRule(
        rule="VTPU012", suffix="_batch_locked", guarded_by="batch",
        guard_message=(
            "call to {name}(...) outside the owning-lock convention: "
            "`*_batch_locked` helpers require their shard lock, "
            "route.lockset, self._decide_lock, or the committer's "
            "self._lock / self._cond")),
    GuardRule(
        rule="VTPU013",
        methods=("set_hbm_limit", "set_limit_checked",
                 "set_utilization_switch"),
        confined_to=(("monitor", "*"), ("enforce", "region.py")),
        confine_message=(
            "region write {name}(...) outside vtpu_torch/monitor/: live "
            "memory limits and the utilization switch are written only by "
            "the monitor's apply paths (ResizeApplier / FeedbackLoop)")),
    GuardRule(
        rule="VTPU014",
        methods=("set_host_limit_checked", "configure_host",
                 "host_try_alloc", "host_force_alloc", "host_free"),
        confined_to=(("monitor", "*"), ("enforce", "*")),
        confine_message=(
            "host-ledger write {name}(...) outside vtpu_torch/enforce/ and "
            "vtpu_torch/monitor/: the host ledger is mutated only by "
            "libvgpu.so's charge path and the checked region APIs")),
    GuardRule(
        rule="VTPU015", methods=("plan_locked", "victims_for_node_locked"),
        receiver_contains="preempt",
        confined_to=(("scheduler", "core.py"), ("scheduler", "preempt.py")),
        guarded_by="shard", guard_suffix="_locked",
        confine_message=_PREEMPT_CONFINE, guard_message=_PREEMPT_GUARD),
    GuardRule(
        rule="VTPU015",
        methods=("_preempt_fit_locked", "preempt_fit_locked",
                 "_complete_eviction", "complete_eviction"),
        confined_to=(("scheduler", "core.py"), ("scheduler", "preempt.py")),
        guarded_by="shard", guard_suffix="_locked",
        confine_message=_PREEMPT_CONFINE, guard_message=_PREEMPT_GUARD),
    GuardRule(
        rule="VTPU016",
        methods=("add_replica_locked", "remove_replica_locked"),
        confined_to=(("gateway", "autoscaler.py"),), guarded_by="shard",
        confine_message=(
            "replica-set mutator {name}(...) outside "
            "vtpu_torch/gateway/autoscaler.py: fleet membership changes "
            "only on the autoscaler's locked, leader-gated path"),
        guard_message=(
            "call to {name}(...) outside the lock convention: ReplicaSet "
            "membership writes require ReplicaSet.lock held")),
    GuardRule(
        rule="VTPU017", methods=("_admit_group", "_drop_group"),
        bare_name=True, confined_to=(("ha", "*"),),
        confine_message=(
            "group transition {name}(...) outside vtpu_torch/ha/: "
            "admit/drop runs only on the GroupCoordinator's lease-checked "
            "poll path or take_over")),
    GuardRule(
        rule="VTPU017", methods=("take_over",), bare_name=True,
        confined_to=(("ha", "*"), ("scheduler", "core.py")),
        forbid_guard="shard",
        confine_message=(
            "take_over(...) outside vtpu_torch/ha/ or scheduler core"),
        guard_message=(
            "take_over(...) under the shard-lock convention: its scoped "
            "recover takes every shard lock itself and self-deadlocks "
            "from here")),
    # the port's entry point is vtpu_torch/scheduler/__main__.py (the JAX
    # package's cmd/scheduler.py)
    GuardRule(
        rule="VTPU017", methods=("recover",), bare_name=True,
        requires_kwarg="groups",
        confined_to=(("ha", "*"), ("scheduler", "core.py"),
                     ("scheduler", "__main__.py")),
        confine_message=(
            "group-scoped recover(groups=...) outside the absorption "
            "path: scoped replay runs only from scheduler core or the "
            "entry point's on_acquire hook "
            "(vtpu_torch/scheduler/__main__.py)")),
    GuardRule(
        rule="VTPU018",
        methods=("encode_migrating_to", "encode_migrated_from"),
        bare_name=True,
        confined_to=(("scheduler", "core.py"), ("scheduler", "migrate.py"),
                     ("*", "codec.py")),
        confine_message=(
            "migration stamp encoder {name}(...) outside "
            "vtpu_torch/scheduler/{{core,migrate}}.py: the stamps "
            "authorize a destination attach and are minted only on the "
            "fenced decide paths")),
)

STORE_RULES: Tuple[StoreRule, ...] = (
    StoreRule(
        rule="VTPU010", subscript_of=("boards",), guarded_by="shard",
        message=("scoreboard store ...boards[...] = ... outside the "
                 "shard-lock convention")),
    StoreRule(
        rule="VTPU017", attr_targets=("_owned", "_holders"),
        confined_to=(("ha", "*"),),
        message=("ownership store ...{attr} = ... outside "
                 "vtpu_torch/ha/")),
    StoreRule(
        rule="VTPU017", subscript_of=("_owned", "_holders"),
        confined_to=(("ha", "*"),),
        message=("ownership store ...{attr}[...] = ... outside "
                 "vtpu_torch/ha/")),
)
