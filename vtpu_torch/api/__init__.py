"""The port's wire vocabulary: container env, node-agent knobs, annotation
keys and resource names.

The container env is the counterpart of vtpu/api/__init__.py:12-95 under the
reference's own CUDA names (pkg/api/types.go:19-22; the Allocate env of
pkg/device-plugin/nvidiadevice/nvinternal/plugin/server.go:336-358). The
device plugin (vtpu_torch/plugin/server.py) produces it; the interposer
vtpu_torch/csrc/libvgpu.c (load_config) and vtpu_torch/enforce/workload.py
(quota_from_env) consume it, and must agree on every name below.

The annotation keys and resource names are the counterpart of
vtpu/contracts.py:45-112: the assignment bus is shared with the TPU vendor
(one scheduler serves both), the node handshake and the resource names are
NVIDIA's own.
"""

# which cards the container may see (indices or GPU UUIDs, comma-separated),
# as CUDA reads it inside the container
ENV_VISIBLE_DEVICES = "CUDA_VISIBLE_DEVICES"

# the assigned cards' UUIDs, set by Allocate (reference server.go:405-434);
# read by nvidia-container-runtime, which exposes exactly those cards to the
# container (as ordinals 0..n-1), and by vtpu_torch/plugin/runtime.py, which
# stands in for it where there is no container
ENV_NVIDIA_VISIBLE_DEVICES = "NVIDIA_VISIBLE_DEVICES"
# the driver libraries nvidia-container-runtime mounts into a container;
# the chart's node agents ask for "utility" (NVML, nvidia-smi) on every
# card (deploy/helm/vgpu), and create no CUDA context
ENV_NVIDIA_DRIVER_CAPABILITIES = "NVIDIA_DRIVER_CAPABILITIES"

# device-memory cap, per visible device index ("%s_%d" per-device form
# first, the bare form as the default for all); "3g" / "512m" / bytes
ENV_DEVICE_MEMORY_LIMIT = "CUDA_DEVICE_MEMORY_LIMIT"

# SM-percent launch limit, per visible device index with the same
# per-index convention; enforced by libvgpu.so's per-device token buckets
ENV_SM_LIMIT = "CUDA_DEVICE_SM_LIMIT"

# host-memory cap in bytes for the region's v8 host ledger; absent/0 =
# unlimited
ENV_HOST_MEMORY_LIMIT = "CUDA_HOST_MEMORY_LIMIT"

# mmap'd shared-region file, one per container
ENV_SHARED_CACHE = "CUDA_DEVICE_MEMORY_SHARED_CACHE"

# task priority consumed by the interposer + monitor feedback loop
ENV_TASK_PRIORITY = "CUDA_TASK_PRIORITY"

# "default" | "force" | "disable" — utilization-policy switch
ENV_CORE_UTILIZATION_POLICY = "GPU_CORE_UTILIZATION_POLICY"

# presence disables all enforcement (reference server.go:371-378)
ENV_DISABLE_CONTROL = "CUDA_DISABLE_CONTROL"

# interposer log level 0..4
ENV_LOG_LEVEL = "LIBCUDA_LOG_LEVEL"

# kill the allocating process instead of returning an OOM error
ENV_ACTIVE_OOM_KILLER = "ACTIVE_OOM_KILLER"

CORE_UTIL_POLICY_DEFAULT = "default"
CORE_UTIL_POLICY_FORCE = "force"
CORE_UTIL_POLICY_DISABLE = "disable"

# canonical in-container paths (reference: /usr/local/vgpu/*,
# plugin/server.go:347,360-383)
CONTAINER_LIB_DIR = "/usr/local/vgpu"
CONTAINER_SHIM_PATH = "/usr/local/vgpu/libvgpu.so"
CONTAINER_CACHE_DIR = "/usr/local/vgpu/containers"
LD_SO_PRELOAD_PATH = "/etc/ld.so.preload"
# the host's license file, mounted when the shim host dir carries one, and
# a validator binary beside it (vtpu/plugin/server.py:835-851)
CONTAINER_LICENSE_PATH = "/vgpu/license"
CONTAINER_VALIDATOR_PATH = "/usr/bin/vgpu-validator"
# the validator's product name and its env (vtpu_torch/csrc/validator.c;
# the JAX validator's VTPU_LICENSE_* under the GPU product's names): the
# HMAC secret, or a file holding it (never inside the mounted license dir),
# and the node name matched against the license's nodes= glob in place of
# the hostname
LICENSE_PRODUCT = "vgpu"
ENV_LICENSE_SECRET = "VGPU_LICENSE_SECRET"
ENV_LICENSE_SECRET_FILE = "VGPU_LICENSE_SECRET_FILE"
ENV_LICENSE_NODE = "VGPU_LICENSE_NODE"
LICENSE_SECRET_FILE_DEFAULT = "/etc/vgpu/license.secret"
# lock directory the interposer shares between a node's containers
# (mounted by Allocate at the same path inside and out)
LOCK_DIR = "/tmp/vgpulock"
# where libvgpu.so takes that lock when it is not LOCK_DIR (a test's own
# directory); the interposer serialises its processes' first contexts on a
# card there, to tell its own NVML process entry from its neighbours'
ENV_LOCK_DIR = "VGPU_LOCK_DIR"

# mesh env of a slice-gang member and the source node of a migrated pod
# (vtpu/api/__init__.py:60-82, same names): set by Allocate from the pod's
# slice-block and migrated-from annotations, read by the workload
ENV_MESH_SHAPE = "VTPU_MESH_SHAPE"
ENV_MESH_COORDS = "VTPU_MESH_COORDS"
ENV_MESH_AXES = "VTPU_MESH_AXES"
ENV_MIGRATED_FROM = "VTPU_MIGRATED_FROM"

# --------------------------------------------------------------------------
# Node-agent knobs (the device plugin's own env; same names as the JAX
# package's plugin, so one deployment's values serve both vendors)
# --------------------------------------------------------------------------

# path of a JSON fixture of cards; when set, vtpu_torch.plugin.nvml.detect()
# enumerates it (FakeNvmlLib) instead of NVML. Also read by the mock
# libnvidia-ml.so.1 (vtpu_torch/csrc/mock_nvml.c).
ENV_FAKE_NVML = "VGPU_FAKE_NVML"
# plugin/nvml.py: the nvidia-smi program whose "topo -m" matrix names each
# card's NUMA node where NVML reports no PCI bus id (default "nvidia-smi")
ENV_NVIDIA_SMI = "VGPU_NVIDIA_SMI"
# node name (the plugin's --node-name default; set by the DaemonSet)
ENV_NODE_NAME = "NODE_NAME"
# plugin/server.py: kubelet registration backoff, kubelet.sock watch period,
# the live-socket probe, Allocate's pending-pod lookup and the reconcile loop
ENV_REGISTER_BACKOFF_S = "VTPU_REGISTER_BACKOFF_S"
ENV_REGISTER_BACKOFF_CAP_S = "VTPU_REGISTER_BACKOFF_CAP_S"
ENV_KUBELET_WATCH_S = "VTPU_KUBELET_WATCH_S"
ENV_SOCKET_PROBE_TIMEOUT_S = "VTPU_SOCKET_PROBE_TIMEOUT_S"
ENV_ALLOCATE_RETRIES = "VTPU_ALLOCATE_RETRIES"
ENV_ALLOCATE_BACKOFF_S = "VTPU_ALLOCATE_BACKOFF_S"
ENV_RECONCILE_S = "VTPU_RECONCILE_S"
# plugin/server.py install_shim_artifacts: overrides of the artifacts it
# copies into the shim host dir
ENV_SHIM_SO = "VGPU_SHIM_SO"
ENV_PRELOAD_SRC = "VGPU_PRELOAD_SRC"
ENV_VALIDATOR_BIN = "VGPU_VALIDATOR_BIN"
# plugin/checkpoint.py: the allocation checkpoint's path and record TTL
ENV_CHECKPOINT_PATH = "VTPU_CHECKPOINT_PATH"
ENV_CHECKPOINT_TTL_S = "VTPU_CHECKPOINT_TTL_S"
# plugin/__main__.py: health-tracking recovery window, /healthz port and bind
ENV_HEALTH_RECOVERY_S = "VTPU_HEALTH_RECOVERY_S"
ENV_PLUGIN_HEALTH_PORT = "VTPU_PLUGIN_HEALTH_PORT"
ENV_PLUGIN_HEALTH_BIND = "VTPU_PLUGIN_HEALTH_BIND"
# plugin/register.py: host-memory capacity override
ENV_HOST_MEM_CAPACITY_MB = "VTPU_HOST_MEM_CAPACITY_MB"
# util/client.py: apiserver request timeout and in-cluster discovery
ENV_API_TIMEOUT_S = "VTPU_API_TIMEOUT_S"
ENV_KUBERNETES_SERVICE_HOST = "KUBERNETES_SERVICE_HOST"
ENV_KUBERNETES_SERVICE_PORT = "KUBERNETES_SERVICE_PORT"

# --------------------------------------------------------------------------
# Scheduler knobs (vtpu_torch/scheduler; the JAX scheduler's names, so one
# deployment's values serve both vendors)
# --------------------------------------------------------------------------

#: the scheduler's component name (vtpu/contracts.py:71): pods name it in
#: spec.schedulerName, which the webhook sets; it fills the same
#: deployment role as the JAX package's scheduler
SCHEDULER_NAME = "vtpu-scheduler"
# scheduler/shard.py: decide-plane shards, multi-active shard groups (1
# without HA) and the node label whose value pools nodes into one shard
ENV_DECIDE_SHARDS = "VTPU_DECIDE_SHARDS"
ENV_SHARD_GROUPS = "VTPU_SHARD_GROUPS"
ENV_SHARD_KEY_LABEL = "VTPU_SHARD_KEY_LABEL"
# scheduler/core.py: bounded decide-lock wait on the commit-failure path,
# "0" commits inline instead of through the pipeline, the opt-in overlay
# audit period, the commit failures a minute before /readyz fails, and
# the deadline of a migrate-instead-of-delete rescue
ENV_DECIDE_LOCK_TIMEOUT_S = "VTPU_DECIDE_LOCK_TIMEOUT_S"
ENV_COMMIT_PIPELINE = "VTPU_COMMIT_PIPELINE"
ENV_OVERLAY_AUDIT_S = "VTPU_OVERLAY_AUDIT_S"
ENV_READYZ_COMMIT_FAILURES = "VTPU_READYZ_COMMIT_FAILURES"
ENV_MIGRATE_DEADLINE_S = "VTPU_MIGRATE_DEADLINE_S"
# scheduler/committer.py: workers, queue bound, retries, same-node patches
# merged into one write, and bind's flush-barrier timeout
ENV_COMMIT_WORKERS = "VTPU_COMMIT_WORKERS"
ENV_COMMIT_QUEUE = "VTPU_COMMIT_QUEUE"
ENV_COMMIT_RETRIES = "VTPU_COMMIT_RETRIES"
ENV_COMMIT_COALESCE = "VTPU_COMMIT_COALESCE"
ENV_FLUSH_TIMEOUT_S = "VTPU_FLUSH_TIMEOUT_S"
# scheduler/preempt.py: candidate nodes a preemption search visits
ENV_PREEMPT_MAX_NODES = "VTPU_PREEMPT_MAX_NODES"
# scheduler/webhook.py: the cluster cap on a pod's host-memory reservation
# and the service accounts allowed to write the migration annotations
ENV_HOST_MEM_MAX_MB = "VTPU_HOST_MEM_MAX_MB"
ENV_MIGRATION_WRITERS = "VTPU_MIGRATION_WRITERS"
# scheduler/routes.py: executor sizes, the per-shard slot gate, and the
# /filter intake's batch size, gather window and bound
ENV_EXECUTOR_WORKERS = "VTPU_EXECUTOR_WORKERS"
ENV_WEBHOOK_WORKERS = "VTPU_WEBHOOK_WORKERS"
ENV_FILTER_SHARD_SLOTS = "VTPU_FILTER_SHARD_SLOTS"
ENV_FILTER_BATCH = "VTPU_FILTER_BATCH"
ENV_FILTER_BATCH_WINDOW_MS = "VTPU_FILTER_BATCH_WINDOW_MS"
ENV_FILTER_INTAKE = "VTPU_FILTER_INTAKE"
# scheduler/__main__.py: the rebalancer's and the migration planner's
# periods (0 = off)
ENV_REBALANCE_S = "VTPU_REBALANCE_S"
ENV_MIGRATE_S = "VTPU_MIGRATE_S"
# scheduler/migrate.py: moves in flight at once
ENV_MIGRATE_MAX_INFLIGHT = "VTPU_MIGRATE_MAX_INFLIGHT"
# scheduler/rebalancer.py: the headroom a resized quota keeps above usage,
# and the URL of a node monitor's /nodeinfo ("{node}" is the node's name)
ENV_RESIZE_HEADROOM_PCT = "VTPU_RESIZE_HEADROOM_PCT"
ENV_MONITOR_URL_TEMPLATE = "VTPU_MONITOR_URL_TEMPLATE"

#: the leadership lease's default name (vtpu/contracts.py:73); a
#: multi-active group's lease is this name with "-g<NN>" appended
LEASE_NAME_DEFAULT = SCHEDULER_NAME
# ha/ and scheduler/__main__.py --ha: the lease's name, namespace and
# expiry, the peers that share the shard groups, this instance's ordinal
# among them (-1 = derived from its identity) and the identity itself
ENV_LEASE_NAME = "VTPU_LEASE_NAME"
ENV_LEASE_NAMESPACE = "VTPU_LEASE_NAMESPACE"
ENV_LEASE_EXPIRE_S = "VTPU_LEASE_EXPIRE_S"
ENV_SCHEDULER_PEERS = "VTPU_SCHEDULER_PEERS"
ENV_SCHEDULER_ORDINAL = "VTPU_SCHEDULER_ORDINAL"
ENV_POD_NAME = "POD_NAME"

# --------------------------------------------------------------------------
# Serving-gateway knobs (vtpu_torch/gateway; the JAX gateway's names,
# vtpu/contracts.py:560-569)
# --------------------------------------------------------------------------

# gateway/batcher.py: the per-model queue bound, the continuous batch's
# floor and ceiling, the p99 SLO in ms and the step-latency EWMA's weight
ENV_GW_QUEUE = "VTPU_GW_QUEUE"
ENV_GW_BATCH_MIN = "VTPU_GW_BATCH_MIN"
ENV_GW_BATCH_MAX = "VTPU_GW_BATCH_MAX"
ENV_GW_SLO_MS = "VTPU_GW_SLO_MS"
ENV_GW_EWMA_ALPHA = "VTPU_GW_EWMA_ALPHA"
# gateway/autoscaler.py: its poll period, the scale-up headroom under the
# SLO, the idle polls before a scale-down, and the replica floor/ceiling
ENV_GW_AUTOSCALE_S = "VTPU_GW_AUTOSCALE_S"
ENV_GW_HEADROOM = "VTPU_GW_HEADROOM"
ENV_GW_IDLE_ROUNDS = "VTPU_GW_IDLE_ROUNDS"
ENV_GW_MIN_REPLICAS = "VTPU_GW_MIN_REPLICAS"
ENV_GW_MAX_REPLICAS = "VTPU_GW_MAX_REPLICAS"

# --------------------------------------------------------------------------
# Soak knobs (vtpu_torch/bench/soak.py; the JAX soak's names,
# vtpu/contracts.py:625-627)
# --------------------------------------------------------------------------

# the chaos soak's length in seconds and its p99 admission-latency SLO in
# ms; the migrate leg's blackout p99 gate in ms
ENV_SOAK_S = "VTPU_SOAK_S"
ENV_SOAK_P99_SLO_MS = "VTPU_SOAK_P99_SLO_MS"
ENV_MIGRATE_BLACKOUT_P99_MS = "VTPU_MIGRATE_BLACKOUT_P99_MS"

# --------------------------------------------------------------------------
# Node-monitor knobs (vtpu_torch/monitor; the JAX monitor's names, so one
# deployment's values serve both vendors)
# --------------------------------------------------------------------------

# monitor/pathmonitor.py: consecutive corrupt sweeps before a region file
# is quarantined
ENV_QUARANTINE_AFTER = "VTPU_QUARANTINE_AFTER"
# monitor/hostguard.py and monitor/resize.py: grace before feedback blocking
ENV_HOST_GRACE_S = "VTPU_HOST_GRACE_S"
ENV_RESIZE_GRACE_S = "VTPU_RESIZE_GRACE_S"
# monitor/metrics.py: spacing of the cluster-wide LIST fallback, the gate
# on the interposer's profile families, a live region's staleness horizon
ENV_MONITOR_LIST_FALLBACK_S = "VTPU_MONITOR_LIST_FALLBACK_S"
ENV_MONITOR_PROFILE_EXPORT = "VTPU_MONITOR_PROFILE_EXPORT"
ENV_SHIM_STALE_S = "VTPU_SHIM_STALE_S"
# enforce/region.py: "0" skips the header-checksum verification, and a
# libvgpucore.so to load in place of the built one
ENV_REGION_CHECKSUM = "VTPU_REGION_CHECKSUM"
ENV_CORE_LIB = "VGPU_CORE_LIB"
# util/lockdebug.py, util/logsetup.py, trace/core.py
ENV_LOCKDEBUG = "VTPU_LOCKDEBUG"
ENV_LOG_FORMAT = "VTPU_LOG_FORMAT"
ENV_TRACE_RING = "VTPU_TRACE_RING"
ENV_TRACE_SPANS = "VTPU_TRACE_SPANS"
ENV_TRACE_JOURNAL = "VTPU_TRACE_JOURNAL"
ENV_TRACE_JOURNAL_MAX_KB = "VTPU_TRACE_JOURNAL_MAX_KB"

# the containers directory on the host (the twin of CONTAINER_CACHE_DIR:
# the plugin's <shim_host_dir>/containers), the monitor's default
HOST_CONTAINERS_DIR = "/usr/local/vgpu/containers"

# --------------------------------------------------------------------------
# The interposer's profile plane and the bench harness (vtpu_torch/bench;
# bench.py's names, so one deployment's values serve both vendors)
# --------------------------------------------------------------------------

# shared_region.c: "0" turns the callsite profile off (default on); the
# 1-in-N latency sampling period of each thread (default 64)
ENV_PROFILE = "VTPU_PROFILE"
ENV_PROFILE_SAMPLE = "VTPU_PROFILE_SAMPLE"
# bench: "mock" runs the models on the CPU over the mock libcuda.so.1 (the
# default runs on the card, and fails without one); set in the children the
# harness starts; the shim child's device-memory quota (default 12g); "1"
# runs the shim rep before the native one in each interleaved pair
ENV_BENCH_BACKEND = "VTPU_BENCH_BACKEND"
ENV_BENCH_CHILD = "VTPU_BENCH_CHILD"
ENV_BENCH_QUOTA = "VTPU_BENCH_QUOTA"
ENV_BENCH_SHIM_FIRST = "VTPU_BENCH_SHIM_FIRST"
# bench --parity: the least shim/native best-rep ratio (default 0.95) and
# the least execute-p50 speedup against the profile baseline (default 3)
ENV_PARITY_MIN = "VTPU_PARITY_MIN"
ENV_PARITY_P50X = "VTPU_PARITY_P50X"

# --------------------------------------------------------------------------
# Files in a container's region directory (<podUID>_<n>/), the port's names
# for vtpu.cache and its sidecars (vtpu/contracts.py's durable files)
# --------------------------------------------------------------------------

# the shared region, written by libvgpu.so, read by the monitor
CACHE_FILENAME = "vgpu.cache"
# the monitor's durable quarantine marker, resize intent and host-guard
# record
QUARANTINE_MARKER = "vgpu.quarantine.json"
RESIZE_RECORD = "vgpu.resize.json"
HOSTGUARD_RECORD = "vgpu.hostguard.json"
# the live-migration drain handshake: the monitor writes the request, the
# workload (enforce/workload.py) the ack
DRAIN_REQUEST_FILE = "vgpu.drain.json"
DRAIN_ACK_FILE = "vgpu.drain.ack.json"

# --------------------------------------------------------------------------
# Annotation keys and resource names (vtpu/contracts.py:45-112)
# --------------------------------------------------------------------------

DOMAIN = "vtpu.io"
NVIDIA_DOMAIN = "nvidia.com"

# node -> scheduler registration bus, this vendor's own pair: the
# scheduler's node poll keys its inventory by the handshake key
# (vtpu/device/__init__.py:84-87), so a GPU node must not reuse the TPU's
# vtpu.io/node-handshake. Written by plugin/register.py, read by the
# scheduler through GPUDevices.handshake_anno/register_anno.
HANDSHAKE_ANNO = f"{DOMAIN}/node-handshake-nvidia"
NODE_REGISTER_ANNO = f"{DOMAIN}/node-nvidia-register"

# scheduler -> plugin assignment bus, shared with the TPU vendor: written by
# the scheduler's filter/bind, read and consumed by Allocate
# (util/podutil.py)
ASSIGNED_NODE_ANNO = f"{DOMAIN}/vtpu-node"
ASSIGNED_IDS_ANNO = f"{DOMAIN}/vtpu-ids"
TO_ALLOCATE_ANNO = f"{DOMAIN}/devices-to-allocate"
ASSIGNED_TIME_ANNO = f"{DOMAIN}/vtpu-time"
BIND_TIME_ANNO = f"{DOMAIN}/bind-time"
BIND_PHASE_ANNO = f"{DOMAIN}/bind-phase"
# node mutex the scheduler's Bind takes and Allocate releases
# (util/nodelock.py)
NODE_LOCK_ANNO = f"{DOMAIN}/mutex.lock"
# pod host-memory reservation (read by Allocate for CUDA_HOST_MEMORY_LIMIT)
# and node host-memory capacity (written by plugin/register.py)
HOST_MEM_ANNO = f"{DOMAIN}/host-memory"
NODE_HOST_MEM_ANNO = f"{DOMAIN}/node-host-memory"
# live migration: the source node, surfaced by Allocate as
# VTPU_MIGRATED_FROM; the scheduler's durable migration stamp and its
# deadline, which the monitor's drain coordinator turns into the drain
# handshake
MIGRATED_FROM_ANNO = f"{DOMAIN}/migrated-from"
MIGRATING_TO_ANNO = f"{DOMAIN}/migrating-to"
MIGRATE_DEADLINE_ANNO = f"{DOMAIN}/migrate-deadline"
# the pod's task priority (0 = guaranteed; absent = best effort, 1), the
# durable preemption stamp and the elastic-quota resize intent, all written
# by the scheduler and read by the monitor
TASK_PRIORITY_ANNO = f"{DOMAIN}/task-priority"
TASK_PRIORITY_DEFAULT = 1
TASK_PRIORITY_HIGH = 0
PREEMPTED_BY_ANNO = f"{DOMAIN}/preempted-by"
HBM_LIMIT_ANNO = f"{DOMAIN}/hbm-limit"
# end-to-end trace stitch key (trace/core.py trace_id_of_pod)
TRACE_ID_ANNO = f"{DOMAIN}/trace-id"
# multi-host slice membership (written empty by plugin/register.py) and a
# gang member's solved block (read by Allocate for the mesh env); the TPU
# domain's keys, since the scheduler's slice solver reads them
NODE_SLICE_ANNO = "tpu.google.com/node-slice"
SLICE_BLOCK_ANNO = "tpu.google.com/slice-block"
# a gang's id and width, read by the scheduler's slice reservations
# (scheduler/slice.py) from the pod, under the same TPU-domain keys
SLICE_GROUP_ANNO = "tpu.google.com/slice-group"
SLICE_HOSTS_ANNO = "tpu.google.com/slice-hosts"

# the scheduler's own keys (vtpu/contracts.py:68-85, same wire strings):
# the fencing generation stamped on every assignment it commits, and the
# defragmentation mark its preemption engine prefers as victims
SCHED_GEN_ANNO = f"{DOMAIN}/scheduler-generation"
MIGRATION_CANDIDATE_ANNO = f"{DOMAIN}/migration-candidate"

# card selection constraints, read by GPUDevices.check_type (reference:
# nvidia/device.go:62-105)
USE_GPUTYPE_ANNO = f"{NVIDIA_DOMAIN}/use-gputype"
NOUSE_GPUTYPE_ANNO = f"{NVIDIA_DOMAIN}/nouse-gputype"
NUMA_BIND_ANNO = f"{NVIDIA_DOMAIN}/numa-bind"

# container resources, read by GPUDevices (reference: nvidia/device.go:41-47;
# the host-memory resource has no reference counterpart and mirrors
# google.com/tpuhostmem); RESOURCE_GPU is also the kubelet resource the
# plugin registers
RESOURCE_GPU = f"{NVIDIA_DOMAIN}/gpu"
RESOURCE_MEM = f"{NVIDIA_DOMAIN}/gpumem"
RESOURCE_MEM_PERCENT = f"{NVIDIA_DOMAIN}/gpumem-percentage"
RESOURCE_CORES = f"{NVIDIA_DOMAIN}/gpucores"
RESOURCE_PRIORITY = f"{NVIDIA_DOMAIN}/priority"
RESOURCE_HOST_MEM = f"{NVIDIA_DOMAIN}/gpuhostmem"
