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
# lock directory the interposer shares between a node's containers
# (mounted by Allocate at the same path inside and out)
LOCK_DIR = "/tmp/vgpulock"

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
# enforce/region.py: "0" skips the header-checksum verification
ENV_REGION_CHECKSUM = "VTPU_REGION_CHECKSUM"
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
PREEMPTED_BY_ANNO = f"{DOMAIN}/preempted-by"
HBM_LIMIT_ANNO = f"{DOMAIN}/hbm-limit"
# end-to-end trace stitch key (trace/core.py trace_id_of_pod)
TRACE_ID_ANNO = f"{DOMAIN}/trace-id"
# multi-host slice membership (written empty by plugin/register.py) and a
# gang member's solved block (read by Allocate for the mesh env); the TPU
# domain's keys, since the scheduler's slice solver reads them
NODE_SLICE_ANNO = "tpu.google.com/node-slice"
SLICE_BLOCK_ANNO = "tpu.google.com/slice-block"

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
