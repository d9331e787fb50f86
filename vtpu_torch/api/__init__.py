"""Container env knobs read by libvgpu.so and the workload (CUDA names).

The counterpart of vtpu/api/__init__.py:12-95 under the reference's own CUDA
names (pkg/api/types.go:19-22; the Allocate env of
pkg/device-plugin/nvidiadevice/nvinternal/plugin/server.go:336-358). The
device plugin produces them; the interposer vtpu_torch/csrc/libvgpu.c
(load_config) and vtpu_torch/enforce/workload.py (quota_from_env) consume
them, and must agree on every name below.
"""

# which cards the container may see (indices or GPU UUIDs, comma-separated)
ENV_VISIBLE_DEVICES = "CUDA_VISIBLE_DEVICES"

# device-memory cap, per visible device index ("%s_%d" per-device form
# first, the bare form as the default for all); "3g" / "512m" / bytes
ENV_DEVICE_MEMORY_LIMIT = "CUDA_DEVICE_MEMORY_LIMIT"

# SM-percent launch limit, per visible device index with the same
# per-index convention (enforcement is not in the interposer yet)
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
