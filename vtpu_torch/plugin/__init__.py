"""Kubelet device plugin for NVIDIA GPUs: the port's node agent.

The port of vtpu/plugin/ (reference layer: pkg/device-plugin/) — the
per-node DaemonSet that enumerates the cards through NVML
(:mod:`.nvml`), advertises ``device_split_count`` virtual replicas of each
to kubelet (:mod:`.rm`), registers the card inventory into node annotations
for the scheduler (:mod:`.register`), and wires quota enforcement into
containers at Allocate time (:mod:`.server`): the response's env, mounts
and device nodes alone put a container under ``libvgpu.so``. Start it with
``python -m vtpu_torch.plugin``. It uses NVML only and never creates a CUDA
context.
"""
