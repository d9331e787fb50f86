"""What the container runtime does with an Allocate response, for a process
started outside a container.

In a cluster kubelet applies the response (env, mounts, device nodes) and
nvidia-container-runtime exposes the ``NVIDIA_VISIBLE_DEVICES`` cards to
the container, where every process loads ``libvgpu.so`` through the mounted
``/etc/ld.so.preload``. Where there is no container (the CPU end-to-end
test, ``chip_smoke.py``'s node-agent phase), :func:`process_env` makes the
one translation that stands in for both:

- every env the response sets, with a value that names a path inside a
  mount rewritten to the mount's host path (the region file);
- ``LD_PRELOAD`` = the host path of the mount at the interposer's
  in-container path (what the preload mount does), and only when the
  response mounts ``/etc/ld.so.preload``;
- ``CUDA_VISIBLE_DEVICES`` = ``NVIDIA_VISIBLE_DEVICES``: CUDA then sees
  exactly the assigned cards, as ordinals 0..n-1 in the response's order,
  as it does inside the container.

Nothing else is set: the response alone decides the process's limits.
"""

from __future__ import annotations

from typing import Dict, Iterable

from .. import api


def host_path(container_path: str, mounts: Iterable) -> str:
    """``container_path`` seen from the host through the response's
    ``mounts`` (the innermost mount that holds it); raises when no mount
    holds it."""
    best = None
    for m in mounts:
        root = m.container_path.rstrip("/")
        if container_path == root or container_path.startswith(root + "/"):
            if best is None or len(root) > len(best.container_path):
                best = m
    if best is None:
        raise ValueError(f"{container_path} is in no mount of the response")
    rest = container_path[len(best.container_path.rstrip("/")):]
    return best.host_path + rest


def process_env(response) -> Dict[str, str]:
    """The env a process gets from one ContainerAllocateResponse; see the
    module docstring."""
    mounts = list(response.mounts)
    env: Dict[str, str] = {}
    for key, value in response.envs.items():
        if value.startswith("/"):
            try:
                value = host_path(value, mounts)
            except ValueError:
                pass  # a path outside every mount stays as it is
        env[key] = value
    if any(m.container_path == api.LD_SO_PRELOAD_PATH for m in mounts):
        env["LD_PRELOAD"] = host_path(api.CONTAINER_SHIM_PATH, mounts)
    env[api.ENV_VISIBLE_DEVICES] = env.get(api.ENV_NVIDIA_VISIBLE_DEVICES,
                                           "")
    return env
