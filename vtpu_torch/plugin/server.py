"""Device-plugin gRPC server: ListAndWatch, Allocate, health, registration.

The port of vtpu/plugin/server.py. Reference:
pkg/device-plugin/nvidiadevice/nvinternal/plugin/server.go — lifecycle
Start/Serve/Register (114-234), ListAndWatch with health push (245-259),
and Allocate (280-403), the point where scheduler decisions turn into
container env/mounts that put the container under ``libvgpu.so``.
"""

from __future__ import annotations

import logging
import os
import queue
import random
import shutil
import threading
import time
from concurrent import futures
from typing import Dict, List, Optional

import grpc

from .. import api, native
from ..trace import trace_id_of_pod
from ..trace import tracer as _tracer
from ..util import codec, lockdebug, podutil, types
from ..util.client import KubeClient, NotFoundError
from ..util.env import env_float, env_int, env_str
from ..util.health import DegradedState
from . import deviceplugin_pb2 as pb
from . import dp_grpc
from .checkpoint import (AllocationCheckpoint, default_checkpoint_path,
                         record_to_response, response_to_record)
from .config import PluginConfig
from .nvml import ChipInfo, GpuLib
from .rm import ResourceManager, parse_replica_id

log = logging.getLogger(__name__)

HEALTH_POLL_S = 1.0        # MLU health loop cadence (cambricon.go:245)
VENDOR = types.GPU_VENDOR

#: device nodes every CUDA container needs besides its cards' own
#: (nvidia-container-runtime exposes the same set)
CONTROL_DEVICES = ("/dev/nvidiactl", "/dev/nvidia-uvm",
                   "/dev/nvidia-uvm-tools")


def _pod_mesh_env(pod: Dict) -> Dict[str, str]:
    """The VTPU_MESH_* env of a slice-gang member whose solved block
    carries mesh geometry (vtpu/plugin/server.py:44-71): the block's box
    shape, this member's block-relative coordinate, and the axis names.
    Empty for non-gang pods and for geometry that does not cover the
    member's host."""
    annos = (pod.get("metadata", {}) or {}).get("annotations", {}) or {}
    block = annos.get(types.SLICE_BLOCK_ANNO, "")
    node = annos.get(types.ASSIGNED_NODE_ANNO, "")
    if not block or not node:
        return {}
    try:
        _, hosts, shape, coords = codec.decode_slice_block_mesh(block)
    except codec.CodecError:
        log.warning("undecodable slice block %r; mesh env withheld",
                    block)
        return {}
    if shape is None or coords is None or node not in hosts:
        return {}
    coord = coords[hosts.index(node)]
    return {
        api.ENV_MESH_SHAPE: ",".join(str(d) for d in shape),
        api.ENV_MESH_COORDS: "-".join(str(c) for c in coord),
        api.ENV_MESH_AXES: "x,y,z",
    }


def _pod_host_mem_mb(pod: Dict) -> int:
    """The pod's host-memory reservation in MB (vtpu.io/host-memory)."""
    annos = (pod.get("metadata", {}) or {}).get("annotations", {}) or {}
    return podutil.host_mem_mb_of(annos)


def _built(build, name: str) -> str:
    """The path ``build()`` produces; on a node that cannot build it (no
    gcc) the path it would have had, which then reads as missing."""
    try:
        return build()
    except native.NativeBuildFailure as e:
        log.warning("cannot build a shim artifact: %s", e)
        return os.path.join(native.BUILD, name)


def install_shim_artifacts(shim_host_dir: str) -> None:
    """Populate the host shim dir that every Allocate mount points into:
    libvgpu.so (vtpu_torch/_build, built at first use by
    vtpu_torch/native.py), the generated ld.so.preload naming its
    in-container path, the vgpu-validator program (mounted only where the
    host carries a license), and the containers/ root of the region
    files. The reference's DaemonSet copies /k8s-vgpu/lib onto the host
    the same way; without this, kubelet's bind mounts would materialise
    empty directories where the .so should be. Idempotent; tmp+rename so
    a running container never maps a torn file. A missing artifact is
    logged and skipped (Allocate still names its mount)."""
    os.makedirs(os.path.join(shim_host_dir, "containers"), exist_ok=True)
    pairs = [
        (env_str(api.ENV_SHIM_SO)
         or _built(native.interposer, "libvgpu.so"),
         os.path.join(shim_host_dir, "libvgpu.so")),
        (env_str(api.ENV_PRELOAD_SRC)
         or _built(native.preload_file, "ld.so.preload"),
         os.path.join(shim_host_dir, "ld.so.preload")),
        (env_str(api.ENV_VALIDATOR_BIN)
         or _built(native.validator, "vgpu-validator"),
         os.path.join(shim_host_dir, "vgpu-validator")),
    ]
    installed = []
    for src, dst in pairs:
        if not os.path.exists(src):
            log.warning("shim artifact %s missing; containers relying on "
                        "the %s mount will fail to enforce", src,
                        os.path.basename(dst))
            continue
        tmp = f"{dst}.tmp.{os.getpid()}"
        shutil.copy2(src, tmp)
        os.replace(tmp, dst)
        installed.append(os.path.basename(dst))
    if installed:
        log.info("installed %s into %s", ", ".join(installed),
                 shim_host_dir)


class AllocateError(Exception):
    pass


class GPUDevicePlugin(dp_grpc.DevicePluginServicer):
    def __init__(
        self,
        gpulib: GpuLib,
        config: PluginConfig,
        client: KubeClient,
        node_name: str,
        socket_name: str = "vgpu.sock",
        pod_cache=None,
        checkpoint: Optional[AllocationCheckpoint] = None,
        degraded: Optional[DegradedState] = None,
    ) -> None:
        self.gpulib = gpulib
        self.config = config.validate()
        self.client = client
        self.node_name = node_name
        self.socket_name = socket_name
        # optional watch-backed PodCache (vtpu_torch/util/podcache):
        # Allocate's pending-pod lookup hits it first instead of LISTing
        # per call, and serves from it while the apiserver is dark
        self.pod_cache = pod_cache
        # durable allocation checkpoint (docs/node-resilience.md): every
        # container response is persisted before its annotation slot is
        # consumed, so a restarted plugin answers kubelet's re-Allocate
        # with the same wiring
        self.checkpoint = checkpoint or AllocationCheckpoint(
            default_checkpoint_path(config.shim_host_dir))
        # shared across restart incarnations when __main__ wires one in
        self.degraded = degraded or DegradedState("device-plugin")
        self.rm = ResourceManager(config)

        self.chips: List[ChipInfo] = gpulib.enumerate()
        self._chips_lock = lockdebug.lock("plugin.chips")
        self._watchers: List[queue.Queue] = []
        self._server: Optional[grpc.Server] = None
        self._stop = threading.Event()
        self._socket_ino = -1
        #: set once a Register RPC succeeded
        self.registered = threading.Event()
        self._register_mu = lockdebug.lock("plugin.register")
        self._register_thread: Optional[threading.Thread] = None
        # knobs read once at construction so tests can tighten them via env
        self._register_backoff_s = env_float(
            api.ENV_REGISTER_BACKOFF_S, 0.5, minimum=0.01)
        self._register_backoff_cap_s = env_float(
            api.ENV_REGISTER_BACKOFF_CAP_S, 30.0, minimum=0.05)
        self._kubelet_watch_s = env_float(
            api.ENV_KUBELET_WATCH_S, 1.0, minimum=0.05)
        self._socket_probe_timeout_s = env_float(
            api.ENV_SOCKET_PROBE_TIMEOUT_S, 1.0, minimum=0.1)
        self._allocate_retries = env_int(
            api.ENV_ALLOCATE_RETRIES, 3, minimum=1)
        self._allocate_backoff_s = env_float(
            api.ENV_ALLOCATE_BACKOFF_S, 0.2, minimum=0.0)
        self._reconcile_s = env_float(api.ENV_RECONCILE_S, 5.0,
                                      minimum=0.05)

    def GetDevicePluginOptions(self, request, context):
        # must agree with RegisterRequest.options
        return pb.DevicePluginOptions(
            get_preferred_allocation_available=True
        )

    # ------------------------------------------------------------------
    # lifecycle (reference: server.go:114-234)
    # ------------------------------------------------------------------

    @property
    def socket_path(self) -> str:
        return os.path.join(self.config.socket_dir, self.socket_name)

    def _remove_stale_socket(self) -> None:
        """Clear a leftover socket file, refusing to start when a live
        sibling still answers on it (two plugin instances must not steal
        each other's socket)."""
        if not os.path.exists(self.socket_path):
            return
        try:
            with grpc.insecure_channel(
                    f"unix://{self.socket_path}") as channel:
                dp_grpc.DevicePluginStub(channel).GetDevicePluginOptions(
                    pb.Empty(), timeout=self._socket_probe_timeout_s)
            raise RuntimeError(
                f"another live device plugin is serving on "
                f"{self.socket_path}; refusing to start")
        except grpc.RpcError as e:
            # only connection-refused proves nobody is home; a DEADLINE
            # against a live-but-busy sibling must refuse too
            code = e.code() if hasattr(e, "code") else None
            if code != grpc.StatusCode.UNAVAILABLE:
                raise RuntimeError(
                    f"socket {self.socket_path} probe returned {code} "
                    "(a live but slow plugin?); refusing to start") from e
        try:
            os.unlink(self.socket_path)
            log.info("removed stale plugin socket %s", self.socket_path)
        except FileNotFoundError:
            pass  # a concurrent cleanup won the unlink race — fine

    def start(self, register_with_kubelet: bool = True) -> None:
        os.makedirs(self.config.socket_dir, exist_ok=True)
        self._remove_stale_socket()
        self._server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=8)
        )
        dp_grpc.add_device_plugin_servicer(self._server, self)
        self._server.add_insecure_port(f"unix://{self.socket_path}")
        self._server.start()
        try:
            self._socket_ino = os.stat(self.socket_path).st_ino
        except OSError:
            self._socket_ino = -1
        log.info("device plugin serving on %s", self.socket_path)
        if register_with_kubelet:
            # never crash-loop on an absent kubelet: retry with capped
            # exponential backoff + jitter, and watch for restarts
            self.trigger_register()
            threading.Thread(target=self._kubelet_watch_loop,
                             daemon=True).start()
        threading.Thread(target=self._health_loop, daemon=True).start()
        threading.Thread(target=self._reconcile_loop, daemon=True).start()

    def _reconcile_loop(self) -> None:
        """Prune expired checkpoint records and pay the annotation
        convergence a completed Allocate still owes (a crash between
        recording completion and flipping bind-phase)."""
        while not self._stop.wait(self._reconcile_s):
            try:
                self.reconcile_once()
            except Exception as e:
                log.warning("checkpoint reconcile pass failed: %s", e)

    def reconcile_once(self) -> int:
        """One reconcile pass; returns the number of pods converged."""
        self.checkpoint.prune()
        converged = 0
        for rec in self.checkpoint.unconverged():
            uid, pod_key = rec["pod_uid"], rec.get("pod_key", "")
            ns, _, name = pod_key.partition("/")
            if not name:
                self.checkpoint.forget(uid)
                continue
            try:
                pod = self.client.get_pod(ns or "default", name)
            except NotFoundError:
                self.checkpoint.forget(uid)  # pod gone: debt void
                continue
            except Exception as e:
                log.debug("reconcile of %s deferred: %s", pod_key, e)
                continue
            meta_annos = pod["metadata"].get("annotations", {}) or {}
            if meta_annos.get(types.ASSIGNED_TIME_ANNO, "") \
                    != rec.get("assigned_time", ""):
                # the control plane moved on to a new assignment
                self.checkpoint.forget(uid)
                continue
            try:
                n_recorded = len(rec.get("containers", []))
                while len(self._consumed_slots(pod)) < n_recorded:
                    podutil.erase_next_device_type_from_annotation(
                        self.client, VENDOR, pod)
                    pod = self._refetch(pod)
                podutil.pod_allocation_try_success(self.client, pod,
                                                   self.node_name)
                self.checkpoint.mark_converged(uid)
                converged += 1
                log.info("reconciled allocation for %s (slots consumed, "
                         "bind-phase success, node lock released)",
                         pod_key)
            except Exception as e:
                log.debug("reconcile of %s deferred: %s", pod_key, e)
        return converged

    def stop(self) -> None:
        self._stop.set()
        if self._server is not None:
            self._server.stop(grace=1.0)
        try:
            # only remove the socket WE bound: a successor may already be
            # serving on a fresh socket at the same path
            if os.stat(self.socket_path).st_ino == self._socket_ino:
                os.unlink(self.socket_path)
        except FileNotFoundError:
            pass
        except OSError as e:
            log.debug("socket cleanup skipped: %s", e)

    # ------------------------------------------------------------------
    # kubelet registration: retrying and restart-watching
    # (reference: register + fsnotify loop, main.go:154-238)
    # ------------------------------------------------------------------

    @property
    def kubelet_socket(self) -> str:
        return os.path.join(self.config.socket_dir, dp_grpc.KUBELET_SOCKET)

    def register_with_kubelet(self) -> None:
        kubelet_sock = self.kubelet_socket
        if not os.path.exists(kubelet_sock):
            # fail fast instead of burning the gRPC connect timeout
            raise FileNotFoundError(f"kubelet socket {kubelet_sock} absent")
        with grpc.insecure_channel(f"unix://{kubelet_sock}") as channel:
            stub = dp_grpc.RegistrationStub(channel)
            stub.Register(
                pb.RegisterRequest(
                    version=dp_grpc.API_VERSION,
                    endpoint=self.socket_name,
                    resource_name=self.config.resource_name,
                    options=pb.DevicePluginOptions(
                        get_preferred_allocation_available=True
                    ),
                ),
                timeout=10,
            )
        self.registered.set()
        self.degraded.clear("kubelet_unregistered")
        log.info("registered %s with kubelet", self.config.resource_name)

    def trigger_register(self) -> None:
        """Start (or restart) the background registration retry loop;
        idempotent while one is already running."""
        with self._register_mu:
            t = self._register_thread
            if t is not None and t.is_alive():
                return
            t = threading.Thread(target=self._register_loop, daemon=True)
            self._register_thread = t
            t.start()

    def _register_loop(self) -> None:
        """Register with capped exponential backoff + full jitter: an
        absent or restarting kubelet is waited out, never crash-looped."""
        delay = self._register_backoff_s
        attempt = 0
        while not self._stop.is_set():
            try:
                self.register_with_kubelet()
                return
            except (grpc.RpcError, OSError) as e:
                attempt += 1
                self.registered.clear()
                self.degraded.set("kubelet_unregistered", str(e))
                sleep = delay * (0.5 + random.random() / 2.0)
                if attempt == 1 or attempt % 10 == 0:
                    log.warning(
                        "kubelet registration attempt %d failed (%s); "
                        "retrying in %.2fs", attempt, e, sleep)
                if self._stop.wait(sleep):
                    return
                delay = min(delay * 2.0, self._register_backoff_cap_s)

    def _kubelet_ino(self) -> int:
        try:
            return os.stat(self.kubelet_socket).st_ino
        except OSError:
            return -1

    def _kubelet_watch_loop(self) -> None:
        """Poll kubelet.sock's inode: a changed or newly-appeared inode
        means kubelet restarted and forgot every plugin — re-register."""
        last = self._kubelet_ino()
        while not self._stop.wait(self._kubelet_watch_s):
            cur = self._kubelet_ino()
            if cur == last:
                continue
            if cur == -1:
                self.registered.clear()
                self.degraded.set("kubelet_unregistered",
                                  "kubelet socket vanished")
            else:
                log.warning("kubelet socket changed (inode %d -> %d); "
                            "re-registering", last, cur)
                self.registered.clear()
                self.trigger_register()
            last = cur

    # ------------------------------------------------------------------
    # ListAndWatch + health (reference: server.go:245-259, health.go)
    # ------------------------------------------------------------------

    def _current_devices(self) -> List[pb.Device]:
        with self._chips_lock:
            return self.rm.kubelet_devices(self.chips)

    def ListAndWatch(self, request, context):
        q: queue.Queue = queue.Queue()
        self._watchers.append(q)
        try:
            yield pb.ListAndWatchResponse(devices=self._current_devices())
            while not self._stop.is_set():
                try:
                    q.get(timeout=1.0)
                except queue.Empty:
                    continue
                yield pb.ListAndWatchResponse(
                    devices=self._current_devices()
                )
        finally:
            self._watchers.remove(q)

    def _notify_watchers(self) -> None:
        for q in list(self._watchers):
            q.put(None)

    def _health_loop(self) -> None:
        """1 Hz health poll with flap-back to healthy."""
        while not self._stop.wait(HEALTH_POLL_S):
            try:
                fresh = self.gpulib.enumerate()
            except Exception:
                log.exception("card enumeration failed")
                continue
            with self._chips_lock:
                old = {c.uuid: c.health for c in self.chips}
                changed = any(
                    old.get(c.uuid) != c.health for c in fresh
                ) or len(fresh) != len(self.chips)
                self.chips = fresh
            if changed:
                log.warning("card health changed; pushing ListAndWatch")
                self._notify_watchers()

    # ------------------------------------------------------------------
    # GetPreferredAllocation (reference: rm/allocate.go:30-123)
    # ------------------------------------------------------------------

    def GetPreferredAllocation(self, request, context):
        """Cards have no interconnect mesh to keep a pod inside (the JAX
        plugin's sub-mesh solver has nothing to solve here): "packed"
        takes replicas card-major from the cards with the most available
        replicas first (fewest cards touched), lower NUMA node first;
        "spread" round-robins across them."""
        responses = []
        with self._chips_lock:
            by_uuid = self.rm.chips_by_uuid(self.chips)
        for creq in request.container_requests:
            per_chip: Dict[str, List[str]] = {}
            for rid in creq.available_deviceIDs:
                per_chip.setdefault(parse_replica_id(rid), []).append(rid)
            chip_order = sorted(per_chip, key=lambda u: (
                -len(per_chip[u]),
                by_uuid[u].numa if u in by_uuid else 0, u))
            ordered: List[str] = []
            if self.config.preferred_allocation_policy == "spread":
                queues = [sorted(per_chip[u]) for u in chip_order]
                while any(queues):
                    for q in queues:
                        if q:
                            ordered.append(q.pop(0))
            else:
                for u in chip_order:
                    ordered.extend(sorted(per_chip[u]))
            picked = list(creq.must_include_deviceIDs)
            picked += [r for r in ordered if r not in set(picked)]
            responses.append(
                pb.ContainerPreferredAllocationResponse(
                    deviceIDs=picked[:creq.allocation_size]
                )
            )
        return pb.PreferredAllocationResponse(
            container_responses=responses
        )

    # ------------------------------------------------------------------
    # Allocate — the enforcement wiring point (reference: server.go:280-403)
    # ------------------------------------------------------------------

    def Allocate(self, request, context):
        try:
            return self._allocate(request)
        except AllocateError as e:
            log.error("allocate failed: %s", e)
            context.abort(grpc.StatusCode.FAILED_PRECONDITION, str(e))
        except Exception as e:
            log.exception("allocate crashed")
            context.abort(grpc.StatusCode.INTERNAL, str(e))

    def _lookup_pending_pod(self, lookup: Dict[str, str]):
        """Pending-pod lookup with bounded retry/backoff and a
        last-known-good cache fallback (docs/node-resilience.md):
        apiserver blips retry inside kubelet's Allocate deadline; a
        persistently unreachable apiserver degrades to the watch cache's
        last view (``lookup["source"] = "cache-degraded"``) instead of
        failing the pod."""
        last_err: Optional[Exception] = None
        delay = self._allocate_backoff_s
        for attempt in range(self._allocate_retries):
            try:
                pod = podutil.get_pending_pod(
                    self.client, self.node_name,
                    cache=self.pod_cache, detail=lookup)
                self.degraded.clear("apiserver_unreachable")
                return pod
            except Exception as e:
                last_err = e
                log.warning("pending-pod lookup attempt %d/%d failed: %s",
                            attempt + 1, self._allocate_retries, e)
                if attempt + 1 < self._allocate_retries and delay > 0:
                    time.sleep(delay * (0.5 + random.random() / 2.0))
                    delay = min(delay * 2.0, 2.0)
        self.degraded.set("apiserver_unreachable", str(last_err))
        cache = self.pod_cache
        if cache is not None and cache.synced:
            hit = podutil.pending_from(
                cache.pods_on_node(self.node_name), self.node_name)
            if hit is not None:
                log.warning(
                    "apiserver unreachable; serving Allocate lookup for "
                    "%s from the last-known-good pod cache",
                    hit["metadata"].get("name", "?"))
                lookup["source"] = "cache-degraded"
                return hit
        raise AllocateError(
            f"apiserver unreachable after {self._allocate_retries} "
            f"lookup attempts and no cached pending pod: {last_err}")

    def _allocate(self, request) -> pb.AllocateResponse:
        lookup: Dict[str, str] = {}
        pod = self._lookup_pending_pod(lookup)
        if pod is None:
            raise AllocateError(
                f"no pod in bind-phase=allocating for node {self.node_name}"
            )
        meta = pod["metadata"]
        pod_key = f"{meta.get('namespace', 'default')}/{meta['name']}"
        pod_uid = meta.get("uid", "nouid")
        degraded = lookup.get("source") == "cache-degraded"
        annos = meta.get("annotations", {}) or {}
        assigned_time = annos.get(types.ASSIGNED_TIME_ANNO, "")
        # responses a previous incarnation already issued for this pod
        # (restored from the checkpoint): kubelet's re-Allocate after a
        # plugin crash must get the SAME wiring, valid only against the
        # same assignment generation (ASSIGNED_TIME)
        rec = self.checkpoint.pod_record(pod_uid)
        if rec is not None \
                and rec.get("assigned_time", "") != assigned_time:
            log.warning("discarding checkpoint record for %s: it is for "
                        "assignment %r, pod now carries %r", pod_key,
                        rec.get("assigned_time", ""), assigned_time)
            self.checkpoint.forget(pod_uid)
            rec = None
        recorded = list(rec.get("containers", [])) if rec else []
        # the trace id stitches this span to the webhook/filter/bind
        # spans the control plane emitted for the same pod
        with _tracer.span(trace_id_of_pod(pod), "allocate", pod=pod_key,
                          node=self.node_name,
                          lookup=lookup.get("source", "list")) as sp:
            responses = []
            try:
                for i, creq in enumerate(request.container_requests):
                    if i < len(recorded):
                        responses.append(self._replay_container(
                            pod_key, pod, i, recorded[i], degraded))
                        if not degraded:
                            pod = self._refetch(pod)
                        continue
                    if degraded:
                        # consuming a fresh annotation slot needs an
                        # apiserver write; without one the allocation
                        # would be unaccounted: fail, kubelet retries
                        raise AllocateError(
                            "apiserver unreachable and container "
                            f"#{i} has no checkpointed response")
                    devs = podutil.get_next_device_request(VENDOR, pod)
                    if not devs:
                        raise AllocateError(
                            "pod annotation has no remaining container "
                            "assignment (kubelet asked for "
                            f"{len(creq.devicesIDs)} devices)"
                        )
                    resp = self._container_response(pod, devs)
                    # checkpoint BEFORE the annotation erase: a crash in
                    # between is healed by the replay path above
                    self.checkpoint.record_container(
                        pod_uid, pod_key, i, response_to_record(resp),
                        assigned_time=assigned_time,
                        host_mem_mb=_pod_host_mem_mb(pod))
                    responses.append(resp)
                    podutil.erase_next_device_type_from_annotation(
                        self.client, VENDOR, pod
                    )
                    pod = self._refetch(pod)
            except Exception:
                if not degraded:
                    try:
                        podutil.pod_allocation_failed(self.client, pod,
                                                      self.node_name)
                        # the scheduler will re-assign this pod: the
                        # recorded responses are for a dead assignment
                        self.checkpoint.forget(pod_uid)
                    except Exception as e:
                        log.warning("cannot stamp allocation failure "
                                    "for %s: %s", pod_key, e)
                raise
            sp.set("containers", len(responses))
            self.checkpoint.mark_complete(pod_uid)
            if degraded:
                log.warning(
                    "Allocate for %s served entirely from checkpoint "
                    "while apiserver unreachable; annotation "
                    "convergence (slot erase + success flip + node "
                    "lock release) owed to the reconcile loop", pod_key)
            else:
                podutil.pod_allocation_try_success(self.client, pod,
                                                   self.node_name)
                self.checkpoint.mark_converged(pod_uid)
            return pb.AllocateResponse(container_responses=responses)

    def _refetch(self, pod: Dict) -> Dict:
        return self.client.get_pod(
            pod["metadata"].get("namespace", "default"),
            pod["metadata"]["name"],
        )

    def _replay_container(self, pod_key: str, pod: Dict, index: int,
                          record: Dict, degraded: bool = False
                          ) -> pb.ContainerAllocateResponse:
        """Reissue container `index`'s response verbatim from the
        checkpoint, catching the annotation up when the previous
        incarnation died between the checkpoint write and the erase."""
        log.info("replaying checkpointed container #%d for %s",
                 index, pod_key)
        if not degraded and len(self._consumed_slots(pod)) <= index:
            podutil.erase_next_device_type_from_annotation(
                self.client, VENDOR, pod)
        return record_to_response(record)

    def _container_response(
        self, pod: Dict, devs: types.ContainerDevices
    ) -> pb.ContainerAllocateResponse:
        """Assemble env/mounts/devices for one container (reference:
        server.go:336-396 + 405-490). Applied as it stands by kubelet and
        nvidia-container-runtime, it puts the container under libvgpu.so:
        the runtime exposes the NVIDIA_VISIBLE_DEVICES cards as ordinals
        0..n-1 (so the ``_i`` suffixes below are container ordinals), the
        mounted /etc/ld.so.preload loads the interposer into every
        process, and the interposer reads its limits and region file from
        the env."""
        with self._chips_lock:
            by_uuid = self.rm.chips_by_uuid(self.chips)
        pod_uid = pod["metadata"].get("uid", "nouid")

        envs: Dict[str, str] = {}
        envs[api.ENV_NVIDIA_VISIBLE_DEVICES] = ",".join(d.uuid for d in devs)
        for i, d in enumerate(devs):
            envs[f"{api.ENV_DEVICE_MEMORY_LIMIT}_{i}"] = str(
                d.usedmem * 1024 * 1024
            )
        if not self.config.disable_core_limit:
            cores = [d.usedcores for d in devs]
            # compact bare form ONLY when every device carries the same
            # nonzero limit — the interposer applies the bare value to all
            # devices, so emitting it for a mixed set would throttle a
            # device the scheduler granted unlimited (usedcores == 0)
            if cores and all(cores) and len(set(cores)) == 1:
                envs[api.ENV_SM_LIMIT] = str(cores[0])
            elif any(cores):
                # per-device limits: the interposer's per-device token
                # buckets read the _i suffix; devices without one stay
                # unthrottled
                for i, d in enumerate(devs):
                    if d.usedcores:
                        envs[f"{api.ENV_SM_LIMIT}_{i}"] = str(d.usedcores)
        # the pod's host-memory reservation, in bytes, for the region's
        # host ledger; absent = no env = unlimited
        host_mb = _pod_host_mem_mb(pod)
        if host_mb > 0:
            envs[api.ENV_HOST_MEMORY_LIMIT] = str(host_mb * 1024 * 1024)

        envs.update(_pod_mesh_env(pod))
        mig_from = (pod["metadata"].get("annotations", {}) or {}).get(
            types.MIGRATED_FROM_ANNO)
        if mig_from:
            envs[api.ENV_MIGRATED_FROM] = mig_from

        cache_name = f"{pod_uid}_{len(self._consumed_slots(pod))}"
        container_cache = f"{api.CONTAINER_CACHE_DIR}/{cache_name}"
        envs[api.ENV_SHARED_CACHE] = f"{container_cache}/{api.CACHE_FILENAME}"

        host_cache = os.path.join(
            self.config.shim_host_dir, "containers", cache_name
        )
        # the region file's host directory, made here as the reference's
        # Allocate makes it (server.go:360-366): the interposer creates the
        # file, not its directory
        os.makedirs(host_cache, exist_ok=True)
        mounts = [
            pb.Mount(
                container_path=api.CONTAINER_SHIM_PATH,
                host_path=os.path.join(self.config.shim_host_dir,
                                       "libvgpu.so"),
                read_only=True,
            ),
            pb.Mount(
                container_path=container_cache,
                host_path=host_cache,
                read_only=False,
            ),
            pb.Mount(
                container_path=api.LOCK_DIR,
                host_path=api.LOCK_DIR,
                read_only=False,
            ),
        ]
        if not self._control_disabled(pod):
            # a CUDA process is reached only through the preload: there is
            # no plugin-discovery env to point at the interposer
            mounts.append(
                pb.Mount(
                    container_path=api.LD_SO_PRELOAD_PATH,
                    host_path=os.path.join(self.config.shim_host_dir,
                                           "ld.so.preload"),
                    read_only=True,
                )
            )
        # entitlement (reference: license + vgpuvalidator mounted only
        # when the host carries a license, server.go:384-396). Only the
        # license FILE is mounted — never the directory, which may hold
        # the signing secret
        license_file = os.path.join(self.config.shim_host_dir,
                                    "license", "license")
        if os.path.exists(license_file):
            mounts.append(pb.Mount(container_path=api.CONTAINER_LICENSE_PATH,
                                   host_path=license_file,
                                   read_only=True))
            validator = os.path.join(self.config.shim_host_dir,
                                     "vgpu-validator")
            if os.path.exists(validator):
                mounts.append(pb.Mount(
                    container_path=api.CONTAINER_VALIDATOR_PATH,
                    host_path=validator, read_only=True))

        device_specs = []
        for d in devs:
            chip = by_uuid.get(d.uuid)
            if chip is None:
                # assigned card vanished between bind and Allocate: fail
                # fast instead of launching a container with env naming a
                # card it has no device node for
                raise AllocateError(
                    f"assigned card {d.uuid} no longer present on node"
                )
            for path in chip.device_paths:
                device_specs.append(
                    pb.DeviceSpec(container_path=path, host_path=path,
                                  permissions="rw")
                )
        for path in CONTROL_DEVICES:
            device_specs.append(pb.DeviceSpec(container_path=path,
                                              host_path=path,
                                              permissions="rw"))
        return pb.ContainerAllocateResponse(
            envs=envs, mounts=mounts, devices=device_specs
        )

    @staticmethod
    def _consumed_slots(pod: Dict) -> List[int]:
        """Indices of container slots already consumed (for unique cache
        dir naming per container)."""
        assigned = podutil.decode_assigned_devices(
            pod, types.ASSIGNED_IDS_ANNO
        )
        remaining = podutil.decode_assigned_devices(pod)
        consumed = []
        for i, ctr in enumerate(assigned):
            if ctr and (i >= len(remaining) or not remaining[i]):
                consumed.append(i)
        return consumed

    @staticmethod
    def _control_disabled(pod: Dict) -> bool:
        """CUDA_DISABLE_CONTROL env anywhere in the pod skips the
        ld.so.preload mount (reference: server.go:371-378)."""
        for ctr in podutil.all_containers(pod):
            for env in ctr.get("env", []) or []:
                if env.get("name") == api.ENV_DISABLE_CONTROL:
                    return True
        return False
