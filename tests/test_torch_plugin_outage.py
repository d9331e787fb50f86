"""The port's device plugin while the apiserver is dark, held to the JAX
package's (tests/test_node_chaos.py, section 4).

Both outage scenarios of tests/test_node_chaos.py run on each package on
the same inputs: one node, one pod assigned one card at 2048 MiB and 30
cores, a watch-backed pod cache synced while the pod waits in
bind-phase=allocating, and an apiserver client whose GETs, LISTs and
patches all fail while ``outage`` is set. On each side:

- the plugin dies (a ``BaseException``, as a SIGKILL) between recording
  the container's response and consuming its annotation slot; the
  apiserver goes dark; a new incarnation answers Allocate within 5 s from
  the cache's last view and the checkpoint, says it is degraded, and its
  ``allocate`` span records ``lookup=cache-degraded``; once the apiserver
  is back, the next Allocate replays the same wiring, catches the
  annotation up and flips the pod to success;
- without a checkpointed response, Allocate fails within 5 s with "no
  checkpointed response" and wires nothing.

The outcomes are compared across the packages under the name map of
tests/test_torch_plugin.py (responses, degraded reasons, span attributes,
annotations, checkpoint records). Before this slice the port failed the
first scenario: its lookup had no pod cache.
"""

from __future__ import annotations

import time

import pytest

from tests.test_torch_plugin import (  # noqa: F401 (fixtures)
    NODE, TPU_UUIDS, UUIDS, JaxClient, JaxPluginConfig, FakeTpuLib,
    TPUDevicePlugin, fixture_json, jax_pb, jax_podutil, jax_types,
    normalise, tpu_chips)
from vtpu.trace import trace_id_of_pod as jax_trace_id_of_pod
from vtpu.trace import tracer as jax_tracer
from vtpu.util.podcache import PodCache as JaxPodCache
from vtpu_torch.plugin import deviceplugin_pb2 as pb
from vtpu_torch.plugin.checkpoint import AllocationCheckpoint
from vtpu_torch.plugin.config import PluginConfig
from vtpu_torch.plugin.nvml import FakeNvmlLib
from vtpu_torch.plugin.server import AllocateError, GPUDevicePlugin
from vtpu_torch.trace import trace_id_of_pod, tracer
from vtpu_torch.util import nodelock, podutil, types
from vtpu_torch.util.client import FakeKubeClient
from vtpu_torch.util.podcache import PodCache

from vtpu.plugin.checkpoint import AllocationCheckpoint as JaxCheckpoint
from vtpu.plugin.server import AllocateError as JaxAllocateError
from vtpu.util import nodelock as jax_nodelock

BOUND_S = 5.0


class Killed(BaseException):
    """SIGKILL stand-in: no ``except Exception`` handler runs."""


def outage_client(base):
    """``base`` (a FakeKubeClient class) whose apiserver round trips all
    fail while ``outage`` is set (connection refused)."""

    class Outage(base):
        outage = False

        def _maybe_fail(self):
            if self.outage:
                raise OSError("apiserver unreachable (chaos)")

        def get_pod(self, *a, **kw):
            self._maybe_fail()
            return super().get_pod(*a, **kw)

        def list_pods_on_node(self, *a, **kw):
            self._maybe_fail()
            return super().list_pods_on_node(*a, **kw)

        def patch_pod_annotations(self, *a, **kw):
            self._maybe_fail()
            return super().patch_pod_annotations(*a, **kw)

    return Outage


class Side:
    """One package's node: its outage client, pod cache, plugin factory and
    Allocate request type."""

    def __init__(self, reference: bool, tmp_path):
        self.reference = reference
        self.tmp = tmp_path
        tmp_path.mkdir(parents=True, exist_ok=True)
        if reference:
            self.client = outage_client(JaxClient)()
            self.cache = JaxPodCache(self.client, node_name=NODE)
            self.podutil, self.types, self.nodelock = (
                jax_podutil, jax_types, jax_nodelock)
            self.pb, self.tracer = jax_pb, jax_tracer
            self.trace_id_of_pod = jax_trace_id_of_pod
            self.checkpoint_cls, self.error = JaxCheckpoint, JaxAllocateError
        else:
            self.client = outage_client(FakeKubeClient)()
            self.cache = PodCache(self.client, node_name=NODE)
            self.podutil, self.types, self.nodelock = (
                podutil, types, nodelock)
            self.pb, self.tracer = pb, tracer
            self.trace_id_of_pod = trace_id_of_pod
            self.checkpoint_cls, self.error = AllocationCheckpoint, \
                AllocateError
        self.client.add_node(NODE)

    def plugin(self, checkpoint=None):
        if self.reference:
            return TPUDevicePlugin(
                FakeTpuLib(chips=tpu_chips()), JaxPluginConfig(
                    device_split_count=4, socket_dir=str(self.tmp / "sock"),
                    shim_host_dir=str(self.tmp / "vtpu")),
                self.client, NODE, checkpoint=checkpoint,
                pod_cache=self.cache)
        return GPUDevicePlugin(
            FakeNvmlLib(fixture=fixture_json(self.tmp)), PluginConfig(
                device_split_count=4, socket_dir=str(self.tmp / "sock"),
                shim_host_dir=str(self.tmp / "vgpu")),
            self.client, NODE, checkpoint=checkpoint, pod_cache=self.cache)

    def add_pod(self, name):
        """the pod assigned card 0 at 2048 MiB / 30 cores, bound, in
        bind-phase=allocating, the node locked (as the scheduler leaves
        it)"""
        t = self.types
        uuid = (TPU_UUIDS if self.reference else UUIDS)[0]
        vendor = "TPU" if self.reference else "NVIDIA"
        devices = [[t.ContainerDevice(uuid=uuid, type=vendor, usedmem=2048,
                                      usedcores=30)]]
        annos = self.podutil.device_annotations(NODE, devices)
        annos[t.ASSIGNED_TIME_ANNO] = "1700000000000000000"
        annos[t.BIND_PHASE_ANNO] = "allocating"
        annos[t.BIND_TIME_ANNO] = str(time.time_ns())
        self.client.add_pod({
            "metadata": {"name": name, "namespace": "default",
                         "uid": f"uid-{name}", "annotations": annos},
            "spec": {"nodeName": NODE, "containers": [{"name": "c0"}]},
            "status": {"phase": "Pending"}})
        self.nodelock.lock_node(self.client, NODE)

    def request(self):
        return self.pb.AllocateRequest(container_requests=[
            self.pb.ContainerAllocateRequest(devicesIDs=["d0"])])

    def response(self, resp):
        """(envs, mounts) under the name map, this side's temp dir as
        ``<tmp>``"""
        (ctr,) = resp.container_responses
        envs, mounts = normalise(ctr, self.reference)[:2]
        root = str(self.tmp)
        return envs, [tuple(v.replace(root, "<tmp>") if isinstance(v, str)
                            else v for v in m) for m in mounts]

    def spans(self, name):
        pod = self.client.get_pod("default", name)
        trace = self.tracer.render_trace(self.trace_id_of_pod(pod)) or {}
        return [(s["attrs"].get("lookup"), s["attrs"].get("containers"),
                 s.get("status")) for s in trace.get("spans", [])
                if s["stage"] == "allocate"]

    def annotations(self, name):
        t = self.types
        annos = self.client.get_pod("default", name)["metadata"][
            "annotations"]
        node = self.client.get_node(NODE)["metadata"]["annotations"]
        return (annos.get(t.BIND_PHASE_ANNO),
                annos.get(t.TO_ALLOCATE_ANNO, "") == "",
                t.NODE_LOCK_ANNO in node)


def dark_allocate(side, monkeypatch):
    """tests/test_node_chaos.py::test_allocate_during_apiserver_outage on
    one side: its outcomes, in comparable form"""
    side.tracer.reset()
    side.add_pod("dark")
    plugin = side.plugin()
    side.cache.sync_once()  # the last-known-good view: pod allocating

    def dying(*a, **kw):
        raise Killed()

    monkeypatch.setattr(side.podutil,
                        "erase_next_device_type_from_annotation", dying)
    with pytest.raises(Killed):
        plugin._allocate(side.request())
    monkeypatch.undo()

    side.client.outage = True
    path = plugin.checkpoint.path
    plugin2 = side.plugin(checkpoint=side.checkpoint_cls(path))
    t0 = time.monotonic()
    resp = plugin2._allocate(side.request())
    elapsed = time.monotonic() - t0
    assert elapsed < BOUND_S, "the outage lookup must be bounded"
    (rec,) = side.checkpoint_cls(path).recorded_containers("uid-dark")
    assert dict(resp.container_responses[0].envs) == rec["envs"]
    dark = (side.response(resp), sorted(plugin2.degraded.reasons()),
            plugin2.degraded.degraded())
    side.client.outage = False
    spans_dark = side.spans("dark")
    resp2 = plugin2._allocate(side.request())
    assert dict(resp2.container_responses[0].envs) == rec["envs"]
    back = (side.response(resp2), sorted(plugin2.degraded.reasons()))
    return {"dark": dark, "back": back, "spans": spans_dark,
            "spans_after": side.spans("dark"),
            "annotations": side.annotations("dark")}


def dark_without_checkpoint(side):
    """tests/test_node_chaos.py::
    test_allocate_outage_without_checkpoint_fails_bounded on one side"""
    side.add_pod("dark2")
    plugin = side.plugin()
    side.cache.sync_once()
    side.client.outage = True
    t0 = time.monotonic()
    with pytest.raises(side.error, match="no checkpointed response") as e:
        plugin._allocate(side.request())
    assert time.monotonic() - t0 < BOUND_S
    side.client.outage = False
    return {"error": str(e.value),
            "reasons": sorted(plugin.degraded.reasons()),
            "checkpointed": side.checkpoint_cls(
                plugin.checkpoint.path).recorded_containers("uid-dark2"),
            "annotations": side.annotations("dark2")}


@pytest.fixture
def fast_retries(monkeypatch):
    monkeypatch.setenv("VTPU_ALLOCATE_RETRIES", "2")
    monkeypatch.setenv("VTPU_ALLOCATE_BACKOFF_S", "0.01")


def test_allocate_during_apiserver_outage_matches_the_reference(
        tmp_path, monkeypatch, fast_retries):
    jax = dark_allocate(Side(True, tmp_path / "jax"), monkeypatch)
    port = dark_allocate(Side(False, tmp_path / "port"), monkeypatch)
    assert port == jax
    # what the reference's own test holds, on the port
    assert port["dark"][1] == ["apiserver_unreachable"]
    assert port["back"][1] == []
    assert port["spans"] == [("cache", None, "error"),
                             ("cache-degraded", 1, "ok")]
    assert port["spans_after"][-1] == ("cache", 1, "ok")
    assert port["annotations"] == ("success", True, False)


def test_allocate_outage_without_checkpoint_fails_bounded_as_the_reference(
        tmp_path, monkeypatch, fast_retries):
    jax = dark_without_checkpoint(Side(True, tmp_path / "jax"))
    port = dark_without_checkpoint(Side(False, tmp_path / "port"))
    assert port == jax
    assert port["checkpointed"] == []
    assert port["annotations"] == ("allocating", False, True)


@pytest.mark.parametrize("state", ["pending", "completed", "absent"])
def test_pending_pod_lookup_with_a_cache_matches_the_reference(
        tmp_path, state):
    """``get_pending_pod(client, node, cache, detail)``: a cache hit is
    confirmed with a GET ("cache"); a pod whose allocation completed since
    the cache's view, or no pod at all, falls through to the LIST
    ("list"), in both packages alike."""
    out = []
    for reference in (True, False):
        side = Side(reference, tmp_path / str(reference))
        if state != "absent":
            side.add_pod("p")
        side.cache.sync_once()
        if state == "completed":
            side.client.patch_pod_annotations(
                "default", "p", {side.types.BIND_PHASE_ANNO: "success"})
        detail = {}
        pod = side.podutil.get_pending_pod(side.client, NODE,
                                           cache=side.cache, detail=detail)
        out.append((None if pod is None else pod["metadata"]["name"],
                    detail))
    assert out[1] == out[0]
    assert out[1][1]["source"] == ("cache" if state == "pending"
                                   else "list")
