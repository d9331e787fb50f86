"""The port's extender and webhook HTTP surface (vtpu_torch.scheduler.routes)
against the JAX one (vtpu.scheduler.routes): each route's status code and
body for the same request, the JAX side's strings mapped ``vTPU`` ->
``vGPU`` (tests/torch_sched_parity.py). Covers /filter (fit, no fit, no GPU
request, the Nodes form, bad JSON, shed on a full intake and on commit
backpressure, not-owner and standby refusals), /bind (bound, node locked,
fenced, failed), /webhook, /healthz, /readyz, /trace/{ns}/{name} and
/debug/traces."""

import asyncio
import json
import re

import pytest
from aiohttp.test_utils import TestClient, TestServer

from torch_sched_parity import (Pair, cards, gpu_pod, node_annos,
                                register_vendors, reset_vendors)
from vtpu.util import nodelock as jax_nodelock
from vtpu_torch.util import nodelock as port_nodelock


@pytest.fixture(autouse=True)
def vendors():
    register_vendors()
    yield
    reset_vendors()


def make_pair(n_nodes=2, **kw):
    nodes = {f"n{i}": (node_annos(cards(f"n{i}", n=4, numa=(0, 0, 1, 1))),
                       {"cloud.google.com/gke-nodepool": f"pool{i}"})
             for i in range(n_nodes)}
    return Pair(nodes, **kw)


def run(coro):
    return asyncio.new_event_loop().run_until_complete(coro)


async def _session(app, requests):
    """[(status, body)] for each (method, path, payload) sent in turn;
    a `payload` of bytes goes out raw, "concurrent" groups go at once."""
    http = TestClient(TestServer(app))
    await http.start_server()
    try:
        out = []
        for req in requests:
            if req[0] == "concurrent":
                out.extend(await asyncio.gather(
                    *(_send(http, *r) for r in req[1])))
            else:
                out.append(await _send(http, *req))
        return out
    finally:
        await http.close()


async def _send(http, method, path, payload=None):
    if isinstance(payload, bytes):
        resp = await http.request(method, path, data=payload)
    else:
        resp = await http.request(method, path, json=payload)
    text = await resp.text()
    try:
        body = json.loads(text)
    except ValueError:
        body = text
    return [resp.status, body]


def both(pair, requests, prepare=None):
    """Send `requests` to each side's app; assert the answers agree and
    return the port's. A trace id minted for a pod the scheduler never
    saw is random, and is masked."""
    answers = []
    for side in pair.sides:
        if prepare is not None:
            prepare(side)
        answers.append(json.loads(re.sub(
            r"\(trace [0-9a-f]+\)", "(trace <random>)", json.dumps(run(
                _session(side.build_app(side.sched), requests(side)))))))
        side.drain()
    assert answers[1] == pair.jax.norm(answers[0])
    return answers[1]


def admitted(pair, pod):
    pair.admit(pod)
    return pod


def filter_req(side, name, nodes=("n0", "n1")):
    return ("POST", "/filter",
            {"Pod": side.client.get_pod("default", name),
             "NodeNames": list(nodes)})


# ---------------------------------------------------------------------------
# /filter
# ---------------------------------------------------------------------------

def test_filter_fit_and_no_fit():
    pair = make_pair()
    try:
        admitted(pair, gpu_pod("fit", 2, mem=12288, cores=25))
        admitted(pair, gpu_pod("nofit", 1, mem=999999))
        (fit, nofit) = both(pair, lambda s: [filter_req(s, "fit"),
                                             filter_req(s, "nofit")])
        assert fit[0] == 200 and fit[1]["NodeNames"] == ["n0"]
        assert fit[1]["Error"] == "" and fit[1]["FailedNodes"] == {}
        assert nofit[0] == 200 and nofit[1]["NodeNames"] == []
        assert nofit[1]["Error"] == "no node fits the vGPU request"
        assert set(nofit[1]["FailedNodes"]) == {"n0", "n1"}
        pair.check_state(["fit", "nofit"])
    finally:
        pair.stop()


def test_filter_refuses_a_pod_without_a_gpu_request():
    pair = make_pair()
    try:
        (ans,) = both(pair, lambda s: [("POST", "/filter", {
            "Pod": {"metadata": {"name": "x"},
                    "spec": {"containers": [{"name": "c"}]}}})])
        assert ans == [200, {"NodeNames": [], "FailedNodes": {},
                             "Error": "pod requests no vGPU resources"}]
    finally:
        pair.stop()


def test_filter_nodes_form_returns_node_objects():
    pair = make_pair()
    try:
        admitted(pair, gpu_pod("p", 1, mem=3072))

        def reqs(side):
            node = side.client.get_node("n1")
            return [("POST", "/filter", {
                "Pod": side.client.get_pod("default", "p"),
                "Nodes": {"items": [node]}})]
        ((status, body),) = both(pair, reqs)
        assert status == 200 and body["NodeNames"] == ["n1"]
        assert [n["metadata"]["name"]
                for n in body["Nodes"]["items"]] == ["n1"]
    finally:
        pair.stop()


@pytest.mark.parametrize("path", ["/filter", "/bind", "/webhook"])
def test_bad_json_is_400(path):
    pair = make_pair()
    try:
        ((status, body),) = both(pair, lambda s: [("POST", path, b"{x")])
        assert status == 400 and "invalid JSON body" in body
    finally:
        pair.stop()


def test_filter_sheds_429_when_the_intake_is_full(monkeypatch):
    """A one-slot intake with a long gather window: the second of two
    concurrent filters finds it full."""
    monkeypatch.setenv("VTPU_FILTER_INTAKE", "1")
    monkeypatch.setenv("VTPU_FILTER_BATCH_WINDOW_MS", "300")
    pair = make_pair()
    try:
        admitted(pair, gpu_pod("a", 1, mem=3072))
        admitted(pair, gpu_pod("b", 1, mem=3072))
        (a, b) = both(pair, lambda s: [("concurrent", [
            filter_req(s, "a"), filter_req(s, "b")])])
        assert a[0] == 200 and a[1]["NodeNames"]
        assert b == [429, {"NodeNames": [], "FailedNodes": {},
                           "Error": "retryable: admission intake full "
                                    "(1 queued); retry"}]
    finally:
        pair.stop()


def test_filter_sheds_429_under_commit_backpressure():
    pair = make_pair()
    try:
        admitted(pair, gpu_pod("a", 1, mem=3072))

        def saturate(side):
            side.sched.committer.saturated = lambda: True
        ((status, body),) = both(pair, lambda s: [filter_req(s, "a")],
                                 prepare=saturate)
        assert status == 429 and body["Error"].startswith(
            "retryable: commit pipeline saturated")
    finally:
        pair.stop()


class FakeHA:
    """A multi-active coordinator that owns `owned` of the shard groups
    (or nothing, a standby)."""

    def __init__(self, owned, leader=True):
        self.owned = frozenset(owned)
        self.leader = leader
        self.role = "leader" if leader else "standby"
        self.generation = 1 if leader else 0

    def is_leader(self):
        return self.leader

    def owns(self, group):
        return group in self.owned

    def owned_groups(self):
        return self.owned

    def generation_for(self, group):
        return 1 if group in self.owned else 0

    def owner_of(self, group):
        return "sched-peer"


def test_filter_503_not_owner_and_standby():
    pair = make_pair(decide_shards=2, shard_groups=2)
    try:
        admitted(pair, gpu_pod("p", 1, mem=3072))
        groups = {s.sched.shards.group_of(n) for s in pair.sides
                  for n in ("n0", "n1")}
        assert groups == {0, 1}
        owned0 = [n for n in ("n0", "n1")
                  if pair.port.sched.shards.group_of(n) == 0]

        def owner_of_group0(side):
            side.sched.ha = FakeHA({0})
        other = [n for n in ("n0", "n1") if n not in owned0]
        (away, mine) = both(pair, lambda s: [
            filter_req(s, "p", other), filter_req(s, "p", owned0)],
            prepare=owner_of_group0)
        assert away[0] == 503 and "owned by sched-peer" in away[1]["Error"]
        assert mine[0] == 200 and mine[1]["NodeNames"] == owned0

        def standby(side):
            side.sched.ha = FakeHA((), leader=False)
        (f, b, r) = both(pair, lambda s: [
            filter_req(s, "p"),
            ("POST", "/bind", {"PodName": "p", "PodNamespace": "default",
                               "Node": "n0"}),
            ("GET", "/readyz", None)], prepare=standby)
        assert f[0] == 503 and "no shard group lease held" in f[1]["Error"]
        assert b[0] == 503
        assert r == [503, {"ready": False, "role": "standby",
                           "problems": ["standby: owns no shard group"]}]
    finally:
        pair.stop()


# ---------------------------------------------------------------------------
# /bind
# ---------------------------------------------------------------------------

def test_bind_bound_locked_and_failed(monkeypatch):
    # the refusal names the lock's time, and the two sides run one after
    # the other: both lock the node at one instant, so a second that ticks
    # between them does not tell them apart
    stamp = port_nodelock.now_str()
    for lock in (jax_nodelock, port_nodelock):
        monkeypatch.setattr(lock, "_now_str", lambda: stamp)
    pair = make_pair()
    try:
        admitted(pair, gpu_pod("p", 1, mem=3072))
        admitted(pair, gpu_pod("q", 1, mem=3072))

        def reqs(side):
            return [filter_req(side, "p"), filter_req(side, "q"),
                    ("POST", "/bind", {"PodName": "p",
                                       "PodNamespace": "default",
                                       "Node": "n0"}),
                    ("POST", "/bind", {"PodName": "q",
                                       "PodNamespace": "default",
                                       "Node": "n0"}),
                    ("POST", "/bind", {"PodName": "gone",
                                       "PodNamespace": "default",
                                       "Node": "n1"})]
        ans = both(pair, reqs)
        assert ans[2] == [200, {"Error": ""}]
        assert ans[3] == [200, {"Error": "node locked binding default/q: "
                                f"node n0 locked since {stamp}"}]
        assert ans[4][0] == 200 and ans[4][1]["Error"].startswith(
            "bind default/gone failed")
        for side in pair.sides:
            assert side.client.bindings[0]["node"] == "n0"
        pair.check_state(["p", "q"])
    finally:
        pair.stop()


def test_bind_fenced_is_503():
    pair = make_pair()
    try:
        admitted(pair, gpu_pod("p", 1, mem=3072))

        def lapsed(side):
            ha = FakeHA({0})
            ha.generation_for = lambda group: 0
            ha.generation = 0
            side.sched.ha = ha
        ((status, body),) = both(pair, lambda s: [
            ("POST", "/bind", {"PodName": "p", "PodNamespace": "default",
                               "Node": "n0"})], prepare=lapsed)
        assert status == 503 and "fenced" in body["Error"]
    finally:
        pair.stop()


# ---------------------------------------------------------------------------
# /webhook, health, traces
# ---------------------------------------------------------------------------

def test_webhook_route():
    pair = make_pair()
    try:
        review = {"apiVersion": "admission.k8s.io/v1",
                  "kind": "AdmissionReview",
                  "request": {"uid": "u1", "object": gpu_pod(
                      "w", 1, mem=3072, priority=0)}}
        ((status, body),) = both(pair, lambda s: [
            ("POST", "/webhook", json.loads(json.dumps(review)))])
        assert status == 200 and body["response"]["allowed"] is True
        assert body["response"]["patchType"] == "JSONPatch"
    finally:
        pair.stop()


def test_webhook_route_admits_when_the_handler_raises(monkeypatch):
    pair = make_pair()
    try:
        from vtpu.scheduler import webhook as jax_webhook
        from vtpu_torch.scheduler import webhook as port_webhook

        def boom(review):
            raise RuntimeError("bug")
        for mod in (jax_webhook, port_webhook):
            monkeypatch.setattr(mod, "handle_admission_review", boom)
        ((status, body),) = both(pair, lambda s: [
            ("POST", "/webhook", {"request": {"uid": "u9"}})])
        assert status == 200
        assert body["response"]["allowed"] is True
        assert body["response"]["uid"] == "u9"
    finally:
        pair.stop()


def test_health_routes():
    pair = make_pair()
    try:
        (h, r) = both(pair, lambda s: [("GET", "/healthz", None),
                                       ("GET", "/readyz", None)])
        assert h == [200, "ok"]
        assert r == [200, {"ready": True, "role": "single"}]

        def broken_watch(side):
            side.sched._watch_started = True
        ((status, body),) = both(pair, lambda s: [("GET", "/readyz", None)],
                                 prepare=broken_watch)
        assert status == 503 and body["problems"] == [
            "pod watch unhealthy (cache degraded to relist poll)"]
    finally:
        pair.stop()


def test_trace_routes():
    pair = make_pair()
    try:
        admitted(pair, gpu_pod("p", 1, mem=3072))
        for side in pair.sides:
            side.tracer.reset()
        answers = []
        for side in pair.sides:
            first = run(_session(side.build_app(side.sched),
                                 [filter_req(side, "p")]))
            # the assignment's commit span lands when the pipeline writes
            side.drain()
            answers.append(first + run(_session(side.build_app(side.sched), [
                ("GET", "/trace/default/p", None),
                ("GET", "/trace/default/nobody", None),
                ("GET", "/debug/traces?limit=5", None),
                ("GET", "/debug/traces?limit=x", None)])))
        jax, port = answers
        assert [a[0] for a in port] == [a[0] for a in jax] == [
            200, 200, 404, 200, 400]
        assert port[2] == jax[2] and port[4] == jax[4]
        # the decision agrees; span timings and process names are each
        # side's own
        assert {k: v for k, v in port[1][1]["decision"].items()
                if k != "ts"} == {
            k: v for k, v in pair.jax.norm(jax[1][1]["decision"]).items()
            if k != "ts"}
        stages = [[sp["stage"] for sp in a[1][1]["spans"]]
                  for a in (jax, port)]
        assert stages[1] == stages[0]
        assert [t["trace_id"] for t in port[3][1]["traces"]] == [
            t["trace_id"] for t in jax[3][1]["traces"]]
    finally:
        pair.stop()
