"""HTTP surface of the scheduler extender.

The port's copy of vtpu/scheduler/routes.py: the same paths, status
codes, bodies and intake batching.

Reference: pkg/scheduler/routes/route.go — the kube-scheduler extender
protocol (`/filter` route.go:41-80, `/bind` route.go:82-111) and the
admission webhook mount (`/webhook` route.go:125-134). JSON shapes follow
k8s.io/kube-scheduler/extender/v1.

Observability additions (docs/observability.md):

- ``GET /trace/{namespace}/{name}`` — the pod's stitched trace (spans +
  the DecisionTrace) from the in-process ring buffer; 404 once evicted.
- ``GET /debug/traces?limit=N`` — newest-first trace summaries.
- ``GET /readyz`` — distinct from /healthz: 503 while the pod watch is
  unhealthy or the commit pipeline is saturated/permanently failing
  (Scheduler.readyz_problems), so a rollout gate notices a scheduler
  that is alive but placing pods against stale state.

Batched admission front door: ``/filter`` requests land in a
BOUNDED intake queue (``VTPU_FILTER_INTAKE``) drained by a batcher
that groups up to ``VTPU_FILTER_BATCH`` requests per
``VTPU_FILTER_BATCH_WINDOW_MS`` window and decides them through
``Scheduler.filter_batch`` — K same-shaped pods per shard-lock
acquisition. The drain is TENANT-FAIR: requests are round-robined by
namespace, so one tenant's whole-deployment burst cannot starve
another's single pod. When the intake is full or the commit pipeline
is backpressuring, ``/filter`` sheds with an HTTP 429 retryable
refusal (counted per reason in ``vGPUAdmissionShed``) instead of
timing out opaquely; kube-scheduler requeues the pod. ``/webhook``
answers OFF the decide path entirely — admission mutation is
annotation synthesis only and never waits behind a decide lock or the
filter executor (it has its own).

HA (docs/ha.md): when the scheduler runs as a leader-elected pair
(``scheduler.ha`` set), the STANDBY answers 503 on ``/filter`` and
``/bind`` — each replica's kube-scheduler talks to its CO-LOCATED
extender over localhost, so the refusal means the standby's
kube-scheduler simply cannot place vGPU pods; only the leader's can.
``/healthz`` and ``/webhook`` stay up on both replicas (admission
mutation is stateless and must survive the failover window — the helm
Service backs only the webhook and is deliberately NOT readiness-gated
on leadership), and ``/readyz`` reports the role (standby = 503) as
the alerting/rollout surface.

Multi-active (``VTPU_SHARD_GROUPS`` > 1): ownership is per SHARD
GROUP, not binary. An instance that owns at least one group serves
``/filter``/``/bind`` and is ready (``/readyz`` lists its owned
groups); a request whose candidates live in a group owned elsewhere
gets a 503 ``NotOwnerError`` naming the owner, and kube-scheduler's
retry lands on that owner's co-located extender. Only an instance
owning NO group at all answers the blanket standby 503.
"""

from __future__ import annotations

import asyncio
import json
import logging
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict

from aiohttp import web

from .. import api
from ..trace import tracer as _tracer
from ..trace import trace_id_of_pod
from ..util import nodelock
from ..util.env import env_float, env_int
from ..util.fairqueue import FairQueue, FairQueueFull
from . import metrics as metricsmod
from . import webhook as webhookmod
from .committer import FencedError
from .core import FilterError, NotOwnerError, Scheduler, ShedError

log = logging.getLogger(__name__)

DEFAULT_EXECUTOR_WORKERS = 8
DEFAULT_WEBHOOK_WORKERS = 2
DEBUG_TRACES_DEFAULT = 20
DEBUG_TRACES_MAX = 200
#: default /filter batching knobs (docs/config.md): max pods per batch
#: decide, the gather window, and the bounded intake the batcher drains
DEFAULT_FILTER_BATCH = 64
DEFAULT_BATCH_WINDOW_MS = 2.0
DEFAULT_FILTER_INTAKE = 1024


async def _json_body(request: web.Request) -> Dict[str, Any]:
    try:
        return await request.json()
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise web.HTTPBadRequest(text=f"invalid JSON body: {e}") from e


def build_app(scheduler: Scheduler) -> web.Application:
    app = web.Application()
    # filter/bind block on locks and (for bind) apiserver RPCs: give
    # each verb its own sized executor (VTPU_EXECUTOR_WORKERS) instead
    # of the event loop's default one. The pools are SEPARATE on
    # purpose: bind can sit in the commit flush barrier for up to
    # VTPU_FLUSH_TIMEOUT_S when the apiserver lags, and a burst of such
    # binds must not occupy the slots that serve /filter — which after
    # the decision/commit split is pure in-memory compute.
    workers = env_int(api.ENV_EXECUTOR_WORKERS,
                      DEFAULT_EXECUTOR_WORKERS, minimum=1)
    filter_executor = ThreadPoolExecutor(
        max_workers=workers, thread_name_prefix="vtpu-filter")
    bind_executor = ThreadPoolExecutor(
        max_workers=workers, thread_name_prefix="vtpu-bind")
    # the webhook must answer AdmissionReview OFF the decide path: its
    # mutation is annotation synthesis only — it never takes a decide
    # lock, and it must not queue behind /filter work either (a filter
    # burst saturating the filter executor while admission stalls would
    # block every pod CREATE in the cluster)
    webhook_executor = ThreadPoolExecutor(
        max_workers=env_int(api.ENV_WEBHOOK_WORKERS,
                            DEFAULT_WEBHOOK_WORKERS, minimum=1),
        thread_name_prefix="vtpu-webhook")
    # per-shard executor fairness (sharded decide plane, shard.py): a
    # burst of filters against ONE hot node pool serializes on that
    # pool's shard lock — without a gate those requests occupy every
    # executor slot while they queue, and filters for other (idle,
    # disjoint) shards wait behind them in the pool. Cap the slots any
    # single shard may hold so at least VTPU_FILTER_SHARD_SLOTS-to-
    # `workers` slots stay available to other shards. Whole-cluster /
    # unknown-shard requests (index -1) and single-shard deployments
    # skip the gate — there is no disjoint work to protect.
    shard_slots = env_int(api.ENV_FILTER_SHARD_SLOTS,
                          max(1, workers - 2), minimum=1)
    shard_gates: Dict[int, asyncio.Semaphore] = {}

    async def _shutdown_executors(app: web.Application) -> None:
        filter_executor.shutdown(wait=False)
        bind_executor.shutdown(wait=False)
        webhook_executor.shutdown(wait=False)

    app.on_cleanup.append(_shutdown_executors)

    # -- batched intake ------------------------------------------------
    # /filter requests queue into a bounded tenant-fair intake
    # (vtpu/util/fairqueue.py — shared with the serving gateway's
    # per-model queues) drained by ONE batcher task per event loop: up
    # to `batch_cap` requests per `window_s` gather window go through
    # Scheduler.filter_batch — K same-shaped pods per shard-lock
    # acquisition. Draining is round-robin across tenants (namespaces),
    # so one tenant's burst cannot starve another's single pod.
    # VTPU_FILTER_BATCH=1 restores the classic per-request dispatch
    # (with its per-shard slot gate).
    batch_cap = env_int(api.ENV_FILTER_BATCH, DEFAULT_FILTER_BATCH,
                        minimum=1)
    window_s = env_float(api.ENV_FILTER_BATCH_WINDOW_MS,
                         DEFAULT_BATCH_WINDOW_MS, minimum=0.0) / 1e3
    intake_cap = env_int(api.ENV_FILTER_INTAKE, DEFAULT_FILTER_INTAKE,
                         minimum=1)
    # queue items are (pod, node_names, future, enqueued_pc)
    intake: Dict[str, Any] = {"queue": FairQueue(intake_cap),
                              "task": None, "loop": None}

    def _intake_reset_if_foreign_loop() -> None:
        # unit-test harnesses drive one app from several short-lived
        # event loops; futures belong to the loop that created them, so
        # a loop change orphans whatever the dead loop left behind
        loop = asyncio.get_running_loop()
        if intake["loop"] is not loop:
            intake["loop"] = loop
            intake["queue"].clear()
            intake["task"] = None

    def _decide_batch(batch):
        # executor side: stitch each request's queue-wait into its pod
        # trace (interval = HTTP arrival -> batch start), then decide
        # the whole batch in one call
        for pod, _names, _fut, enqueued_pc in batch:
            meta = pod.get("metadata", {}) or {}
            with _tracer.span(trace_id_of_pod(pod), "filter.queue_wait",
                              started_at=enqueued_pc,
                              pod=(f"{meta.get('namespace', 'default')}/"
                                   f"{meta.get('name', '')}")):
                pass
        return scheduler.filter_batch(
            [(pod, names) for pod, names, _fut, _t in batch])

    async def _batcher():
        loop = asyncio.get_running_loop()
        try:
            while len(intake["queue"]):
                if window_s > 0:
                    await asyncio.sleep(window_s)
                batch = intake["queue"].take(batch_cap)
                if not batch:
                    break
                try:
                    results = await loop.run_in_executor(
                        filter_executor, _decide_batch, batch)
                except Exception as e:  # defensive: never strand futures
                    log.exception("batch decide failed wholesale")
                    results = [(None, {}, e)] * len(batch)
                for (_pod, _names, fut, _t), res in zip(batch, results):
                    if not fut.done():
                        fut.set_result(res)
        finally:
            intake["task"] = None
            if len(intake["queue"]) and intake["loop"] is loop:
                intake["task"] = loop.create_task(_batcher())

    async def _filter_batched(pod, node_names):
        """Enqueue into the bounded intake; sheds 429-style when the
        intake or the commit pipeline is saturated."""
        _intake_reset_if_foreign_loop()
        if scheduler.committer.saturated():
            metricsmod.ADMISSION_SHED.labels("commit_backpressure").inc()
            raise ShedError(
                "commit pipeline saturated (apiserver writes lagging); "
                "retry")
        loop = asyncio.get_running_loop()
        fut = loop.create_future()
        tenant = (pod.get("metadata", {}) or {}).get("namespace",
                                                     "default")
        try:
            intake["queue"].push(
                tenant, (pod, node_names, fut, time.perf_counter()))
        except FairQueueFull:
            metricsmod.ADMISSION_SHED.labels("intake_full").inc()
            raise ShedError(
                f"admission intake full ({intake_cap} queued); retry") from None
        if intake["task"] is None:
            intake["task"] = loop.create_task(_batcher())
        winner, failed, err = await fut
        if err is not None:
            raise err
        return winner, failed

    def _role() -> str:
        return scheduler.ha.role if scheduler.ha is not None else "single"

    def _standby_refusal(verb: str):
        """503 from the extender verbs while owning NOTHING: the
        fencing complement — a standby (or fully deposed instance)
        must never decide or bind. Under multi-active, `is_leader()`
        means "owns at least one shard group": an instance owning any
        group serves the verbs (per-request group routing happens in
        the decide path via NotOwnerError), so this cheap pre-parse
        refusal fires only for the instance holding no lease at all.
        Its co-located kube-scheduler's attempt fails and the pod
        stays Pending until an owning replica's kube-scheduler picks
        it up (extender discovery is per-pod localhost, docs/ha.md)."""
        if scheduler.ha is not None and not scheduler.ha.is_leader():
            if scheduler.shards.n_groups > 1:
                return web.json_response(
                    {"Error": f"no shard group lease held; {verb} "
                              "unavailable on this instance "
                              "(multi-active, docs/ha.md)"},
                    status=503)
            return web.json_response(
                {"Error": f"standby scheduler does not serve {verb} "
                          "(leader-elected pair, docs/ha.md)"},
                status=503)
        return None

    async def filter_route(request: web.Request) -> web.Response:
        refusal = _standby_refusal("filter")
        if refusal is not None:
            return refusal
        args = await _json_body(request)
        pod = args.get("Pod", {}) or {}
        node_names = args.get("NodeNames")
        node_objs: Dict[str, Any] = {}
        if args.get("Nodes"):
            # nodeCacheCapable=false form: full node objects in, full node
            # objects out (kube-scheduler reads result.Nodes in this mode)
            items = args["Nodes"].get("items", args["Nodes"].get("Items", []))
            node_objs = {n["metadata"]["name"]: n for n in items}
            if node_names is None:
                node_names = list(node_objs)
        meta = pod.get("metadata", {}) or {}
        pod_key = (f"{meta.get('namespace', 'default')}/"
                   f"{meta.get('name', '')}")
        enqueued = time.perf_counter()
        result: Dict[str, Any] = {
            "NodeNames": [], "FailedNodes": {}, "Error": "",
        }

        def _filter_in_executor():
            # the queue-wait span measures how long this request sat
            # behind other filters for an executor slot — the interval
            # ended the moment this function started, hence the
            # backdated start and empty body
            tid = trace_id_of_pod(pod)
            with _tracer.span(tid, "filter.queue_wait",
                              started_at=enqueued, pod=pod_key):
                pass
            return scheduler.filter(pod, node_names)

        async def _dispatch():
            # scheduler.filter blocks on its shard's decide lock: keep
            # the event loop free for /webhook and /healthz
            return await asyncio.get_running_loop() \
                .run_in_executor(filter_executor, _filter_in_executor)

        try:
            if batch_cap > 1:
                # batched intake (module docstring): bounded queue ->
                # tenant-fair batcher -> Scheduler.filter_batch
                winner, failed = await _filter_batched(pod, node_names)
            else:
                shard_idx = (scheduler.shards.primary_index(node_names)
                             if scheduler.shards.count > 1 else -1)
                if shard_idx >= 0:
                    gate = shard_gates.get(shard_idx)
                    if gate is None:
                        gate = shard_gates.setdefault(
                            shard_idx, asyncio.Semaphore(shard_slots))
                    async with gate:
                        winner, failed = await _dispatch()
                else:
                    winner, failed = await _dispatch()
            result["FailedNodes"] = failed
            if winner is None:
                result["Error"] = "no node fits the vGPU request"
            else:
                result["NodeNames"] = [winner]
                if node_objs:
                    result["Nodes"] = {
                        "kind": "NodeList", "apiVersion": "v1",
                        "items": [node_objs[winner]]
                        if winner in node_objs else [],
                    }
        except ShedError as e:
            # explicit retryable refusal (intake full / commit
            # backpressure / decide-lock timeout): HTTP 429 so the
            # caller unambiguously distinguishes "come back" from "no
            # fit"; kube-scheduler requeues the pod either way
            log.info("filter shed pod %s: %s", pod_key, e)
            result["Error"] = f"retryable: {e}"
            return web.json_response(result, status=429)
        except NotOwnerError as e:
            # multi-active routing (docs/ha.md): another instance owns
            # the candidates' shard group — 503 (not 429: nothing here
            # will change by waiting) so kube-scheduler requeues and
            # the owning replica's co-located extender accepts. The
            # owner identity rides the message as the routing hint.
            log.info("filter routed away for pod %s: %s", pod_key, e)
            result["Error"] = f"retryable: {e}"
            return web.json_response(result, status=503)
        except FilterError as e:
            # protocol-level refusal (e.g. no vGPU resources requested):
            # not an internal error, but silent returns made these pods
            # undiagnosable — keep the pod key in the log
            log.info("filter refused pod %s: %s", pod_key, e)
            result["Error"] = str(e)
        except Exception as e:
            log.exception("filter failed for pod %s", pod_key)
            result["Error"] = f"internal error: {e}"
        return web.json_response(result)

    async def bind_route(request: web.Request) -> web.Response:
        refusal = _standby_refusal("bind")
        if refusal is not None:
            return refusal
        args = await _json_body(request)
        ns = args.get("PodNamespace", "default")
        name = args.get("PodName", "")
        node = args.get("Node", "")
        try:
            await asyncio.get_running_loop().run_in_executor(
                bind_executor, scheduler.bind, ns, name, node
            )
            return web.json_response({"Error": ""})
        except nodelock.NodeLockedError as e:
            log.info("bind %s/%s -> %s: node locked: %s", ns, name,
                     node, e)
            return web.json_response(
                {"Error": f"node locked binding {ns}/{name}: {e}"})
        except FencedError as e:
            # the node's shard group changed hands since the decision
            # (or was never ours): retryable — the new owner re-filters
            # and binds under its own generation (docs/ha.md)
            log.info("bind %s/%s -> %s fenced: %s", ns, name, node, e)
            return web.json_response(
                {"Error": f"retryable: bind {ns}/{name} fenced: {e}"},
                status=503)
        except Exception as e:
            tid = _tracer.trace_id_for_key(f"{ns}/{name}") or ""
            log.exception("bind %s/%s -> %s failed (trace %s)",
                          ns, name, node, tid or "-")
            return web.json_response(
                {"Error": f"bind {ns}/{name} failed: {e}"
                          + (f" (trace {tid})" if tid else "")})

    async def webhook_route(request: web.Request) -> web.Response:
        review = await _json_body(request)
        try:
            # own executor: AdmissionReview is answered off the decide
            # path — mutation is annotation synthesis only and must
            # never wait behind a decide lock or a /filter burst
            body = await asyncio.get_running_loop().run_in_executor(
                webhook_executor, webhookmod.handle_admission_review,
                review)
            return web.json_response(body)
        except Exception as e:
            # an unhandled bug here would 500 the AdmissionReview and
            # (failurePolicy permitting) block every pod create in the
            # cluster: always answer allowed, like handle_admission_review
            # does for mutation failures
            log.exception("webhook handler failed; admitting unmodified")
            uid = (review.get("request", {}) or {}).get("uid", "")
            return web.json_response({
                "apiVersion": review.get("apiVersion",
                                         "admission.k8s.io/v1"),
                "kind": "AdmissionReview",
                "response": {
                    "uid": uid, "allowed": True,
                    "warnings": [f"vtpu webhook handler error: {e}"],
                },
            })

    async def healthz(request: web.Request) -> web.Response:
        return web.Response(text="ok")

    async def readyz(request: web.Request) -> web.Response:
        role = _role()
        if role == "standby":
            # the standby is healthy (/healthz) and warm, just not
            # serving decisions: 503 + role makes that unmistakable to
            # alerting and rollout gates (the helm probes deliberately
            # do NOT use this — the Service backs the webhook, which
            # both replicas must keep serving; docs/ha.md). Its REAL
            # degradations ride along: a standby with a dead pod watch
            # would otherwise look identical to a healthy one right up
            # until it promotes from stale state. Under multi-active,
            # "standby" means owning NO shard group (an instance is
            # ready once it owns >= 1 — each group's recover() ran
            # before the coordinator admitted it to the owned set).
            why = ("standby: owns no shard group"
                   if scheduler.shards.n_groups > 1
                   else "standby: not the leader")
            return web.json_response(
                {"ready": False, "role": role,
                 "problems": [why] + scheduler.readyz_problems()},
                status=503)
        problems = scheduler.readyz_problems()
        if problems:
            return web.json_response(
                {"ready": False, "role": role, "problems": problems},
                status=503)
        body: Dict[str, Any] = {"ready": True, "role": role}
        if scheduler.shards.n_groups > 1 and scheduler.ha is not None:
            # multi-active: WHICH groups this instance answers for
            # (rollout gates and the fleet bench read this)
            body["groups"] = sorted(scheduler._owned_groups()
                                    or frozenset())
        return web.json_response(body)

    async def trace_route(request: web.Request) -> web.Response:
        ns = request.match_info["namespace"]
        name = request.match_info["name"]
        data = _tracer.trace_for_key(f"{ns}/{name}")
        if data is None:
            raise web.HTTPNotFound(
                text=f"no trace for pod {ns}/{name} "
                     "(never scheduled here, or evicted from the ring)")
        return web.json_response(data)

    async def debug_traces(request: web.Request) -> web.Response:
        try:
            limit = int(request.query.get("limit",
                                          str(DEBUG_TRACES_DEFAULT)))
        except ValueError:
            raise web.HTTPBadRequest(text="limit must be an integer") from None
        limit = max(1, min(limit, DEBUG_TRACES_MAX))
        return web.json_response({"traces": _tracer.recent(limit)})

    app.router.add_post("/filter", filter_route)
    app.router.add_post("/bind", bind_route)
    app.router.add_post("/webhook", webhook_route)
    app.router.add_get("/healthz", healthz)
    app.router.add_get("/readyz", readyz)
    app.router.add_get("/trace/{namespace}/{name}", trace_route)
    app.router.add_get("/debug/traces", debug_traces)
    return app
