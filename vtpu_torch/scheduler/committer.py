"""Decision/commit split: pipelined apiserver writes.

The port's copy of vtpu/scheduler/committer.py.

`Scheduler.filter()` decides in memory — overlay snapshot, scoring, pod
cache write-through — and hands the durable annotation patch to this
background pipeline instead of blocking the filter verb on an apiserver
round-trip. At realistic apiserver latencies (10–50ms per call) that
synchronous patch, not scoring, bounded pod throughput: the reference
sidesteps it with client-go's write-behind informer machinery
(scheduler.go:72-133); this module is the explicit Python analog.

Shape:

  * `submit()` enqueues one pod's assignment patch. Tasks are keyed by
    `namespace/name`; a newer assignment for the same pod COALESCES over
    a still-queued older one (annotation patches are whole-assignment
    writes, so last-writer-wins is exact, and re-filters cost one RPC,
    not two). Per-pod ordering is preserved by sharding pods over
    workers by key hash — one pod's commits always execute on one
    worker, in submit order.
  * **Per-node coalescing**: a worker draining its queue merges
    up to `VTPU_COMMIT_COALESCE` queued patches that target pods on the
    SAME node into one bulk apiserver write
    (`KubeClient.patch_pods_annotations_bulk`) — a whole-deployment
    burst landing across a pool pays one RPC per node per drain window
    instead of one per pod. Every pod keeps its own uid + leadership-
    generation fencing preconditions, evaluated per item inside the
    bulk call, and per-pod ordering is untouched (coalescing only pulls
    *queued* tasks forward on the worker that already owns their keys —
    relative order across distinct pods was never guaranteed).
  * Transient patch failures retry with exponential backoff + jitter
    (`VTPU_COMMIT_RETRIES` attempts). `NotFoundError` is permanent
    immediately: the pod is gone, no retry will help.
  * The correctness crux is the **flush barrier**: `Scheduler.bind()`
    (and anything that needs the assignment durable before kubelet's
    Allocate reads it) calls `flush()` and blocks until this pod has no
    queued or in-flight commit. The barrier is strictly per-pod: a
    flushed key is PROMOTED to the front of its worker's queue, so a
    bind waits on the pod it binds, never on the unrelated backlog
    ahead of it. A permanently-failed commit surfaces there as
    `CommitFailed`, after the failure handler has retracted the cached
    assignment (`Scheduler._on_commit_failed`) — so kube-scheduler
    re-filters instead of binding against a ghost reservation.
  * `inline=True` (env `VTPU_COMMIT_PIPELINE=0`) degrades to the seed's
    synchronous write — the benchmark baseline and an operational
    escape hatch.

Env knobs (docs/commit-pipeline.md): VTPU_COMMIT_PIPELINE,
VTPU_COMMIT_WORKERS, VTPU_COMMIT_QUEUE, VTPU_COMMIT_RETRIES,
VTPU_COMMIT_COALESCE, VTPU_FLUSH_TIMEOUT_S.
"""

from __future__ import annotations

import inspect
import logging
import random
import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional, Set, Tuple

from .. import api
from ..trace import metrics as tracemetrics
from ..trace import tracer as _tracer
from ..util import lockdebug
from ..util.client import (KubeClient, NotFoundError, PreconditionError,
                           check_patch_preconditions)
from ..util.env import env_float, env_int
from ..util.types import SCHED_GEN_ANNO, PodDevices
from . import metrics as metricsmod

log = logging.getLogger(__name__)


class CommitFailed(Exception):
    """A pod's assignment patch exhausted its retries (or the pod is
    gone); the cached assignment has been retracted."""


class CommitTimeout(CommitFailed):
    """flush()/drain() gave up waiting for a pending commit."""


class StaleTargetError(Exception):
    """The pod named by the task now has a different uid — it was
    deleted and recreated while the commit waited. Permanent: the
    decision belongs to a pod that no longer exists."""


class FencedError(Exception):
    """The task was decided under a leadership generation that is no
    longer current (docs/ha.md): either our own lease lapsed/changed
    hands, or the pod already carries an assignment stamped by a NEWER
    generation. Permanent and benign — a deposed leader's in-flight
    commits failing is the fencing design working, not pipeline
    sickness."""


@dataclass
class CommitTask:
    """One pod's pending assignment patch, with enough context for the
    permanent-failure handler to retract exactly what was cached."""

    namespace: str
    name: str
    uid: str
    node_id: str
    devices: PodDevices
    annotations: Dict[str, str]
    group: Optional[str] = None  # slice gang id, for reservation release
    trace_id: str = ""           # stitches commit spans into the pod trace
    generation: int = 0          # HA fencing token (0 = not leader-gated)
    # multi-active scheduling (docs/ha.md): the SHARD GROUP whose lease
    # `generation` belongs to — the fence re-check asks for the current
    # generation OF THIS GROUP, so owning instance A's commits to group
    # 0 survive instance B taking over group 1 mid-flight. 0 is both
    # the binary pair's only group and the single-active default.
    shard_group: int = 0
    # elastic-quota resize commit (docs/elastic-quotas.md): the patch
    # rewrites an EXISTING assignment's quota, so a permanent failure
    # reverts the write-through to `prev_devices` instead of retracting
    # the pod (core._on_commit_failed) — the pod is still placed, only
    # the resize never became durable
    resize: bool = False
    prev_devices: Optional[PodDevices] = None
    # preemption phase-1 commit (docs/multihost.md ADR): the patch
    # stamps vtpu.io/preempted-by onto a VICTIM — a permanent failure
    # must neither retract nor re-add anything about the victim's
    # assignment (core._on_commit_failed evict path), and a SUCCESS
    # triggers phase 2 (the pod delete) via `post_commit`
    evict: bool = False
    # live-migration commit (docs/migration.md): the patch writes or
    # clears a vtpu.io/migrating-to stamp (phase A) or rewrites the
    # assignment to the destination (phase B cutover). A permanent
    # failure retracts the DESTINATION RESERVATION write-through — and,
    # for a failed cutover, the moved entry — so the cache re-converges
    # on the durable (still-source) truth at the next resync
    # (core._on_commit_failed migrate path).
    migrate: bool = False
    # invoked once, outside the committer's locks, after this task's
    # patch became durable — the evict protocol's phase-2 hook. Never
    # invoked on failure; a leader that dies in between is healed by
    # Scheduler.recover() replaying the delete from the durable
    # phase-1 annotation.
    post_commit: Optional[Callable[[], None]] = None
    enqueued: float = field(default_factory=time.monotonic)
    # perf_counter twin of `enqueued` for the commit.queue_wait span
    # (span starts must share the span clock domain)
    enqueued_pc: float = field(default_factory=time.perf_counter)

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}"


class Committer:
    """Bounded background pipeline for pod-assignment patches."""

    def __init__(
        self,
        client: KubeClient,
        on_permanent_failure: Optional[Callable[[CommitTask], None]] = None,
        workers: Optional[int] = None,
        queue_limit: Optional[int] = None,
        max_attempts: Optional[int] = None,
        backoff_base_s: float = 0.05,
        backoff_cap_s: float = 2.0,
        inline: bool = False,
        fence: Optional[Callable[[], int]] = None,
        coalesce: Optional[int] = None,
    ) -> None:
        self.client = client
        self.on_permanent_failure = on_permanent_failure
        # HA fencing (docs/ha.md): returns the CURRENT leadership
        # generation (0 when not validly leading). A task whose
        # generation no longer matches is refused before the patch —
        # a deposed leader must not write assignments. Under
        # multi-active scheduling the generation is PER SHARD GROUP, so
        # a group-aware fence takes the task's shard_group; zero-arg
        # fences (the binary pair, and every pre-multi-active caller)
        # keep working via the arity probe below.
        self.fence = fence
        self._fence_grouped = False
        if fence is not None:
            try:
                self._fence_grouped = len(
                    inspect.signature(fence).parameters) >= 1
            except (TypeError, ValueError):
                self._fence_grouped = False
        self.workers = max(1, workers if workers is not None
                           else env_int(api.ENV_COMMIT_WORKERS, 4))
        self.queue_limit = max(1, queue_limit if queue_limit is not None
                               else env_int(api.ENV_COMMIT_QUEUE, 1024))
        self.max_attempts = max(1, max_attempts if max_attempts is not None
                                else env_int(api.ENV_COMMIT_RETRIES, 5))
        # per-node coalescing cap: a worker merges up to this many
        # queued same-node patches into one bulk write (1 disables)
        self.coalesce = max(1, coalesce if coalesce is not None
                            else env_int(api.ENV_COMMIT_COALESCE, 16))
        self.backoff_base_s = backoff_base_s
        self.backoff_cap_s = backoff_cap_s
        self.inline = inline
        self._lock = lockdebug.lock("scheduler.committer")
        self._cond = threading.Condition(self._lock)
        self._queues: List[Deque[str]] = [deque()
                                          for _ in range(self.workers)]
        self._tasks: Dict[str, CommitTask] = {}  # queued, latest per key
        self._inflight: Set[str] = set()
        # keys a flush() is waiting on: their worker serves them first,
        # so a bind's barrier never queues behind unrelated backlog
        self._urgent: Set[str] = set()
        # key -> last permanent error; FIFO-bounded (MAX_FAILED) so
        # failures for pods that are never re-filtered through this
        # scheduler cannot grow the dict for its lifetime
        self._failed: "OrderedDict[str, str]" = OrderedDict()
        # monotonic stamps of recent NON-benign permanent failures
        # (NotFound/StaleTarget are the pod racing its own deletion, not
        # pipeline sickness) — feeds /readyz (core.readyz_problems)
        self._perm_fail_times: Deque[float] = deque(maxlen=256)
        # key -> monotonic time its last commit became durable; feeds
        # recently_committed() (bounded by pruning on insert)
        self._last_commit: "OrderedDict[str, float]" = OrderedDict()
        # victims whose evict stamp is queued or in flight: the
        # resync/watch paths consult this so a pod LIST that predates
        # the stamp cannot resurrect the victim's usage the decision
        # already granted away (core._sync_pod_list / on_add_pod).
        # Cleared when the task settles either way — on success the
        # durable annotation takes over as the guard, on permanent
        # failure the victim is MEANT to be re-added (the documented
        # self-heal).
        self._evicting: Set[str] = set()
        self._threads: List[threading.Thread] = []
        self._stop = False
        self._started = False

    # -- producer side ----------------------------------------------------

    def submit(self, namespace: str, name: str, uid: str, node_id: str,
               devices: PodDevices, annotations: Dict[str, str],
               group: Optional[str] = None, trace_id: str = "",
               generation: int = 0, shard_group: int = 0) -> None:
        """Enqueue one pod's assignment patch (or execute it synchronously
        in inline mode — the seed's behavior, exceptions propagate)."""
        self.submit_task(CommitTask(
            namespace=namespace, name=name, uid=uid, node_id=node_id,
            devices=devices, annotations=annotations, group=group,
            trace_id=trace_id, generation=generation,
            shard_group=shard_group))

    def submit_task(self, task: CommitTask) -> None:
        if self.inline or self._stop:
            with _tracer.span(task.trace_id, "commit.patch",
                              pod=task.key, mode="inline"):
                self._execute(task)
            with self._lock:
                self._note_committed_locked(task.key)
            if task.post_commit is not None:
                # NEVER synchronously: inline submits run inside the
                # producing filter's decide critical section, and the
                # hook makes its own apiserver call (the evict
                # protocol's delete) — a blocking RPC under every
                # decide lock, against an apiserver that is struggling
                # (the exact situation inline mode serves), would
                # stall admission on those shards. The hook is
                # crash-safe by design (recover() replays it from the
                # durable stamp), so a detached thread loses nothing.
                threading.Thread(
                    target=self._run_post_commit, args=(task,),
                    name="vtpu-post-commit", daemon=True).start()
            return
        with self._cond:
            self._ensure_started()
            self._enqueue_locked(task)
            self._set_depth_locked()
            self._cond.notify_all()

    def submit_many(self, tasks: List[CommitTask]) -> None:
        """Enqueue a batch decider's whole group under ONE lock hold and
        one worker wakeup — per-pod submit paid a committer-lock
        acquire plus a 4-worker notify_all per pod, which at the 1k
        pods/s front door was a measurable slice of the decide hold
        time. Inline mode degrades to per-task synchronous execution
        (seed semantics: the first failure propagates)."""
        if self.inline or self._stop:
            for task in tasks:
                self.submit_task(task)
            return
        with self._cond:
            self._ensure_started()
            for task in tasks:
                self._enqueue_locked(task)
            self._set_depth_locked()
            self._cond.notify_all()

    def _enqueue_locked(self, task: CommitTask) -> None:
        # backpressure: a full queue blocks the producer (coalescing
        # onto an already-queued key never grows the queue)
        while (len(self._tasks) >= self.queue_limit
               and task.key not in self._tasks and not self._stop):
            self._cond.wait(0.1)
        # a fresh assignment supersedes any recorded failure
        self._failed.pop(task.key, None)
        if task.key not in self._tasks:
            self._queues[self._shard(task.key)].append(task.key)
        self._tasks[task.key] = task
        if task.evict:
            self._evicting.add(task.key)
        else:
            # a same-key successor superseding a queued evict (victim
            # recreated + re-decided) clears the guard with it
            self._evicting.discard(task.key)

    def pending(self, key: str) -> bool:
        """True while `namespace/name` has a queued or in-flight commit."""
        with self._lock:
            return key in self._tasks or key in self._inflight

    def pending_keys(self) -> List[str]:
        with self._lock:
            return list(set(self._tasks) | self._inflight)

    def has_queued(self, key: str) -> bool:
        """True when a NEWER commit is queued for this pod (excludes the
        in-flight one — the permanent-failure handler runs while its own
        failed task still occupies _inflight to hold the flush barrier,
        and must not mistake itself for a successor)."""
        with self._lock:
            return key in self._tasks

    def evicting(self, key: str) -> bool:
        """True while this pod's preemption stamp is queued or in
        flight (the window between the decision's retraction and the
        durable vtpu.io/preempted-by annotation)."""
        with self._lock:
            return key in self._evicting

    def evicting_keys(self) -> List[str]:
        with self._lock:
            return list(self._evicting)

    #: retained per-key commit-completion stamps (recently_committed)
    MAX_COMMIT_STAMPS = 4096
    #: retained permanent-failure records awaiting their flush()
    MAX_FAILED = 4096

    def recently_committed(self, key: str, within_s: float) -> bool:
        """True when this pod's last commit became durable less than
        `within_s` ago. Guards the watch path: an event generated
        BEFORE the commit can be delivered AFTER it, showing the pod
        unassigned — retracting the write-through on such a stale view
        would free chips another filter could double-book before the
        commit's own MODIFIED event re-adds them."""
        with self._lock:
            t = self._last_commit.get(key)
        return t is not None and time.monotonic() - t < within_s

    def _note_committed_locked(self, key: str) -> None:
        self._last_commit[key] = time.monotonic()
        self._last_commit.move_to_end(key)
        while len(self._last_commit) > self.MAX_COMMIT_STAMPS:
            self._last_commit.popitem(last=False)

    def flush(self, namespace: str, name: str,
              timeout: Optional[float] = None) -> None:
        """Flush barrier: block until this pod has no pending commit.
        Raises CommitFailed when its last commit permanently failed (the
        failure is consumed — the caller owns the re-schedule) and
        CommitTimeout when the pipeline can't confirm in time."""
        if timeout is None:
            timeout = env_float(api.ENV_FLUSH_TIMEOUT_S, 30.0)
        key = f"{namespace}/{name}"
        deadline = time.monotonic() + timeout
        with self._cond:
            if key in self._tasks:
                # promote: this pod's worker serves urgent keys first,
                # so the barrier waits on THIS pod's commit, not on the
                # whole backlog queued ahead of it
                self._urgent.add(key)
                self._cond.notify_all()
            while key in self._tasks or key in self._inflight:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise CommitTimeout(
                        f"commit for {key} still pending after "
                        f"{timeout:.1f}s")
                self._cond.wait(min(remaining, 0.5))
            err = self._failed.pop(key, None)
        if err is not None:
            raise CommitFailed(
                f"assignment commit for {key} failed permanently: {err}")

    def saturated(self) -> bool:
        """True while submit() producers would block on backpressure —
        the /readyz signal that decisions outpace apiserver writes."""
        with self._lock:
            return len(self._tasks) >= self.queue_limit

    def recent_permanent_failures(self, window_s: float = 60.0) -> int:
        """Non-benign permanent commit failures in the last `window_s`
        (NotFound/StaleTarget — the pod vanished — are not counted)."""
        now = time.monotonic()
        with self._lock:
            return sum(1 for t in self._perm_fail_times
                       if now - t < window_s)

    def drain(self, timeout: float = 30.0) -> None:
        """Wait until the whole pipeline is empty (tests/benchmarks)."""
        deadline = time.monotonic() + timeout
        with self._cond:
            while self._tasks or self._inflight:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise CommitTimeout(
                        f"pipeline not drained after {timeout:.1f}s")
                self._cond.wait(min(remaining, 0.5))

    def close(self, timeout: float = 5.0) -> None:
        """Stop accepting queued work; workers drain what's queued, then
        exit. Post-close submits fall back to inline execution."""
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        for t in self._threads:
            t.join(timeout=timeout)

    def kill(self, timeout: float = 5.0) -> None:
        """Chaos/test hook: simulate SIGKILL — queued tasks are DROPPED
        on the floor (a dead process never patches them) and workers
        stop without draining. An RPC already in flight may still land,
        exactly as a real SIGKILL can have a write already on the wire.
        The object is dead afterwards; only the fault-injection harness
        (docs/ha.md chaos matrix) calls this."""
        with self._cond:
            self._stop = True
            for q in self._queues:
                q.clear()
            self._tasks.clear()
            self._failed.clear()
            self._urgent.clear()
            self._evicting.clear()
            self._set_depth_locked()
            self._cond.notify_all()
        for t in self._threads:
            t.join(timeout=timeout)

    # -- worker side ------------------------------------------------------

    def _fence_value(self, task: CommitTask) -> int:
        """Current fencing generation to compare `task.generation`
        against: the generation of the task's SHARD GROUP when the
        fence is group-aware, the single cluster generation otherwise."""
        if self._fence_grouped:
            return self.fence(task.shard_group)
        return self.fence()

    def _shard(self, key: str) -> int:
        return hash(key) % self.workers

    def _ensure_started(self) -> None:
        # lock held; threads start lazily so control-plane objects that
        # never schedule (tests, tools) spawn nothing
        if self._started:
            return
        self._started = True
        for i in range(self.workers):
            t = threading.Thread(target=self._worker, args=(i,),
                                 name=f"vtpu-commit-{i}", daemon=True)
            self._threads.append(t)
            t.start()

    def _set_depth_locked(self) -> None:
        metricsmod.COMMIT_QUEUE_DEPTH.set(
            len(self._tasks) + len(self._inflight))

    def _worker(self, shard: int) -> None:
        q = self._queues[shard]
        while True:
            with self._cond:
                while not q and not self._stop:
                    self._cond.wait(0.5)
                if not q:  # stopping and nothing left to drain
                    return
                batch = self._pop_batch_locked(q)
            if len(batch) == 1:
                self._run_one(batch[0])
            else:
                self._run_coalesced(batch)

    def _pop_batch_locked(self, q: Deque[str]) -> List[CommitTask]:
        """Pop the next task (urgent-flushed keys first) plus up to
        `coalesce - 1` more queued tasks targeting the SAME node — the
        per-node bulk-write window. Caller holds self._cond; every
        popped key moves to _inflight so the flush barrier stays
        closed until its outcome is recorded."""
        key: Optional[str] = None
        if self._urgent:
            for i, k in enumerate(q):
                if k in self._urgent:
                    del q[i]
                    key = k
                    break
        if key is None:
            key = q.popleft()
        self._urgent.discard(key)
        head = self._tasks.pop(key)
        self._inflight.add(key)
        batch = [head]
        if self.coalesce > 1 and q:
            picked: List[str] = []
            for other in q:
                if len(batch) + len(picked) >= self.coalesce:
                    break
                t = self._tasks.get(other)
                if t is not None and t.node_id == head.node_id:
                    picked.append(other)
            for other in picked:
                q.remove(other)
                self._urgent.discard(other)
                batch.append(self._tasks.pop(other))
                self._inflight.add(other)
        self._set_depth_locked()
        return batch

    def _run_one(self, task: CommitTask) -> None:
        err: Optional[str] = None
        benign = False
        # queue wait rides the patch span as an attr (plus its own
        # stage histogram sample) instead of a second span: half the
        # tracing work on the worker, same information in the trace
        queue_wait_s = time.perf_counter() - task.enqueued_pc
        tracemetrics.observe("commit.queue_wait", queue_wait_s)
        try:
            with _tracer.span(task.trace_id, "commit.patch",
                              pod=task.key) as sp:
                sp.set("queue_wait_ms",
                       round(queue_wait_s * 1e3, 3))
                if task.shard_group:
                    # multi-active: which group's lease fences this
                    # commit (docs/ha.md)
                    sp.set("shard_group", task.shard_group)
                    sp.set("fence_generation", task.generation)
                sp.set("attempts",
                       self._execute_with_retry(task))
        except (NotFoundError, StaleTargetError, FencedError) as e:
            # the pod raced its own deletion/recreation, or this
            # leader was deposed mid-flight — both are the system
            # working, not pipeline sickness
            benign = True
            err = str(e) or type(e).__name__
        except Exception as e:
            err = str(e) or type(e).__name__
        self._finish_task(task, err, benign)

    def _run_coalesced(self, batch: List[CommitTask]) -> None:
        """Execute a same-node batch as one bulk apiserver write; every
        task keeps its own uid + generation preconditions and its own
        per-pod outcome (one pod's failure never poisons the batch)."""
        metricsmod.COMMIT_BULK_WRITES.inc()
        metricsmod.COMMIT_COALESCED.inc(len(batch) - 1)
        # queue wait snapshots BEFORE the bulk call: the span attr must
        # agree with the histogram sample — measuring after execution
        # would bill the RPC plus any retry backoff as phantom queue
        # time exactly when the apiserver is degraded
        queue_waits: Dict[str, float] = {}
        for task in batch:
            wait_s = time.perf_counter() - task.enqueued_pc
            queue_waits[task.key] = wait_s
            tracemetrics.observe("commit.queue_wait", wait_s)
        outcomes, attempts = self._execute_bulk_with_retry(batch)
        finished: List[Tuple[CommitTask, Optional[str], bool]] = []
        for task in batch:
            exc = outcomes.get(task.key)
            err: Optional[str] = None
            benign = False
            if exc is not None:
                err = str(exc) or type(exc).__name__
                benign = isinstance(
                    exc, (NotFoundError, StaleTargetError, FencedError))
            with _tracer.span(task.trace_id, "commit.patch",
                              pod=task.key) as sp:
                sp.set("queue_wait_ms",
                       round(queue_waits[task.key] * 1e3, 3))
                if task.shard_group:
                    sp.set("shard_group", task.shard_group)
                    sp.set("fence_generation", task.generation)
                sp.set("attempts", attempts)
                sp.set("coalesced", len(batch))
                if err is not None:
                    sp.set("error", err)
            finished.append((task, err, benign))
        self._finish_tasks(finished)

    def _finish_task(self, task: CommitTask, err: Optional[str],
                     benign: bool) -> None:
        self._finish_tasks([(task, err, benign)])

    def _finish_tasks(
        self, finished: List[Tuple[CommitTask, Optional[str], bool]],
    ) -> None:
        """Record task outcomes: permanent-failure retractions run
        BEFORE the flush barrier opens (every key stays in _inflight
        until the single release below), so a bind woken by a failure
        already sees the ghost reservation gone. A coalesced batch
        releases its whole set under ONE condition hold and ONE
        notify_all — per-task wakeups were a thundering herd (every
        waiter: binders, producers, idle workers) per pod at the 1k
        pods/s front door."""
        for task, err, benign in finished:
            if err is None:
                continue
            key = task.key
            with self._lock:
                superseded = key in self._tasks
            if not superseded:
                metricsmod.COMMIT_FAILURES.inc()
                if not benign:
                    with self._lock:
                        self._perm_fail_times.append(time.monotonic())
                log.error("commit for %s permanently failed: %s",
                          key, err)
                cb = self.on_permanent_failure
                if cb is not None:
                    try:
                        cb(task)
                    except Exception:
                        log.exception(
                            "commit permanent-failure handler")
        with self._cond:
            for task, err, _benign in finished:
                key = task.key
                self._inflight.discard(key)
                if task.evict and key not in self._tasks:
                    # settled with no queued successor: on success the
                    # durable stamp guards the victim now; on failure
                    # the resync is MEANT to re-add it
                    self._evicting.discard(key)
                if err is None:
                    self._note_committed_locked(key)
                elif key not in self._tasks:
                    self._failed[key] = err
                    self._failed.move_to_end(key)
                    while len(self._failed) > self.MAX_FAILED:
                        self._failed.popitem(last=False)
            self._set_depth_locked()
            self._cond.notify_all()
        now = time.monotonic()
        for task, err, _benign in finished:
            if err is None:
                metricsmod.COMMIT_LATENCY.observe(now - task.enqueued)
                self._run_post_commit(task)

    @staticmethod
    def _run_post_commit(task: CommitTask) -> None:
        """Fire a task's phase-2 hook (the evict protocol's pod
        delete) after its patch became durable; runs OUTSIDE every
        committer lock — the hook makes its own apiserver call."""
        if task.post_commit is None:
            return
        try:
            task.post_commit()
        except Exception:
            log.exception("post-commit hook for %s failed (recovery "
                          "replays it from the durable annotation)",
                          task.key)

    def _execute_bulk_with_retry(
        self, batch: List[CommitTask],
    ) -> Tuple[Dict[str, Optional[Exception]], int]:
        """Run a same-node batch through the bulk patch verb with the
        single-task path's backoff. Per-item permanent failures
        (NotFound / precondition misses) settle immediately; items the
        transport failed wholesale retry together. Returns
        (key -> outcome exception or None, attempts used)."""
        outcomes: Dict[str, Optional[Exception]] = {}
        pending = list(batch)
        attempt = 0
        while pending:
            attempt += 1
            items: List[Tuple[CommitTask, tuple]] = []
            for t in pending:
                # fencing precondition on OUR side (docs/ha.md): a task
                # decided under a generation that is no longer ours must
                # not reach the apiserver at all — same check as
                # _execute, applied per attempt because leadership can
                # lapse between retries
                if t.generation and self.fence is not None:
                    cur = self._fence_value(t)
                    if cur != t.generation:
                        outcomes[t.key] = FencedError(
                            f"{t.key}: decided under generation "
                            f"{t.generation}, leadership is now "
                            f"{cur or 'lost'}")
                        continue
                preconds: Dict[str, object] = {}
                if t.uid:
                    preconds["uid"] = t.uid
                if t.generation:
                    # generation ceiling on the OBJECT: a newer leader
                    # already committed this pod — never rewind it
                    preconds["anno_le"] = (SCHED_GEN_ANNO, t.generation)
                items.append((t, (t.namespace, t.name, t.annotations,
                                  preconds or None)))
            if not items:
                break
            try:
                results = self.client.patch_pods_annotations_bulk(
                    [wire for _, wire in items])
            except Exception as e:
                if attempt >= self.max_attempts or self._stop:
                    for t, _ in items:
                        outcomes[t.key] = e
                    break
                metricsmod.COMMIT_RETRIES.inc()
                delay = min(self.backoff_cap_s,
                            self.backoff_base_s * (2 ** (attempt - 1)))
                delay *= 1.0 + random.random() * 0.5  # jitter
                log.warning("bulk commit of %d patches attempt %d/%d "
                            "failed (%s); retrying in %.2fs", len(items),
                            attempt, self.max_attempts, e, delay)
                time.sleep(delay)
                continue
            retry: List[CommitTask] = []
            for (t, _), res in zip(items, results):
                if res is None:
                    outcomes[t.key] = None
                elif isinstance(res, NotFoundError):
                    outcomes[t.key] = res
                elif isinstance(res, PreconditionError):
                    # uid moved -> the pod was recreated under the same
                    # name (StaleTarget); generation ceiling -> a newer
                    # leader owns the pod (Fenced) — both permanent+benign
                    if res.field == "uid":
                        outcomes[t.key] = StaleTargetError(str(res))
                    else:
                        outcomes[t.key] = FencedError(str(res))
                elif isinstance(res, Exception):
                    # per-item transient (a conservative base-class
                    # implementation may surface one): retries remain
                    if attempt >= self.max_attempts or self._stop:
                        outcomes[t.key] = res
                    else:
                        retry.append(t)
                else:  # defensive: a client returning junk is permanent
                    outcomes[t.key] = RuntimeError(
                        f"bulk patch returned {res!r}")
            if not retry:
                break
            metricsmod.COMMIT_RETRIES.inc()
            delay = min(self.backoff_cap_s,
                        self.backoff_base_s * (2 ** (attempt - 1)))
            delay *= 1.0 + random.random() * 0.5  # jitter, like every
            # other retry path: synchronized worker waves against a
            # degraded apiserver are the thundering herd jitter prevents
            log.warning("%d/%d coalesced patches transiently failed "
                        "attempt %d/%d; retrying in %.2fs", len(retry),
                        len(batch), attempt, self.max_attempts, delay)
            time.sleep(delay)
            pending = retry
        return outcomes, attempt

    def _execute_with_retry(self, task: CommitTask) -> int:
        """Run the patch with backoff; returns the attempt count that
        succeeded (the commit.patch span's `attempts` attr)."""
        for attempt in range(self.max_attempts):
            try:
                self._execute(task)
                return attempt + 1
            except (NotFoundError, StaleTargetError, FencedError):
                raise  # pod gone / leadership gone: retries cannot help
            except Exception as e:
                if attempt + 1 >= self.max_attempts or self._stop:
                    raise
                metricsmod.COMMIT_RETRIES.inc()
                delay = min(self.backoff_cap_s,
                            self.backoff_base_s * (2 ** attempt))
                delay *= 1.0 + random.random() * 0.5  # jitter
                log.warning("commit for %s attempt %d/%d failed (%s); "
                            "retrying in %.2fs", task.key, attempt + 1,
                            self.max_attempts, e, delay)
                time.sleep(delay)

    def _execute(self, task: CommitTask) -> None:
        # fencing precondition (docs/ha.md): a task decided under a
        # leadership generation that is no longer OURS must not reach
        # the apiserver — a deposed leader's queued decisions would
        # otherwise clobber the new leader's placements. Checked in
        # every mode (inline included): leadership can lapse while the
        # producing filter still holds the decide lock.
        if task.generation and self.fence is not None:
            cur = self._fence_value(task)
            if cur != task.generation:
                raise FencedError(
                    f"{task.key}: decided under generation "
                    f"{task.generation}, leadership is now "
                    f"{cur or 'lost'}")
        # uid precondition: the patch targets namespace/name, but the
        # decision belongs to a specific pod INSTANCE. A pod deleted and
        # recreated under the same name (StatefulSet churn) while the
        # commit sat in the queue must not inherit the old assignment —
        # kubelet would program chips the scheduler never granted it.
        # (The remaining get→patch window matches the seed's synchronous
        # exposure; a merge-patch cannot carry a server-side uid test.)
        # Inline mode skips the check: the patch runs synchronously
        # inside filter() with a uid read moments ago — zero queue-wait
        # staleness, and the escape hatch must keep the seed's 1-RPC
        # cost (it is used precisely when the apiserver is struggling).
        # The checks themselves are the SHARED check_patch_preconditions
        # (vtpu/util/client.py) — the bulk path evaluates the identical
        # predicate server-side, so the fencing rule can never diverge
        # between solo and coalesced commits.
        if task.uid and not self.inline:
            current = self.client.get_pod(task.namespace, task.name)
            preconds: Dict[str, object] = {"uid": task.uid}
            if task.generation:
                # generation precondition on the OBJECT: a newer leader
                # already committed this pod — even a still-valid older
                # fence must not rewind its write (the lost-update half
                # of the uid+generation precondition)
                preconds["anno_le"] = (SCHED_GEN_ANNO, task.generation)
            err = check_patch_preconditions(task.key, current, preconds)
            if isinstance(err, PreconditionError):
                if err.field == "uid":
                    raise StaleTargetError(str(err))
                raise FencedError(str(err))
        self.client.patch_pod_annotations(task.namespace, task.name,
                                          task.annotations)
