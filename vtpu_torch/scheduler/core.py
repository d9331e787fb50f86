"""Scheduler extender state machine.

The port's copy of vtpu/scheduler/core.py.

Reference: pkg/scheduler/scheduler.go — the `Scheduler` struct (41-53) wiring
nodeManager + podManager, the annotation-based node registration poll
(RegisterFromNodeAnnotatons, 135-229), the usage overlay (getNodesUsage,
249-310), and the extender verbs Filter (354-402) and Bind (312-352).

Usage-overlay invariant: `get_nodes_usage` serves an incrementally-
maintained `UsageOverlay` (overlay.py) instead of rebuilding from the
pod cache per call. Every pod/node mutation writes its delta through
(PodManager/NodeManager hooks plus the filter() write-through below),
so for any candidate set `overlay.snapshot(names)` must equal the
from-scratch `overlay.rebuild(nodes, pods)`. `verify_overlay()`
cross-checks the two; set VTPU_OVERLAY_AUDIT_S=<seconds> to run that
check (and self-heal on drift) periodically from the registration
loop. benchmarks/sched_bench.py measures the resulting filter()
throughput.

Decision/commit split: `filter()` decides purely in memory under
the decide lock(s) — overlay generations + the (generation, request-
signature) verdict memo mean a burst of same-shaped pods re-fits only
the nodes mutated since their last verdict — and the durable annotation
patch rides the background commit pipeline (committer.py). `bind()`
re-joins the two with a flush barrier; a permanently-failed commit
retracts the cached assignment and fails the bind so kube-scheduler
re-filters. `--apiserver-latency-ms` in benchmarks/sched_bench.py
measures the pipelined filter→bind throughput win;
docs/commit-pipeline.md is the ADR.

Sharded decide plane (shard.py): the decide state
is partitioned into VTPU_DECIDE_SHARDS shards keyed by node pool label
(VTPU_SHARD_KEY_LABEL) / slice name, each with its own decide lock,
UsageOverlay, verdict cache, and incrementally-synced scoreboards.
`self.overlay` is the DecideShards facade (UsageOverlay-compatible), so
PodManager/NodeManager write-throughs land in each node's owner shard;
`self._decide_lock` is the all-shards ordered lock set, so every
pre-shard `with self._decide_lock:` site keeps its exact semantics.
filter() routes each candidate set to the shard(s) it touches —
disjoint-pool admissions decide concurrently, gang / slice-spanning
requests take the touched shards in canonical order
(`benchmarks/sched_bench.py --sharded` gates the win).
"""

from __future__ import annotations

import functools
import logging
import threading
import time
from typing import Dict, List, Optional, Tuple

from .. import api
from .. import device as devmod
from ..trace import decision as decisionmod
from ..trace import trace_id_for_uid, trace_id_of_pod
from ..trace import tracer as _tracer
from ..trace.decision import DecisionTrace, Rejection
from ..util import codec, nodelock, podutil, types
from ..util.client import (GoneError, KubeClient, NotFoundError,
                           PreconditionError)
from ..util.env import env_bool, env_float, env_int, env_str
from ..util.types import DeviceUsage
from . import committer as committermod
from . import metrics as metricsmod
from . import preempt as preemptmod
from . import score as scoremod
from . import shard as shardmod
from .nodes import NodeManager
from .pods import PodInfo, PodManager
from .slice import RebuiltMember, SliceReservations

log = logging.getLogger(__name__)

REGISTER_POLL_S = 15.0   # scheduler.go:227
POD_RESYNC_S = 300.0     # periodic safety relist under a live watch
# watch events generated before a commit may be delivered after it;
# an unassigned view younger than this never retracts the write-through
# (the POD_RESYNC_S relist remains the authority for real removals)
COMMIT_EVENT_GRACE_S = 30.0
WATCH_TIMEOUT_S = 60.0   # per watch request; the loop re-watches
WATCH_RETRY_S = 5.0      # backoff after a failed watch stream
# live migration (docs/migration.md): a pod carrying the durable
# vtpu.io/migrating-to stamp is accounted TWICE — its source entry plus
# a synthetic destination reservation keyed with this suffix, so the
# reserved capacity survives resyncs/failovers exactly like any other
# reconstruction-based state (make-before-break). The suffix can never
# collide with a real pod: "#" is not a valid DNS-1123 name character.
MIG_RESERVATION_SUFFIX = "#mig"
# uncooperative-workload fallback: how long a migrate-instead-of-delete
# rescue (preempt path) may wait for the snapshot ack before the
# planner falls back to the preemption delete (docs/config.md)
MIGRATE_DEADLINE_S_DEFAULT = 60.0
HANDSHAKE_REQUESTING = "Requesting"
HANDSHAKE_REPORTED = "Reported"
HANDSHAKE_DELETED = "Deleted"


class FilterError(Exception):
    pass


class ShedError(FilterError):
    """Retryable admission refusal: the front door is saturated (batch
    decide-lock acquisition timed out, intake bounded, or the commit
    pipeline is backpressuring). kube-scheduler treats the failed
    attempt like any other and requeues the pod — an explicit 429-style
    refusal instead of an opaque timeout (counted in
    vGPUAdmissionShed)."""


class NotOwnerError(FilterError):
    """Retryable refusal under multi-active scheduling (docs/ha.md):
    the candidates belong to shard group(s) another instance owns.
    routes.py renders it as a 503 naming the owner, so kube-scheduler's
    retry (or the intake forwarder) lands the pod on the instance that
    can actually decide it — the non-owner never touches state."""

    def __init__(self, message: str, group: Optional[int] = None,
                 owner: str = "") -> None:
        super().__init__(message)
        self.group = group
        self.owner = owner


class Scheduler:
    def __init__(self, client: KubeClient,
                 commit_pipeline: Optional[bool] = None,
                 decide_shards: Optional[int] = None,
                 shard_groups: Optional[int] = None) -> None:
        self.client = client
        # sharded decide plane (shard.py): per-shard lock + overlay +
        # verdicts + scoreboards. The router doubles as the
        # UsageOverlay-compatible facade PodManager/NodeManager write
        # through, so every usage delta lands in its node's owner shard.
        # `shard_groups` (VTPU_SHARD_GROUPS) is the multi-active
        # ownership granularity: shard i belongs to group i % n_groups,
        # and with a GroupCoordinator wired as self.ha this instance
        # decides only for the groups whose leases it holds.
        self.shards = shardmod.DecideShards(count=decide_shards,
                                            groups=shard_groups)
        self.overlay = self.shards
        self.nodes = NodeManager(overlay=self.overlay)
        self.pods = PodManager(overlay=self.overlay)
        self.slices = SliceReservations()
        # priority preemption (vtpu/scheduler/preempt.py): consulted
        # from _decide_locked when a pod that outranks running tenants
        # fails per-chip fitting — victim selection and the in-memory
        # retraction run under the SAME decide locks as the decision
        self.preempt = preemptmod.PreemptionEngine(self)
        # decision/commit split (committer.py): filter() decides under
        # in-memory decide lock(s) — overlay snapshot, scoring,
        # pod-cache write-through — and the durable annotation patch
        # rides the background commit pipeline; bind()'s flush barrier
        # re-joins the two. The decide locks keep concurrent filters
        # (the extender's executor serves several HTTP requests) from
        # double-booking chips; with the patch off the hot path the
        # hold time is pure compute. `_decide_lock` is the ALL-shards
        # ordered lock set: the event/recovery/registration paths that
        # predate sharding keep their exact serialization semantics,
        # while filter() itself acquires only the shard(s) its
        # candidate set touches (shard.py routing).
        self._decide_lock = self.shards.all_locks
        # node label whose value pools nodes into one decide shard
        # (slice hosts key by slice name; everything else hashes)
        self.shard_key_label = env_str(
            api.ENV_SHARD_KEY_LABEL, shardmod.DEFAULT_SHARD_KEY_LABEL)
        # bounded decide-lock acquire on the commit-failure path (was a
        # hardcoded 5.0s): how long a commit worker waits before
        # degrading to its lock-free guard (counted, not silent)
        self.decide_lock_timeout_s = env_float(
            api.ENV_DECIDE_LOCK_TIMEOUT_S, 5.0, minimum=0.0)
        # HA coordinator (vtpu/ha/coordinator.py), set by cmd/scheduler
        # when leader election is on. None = classic single-scheduler
        # deployment: no fencing, no role gating, nothing changes.
        self.ha = None
        if commit_pipeline is None:
            commit_pipeline = env_bool(api.ENV_COMMIT_PIPELINE, True)
        self.committer = committermod.Committer(
            client, on_permanent_failure=self._on_commit_failed,
            inline=not commit_pipeline, fence=self._fence_generation)
        self._stop = threading.Event()
        # set while the pod watch stream is healthy: the 15s
        # registration poll then skips its O(cluster) pod relist
        self._watch_healthy = threading.Event()
        # opt-in O(cluster) overlay consistency audit (module docstring)
        self.overlay_audit_s = env_float(api.ENV_OVERLAY_AUDIT_S, 0.0,
                                         minimum=0.0)
        self._next_audit = 0.0
        # /readyz (routes.py): the watch only counts against readiness
        # once it has actually been started — a poll-only deployment
        # (or a unit test) is degraded, not broken
        self._watch_started = False
        # permanent commit failures in the last 60s before /readyz
        # reports the commit pipeline as failing
        self.readyz_commit_failures = env_int(
            api.ENV_READYZ_COMMIT_FAILURES, 3, minimum=1)
        # live migration (docs/migration.md): rescue deadline for
        # migrate-instead-of-delete preemption victims, and the
        # process-wide migration-generation floor — every stamp this
        # process issues (planner or rescue) climbs past it, so a
        # rescue after a planner move can never reuse a generation the
        # drain coordinator already acked
        self.migrate_deadline_s = env_float(
            api.ENV_MIGRATE_DEADLINE_S, MIGRATE_DEADLINE_S_DEFAULT,
            minimum=0.0)
        self._migrate_seq = 0
        # phase-C completion watches recover() re-seeds from durable
        # vtpu.io/migrated-from breadcrumbs (pods whose cutover
        # committed but whose planner died before the destination
        # attach cleared the record); the planner drains this into its
        # in-memory _cleanup on its next poll — uid -> (ns, name, dest)
        self._migrate_cleanup_seed: Dict[str, Tuple[str, str, str]] = {}

    def note_migrate_gen(self, gen: int) -> None:
        """Raise the process-wide migration-generation floor (called by
        the planner for every stamp it issues; GIL-atomic max)."""
        if gen > self._migrate_seq:
            self._migrate_seq = gen

    def next_migrate_gen(self, fence_gen: int = 0) -> int:
        """A migration generation strictly above everything this
        process issued AND the fencing generation (monotonic across
        failovers whenever HA is on; docs/migration.md §generations)."""
        nxt = max(self._migrate_seq, fence_gen) + 1
        self._migrate_seq = nxt
        return nxt

    # ------------------------------------------------------------------
    # Node registration (reference: scheduler.go:135-229)
    # ------------------------------------------------------------------

    def register_from_node_annotations_once(self) -> None:
        """One poll: consume Reported handshakes into the inventory, expire
        stale Requesting ones (>60s → devices evicted, scheduler.go:158-190)."""
        for node in self.client.list_nodes():
            name = node["metadata"]["name"]
            annos = node.get("metadata", {}).get("annotations", {}) or {}
            labels = node.get("metadata", {}).get("labels", {}) or {}
            for handshake_anno, register_anno in devmod.known_devices.items():
                hs = annos.get(handshake_anno)
                if hs is None:
                    continue
                if hs.startswith(HANDSHAKE_REPORTED):
                    encoded = annos.get(register_anno, "")
                    try:
                        devices = codec.decode_node_devices(encoded)
                    except ValueError as e:
                        log.error("node %s: bad register annotation: %s",
                                  name, e)
                        continue
                    slice_name, host_coord = _parse_node_slice(
                        name, annos.get(types.NODE_SLICE_ANNO))
                    host_mem_mb = _parse_node_host_mem(
                        name, annos.get(types.NODE_HOST_MEM_ANNO))
                    # pool-key the node's decide shard: node-pool label
                    # first, slice name for slice hosts (a gang's
                    # candidate hosts then share one shard), hash
                    # fallback otherwise. Under the ALL-shards lock: a
                    # changed key migrates the node's overlay state
                    # between shards, which no concurrent decision may
                    # observe half-done (shard.py assign_all_locked).
                    pool_key = labels.get(self.shard_key_label, "") \
                        or slice_name
                    with self._decide_lock:
                        self.shards.assign_all_locked(name, pool_key)
                        self.nodes.add_node(name, devices, slice_name,
                                            host_coord,
                                            host_mem_mb=host_mem_mb)
                    self._patch_handshake(
                        name, handshake_anno,
                        f"{HANDSHAKE_REQUESTING}_{time.time():.0f}",
                    )
                elif hs.startswith(HANDSHAKE_REQUESTING):
                    ts = _handshake_time(hs)
                    if ts is not None and (
                        time.time() - ts > types.HANDSHAKE_TIMEOUT_S
                    ):
                        log.warning(
                            "node %s handshake stale (%.0fs); evicting "
                            "devices", name, time.time() - ts)
                        self.nodes.rm_node_devices(name)
                        self._patch_handshake(
                            name, handshake_anno,
                            f"{HANDSHAKE_DELETED}_{time.time():.0f}",
                        )

    def _fence_generation(self, group: int = 0) -> int:
        """Current leadership generation of shard group `group` (0 =
        not HA, or not validly owning it) — stamped on every decision
        and re-checked by the committer before each patch (docs/ha.md
        fencing). Multi-active coordinators expose per-group
        generations; the binary pair and single-`.generation` test
        doubles fall back to their one cluster-wide token."""
        if self.ha is None:
            return 0
        gen_for = getattr(self.ha, "generation_for", None)
        if gen_for is not None:
            return gen_for(group)
        return self.ha.generation

    def _owns_group(self, group: int) -> bool:
        """Does THIS instance validly own shard group `group`? Always
        true without HA; the binary pair owns everything-or-nothing."""
        if self.ha is None:
            return True
        owns = getattr(self.ha, "owns", None)
        if owns is not None:
            return owns(group)
        return self.ha.is_leader()

    def _owned_groups(self):
        """The shard groups this instance validly owns (None = no HA,
        no gating). Binary coordinators own {0} while leading."""
        if self.ha is None:
            return None
        og = getattr(self.ha, "owned_groups", None)
        if og is not None:
            return og()
        return frozenset({0}) if self.ha.is_leader() else frozenset()

    def _group_owner_hint(self, group: int) -> str:
        """Best-effort holder identity for a NotOwnerError 503 (empty
        when the coordinator has not observed the group's lease)."""
        if self.ha is None:
            return ""
        owner_of = getattr(self.ha, "owner_of", None)
        return owner_of(group) if owner_of is not None else ""

    def _ensure_gang_groups(
            self, node_names: Optional[List[str]]) -> None:
        """Multi-active gang pre-lock (docs/ha.md): a slice gang's
        reservation may land on a host in ANY shard group, so the
        deciding instance must own every group a candidate slice host
        lives in BEFORE taking the ordered ShardLockSet. Ownership
        consolidates rather than shares: owning the MAJORITY of the
        involved groups, this instance takes over the rest (forced,
        fencing-safe — ascending group order, and take_over()'s scoped
        recover() runs here, outside the decide locks it must
        acquire); owning a minority, it refuses retryably with the
        peer holding the most involved groups as the routing hint.
        The consolidation rule is a total order so every retry
        converges on exactly one instance: majority (ties to the
        requester) beats strict-majority peer beats the owner of the
        LOWEST involved group — the canonical consolidator when an
        N-way split leaves nobody with half. Binary pairs and HA-less
        schedulers have one group and fall straight through."""
        if self.shards.n_groups <= 1 or self.ha is None:
            return
        take_over = getattr(self.ha, "take_over", None)
        if take_over is None:
            return  # binary coordinator: single group, nothing to do
        involved = set()
        for nid, info in self.nodes.list_nodes().items():
            if info.host_coord is None:
                continue
            if node_names is not None and nid not in node_names:
                continue
            involved.add(self.shards.group_of(nid))
        if not involved:
            return  # no slice-capable candidates: scoring refuses
        owned = self._owned_groups() or frozenset()
        missing = sorted(involved - owned)
        if not missing:
            return
        # >= : a tie goes to the REQUESTING instance. With an even
        # split both sides would otherwise refuse forever, each
        # pointing at the other; concurrent take_over attempts
        # serialize on the lease CAS, so exactly one wins and the
        # loser then genuinely owns a minority and hands off.
        if len(involved & owned) * 2 >= len(involved):
            for g in missing:
                take_over(g)
            metricsmod.GANG_GROUP_TAKEOVERS.inc(len(missing))
            return
        # a peer owns more of the slice fabric than we do: hand the
        # gang off to it instead of stealing the majority of its load
        counts: Dict[str, int] = {}
        for g in missing:
            holder = self._group_owner_hint(g)
            if holder:
                counts[holder] = counts.get(holder, 0) + 1
        best = max(sorted(counts), key=lambda o: counts[o]) \
            if counts else ""
        if best and counts[best] * 2 > len(involved):
            owner = best  # a strict-majority peer: route there
        else:
            # N-way split, nobody holds half: the owner of the lowest
            # involved group consolidates — a deterministic winner,
            # or the retry would bounce between minorities forever
            low = min(involved)
            if low in owned:
                for g in missing:
                    take_over(g)
                metricsmod.GANG_GROUP_TAKEOVERS.inc(len(missing))
                return
            owner = self._group_owner_hint(low) or best
        raise NotOwnerError(
            f"slice gang spans shard groups {sorted(involved)}, "
            f"mostly owned by {owner or 'other instances'}; retry "
            f"routes there", group=missing[0], owner=owner)

    def _patch_handshake(self, node: str, anno: str, value: str) -> None:
        # only the OWNER of the node's shard group answers handshakes —
        # two schedulers flipping the same handshake annotation would
        # fight, and the annotation bus has exactly one writer per
        # direction by design. Every instance still READS Reported
        # handshakes to keep its whole-cluster inventory warm (an
        # absorbed group decides correctly the moment it is acquired).
        if not self._owns_group(self.shards.group_of(node)):
            return
        try:
            self.client.patch_node_annotations(node, {anno: value})
        except NotFoundError:
            self.nodes.rm_node_devices(node)

    def poll_once(self) -> None:
        """One registration-loop iteration: ingest node handshakes, and
        relist pods only when no healthy watch stream is maintaining
        the cache — a 15s O(cluster) relist on top of an event-driven
        cache would defeat it."""
        self.register_from_node_annotations_once()
        if not self._watch_healthy.is_set():
            self.sync_pods()
        if self.overlay_audit_s > 0:
            now = time.monotonic()
            if now >= self._next_audit:
                self._next_audit = now + self.overlay_audit_s
                self.audit_overlay()

    def registration_loop(self) -> None:
        while not self._stop.wait(REGISTER_POLL_S):
            try:
                self.poll_once()
            except Exception:
                log.exception("registration poll failed")

    def pod_watch_loop(self) -> None:
        """Event-driven pod cache: list once to prime the cache and get
        a resourceVersion, then stream watch events; history expiry
        (410 / GoneError) or any stream failure falls back to a relist.
        This is the informer role the reference fills with client-go
        (scheduler.go:72-133) — the 15s full relist becomes a
        POD_RESYNC_S safety net instead of the primary mechanism."""
        self._watch_started = True
        while not self._stop.is_set():
            try:
                rv = self.sync_pods_versioned()
                self._watch_healthy.set()
                resync_at = time.time() + POD_RESYNC_S
                while not self._stop.is_set() and time.time() < resync_at:
                    for etype, pod in self.client.watch_pods(
                            rv, timeout_s=WATCH_TIMEOUT_S):
                        meta_rv = pod.get("metadata", {}).get(
                            "resourceVersion")
                        if meta_rv:
                            rv = meta_rv
                        if etype in ("ADDED", "MODIFIED"):
                            self.on_add_pod(pod)
                        elif etype == "DELETED":
                            self.on_del_pod(pod)
                        if self._stop.is_set():
                            break
            except GoneError:
                self._watch_healthy.clear()
                log.info("pod watch history expired; relisting in %gs",
                         WATCH_RETRY_S)
                # one relist normally fixes a 410, but a persistently-
                # Gone apiserver must not drive an O(cluster)
                # relist-and-rewatch busy loop
                self._stop.wait(WATCH_RETRY_S)
            except Exception:
                self._watch_healthy.clear()
                log.exception("pod watch failed; relisting in %gs",
                              WATCH_RETRY_S)
                self._stop.wait(WATCH_RETRY_S)

    def stop(self) -> None:
        self._stop.set()
        # drain what's queued, then stop the commit workers; later
        # submits degrade to inline writes
        self.committer.close()

    def readyz_problems(self) -> List[str]:
        """Why /readyz should fail (empty = ready): a started-but-broken
        pod watch (vGPUPodWatchHealthy=0 — the cache degraded to the 15s
        relist poll), a saturated commit queue (filter() producers are
        blocking on backpressure), or repeated permanent commit failures
        (placements are being decided and then retracted)."""
        problems: List[str] = []
        if self._watch_started and not self._watch_healthy.is_set():
            problems.append(
                "pod watch unhealthy (cache degraded to relist poll)")
        if self.committer.saturated():
            problems.append(
                "commit queue saturated (apiserver writes lagging)")
        n = self.committer.recent_permanent_failures(60.0)
        if n >= self.readyz_commit_failures:
            problems.append(
                f"{n} permanent commit failure(s) in the last 60s")
        return problems

    # ------------------------------------------------------------------
    # Pod cache (reference: scheduler.go:72-133 informer handlers; rebuilt
    # by reconstruction from annotations, SURVEY.md §5.4)
    # ------------------------------------------------------------------

    def _pod_info(self, pod: Dict) -> Optional[PodInfo]:
        """Decode a pod's assignment annotations into a cache entry
        (None when the pod holds no live vGPU assignment)."""
        meta = pod.get("metadata", {})
        annos = meta.get("annotations", {}) or {}
        node = annos.get(types.ASSIGNED_NODE_ANNO)
        if not node:
            return None
        if podutil.is_pod_in_terminated_state(pod):
            return None
        if annos.get(types.PREEMPTED_BY_ANNO):
            # an evicted victim awaiting its phase-2 delete holds no
            # schedulable claim: the decision that stamped it already
            # granted its capacity to the incoming tenant — caching it
            # again would double-count the chips until kubelet's
            # teardown (recover() replays the delete from this same
            # annotation, so the state is transient by construction)
            return None
        encoded = annos.get(types.ASSIGNED_IDS_ANNO, "")
        try:
            devices = codec.decode_pod_devices(encoded)
        except ValueError:
            log.error("pod %s/%s: undecodable assignment %r",
                      meta.get("namespace"), meta.get("name"), encoded)
            return None
        return PodInfo(
            namespace=meta.get("namespace", "default"),
            name=meta.get("name", ""), uid=meta.get("uid", ""),
            node_id=node, devices=devices,
            # the host-memory reservation is durable ON the pod (the
            # webhook stamped/validated it at admission), so recovery-
            # by-reconstruction rebuilds the node host axis from the
            # same pass that rebuilds the chip aggregates
            host_mb=scoremod.host_mem_request_mb(annos),
            # preemption metadata, durable on the same bus: priority
            # (webhook-synthesized vtpu.io/task-priority), gang id, and
            # the migration-candidate mark (uid-keyed with this
            # entry, so a recycled name can't inherit a dead mark)
            priority=podutil.task_priority_of(annos),
            group=annos.get(types.SLICE_GROUP_ANNO, "") or "",
            migration_candidate=bool(
                annos.get(types.MIGRATION_CANDIDATE_ANNO)),
        )

    def _migration_reservation(self, pod: Dict) -> Optional[PodInfo]:
        """Synthesize the destination reservation entry for a pod
        carrying the durable ``vtpu.io/migrating-to`` stamp (None when
        unstamped/terminated). The stamp IS the reservation: the
        planner's write-through and every resync rebuild this same
        entry from the same annotation, so the reserved chips can never
        drift from the durable truth (verify_overlay sees one
        consistent pod cache). Priority 0 — a reservation is never a
        preemption victim — and group "" — gang machinery ignores it.
        Synthesized even for PREEMPTED_BY-stamped rescue victims, whose
        SOURCE entry _pod_info refuses: the rescue granted the source
        capacity away but the destination must stay booked."""
        meta = pod.get("metadata", {}) or {}
        annos = meta.get("annotations", {}) or {}
        stamp = annos.get(types.MIGRATING_TO_ANNO)
        if not stamp or podutil.is_pod_in_terminated_state(pod):
            return None
        try:
            _gen, dest, devices = codec.decode_migrating_to(stamp)
        except codec.CodecError as e:
            log.error("pod %s/%s: undecodable migration stamp: %s",
                      meta.get("namespace"), meta.get("name"), e)
            return None
        return PodInfo(
            namespace=meta.get("namespace", "default"),
            name=meta.get("name", "") + MIG_RESERVATION_SUFFIX,
            uid=meta.get("uid", "") + MIG_RESERVATION_SUFFIX,
            node_id=dest, devices=devices,
            # host axis reserved at the destination too: the resumed
            # workload re-charges its snapshot there (make-before-break
            # on both axes; docs/migration.md §accounting)
            host_mb=scoremod.host_mem_request_mb(annos),
            priority=types.TASK_PRIORITY_HIGH,
            group="", migration_candidate=False)

    def _apply_reservation_locked(self, namespace: str, name: str,
                                  uid: str,
                                  resv: Optional[PodInfo]) -> None:
        """Write-through (or retract) a pod's migration reservation;
        caller holds the decide lock(s) covering the destination."""
        if resv is not None:
            self.pods.add_pod(resv.namespace, resv.name, resv.uid,
                              resv.node_id, resv.devices,
                              host_mb=resv.host_mb,
                              priority=resv.priority)
        else:
            self.pods.del_pod(namespace,
                              name + MIG_RESERVATION_SUFFIX,
                              uid + MIG_RESERVATION_SUFFIX)

    def on_add_pod(self, pod: Dict) -> None:
        info = self._pod_info(pod)
        resv = self._migration_reservation(pod)
        if info is not None and self.committer.evicting(
                f"{info.namespace}/{info.name}"):
            # an event generated BEFORE the victim's in-flight evict
            # stamp would resurrect usage the decision already granted
            # to the preemptor; once the stamp settles, either the
            # durable annotation guards the pod (_pod_info refuses it)
            # or the failure self-heal wants the next event to re-add
            return
        if info is not None:
            group = (pod.get("metadata", {}).get("annotations", {})
                     or {}).get(types.SLICE_GROUP_ANNO)
            # under the decide lock (VTPU002): the event is durable
            # truth, but applying its usage delta mid-decision — between
            # a filter's overlay snapshot and its write-through — would
            # let the decision land on a view that never existed
            with self._decide_lock:
                self.pods.add_pod(info.namespace, info.name, info.uid,
                                  info.node_id, info.devices,
                                  host_mb=info.host_mb,
                                  priority=info.priority,
                                  group=info.group,
                                  migration_candidate=(
                                      info.migration_candidate))
                # migration stamp on the bus: mirror the destination
                # reservation (stamp cleared → reservation retracted —
                # the cutover/abort freed the booked capacity)
                self._apply_reservation_locked(info.namespace,
                                               info.name, info.uid,
                                               resv)
                if group:
                    # a durably-assigned gang member observed on the bus
                    # is CONFIRMED, whoever wrote it: this heals the
                    # recovery race where a dead leader's in-flight
                    # commit lands AFTER recover()'s pod list — without
                    # it, node_for could hand that member's host to a
                    # straggler (idempotent for members we confirmed
                    # ourselves)
                    self.slices.confirm_placed(
                        (info.namespace, group), info.uid, info.node_id)
            return
        meta = pod.get("metadata", {})
        annos = meta.get("annotations", {}) or {}
        if resv is not None:
            # preempt-rescue victim (PREEMPTED_BY + MIGRATING_TO): the
            # source entry is refused — the rescue granted its capacity
            # to the preemptor — but the destination reservation must
            # stay booked until cutover or the deadline fallback
            with self._decide_lock:
                self._apply_reservation_locked(
                    meta.get("namespace", "default"),
                    meta.get("name", ""), meta.get("uid", ""), resv)
            return
        if podutil.is_pod_in_terminated_state(pod):
            self.on_del_pod(pod)
            return
        if not annos.get(types.ASSIGNED_NODE_ANNO):
            # affirmatively unassigned (e.g. a bind-failure unwind
            # cleared the annotation): retract any cached assignment so
            # the chips free up before the next resync. Two guards: an
            # event generated BEFORE a commit can arrive while it is
            # still in flight (pending) or shortly AFTER it landed
            # (recently_committed) — retracting on such a stale view
            # would free chips another filter could double-book before
            # the commit's own MODIFIED event re-adds them.
            key = (f"{meta.get('namespace', 'default')}/"
                   f"{meta.get('name', '')}")
            # under the decide lock: a decision in progress has not yet
            # submitted its commit, and without the lock this retraction
            # could slip between its add_pod and submit
            with self._decide_lock:
                if (not self.committer.pending(key)
                        and not self.committer.recently_committed(
                            key, COMMIT_EVENT_GRACE_S)):
                    self.pods.del_pod(meta.get("namespace", "default"),
                                      meta.get("name", ""),
                                      meta.get("uid", ""))
        # else: assignment present but undecodable — transient garble
        # must not release a confirmed slot (see _sync_pod_list)

    def on_del_pod(self, pod: Dict) -> None:
        meta = pod.get("metadata", {})
        # decide lock (VTPU002): retraction + gang-slot release land as
        # one atomic step against concurrent decisions, so a re-solve
        # never observes the chips freed but the slot still held
        with self._decide_lock:
            self.pods.del_pod(
                meta.get("namespace", "default"), meta.get("name", ""),
                meta.get("uid", ""),
            )
            # a deleted pod's in-flight migration dies with it: the
            # destination reservation frees in the same atomic step
            self._apply_reservation_locked(
                meta.get("namespace", "default"), meta.get("name", ""),
                meta.get("uid", ""), None)
            annos = meta.get("annotations", {}) or {}
            group = annos.get(types.SLICE_GROUP_ANNO)
            if group:
                # free the gang slot so a recreated member (new uid)
                # isn't refused until the reservation TTL
                self.slices.release_pod(
                    (meta.get("namespace", "default"), group),
                    meta.get("uid", ""))

    def sync_pods(self) -> None:
        """Full resync from the API (poll-model informer). Builds the new
        view first and swaps it in atomically so a concurrent filter() never
        sees a half-rebuilt cache (and can't double-book chips)."""
        self._sync_pod_list(self.client.list_pods_all_namespaces())

    # ------------------------------------------------------------------
    # Crash recovery / standby promotion (docs/ha.md)
    # ------------------------------------------------------------------

    @staticmethod
    def _gang_member_of(pod: Dict) -> Optional[RebuiltMember]:
        """Decode one live pod's durable gang membership (None when the
        pod is not a confirmed gang member)."""
        meta = pod.get("metadata", {}) or {}
        annos = meta.get("annotations", {}) or {}
        group = annos.get(types.SLICE_GROUP_ANNO)
        node = annos.get(types.ASSIGNED_NODE_ANNO)
        uid = meta.get("uid", "")
        if not group or not node or not uid:
            return None
        if podutil.is_pod_in_terminated_state(pod):
            return None
        if annos.get(types.PREEMPTED_BY_ANNO):
            # a stamped victim must not anchor gang re-solves: its
            # eviction already granted the host away (recover()
            # finishes the delete; the gang slot was released with
            # the decision)
            return None
        slice_name, hosts = "", ()
        shape = coords = None
        block = annos.get(types.SLICE_BLOCK_ANNO, "")
        if block:
            try:
                slice_name, decoded, shape, coords = \
                    codec.decode_slice_block_mesh(block)
                hosts = tuple(decoded)
            except codec.CodecError:
                # garbled block: the member still anchors re-solves via
                # its own host; only the block affinity is lost
                log.error("pod %s/%s: undecodable slice block %r",
                          meta.get("namespace"), meta.get("name"), block)
        try:
            assigned_ns = int(annos.get(types.ASSIGNED_TIME_ANNO, "0")
                              or 0)
        except ValueError:
            assigned_ns = 0
        return RebuiltMember(
            namespace=meta.get("namespace", "default"), group=group,
            uid=uid, node=node, name=meta.get("name", ""),
            slice_name=slice_name, hosts=hosts, assigned_ns=assigned_ns,
            shape=shape, coords=tuple(coords) if coords else None)

    def recover(self, groups=None) -> int:
        """Rebuild everything the annotation bus can prove — pod cache,
        usage overlay (both already reconstruction-based), and now the
        gang reservation store — from ONE pod list. Called at startup
        and on promotion/group acquisition (vtpu/ha/), BEFORE the
        first decision is served, so a scheduler that died between a
        gang's first and last member neither strands the solved block
        nor re-solves confirmed members onto conflicting hosts.

        `groups` (multi-active scheduling, vtpu/ha/groups.py) scopes
        the SIDE-EFFECTFUL half: the preemption phase-2 replay deletes
        victim pods, and with N owners alive, only the instance
        absorbing a dead peer's groups may replay the deletes for
        nodes in THOSE groups — every owner replaying every stamp
        would be N-times delivery of an at-most-once protocol (the
        uid-preconditioned delete keeps even that safe, but the scoped
        replay is what makes it exactly-once per absorption). The
        in-memory rebuild stays global: it is idempotent, private to
        this instance, and a warm whole-cluster view is what lets the
        NEXT absorbed group decide correctly the moment its lease
        lands. Returns the number of gang member placements restored."""
        list_started = time.time()
        pods = self.client.list_pods_all_namespaces()
        self._sync_pod_list(pods)
        members = [m for m in map(self._gang_member_of, pods)
                   if m is not None]
        with self._decide_lock:
            # preserve_after: a watch event (on_add_pod confirm) that
            # lands between the LIST above and this rebuild is newer
            # than the list and is never re-delivered — the rebuild's
            # clear must not erase it
            count = self.slices.rebuild(members,
                                        preserve_after=list_started)
        # (no verdict-cache reset needed: the pod sync above bumped the
        # usage generation of every mutated node, so stale verdicts
        # already miss)
        # rebuild spans stitch into each member pod's own trace (the
        # acceptance surface: GET /trace/{ns}/{name} shows the rebuild)
        for m in members:
            with _tracer.span(trace_id_for_uid(m.uid), "ha.rebuild",
                              pod=f"{m.namespace}/{m.name}",
                              node=m.node, group=m.group):
                pass
        # preemption phase-2 replay (docs/multihost.md ADR): a live pod
        # still carrying the durable vtpu.io/preempted-by stamp means a
        # previous leader died between the fenced annotation commit and
        # the delete — finish the eviction exactly-once (the delete is
        # idempotent by uid; a recycled instance is skipped by the
        # server-side precondition). _pod_info already refused to cache
        # these pods, so their capacity stays granted to the tenant the
        # dead leader admitted.
        for p in pods:
            meta = p.get("metadata", {}) or {}
            annos = meta.get("annotations", {}) or {}
            if podutil.is_pod_in_terminated_state(p):
                continue
            if groups is not None:
                node = annos.get(types.ASSIGNED_NODE_ANNO, "")
                if node and self.shards.group_of(node) not in groups:
                    # another owner's group: ITS absorber replays this
                    # stamp (scoping doc above)
                    continue
            ns = meta.get("namespace", "default")
            name = meta.get("name", "")
            uid = meta.get("uid", "")
            mig = annos.get(types.MIGRATING_TO_ANNO, "")
            if mig:
                # in-flight live migration (docs/migration.md): the
                # sync above already rebuilt the destination
                # reservation from the durable stamp (idempotent,
                # global); the GROUP-SCOPED continuation — observing
                # the drain state and driving cutover/abort — is the
                # planner's next poll on THIS instance, exactly-once
                # per absorption because only the absorbing owner's
                # planner acts on the group. Seed the generation floor
                # so every new stamp climbs past the replayed one.
                try:
                    g, _d, _devs = codec.decode_migrating_to(mig)
                    self.note_migrate_gen(g)
                except codec.CodecError:
                    pass
                with _tracer.span(trace_id_for_uid(uid),
                                  "migrate.replay",
                                  pod=f"{ns}/{name}", replay=True):
                    pass
            elif annos.get(types.MIGRATED_FROM_ANNO):
                # cutover committed but phase C never closed: the
                # completion watch (migrated-from cleared on
                # destination attach) lived only in the dead planner's
                # memory, and _continue_moves walks reservations the
                # cutover already deleted. Re-seed the absorbing
                # planner's watch from the durable breadcrumb, or the
                # record — and the VTPU_MIGRATED_FROM env replay it
                # drives — leaks forever.
                dest = annos.get(types.ASSIGNED_NODE_ANNO, "")
                if dest:
                    self._migrate_cleanup_seed[uid] = (ns, name, dest)
            if not annos.get(types.PREEMPTED_BY_ANNO):
                continue
            if mig:
                # preempt-rescue in flight: the victim is being MOVED,
                # not killed. Before its deadline the phase-2 delete
                # must NOT replay — the planner watchdog owns the move
                # (and falls back to this very delete on expiry); past
                # the deadline the delete replays exactly-once below.
                deadline = 0.0
                try:
                    deadline = float(
                        annos.get(types.MIGRATE_DEADLINE_ANNO, "0")
                        or 0)
                except ValueError:
                    pass
                if deadline and time.time() < deadline:
                    continue
            with _tracer.span(trace_id_for_uid(uid), "preempt.evict",
                              pod=f"{ns}/{name}",
                              preempted_by=annos.get(
                                  types.PREEMPTED_BY_ANNO, ""),
                              replay=True):
                self._complete_eviction(ns, name, uid, replay=True)
        return count

    def sync_pods_versioned(self) -> str:
        """Full resync that also returns the list's resourceVersion so
        the watch loop can resume from exactly this snapshot."""
        pods, rv = self.client.list_pods_with_version()
        self._sync_pod_list(pods)
        return rv

    def _sync_pod_list(self, pods: List[Dict]) -> None:
        entries: List[PodInfo] = []
        live_uids = set()
        live_keys = set()
        listed_keys = set()
        gang_confirms: List[Tuple[Tuple[str, str], str, str]] = []
        for pod in pods:
            meta = pod.get("metadata", {})
            k = (f"{meta.get('namespace', 'default')}/"
                 f"{meta.get('name', '')}")
            listed_keys.add(k)
            annos_k = meta.get("annotations", {}) or {}
            if not podutil.is_pod_in_terminated_state(pod) \
                    and not annos_k.get(types.PREEMPTED_BY_ANNO):
                # a stamped preemption victim is dead walking: its
                # write-through was retracted with the decision and
                # must NOT be preserved by the commit-grace window —
                # its capacity already belongs to the incoming tenant
                live_keys.add(k)
            # live = any non-terminated pod, INCLUDING ones whose
            # assignment annotation is transiently undecodable — a gang
            # member must not lose its confirmed slot (and get its host
            # double-booked by a re-solve) because one poll saw a
            # garbled annotation
            if not podutil.is_pod_in_terminated_state(pod):
                live_uids.add(meta.get("uid", ""))
            info = self._pod_info(pod)
            if info is not None:
                entries.append(info)
                group = (meta.get("annotations", {})
                         or {}).get(types.SLICE_GROUP_ANNO)
                if group:
                    gang_confirms.append((
                        (info.namespace, group), info.uid, info.node_id))
            # migration reservation: rebuilt from the durable stamp in
            # the SAME pass (recovery-by-reconstruction) — including
            # rescue victims whose source entry _pod_info refused
            resv = self._migration_reservation(pod)
            if resv is not None:
                entries.append(resv)
        # decision/commit split: a list snapshot taken while a commit is
        # in flight — or evaluated by the apiserver just before a commit
        # that has since landed — predates that pod's annotation patch.
        # Keep the write-through entry in both cases; the pipeline owns
        # its durability (and its retraction, should the commit
        # permanently fail), and the next resync sees the durable
        # annotations agree.
        # under the decide lock so the preserve check and the swap are
        # atomic against a decision between its add_pod and submit
        # (whose commit would not be visible as pending yet)
        with self._decide_lock:
            pending = set(self.committer.pending_keys())
            evicting = set(self.committer.evicting_keys())
            if evicting:
                # a pod LIST fetched before an in-flight evict stamp
                # landed still shows the victim fully assigned and
                # unstamped — rebuilding its entry would double-count
                # the chips the decision granted to the preemptor
                # (transiently rejecting arrivals on the node and
                # inviting an unnecessary extra victim). Drop such
                # entries; the stamp's own MODIFIED/DELETED events and
                # the next resync converge on the durable truth.
                entries = [e for e in entries
                           if f"{e.namespace}/{e.name}" not in evicting]
                live_keys -= evicting
            have = {f"{e.namespace}/{e.name}" for e in entries}
            for p in self.pods.list_pods():
                k = f"{p.namespace}/{p.name}"
                if k in have:
                    continue
                if p.name.endswith(MIG_RESERVATION_SUFFIX):
                    # a reservation write-through whose migrating-to
                    # stamp is still in flight (or just landed): the
                    # list predates the stamp — the commit pipeline
                    # owns the reservation exactly like an assignment
                    base = (f"{p.namespace}/"
                            f"{p.name[:-len(MIG_RESERVATION_SUFFIX)]}")
                    if base in pending or base in evicting \
                            or self.committer.recently_committed(
                                base, COMMIT_EVENT_GRACE_S):
                        entries.append(p)
                    continue
                # a pod LISTED as terminated releases its usage
                # regardless (its commit may still land on the
                # terminated object — a harmless stale annotation,
                # never counted usage)
                if k in pending and k not in listed_keys:
                    # queued commit for a pod the list doesn't show at
                    # all: either deleted (the commit fails NotFound
                    # and retracts) or created after the list was
                    # evaluated — keep the write-through, the pipeline
                    # owns it
                    entries.append(p)
                elif k in live_keys and (
                        k in pending
                        or self.committer.recently_committed(
                            k, COMMIT_EVENT_GRACE_S)):
                    entries.append(p)
            self.pods.replace_all(entries)
            # durably-assigned gang members seen by this list are
            # CONFIRMED (same healing as on_add_pod: a dead leader's
            # in-flight commit landing after a rebuild's list must not
            # leave the member invisible to node_for)
            for gkey, uid, node in gang_confirms:
                self.slices.confirm_placed(gkey, uid, node)
        # gang members whose pod went away free their slice slot here —
        # the poll loop is the only delete signal in production (there
        # is no informer; on_del_pod is the in-process fast path).
        # Safe outside the decide lock: RECONCILE_GRACE_S means a member
        # confirmed by an in-flight decision (whose uid this pre-list
        # snapshot cannot contain yet) is never reaped.
        # vtpulint: ignore[VTPU002] guarded by reconcile's grace window, not the decide lock (comment above)
        self.slices.reconcile(live_uids)

    # ------------------------------------------------------------------
    # Usage overlay (reference: getNodesUsage scheduler.go:249-310)
    # ------------------------------------------------------------------

    def get_nodes_usage(
        self, node_names: Optional[List[str]] = None
    ) -> Dict[str, List[DeviceUsage]]:
        """Incremental overlay snapshot: O(candidates x chips), not
        O(cluster) — the seed's per-call rebuild survives only as
        `verify_overlay()`'s cross-check (overlay.rebuild)."""
        return self.overlay.snapshot(node_names)

    def inspect_all_nodes_usage(self) -> Dict[str, List[DeviceUsage]]:
        """Metrics feed (reference: scheduler.go:232-234)."""
        return self.get_nodes_usage()

    def verify_overlay(self) -> List[str]:
        """Cross-check the incremental overlay against the from-scratch
        rebuild; returns discrepancies (empty == consistent). O(cluster);
        used by tests and the opt-in periodic audit. Holds the pod-cache
        lock so a write-through landing mid-check cannot masquerade as
        drift."""
        with self.pods.lock:
            return self.overlay.diff_against(self.nodes.list_nodes(),
                                             self.pods.list_pods())

    def audit_overlay(self) -> List[str]:
        """Opt-in consistency audit (VTPU_OVERLAY_AUDIT_S): report any
        drift and self-heal the usage aggregates from the pod cache so
        one accounting bug cannot skew placements forever. The whole
        verify+heal runs under the pod-cache lock — a concurrent
        add_pod between the pod-list read and the aggregate reset
        would otherwise have its delta erased, CREATING drift."""
        with self.pods.lock:
            problems = self.verify_overlay()
            if problems:
                log.error(
                    "usage overlay drifted from pod cache (healing): %s",
                    "; ".join(problems[:10]))
                # the decide lock is NOT needed: pods.lock (held)
                # serializes every usage writer, and inventory writers
                # run on this same registration-loop thread
                # vtpulint: ignore[VTPU002] serialized by pods.lock + registration-thread affinity (comment above)
                self.overlay.reset_inventory(self.nodes.list_nodes())
                # vtpulint: ignore[VTPU002] serialized by pods.lock + registration-thread affinity (comment above)
                self.overlay.reset_usage(self.pods.list_pods())
            return problems

    # ------------------------------------------------------------------
    # Filter (reference: scheduler.go:354-402)
    # ------------------------------------------------------------------

    def filter(
        self, pod: Dict, node_names: Optional[List[str]] = None
    ) -> Tuple[Optional[str], Dict[str, str]]:
        """Pick the best node, write the assignment annotations; returns
        (winner or None, per-node failure reasons — renderings of the
        structured Rejections the DecisionTrace records)."""
        meta = pod.get("metadata", {}) or {}
        key = (f"{meta.get('namespace', 'default')}/"
               f"{meta.get('name', '')}")
        trace_id = trace_id_of_pod(pod)
        with metricsmod.FILTER_LATENCY.time():
            with _tracer.span(trace_id, "filter.decide", pod=key) as sp:
                winner, failed = self._filter(pod, node_names, trace_id,
                                              sp)
                sp.set("winner", winner or "")
                return winner, failed

    def _filter(
        self, pod: Dict, node_names: Optional[List[str]],
        trace_id: str, sp=None,
    ) -> Tuple[Optional[str], Dict[str, str]]:
        requests = [
            self._container_request(ctr)
            for ctr in podutil.all_containers(pod)
        ]
        if sum(r.nums for r in requests) == 0:
            raise FilterError("pod requests no vGPU resources")
        # route the candidate set to the shard(s) it touches: the decide
        # lock(s) serialize the in-memory decision (snapshot -> score ->
        # write-through) so concurrent filters can never both claim the
        # same chip budget — but filters over DISJOINT shards now run
        # concurrently. Gang members consult + mutate the global slice
        # store and may land on any shard's host: the rare
        # slice-spanning case takes every shard lock in canonical order
        # (shard.py ShardLockSet). The apiserver patch happens OUTSIDE
        # the critical section, on the commit pipeline — the hold time
        # is pure compute.
        annos0 = pod.get("metadata", {}).get("annotations", {}) or {}
        if annos0.get(types.SLICE_GROUP_ANNO):
            # gang member: consolidate ownership of every involved
            # shard group FIRST — take_over()'s scoped recover() must
            # run before this thread holds any decide lock
            self._ensure_gang_groups(node_names)
            route = self.shards.route(None)
        else:
            route = self.shards.route(node_names)
        if sp is not None:
            # per-shard trace attribute: which decide domain(s) served
            # this pod (docs/observability.md)
            sp.set("shards", route.names())
        if len(route.shards) == 1:
            route.shards[0].filters_metric.inc()
        else:
            metricsmod.DECIDE_MULTI_SHARD_FILTERS.inc()
        with route.lockset:
            winner, failed, dtrace = self._decide_locked(
                pod, node_names, requests, trace_id, route)
        if (sp is not None and winner is not None
                and self.shards.n_groups > 1):
            # multi-active observability: which group's lease fenced
            # this decision (binary traces stay byte-identical)
            g = self.shards.group_of(winner)
            sp.set("shard_group", g)
            sp.set("fence_generation", self._fence_generation(g))
        if dtrace is not None:
            # emitted AFTER the lock: decision() renders rejections and
            # (with VTPU_TRACE_JOURNAL set) writes a file — disk I/O
            # must never sit inside the lock every filter serializes on
            _tracer.decision(dtrace)
        # the wire protocol's FailedNodes wants strings: render the
        # structured rejections (memoized — shared through the verdict
        # cache, one string build per generation+signature, not per
        # filter call)
        return winner, {nid: str(why) for nid, why in failed.items()}

    # ------------------------------------------------------------------
    # Batch admission: K same-shaped pods per lock acquisition
    # ------------------------------------------------------------------

    def filter_batch(
        self, items: List[Tuple[Dict, Optional[List[str]]]],
    ) -> List[Tuple[Optional[str], Dict[str, str], Optional[Exception]]]:
        """Decide a burst of pods, grouping them by (route, request
        signature) so each same-shaped group pays ONE shard-lock
        acquisition: the first pod fits against the overlay, the rest
        ride the verdict cache + scoreboard `changes_since` resync —
        O(nodes mutated), typically just the previous winner, instead
        of K full decisions. Cross-shard gangs keep the ordered
        ShardLockSet path (they go through plain filter()).

        Each item is `(pod, node_names)`; the result list is positional
        with the input: `(winner, failed-node renderings, error)` where
        `error` carries this pod's FilterError/ShedError instead of
        aborting the batch. Decisions inside a group run in input
        order, so a batch of K same-shaped pods is byte-identical to K
        sequential `filter()` calls on the same seed state
        (tests/test_batch_admission.py pins this)."""
        n = len(items)
        results: List[Optional[Tuple]] = [None] * n
        pre: List[Optional[Tuple]] = [None] * n
        plan: "Dict[Tuple, List[int]]" = {}
        for i, (pod, node_names) in enumerate(items):
            try:
                requests = [
                    self._container_request(ctr)
                    for ctr in podutil.all_containers(pod)
                ]
                if sum(r.nums for r in requests) == 0:
                    raise FilterError("pod requests no vGPU resources")
            # any parse failure (malformed quantities included, not just
            # FilterError) is THIS pod's result — one bad pod on a
            # retry loop must never poison its 63 batch-mates
            # vtpulint: ignore[VTPU004] not swallowed: the exception IS this pod's result, re-raised/rendered by the caller per item
            except Exception as e:
                results[i] = (None, {}, e)
                continue
            annos0 = pod.get("metadata", {}).get("annotations", {}) or {}
            if annos0.get(types.SLICE_GROUP_ANNO):
                # gang member: global slice store + possibly any shard's
                # host — keeps the ordered all-shards ShardLockSet path
                plan[("gang", i)] = [i]
                pre[i] = (pod, node_names, None, None)
                continue
            route = self.shards.route(node_names)
            sig = scoremod.request_signature(requests, annos0)
            plan.setdefault((id(route), sig), []).append(i)
            pre[i] = (pod, node_names, requests, route)
        # dict preserves first-occurrence order, and each group keeps
        # input order — grouping is deterministic, never a reordering
        # of same-shaped pods
        for gkey, idxs in plan.items():
            if gkey[0] == "gang":
                i = idxs[0]
                pod, node_names = pre[i][0], pre[i][1]
                try:
                    winner, failed = self.filter(pod, node_names)
                    results[i] = (winner, failed, None)
                # vtpulint: ignore[VTPU004] not swallowed: the exception IS this pod's result, re-raised/rendered by the caller per item
                except Exception as e:
                    results[i] = (None, {}, e)
                continue
            self._filter_group(pre[idxs[0]][3], idxs, pre, results)
        return results  # type: ignore[return-value]

    def _filter_group(self, route: shardmod.Route, idxs: List[int],
                      pre: List, results: List) -> None:
        """One same-shaped group under one (bounded) lockset hold; a
        timed-out acquire sheds the whole group retryably instead of
        stalling the intake behind a hot shard."""
        batch_size = len(idxs)
        metricsmod.ADMISSION_BATCH_SIZE.observe(batch_size)
        if len(route.shards) == 1:
            route.shards[0].filters_metric.inc(batch_size)
        else:
            metricsmod.DECIDE_MULTI_SHARD_FILTERS.inc(batch_size)
        if not route.lockset.acquire(timeout=self.decide_lock_timeout_s):
            metricsmod.ADMISSION_SHED.labels(
                "decide_lock_timeout").inc(batch_size)
            for i in idxs:
                results[i] = (None, {}, ShedError(
                    f"decide lock(s) {route.names()} not acquired in "
                    f"{self.decide_lock_timeout_s:.1f}s; retry"))
            return
        dtraces: List[DecisionTrace] = []
        try:
            # vtpulint: ignore[VTPU012] lockset held via the bounded acquire above (shed-on-timeout needs a timeout the `with` form cannot express)
            self._decide_batch_locked(route, idxs, pre, results,
                                      batch_size, dtraces)
        finally:
            route.lockset.release()
        # emitted AFTER the locks: decision() renders rejections and
        # (with VTPU_TRACE_JOURNAL set) writes a file — disk I/O must
        # never sit inside locks a whole burst serializes on
        for d in dtraces:
            _tracer.decision(d)

    def _decide_batch_locked(self, route: shardmod.Route,
                             idxs: List[int], pre: List, results: List,
                             batch_size: int,
                             dtraces: List[DecisionTrace]) -> None:
        """The in-lock half of a batch group; caller holds every lock
        in `route` (VTPU012). Per-pod failures record into `results`
        instead of aborting the group. The group's commit tasks submit
        through ONE committer-lock hold at the end (still under the
        decide locks, so no resync can catch a cached decision without
        its pending commit)."""
        sink: List[committermod.CommitTask] = []
        for i in idxs:
            pod, node_names, requests, _ = pre[i]
            meta = pod.get("metadata", {}) or {}
            key = (f"{meta.get('namespace', 'default')}/"
                   f"{meta.get('name', '')}")
            trace_id = trace_id_of_pod(pod)
            try:
                with metricsmod.FILTER_LATENCY.time():
                    with _tracer.span(trace_id, "filter.decide",
                                      pod=key) as sp:
                        winner, failed, dtrace = self._decide_locked(
                            pod, node_names, requests, trace_id, route,
                            submit_sink=sink)
                        sp.set("winner", winner or "")
                        sp.set("batch_size", batch_size)
                        sp.set("shards", route.names())
                        if dtrace is not None:
                            sp.set("verdict_hits", dtrace.cache_hits)
                if dtrace is not None:
                    dtraces.append(dtrace)
                results[i] = (
                    winner,
                    {nid: str(why) for nid, why in failed.items()},
                    None)
            # vtpulint: ignore[VTPU004] not swallowed: the exception IS this pod's result, re-raised/rendered by the caller per item
            except Exception as e:
                results[i] = (None, {}, e)
        if sink:
            self.committer.submit_many(sink)

    def _decide_locked(
        self, pod: Dict, node_names: Optional[List[str]],
        requests: List[types.ContainerDeviceRequest],
        trace_id: str = "",
        route: Optional[shardmod.Route] = None,
        submit_sink: Optional[List[committermod.CommitTask]] = None,
    ) -> Tuple[Optional[str], Dict[str, object],
               Optional[DecisionTrace]]:
        """The in-memory decision; caller holds `route`'s decide
        lock(s) — every shard the candidate set touches (the `_locked`
        suffix is the contract hack/vtpulint.py VTPU002 checks
        mutations against). Returns rejections as structured Rejection
        objects plus the populated DecisionTrace; the caller
        renders/emits both OUTSIDE the locks."""
        if route is None:  # direct callers (tests): all shards
            route = self.shards.route(None)
        # fencing starts at decision time: with HA on, a generation of 0
        # means our lease validity lapsed (or we never led) — deciding
        # anyway would submit UNFENCED commits (generation-0 tasks skip
        # the committer's preconditions), the exact split-brain write
        # path fencing exists to close. Refuse before touching any
        # state; kube-scheduler retries and reaches the live leader.
        n_groups = self.shards.n_groups
        allowed_shards = None
        if n_groups <= 1 or self.ha is None:
            generation = self._fence_generation()
            if self.ha is not None and generation == 0:
                raise FilterError(
                    "not the validly-leased leader (fencing generation "
                    "0); refusing to decide")
        else:
            # multi-active (docs/ha.md): decide only over the shard
            # groups whose leases WE validly hold — the winner's group
            # generation is stamped at commit-build time below, per
            # group. Candidates in another owner's groups are excluded
            # from scoring (structured NODE_GROUP_NOT_OWNED rejections
            # ride FailedNodes); an instance owning none of the touched
            # shards refuses retryably with the owner hint routes.py
            # turns into a 503 redirect.
            owned = self._owned_groups()
            if not owned:
                raise NotOwnerError(
                    "no shard group lease held (fencing generation 0 "
                    "everywhere); refusing to decide")
            allowed_shards = frozenset(
                i for i in range(self.shards.count)
                if self.shards.shard_group(i) in owned)
            touched = [sh.index for sh in route.shards]
            if not any(i in allowed_shards for i in touched):
                g = self.shards.shard_group(touched[0])
                owner = self._group_owner_hint(g)
                raise NotOwnerError(
                    f"candidates belong to shard group {g} owned by "
                    f"{owner or 'another instance'}; retry routes there",
                    group=g, owner=owner)
            generation = 0  # per-winner-group, resolved at stamp time
        annos = pod.get("metadata", {}).get("annotations", {}) or {}
        meta0 = pod.get("metadata", {})
        dtrace = None
        if _tracer.enabled:
            dtrace = DecisionTrace(
                trace_id or trace_id_of_pod(pod),
                meta0.get("namespace", "default"), meta0.get("name", ""),
                meta0.get("uid", ""), time.time())
        gang_key = None
        group = annos.get(types.SLICE_GROUP_ANNO)
        if group:
            # multi-host gang member: restrict scoring to the host this
            # pod's reservation assigns (docs/multihost.md)
            try:
                n_hosts = int(annos.get(types.SLICE_HOSTS_ANNO, "0"))
            except ValueError:
                n_hosts = 0
            if n_hosts <= 0:
                raise FilterError(
                    f"slice-group pod needs a positive "
                    f"{types.SLICE_HOSTS_ANNO} annotation")
            gang_key = (meta0.get("namespace", "default"), group)
            candidates = {
                nid: (info.slice_name, info.host_coord)
                for nid, info in self.nodes.list_nodes().items()
                if info.host_coord is not None
                and (node_names is None or nid in node_names)
            }
            node, reason = self.slices.node_for(
                gang_key, meta0.get("uid", ""), n_hosts, candidates)
            if node is None:
                rej = Rejection(decisionmod.NODE_SLICE_GANG,
                                {"group": group, "reason": reason},
                                message=f"slice gang: {reason}")
                if dtrace is not None:
                    dtrace.gang = {"group": group, "hosts": n_hosts,
                                   "reserved_host": None}
                    dtrace.add_rejection("*", rej)
                return None, {"*": rej}, dtrace
            node_names = [node]
            if dtrace is not None:
                dtrace.gang = {"group": group, "hosts": n_hosts,
                               "reserved_host": node}
        # the cache is maintained by the 15s registration loop plus the
        # write-through below; a per-call full relist would block the HTTP
        # loop for O(cluster) on every scheduling attempt
        scores, failed = self._score_candidates_locked(
            route, node_names, requests, annos, dtrace,
            allowed_shards=allowed_shards)
        if scores is None:
            rej = Rejection(decisionmod.NODE_NO_NODES)
            if dtrace is not None:
                dtrace.add_rejection("*", rej)
            return None, {"*": rej}, dtrace
        if dtrace is not None:
            # candidates/fit_count were recorded by the scorer (the
            # scoreboard path returns top-K, not every fitting node)
            for nid, why in failed.items():
                dtrace.add_rejection(nid, why)
        if not scores:
            # priority preemption (vtpu/scheduler/preempt.py): before
            # refusing a pod that outranks running tenants, search for
            # a minimal victim set whose eviction makes the fit
            # succeed — victim retraction + the requester's re-score
            # run inside THIS critical section, so no concurrent
            # filter can claim the freed capacity first
            scores = self._preempt_fit_locked(
                pod, node_names, requests, annos, failed,
                trace_id or trace_id_of_pod(pod),
                generation=generation, route=route,
                submit_sink=submit_sink, dtrace=dtrace,
                allowed_shards=allowed_shards)
            if not scores:
                if gang_key is not None:
                    # the reserved host stopped fitting: drop the
                    # whole reservation, marking the full host so the
                    # next re-solve prefers a block around it instead
                    # of deterministically re-picking the same one
                    self.slices.invalidate(gang_key,
                                           failed_host=node_names[0],
                                           pod_uid=meta0.get("uid", ""))
                return None, failed, dtrace
        winner = scores[0]
        shard_group = 0
        if n_groups > 1 and self.ha is not None:
            # per-group fencing (docs/ha.md): the stamp carries the
            # generation of the WINNER's shard group — instance A's
            # commits to its groups survive any other group changing
            # hands mid-flight. A generation gone 0 here means this
            # very group moved between the owned-set snapshot and now:
            # nothing is cached yet, so refuse retryably.
            shard_group = self.shards.group_of(winner.node_id)
            generation = self._fence_generation(shard_group)
            if generation == 0:
                owner = self._group_owner_hint(shard_group)
                raise NotOwnerError(
                    f"shard group {shard_group} lost mid-decision "
                    f"(now {owner or 'unowned'}); retry",
                    group=shard_group, owner=owner)
        if dtrace is not None:
            dtrace.winner = winner.node_id
            dtrace.score = winner.score
            dtrace.breakdown = winner.breakdown
            dtrace.devices = winner.devices
            dtrace.runners_up = [
                (s.node_id, s.score)
                for s in scores[1:1 + DecisionTrace.MAX_RUNNERS_UP]]
        meta = pod["metadata"]
        assign_annos = podutil.device_annotations(winner.node_id,
                                                  winner.devices)
        # durable stitch key rides the assignment commit: on a real
        # apiserver the webhook ran before the UID existed and could
        # not stamp it (webhook.py); trace_id here is annotation-or-
        # UID-derived, so re-stamping an existing value is idempotent
        assign_annos[types.TRACE_ID_ANNO] = trace_id or \
            trace_id_of_pod(pod)
        if generation:
            # fencing stamp (docs/ha.md): lets a later, older-generation
            # commit be refused by the committer's object precondition
            assign_annos[types.SCHED_GEN_ANNO] = str(generation)
        if gang_key is not None:
            # durable gang state: the solved block rides the member's
            # assignment commit, so a restarted/promoted scheduler
            # rebuilds the reservation instead of re-solving a
            # half-placed gang onto a conflicting block
            blk = self.slices.block_of(gang_key)
            if blk is not None:
                assign_annos[types.SLICE_BLOCK_ANNO] = \
                    codec.encode_slice_block(*blk)
        if self.committer.inline:
            # synchronous mode keeps the seed's patch-BEFORE-cache
            # ordering: a failed patch raises here, before any
            # write-through or gang confirmation exists to unwind
            self.committer.submit(
                meta.get("namespace", "default"), meta.get("name", ""),
                meta.get("uid", ""), winner.node_id, winner.devices,
                assign_annos, group=group, trace_id=trace_id,
                generation=generation, shard_group=shard_group,
            )
        # cache immediately so back-to-back Filters see the usage
        # (the reference relies on its informer seeing its own patch) —
        # including the node-level host-memory reservation, so the very
        # next decision fits against the committed host axis
        self.pods.add_pod(
            meta.get("namespace", "default"), meta.get("name", ""),
            meta.get("uid", ""), winner.node_id, winner.devices,
            host_mb=scoremod.host_mem_request_mb(annos),
            # a just-admitted best-effort pod is immediately visible
            # to the preemption engine's victim search
            priority=podutil.task_priority_of(annos),
            group=group or "",
        )
        if gang_key is not None:
            # the member is confirmed at decision time; a permanently-
            # failed commit releases it again (_on_commit_failed), so an
            # assignment that never became durable cannot pin the pod to
            # an infeasible host
            self.slices.confirm_placed(gang_key, meta.get("uid", ""),
                                       winner.node_id)
        if not self.committer.inline:
            # decision done — the durable annotation patch rides the
            # pipeline; bind()'s flush barrier waits for it. A batch
            # decide passes a sink so its whole group submits under one
            # committer-lock hold (submit_many) — still INSIDE the
            # decide lock, so a concurrent resync always sees either no
            # cache entry or a pending commit, never the gap between.
            task = committermod.CommitTask(
                namespace=meta.get("namespace", "default"),
                name=meta.get("name", ""), uid=meta.get("uid", ""),
                node_id=winner.node_id, devices=winner.devices,
                annotations=assign_annos, group=group,
                trace_id=trace_id, generation=generation,
                shard_group=shard_group)
            if submit_sink is not None:
                submit_sink.append(task)
            else:
                self.committer.submit_task(task)
        return winner.node_id, failed, dtrace

    def _score_candidates_locked(
        self, route: shardmod.Route,
        node_names: Optional[List[str]],
        requests: List[types.ContainerDeviceRequest],
        annos: Dict[str, str],
        dtrace: Optional[DecisionTrace] = None,
        allowed_shards=None,
    ) -> Tuple[Optional[List[scoremod.NodeScore]], Dict[str, Rejection]]:
        """Score the candidate set shard by shard; the caller holds
        every lock in `route`. Two regimes per shard (shard.py):

        * the candidate set COVERS the shard (pool-aligned nodeSelector
          workloads, whole-cluster filters) → the shard's scoreboard: a
          persistently-scored set synced by the overlay mutation log,
          so a burst of same-shaped pods pays O(nodes mutated since the
          last same-shaped decision) — typically just the previous
          winner — instead of O(candidates) per-node verdict probes;
        * a candidate subset → the (generation, request-signature)
          verdict memo against the shard-local cache, exactly the
          pre-shard path.

        Returns (None, {}) when no candidate has a registered
        inventory. `dtrace` (when tracing) receives the aggregated
        cache-hit/miss provenance."""
        sig = scoremod.request_signature(requests, annos)
        if route.groups is None and node_names is not None:
            # candidate set narrowed AFTER routing (the gang path picks
            # its reserved host under the all-shards route): split the
            # named nodes by owner shard — every lock is already held
            split: Dict[int, List[str]] = {}
            for n in node_names:
                split.setdefault(self.shards.shard_index(n),
                                 []).append(n)
            parts = [(self.shards.shards[i], g)
                     for i, g in sorted(split.items())]
        elif route.groups is None:
            parts = [(sh, None) for sh in route.shards]
        else:
            parts = [(sh, route.groups.get(sh.index, []))
                     for sh in route.shards]
        scores: List[scoremod.NodeScore] = []
        failed: Dict[str, Rejection] = {}
        if allowed_shards is not None:
            # multi-active scheduling: shards in groups another
            # instance owns never score here — their NAMED candidates
            # surface as structured owner-hint rejections instead of
            # silently vanishing from FailedNodes (whole-shard parts
            # simply belong to the other owner's decide plane)
            kept = []
            for sh, grp in parts:
                if sh.index in allowed_shards:
                    kept.append((sh, grp))
                elif grp is not None:
                    g = self.shards.shard_group(sh.index)
                    rej = Rejection(
                        decisionmod.NODE_GROUP_NOT_OWNED,
                        {"group": g,
                         "owner": self._group_owner_hint(g)})
                    for nid in grp:
                        failed[nid] = rej
            parts = kept
        hits = misses = registered = fit_total = 0
        for sh, group in parts:
            if group is None:
                whole, extras = True, ()
            else:
                # coverage memoized per (route, shard) and keyed by the
                # shard's inventory epoch — repeat filters over the
                # same candidate list pay one dict probe, not an
                # O(candidates) subset check
                epoch = sh.overlay.inventory_epoch()
                cov = route.coverage.get(sh.index)
                if cov is None or cov[0] != epoch:
                    gset = route.group_sets.get(sh.index) \
                        or frozenset(group)
                    covered, ex = sh.coverage_shard_locked(gset)
                    cov = (epoch, covered, ex)
                    route.coverage[sh.index] = cov
                whole, extras = cov[1], cov[2]
            for nid in extras:
                # named-but-unregistered candidates carry a structured
                # rejection instead of silence
                failed[nid] = Rejection(decisionmod.NODE_UNREGISTERED)
            if whole:
                top, nfit, sfailed, h, m, reg = \
                    sh.score_shard_locked(sig, requests, annos)
            else:
                top, nfit, sfailed, h, m, reg = \
                    sh.score_nodes_shard_locked(group, sig, requests,
                                                annos)
            scores.extend(top)
            failed.update(sfailed)
            hits += h
            misses += m
            registered += reg
            fit_total += nfit
        if dtrace is not None:
            dtrace.cache_hits = hits
            dtrace.cache_misses = misses
            # recorded here because the scoreboard path returns only
            # each shard's best-first top-K, not every fitting node
            dtrace.candidates = registered + sum(
                1 for why in failed.values()
                if why.code == decisionmod.NODE_UNREGISTERED)
            dtrace.fit_count = fit_total
        if not registered:
            return None, {}
        scores.sort(key=lambda r: (-r.score, r.node_id))
        return scores, failed

    # ------------------------------------------------------------------
    # Priority preemption (vtpu/scheduler/preempt.py, docs/multihost.md)
    # ------------------------------------------------------------------

    def _rescue_destination_locked(
        self, v: PodInfo, exclude_node: str,
        route: shardmod.Route, allowed_shards=None,
    ) -> Optional[scoremod.NodeScore]:
        """Migration-instead-of-delete (docs/migration.md): score a
        destination for a victim about to be evicted, over the nodes
        whose decide locks the caller's route already holds (never a
        lock nobody took), excluding the node the preemptor is taking.
        None = no destination fits — the victim falls back to the
        classic delete."""
        reqs = [types.ContainerDeviceRequest(
                    nums=len(ctr), type=ctr[0].type,
                    memreq=max(cd.usedmem for cd in ctr),
                    coresreq=max(cd.usedcores for cd in ctr))
                for ctr in v.devices if ctr]
        if not reqs:
            return None
        idx = {sh.index for sh in route.shards}
        if allowed_shards is not None:
            idx &= set(allowed_shards)
        pool = [n for n in self.nodes.list_nodes()
                if n != exclude_node
                and self.shards.shard_index(n) in idx]
        if not pool:
            return None
        annos = ({types.HOST_MEM_ANNO: str(v.host_mb)}
                 if v.host_mb else {})
        scores, _ = self._score_candidates_locked(
            route, pool, reqs, annos, None,
            allowed_shards=allowed_shards)
        # a pre-named route scores its own group lists (node_names is
        # advisory there): drop the excluded node post-hoc so a victim
        # is never "rescued" onto the very capacity the preemptor is
        # taking (the pinned regression in tests/test_migrate.py)
        scores = [s for s in (scores or [])
                  if s.node_id != exclude_node]
        return scores[0] if scores else None

    def _preempt_fit_locked(
        self, pod: Dict, node_names: Optional[List[str]],
        requests: List[types.ContainerDeviceRequest],
        annos: Dict[str, str], failed: Dict[str, object],
        trace_id: str, generation: int = 0,
        route: Optional[shardmod.Route] = None,
        submit_sink: Optional[List[committermod.CommitTask]] = None,
        dtrace: Optional[DecisionTrace] = None,
        allowed_shards=None,
    ) -> List[scoremod.NodeScore]:
        """The decide path's preemption hook; caller holds every decide
        lock the candidate set touches (the `_locked` contract VTPU002/
        VTPU015 check). Searches for a minimal lower-priority victim
        set, executes phase 1 of the evict protocol (in-memory
        retraction + the fenced durable `vtpu.io/preempted-by` commit
        whose post-commit hook deletes the pod), records the PREEMPTED/
        NO_VICTIMS DecisionTrace + spans + metrics, and re-scores the
        requester against the freed capacity. Returns the fresh scores
        ([] = preemption could not cure the failure)."""
        meta = pod.get("metadata", {}) or {}
        key = (f"{meta.get('namespace', 'default')}/"
               f"{meta.get('name', '')}")
        req_priority = podutil.task_priority_of(annos)
        plan, had_eligible = self.preempt.plan_locked(
            node_names, requests, annos, req_priority, failed)
        if plan is None:
            if had_eligible or req_priority < types.TASK_PRIORITY_DEFAULT:
                # the engine ENGAGED — lower-priority tenants existed,
                # or the arrival outranks the default tier (a
                # guaranteed pod's refusal is always worth explaining,
                # including the pinned guaranteed-never-a-victim case
                # where every resident is equally guaranteed). The
                # counted, traced refusal the acceptance criteria
                # name; ordinary best-effort no-fit stays silent.
                metricsmod.PREEMPTION_FAILED.labels("no_victims").inc()
                if dtrace is not None:
                    dtrace.preemption = {"result": "NO_VICTIMS",
                                         "priority": req_priority}
                with _tracer.span(trace_id, "preempt.decide", pod=key,
                                  result="no_victims",
                                  priority=req_priority):
                    pass
            return []
        shard_group = 0
        if self.shards.n_groups > 1 and self.ha is not None:
            # per-group fencing: the victims live on plan.node, so the
            # evict stamps carry ITS group's generation. A generation
            # of 0 means the plan landed on a group we do not (or no
            # longer) own — evicting there would mutate another
            # owner's state; refuse before touching anything.
            shard_group = self.shards.group_of(plan.node)
            generation = self._fence_generation(shard_group)
            if generation == 0:
                metricsmod.PREEMPTION_FAILED.labels(
                    "group_not_owned").inc()
                return []
        victims_detail = preemptmod.victim_trace_detail(plan)
        by_key = preemptmod.preemptor_key(
            meta.get("namespace", "default"), meta.get("name", ""))
        evict_tasks: List[committermod.CommitTask] = []
        for v in plan.victims:
            # phase 1a, in memory: the victim's usage leaves the
            # overlay NOW, under the decide locks — the re-score below
            # sees the freed chips and no concurrent filter can race us
            # to them. VTPU002 satisfied by the *_locked contract.
            self.pods.del_pod(v.namespace, v.name, v.uid)
            if v.group:
                # an evicted gang member frees its slice slot in the
                # same atomic step (a recreated member re-solves)
                self.slices.release_pod((v.namespace, v.group), v.uid)
            evict_annos: Dict[str, str] = {
                types.PREEMPTED_BY_ANNO: by_key}
            if generation:
                evict_annos[types.SCHED_GEN_ANNO] = str(generation)
            # migrate-instead-of-delete (docs/migration.md): a
            # migratable best-effort victim with destination capacity
            # inside the locked route gets MOVED — the rescue stamp
            # rides the SAME fenced evict commit (the preemptor's
            # capacity grant is identical either way: the in-memory
            # retraction above already freed the source), the
            # destination reservation write-through lands in this same
            # critical section, and the phase-2 delete is replaced by
            # the planner's drain→cutover. The deadline bounds the
            # workload's cooperation: past it, the planner (or
            # recover()) falls back to exactly this delete — a
            # guaranteed arrival is never delayed either way.
            rescue = None
            if v.migration_candidate and not v.group \
                    and self.migrate_deadline_s > 0:
                rescue = self._rescue_destination_locked(
                    v, plan.node, route, allowed_shards)
            post_commit = functools.partial(
                self._complete_eviction, v.namespace, v.name, v.uid)
            if rescue is not None:
                mgen = self.next_migrate_gen(generation)
                evict_annos[types.MIGRATING_TO_ANNO] = \
                    codec.encode_migrating_to(mgen, rescue.node_id,
                                              rescue.devices)
                evict_annos[types.MIGRATE_DEADLINE_ANNO] = \
                    f"{time.time() + self.migrate_deadline_s:.3f}"
                post_commit = None
                self.pods.add_pod(
                    v.namespace, v.name + MIG_RESERVATION_SUFFIX,
                    v.uid + MIG_RESERVATION_SUFFIX, rescue.node_id,
                    rescue.devices, host_mb=v.host_mb,
                    priority=types.TASK_PRIORITY_HIGH)
                metricsmod.MIGRATIONS.labels("rescue").inc()
            evict_tasks.append(committermod.CommitTask(
                namespace=v.namespace, name=v.name, uid=v.uid,
                node_id=v.node_id, devices=v.devices,
                annotations=evict_annos,
                trace_id=trace_id_for_uid(v.uid),
                generation=generation, evict=True,
                shard_group=shard_group,
                post_commit=post_commit))
            # the victim's own trace shows who evicted it and why —
            # the other half of the acceptance surface
            with _tracer.span(trace_id_for_uid(v.uid), "preempt.evict",
                              pod=f"{v.namespace}/{v.name}",
                              node=v.node_id, preempted_by=by_key,
                              victim_priority=v.priority,
                              rescued_to=(rescue.node_id
                                          if rescue else ""),
                              freed_mb=preemptmod.victim_mb(v)):
                pass
        # phase 1b, durable: the fenced preempted-by stamps ride the
        # commit pipeline; phase 2 (the uid-preconditioned delete)
        # fires from each task's post-commit hook. Submission happens
        # inside the decide locks like every decision commit, so a
        # resync can never observe the retraction without its pending
        # stamp.
        if submit_sink is not None and not self.committer.inline:
            submit_sink.extend(evict_tasks)
        else:
            for t in evict_tasks:
                self.committer.submit_task(t)
        reason = "defrag" if plan.all_defrag else "capacity"
        metricsmod.PREEMPTIONS.labels(reason).inc()
        metricsmod.PREEMPTION_VICTIMS.inc(len(plan.victims))
        if dtrace is not None:
            dtrace.preemption = {
                "result": "PREEMPTED", "node": plan.node,
                "reason": reason, "victims": victims_detail,
                "freed_mb": plan.freed_mb,
                "freed_host_mb": plan.freed_host_mb,
            }
        with _tracer.span(trace_id, "preempt.decide", pod=key,
                          result="preempted", node=plan.node,
                          victims=len(plan.victims),
                          freed_mb=plan.freed_mb, reason=reason):
            pass
        log.info("preempted %d pod(s) on %s (freed %d MB HBM, %d MB "
                 "host) for %s: %s", len(plan.victims), plan.node,
                 plan.freed_mb, plan.freed_host_mb, key,
                 [d["pod"] for d in victims_detail])
        # re-score against the freed capacity (the del_pod write-
        # throughs bumped the mutated node's generation, so boards/
        # verdicts resync exactly the victim node). The caller MUST
        # hand us the route whose locks it holds — constructing one
        # here would score under locks nobody took.
        assert route is not None, \
            "_preempt_fit_locked requires the caller's locked route"
        scores, refreshed = self._score_candidates_locked(
            route, node_names, requests, annos, None,
            allowed_shards=allowed_shards)
        if not scores:
            # the simulation is the same fit_pod over the same
            # snapshot, so this is unreachable in a correct engine —
            # defensive: the victims are already evicted (their stamps
            # are durable-bound), the requester simply retries
            log.error("preemption freed capacity on %s but the "
                      "re-score still refuses %s — requester will "
                      "re-filter", plan.node, key)
            return []
        failed.update(refreshed)
        for s in scores:
            failed.pop(s.node_id, None)
        return scores

    def _complete_eviction(self, namespace: str, name: str,
                           uid: str, replay: bool = False) -> None:
        """Phase 2 of the evict protocol: delete the victim, idempotent
        by uid — runs from the committer's post-commit hook (never
        under a decide lock) and from recover()'s replay after a
        leader died between the phases."""
        # a victim dying mid-rescue takes its destination reservation
        # with it (recover() rebuilds the reservation BEFORE replaying
        # an expired-deadline delete — without this it would squat the
        # destination chips until the next full resync)
        resv = self.pods.get(namespace, name + MIG_RESERVATION_SUFFIX,
                             uid + MIG_RESERVATION_SUFFIX)
        if resv is not None:
            with self.shards.route([resv.node_id]).lockset:
                # vtpulint: ignore[VTPU002] destination shard's route lockset held by the lexical with above — reservation teardown, no decide state touched
                self.pods.del_pod(namespace,
                                  name + MIG_RESERVATION_SUFFIX,
                                  uid + MIG_RESERVATION_SUFFIX)
        try:
            self.client.delete_pod(namespace, name, uid=uid)
            log.info("preemption: deleted victim %s/%s%s", namespace,
                     name, " (recovery replay)" if replay else "")
        except NotFoundError:
            log.debug("preemption: victim %s/%s already gone",
                      namespace, name)
        except PreconditionError:
            # the name now belongs to a NEW pod instance: the old
            # victim is gone and the new pod must live
            log.info("preemption: victim %s/%s was recreated "
                     "(uid moved); delete skipped", namespace, name)
        except Exception as e:
            # transient apiserver failure: the durable preempted-by
            # stamp replays this delete on the next recover()
            log.warning("preemption: delete of victim %s/%s failed "
                        "(recovery replays from the durable stamp): %s",
                        namespace, name, e)

    def _on_commit_failed(self, task: committermod.CommitTask) -> None:
        """A commit that exhausted its retries leaves the apiserver
        without the assignment: retract the write-through (unless a newer
        assignment replaced it), release the gang slot, and best-effort
        mark bind-phase failed so kube-scheduler re-filters instead of
        binding against a ghost reservation.

        Runs under the decide lock so the supersession check and the
        retraction are atomic against a concurrent re-filter of the same
        pod: a re-decision either completed before we got the lock (its
        submit is then visible as pending -> we skip) or starts after we
        release it (the retraction targeted only the old entry). The
        acquire is bounded (VTPU_DECIDE_LOCK_TIMEOUT_S) — if the decide
        locks are starved (e.g. submit backpressure) we degrade to the
        unlocked match-based guard rather than deadlocking the commit
        worker, and the timeout is COUNTED (vGPUDecideLockTimeouts) so
        a starved commit path is an alertable signal, not a silent
        slow-path."""
        if task.evict:
            # a preemption phase-1 stamp that never became durable:
            # the victim was already retracted in memory and its own
            # durable assignment is untouched — the next resync simply
            # re-adds it (a transient overlay overcommit that blocks
            # NEW admissions onto the phantom capacity until a later
            # decision re-preempts). Nothing here may write durable
            # state: on the fenced path the new leader owns the pod,
            # and on the apiserver-broken path the delete would fail
            # exactly like the stamp did.
            log.error("preemption stamp for victim %s permanently "
                      "failed; victim survives until a later decision "
                      "re-preempts (resync restores its accounting)",
                      task.key)
            if task.annotations \
                    and types.MIGRATING_TO_ANNO in task.annotations:
                # a rescue stamp that never became durable: the
                # destination reservation write-through must go too —
                # the surviving victim keeps only its source claim
                locked = self._decide_lock.acquire(
                    timeout=self.decide_lock_timeout_s)
                try:
                    # vtpulint: ignore[VTPU002] decide lock held via the bounded acquire above
                    self.pods.del_pod(
                        task.namespace,
                        task.name + MIG_RESERVATION_SUFFIX,
                        task.uid + MIG_RESERVATION_SUFFIX)
                finally:
                    if locked:
                        self._decide_lock.release()
            return
        locked = self._decide_lock.acquire(
            timeout=self.decide_lock_timeout_s)
        if not locked:
            metricsmod.DECIDE_LOCK_TIMEOUTS.inc()
            log.warning(
                "decide locks not acquired in %.1fs; commit-failure "
                "retraction for %s/%s degrades to the lock-free guard",
                self.decide_lock_timeout_s, task.namespace, task.name)
        try:
            # per-key ordering means no NEWER commit can have completed
            # while this one was in flight — a successor can only be
            # queued, so has_queued alone decides supersession
            if self.committer.has_queued(task.key):
                return  # a newer decision owns this pod's state
            current = self.pods.get(task.namespace, task.name, task.uid)
            if task.migrate:
                # a migration commit that never became durable: drop
                # the destination reservation write-through either way
                # vtpulint: ignore[VTPU002] decide lock held via the bounded acquire above (docstring)
                self.pods.del_pod(task.namespace,
                                  task.name + MIG_RESERVATION_SUFFIX,
                                  task.uid + MIG_RESERVATION_SUFFIX)
                if types.ASSIGNED_NODE_ANNO in (task.annotations
                                                or {}) \
                        and current is not None \
                        and current.node_id == task.node_id \
                        and current.devices == task.devices:
                    # failed CUTOVER: the write-through already moved
                    # the entry to the destination but the durable
                    # truth still says source+stamp — retract the
                    # moved entry; the next resync rebuilds source
                    # entry AND reservation from the annotations
                    # vtpulint: ignore[VTPU002] decide lock held via the bounded acquire above (docstring)
                    self.pods.del_pod(task.namespace, task.name,
                                      task.uid)
                log.error("migration commit for %s permanently failed; "
                          "reservation retracted (durable annotations "
                          "still hold the source assignment)", task.key)
                return
            if task.resize:
                # a failed RESIZE commit leaves the pod's OLD quota as
                # the durable truth: revert the write-through so
                # admission fit matches the annotations again (the pod
                # stays placed — retracting it would free chips a
                # durably-assigned pod still owns)
                if (current is not None
                        and current.node_id == task.node_id
                        and current.devices == task.devices
                        and task.prev_devices is not None):
                    # vtpulint: ignore[VTPU002] decide lock held via the bounded acquire above (docstring)
                    self.pods.add_pod(
                        task.namespace, task.name, task.uid,
                        task.node_id, task.prev_devices,
                        host_mb=current.host_mb,
                        priority=current.priority, group=current.group,
                        migration_candidate=current.migration_candidate)
                return
            if (current is not None and current.node_id == task.node_id
                    and current.devices == task.devices):
                # vtpulint: ignore[VTPU002] decide lock held via the bounded acquire above (docstring); a lexical `with` would deadlock-prone the commit worker
                self.pods.del_pod(task.namespace, task.name, task.uid)
            if task.group:
                # vtpulint: ignore[VTPU002] decide lock held via the bounded acquire above (docstring)
                self.slices.release_pod((task.namespace, task.group),
                                        task.uid)
        finally:
            if locked:
                self._decide_lock.release()
        if (task.generation
                and task.generation
                != self._fence_generation(task.shard_group)):
            # fenced commit (docs/ha.md): the new owner of this TASK's
            # shard group holds the pod's durable state now — a deposed
            # owner must not write even the bind-phase=failed stamp (it
            # would clobber a valid in-progress placement); the
            # in-memory retraction above was all the cleanup this dead
            # decision gets
            return
        try:
            # only stamp the pod this decision was for — a recreated
            # pod under the same name must not inherit a failed phase
            fresh = self.client.get_pod(task.namespace, task.name)
            if (not task.uid
                    or fresh.get("metadata", {}).get("uid", "")
                    in ("", task.uid)):
                self.client.patch_pod_annotations(
                    task.namespace, task.name,
                    {types.BIND_PHASE_ANNO: types.BindPhase.FAILED.value})
        except NotFoundError:
            # the COMMON permanent-failure cause: the pod was deleted
            # while its commit was queued — nothing left to stamp
            log.debug("pod %s/%s gone; skipping bind-phase=failed stamp",
                      task.namespace, task.name)
        except Exception:
            # commit-loop failure path: keep it visible (VTPU004) — a pod
            # stuck without its bind-phase=failed stamp waits out the
            # kube-scheduler retry instead of re-filtering immediately
            log.warning("bind-phase=failed patch after failed commit also "
                        "failed for %s/%s", task.namespace, task.name,
                        exc_info=True)

    @staticmethod
    def _container_request(ctr: Dict) -> types.ContainerDeviceRequest:
        for dev in devmod.all_devices():
            req = dev.generate_resource_requests(ctr)
            if req.nums > 0:
                return req
        return types.ContainerDeviceRequest(nums=0)

    # ------------------------------------------------------------------
    # Bind (reference: scheduler.go:312-352)
    # ------------------------------------------------------------------

    def trace_id_for(self, namespace: str, name: str) -> str:
        """This pod's trace id without an apiserver round-trip: derive
        from the cached assignment's uid, else reuse the id the filter
        span indexed; a random id is the last resort (spans still group,
        they just can't stitch)."""
        info = self.pods.find(namespace, name)
        if info is not None and info.uid:
            return trace_id_for_uid(info.uid)
        return (_tracer.trace_id_for_key(f"{namespace}/{name}")
                or trace_id_for_uid(""))

    def _bind_fenced(self, generation: int, group: int = 0) -> bool:
        """Ownership of the bound node's shard group changed (or
        lapsed) since this bind began."""
        return (self.ha is not None
                and self._fence_generation(group) != generation)

    def bind(self, namespace: str, name: str, node: str) -> None:
        """Flush the pod's pending commit (the assignment annotation must
        be durable before kubelet's Allocate reads it), lock the node,
        flip bind-phase to allocating, bind via the apiserver; unwind on
        failure. A permanently-failed commit surfaces here as
        CommitFailed — its write-through was already retracted, so
        kube-scheduler simply re-filters.

        Fencing (docs/ha.md): every apiserver write here is gated on
        the generation of the NODE's shard group captured at entry —
        under multi-active that is the only lease whose loss makes
        this bind someone else's to finish. The flush barrier can
        block for longer than the lease window, and a bind failing
        BECAUSE of a partition is exactly when a peer has taken over —
        a deposed owner's unwind clearing the new owner's fresh
        assignment would be the clobber fencing exists to prevent."""
        key = f"{namespace}/{name}"
        group = self.shards.group_of(node)
        generation = self._fence_generation(group)
        if self.ha is not None and generation == 0:
            who = (f"shard group {group} lease not held"
                   if self.shards.n_groups > 1
                   else "not the validly-leased leader")
            raise committermod.FencedError(
                f"{who}; refusing to bind {key}")
        trace_id = self.trace_id_for(namespace, name)
        with _tracer.span(trace_id, "bind.flush", pod=key):
            self.committer.flush(namespace, name)
        if self._bind_fenced(generation, group):
            raise committermod.FencedError(
                f"leadership changed during bind flush of {key}")
        nodelock.lock_node(self.client, node)
        try:
            with _tracer.span(trace_id, "bind.api", pod=key, node=node):
                self.client.patch_pod_annotations(
                    namespace, name,
                    {
                        types.BIND_PHASE_ANNO:
                            types.BindPhase.ALLOCATING.value,
                        types.BIND_TIME_ANNO: str(time.time_ns()),
                    },
                )
                self.client.bind_pod(namespace, name, node)
        except Exception:
            log.exception("bind %s/%s -> %s failed; unwinding",
                          namespace, name, node)
            # retract the filter write-through: a pod that failed to
            # bind keeps no claim on the node's chips (without this the
            # ghost reservation survives until the next resync). Under
            # the decide lock (VTPU002) so the lookup+retraction is
            # atomic against a concurrent re-filter re-adding the pod.
            # (In-memory only — safe even when deposed.)
            with self._decide_lock:
                info = self.pods.find(namespace, name)
                if info is not None and info.node_id == node:
                    self.pods.del_pod(info.namespace, info.name, info.uid)
            if self._bind_fenced(generation, group):
                # deposed mid-bind (a partition failing the bind is the
                # textbook case): the new leader owns this pod's durable
                # state — write NOTHING, not even the unwind. The node
                # lock self-expires (nodelock.LOCK_EXPIRE_S) rather than
                # us racing its release against the new leader's binds.
                log.warning("bind %s/%s failed while deposed; leaving "
                            "durable state to the new leader", namespace,
                            name)
                raise
            try:
                self.client.patch_pod_annotations(
                    namespace, name,
                    {
                        types.BIND_PHASE_ANNO: types.BindPhase.FAILED.value,
                        # clear the assignment so the watch's MODIFIED
                        # event agrees with the retraction above instead
                        # of re-adding the ghost; the generation stamp
                        # goes with it — an UNASSIGNED pod must carry no
                        # stale fencing floor (a lease recreated after
                        # operator deletion would otherwise never be
                        # able to re-commit it)
                        types.ASSIGNED_NODE_ANNO: None,
                        types.TO_ALLOCATE_ANNO: None,
                        types.SCHED_GEN_ANNO: None,
                    },
                )
            except NotFoundError:
                pass
            except Exception:
                log.exception("bind-failure unwind patch for %s/%s failed",
                              namespace, name)
            nodelock.release_node(self.client, node)
            raise


def _handshake_time(value: str) -> Optional[float]:
    parts = value.split("_", 1)
    if len(parts) != 2:
        return None
    try:
        return float(parts[1])
    except ValueError:
        return None


def _parse_node_host_mem(node: str, anno: Optional[str]) -> int:
    """NODE_HOST_MEM_ANNO value (schedulable host-RAM MB) -> int;
    malformed values log and degrade to 0 = unreported/legacy-unlimited
    (the node still schedules; only the host axis goes unenforced)."""
    if not anno:
        return 0
    try:
        mb = int(anno)
        if mb < 0:
            raise ValueError(anno)
        return mb
    except ValueError:
        log.error("node %s: bad %s annotation %r", node,
                  types.NODE_HOST_MEM_ANNO, anno)
        return 0


def _parse_node_slice(node: str, anno: Optional[str]):
    """NODE_SLICE_ANNO value "<slice-name>;x-y-z" -> (name, MeshCoord);
    malformed values log and degrade to no-slice (the node still
    schedules for single-host pods)."""
    if not anno:
        return "", None
    try:
        name, coord = anno.split(";", 1)
        mc = types.MeshCoord.decode(coord)
        if not name or mc is None:
            raise ValueError(anno)
        return name, mc
    except ValueError:
        log.error("node %s: bad %s annotation %r", node,
                  types.NODE_SLICE_ANNO, anno)
        return "", None
