"""Cluster-view Prometheus metrics.

The port's copy of vtpu/scheduler/metrics.py, every family renamed
``vTPU...`` -> ``vGPU...`` as the port's monitor does: a process that
imports both packages registers both sets in one Prometheus registry.

Reference: cmd/scheduler/metrics.go:65-207 — gauges over the scheduler's
live inventory+usage view (fed from InspectAllNodesUsage,
scheduler.go:232-234), exposed on the scheduler's HTTP port. Metric families
keep the reference's shape with TPU names:

  vGPUDeviceMemoryLimit / vGPUDeviceMemoryAllocated (bytes, per chip)
  vGPUDeviceCoreLimit / vGPUDeviceCoreAllocated (percent, per chip)
  vGPUDeviceSharedNum (tasks per chip)
  nodeTPUOverview (per chip: mem/core/shared summary)
  vGPUPodsDeviceAllocated (per pod x chip)

plus the extender hot-path histogram:

  vGPUFilterLatency (seconds per Filter verb, success or failure)

and the decision/commit-split pipeline (vtpu/scheduler/committer.py):

  vGPUCommitQueueDepth (assignment patches queued or in flight)
  vGPUCommitLatency (seconds from decision to durable apiserver write)
  vGPUCommitRetries / vGPUCommitFailures (transient retries; permanent
  drops, each of which retracted a cached assignment)
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Iterable

from prometheus_client import Counter, Gauge, Histogram
from prometheus_client.core import CounterMetricFamily, GaugeMetricFamily
from prometheus_client.registry import Collector

if TYPE_CHECKING:  # import-cycle guard: core times filter() against
    from .core import Scheduler  # FILTER_LATENCY defined below

MB = 1024 * 1024

#: every metric family the JAX scheduler's process exports (its module's
#: and SchedulerCollector's) -> the port's family: ``vTPU`` -> ``vGPU``;
#: ``nodeTPUMemoryPercentage`` keeps the reference's name (below)
METRIC_NAMES = {
    "vTPUFilterLatency": "vGPUFilterLatency",
    "vTPUCommitQueueDepth": "vGPUCommitQueueDepth",
    "vTPUCommitLatency": "vGPUCommitLatency",
    "vTPUCommitRetries": "vGPUCommitRetries",
    "vTPUCommitFailures": "vGPUCommitFailures",
    "vTPUDecideShards": "vGPUDecideShards",
    "vTPUDecideShardFilters": "vGPUDecideShardFilters",
    "vTPUDecideMultiShardFilters": "vGPUDecideMultiShardFilters",
    "vTPUDecideLockTimeouts": "vGPUDecideLockTimeouts",
    "vTPUAdmissionBatchSize": "vGPUAdmissionBatchSize",
    "vTPUAdmissionShed": "vGPUAdmissionShed",
    "vTPUCommitCoalesced": "vGPUCommitCoalesced",
    "vTPUCommitBulkWrites": "vGPUCommitBulkWrites",
    "vTPURebalanceGrows": "vGPURebalanceGrows",
    "vTPURebalanceShrinks": "vGPURebalanceShrinks",
    "vTPURebalanceSkippedHeadroom": "vGPURebalanceSkippedHeadroom",
    "vTPUMigrationCandidates": "vGPUMigrationCandidates",
    "vTPUPreemptions": "vGPUPreemptions",
    "vTPUPreemptionVictims": "vGPUPreemptionVictims",
    "vTPUPreemptionFailed": "vGPUPreemptionFailed",
    "vTPUMigrations": "vGPUMigrations",
    "vTPUMigrateBlackoutSeconds": "vGPUMigrateBlackoutSeconds",
    "vTPUGangGroupTakeovers": "vGPUGangGroupTakeovers",
    "vTPUDeviceMemoryLimit": "vGPUDeviceMemoryLimit",
    "vTPUDeviceMemoryAllocated": "vGPUDeviceMemoryAllocated",
    "vTPUDeviceCoreLimit": "vGPUDeviceCoreLimit",
    "vTPUDeviceCoreAllocated": "vGPUDeviceCoreAllocated",
    "vTPUDeviceSharedNum": "vGPUDeviceSharedNum",
    "nodeTPUMemoryPercentage": "nodeTPUMemoryPercentage",
    "vTPUPodsDeviceAllocated": "vGPUPodsDeviceAllocated",
    "vTPUPodWatchHealthy": "vGPUPodWatchHealthy",
    "vTPUShardGroupOwner": "vGPUShardGroupOwner",
    "vTPUShardGroupTransitions": "vGPUShardGroupTransitions",
    "vTPUShardGroupOrdinalCollisions": "vGPUShardGroupOrdinalCollisions",
}


# Filter is on every pod's critical scheduling path; the buckets span
# "overlay snapshot of a few candidates" (~100us) to "something is
# O(cluster) again" (seconds) so a regression moves mass visibly.
FILTER_LATENCY = Histogram(
    "vGPUFilterLatency",
    "scheduler extender Filter latency in seconds",
    buckets=(0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
             0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0),
)

# Commit-pipeline health: depth trending up means the apiserver can't
# keep pace with decisions; latency is decision->durable (what the
# bind-time flush barrier may wait on); failures each retracted one
# cached assignment (vtpu/scheduler/committer.py).
COMMIT_QUEUE_DEPTH = Gauge(
    "vGPUCommitQueueDepth",
    "assignment patches queued or in flight in the commit pipeline",
)
COMMIT_LATENCY = Histogram(
    "vGPUCommitLatency",
    "seconds from scheduling decision to durable apiserver write",
    buckets=(0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
             0.5, 1.0, 2.5, 5.0, 10.0),
)
COMMIT_RETRIES = Counter(
    "vGPUCommitRetries",
    "transient assignment-patch failures that were retried",
)
COMMIT_FAILURES = Counter(
    "vGPUCommitFailures",
    "assignment patches dropped after exhausting retries "
    "(cached assignment retracted)",
)

# Sharded decide plane (vtpu/scheduler/shard.py): disjoint-pool
# admissions decide concurrently under per-shard locks; requests whose
# candidate set spans shards take the ordered multi-shard path. A
# multi-shard ratio trending toward 1 means the shard key (node pool
# label / slice) does not match how pods actually constrain candidates.
DECIDE_SHARDS = Gauge(
    "vGPUDecideShards",
    "configured decide-plane shards (VTPU_DECIDE_SHARDS)",
)
DECIDE_SHARD_FILTERS = Counter(
    "vGPUDecideShardFilters",
    "filters decided wholly inside one shard",
    ["shard"],
)
DECIDE_MULTI_SHARD_FILTERS = Counter(
    "vGPUDecideMultiShardFilters",
    "filters that took the ordered multi-shard lock path",
)
DECIDE_LOCK_TIMEOUTS = Counter(
    "vGPUDecideLockTimeouts",
    "bounded decide-lock acquires that gave up after "
    "VTPU_DECIDE_LOCK_TIMEOUT_S (handler degraded to its lock-free "
    "guard instead of stalling a commit worker)",
)

# Batched admission front door: the webhook/extender intake
# feeds a batch decider that admits K same-shaped pods per shard-lock
# acquisition, and the committer merges same-node patches into bulk
# writes. Shed counts are the front door refusing RETRYABLY (429-style)
# instead of timing out opaquely when a queue saturates.
ADMISSION_BATCH_SIZE = Histogram(
    "vGPUAdmissionBatchSize",
    "pods decided per shard-lock acquisition by the batch decider",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256),
)
ADMISSION_SHED = Counter(
    "vGPUAdmissionShed",
    "admission requests shed with a retryable refusal instead of an "
    "opaque timeout (reason: intake_full / commit_backpressure / "
    "decide_lock_timeout)",
    ["reason"],
)
COMMIT_COALESCED = Counter(
    "vGPUCommitCoalesced",
    "assignment patches that rode a same-node bulk write instead of "
    "their own RPC (each bulk write of K patches counts K-1)",
)
COMMIT_BULK_WRITES = Counter(
    "vGPUCommitBulkWrites",
    "coalesced per-node bulk patch RPCs issued by the commit pipeline",
)

# Elastic quotas (vtpu/scheduler/rebalancer.py, docs/elastic-quotas.md):
# the leader-gated vertical right-sizer. Grows/shrinks are DECISIONS
# submitted to the fenced commit pipeline — the node monitor's
# vGPUResize{Applied,Refused,Clamped,Blocked} count what actually
# reached each region.
REBALANCE_GROWS = Counter(
    "vGPURebalanceGrows",
    "pod quota grow decisions submitted by the rebalancer",
)
REBALANCE_SHRINKS = Counter(
    "vGPURebalanceShrinks",
    "pod quota shrink decisions submitted by the rebalancer",
)
REBALANCE_SKIPPED_HEADROOM = Counter(
    "vGPURebalanceSkippedHeadroom",
    "grow decisions dropped because the chip had no free headroom "
    "(the pressure signal persists; defragmentation proposals are the "
    "longer-term relief valve)",
)
MIGRATION_CANDIDATES = Gauge(
    "vGPUMigrationCandidates",
    "pods currently annotated vtpu.io/migration-candidate: "
    "defragmentation proposals the preemption engine consumes as a "
    "preferred victim source (vtpu/scheduler/preempt.py)",
)

# Priority preemption (vtpu/scheduler/preempt.py, docs/multihost.md
# ADR): decisions where a higher-priority arrival evicted lower-
# priority tenants. reason: "capacity" (ordinary make-room) or
# "defrag" (every victim was a migration candidate — the
# eviction doubled as the proposed defragmentation). Victims count
# individual evicted pods; failures count higher-priority arrivals
# that stayed unschedulable because no victim set could make them fit.
PREEMPTIONS = Counter(
    "vGPUPreemptions",
    "successful preemption decisions by the priority-aware engine",
    ["reason"],
)
PREEMPTION_VICTIMS = Counter(
    "vGPUPreemptionVictims",
    "pods evicted by the preemption engine (two-phase fenced protocol)",
)
PREEMPTION_FAILED = Counter(
    "vGPUPreemptionFailed",
    "preemption attempts that found no feasible victim set "
    "(reason: no_victims / group_not_owned)",
    ["reason"],
)

# Multi-active control plane (vtpu/ha/groups.py, docs/ha.md): N
# schedulers each own disjoint SHARD GROUPS via per-group leases.
# vGPUShardGroupOwner / vGPUShardGroupTransitions are emitted by
# SchedulerCollector below (they read the coordinator's lease state).
# Gang takeovers count forced group consolidations a slice gang's
# pre-lock performed (core._ensure_gang_groups).
# Live migration (vtpu/scheduler/migrate.py, docs/migration.md): the
# defrag loop that MOVES marked pods instead of killing them. Events:
# planned (stamp committed), cutover (assignment moved), completed
# (destination attach observed, migrated-from cleared), aborted
# (workload refused the drain), expired (deadline passed), rescue
# (preemption victim granted migrate-instead-of-delete),
# fallback_delete (a rescue that refused/expired and took the classic
# delete), no_destination (a planned move with nowhere to go).
MIGRATIONS = Counter(
    "vGPUMigrations",
    "live-migration protocol events by the leader-gated planner",
    ["event"],
)
# Blackout = first all-regions-snapshotted observation to the cutover
# commit, as seen by the planner's poll clock. The soak gates its p99
# against VTPU_MIGRATE_BLACKOUT_P99_MS (benchmarks/soak.py --migrate).
MIGRATE_BLACKOUT = Histogram(
    "vGPUMigrateBlackoutSeconds",
    "seconds between a move's source quiesce (all regions snapshotted) "
    "and its cutover commit",
    buckets=(0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
             30.0, 60.0),
)

GANG_GROUP_TAKEOVERS = Counter(
    "vGPUGangGroupTakeovers",
    "shard groups force-acquired by a slice gang's pre-lock "
    "consolidation (majority owner absorbing the minority)",
)


class SchedulerCollector(Collector):
    def __init__(self, scheduler: Scheduler) -> None:
        self.scheduler = scheduler

    def collect(self) -> Iterable[GaugeMetricFamily]:
        mem_limit = GaugeMetricFamily(
            "vGPUDeviceMemoryLimit", "device HBM limit in bytes",
            labels=["nodeid", "deviceuuid", "deviceidx"],
        )
        mem_alloc = GaugeMetricFamily(
            "vGPUDeviceMemoryAllocated", "device HBM allocated in bytes",
            labels=["nodeid", "deviceuuid", "deviceidx"],
        )
        core_limit = GaugeMetricFamily(
            "vGPUDeviceCoreLimit", "device tensorcore capacity (percent)",
            labels=["nodeid", "deviceuuid", "deviceidx"],
        )
        core_alloc = GaugeMetricFamily(
            "vGPUDeviceCoreAllocated", "device tensorcore allocated (percent)",
            labels=["nodeid", "deviceuuid", "deviceidx"],
        )
        shared_num = GaugeMetricFamily(
            "vGPUDeviceSharedNum", "tasks sharing the device",
            labels=["nodeid", "deviceuuid", "deviceidx"],
        )
        # vtpulint: ignore[VTPU005] reference-inherited family name; renaming breaks existing dashboards (docs/gpu/static-analysis.md)
        node_mem_pct = GaugeMetricFamily(
            "nodeTPUMemoryPercentage", "node HBM allocation ratio",
            labels=["nodeid"],
        )
        for node_id, usages in self.scheduler.inspect_all_nodes_usage().items():
            total = used = 0
            for u in usages:
                labels = [node_id, u.id, str(u.index)]
                mem_limit.add_metric(labels, float(u.totalmem) * MB)
                mem_alloc.add_metric(labels, float(u.usedmem) * MB)
                core_limit.add_metric(labels, float(u.totalcores))
                core_alloc.add_metric(labels, float(u.usedcores))
                shared_num.add_metric(labels, float(u.used))
                total += u.totalmem
                used += u.usedmem
            node_mem_pct.add_metric([node_id], used / total if total else 0.0)

        pod_alloc = GaugeMetricFamily(
            "vGPUPodsDeviceAllocated", "per-pod HBM allocated in bytes",
            labels=["podnamespace", "podname", "nodename", "deviceuuid",
                    "containeridx"],
        )
        for pod in self.scheduler.pods.list_pods():
            for ci, ctr in enumerate(pod.devices):
                for cd in ctr:
                    pod_alloc.add_metric(
                        [pod.namespace, pod.name, pod.node_id, cd.uuid,
                         str(ci)],
                        float(cd.usedmem) * MB,
                    )
        watch_healthy = GaugeMetricFamily(
            "vGPUPodWatchHealthy",
            "1 while the event-driven pod watch stream is live (0 = the "
            "cache is falling back to the 15s relist poll)",
        )
        watch_healthy.add_metric(
            [], 1.0 if self.scheduler._watch_healthy.is_set() else 0.0)
        yield from (mem_limit, mem_alloc, core_limit, core_alloc,
                    shared_num, node_mem_pct, pod_alloc, watch_healthy)
        yield from self._group_families()

    def _group_families(self) -> Iterable[GaugeMetricFamily]:
        """Multi-active ownership map (docs/ha.md): one info sample per
        shard group THIS instance validly owns (labels carry the holder
        identity and the group's fencing generation), plus this
        instance's per-group handoff count (acquires and losses it
        participated in — sum across the fleet for the global churn
        rate). Binary pairs report group 0; HA-less schedulers report
        nothing."""
        ha = getattr(self.scheduler, "ha", None)
        if ha is None:
            return
        owner = GaugeMetricFamily(
            "vGPUShardGroupOwner",
            "1 for each shard group this scheduler instance validly "
            "owns (info gauge: labels carry holder identity and the "
            "group's fencing generation)",
            labels=["group", "owner", "generation"],
        )
        transitions = CounterMetricFamily(
            "vGPUShardGroupTransitions",
            "lease handoffs observed by this instance per shard group "
            "(acquires and losses; each corresponds to a bump of the "
            "group's durable leaseTransitions fencing counter)",
            labels=["group"],
        )
        identity = str(getattr(ha, "identity", "") or "")
        owned = self.scheduler._owned_groups() or frozenset()
        for g in sorted(owned):
            gen = self.scheduler._fence_generation(g)
            owner.add_metric([str(g), identity, str(gen)], 1.0)
        trans = getattr(ha, "transitions", None)
        if isinstance(trans, dict):
            for g, n in sorted(trans.items()):
                transitions.add_metric([str(g)], float(n))
        else:
            gen = getattr(ha, "generation", 0) or 0
            transitions.add_metric(["0"], float(gen))
        yield owner
        yield transitions
        coll = getattr(ha, "collisions", None)
        if isinstance(coll, dict):
            # non-zero means two replicas contend for the same
            # preferred slot (duplicate ordinal) or this instance
            # paused past its lease window; forced reclaim is backed
            # off while it grows (groups.py _suspect_collision) —
            # alert on any sustained increase
            collide = CounterMetricFamily(
                "vGPUShardGroupOrdinalCollisions",
                "times this instance was force-deposed from a "
                "PREFERRED shard group by a live peer (suspected "
                "ordinal collision or pause past the lease window); "
                "its forced reclaim backs off exponentially while "
                "this counts up",
                labels=["group"],
            )
            for g, n in sorted(coll.items()):
                collide.add_metric([str(g)], float(n))
            yield collide
