"""Per-node device bin-packing and scoring.

The port's copy of vtpu/scheduler/score.py, with one difference: a
multi-card request that asserts ``nvidia.com/numa-bind`` on cards that
carry no mesh coordinate (all NVML reports) is placed inside one NUMA
node, as the reference's NUMA-restart walk does (score.go:99-104), where
the TPU rule would demand a contiguous ICI box and refuse it.

Reference: pkg/scheduler/score.go — `fitInCertainDevice` (86-152) walks the
node's devices accumulating a container's request, `fitInDevices` (154-181)
runs every container, `calcScore` (183-214) ranks nodes. The reference's
NUMA-restart semantics (99-104) become ICI semantics here: when the pod
asserts `tpu.google.com/ici-bind`, a multi-chip request must land on a
contiguous ICI sub-mesh, chosen by the vtpu.parallel.mesh solver; without
the assertion the solver still contributes a locality bonus so equally
packed nodes tie-break toward better topology.
"""

from __future__ import annotations

import logging
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, Hashable, List, Optional, Tuple

from .. import device as devmod
from ..parallel import mesh
from ..trace import decision as decisionmod
from ..trace.decision import ChipReject, Rejection
from ..util import lockdebug, podutil, types
from ..util.types import (
    ContainerDevice,
    ContainerDeviceRequest,
    DeviceUsage,
    PodDevices,
)

log = logging.getLogger(__name__)


@dataclass
class NodeScore:
    node_id: str
    devices: PodDevices = field(default_factory=list)  # per container
    score: float = 0.0
    # component decomposition of `score` (score_node), recorded into the
    # winner's DecisionTrace so "why THIS node" is answerable from /trace
    breakdown: Dict[str, float] = field(default_factory=dict)


def host_mem_request_mb(annos: Dict[str, str]) -> int:
    """The pod's host-memory reservation in MB (vtpu.io/host-memory), a
    NODE-level scheduling axis — the shared parser in
    :func:`vtpu.util.podutil.host_mem_mb_of` (Allocate's env injection
    reads the SAME one, so fit and enforcement can't drift)."""
    return podutil.host_mem_mb_of(annos)


def host_fit_rejection(
    host_demand_mb: int, cap_mb: int, used_mb: int,
) -> Optional[Rejection]:
    """The node-level host-RAM fit: None when `host_demand_mb` fits the
    node's (capacity - committed) host memory. Capacity 0 = the node
    reported no host-memory axis — legacy-unlimited (documented
    migration default)."""
    if host_demand_mb <= 0 or cap_mb <= 0:
        return None
    free = cap_mb - used_mb
    if host_demand_mb <= free:
        return None
    return Rejection(decisionmod.NODE_HOST_MEM_SHORT,
                     {"need_mb": host_demand_mb,
                      "free_mb": max(0, free),
                      "short_mb": host_demand_mb - max(0, free),
                      "capacity_mb": cap_mb,
                      "committed_mb": used_mb})


def request_mem_mb(req: ContainerDeviceRequest, dev: DeviceUsage) -> int:
    """Resolve a request's HBM demand against a concrete chip
    (reference: score.go:106-112 percentage branch)."""
    if req.memreq > 0:
        return req.memreq
    if req.mem_percentage > 0:
        return dev.totalmem * req.mem_percentage // 100
    return 0


def _fits_quota(dev: DeviceUsage, req: ContainerDeviceRequest) -> bool:
    """The non-type half of device_fits: task count, memory, cores."""
    if dev.used >= dev.count:
        return False
    mem = request_mem_mb(req, dev)
    if dev.usedmem + mem > dev.totalmem:
        return False
    if req.coresreq > 0 and dev.usedcores + req.coresreq > dev.totalcores:
        return False
    # a 100%-core request wants the chip exclusively, and a chip whose
    # cores are fully claimed admits no one — not even 0-core requests
    # (reference: score.go:133-139)
    if req.coresreq == 100 and dev.used > 0:
        return False
    if dev.used > 0 and dev.usedcores >= dev.totalcores:
        return False
    return True


def device_fits(
    annos: Dict[str, str],
    dev: DeviceUsage,
    req: ContainerDeviceRequest,
) -> bool:
    """One chip's eligibility for one request (reference: score.go:113-139
    checks: health, type, task-count, memory, cores)."""
    if not dev.health:
        return False
    vendor = devmod.get(req.type)
    if vendor is None:
        return False
    ok, _ = vendor.check_type(annos, dev, req)
    if not ok:
        return False
    return _fits_quota(dev, req)


def _choose_numa_first(
    fitting: List[DeviceUsage], n: int, policy: "mesh.Policy"
) -> Optional["mesh.Candidate"]:
    """Multi-chip selection with a NUMA tie-break (reference sorts
    devices NUMA-first, score.go:45-50; here NUMA ranks BELOW ICI
    contiguity — vGPU chips cooperate over ICI, NUMA only shapes host
    DMA paths, so a contiguous cross-NUMA sub-mesh still beats a
    fragmented same-NUMA set). Preference order:

      1. contiguous sub-mesh within one NUMA node (best score wins)
      2. contiguous sub-mesh anywhere
      3. (non-guaranteed) policy fallbacks within one NUMA node
      4. (non-guaranteed) policy fallbacks anywhere
    """
    groups: Dict[int, List[DeviceUsage]] = {}
    for d in fitting:
        groups.setdefault(d.numa, []).append(d)
    multi_numa = len(groups) > 1
    if multi_numa:
        best: Optional[mesh.Candidate] = None
        for numa in sorted(groups):
            g = {d.id: d.mesh for d in groups[numa]}
            if len(g) < n:
                continue
            cand = mesh.choose_chips(g, n, mesh.Policy.GUARANTEED)
            if cand is not None and (best is None
                                     or cand.score > best.score):
                best = cand
        if best is not None:
            return best
    all_chips = {d.id: d.mesh for d in fitting}
    cand = mesh.choose_chips(all_chips, n, mesh.Policy.GUARANTEED)
    if cand is not None:
        return cand
    if policy == mesh.Policy.GUARANTEED:
        return None
    if multi_numa:
        for numa in sorted(groups):
            g = {d.id: d.mesh for d in groups[numa]}
            if len(g) < n:
                continue
            cand = mesh.choose_chips(g, n, policy)
            if cand is not None:
                return cand
    return mesh.choose_chips(all_chips, n, policy)


def _numa_bind_applies(fitting: List[DeviceUsage]) -> bool:
    """The asserted locality means one NUMA node, not an ICI box, when no
    fitting card carries a mesh coordinate: NVML reports none, so a GPU
    node's cards never could form the box the TPU rule demands."""
    return all(d.mesh is None for d in fitting)


def _choose_numa_bound(
    fitting: List[DeviceUsage], n: int
) -> Optional["mesh.Candidate"]:
    """A numa-bind request's cards (reference: the NUMA-restart walk,
    score.go:99-104): exactly the set the same request without the
    assertion gets, when that set lies in one NUMA node; None otherwise.
    That set is the first NUMA node, in id order, with n fitting cards
    (_choose_numa_first tries each node before it crosses them)."""
    cand = _choose_numa_first(fitting, n, mesh.Policy.BEST_EFFORT)
    if cand is None:
        return None
    numa_of = {d.id: d.numa for d in fitting}
    if len({numa_of[c] for c in cand.chips}) != 1:
        return None
    return cand


def fit_in_certain_device(
    node_devices: List[DeviceUsage],
    req: ContainerDeviceRequest,
    annos: Dict[str, str],
) -> Optional[List[ContainerDevice]]:
    """Place one container request on one node, mutating usage on success
    (reference: score.go:86-152)."""
    if req.nums <= 0:
        return []
    vendor = devmod.get(req.type)
    if vendor is None:
        return None
    # check_type depends only on (annos, dev.type, req), so memoize per
    # chip type: one vendor call per distinct generation on the node,
    # not one per chip (the filter hot path visits every candidate chip)
    type_ok: Dict[str, Tuple[bool, bool]] = {}
    fitting = []
    for d in node_devices:
        tc = type_ok.get(d.type)
        if tc is None:
            tc = type_ok[d.type] = vendor.check_type(annos, d, req)
        if tc[0] and d.health and _fits_quota(d, req):
            fitting.append(d)
    if len(fitting) < req.nums:
        return None
    # the ICI-bind assertion belongs to the request (its vendor reads it
    # from the pod annotations), so derive it from a chip type the
    # request actually MATCHED — on a mixed-generation node the first
    # chip's type can be one the request rejected, whose check_type
    # verdict never saw the assertion
    ici_assert = any(type_ok[d.type][1] for d in fitting)

    if req.nums > 1:
        if ici_assert and _numa_bind_applies(fitting):
            cand = _choose_numa_bound(fitting, req.nums)
        else:
            policy = (mesh.Policy.GUARANTEED if ici_assert
                      else mesh.Policy.BEST_EFFORT)
            cand = _choose_numa_first(fitting, req.nums, policy)
        if cand is None:
            return None
        chosen = [d for d in fitting if d.id in set(cand.chips)]
    else:
        # pack tight: NUMA-first, then most-loaded eligible chip
        # (reference sort order, score.go:45-50 — filling low NUMA ids
        # first also keeps whole NUMA nodes free for multi-chip pods)
        fitting.sort(key=lambda d: (d.numa, d.totalmem - d.usedmem, d.id))
        chosen = fitting[: req.nums]

    out: List[ContainerDevice] = []
    for d in chosen:
        mem = request_mem_mb(req, d)
        d.used += 1
        d.usedmem += mem
        d.usedcores += req.coresreq
        out.append(
            ContainerDevice(
                uuid=d.id, type=req.type, usedmem=mem,
                usedcores=req.coresreq,
            )
        )
    return out


def fit_pod(
    node_devices: List[DeviceUsage],
    ctr_requests: List[ContainerDeviceRequest],
    annos: Dict[str, str],
) -> Tuple[Optional[PodDevices], Optional[int]]:
    """All containers of a pod on one node (reference: fitInDevices,
    score.go:154-181); on failure also names the container index that
    failed, against the already-mutated trial state — what the
    structured rejection explains."""
    pod_devices: PodDevices = []
    for ci, req in enumerate(ctr_requests):
        placed = fit_in_certain_device(node_devices, req, annos)
        if placed is None:
            return None, ci
        pod_devices.append(placed)
    return pod_devices, None


def score_node(
    devices_after: List[DeviceUsage], assigned: PodDevices,
    breakdown: Optional[Dict[str, float]] = None,
) -> float:
    """Bin-packing score, higher = better (reference formula at
    score.go:180: packed usage ratio + count of untouched devices, i.e.
    consolidate onto busy chips and keep whole chips free). An ICI locality
    bonus is added for multi-chip containers. Pass a dict as `breakdown`
    to receive the per-component decomposition (DecisionTrace)."""
    packed = free = locality = 0.0
    for d in devices_after:
        if d.totalmem and d.used:
            packed += 10.0 * d.usedmem / d.totalmem
        if d.used == 0:
            free += 1.0  # reward keeping chips completely free
    if any(len(ctr) > 1 for ctr in assigned):
        chips = {d.id: d.mesh for d in devices_after}
        for ctr in assigned:
            if len(ctr) > 1:
                locality += 2.0 * mesh.locality_bonus(
                    chips, [c.uuid for c in ctr])
    score = packed + free + locality
    if breakdown is not None:
        breakdown["packed_hbm"] = round(packed, 4)
        breakdown["free_chips"] = free
        breakdown["ici_locality"] = round(locality, 4)
        breakdown["total"] = round(score, 4)
    return score


def clone_usage(u: DeviceUsage) -> DeviceUsage:
    """Hand-rolled shallow clone for scoring trials — ~20x cheaper than
    copy.deepcopy on the filter hot path. Scalars are copied; `mesh` is
    a frozen dataclass and is shared safely."""
    return DeviceUsage(
        id=u.id, index=u.index, used=u.used, count=u.count,
        usedmem=u.usedmem, totalmem=u.totalmem, usedcores=u.usedcores,
        totalcores=u.totalcores, numa=u.numa, mesh=u.mesh,
        type=u.type, health=u.health,
    )


def aggregate_demand(
    ctr_requests: List[ContainerDeviceRequest],
) -> Tuple[int, int, int]:
    """Conservative whole-pod demand: (chip slots, HBM MB, core %).
    Percentage HBM requests resolve per-chip, so they contribute 0 here
    — a lower bound that never rules out a feasible node."""
    slots = mem = cores = 0
    for r in ctr_requests:
        if r.nums <= 0:
            continue
        slots += r.nums
        mem += r.nums * r.memreq
        cores += r.nums * r.coresreq
    return slots, mem, cores


def node_prefits(
    usages: List[DeviceUsage], slots: int, mem: int, cores: int
) -> bool:
    """Aggregate capacity gate: can the node's healthy free slot/HBM/core
    totals possibly satisfy the pod? A False verdict is definitive; a
    True verdict still needs per-chip fitting. Lets calc_score skip the
    clone + mesh-solver work on nodes that plainly cannot fit."""
    free_slots = free_mem = free_cores = 0
    for d in usages:
        if not d.health:
            continue
        if d.used < d.count:
            free_slots += d.count - d.used
        if d.usedmem < d.totalmem:
            free_mem += d.totalmem - d.usedmem
        if d.usedcores < d.totalcores:
            free_cores += d.totalcores - d.usedcores
        if free_slots >= slots and free_mem >= mem and free_cores >= cores:
            return True
    return free_slots >= slots and free_mem >= mem and free_cores >= cores


# --------------------------------------------------------------------------
# Generation-stamped verdict memo (decision/commit split)
# --------------------------------------------------------------------------

def request_signature(
    ctr_requests: List[ContainerDeviceRequest],
    annos: Dict[str, str],
) -> Hashable:
    """Hashable identity of everything per-node fitting consults besides
    the node's own usage: the synthesized container requests plus the
    scheduling annotations vendors read in check_type. Keys the
    VerdictCache together with the overlay's per-node usage generation.

    CONTRACT: any annotation a vendor's check_type starts reading must
    appear in that vendor's `scheduling_annos` tuple, or stale verdicts
    would be served for pods differing only in that annotation."""
    anno_keys = set()
    for dev in devmod.all_devices():
        anno_keys.update(getattr(dev, "scheduling_annos", ()))
    return (
        tuple((r.nums, r.type, r.memreq, r.mem_percentage, r.coresreq)
              for r in ctr_requests),
        tuple((k, annos.get(k, "")) for k in sorted(anno_keys)),
        # node-level host-memory demand: two pods differing only in
        # their vtpu.io/host-memory reservation must never share a
        # cached verdict (host usage mutations bump the node generation
        # through the same _apply path as the chip aggregates)
        host_mem_request_mb(annos),
    )


# verdict payloads: a NodeScore for a fit, a Rejection for a miss
Verdict = object


class VerdictCache:
    """LRU of (node, request-signature) -> generation-stamped scoring
    verdict (a NodeScore on fit, a structured Rejection on miss).
    Within a filter burst of same-shaped pods on a mostly-idle
    fleet, only the nodes actually mutated since their last verdict
    (the previous winners) re-run per-chip fitting — the other
    candidates cost one dict lookup each and skip the overlay snapshot
    entirely. Sound because fit_pod is deterministic in (node
    usage, request, annos): an unchanged generation replays the exact
    same placement; the devices list is safe to share because assigned
    ContainerDevice records are never mutated, and at most one pod ever
    lands per (node, generation) — landing bumps the generation.
    Rejections memoize their rendering, so FailedNodes strings also
    cost one build per (generation, signature), not one per filter."""

    def __init__(self, maxsize: int = 65536) -> None:
        self.maxsize = maxsize
        self._lock = lockdebug.lock("scheduler.verdicts")
        self._data: "OrderedDict[Tuple[str, Hashable], Tuple[int, Verdict]]" \
            = OrderedDict()
        self.hits = 0
        self.misses = 0

    def get(self, node_id: str, sig: Hashable,
            gen: int) -> Optional[Verdict]:
        key = (node_id, sig)
        with self._lock:
            entry = self._data.get(key)
            if entry is None or entry[0] != gen:
                self.misses += 1
                return None
            self._data.move_to_end(key)
            self.hits += 1
            return entry[1]

    def put(self, node_id: str, sig: Hashable, gen: int,
            verdict: Verdict) -> None:
        key = (node_id, sig)
        with self._lock:
            self._data[key] = (gen, verdict)
            self._data.move_to_end(key)
            while len(self._data) > self.maxsize:
                self._data.popitem(last=False)

    def clear(self) -> None:
        with self._lock:
            self._data.clear()


def _explain_chip(
    dev: DeviceUsage, req: ContainerDeviceRequest,
    type_verdict: bool,
) -> Optional[ChipReject]:
    """Why this chip refuses this request (None = it fits) — the same
    predicate chain as device_fits/_fits_quota, but reporting the first
    failing check with the actual numbers instead of a bool."""
    if not dev.health:
        return ChipReject(dev.id, decisionmod.CHIP_UNHEALTHY)
    if not type_verdict:
        return ChipReject(dev.id, decisionmod.CHIP_TYPE_MISMATCH,
                          {"chip_type": dev.type, "want_type": req.type})
    if dev.used >= dev.count:
        return ChipReject(dev.id, decisionmod.CHIP_TASKS_FULL,
                          {"used": dev.used, "count": dev.count})
    mem = request_mem_mb(req, dev)
    if dev.usedmem + mem > dev.totalmem:
        free = dev.totalmem - dev.usedmem
        return ChipReject(dev.id, decisionmod.CHIP_HBM_SHORT,
                          {"need_mb": mem, "free_mb": free,
                           "short_mb": mem - free})
    if req.coresreq > 0 and dev.usedcores + req.coresreq > dev.totalcores:
        free = dev.totalcores - dev.usedcores
        return ChipReject(dev.id, decisionmod.CHIP_CORES_SHORT,
                          {"need_pct": req.coresreq, "free_pct": free,
                           "short_pct": req.coresreq - free})
    if req.coresreq == 100 and dev.used > 0:
        return ChipReject(dev.id, decisionmod.CHIP_EXCLUSIVE_BUSY,
                          {"sharing": dev.used})
    if dev.used > 0 and dev.usedcores >= dev.totalcores:
        return ChipReject(dev.id, decisionmod.CHIP_CORES_EXHAUSTED,
                          {"used_pct": dev.usedcores,
                           "total_pct": dev.totalcores})
    return None


def explain_request_failure(
    devices_state: List[DeviceUsage],
    req: ContainerDeviceRequest,
    annos: Dict[str, str],
    container_idx: int,
) -> Rejection:
    """Structured rejection for ONE container request against the exact
    device state it failed in (earlier containers' trial placements
    included): every chip's machine-readable cause, plus the node-level
    code — `mesh` when enough chips fit individually but no contiguous
    ICI sub-mesh exists, `numa` when they fit but a numa-bind request
    finds no NUMA node that holds it, `capacity` otherwise. Only runs
    on the failure path (winners never pay it) and is memoized through
    the verdict cache, so cost is one pass per (node generation,
    signature)."""
    vendor = devmod.get(req.type)
    if vendor is None:
        return Rejection(decisionmod.NODE_NO_VENDOR, {"type": req.type})
    chips: List[ChipReject] = []
    fitting = 0
    fit_cards: List[DeviceUsage] = []
    type_ok: Dict[str, Tuple[bool, bool]] = {}
    for d in devices_state:
        tc = type_ok.get(d.type)
        if tc is None:
            tc = type_ok[d.type] = vendor.check_type(annos, d, req)
        cr = _explain_chip(d, req, tc[0])
        if cr is None:
            fitting += 1
            fit_cards.append(d)
        else:
            chips.append(cr)
    detail = {"container": container_idx, "need": req.nums,
              "fitting": fitting}
    if fitting < req.nums:
        code = decisionmod.NODE_CAPACITY
    elif any(type_ok[d.type][1] for d in fit_cards) \
            and _numa_bind_applies(fit_cards):
        # numa-bind on cards with no mesh coordinate: enough cards fit,
        # but no NUMA node holds the request alone
        code = decisionmod.NODE_NUMA
        per_numa: Dict[int, int] = {}
        for d in fit_cards:
            per_numa[d.numa] = per_numa.get(d.numa, 0) + 1
        detail["numa_most"] = max(per_numa.values())
    else:
        code = decisionmod.NODE_MESH
    return Rejection(code, detail, chips=chips)


def explain_fit_failure(
    node_usages: List[DeviceUsage],
    ctr_requests: List[ContainerDeviceRequest],
    annos: Dict[str, str],
) -> Rejection:
    """Replay the whole pod on a fresh clone of an UN-MUTATED usage view
    and explain the first container that fails (prefit-failure path; the
    per-chip fitting path explains in place via
    :func:`explain_request_failure` instead)."""
    trial = [clone_usage(u) for u in node_usages]
    placed, failing_ci = fit_pod(trial, ctr_requests, annos)
    if placed is None:
        return explain_request_failure(trial, ctr_requests[failing_ci],
                                       annos, failing_ci)
    # every container placed on the replay — only reachable when the
    # caller's aggregate prefit was conservative; report it as capacity
    return Rejection(decisionmod.NODE_CAPACITY, {"fitting": 0})


def calc_score(
    node_usages: Dict[str, List[DeviceUsage]],
    ctr_requests: List[ContainerDeviceRequest],
    annos: Dict[str, str],
    mutable_usages: bool = False,
    host_state: Optional[Dict[str, Tuple[int, int]]] = None,
) -> Tuple[List[NodeScore], Dict[str, Rejection]]:
    """Score every candidate node; returns (fitting nodes sorted
    best-first, a structured Rejection per non-fitting node — render
    with str() for the extender's FailedNodes strings)
    (reference: score.go:183-214).

    `mutable_usages=True` grants ownership of `node_usages` to the
    scorer: placement trials mutate the passed DeviceUsage objects in
    place instead of cloning them first. The scheduler passes a fresh
    overlay snapshot this way, skipping one full copy of every
    candidate chip per filter() call. Rejection explains always read a
    fresh clone, so they are exact either way.

    `host_state` maps node -> (host capacity MB, committed MB): the
    NODE-level host-memory axis checked before any per-chip fitting
    when the pod carries a vtpu.io/host-memory reservation. None/absent
    nodes = unreported capacity = legacy-unlimited."""
    results: List[NodeScore] = []
    failed: Dict[str, Rejection] = {}
    need_slots, need_mem, need_cores = aggregate_demand(ctr_requests)
    host_demand = host_mem_request_mb(annos)
    for node_id, usages in node_usages.items():
        if host_demand and host_state is not None:
            cap, used = host_state.get(node_id, (0, 0))
            host_rej = host_fit_rejection(host_demand, cap, used)
            if host_rej is not None:
                failed[node_id] = host_rej
                continue
        if not node_prefits(usages, need_slots, need_mem, need_cores):
            failed[node_id] = explain_fit_failure(usages, ctr_requests,
                                                 annos)
            continue
        trial = usages if mutable_usages \
            else [clone_usage(u) for u in usages]
        placed, failing_ci = fit_pod(trial, ctr_requests, annos)
        if placed is None:
            # explain against the exact state the request failed in
            # (earlier containers' trial placements included) — the
            # mutable snapshot has no pristine copy to replay
            failed[node_id] = explain_request_failure(
                trial, ctr_requests[failing_ci], annos, failing_ci)
            continue
        breakdown: Dict[str, float] = {}
        results.append(
            NodeScore(
                node_id=node_id,
                devices=placed,
                score=score_node(trial, placed, breakdown=breakdown),
                breakdown=breakdown,
            )
        )
    results.sort(key=lambda r: (-r.score, r.node_id))
    return results, failed
