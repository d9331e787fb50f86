"""Structured scheduling-decision records (the port's copy of
vtpu/trace/decision.py).

The reference answers "why didn't pod X schedule" with free-text
FailedNodes strings assembled inside calcScore (score.go:183-214) — one
English sentence per node, unparseable by tooling and silent about the
chip-level cause. Here the machine-readable record is the source of
truth: scoring produces :class:`Rejection` objects (node-level code +
per-chip :class:`ChipReject` causes with the actual numbers — HBM short
by N MB, core percent missing, type mismatch), the extender wire
protocol's FailedNodes strings become *renderings* of them, and
`_decide_locked` folds the whole candidate sweep into one
:class:`DecisionTrace` stored in the trace ring buffer
(vtpu_torch/trace/core.py) and served by ``GET /trace/{ns}/{name}``.

Rendering is lazy and memoized: Rejection objects live in the verdict
cache across a filter burst (scheduler/score.py VerdictCache), so the
hot path pays one string build per (node generation, request signature),
not one per filter call.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

#: chip-level rejection codes (the numbers live in ChipReject.detail)
CHIP_UNHEALTHY = "unhealthy"
CHIP_TYPE_MISMATCH = "type_mismatch"
CHIP_TASKS_FULL = "tasks_full"
CHIP_HBM_SHORT = "hbm_short"
CHIP_CORES_SHORT = "cores_short"
CHIP_EXCLUSIVE_BUSY = "exclusive_busy"
CHIP_CORES_EXHAUSTED = "cores_exhausted"

#: node-level rejection codes
NODE_CAPACITY = "capacity"          # not enough fitting chips
NODE_MESH = "mesh"                  # enough chips, no contiguous sub-mesh
NODE_UNREGISTERED = "unregistered"  # candidate has no vGPU inventory
NODE_NO_NODES = "no_nodes"          # nothing registered at all
NODE_SLICE_GANG = "slice_gang"      # multi-host gang reservation refused
NODE_NO_VENDOR = "no_vendor"        # request names an unknown vendor
NODE_HOST_MEM_SHORT = "host_mem_short"  # node host-RAM axis cannot fit
NODE_GROUP_NOT_OWNED = "group_not_owned"  # multi-active: another
# scheduler instance owns this node's shard group (docs/ha.md)

_CHIP_TEXT = {
    CHIP_UNHEALTHY: lambda d: "unhealthy",
    CHIP_TYPE_MISMATCH: lambda d: f"type {d.get('chip_type', '?')} excluded",
    CHIP_TASKS_FULL: lambda d: (
        f"task slots full ({d.get('used', '?')}/{d.get('count', '?')})"),
    CHIP_HBM_SHORT: lambda d: (
        f"HBM short {d.get('short_mb', '?')}MB "
        f"(need {d.get('need_mb', '?')}, free {d.get('free_mb', '?')})"),
    CHIP_CORES_SHORT: lambda d: (
        f"cores short {d.get('short_pct', '?')}% "
        f"(need {d.get('need_pct', '?')}, free {d.get('free_pct', '?')})"),
    CHIP_EXCLUSIVE_BUSY: lambda d: (
        f"exclusive request but {d.get('sharing', '?')} task(s) sharing"),
    CHIP_CORES_EXHAUSTED: lambda d: "cores fully claimed",
}


class ChipReject:
    """Why one chip refused one container request — code + numbers."""

    __slots__ = ("chip", "code", "detail")

    def __init__(self, chip: str, code: str,
                 detail: Optional[Dict[str, Any]] = None) -> None:
        self.chip = chip
        self.code = code
        self.detail = detail or {}

    def render(self) -> str:
        text = _CHIP_TEXT.get(self.code)
        return (f"{self.chip}: {text(self.detail)}" if text
                else f"{self.chip}: {self.code}")

    def to_dict(self) -> Dict[str, Any]:
        return {"chip": self.chip, "code": self.code, **self.detail}


class Rejection:
    """One candidate node's machine-readable refusal.

    ``str(rejection)`` yields the human form that goes out as the
    extender's FailedNodes entry; the structured fields feed the
    DecisionTrace. The rendering memoizes — these objects are shared
    through the verdict cache across a filter burst."""

    __slots__ = ("code", "detail", "chips", "chips_truncated", "_text")

    #: chip causes kept per rejection (a 64-chip node's full cause list
    #: is noise; the counts in `detail` stay exact)
    MAX_CHIPS = 16

    def __init__(self, code: str, detail: Optional[Dict[str, Any]] = None,
                 chips: Optional[List[ChipReject]] = None,
                 message: str = "") -> None:
        self.code = code
        self.detail = detail or {}
        self.chips = (chips or [])[: self.MAX_CHIPS]
        self.chips_truncated = max(0, len(chips or []) - self.MAX_CHIPS)
        self._text = message or None

    def render(self) -> str:
        if self._text is None:
            self._text = self._render()
        return self._text

    __str__ = render

    def __repr__(self) -> str:  # debugging/log readability
        return f"Rejection({self.code!r}, {self.detail!r})"

    def _render(self) -> str:
        if self.code == NODE_NO_NODES:
            return "no vGPU nodes registered"
        if self.code == NODE_UNREGISTERED:
            return "node has no registered vGPU inventory"
        if self.code == NODE_GROUP_NOT_OWNED:
            owner = self.detail.get("owner") or "another instance"
            return (f"shard group {self.detail.get('group', '?')} owned "
                    f"by {owner}; retry routes there")
        if self.code == NODE_NO_VENDOR:
            return (f"no vendor backend for device type "
                    f"{self.detail.get('type', '?')}")
        if self.code == NODE_HOST_MEM_SHORT:
            return (f"host memory short {self.detail.get('short_mb', '?')}MB "
                    f"(need {self.detail.get('need_mb', '?')}, free "
                    f"{self.detail.get('free_mb', '?')} of "
                    f"{self.detail.get('capacity_mb', '?')})")
        if self.code == NODE_MESH:
            head = (f"{self.detail.get('fitting', '?')} chip(s) fit but no "
                    f"contiguous ICI sub-mesh of {self.detail.get('need', '?')}")
        else:
            head = (f"insufficient vGPU capacity "
                    f"({self.detail.get('fitting', 0)} of "
                    f"{self.detail.get('need', '?')} chip(s) fit)")
        if self.chips:
            causes = "; ".join(c.render() for c in self.chips)
            if self.chips_truncated:
                causes += f"; +{self.chips_truncated} more"
            return f"{head}: {causes}"
        return head

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"code": self.code, "reason": self.render()}
        if self.detail:
            out["detail"] = dict(self.detail)
        if self.chips:
            out["chips"] = [c.to_dict() for c in self.chips]
        if self.chips_truncated:
            out["chips_truncated"] = self.chips_truncated
        return out


class DecisionTrace:
    """One filter() decision, machine-readable end to end: every
    candidate's verdict provenance (verdict-cache hit or fresh fit),
    the structured rejections, and the winner's score breakdown.

    Built inside `_decide_locked` under the decide lock, so it must stay
    allocation-light: rejections are stored as references into the
    verdict cache (capped at MAX_REJECTIONS) and only rendered to JSON
    when a /trace request or the journal asks."""

    __slots__ = ("trace_id", "namespace", "name", "uid", "wall_ts",
                 "winner", "score", "breakdown", "devices", "candidates",
                 "fit_count", "cache_hits", "cache_misses", "rejections",
                 "rejections_truncated", "runners_up", "gang",
                 "preemption")

    MAX_REJECTIONS = 64
    MAX_RUNNERS_UP = 3

    def __init__(self, trace_id: str, namespace: str, name: str,
                 uid: str, wall_ts: float) -> None:
        self.trace_id = trace_id
        self.namespace = namespace
        self.name = name
        self.uid = uid
        self.wall_ts = wall_ts
        self.winner: Optional[str] = None
        self.score: float = 0.0
        self.breakdown: Dict[str, float] = {}
        self.devices: Any = None           # winner's PodDevices (shared ref)
        self.candidates = 0
        self.fit_count = 0
        self.cache_hits = 0
        self.cache_misses = 0
        self.rejections: List[Tuple[str, Rejection]] = []
        self.rejections_truncated = 0
        self.runners_up: List[Tuple[str, float]] = []
        self.gang: Optional[Dict[str, Any]] = None
        # priority preemption (vtpu/scheduler/preempt.py): a structured
        # PREEMPTED record ({"result": "PREEMPTED", "node", "victims":
        # [{pod, uid, priority, freed_mb, ...}], "freed_mb"}) or
        # {"result": "NO_VICTIMS"} when a higher-priority arrival
        # failed fit and the engine could not cure it — the exact
        # victim list and freed MB the acceptance criteria name
        self.preemption: Optional[Dict[str, Any]] = None

    def add_rejection(self, node: str, rejection: Rejection) -> None:
        if len(self.rejections) < self.MAX_REJECTIONS:
            self.rejections.append((node, rejection))
        else:
            self.rejections_truncated += 1

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "trace_id": self.trace_id,
            "pod": f"{self.namespace}/{self.name}",
            "uid": self.uid,
            "ts": self.wall_ts,
            "winner": self.winner,
            "candidates": self.candidates,
            "fit": self.fit_count,
            "cache": {"hits": self.cache_hits, "misses": self.cache_misses},
            "rejections": {n: r.to_dict() for n, r in self.rejections},
        }
        if self.winner is not None:
            out["score"] = self.score
            out["score_breakdown"] = dict(self.breakdown)
            if self.devices:
                out["devices"] = [
                    [{"chip": d.uuid, "mem_mb": d.usedmem,
                      "cores_pct": d.usedcores} for d in ctr]
                    for ctr in self.devices
                ]
        if self.runners_up:
            out["runners_up"] = [
                {"node": n, "score": s} for n, s in self.runners_up]
        if self.rejections_truncated:
            out["rejections_truncated"] = self.rejections_truncated
        if self.gang is not None:
            out["gang"] = dict(self.gang)
        if self.preemption is not None:
            out["preemption"] = dict(self.preemption)
        return out
