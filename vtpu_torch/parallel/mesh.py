"""ICI sub-mesh topology solver.

The port's copy of vtpu/parallel/mesh.py. NVML reports no mesh
coordinate, so a card the port's plugin registers never joins a box;
cards whose register annotation carries coordinates still do.

TPU-native replacement for the reference's MLULink ring machinery: the
`cntopo` binary that enumerates rings (mlu/cntopo/cntopo.go:60-100) and the
spider/board ring allocators choosing device sets with non-conflicting rings
(mlu/allocator/board.go:44-118, spider.go:41-100) under the policy triad
best-effort / restricted / guaranteed (mlu/const.go:24-26).

On TPU the hardware locality structure is the ICI mesh, not link rings: a
multi-chip pod wants chips forming a contiguous axis-aligned sub-mesh so XLA
collectives ride ICI without hops through foreign chips. This is a pure
solver over the chip coordinates carried in the node-register annotation —
no external binary (the cntopo CLI's job collapses into ~100 lines of
Python because a mesh is so much more regular than link rings).

Host-scale inputs are tiny (v4: 4 chips 2x2x1, v5e: 8 chips 2x4x1, v5p: 4),
so exhaustive enumeration is exact and O(small).
"""

from __future__ import annotations

import enum
import functools
import itertools
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

from ..util.types import MeshCoord

Coord = Tuple[int, int, int]


class Policy(str, enum.Enum):
    """Placement strictness (reference: mlu/const.go:24-26)."""

    BEST_EFFORT = "best-effort"   # contiguous if possible, else anything
    RESTRICTED = "restricted"     # must be ICI-connected (no islands)
    GUARANTEED = "guaranteed"     # must be a full contiguous sub-mesh box


@dataclass
class Candidate:
    chips: List[str]
    shape: Tuple[int, int, int] = (0, 0, 0)
    contiguous: bool = False      # axis-aligned full box
    connected: bool = False       # one ICI component
    score: float = 0.0
    # absolute mesh coords, positional with `chips` (empty when any
    # chip's topology is unknown) — the geometry the slice scheduler
    # persists into the slice-block annotation so Allocate can emit
    # the VTPU_MESH_* env contract (docs/multihost.md)
    coords: Tuple[Coord, ...] = ()


def _neighbors(c: Coord) -> List[Coord]:
    x, y, z = c
    return [
        (x - 1, y, z), (x + 1, y, z),
        (x, y - 1, z), (x, y + 1, z),
        (x, y, z - 1), (x, y, z + 1),
    ]


def is_connected(coords: Sequence[Coord]) -> bool:
    if not coords:
        return False
    todo = {tuple(c) for c in coords}
    stack = [next(iter(todo))]
    todo.discard(stack[0])
    while stack:
        cur = stack.pop()
        for nb in _neighbors(cur):
            if nb in todo:
                todo.discard(nb)
                stack.append(nb)
    return not todo


def _shapes(n: int, bounds: Tuple[int, int, int]) -> List[Tuple[int, int, int]]:
    """All (dx,dy,dz) boxes of volume n fitting within bounds, most compact
    (lowest surface area) first."""
    out = []
    bx, by, bz = bounds
    for dx in range(1, min(n, bx) + 1):
        if n % dx:
            continue
        rest = n // dx
        for dy in range(1, min(rest, by) + 1):
            if rest % dy:
                continue
            dz = rest // dy
            if dz <= bz:
                out.append((dx, dy, dz))
    out.sort(key=lambda s: (
        s[0] * s[1] + s[1] * s[2] + s[0] * s[2],  # half surface area
        s,
    ))
    return out


def enumerate_submeshes(
    chips: Dict[str, MeshCoord], n: int
) -> List[Candidate]:
    """All full axis-aligned boxes of exactly n available chips, best first.

    The analog of `cntopo find` returning every non-conflicting ring
    (cntopo.go:60-100): every way to carve a contiguous n-chip sub-mesh out
    of the healthy chips on one node.
    """
    if n <= 0 or len(chips) < n:
        return []
    by_coord: Dict[Coord, str] = {}
    for uuid, mc in chips.items():
        if mc is None:
            continue  # unknown topology: chip can't join a contiguous box
        by_coord[mc.as_tuple()] = uuid
    if len(by_coord) < n:
        return []
    xs = [c[0] for c in by_coord]
    ys = [c[1] for c in by_coord]
    zs = [c[2] for c in by_coord]
    lo = (min(xs), min(ys), min(zs))
    hi = (max(xs), max(ys), max(zs))
    bounds = tuple(h - l + 1 for h, l in zip(hi, lo))

    out: List[Candidate] = []
    seen: Set[FrozenSet[str]] = set()
    for shape in _shapes(n, bounds):  # compact shapes first
        dx, dy, dz = shape
        for ox, oy, oz in itertools.product(
            range(lo[0], hi[0] - dx + 2),
            range(lo[1], hi[1] - dy + 2),
            range(lo[2], hi[2] - dz + 2),
        ):
            cells = [
                (ox + i, oy + j, oz + k)
                for i in range(dx) for j in range(dy) for k in range(dz)
            ]
            if all(c in by_coord for c in cells):
                uuids = [by_coord[c] for c in cells]
                key = frozenset(uuids)
                if key in seen:
                    continue
                seen.add(key)
                out.append(Candidate(
                    chips=uuids, shape=shape, contiguous=True,
                    connected=True,
                    score=_compactness(shape),
                    coords=tuple(cells),
                ))
    return out


def _compactness(shape: Tuple[int, int, int]) -> float:
    dx, dy, dz = shape
    vol = dx * dy * dz
    half_surface = dx * dy + dy * dz + dx * dz
    return vol / half_surface  # higher = more cube-like = better


# --------------------------------------------------------------------------
# Memoized coordinate solvers
#
# A mostly-idle homogeneous fleet presents the SAME free-chip shape
# thousands of times per filter burst (every v4 host with chips 2,3 free
# looks identical), so the geometric search runs over origin-normalized
# coordinate sets behind an LRU: identical shapes solve once, and
# choose_chips just maps the solved coordinates back to this node's chip
# uuids. Translation to the origin widens hits to congruent shapes at
# different offsets. Cache keys are tiny (hosts carry 4-8 chips).
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=4096)
def _best_box_cells(
    coords: FrozenSet[Coord], n: int
) -> Optional[Tuple[Tuple[Coord, ...], Tuple[int, int, int], float]]:
    """Best full axis-aligned n-cell box within a normalized coordinate
    set: (cells in shape-major order, shape, compactness score). Shapes
    are tried most-compact first and compactness is monotone in that
    order, so the FIRST feasible placement is exactly the max-score box
    `enumerate_submeshes` would surface."""
    xs = [c[0] for c in coords]
    ys = [c[1] for c in coords]
    zs = [c[2] for c in coords]
    lo = (min(xs), min(ys), min(zs))
    hi = (max(xs), max(ys), max(zs))
    bounds = (hi[0] - lo[0] + 1, hi[1] - lo[1] + 1, hi[2] - lo[2] + 1)
    for shape in _shapes(n, bounds):
        dx, dy, dz = shape
        for ox, oy, oz in itertools.product(
            range(lo[0], hi[0] - dx + 2),
            range(lo[1], hi[1] - dy + 2),
            range(lo[2], hi[2] - dz + 2),
        ):
            cells = tuple(
                (ox + i, oy + j, oz + k)
                for i in range(dx) for j in range(dy) for k in range(dz)
            )
            if all(c in coords for c in cells):
                return cells, shape, _compactness(shape)
    return None


@functools.lru_cache(maxsize=4096)
def _connected_cells(
    coords: FrozenSet[Coord], n: int
) -> Optional[Tuple[Coord, ...]]:
    """Greedy BFS growth to any single ICI-connected component of n
    cells, deterministic in the normalized coordinates alone."""
    by_coord = set(coords)
    for start in sorted(by_coord):
        picked = [start]
        picked_set = {start}
        frontier = [start]
        while frontier and len(picked) < n:
            cur = frontier.pop(0)
            for nb in _neighbors(cur):
                if nb in by_coord and nb not in picked_set:
                    picked.append(nb)
                    picked_set.add(nb)
                    frontier.append(nb)
                    if len(picked) == n:
                        break
        if len(picked) == n:
            return tuple(picked)
    return None


def solver_cache_info() -> Dict[str, object]:
    """Hit/miss counters for the memoized solvers (tests, benchmarks)."""
    return {
        "box": _best_box_cells.cache_info(),
        "connected": _connected_cells.cache_info(),
    }


def clear_solver_cache() -> None:
    _best_box_cells.cache_clear()
    _connected_cells.cache_clear()


def choose_chips(
    chips: Dict[str, MeshCoord], n: int, policy: Policy = Policy.BEST_EFFORT
) -> Optional[Candidate]:
    """Pick n chips under the policy; None when the policy can't be met
    (the allocator returning an error in the reference,
    mlu/allocator/board.go:44-118). Geometric solving is memoized on the
    origin-normalized free-coordinate signature, so a homogeneous fleet
    pays the search once per distinct shape, not once per node."""
    if n <= 0 or len(chips) < n:
        return None
    by_coord: Dict[Coord, str] = {}
    for uuid, mc in chips.items():
        if mc is None:
            continue  # unknown topology: chip can't join a contiguous set
        by_coord[mc.as_tuple()] = uuid
    norm: Optional[FrozenSet[Coord]] = None
    off = (0, 0, 0)
    if len(by_coord) >= n:
        off = (min(c[0] for c in by_coord),
               min(c[1] for c in by_coord),
               min(c[2] for c in by_coord))
        norm = frozenset((c[0] - off[0], c[1] - off[1], c[2] - off[2])
                         for c in by_coord)
        best = _best_box_cells(norm, n)
        if best is not None:
            cells, shape, score = best
            abs_cells = tuple((c[0] + off[0], c[1] + off[1],
                               c[2] + off[2]) for c in cells)
            return Candidate(
                chips=[by_coord[c] for c in abs_cells],
                shape=shape, contiguous=True, connected=True, score=score,
                coords=abs_cells,
            )
    if policy == Policy.GUARANTEED:
        return None
    if norm is not None:
        conn = _connected_cells(norm, n)
        if conn is not None:
            abs_cells = tuple((c[0] + off[0], c[1] + off[1],
                               c[2] + off[2]) for c in conn)
            return Candidate(
                chips=[by_coord[c] for c in abs_cells],
                contiguous=False, connected=True, score=0.0,
                coords=abs_cells,
            )
    if policy == Policy.RESTRICTED:
        return None
    # best-effort: any chips at all (including unknown topology) —
    # uuid-dependent, so deliberately uncached
    uuids = sorted(chips)[:n]
    coords = [chips[u].as_tuple() for u in uuids if chips[u] is not None]
    return Candidate(
        chips=uuids, contiguous=False,
        connected=len(coords) == n and is_connected(coords),
        coords=tuple(coords) if len(coords) == n else (),
    )


def locality_bonus(
    chips: Dict[str, MeshCoord], selected: Sequence[str]
) -> float:
    """Score term for the scheduler: 1.0 for a perfect sub-mesh box, 0.5 for
    a connected set, 0 otherwise. Folded into calcScore's node score so two
    otherwise-equal nodes tie-break on ICI locality (the design slot of the
    reference's ring-count sort, board.go:62-87)."""
    sel = {u: chips[u] for u in selected if u in chips}
    if len(sel) != len(selected) or not sel:
        return 0.0
    if any(mc is None for mc in sel.values()):
        return 0.0
    coords = [mc.as_tuple() for mc in sel.values()]
    if len(selected) == 1:
        return 1.0
    xs, ys, zs = zip(*coords)
    vol = (
        (max(xs) - min(xs) + 1)
        * (max(ys) - min(ys) + 1)
        * (max(zs) - min(zs) + 1)
    )
    if vol == len(coords):
        return 1.0
    if is_connected(coords):
        return 0.5
    return 0.0
