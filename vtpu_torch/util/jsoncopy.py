"""Fast deep copy for JSON-shaped object trees (the port's copy of
vtpu/util/jsoncopy.py, used by the fake apiserver).

`copy.deepcopy` pays memo-dict bookkeeping, reduce-protocol dispatch,
and per-object type negotiation that plain API objects (nested dicts /
lists of scalars — everything the fake apiserver and the admission
webhook handle) never need. At the 1k-admissions/s front door those
copies ARE the fake-apiserver hot path: `json_copy` is ~4x faster on a
representative pod object (see benchmarks/sched_bench.py --fleet).

Scalars (str/int/float/bool/None) are immutable and shared; dicts and
lists are copied structurally. Exotic values (tuples, custom classes)
fall back to themselves — identical to what json.dumps round-tripping
would reject, so callers feeding real API objects never hit it.
"""

from __future__ import annotations


def json_copy(obj):
    """Deep copy of a JSON-shaped tree (dict/list/scalar)."""
    t = obj.__class__
    if t is dict:
        return {k: json_copy(v) for k, v in obj.items()}
    if t is list:
        return [json_copy(v) for v in obj]
    return obj
