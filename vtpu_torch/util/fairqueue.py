"""Tenant-fair bounded intake queue.

The port's copy of vtpu/util/fairqueue.py.

One implementation of the round-robin-by-namespace drain,
shared by the scheduler's /filter webhook intake
(vtpu/scheduler/routes.py) and the serving gateway's per-model
request queues (vtpu/gateway/batcher.py) — one discipline, not two
drifting copies.

Semantics (docs/serving.md, docs/benchmark.md):

- ``push(tenant, item)`` appends to the tenant's FIFO; when the TOTAL
  queued count has reached ``capacity`` it raises :class:`FairQueueFull`
  instead — callers translate that into their retryable refusal
  (HTTP 429 / ``ShedError``), never an opaque timeout.
- ``take(k)`` drains up to ``k`` items round-robin ACROSS tenants, one
  item per tenant per pass: a K-item burst from one namespace and a
  single item from another always interleave, so no tenant's burst can
  starve another's singleton.
- Per-tenant FIFO order is preserved; the cross-tenant cursor restarts
  from tenant insertion order on each ``take`` (the queue is drained in
  batches, so a persistent cursor would only reshuffle within a batch).

The structure is a plain synchronous container: it does NOT own a lock
or an event loop. The webhook intake mutates it only from its single
event-loop thread; the gateway wraps it in the batcher's lock.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Deque, Dict, List, Tuple

__all__ = ["FairQueue", "FairQueueFull"]


class FairQueueFull(Exception):
    """push() refused: the queue is at capacity. The caller sheds
    retryably (429-style) rather than queueing unboundedly."""


class FairQueue:
    """Bounded multi-tenant FIFO with round-robin cross-tenant drain."""

    def __init__(self, capacity: int) -> None:
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._tenants: Dict[str, Deque[Any]] = {}
        self._count = 0

    def __len__(self) -> int:
        return self._count

    @property
    def full(self) -> bool:
        return self._count >= self.capacity

    def tenants(self) -> List[str]:
        """Tenants with queued items, in insertion (drain-cursor) order."""
        return list(self._tenants)

    def depth(self, tenant: str) -> int:
        q = self._tenants.get(tenant)
        return len(q) if q is not None else 0

    def push(self, tenant: str, item: Any) -> None:
        """Append item to tenant's FIFO; FairQueueFull at capacity."""
        if self._count >= self.capacity:
            raise FairQueueFull(
                f"intake full ({self.capacity} queued); retry")
        self._tenants.setdefault(tenant, deque()).append(item)
        self._count += 1

    def take(self, k: int) -> List[Any]:
        """Drain up to k items, one per tenant per pass (round-robin)."""
        batch: List[Any] = []
        tenants = self._tenants
        while tenants and len(batch) < k:
            for tenant in list(tenants):
                q = tenants[tenant]
                batch.append(q.popleft())
                if not q:
                    del tenants[tenant]
                if len(batch) >= k:
                    break
        self._count -= len(batch)
        return batch

    def drain_items(self) -> List[Tuple[str, Any]]:
        """Remove and return EVERYTHING as (tenant, item) pairs, in the
        same round-robin order take() would have produced. Used by
        owners that must fail queued work explicitly (loop teardown,
        replica drain) instead of silently dropping it."""
        out: List[Tuple[str, Any]] = []
        tenants = self._tenants
        while tenants:
            for tenant in list(tenants):
                q = tenants[tenant]
                out.append((tenant, q.popleft()))
                if not q:
                    del tenants[tenant]
        self._count = 0
        return out

    def clear(self) -> None:
        """Drop everything (owner already failed/abandoned the items —
        e.g. the webhook's foreign-event-loop reset, where the futures
        belonged to a loop that no longer exists)."""
        self._tenants = {}
        self._count = 0
