"""HA control plane: leader-elected scheduler pair with durable gang

The port's copy of vtpu/ha/__init__.py.
state and crash-recovery rebuild (docs/ha.md).

Three cooperating pieces:

  * :mod:`vtpu_torch.ha.lease` — ClusterLease, the nodelock CAS discipline
    generalized onto a coordination.k8s.io Lease, with a fencing
    generation (leaseTransitions) that rides every assignment commit.
  * :mod:`vtpu_torch.ha.coordinator` — HACoordinator, the active/passive role
    state machine; promotion runs the gang-state rebuild before the new
    leader serves a single decision.
  * :mod:`vtpu_torch.ha.groups` — GroupCoordinator, the multi-active
    generalization: one lease PER SHARD GROUP, N instances each owning
    a disjoint group subset and deciding concurrently, with per-group
    fencing generations.
  * Durable gang state lives in the scheduler itself: the solved block
    annotation (types.SLICE_BLOCK_ANNO) written with every confirmed
    member's commit, and SliceReservations.rebuild /
    Scheduler.recover reconstructing reservations from live pods.
"""

from .coordinator import HACoordinator, ROLE_LEADER, ROLE_STANDBY
from .groups import GroupCoordinator, ordinal_from_identity
from .lease import ClusterLease, LEASE_EXPIRE_S

__all__ = [
    "ClusterLease", "GroupCoordinator", "HACoordinator", "LEASE_EXPIRE_S",
    "ROLE_LEADER", "ROLE_STANDBY", "ordinal_from_identity",
]
