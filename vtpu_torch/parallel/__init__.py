"""Placement solvers of the port's scheduler: the port's copy of
vtpu/parallel's mesh solver (the rest of vtpu/parallel is JAX sharding,
which the port does in vtpu_torch.models.train)."""

from . import mesh  # noqa: F401
