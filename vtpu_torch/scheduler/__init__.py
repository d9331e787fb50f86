"""The scheduler extender and mutating webhook of the port: the port's copy
of vtpu/scheduler (with cmd/scheduler.py as ``python -m
vtpu_torch.scheduler``). It places GPU pods from the node inventory the
port's device plugin registers, over the same annotation bus. A host
program: it imports neither ``torch`` nor ``vtpu`` and holds no CUDA
context."""

from .core import Scheduler  # noqa: F401
