"""In-process and host-side quota plumbing (the port of vtpu/enforce).

- ``vtpu_torch.enforce.region`` — ctypes view of the shared region
  (vtpu_torch/csrc/shared_region.h).
- ``vtpu_torch.enforce.workload`` — what a PyTorch workload inside a
  quota-limited container calls: :func:`install`, :func:`quota_from_env`.
"""

from .region import RegionView, SharedRegion  # noqa: F401
from .workload import Enforcer, Quota, install, quota_from_env  # noqa: F401
