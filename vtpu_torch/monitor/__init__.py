"""The node monitor of the port: the counterpart of vtpu/monitor over the
regions libvgpu.so writes (reference cmd/vGPUmonitor/: main.go:11-32 wires
three loops).

- :mod:`vtpu_torch.monitor.pathmonitor` — discovers the per-container
  region files (``<podUID>_<n>/vgpu.cache``) under the plugin's containers
  dir, mmaps them, quarantines corrupt ones, GCs dirs of vanished pods.
- :mod:`vtpu_torch.monitor.feedback` — the priority/blocking loop writing
  the regions' feedback plane (``recent_kernel``, ``utilization_switch``).
- :mod:`vtpu_torch.monitor.metrics` — the Prometheus collector over the
  regions plus NVML's card inventory.
- :mod:`vtpu_torch.monitor.hostguard`, :mod:`~vtpu_torch.monitor.resize`,
  :mod:`~vtpu_torch.monitor.migrate` — host-ledger escalation, annotation
  resizes, the live-migration drain handshake.
- :mod:`vtpu_torch.monitor.daemon` — ties them together behind one process
  (``python -m vtpu_torch.monitor``).

None of them imports torch: the monitor holds no CUDA context.
"""

from .pathmonitor import ContainerRegions  # noqa: F401
from .feedback import FeedbackLoop  # noqa: F401
