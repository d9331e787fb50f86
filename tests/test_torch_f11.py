"""F11, a deliberate difference from the JAX rebalancer, tested as one.

The rebalancer's per-container decision (``_plan_container``) on the same
signals in both packages: a stub scheduler whose pod cache holds one
pod's assignment, and a /nodeinfo entry's usage, limits and pressure
counters. The JAX package shrinks a container whose devices read 0 MiB
used to ``max(1, ceil(0 x headroom))`` = 1 MiB. Under ``libvgpu.so`` every
live CUDA process holds its context's footprint in its region (ROADMAP F1),
so 0 MiB means a pod that attached before it made its context: on an
H100 such a shrink refused the pod's first allocation after its 543 MB
context (``vtpu_torch.scheduler.livemove`` with ``VTPU_REBALANCE_S=1``). The
port never shrinks a container while any of its devices reads 0 MiB;
every other decision is the JAX rebalancer's, exactly.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import pytest

from vtpu.scheduler import rebalancer as jax_rebalancer
from vtpu.util import types as jax_types
from vtpu_torch.scheduler import rebalancer
from vtpu_torch.util import types


@dataclass
class _Info:
    node_id: str
    devices: List


class _Pods:
    def __init__(self, info):
        self.info = info

    def get(self, namespace, name, uid):
        return self.info


class _Sched:
    def __init__(self, info):
        self.pods = _Pods(info)


def decide(mod, tmod, quotas, used, limit=None, pressure=(0, 0),
           prior=None):
    """``mod``'s decision for one container assigned ``quotas`` MiB (one
    per device) whose region reads ``used`` MiB; ``prior`` pressure
    counters seen on a poll before, so ``pressure`` is a delta"""
    devs = [tmod.ContainerDevice(uuid=f"GPU-{i}", type="NVIDIA",
                                 usedmem=q, usedcores=25)
            for i, q in enumerate(quotas)]
    r = mod.Rebalancer(_Sched(_Info("n1", [devs])), source=None,
                       period_s=0.0, headroom_pct=25.0)

    def sig(counters):
        return mod._PodSignal(
            namespace="default", name="p", uid="u", node="n1",
            container=0, used_mb=list(used),
            limit_mb=list(limit or quotas), near_limit_failures=counters[0],
            at_limit_ns=counters[1])

    if prior is not None:
        r._plan_container(sig(prior))
    return r._plan_container(sig(pressure))


#: (quotas MiB, used MiB, pressure, prior): inputs where the two agree
AGREE = [
    ([8192], [6000], (0, 0), None),         # comfortable: no release
    ([8192], [1000], (0, 0), None),         # padded: shrink to 1250
    ([8192], [8000], (0, 0), None),         # past 90%: grow
    ([4096, 4096], [1000, 3000], (0, 0), None),  # mixed: shrink both
    ([4096, 4096], [4000, 100], (0, 0), None),   # one device grows
    ([8192], [6000], (3, 0), (1, 0)),       # pressure delta: grow
    ([8192], [6000], (3, 0), None),         # first sight is history
    ([1024], [1], (0, 0), None),            # 1 MiB used is a reading
]

#: (quotas MiB, used MiB, pressure, prior): a device reads 0 MiB
F11 = [([8192], [0], (0, 0), None), ([4096, 4096], [0, 0], (0, 0), None),
       ([4096, 4096], [2000, 0], (0, 0), None),
       ([4096, 4096], [0, 100], (0, 0), None),
       ([8192], [0], (5, 0), (1, 0))]      # pressured, yet nothing to grow


@pytest.mark.parametrize("quotas,used,pressure,prior", AGREE)
def test_every_other_decision_is_the_references(quotas, used, pressure,
                                                prior):
    want = decide(jax_rebalancer, jax_types, quotas, used,
                  pressure=pressure, prior=prior)
    got = decide(rebalancer, types, quotas, used, pressure=pressure,
                 prior=prior)
    assert got == want


@pytest.mark.parametrize("quotas,used,pressure,prior", F11)
def test_f11_no_shrink_while_a_device_reads_zero(quotas, used, pressure,
                                                 prior):
    jax = decide(jax_rebalancer, jax_types, quotas, used,
                 pressure=pressure, prior=prior)
    port = decide(rebalancer, types, quotas, used, pressure=pressure,
                  prior=prior)
    # the reference shrinks the idle device to 1 MiB; the port waits for
    # the pod's first charged byte
    assert jax is not None and jax[0] == "shrink"
    assert [t for t, u in zip(jax[1], used) if u == 0] == \
        [1] * used.count(0)
    assert port is None


def test_f11_the_first_charged_byte_lifts_the_hold():
    """Once the context is charged the port shrinks as the reference
    does, to the same target."""
    used = [600]   # a context's footprint, in MiB
    assert decide(rebalancer, types, [8192], used) == decide(
        jax_rebalancer, jax_types, [8192], used) == ("shrink", [750],
                                                     [8192])
