"""Global scheduling defaults (the port's copy of vtpu/device/config.py;
reference: pkg/scheduler/config/config.go:19-24).

default_mem == 0 means "whole card" (expressed as mem-percentage 100) and
default_cores == 0 means "fit on any card regardless of core load" — the
semantics the reference documents at docs/config.md:17-20.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..api import SCHEDULER_NAME


@dataclass
class SchedulerConfig:
    scheduler_name: str = SCHEDULER_NAME
    default_mem: int = 0        # MB; 0 => whole card
    default_cores: int = 0      # SM %; 0 => fit anywhere
    default_replicas: int = 1   # devices per pod when only gpumem given


GLOBAL = SchedulerConfig()
