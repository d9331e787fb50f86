"""Environment-knob parsing for the port's node agent.

The port's copy of vtpu/util/env.py: one parse-or-default implementation,
where a malformed value degrades to the default (a config mistake must
never crash a plugin at import time). The knob names themselves are
declared in :mod:`vtpu_torch.api`.
"""

from __future__ import annotations

import os


def env_int(name: str, default: int, minimum: int | None = None) -> int:
    try:
        v = int(os.environ.get(name, "") or default)
    except ValueError:
        v = default
    if minimum is not None and v < minimum:
        return minimum
    return v


def env_float(name: str, default: float,
              minimum: float | None = None) -> float:
    try:
        v = float(os.environ.get(name, "") or default)
    except ValueError:
        v = default
    if minimum is not None and v < minimum:
        return minimum
    return v


def env_str(name: str, default: str = "") -> str:
    """Plain string knob; unset (not merely empty) yields the default."""
    v = os.environ.get(name)
    return default if v is None else v


def env_bool(name: str, default: bool = False) -> bool:
    """Boolean knob: unset/empty -> default; "0"/"false"/"no"/"off"
    (any case) -> False; anything else -> True."""
    v = os.environ.get(name)
    if v is None or not v.strip():
        return default
    return v.strip().lower() not in ("0", "false", "no", "off")
