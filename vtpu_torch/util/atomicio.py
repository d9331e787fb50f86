"""Atomic small-file writes for node-plane durable state.

The port's copy of vtpu/util/atomicio.py. The device plugin's allocation
checkpoint is read back after a SIGKILL at any instruction boundary, so a
torn or half-written file must be impossible: every write goes through
write-to-temp + fsync + rename + directory fsync (the same discipline
``shared_region.c`` applies to region initialization with its flock'd
ftruncate).
"""

from __future__ import annotations

import json
import logging
import os
import tempfile
from typing import Any, Optional

log = logging.getLogger(__name__)


def atomic_write_bytes(path: str, data: bytes, fsync: bool = True) -> None:
    """Write ``data`` to ``path`` atomically: a reader (or a restarted
    daemon) sees either the previous complete content or the new
    complete content, never a prefix. ``fsync=True`` additionally makes
    the rename durable across a machine crash (file fsync before the
    rename, directory fsync after)."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d,
                               prefix=os.path.basename(path) + ".tmp.")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            if fsync:
                os.fsync(f.fileno())
        os.replace(tmp, path)
    except Exception:
        try:
            os.unlink(tmp)
        except FileNotFoundError:
            pass
        raise
    if fsync:
        try:
            dfd = os.open(d, os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)
        except OSError as e:
            # the rename itself succeeded; losing the directory fsync
            # only narrows crash-durability, not atomicity
            log.debug("directory fsync of %s failed: %s", d, e)


def atomic_write_json(path: str, obj: Any, fsync: bool = True) -> None:
    atomic_write_bytes(
        path,
        json.dumps(obj, sort_keys=True, separators=(",", ":")).encode()
        + b"\n",
        fsync=fsync)


def read_json(path: str) -> Optional[Any]:
    """Load a JSON file written by :func:`atomic_write_json`; ``None``
    when absent or unreadable (a corrupt durable file must degrade to
    'no state', never crash the daemon reading it)."""
    try:
        with open(path, "rb") as f:
            return json.loads(f.read().decode("utf-8"))
    except FileNotFoundError:
        return None
    except (OSError, ValueError) as e:
        log.warning("unreadable state file %s: %s", path, e)
        return None
