"""Entitlement licenses for ``vgpu-validator`` (vtpu_torch/csrc/validator.c).

A license is ``key=value`` lines (``product``, ``expires`` in unix seconds,
``nodes`` an fnmatch glob against the node's hostname, ``max_chips``) and a
last ``sig=`` line: the hex HMAC-SHA256 of every line before it, keyed by
the operator's secret. The device plugin mounts ``<shim dir>/license/
license`` and the validator into a container when the host carries a
license (server.py ``_container_response``); the container runs
``vgpu-validator /vgpu/license`` with the secret in its env
(``VGPU_LICENSE_SECRET``, from a Secret). :func:`mint` writes one, as the
validator's ``--sign`` mode would sign it.
"""

from __future__ import annotations

import hashlib
import hmac

from .. import api


def mint(secret: bytes, expires: int, nodes: str = "*",
         max_chips: int = 0, product: str = api.LICENSE_PRODUCT) -> str:
    """The text of a license signed with ``secret``."""
    body = (f"product={product}\nexpires={int(expires)}\nnodes={nodes}\n"
            f"max_chips={int(max_chips)}\n")
    sig = hmac.new(secret, body.encode(), hashlib.sha256).hexdigest()
    return f"{body}sig={sig}\n"
