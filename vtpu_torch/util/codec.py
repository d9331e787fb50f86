"""String codecs for the annotation wire protocol.

The port's copy of vtpu/util/codec.py (node inventory, pod assignments and
the gang slice block), wire-identical: a string either package encodes, the
other decodes to the same values. The formats are compact
comma/colon/semicolon-joined strings because they live inside Kubernetes
annotation values (max 256 KiB total per object).

Wire grammar:

  node register  :=  chip (":" chip)*
  chip           :=  id "," count "," devmem "," devcore "," type "," numa
                     "," mesh "," health
  mesh           :=  x "-" y "-" z | "*"

  pod devices    :=  container (";" container)*      (trailing ";" tolerated)
  container      :=  device (":" device)* | ""       (empty = no card for it)
  device         :=  uuid "," type "," usedmem "," usedcores

A card's type comes from NVML (``"NVIDIA-" + name``) and its id is NVML's
UUID, so unlike the TPU's generated ids they are not ours to choose: a
field holding a separator would encode to a string that decodes to other
values, and encoding refuses it with :class:`CodecError`.
"""

from __future__ import annotations

from typing import List

from .types import (
    ContainerDevice,
    ContainerDevices,
    DeviceInfo,
    MeshCoord,
    PodDevices,
)

_SEPARATORS = (",", ":", ";")


class CodecError(ValueError):
    pass


def _field(value: str, what: str) -> str:
    if any(sep in value for sep in _SEPARATORS):
        raise CodecError(f"{what} {value!r} holds a wire separator "
                         f"({' '.join(_SEPARATORS)})")
    return value


# --------------------------------------------------------------------------
# Node device inventory (reference: util.go:100-134 encode, 68-99 decode)
# --------------------------------------------------------------------------

def encode_node_devices(devices: List[DeviceInfo]) -> str:
    recs = []
    for d in devices:
        mesh = d.mesh.encode() if d.mesh is not None else "*"
        recs.append(
            f"{_field(d.id, 'device id')},{d.count},{d.devmem},{d.devcore},"
            f"{_field(d.type, 'device type')},{d.numa},"
            f"{mesh},{str(d.health).lower()}"
        )
    return ":".join(recs)


def decode_node_devices(s: str) -> List[DeviceInfo]:
    if not s:
        return []
    out: List[DeviceInfo] = []
    for rec in s.split(":"):
        if not rec:
            continue
        parts = rec.split(",")
        if len(parts) != 8:
            raise CodecError(f"bad node device record {rec!r}")
        out.append(
            DeviceInfo(
                id=parts[0],
                index=len(out),
                count=int(parts[1]),
                devmem=int(parts[2]),
                devcore=int(parts[3]),
                type=parts[4],
                numa=int(parts[5]),
                mesh=MeshCoord.decode(parts[6]),
                health=parts[7] == "true",
            )
        )
    return out


# --------------------------------------------------------------------------
# Pod assignments (reference: util.go:136-172)
# --------------------------------------------------------------------------

def encode_container_devices(devs: ContainerDevices) -> str:
    return ":".join(
        f"{_field(d.uuid, 'device uuid')},{_field(d.type, 'device type')},"
        f"{d.usedmem},{d.usedcores}" for d in devs)


def encode_pod_devices(pod_devices: PodDevices) -> str:
    return ";".join(encode_container_devices(c) for c in pod_devices)


def decode_container_devices(s: str) -> ContainerDevices:
    if not s:
        return []
    out: ContainerDevices = []
    for rec in s.split(":"):
        if not rec:
            continue
        parts = rec.split(",")
        if len(parts) != 4:
            raise CodecError(f"bad container device record {rec!r}")
        out.append(
            ContainerDevice(
                uuid=parts[0],
                type=parts[1],
                usedmem=int(parts[2]),
                usedcores=int(parts[3]),
            )
        )
    return out


def decode_pod_devices(s: str) -> PodDevices:
    """Exact inverse of encode_pod_devices; empty container slots round-trip
    (mirrors the reference's empty-slot handling, util_test.go:28-56):
    "a,NVIDIA,1,2;;" decodes to [[dev], [], []]."""
    if not s:
        return []
    return [decode_container_devices(c) for c in s.split(";")]


# --------------------------------------------------------------------------
# Gang slice block (vtpu/util/codec.py:265-290), read by Allocate's mesh env
# --------------------------------------------------------------------------

def decode_slice_block_mesh(
    s: str,
) -> "tuple[str, List[str], tuple | None, List[tuple] | None]":
    """(slice name, hosts, shape, per-host coords); shape/coords are
    None for v1 blocks. Garbled geometry degrades to None (the block
    itself still decodes)."""
    if not s or ";" not in s:
        raise CodecError(f"bad slice block {s!r}")
    parts = s.split(";")
    slice_name, hosts_s = parts[0], parts[1]
    hosts = [h for h in hosts_s.split(",") if h]
    if not slice_name or not hosts:
        raise CodecError(f"bad slice block {s!r}")
    if len(parts) < 4:
        return slice_name, hosts, None, None
    try:
        shape = tuple(int(d) for d in parts[2].split("x"))
        coords = [tuple(int(c) for c in coord.split("-"))
                  for coord in parts[3].split("|")]
        if len(shape) != 3 or any(len(c) != 3 for c in coords) \
                or len(coords) != len(hosts):
            raise ValueError(s)
    except ValueError:
        return slice_name, hosts, None, None
    return slice_name, hosts, shape, coords
