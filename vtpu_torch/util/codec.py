"""String codecs for the annotation wire protocol.

The port's copy of vtpu/util/codec.py (node inventory, pod assignments, the
resize intent, the migration stamp and record, and the gang slice block), wire-identical: a string either package encodes, the
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
# Elastic-quota resize intent (docs/elastic-quotas.md; no reference analog)
# --------------------------------------------------------------------------

def encode_hbm_limit(gen: int, limits_mb: List[List[int]]) -> str:
    """The durable resize intent (types.HBM_LIMIT_ANNO):
    "<generation>:<mb>,<mb>;<mb>,..." — one ";"-separated segment PER
    CONTAINER (matching the pod-devices wire shape), each listing that
    container's per-visible-device memory quota in MB in the region's
    device order (the order Allocate wired CUDA_DEVICE_MEMORY_LIMIT_i).
    The container segmentation matters: each container has its OWN
    shared region (`<uid>_<n>`), so the applier must index by
    container, never by a pod-wide flat offset. The generation is a
    per-pod monotonic counter; the monitor never applies a generation
    at or below the one it already recorded."""
    if gen < 1 or not limits_mb or not any(limits_mb) \
            or any(m < 0 for ctr in limits_mb for m in ctr):
        raise CodecError("hbm-limit intent needs gen >= 1 and >= 1 "
                         "non-negative MB value")
    return f"{gen}:" + ";".join(
        ",".join(str(int(m)) for m in ctr) for ctr in limits_mb)


def decode_hbm_limit(s: str) -> "tuple[int, List[List[int]]]":
    if not s or ":" not in s:
        raise CodecError(f"bad hbm-limit intent {s!r}")
    gen_s, body = s.split(":", 1)
    try:
        gen = int(gen_s)
        limits = [[int(x) for x in ctr.split(",") if x != ""]
                  for ctr in body.split(";")]
    except ValueError:
        raise CodecError(f"bad hbm-limit intent {s!r}") from None
    if gen < 1 or not any(limits) \
            or any(m < 0 for ctr in limits for m in ctr):
        raise CodecError(f"bad hbm-limit intent {s!r}")
    return gen, limits


# --------------------------------------------------------------------------
# Live-migration stamp (docs/migration.md; no reference analog)
# --------------------------------------------------------------------------

def encode_migrating_to(gen: int, node: str, devices: PodDevices) -> str:
    """The durable phase-A migration stamp (types.MIGRATING_TO_ANNO):
    "<generation>:<node>;<chips>" where <chips> is the destination
    assignment in the pod-devices wire form (so the reservation the
    stamp encodes is byte-identical to what the cutover commit will
    write into ASSIGNED_IDS). The generation is the owning group's
    fencing generation at stamp time; recover() replays only stamps,
    never re-plans, so a crashed planner's move completes on exactly
    the chips it reserved. Node names are k8s object names, so ":" and
    ";" cannot appear in them — decode splits each exactly once."""
    if gen < 1 or not node or not devices or not any(devices):
        raise CodecError("migrating-to stamp needs gen >= 1, a node "
                         "and >= 1 destination device")
    return f"{gen}:{node};{encode_pod_devices(devices)}"


def decode_migrating_to(s: str) -> "tuple[int, str, PodDevices]":
    """(gen, destination node, destination PodDevices). Inverse of
    encode_migrating_to: split ":" once (gen), then ";" once (node),
    so the pod-devices wire's own ";" container separators survive."""
    if not s or ":" not in s:
        raise CodecError(f"bad migrating-to stamp {s!r}")
    gen_s, rest = s.split(":", 1)
    if ";" not in rest:
        raise CodecError(f"bad migrating-to stamp {s!r}")
    node, chips = rest.split(";", 1)
    try:
        gen = int(gen_s)
        devices = decode_pod_devices(chips)
    except (ValueError, CodecError):
        raise CodecError(f"bad migrating-to stamp {s!r}") from None
    if gen < 1 or not node or not devices or not any(devices):
        raise CodecError(f"bad migrating-to stamp {s!r}")
    return gen, node, devices


def encode_migrated_from(gen: int, node: str) -> str:
    """The phase-B cutover record (types.MIGRATED_FROM_ANNO):
    "<generation>:<source-node>". Carries the source so the cleanup
    pass (and Allocate's VTPU_MIGRATED_FROM env replay) can name where
    the pod came from without consulting any in-memory state."""
    if gen < 1 or not node:
        raise CodecError("migrated-from record needs gen >= 1 and a node")
    return f"{gen}:{node}"


def decode_migrated_from(s: str) -> "tuple[int, str]":
    if not s or ":" not in s:
        raise CodecError(f"bad migrated-from record {s!r}")
    gen_s, node = s.split(":", 1)
    try:
        gen = int(gen_s)
    except ValueError:
        raise CodecError(f"bad migrated-from record {s!r}") from None
    if gen < 1 or not node:
        raise CodecError(f"bad migrated-from record {s!r}")
    return gen, node


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
