"""Which of libvgpu.so's hooked entry points a driver answers with a
variant of another ABI.

The interposer hands out its hook for a base name asked of
``cuGetProcAddress`` only where the driver answered with the variant the
hook implements (its exact symbol; F17: CUDA 13.0's driver answers
``cuCtxSynchronize`` with ``cuCtxSynchronize_v2``, which takes a context).
This probe, run without the interposer, resolves every hooked variant of
``vtpu_torch/csrc/libvgpu.c`` (its ``HOOKS`` table and copy hooks) at each
runtime version asked for, with the per-thread-stream flag where the
variant has one, and lists those the driver answers with another symbol.

    python -m vtpu_torch.bench.abi                  # libcuda.so.1 here
    python -m vtpu_torch.bench.abi --versions 12080,13000

One JSON line: the driver's version, the variants resolved, and for each
version the ones answered otherwise (base name, the hook's symbol, what
the driver's answer is exported as, if anything). Exit 0.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import sys
from typing import Dict, List, Optional, Tuple

from .. import native

PTDS = 2  # CU_GET_PROC_ADDRESS_PER_THREAD_DEFAULT_STREAM


def hooked_variants() -> List[Tuple[str, int, int, str]]:
    """(base name, least version, per-thread-stream only, exact symbol) of
    every hook, read from libvgpu.c"""
    with open(os.path.join(native.CSRC, "libvgpu.c")) as f:
        src = f.read()
    src = re.sub(r"\\\n", " ", src)  # the copy table's continued lines
    rows = re.findall(r'\[H_\w+\] = \{"(\w+)",\s*(\d+),\s*(\d),\s*"(\w+)"',
                      src)
    rows += re.findall(r'X\(\w+,\s*"(\w+)",\s*(\d+),\s*(\d),\s*(\w+),', src)
    return sorted({(b, int(v), int(p), e) for b, v, p, e in rows})


def probe(versions: List[int]) -> Dict:
    ct = ctypes
    cu = ct.CDLL("libcuda.so.1")
    if hasattr(cu, "cuInit"):
        cu.cuInit(0)
    driver = ct.c_int(0)
    if hasattr(cu, "cuDriverGetVersion"):
        cu.cuDriverGetVersion(ct.byref(driver))
    gpa = ct.CFUNCTYPE(ct.c_int, ct.c_char_p, ct.POINTER(ct.c_void_p),
                       ct.c_int, ct.c_uint64, ct.POINTER(ct.c_int))(
        ct.cast(cu.cuGetProcAddress_v2, ct.c_void_p).value)

    def exported(name: str) -> Optional[int]:
        fn = getattr(cu, name, None)
        return ct.cast(fn, ct.c_void_p).value if fn is not None else None

    rows = hooked_variants()
    out = {"driver_version": driver.value, "variants": len(rows),
           "other_abi": {}}
    for version in versions:
        other = []
        for base, least, ptds, exact in rows:
            if version < least:
                continue
            p, st = ct.c_void_p(), ct.c_int(-1)
            if gpa(base.encode(), ct.byref(p), version, PTDS if ptds else 0,
                   ct.byref(st)) or not p.value:
                continue
            if p.value == exported(exact):
                continue
            # another variant of the table answers for this base name (a
            # later one comes first there): not another ABI
            if any(p.value == exported(e) for b, v, d, e in rows
                   if b == base and v <= version and d == ptds):
                continue
            names = [n for n in (f"{base}_v2", f"{base}_v3", f"{base}_v4",
                                 f"{exact}_v2") if p.value == exported(n)]
            other.append({"base": base, "hook": exact,
                          "driver": names[0] if names else None})
        out["other_abi"][str(version)] = other
    return out


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m vtpu_torch.bench.abi",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--versions", default="12080,13000",
                    help="runtime versions to ask at, comma-separated")
    args = ap.parse_args(argv)
    print(json.dumps(probe([int(v) for v in args.versions.split(",")])))
    return 0


if __name__ == "__main__":
    sys.exit(main())
