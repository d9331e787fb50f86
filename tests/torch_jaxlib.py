"""The JAX shim's test pieces (``lib/vtpu``'s libvtpucore.so, libvtpu.so,
mock_pjrt.so and shim_test), built once per test process into one
directory of its temp dir, never ``lib/vtpu/build/``, which the JAX
package's tests build.

Every port test module that loads the JAX package's libvtpucore.so loads
it from there. Each copy of the library a process loads from another path
takes static TLS, of which a process has little: a test worker that had
loaded the copies of the throttle, monitor and profile modules beside
``lib/vtpu/build/``'s refused the next with "cannot allocate memory in
static TLS block".
"""

from __future__ import annotations

import os
import subprocess

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TARGETS = ("libvtpucore.so", "libvtpu.so", "mock_pjrt.so", "shim_test")

_built = {}


def build(tmp_path_factory) -> str:
    """the directory the pieces are built in, built at the first call of
    this test process"""
    base = str(tmp_path_factory.getbasetemp())
    if base not in _built:
        out = os.path.join(base, "jax-lib")
        os.makedirs(out, exist_ok=True)
        subprocess.run(["make", "-s", "-C", os.path.join(REPO, "lib", "vtpu"),
                        f"BUILD={out}"] + [os.path.join(out, t)
                                           for t in TARGETS],
                       check=True, capture_output=True, timeout=300)
        _built[base] = out
    return _built[base]


def core(tmp_path_factory) -> str:
    """the JAX package's libvtpucore.so"""
    return os.path.join(build(tmp_path_factory), "libvtpucore.so")
