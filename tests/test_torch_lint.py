"""The port's static analysis (``python -m vtpu_torch.lint``) against the
JAX package's (hack/vtpulint.py and hack/vtpucheck).

1. Every fixture of tests/test_vtpulint.py and tests/test_vtpucheck.py is
   written once below as a template and rendered in each vocabulary (the
   JAX package's and the port's: ``vTPU``/``vGPU`` metric families,
   ``vtpu.util.env``/``vtpu_torch.util.env``, ``cmd/scheduler.py``/
   ``scheduler/__main__.py`` as the entry point, the JAX shim's PJRT
   metadata calls/the CUDA driver's, ``vtpu.*``/``vgpu.*`` node files,
   ``google.com/tpu``/``nvidia.com/gpu``). The JAX fixture goes through
   the JAX linter, the port's through the port's, and the two give equal
   (rule, line) findings, which are the fixture's expected ones. The
   fixtures whose findings point into the registry itself (an uncovered
   crash edge names its declaring line) compare what lands in the
   fixture's own files and count the rest against each registry.
2. The port's tree: it lints clean, every declared crash edge is tagged
   or waived, docs/gpu/protocols.md is its rendering, no waiver is stale,
   no module of vtpu_torch/ imports vtpu or jax, and each rule has a
   repo gate as the JAX tests do.
"""

from __future__ import annotations

import ast
import importlib.util
import os
import re
import shutil
import sys
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _p in (REPO, os.path.join(REPO, "hack")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

if "vtpulint" not in sys.modules:
    _spec = importlib.util.spec_from_file_location(
        "vtpulint", os.path.join(REPO, "hack", "vtpulint.py"))
    _mod = importlib.util.module_from_spec(_spec)
    sys.modules["vtpulint"] = _mod  # dataclasses resolve via sys.modules
    _spec.loader.exec_module(_mod)
vtpulint = sys.modules["vtpulint"]

from vtpu import contracts as jax_contracts  # noqa: E402
from vtpucheck import docsync as jax_docsync  # noqa: E402
from vtpucheck import killedges as jax_killedges  # noqa: E402
from vtpucheck import stale as jax_stale  # noqa: E402
from vtpucheck import wire as jax_wire  # noqa: E402

from vtpu_torch import contracts  # noqa: E402
from vtpu_torch.lint import __main__ as lint_main  # noqa: E402
from vtpu_torch.lint import docsync, killedges, rules, stale, wire  # noqa: E402

#: each vocabulary's words, substituted for ``<<KEY>>`` in a fixture
VOCAB: Dict[str, Dict[str, str]] = {
    "jax": {
        "M": "vTPU", "PKG": "vtpu", "ENVMOD": "vtpu.util.env",
        "NAMES": "vtpu.contracts", "QUAR": "vtpu.quarantine.json",
        "ENTRY_PKG": "cmd", "ENTRY": "scheduler.py",
        "META1": "device_bytes(buf, 0)", "META2": "buffer_device_index(buf)",
        "META3": "loaded_exec_code_bytes(exe, &d, &t)",
        "CFILE": "libvtpu.c", "RES": "google.com/tpu",
        "TESTFILE": "test_x.py", "REFNAME": "HostThing",
    },
    "port": {
        "M": "vGPU", "PKG": "vtpu_torch", "ENVMOD": "vtpu_torch.util.env",
        "NAMES": "vtpu_torch.api", "QUAR": "vgpu.quarantine.json",
        "ENTRY_PKG": "scheduler", "ENTRY": "__main__.py",
        "META1": "cuFuncGetAttribute(&v, a, f)",
        "META2": "cuPointerGetAttribute(&d, a, p)",
        "META3": "nvmlDeviceGetMemoryInfo(h, &m)",
        "CFILE": "libvgpu.c", "RES": "nvidia.com/gpu",
        "TESTFILE": "test_torch_x.py", "REFNAME": "HostThing",
    },
}


def sub(text: str, vocab: str) -> str:
    for k, v in VOCAB[vocab].items():
        text = text.replace(f"<<{k}>>", v)
    assert not re.search(r"<<[A-Z0-9_]+>>", text), text
    return text


@dataclass
class Case:
    """One fixture: ``files`` (relative path -> source, both templates)
    are written into a fresh root and ``kind`` says which check reads
    them. ``expect`` is the exact rule list, ``has`` rules that must be
    among the findings, ``msg`` text every finding's message holds."""

    name: str
    kind: str
    files: Dict[str, str] = field(default_factory=dict)
    target: str = ""
    expect: Optional[List[str]] = None
    has: Tuple[str, ...] = ()
    msg: str = ""
    arg: Tuple = ()


CASES: List[Case] = []


def case(name, kind="file", src=None, filename="mod.py", **kw):
    files = kw.pop("files", None) or {filename: src}
    CASES.append(Case(name, kind, files, **kw))


# ---------------------------------------------------------------------------
# tests/test_vtpulint.py's fixtures
# ---------------------------------------------------------------------------

# VTPU001
case("vtpu001_hot_module_hit", src=(
    "def calc(self):\n"
    "    return self.client.list_nodes()\n"), filename="score.py",
    expect=["VTPU001"])
case("vtpu001_decide_lock_hit", src=(
    "def f(self):\n"
    "    with self._decide_lock:\n"
    "        self.client.get_pod('ns', 'n')\n"), expect=["VTPU001"])
case("vtpu001_waived", src=(
    "def f(self):\n"
    "    with self._decide_lock:\n"
    "        # vtpulint: ignore[VTPU001] one-time startup priming, not the "
    "filter path\n"
    "        self.client.get_pod('ns', 'n')\n"), expect=[])
case("vtpu001_clean", src=(
    "def f(self):\n"
    "    self.client.get_pod('ns', 'n')\n"), expect=[])

# VTPU002
case("vtpu002_hit", src=(
    "def f(self):\n"
    "    self.pods.add_pod('ns', 'n', 'u', 'node', [])\n"),
    expect=["VTPU002"])
case("vtpu002_ok_under_lock_or_convention", src=(
    "def f(self):\n"
    "    with self._decide_lock:\n"
    "        self.pods.add_pod('ns', 'n', 'u', 'node', [])\n"
    "def g_locked(self):\n"
    "    self.overlay.apply_delta([], [])\n"), expect=[])
case("vtpu002_waived", src=(
    "def f(self):\n"
    "    # vtpulint: ignore[VTPU002, VTPU008] idempotent retraction, "
    "guarded by its own lock\n"
    "    self.slices.release_pod(('ns', 'g'), 'u')\n"), expect=[])

# VTPU003
case("vtpu003_hits", src=(
    "import os\n"
    "A = int(os.environ.get('X', '1'))\n"
    "B = os.getenv('Y')\n"
    "C = os.environ['Z']\n"), expect=["VTPU003"] * 3)
case("vtpu003_waived_and_clean", src=(
    "import os\n"
    "from <<ENVMOD>> import env_int\n"
    "A = env_int('X', 1)\n"
    "# vtpulint: ignore[VTPU003] passthrough env copy for a subprocess, "
    "not a knob parse\n"
    "B = os.environ.get('Y')\n"), expect=[])
case("vtpu003_env_py_is_exempt", src=(
    "import os\n"
    "def env_int(name, default):\n"
    "    return int(os.environ.get(name, default))\n"), filename="env.py",
    expect=[])

# VTPU004
case("vtpu004_hits", src=(
    "def loop():\n"
    "    while True:\n"
    "        try:\n"
    "            step()\n"
    "        except Exception:\n"
    "            pass\n"
    "def loop2():\n"
    "    for x in items:\n"
    "        try:\n"
    "            step(x)\n"
    "        except:\n"
    "            continue\n"), expect=["VTPU004", "VTPU004"])
case("vtpu004_logging_or_raise_is_fine", src=(
    "def f():\n"
    "    try:\n"
    "        step()\n"
    "    except Exception:\n"
    "        log.exception('step failed')\n"
    "    try:\n"
    "        step()\n"
    "    except Exception:\n"
    "        cleanup()\n"
    "        raise\n"
    "    try:\n"
    "        step()\n"
    "    except ValueError:\n"
    "        pass\n"), expect=[])
case("vtpu004_waived", src=(
    "def f():\n"
    "    try:\n"
    "        step()\n"
    "    except Exception:  # vtpulint: ignore[VTPU004] best-effort probe; "
    "outcome observed by the caller's timeout\n"
    "        pass\n"), expect=[])

# VTPU005
case("vtpu005_bad_name", src=(
    "from prometheus_client import Counter\n"
    "C = Counter('tpu_bad_name', 'desc')\n"), expect=["VTPU005"])
case("vtpu005_function_scope_registration", src=(
    "from prometheus_client import Gauge\n"
    "def collect():\n"
    "    return Gauge('<<M>>Thing', 'desc')\n"), expect=["VTPU005"])
case("vtpu005_family_in_function_ok", src=(
    "from prometheus_client.core import GaugeMetricFamily\n"
    "def collect():\n"
    "    return GaugeMetricFamily('<<M>>Thing', 'desc')\n"), expect=[])
case("vtpu005_duplicate_across_files", kind="tree", files={
    "a.py": ("from prometheus_client import Counter\n"
             "C = Counter('<<M>>Dup', 'd')\n"),
    "b.py": ("from prometheus_client import Gauge\n"
             "G = Gauge('<<M>>Dup', 'd')\n")},
    expect=["VTPU005", "VTPU005"], msg="exactly once")
case("vtpu005_waived", src=(
    "from prometheus_client.core import GaugeMetricFamily\n"
    "def collect():\n"
    "    # vtpulint: ignore[VTPU005] reference-inherited name\n"
    "    return GaugeMetricFamily('<<REFNAME>>', 'desc')\n"), expect=[])

# VTPU007
case("vtpu007_naked_span_ctor", src=(
    "def f(tracer):\n"
    "    s = Span(tracer, 'tid', 'stage', {})\n"), expect=["VTPU007"])
case("vtpu007_manual_start", src=(
    "def f(tracer):\n"
    "    tracer.span('tid', 'stage').start()\n"
    "def g(span):\n"
    "    span.start()\n"), expect=["VTPU007", "VTPU007"])
case("vtpu007_context_manager_and_threads_clean", src=(
    "def f(tracer, pod):\n"
    "    with tracer.span('tid', 'filter.decide') as sp:\n"
    "        sp.set('winner', 'n1')\n"
    "def g(self):\n"
    "    self._thread.start()\n"
    "    self._server.start()\n"
    "    t.start()\n"), expect=[])
case("vtpu007_trace_package_is_exempt", src=(
    "def span(self, tid, stage):\n"
    "    return Span(self, tid, stage, {})\n"), filename="trace/core.py",
    expect=[])
case("vtpu007_waived", src=(
    "def f(tracer):\n"
    "    # vtpulint: ignore[VTPU007] test fixture constructing a span "
    "directly\n"
    "    s = Span(tracer, 'tid', 'stage', {})\n"), expect=[])

# VTPU008
case("vtpu008_hit_outside_core", src=(
    "def sweep(self):\n"
    "    self.slices.reconcile(set())\n"), filename="daemon.py",
    has=("VTPU008",))
case("vtpu008_node_for_is_a_mutation", src=(
    "def pick(self, key, uid, n, cands):\n"
    "    return self.slices.node_for(key, uid, n, cands)\n"),
    filename="helper.py", has=("VTPU008",))
for _f in ("core.py", "slice.py"):
    case(f"vtpu008_scheduler_{_f[:-3]}_module_allowed", src=(
        "def f_locked(self):\n"
        "    self.slices.rebuild([])\n"), filename=f"scheduler/{_f}",
        expect=[])
case("vtpu008_core_py_outside_scheduler_pkg_still_flagged", src=(
    "def f_locked(self):\n"
    "    self.slices.rebuild([])\n"), filename="trace/core.py",
    has=("VTPU008",))
case("vtpu008_non_slices_receiver_clean", src=(
    "def f(self):\n"
    "    self.cache.reconcile(set())\n"
    "    store.rebuild([])\n"), filename="other.py", expect=[])
case("vtpu008_waived", src=(
    "def f(self):\n"
    "    # vtpulint: ignore[VTPU002, VTPU008] chaos-harness fault "
    "injection, not production code\n"
    "    self.slices.invalidate(('ns', 'g'))\n"), filename="harness.py",
    expect=[])

# VTPU009
case("vtpu009_naked_checkpoint_write", src=(
    "def save(checkpoint_path, data):\n"
    "    with open(checkpoint_path, 'w') as f:\n"
    "        f.write(data)\n"), expect=["VTPU009"])
case("vtpu009_quarantine_marker_and_mode_kw", src=(
    "import os\n"
    "def mark(d):\n"
    "    open(os.path.join(d, '<<QUAR>>'),\n"
    "         mode='wb').write(b'{}')\n"
    "    open('other.ckpt', 'a').write('x')\n"),
    expect=["VTPU009", "VTPU009"])
case("vtpu009_reads_and_unrelated_writes_clean", src=(
    "def load(checkpoint_path):\n"
    "    return open(checkpoint_path).read()\n"
    "def loadb(ckpt):\n"
    "    return open(ckpt, 'rb').read()\n"
    "def unrelated(log_path):\n"
    "    open(log_path, 'w').write('x')\n"), expect=[])
case("vtpu009_atomicio_is_exempt", src=(
    "def atomic_write_bytes(checkpoint_path, data):\n"
    "    open(checkpoint_path, 'wb').write(data)\n"), filename="atomicio.py",
    expect=[])
case("vtpu009_waived", src=(
    "def scribble(ckpt):\n"
    "    # vtpulint: ignore[VTPU009] test fixture deliberately tearing a "
    "checkpoint\n"
    "    open(ckpt, 'w').write('junk')\n"), expect=[])

# VTPU010
case("vtpu010_unguarded_shard_locked_call", src=(
    "def probe(self, sh, sig):\n"
    "    return sh.score_shard_locked(sig, [], {})\n"), expect=["VTPU010"])
case("vtpu010_ok_under_shard_lock_or_convention", src=(
    "def a(self, sh, sig):\n"
    "    with sh.lock:\n"
    "        return sh.score_shard_locked(sig, [], {})\n"
    "def b(self, route, sig):\n"
    "    with route.lockset:\n"
    "        return route.shards[0].coverage_shard_locked(sig)\n"
    "def c(self, router, sig):\n"
    "    with router.all_locks:\n"
    "        router.shards[0].boards.clear()\n"
    "def d_locked(self, sh, sig):\n"
    "    sh.boards[sig] = None\n"
    "    return sh.score_nodes_shard_locked([], sig, [], {})\n"
    "def e(self, sh, sig):\n"
    "    with self._decide_lock:\n"
    "        return sh.score_shard_locked(sig, [], {})\n"), expect=[])
case("vtpu010_unguarded_board_mutation", src=(
    "def evict(self, sh, sig):\n"
    "    sh.boards.pop(sig, None)\n"
    "def install(self, sh, sig, b):\n"
    "    sh.boards[sig] = b\n"), expect=["VTPU010", "VTPU010"])
case("vtpu010_unrelated_receivers_clean", src=(
    "def f(self, cache, sig):\n"
    "    cache.pop(sig, None)\n"
    "    return self._decide_locked(sig)\n"), expect=[])
case("vtpu010_waived", src=(
    "def peek(self, sh, sig):\n"
    "    # vtpulint: ignore[VTPU010] read-only diagnostics off the decide "
    "path\n"
    "    return sh.score_shard_locked(sig, [], {})\n"), expect=[])

# VTPU012
case("vtpu012_unguarded_batch_helper_call", src=(
    "def drain(self, q):\n"
    "    return self._pop_batch_locked(q)\n"), expect=["VTPU012"])
case("vtpu012_ok_under_owning_locks", src=(
    "def a(self, route, idxs):\n"
    "    with route.lockset:\n"
    "        self._decide_batch_locked(route, idxs)\n"
    "def b(self, q):\n"
    "    with self._cond:\n"
    "        return self._pop_batch_locked(q)\n"
    "def c(self, q):\n"
    "    with self._lock:\n"
    "        return self._pop_batch_locked(q)\n"
    "def d(self, sh, idxs):\n"
    "    with sh.lock:\n"
    "        self._decide_batch_locked(None, idxs)\n"
    "def e(self, idxs):\n"
    "    with self._decide_lock:\n"
    "        self._decide_batch_locked(None, idxs)\n"
    "def f_locked(self, q):\n"
    "    return self._pop_batch_locked(q)\n"), expect=[])
case("vtpu012_waived", src=(
    "def g(self, route, idxs):\n"
    "    # vtpulint: ignore[VTPU012] lockset held via bounded acquire "
    "above\n"
    "    self._decide_batch_locked(route, idxs)\n"), expect=[])
case("vtpu012_unrelated_suffixes_clean", src=(
    "def h(self):\n"
    "    with self._decide_lock:\n"
    "        return self._decide_locked(None)\n"), expect=[])

# VTPU013
case("vtpu013_limit_write_outside_monitor", src=(
    "def f(view):\n"
    "    view.set_hbm_limit(123)\n"
    "    view.set_limit_checked(123)\n"
    "    view.set_utilization_switch(0)\n"),
    expect=["VTPU013", "VTPU013", "VTPU013"])
case("vtpu013_monitor_package_is_exempt", src=(
    "def apply(self, view, target):\n"
    "    rc, applied = view.set_limit_checked(target)\n"
    "    view.set_utilization_switch(0)\n"
    "    return rc, applied\n"), filename="monitor/resize.py", expect=[])
case("vtpu013_region_module_is_exempt", src=(
    "def set_hbm_limit(self, value, dev=0):\n"
    "    _rc, applied = self.set_limit_checked(value, dev)\n"
    "    return applied\n"), filename="enforce/region.py", expect=[])
case("vtpu013_region_basename_elsewhere_is_not", src=(
    "def f(view):\n"
    "    view.set_limit_checked(1)\n"), filename="region.py",
    expect=["VTPU013"])
case("vtpu013_waived", src=(
    "def probe(v):\n"
    "    # vtpulint: ignore[VTPU013] OOM prober raises the live limit\n"
    "    v.set_hbm_limit(1 << 44)\n"), expect=[])

# VTPU006: the real header perturbed (old, new), against the real mirror
for _name, _old, _new, _msg in (
        ("field_width", "uint64_t oom_events;", "uint32_t oom_events;",
         "oom_events"),
        ("field_order", "int32_t recent_kernel;", "int32_t kernel_recent;",
         "name/order"),
        ("array_dim", "#define VTPU_MAX_DEVICES 16",
         "#define VTPU_MAX_DEVICES 32", "array shape drift"),
        ("version", "#define VTPU_SHARED_VERSION 8",
         "#define VTPU_SHARED_VERSION 9", "VTPU_SHARED_VERSION"),
        ("missing_field", "  uint64_t total_launches;\n", "",
         "total_launches"),
        ("checksum_field_width", "uint64_t header_checksum;",
         "uint32_t header_checksum;", "header_checksum"),
        ("checksum_field_dropped", "  int64_t header_heartbeat_ns;\n", "",
         "header_heartbeat_ns"),
        ("checksum_constant", "#define VTPU_HEADER_CSUM_PRIME 0x100000001b3",
         "#define VTPU_HEADER_CSUM_PRIME 0x100000001b5",
         "VTPU_HEADER_CSUM_PRIME"),
        ("prof_bucket_dim", "#define VTPU_PROF_BUCKETS 24",
         "#define VTPU_PROF_BUCKETS 16", "hist"),
        ("prof_callsite_index", "#define VTPU_PROF_CS_EXECUTE 4",
         "#define VTPU_PROF_CS_EXECUTE 5", "VTPU_PROF_CS_EXECUTE"),
        ("prof_field_width", "uint64_t total_ns;", "uint32_t total_ns;",
         "total_ns"),
        ("prof_missing_field",
         "  uint64_t prof_pressure[VTPU_PROF_PRESSURE_KINDS];\n", "",
         "prof_pressure"),
        ("prof_sample_default", "#define VTPU_PROF_SAMPLE_DEFAULT 64",
         "#define VTPU_PROF_SAMPLE_DEFAULT 32", "VTPU_PROF_SAMPLE_DEFAULT"),
        ("v8_host_field_dropped", "  uint64_t host_limit;\n", "",
         "host_limit"),
        ("v8_host_field_width", "uint64_t host_used;", "uint32_t host_used;",
         "host_used"),
        ("v8_min_compat", "#define VTPU_SHARED_VERSION_MIN_COMPAT 5",
         "#define VTPU_SHARED_VERSION_MIN_COMPAT 6",
         "VTPU_SHARED_VERSION_MIN_COMPAT"),
        ("v8_pressure_kind", "#define VTPU_PROF_PK_HOST_OVER_EVENTS 6",
         "#define VTPU_PROF_PK_HOST_OVER_EVENTS 7",
         "VTPU_PROF_PK_HOST_OVER_EVENTS")):
    CASES.append(Case(f"vtpu006_{_name}_drift_fires", "abi",
                      has=("VTPU006",), arg=(_old, _new, _msg)))
CASES.append(Case("vtpu006_real_tree_is_clean", "abi", expect=[],
                  arg=("", "", "")))

# VTPU006's bucket-source check
GOOD_C_BUCKET = """
int vtpu_prof_bucket_index(uint64_t ns) {
  uint64_t v = ns >> VTPU_PROF_BUCKET_MIN_SHIFT;
  if (!v) return 0;
  int b = 64 - __builtin_clzll(v);
  return b >= VTPU_PROF_BUCKETS ? VTPU_PROF_BUCKETS - 1 : b;
}
"""
GOOD_PY_BUCKET = """
VTPU_PROF_BUCKETS = 24
VTPU_PROF_BUCKET_MIN_SHIFT = 7


def prof_bucket_index(ns):
    v = ns >> VTPU_PROF_BUCKET_MIN_SHIFT
    if v <= 0:
        return 0
    return min(v.bit_length(), VTPU_PROF_BUCKETS - 1)


def prof_bucket_bounds():
    return [float(1 << (VTPU_PROF_BUCKET_MIN_SHIFT + b))
            for b in range(VTPU_PROF_BUCKETS - 1)] + [float("inf")]
"""
_BOUNDS_LINE = ("def prof_bucket_bounds():\n"
                "    return [float(1 << (VTPU_PROF_BUCKET_MIN_SHIFT + b))")
for _name, _c, _py, _exp in (
        ("clean_fixture_passes", GOOD_C_BUCKET, GOOD_PY_BUCKET, []),
        ("c_literal_fires",
         GOOD_C_BUCKET.replace("VTPU_PROF_BUCKET_MIN_SHIFT", "7"),
         GOOD_PY_BUCKET, ["VTPU006"]),
        ("py_literal_fires", GOOD_C_BUCKET, GOOD_PY_BUCKET.replace(
            _BOUNDS_LINE, "def prof_bucket_bounds():\n"
                          "    return [float(1 << (7 + b))"), ["VTPU006"]),
        ("missing_c_function_fires", "int other(void) { return 0; }",
         GOOD_PY_BUCKET, ["VTPU006"])):
    CASES.append(Case(f"bucket_sources_{_name}", "bucket",
                      {"shared_region.c": _c, "region.py": _py},
                      expect=_exp))

# VTPU011
HOTPATH_OK = """
static void slow_fill(void) {
  uint64_t sz = <<META1>>; /* outside markers: fine */
  int dev = <<META2>>;
}
static void gate(void) {
  /* vtpu: hot-path begin (pre-launch gate) */
  uint64_t ep = vtpu_region_usage_epoch(r);
  if (ep != cached) vtpu_region_used_fast(r, used);
  /* vtpu: hot-path end */
}
"""
_USED = "if (ep != cached) vtpu_region_used_fast(r, used);"
for _name, _src, _exp, _msg in (
        ("clean_fixture_passes", HOTPATH_OK, [], ""),
        ("mutex_lock_fires", HOTPATH_OK.replace(
            "uint64_t ep = vtpu_region_usage_epoch(r);",
            "pthread_mutex_lock(&mu);"), ["VTPU011"], "pthread_mutex_lock"),
        ("metadata_call_1_fires", HOTPATH_OK.replace(
            "vtpu_region_used_fast(r, used);", "<<META1>>;"),
         ["VTPU011"], ""),
        ("metadata_call_2_fires", HOTPATH_OK.replace(
            "vtpu_region_used_fast(r, used);", "<<META2>>;"),
         ["VTPU011"], ""),
        ("metadata_call_3_fires", HOTPATH_OK.replace(
            "vtpu_region_used_fast(r, used);", "<<META3>>;"),
         ["VTPU011"], ""),
        ("comment_and_string_do_not_fire", HOTPATH_OK.replace(
            _USED, "/* <<META1>> would be banned here */\n"
                   '  log("no pthread_mutex_lock call either");'), [], ""),
        ("waived_with_reason_passes", HOTPATH_OK.replace(
            _USED, "/* vtpulint: ignore[VTPU011] one-time init, not per "
                   "launch */\n  pthread_mutex_lock(&mu);"), [], ""),
        ("unexplained_waiver_is_a_finding", HOTPATH_OK.replace(
            _USED, "/* vtpulint: ignore[VTPU011] */\n"
                   "  pthread_mutex_lock(&mu);"), ["VTPU011"],
         "unexplained waiver"),
        ("unbalanced_end_fires", HOTPATH_OK.replace(
            "/* vtpu: hot-path end */", ""), ["VTPU011"], "never ended"),
        ("unbalanced_begin_fires", HOTPATH_OK.replace(
            "/* vtpu: hot-path begin (pre-launch gate) */", ""),
         ["VTPU011", "VTPU011"], "without a matching begin"),
        ("missing_markers_fire", "int main(void) { return 0; }",
         ["VTPU011"], "markers")):
    CASES.append(Case(f"vtpu011_{_name}", "hotpath", {"<<CFILE>>": _src},
                      expect=_exp, msg=_msg))

# waiver hygiene
case("unexplained_waiver_is_a_finding", src=(
    "import os\n"
    "# vtpulint: ignore[VTPU003]\n"
    "B = os.environ.get('Y')\n"), expect=["VTPU003"],
    msg="unexplained waiver")

# VTPU014
case("vtpu014_host_write_outside_sanctioned_paths", src=(
    "def f(region):\n"
    "    region.host_try_alloc(1024)\n"
    "    region.host_force_alloc(1024)\n"
    "    region.host_free(1024)\n"
    "    region.configure_host(1 << 30)\n"
    "    region.set_host_limit_checked(1 << 30)\n"),
    expect=["VTPU014"] * 5)
for _pkg, _f in (("enforce", "workload.py"), ("monitor", "hostguard.py")):
    case(f"vtpu014_{_pkg}_is_exempt", src=(
        "def charge(self, region, n):\n"
        "    return region.host_try_alloc(n)\n"), filename=f"{_pkg}/{_f}",
        expect=[])
case("vtpu014_waived", src=(
    "def f(region):\n"
    "    # vtpulint: ignore[VTPU014] chaos harness injects the overage\n"
    "    region.host_force_alloc(1 << 40)\n"), expect=[])
_OWNER_C = ("/* the owning TU: writes here are legal */\n"
            "void f(vtpu_shared_region_t *r) { r->host_used_agg = 0; }\n")
CASES.append(Case("vtpu014_c_direct_write_fires", "hostledger", {
    "shared_region.c": _OWNER_C, "libfake.c": (
        "void f(vtpu_shared_region_t *r) {\n"
        "  r->host_used_agg += 5;\n"
        "  r->host_limit = 0;\n"
        "  __atomic_store_n(&r->host_used_agg, 0, __ATOMIC_RELAXED);\n"
        "}\n")}, expect=["VTPU014"] * 3))
CASES.append(Case("vtpu014_c_calls_and_local_mirror_pass", "hostledger", {
    "shared_region.c": _OWNER_C, "libfake.c": (
        "void f(vtpu_shared_region_t *r) {\n"
        "  vtpu_host_try_alloc(r, 1, 4096);\n"
        "  /* r->host_used_agg = 1; a comment never fires */\n"
        "  uint64_t x = r->host_used_agg;  /* reads are fine */\n"
        "  G.host_limit = parse_bytes(s); /* process-LOCAL mirror */\n"
        "}\n")}, expect=[]))

# VTPU015
case("vtpu015_engine_call_outside_scheduler_hit", src=(
    "def sweep(self):\n"
    "    return self.preempt.plan_locked(None, [], {}, 0)\n"),
    filename="daemon.py", has=("VTPU015",))
case("vtpu015_driver_call_outside_scheduler_hit", src=(
    "def gc(self):\n"
    "    self._complete_eviction('ns', 'p', 'uid')\n"), filename="helper.py",
    has=("VTPU015",))
case("vtpu015_unrelated_plan_locked_receiver_clean", src=(
    "def f(self):\n"
    "    return self.router.plan_locked(None, [], {}, 0)\n"),
    filename="daemon.py", expect=[])
for _f in ("core.py", "preempt.py"):
    case(f"vtpu015_{_f[:-3]}_under_lock_convention_clean", src=(
        "def _decide_locked(self):\n"
        "    plan = self.preempt.plan_locked(None, [], {}, 0)\n"
        "    self._complete_eviction('ns', 'p', 'uid')\n"),
        filename=f"scheduler/{_f}", expect=[])
case("vtpu015_locked_member_needs_lock_even_in_core", src=(
    "def helper(self):\n"
    "    return self.preempt.victims_for_node_locked('n', [], {}, 0)\n"),
    filename="scheduler/core.py", expect=["VTPU015"])
case("vtpu015_waived", src=(
    "def f(self):\n"
    "    # vtpulint: ignore[VTPU015] chaos harness severs phase 2 to "
    "simulate the kill point\n"
    "    self._complete_eviction('ns', 'p', 'uid')\n"), filename="harness.py",
    expect=[])

# VTPU016
case("vtpu016_mutator_outside_autoscaler_hit", src=(
    "def handle(self, replica):\n"
    "    self.replicas.add_replica_locked(replica)\n"), filename="router.py",
    has=("VTPU016",))
case("vtpu016_remove_outside_gateway_pkg_hit", src=(
    "def gc(self):\n"
    "    self.replicas.remove_replica_locked('r0')\n"), filename="daemon.py",
    has=("VTPU016",))
case("vtpu016_autoscaler_under_lock_clean", src=(
    "def poll_once(self):\n"
    "    with self.replicas.lock:\n"
    "        self.replicas.add_replica_locked(None)\n"
    "        self.replicas.remove_replica_locked('r0')\n"),
    filename="gateway/autoscaler.py", expect=[])
case("vtpu016_autoscaler_without_lock_hit", src=(
    "def helper(self, replica):\n"
    "    self.replicas.add_replica_locked(replica)\n"),
    filename="gateway/autoscaler.py", expect=["VTPU016"])
case("vtpu016_waived", src=(
    "def f(self, replica):\n"
    "    # vtpulint: ignore[VTPU016] chaos harness injects a dead replica "
    "to exercise the drain path\n"
    "    self.replicas.add_replica_locked(replica)\n"), filename="harness.py",
    expect=[])

# VTPU017
case("vtpu017_admit_outside_ha_hit", src=(
    "def grab(self, g):\n"
    "    self.ha._admit_group(g, 7)\n"), filename="daemon.py",
    has=("VTPU017",))
case("vtpu017_coordinator_poll_path_clean", src=(
    "def poll_once(self):\n"
    "    for g in self.groups:\n"
    "        self._admit_group(g, 1)\n"
    "        self._owned = self._owned | {g}\n"
    "        self._holders[g] = self.identity\n"
    "        self._drop_group(g, 'expired')\n"), filename="ha/groups.py",
    expect=[])
case("vtpu017_takeover_outside_core_hit", src=(
    "def rebalance(self):\n"
    "    self.ha.take_over(1)\n"), filename="router.py", has=("VTPU017",))
case("vtpu017_core_takeover_before_locks_clean", src=(
    "def _ensure_gang_groups(self, groups):\n"
    "    take_over = getattr(self.ha, 'take_over', None)\n"
    "    for g in sorted(groups):\n"
    "        take_over(g)\n"), filename="scheduler/core.py", expect=[])
case("vtpu017_takeover_under_locks_hit_even_in_core", src=(
    "def _filter(self, g, shard):\n"
    "    with shard.lock:\n"
    "        self.ha.take_over(g)\n"), filename="scheduler/core.py",
    expect=["VTPU017"])
case("vtpu017_scoped_recover_outside_absorption_hit", src=(
    "def heal(self):\n"
    "    self.sched.recover(groups=frozenset({0}))\n"
    "    self.sched.recover()\n"), filename="daemon.py", expect=["VTPU017"])
case("vtpu017_entry_point_scoped_recover_clean", src=(
    "def on_acquire(g, gen):\n"
    "    sched.recover(groups=frozenset({g}))\n"),
    filename="<<ENTRY_PKG>>/<<ENTRY>>", expect=[])
case("vtpu017_ownership_store_outside_ha_hit", src=(
    "def hijack(self):\n"
    "    self.coord._owned = frozenset({0})\n"
    "    self.coord._holders[0] = 'me'\n"), filename="daemon.py",
    expect=["VTPU017", "VTPU017"])
case("vtpu017_waived", src=(
    "def f(self):\n"
    "    # vtpulint: ignore[VTPU017] chaos harness forces a handoff to "
    "exercise the fencing path\n"
    "    self.ha.take_over(0)\n"), filename="harness.py", expect=[])

# VTPU018
case("vtpu018_stamp_encoder_outside_scheduler_hit", src=(
    "def move(self, pod, node, devs):\n"
    "    stamp = codec.encode_migrating_to(1, node, devs)\n"
    "    frm = codec.encode_migrated_from(1, node)\n"),
    filename="controller.py", expect=["VTPU018", "VTPU018"])
case("vtpu018_bare_name_encoder_hit", src=(
    "def f(node, devs):\n"
    "    return encode_migrating_to(2, node, devs)\n"), filename="daemon.py",
    expect=["VTPU018"])
for _f in ("core.py", "migrate.py"):
    case(f"vtpu018_{_f[:-3]}_clean", src=(
        "def _plan(self, node, devs):\n"
        "    return codec.encode_migrating_to(1, node, devs)\n"),
        filename=f"scheduler/{_f}", expect=[])
case("vtpu018_codec_module_clean", src=(
    "def roundtrip(gen, node, devs):\n"
    "    return encode_migrating_to(gen, node, devs)\n"), filename="codec.py",
    expect=[])
case("vtpu018_drain_sidecar_write_outside_monitor_hit", src=(
    "def forge(d, gen):\n"
    "    atomic_write_json(os.path.join(d, DRAIN_REQUEST_FILE),\n"
    "                      {'gen': gen})\n"
    "    atomic_write_json(os.path.join(d, DRAIN_ACK_FILE),\n"
    "                      {'gen': gen, 'phase': 'snapshotted'})\n"),
    filename="daemon.py", expect=["VTPU018", "VTPU018"])
for _pkg, _f in (("monitor", "migrate.py"), ("enforce", "workload.py")):
    case(f"vtpu018_{_pkg}_writer_clean", src=(
        "def write(self, d, rec):\n"
        "    atomic_write_json(\n"
        "        os.path.join(d, DRAIN_REQUEST_FILE), rec)\n"),
        filename=f"{_pkg}/{_f}", expect=[])
case("vtpu018_unrelated_sidecar_write_clean", src=(
    "def save(d, rec):\n"
    "    atomic_write_json(os.path.join(d, 'progress.json'), rec)\n"),
    filename="daemon.py", expect=[])
case("vtpu018_waived", src=(
    "def f(d):\n"
    "    # vtpulint: ignore[VTPU018] chaos harness forges a stale ack to "
    "exercise the gen check\n"
    "    atomic_write_json(os.path.join(d, DRAIN_ACK_FILE), {})\n"),
    filename="harness.py", expect=[])

# ---------------------------------------------------------------------------
# tests/test_vtpucheck.py's fixtures
# ---------------------------------------------------------------------------

# VTPU019
case("vtpu019_naked_annotation_literal", "wire",
     'KEY = "vtpu.io/preempted-by"\n', filename="somepkg/mod.py",
     expect=["VTPU019"], msg="vtpu.io/preempted-by")
case("vtpu019_novel_key_under_the_domain_is_still_naked", "wire",
     'KEY = "vtpu.io/some-new-thing"\n', filename="somepkg/mod.py",
     expect=["VTPU019"])
case("vtpu019_naked_resource_literal", "wire",
     'RES = "<<RES>>"\n', filename="somepkg/mod.py", expect=["VTPU019"])
case("vtpu019_fstring_minting_from_domain", "wire", (
    'from <<NAMES>> import DOMAIN\n'
    'key = f"{DOMAIN}/minted-here"\n'), filename="somepkg/mod.py",
    expect=["VTPU019"])
case("vtpu019_unregistered_env_knob", "wire", (
    'from <<ENVMOD>> import env_int\n'
    'x = env_int("VTPU_NOT_A_REAL_KNOB", 1)\n'), filename="somepkg/mod.py",
    expect=["VTPU019"], msg="VTPU_NOT_A_REAL_KNOB")
case("vtpu019_registered_knob_and_constant_import_clean", "wire", (
    'from <<NAMES>> import PREEMPTED_BY_ANNO\n'
    'from <<ENVMOD>> import env_int\n'
    'x = env_int("VTPU_PREEMPT_MAX_NODES", 16)\n'
    'def read(annotations):\n'
    '    return annotations.get(PREEMPTED_BY_ANNO)\n'),
    filename="somepkg/mod.py", expect=[])
case("vtpu019_foreign_env_and_unanchored_hostnames_out_of_scope", "wire", (
    'from <<ENVMOD>> import env_str\n'
    'home = env_str("HOME", "")\n'
    'POOL = "cloud.google.com/gke-nodepool"\n'), filename="somepkg/mod.py",
    expect=[])
case("vtpu019_registry_module_is_exempt", "wire",
     'K = "vtpu.io/defined-here"\n', filename="<<PKG>>/contracts.py",
     expect=[])

# VTPU020 (PREEMPTED_BY_ANNO's writers: scheduler core/preempt/migrate in
# both registries)
_STAMP = ('from <<NAMES>> import PREEMPTED_BY_ANNO\n'
          'def stamp(annotations):\n'
          '    annotations[PREEMPTED_BY_ANNO] = "me"\n')
case("vtpu020_subscript_store_outside_writers", "wire", _STAMP,
     filename="rogue/mod.py", expect=["VTPU020"],
     msg="vtpu.io/preempted-by")
case("vtpu020_dict_literal_and_setdefault_are_write_shaped", "wire", (
    'from <<NAMES>> import PREEMPTED_BY_ANNO\n'
    'def patch(annotations):\n'
    '    body = {PREEMPTED_BY_ANNO: "me"}\n'
    '    annotations.setdefault(PREEMPTED_BY_ANNO, "me")\n'
    '    return body\n'), filename="rogue/mod.py",
    expect=["VTPU020", "VTPU020"])
case("vtpu020_declared_writer_site_clean", "wire", _STAMP,
     filename="scheduler/core.py", expect=[])
case("vtpu020_reads_are_free_anywhere", "wire", (
    'from <<NAMES>> import PREEMPTED_BY_ANNO\n'
    'def who(annotations):\n'
    '    if PREEMPTED_BY_ANNO in annotations:\n'
    '        return annotations[PREEMPTED_BY_ANNO]\n'),
    filename="rogue/mod.py", expect=[])
case("vtpu020_unconfined_annotation_writes_anywhere", "wire", (
    'from <<NAMES>> import TASK_PRIORITY_ANNO\n'
    'def f(annotations):\n'
    '    annotations[TASK_PRIORITY_ANNO] = "1"\n'), filename="rogue/mod.py",
    expect=[])

# VTPU021: the config doc with a row added, or a documented knob's row
# taken out
CASES.append(Case("vtpu021_doc_row_for_unregistered_knob", "config_doc",
                  expect=["VTPU021"], msg="VTPU_TOTALLY_FAKE", arg=("add",)))
CASES.append(Case("vtpu021_documented_knob_missing_its_row", "config_doc",
                  has=("VTPU021",), arg=("drop",)))
CASES.append(Case("vtpu021_repo_config_doc_in_lockstep", "config_doc",
                  expect=[], arg=("",)))

# VTPU022
for _step in ("missing", "written", "drifted"):
    CASES.append(Case(f"vtpu022_{_step}", "protocols_doc",
                      expect=[] if _step == "written" else ["VTPU022"],
                      msg="" if _step == "written" else _step,
                      arg=(_step,)))

# VTPU023
CASES.append(Case("vtpu023_uncovered_edge_and_typo", "killedges", {
    "tests/<<TESTFILE>>": (
        'from <<PKG>>.contracts import covers_edge\n'
        '@covers_edge("commit:kill-mid-gang")\n'
        'def test_real(): pass\n'
        '@covers_edge("bogus:no-such-edge")\n'
        'def test_typo(): pass\n')}, expect=["VTPU023"],
    msg="bogus:no-such-edge"))
CASES.append(Case("vtpu023_decorator_arg_must_be_literal", "killedges", {
    "tests/<<TESTFILE>>": (
        'from <<PKG>>.contracts import covers_edge\n'
        'EDGE = "commit:kill-mid-gang"\n'
        '@covers_edge(EDGE)\n'
        'def test_indirect(): pass\n')}, expect=["VTPU023"],
    msg="string literal"))

# VTPU024
case("vtpu024_stale_vs_live_waiver", "stale", (
    'import os\n'
    'x = os.environ.get("X")  # vtpulint: ignore[VTPU003] fixture: read '
    'outside env.py\n'
    'y = 1  # vtpulint: ignore[VTPU001] fixture: nothing here\n'),
    filename="<<PKG>>/mod.py", expect=["VTPU024"], msg="VTPU001")
case("vtpu024_sees_wire_findings_prewaiver", "stale", (
    'K = "vtpu.io/x"  # vtpulint: ignore[VTPU019] fixture: deliberate '
    'naked literal\n'), filename="<<PKG>>/mod.py", expect=[])


# ---------------------------------------------------------------------------
# running a fixture through either linter
# ---------------------------------------------------------------------------

JAX_HEADER = os.path.join(REPO, "lib", "vtpu", "shared_region.h")
JAX_MIRROR = os.path.join(REPO, "vtpu", "enforce", "region.py")
PORT_HEADER = os.path.join(REPO, rules.ABI_HEADER)
PORT_MIRROR = os.path.join(REPO, rules.ABI_MIRROR)


def _write(root: str, files: Dict[str, str], vocab: str) -> Dict[str, str]:
    out = {}
    for rel, src in files.items():
        path = os.path.join(root, sub(rel, vocab))
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write(sub(src, vocab))
        out[rel] = path
    return out


def _norm(findings) -> List[Tuple[str, int, str]]:
    """(rule, line, message) of Finding objects or (path, line, rule,
    message) / (line, rule, message) tuples."""
    out = []
    for f in findings:
        if hasattr(f, "rule"):
            out.append((f.rule, f.line, f.message))
        elif len(f) == 4:
            out.append((f[2], f[1], f[3]))
        else:
            out.append((f[1], f[0], f[2]))
    return out


def run_case(c: Case, vocab: str, root: str):
    """The fixture's findings through ``vocab``'s linter, as (rule, line,
    message)."""
    jax = vocab == "jax"
    os.makedirs(root, exist_ok=True)
    paths = _write(root, c.files, vocab)
    if c.kind == "file":
        target = paths[c.target or next(iter(c.files))]
        lint_file = vtpulint.lint_file if jax else rules.lint_file
        return _norm(lint_file(target)[0])
    if c.kind == "tree":
        run_lint = vtpulint.run_lint if jax else rules.run_lint
        return _norm(run_lint([root], None, None, abi=False))
    if c.kind == "abi":
        old, new, _ = c.arg
        header = JAX_HEADER if jax else PORT_HEADER
        mirror = JAX_MIRROR if jax else PORT_MIRROR
        if old:
            src = open(header).read()
            assert old in src, (header, old)
            header = os.path.join(root, "shared_region.h")
            with open(header, "w") as f:
                f.write(src.replace(old, new, 1))
        check = vtpulint.check_abi if jax else rules.check_abi
        return _norm(check(header, mirror))
    if c.kind == "bucket":
        check = (vtpulint.check_bucket_sources if jax
                 else rules.check_bucket_sources)
        return _norm(check(paths["shared_region.c"], paths["region.py"]))
    if c.kind == "hotpath":
        check = vtpulint.check_c_hotpath if jax else rules.check_c_hotpath
        return _norm(check(paths["<<CFILE>>"]))
    if c.kind == "hostledger":
        check = (vtpulint.check_c_host_ledger if jax
                 else rules.check_c_host_ledger)
        return _norm(check(root))
    if c.kind == "wire":
        (path,) = paths.values()
        scan = jax_wire.scan_file if jax else wire.scan_file
        return _norm(scan(path, ast.parse(open(path).read())))
    if c.kind == "config_doc":
        return _config_doc(c.arg[0], jax, root)
    if c.kind == "protocols_doc":
        return _protocols_doc(c.arg[0], jax, root)
    if c.kind == "killedges":
        mod = jax_killedges if jax else killedges
        if c.name.endswith("literal"):
            return _norm(mod.collect_covered_edges(root)[1])
        # the registry's uncovered edges, counted against its own
        # declarations; the findings in the fixture's test file compared
        registry = jax_contracts if jax else contracts
        waived = {f"{p.name}:{e.name}" for p in registry.PROTOCOLS
                  for e in p.edges if e.waiver}
        got = mod.check_kill_edges(root)
        uncovered = [f for f in got if "no registered" in f[3]]
        assert len(uncovered) == len(registry.ALL_EDGE_IDS
                                     - {"commit:kill-mid-gang"} - waived)
        tests = os.path.join(root, "tests") + os.sep
        return _norm(f for f in got if f[0].startswith(tests))
    if c.kind == "stale":
        check = jax_stale if jax else stale
        return _norm(check.check_stale_waivers(root))
    raise AssertionError(c.kind)


def _config_doc(step: str, jax: bool, root: str):
    mod = jax_docsync if jax else docsync
    rel = (os.path.join("docs", "config.md") if jax
           else os.path.join("docs", "gpu", "config.md"))
    path = os.path.join(root, rel)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    shutil.copy(os.path.join(REPO, rel), path)
    if step == "add":
        with open(path, "a") as f:
            f.write("\n| `VTPU_TOTALLY_FAKE` | 0 | made up |\n")
        # the docs differ in length: the row's line is their last
        last = len(open(path).read().splitlines())
        return [(r, 0 if ln == last else ln, m)
                for r, ln, m in _norm(mod.check_config_doc(root))]
    elif step == "drop":
        doc = mod.documented_knobs_in_config(path)
        victim = sorted(doc)[0]
        lines = open(path).read().splitlines(keepends=True)
        del lines[doc[victim] - 1]
        open(path, "w").write("".join(lines))
        got = mod.check_config_doc(root)
        assert any(victim in m for _p, _l, _r, m in got)
        return [(r, 0, "") for _p, _l, r, _m in got]
    return _norm(mod.check_config_doc(root))


def _protocols_doc(step: str, jax: bool, root: str):
    mod = jax_docsync if jax else docsync
    os.makedirs(os.path.dirname(os.path.join(root, mod.PROTOCOLS_MD)),
                exist_ok=True)
    if step == "missing":
        return _norm(mod.check_protocols_doc(root))
    mod.write_protocols_doc(root)
    if step == "drifted":
        path = os.path.join(root, mod.PROTOCOLS_MD)
        text = open(path).read()
        assert "Fenced protocols" in text
        open(path, "w").write(text.replace("Fenced protocols",
                                           "Fenced protocolz", 1))
    return [(r, 0, m) for r, _l, m in _norm(mod.check_protocols_doc(root))]


@pytest.mark.parametrize("c", CASES, ids=[c.name for c in CASES])
def test_fixture_gives_equal_findings(c, tmp_path):
    """The fixture in the JAX vocabulary through the JAX linter and in the
    port's through the port's: equal (rule, line) findings, the fixture's
    own."""
    jax = run_case(c, "jax", str(tmp_path / "jax"))
    port = run_case(c, "port", str(tmp_path / "port"))
    assert [(r, ln) for r, ln, _ in port] == [(r, ln) for r, ln, _ in jax], \
        (jax, port)
    got = [r for r, _, _ in port]
    if c.expect is not None:
        assert got == c.expect, port
    assert set(c.has) <= set(got), port
    want = c.msg or (c.arg[2] if c.kind == "abi" and c.arg[2] else "")
    if want:
        for side in (jax, port):
            assert any(want in m for _, _, m in side), side


def test_every_jax_fixture_has_a_case():
    """Each fixture of the two JAX test files is a case above: the cases
    outnumber the files' fixture tests less their repo gates."""
    def fixtures(path):
        tree = ast.parse(open(path).read())
        return [n.name for n in tree.body
                if isinstance(n, ast.FunctionDef)
                and n.name.startswith("test_") and n.args.args]
    jax = (fixtures(os.path.join(REPO, "tests", "test_vtpulint.py"))
           + fixtures(os.path.join(REPO, "tests", "test_vtpucheck.py")))
    assert len(jax) >= 100
    assert len(CASES) >= len(jax)


# ---------------------------------------------------------------------------
# the port's vocabulary beyond the JAX fixtures
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("src,expect", [
    ("from vtpu_torch import api\n"
     "from vtpu_torch.util.env import env_int\n"
     "x = env_int(api.ENV_PREEMPT_MAX_NODES, 16)\n", []),
    ("from vtpu_torch.api import ENV_SM_LIMIT\n"
     "from vtpu_torch.util.env import env_str\n"
     "x = env_str(ENV_SM_LIMIT)\n", []),
    ("from vtpu_torch.util.env import env_str\n"
     "x = env_str('CUDA_NOT_A_KNOB')\n", ["VTPU019"]),
    ("from vtpu_torch.api import NVIDIA_DOMAIN\n"
     "k = f'{NVIDIA_DOMAIN}/minted'\n", ["VTPU019"]),
    ("R = 'nvidia.com/gpumem'\n", ["VTPU019"]),
], ids=["knob-by-api-attribute", "knob-by-imported-constant",
        "unregistered-cuda-knob", "nvidia-domain-minting",
        "naked-nvidia-resource"])
def test_port_wire_vocabulary(tmp_path, src, expect):
    """Knobs named by their vtpu_torch.api constant resolve to the
    registry's names; the NVIDIA domain and resources are wire words."""
    path = tmp_path / "somepkg" / "mod.py"
    path.parent.mkdir()
    path.write_text(src)
    assert [r for _l, r, _m in wire.scan_file(str(path),
                                              ast.parse(src))] == expect


@pytest.mark.parametrize("name,expect", [
    ("vGPUFilterLatency", []), ("HostCoreUtilization", []),
    ("vGPU_device_memory_usage_in_bytes", []),
    ("vTPUFilterLatency", ["VTPU005"]), ("gpu_filter_latency", ["VTPU005"]),
])
def test_port_metric_vocabulary(tmp_path, name, expect):
    path = tmp_path / "mod.py"
    path.write_text("from prometheus_client import Counter\n"
                    f"C = Counter('{name}', 'd')\n")
    assert [f.rule for f in rules.lint_file(str(path))[0]] == expect


# ---------------------------------------------------------------------------
# the port's tree
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tree_findings():
    return lint_main.run()


def test_port_tree_lints_clean(tree_findings):
    """`python -m vtpu_torch.lint` on the tree: zero findings."""
    assert tree_findings == [], "\n".join(f.render(REPO)
                                          for f in tree_findings)
    assert lint_main.main([]) == 0


@pytest.mark.parametrize("rule", rules.ALL_RULES + rules.CONTRACT_RULES)
def test_repo_gate_per_rule(rule, tree_findings):
    """Each rule finds nothing on the tree (the JAX tests' repo gates, one
    per rule)."""
    assert [f for f in tree_findings if f.rule == rule] == []


def test_every_declared_edge_is_covered_or_waived():
    covered, malformed = killedges.collect_covered_edges(REPO)
    assert malformed == []
    waived = {f"{p.name}:{e.name}" for p in contracts.PROTOCOLS
              for e in p.edges if e.waiver}
    assert contracts.ALL_EDGE_IDS - set(covered) - waived == set()
    assert set(covered) <= contracts.ALL_EDGE_IDS
    assert waived.isdisjoint(covered)
    # the JAX registry's protocols, edge for edge
    assert contracts.ALL_EDGE_IDS == jax_contracts.ALL_EDGE_IDS
    assert killedges.check_kill_edges(REPO) == []


def test_protocols_doc_is_its_rendering():
    with open(os.path.join(REPO, docsync.PROTOCOLS_MD)) as f:
        assert f.read() == docsync.render_protocols_md()
    assert docsync.check_protocols_doc(REPO) == []


def test_no_live_waiver_is_stale():
    assert stale.check_stale_waivers(REPO) == []
    # ... and the tree has waivers for the check to read
    n = 0
    for path in rules.iter_py_files(rules.default_paths()):
        n += len(rules.Waivers.parse(open(path).read()).by_line)
    assert n >= 16


def test_hot_path_markers_are_in_libvgpu():
    src = open(os.path.join(REPO, rules.HOTPATH_C)).read()
    assert src.count("/* vtpu: hot-path begin") == 3
    assert src.count("/* vtpu: hot-path end */") == 3


def test_no_port_module_imports_vtpu_or_jax():
    """vtpu_torch/ imports nothing of the JAX package and no JAX."""
    bad = []
    for dirpath, dirnames, files in os.walk(os.path.join(REPO, "vtpu_torch")):
        dirnames[:] = [d for d in dirnames if d not in ("__pycache__",
                                                        "_build")]
        for fname in files:
            if not fname.endswith(".py"):
                continue
            path = os.path.join(dirpath, fname)
            for node in ast.walk(ast.parse(open(path).read())):
                names = []
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    names = [node.module or ""]
                for n in names:
                    if n.split(".")[0] in ("vtpu", "jax", "jaxlib", "flax"):
                        bad.append((path, n))
    assert bad == []


def test_command_line(tmp_path, capsys):
    assert lint_main.main(["--list-rules"]) == 0
    assert "VTPU011" in capsys.readouterr().out
    assert lint_main.main([str(tmp_path / "nowhere")]) == 2
    bad = tmp_path / "mod.py"
    bad.write_text("import os\nX = os.environ['Y']\n")
    assert lint_main.main([str(bad), "--no-docs", "--no-kill-edges",
                           "--no-stale"]) == 1
