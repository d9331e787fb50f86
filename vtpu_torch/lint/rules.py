"""The port's per-file rules, VTPU001-018: hack/vtpulint.py in the port's
vocabulary.

Each rule keeps its JAX counterpart's shape and reads the port's tree
(docs/gpu/static-analysis.md has the table in CUDA terms):

  VTPU001  no blocking KubeClient verb (vtpu_torch/util/client.py) in the
           filter hot-path modules or inside `with self._decide_lock:`.
  VTPU002  overlay/assignment mutators only under the decide lock or in a
           `*_locked` function (GuardRule, vtpu_torch/contracts.py).
  VTPU003  env knobs go through vtpu_torch/util/env.py, never a raw
           `os.environ.get` / `os.getenv` / `os.environ[...]` read.
  VTPU004  no blind `except Exception:` / bare `except:` handler.
  VTPU005  Prometheus metric names match `vGPU[A-Za-z]+` (or are one of
           the reference-inherited families the monitor exports), are
           unique across the tree, and registry-backed metrics are built
           once, at module scope.
  VTPU006  vtpu_torch/csrc/shared_region.h and its ctypes mirror
           vtpu_torch/enforce/region.py agree field for field and
           constant for constant, and both bucket functions derive their
           bounds from the shared VTPU_PROF_BUCKET_* constants.
  VTPU007  spans only through the tracer's context manager.
  VTPU008  SliceReservations mutated only on the decide path.
  VTPU009  durable node files written only through util/atomicio.py.
  VTPU010  shard-local decide state only under its shard's lock.
  VTPU011  the marked hot-path sections of vtpu_torch/csrc/libvgpu.c
           (between `/* vtpu: hot-path begin */` and `/* vtpu: hot-path
           end */`) take no lock and make no driver or NVML metadata call
           that the launch path memoizes.
  VTPU012  `*_batch_locked` helpers only under their owning lock.
  VTPU013  region limit/throttle writes only from vtpu_torch/monitor/.
  VTPU014  host-ledger writes only in vtpu_torch/{enforce,monitor}/ and,
           in C, only in shared_region.c.
  VTPU015  the victim search and the evict drivers only in scheduler
           core/preempt, under the shard-lock convention.
  VTPU016  replica-set membership only in gateway/autoscaler.py.
  VTPU017  shard-group ownership only in vtpu_torch/ha/, scoped recover
           only from scheduler core or vtpu_torch/scheduler/__main__.py.
  VTPU018  migration stamps minted and drain sidecars written only on the
           fenced paths and in vtpu_torch/{monitor,enforce}/.

The guarded-by/confined-to rules (VTPU002/008/010/012/013/014/015/016/017
and VTPU018's stamp half) are GuardRule/StoreRule data in
vtpu_torch/contracts.py, run by vtpu_torch/lint/engine.py inside this
module's per-file walk.

Waivers: `# vtpulint: ignore[VTPU0NN] <reason>` on the offending line or
the line above (`/* ... */` in C); a waiver without a reason is itself a
finding.
"""

from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from vtpu_torch.lint import engine as _engine

#: the repository root (the lint's paths are relative to it)
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

#: default lint scope: the port's counterpart of vtpu/ and cmd/ (the
#: daemons' entry points are its __main__ modules)
DEFAULT_PATHS = ("vtpu_torch",)
#: left out of the default scope: the ports of the root harnesses
#: (bench.py, northstar.py, benchmarks/) and of hack/ (this linter), which
#: hack/vtpulint.py never reads either
EXCLUDED_DIRS = (os.path.join("vtpu_torch", "bench"),
                 os.path.join("vtpu_torch", "northstar"),
                 os.path.join("vtpu_torch", "lint"))
#: the C sources VTPU006, VTPU011 and VTPU014's C half read
CSRC = os.path.join("vtpu_torch", "csrc")
ABI_HEADER = os.path.join(CSRC, "shared_region.h")
ABI_MIRROR = os.path.join("vtpu_torch", "enforce", "region.py")
HOTPATH_C = os.path.join(CSRC, "libvgpu.c")

#: the KubeClient verb surface (vtpu_torch/util/client.py): every one is a
#: blocking apiserver round trip
KUBE_VERBS = frozenset({
    "get_node", "list_nodes", "patch_node_annotations",
    "update_node_annotations_guarded", "get_pod",
    "list_pods_all_namespaces", "list_pods_on_node",
    "list_pods_with_version", "watch_pods", "patch_pod_annotations",
    "patch_pods_annotations_bulk", "bind_pod", "delete_pod", "get_lease",
    "create_lease", "update_lease_guarded",
})

#: modules reachable from filter()'s in-memory decision (matched by
#: basename): the overlay, the scorer, the mesh fitter and the NVIDIA
#: vendor's card fit (vtpu_torch/device/gpu.py)
HOT_PATH_BASENAMES = frozenset({"overlay.py", "score.py", "mesh.py",
                                "gpu.py"})

#: tokens naming a drain sidecar path (an AST dump search); the sidecars
#: are DurableFile entries in vtpu_torch/contracts.py
DRAIN_SIDECAR_TOKENS = ("drain_request_file", "drain_ack_file",
                        "vgpu.drain", "vtpu.drain")

#: prometheus_client constructors that register in the default REGISTRY
REGISTERED_METRIC_CTORS = frozenset({
    "Counter", "Gauge", "Histogram", "Summary", "Info", "Enum",
})
#: per-collect family constructors (not registered; name rules still apply)
FAMILY_METRIC_CTORS = frozenset({
    "GaugeMetricFamily", "CounterMetricFamily", "HistogramMetricFamily",
    "SummaryMetricFamily", "InfoMetricFamily",
})
METRIC_NAME_RE = re.compile(r"^vGPU[A-Za-z]+$")
#: the families the monitor exports under the reference's own names
#: (vtpu_torch/monitor/metrics.py: HAMi's node and container gauges);
#: dashboards built for the reference read them as they are
REFERENCE_METRIC_FAMILIES = frozenset({
    "HostGPUMemoryCapacity", "HostGPUMemoryUsage", "HostCoreUtilization",
    "vGPU_device_memory_usage_in_bytes",
    "vGPU_device_memory_limit_in_bytes",
    "vGPU_container_program_launches", "vGPU_container_oom_events",
    "vGPU_container_programs_inflight",
})

#: waiver marker in a Python (`# vtpulint: ignore[...] why`) or C
#: (`/* vtpulint: ignore[...] why */`, `// ...`) comment
WAIVER_RE = re.compile(
    r"(?:#|/\*|//)\s*vtpulint:\s*ignore\[([A-Z0-9, ]+)\]\s*(.*?)\s*"
    r"(?:\*/\s*)?$")

ALL_RULES = ("VTPU001", "VTPU002", "VTPU003", "VTPU004", "VTPU005",
             "VTPU006", "VTPU007", "VTPU008", "VTPU009", "VTPU010",
             "VTPU011", "VTPU012", "VTPU013", "VTPU014", "VTPU015",
             "VTPU016", "VTPU017", "VTPU018")

#: the registry-backed rules (wire.py, docsync.py, killedges.py,
#: stale.py); listed here so --list-rules shows every rule
CONTRACT_RULES = ("VTPU019", "VTPU020", "VTPU021", "VTPU022",
                  "VTPU023", "VTPU024")

RULE_HELP = {
    "VTPU001": "blocking KubeClient call on the filter hot path",
    "VTPU002": "overlay/assignment mutation outside the decide lock",
    "VTPU003": "raw os.environ access outside vtpu_torch/util/env.py",
    "VTPU004": "blind exception swallowing",
    "VTPU005": "Prometheus metric naming/registration",
    "VTPU006": "shared-region ABI drift (C header vs ctypes mirror)",
    "VTPU007": "span creation outside the tracer context manager",
    "VTPU008": "gang-state mutation outside the leader-gated decide path",
    "VTPU009": "naked write to a durable checkpoint/quarantine file",
    "VTPU010": "shard-local decide state touched outside its shard lock",
    "VTPU011": "lock/driver-metadata call inside a marked C hot-path section",
    "VTPU012": "batch decide/coalesce helper called outside its owning lock",
    "VTPU013": "region limit/throttle write outside the monitor apply path",
    "VTPU014": "host-ledger mutation outside libvgpu.so's charge path / "
               "checked region APIs",
    "VTPU015": "eviction/victim-set mutator outside the decide-locked "
               "preemption path",
    "VTPU016": "gateway replica-set mutation outside the autoscaler's "
               "locked, leader-gated path",
    "VTPU017": "shard-group ownership mutation outside vtpu_torch/ha/ or the "
               "owning group's lease-checked path",
    "VTPU018": "migration stamp minted / drain sidecar written outside "
               "the fenced scheduler paths and vtpu_torch/monitor/+enforce/",
    "VTPU019": "naked wire-protocol literal / unregistered env knob "
               "outside the vtpu_torch/contracts.py registry",
    "VTPU020": "annotation key written outside its registry-declared "
               "writer modules",
    "VTPU021": "docs/gpu/config.md env table drifted from the registry",
    "VTPU022": "docs/gpu/protocols.md drifted from the generated registry "
               "rendering",
    "VTPU023": "declared protocol crash edge with no registered chaos "
               "test (@covers_edge) and no registry waiver",
    "VTPU024": "stale waiver: the ignore[] comment no longer "
               "suppresses any finding",
}

#: lock-shaped `with` context attrs that satisfy the VTPU010 shard-lock
#: convention (a DecideShard's .lock, a Route's .lockset, the all-shards
#: .all_locks; self._decide_lock is tracked separately and also counts)
SHARD_LOCK_ATTRS = frozenset({"lock", "lockset", "all_locks"})
#: additional owning locks that satisfy VTPU012 for the committer's
#: coalesce helpers (`with self._lock:` / `with self._cond:` — the
#: Condition shares the queue lock)
QUEUE_LOCK_ATTRS = frozenset({"_lock", "_cond"})

#: durable-state tokens whose presence in an open()-for-write target
#: expression triggers VTPU009 (variable/attribute/constant names all
#: surface in the AST dump)
DURABLE_STATE_TOKENS = ("checkpoint", "ckpt", "quarantine", "resize")


@dataclass
class Finding:
    path: str
    line: int
    rule: str
    message: str

    def render(self, root: str) -> str:
        rel = os.path.relpath(self.path, root)
        return f"{rel}:{self.line}: {self.rule} {self.message}"


@dataclass
class Waivers:
    """Per-file waiver table: line -> (rules, reason)."""

    by_line: Dict[int, Tuple[Set[str], str]] = field(default_factory=dict)

    @classmethod
    def parse(cls, source: str) -> "Waivers":
        w = cls()
        for i, text in enumerate(source.splitlines(), start=1):
            m = WAIVER_RE.search(text)
            if m:
                rules = {r.strip() for r in m.group(1).split(",")
                         if r.strip()}
                w.by_line[i] = (rules, m.group(2))
        return w

    def covering(self, line: int, rule: str) -> Optional[Tuple[int, str]]:
        """(waiver line, reason) covering `rule` at `line` — same line
        or the line directly above."""
        for cand in (line, line - 1):
            hit = self.by_line.get(cand)
            if hit and rule in hit[0]:
                return cand, hit[1]
        return None


def apply_waivers(findings: List[Finding], waivers: Waivers,
                  path: str) -> List[Finding]:
    """Drop waived findings; turn reason-less waivers into findings."""
    out: List[Finding] = []
    for f in findings:
        hit = waivers.covering(f.line, f.rule)
        if hit is None:
            out.append(f)
            continue
        wline, reason = hit
        if not reason:
            out.append(Finding(
                path, wline, f.rule,
                "unexplained waiver: add a reason after the rule tag "
                "(# vtpulint: ignore[%s] <why this is safe>)" % f.rule))
    return out


# ---------------------------------------------------------------------------
# per-file AST checks (VTPU001-005)
# ---------------------------------------------------------------------------

def _attr_chain(node: ast.AST) -> List[str]:
    """x.y.z -> ["x", "y", "z"] ([] when the base isn't a Name)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        parts.reverse()
        return parts
    return []


def _is_decide_lock_item(item: ast.withitem) -> bool:
    """`with self._decide_lock:` (or any *._decide_lock)."""
    ctx = item.context_expr
    return isinstance(ctx, ast.Attribute) and ctx.attr == "_decide_lock"


def _is_shard_lock_item(item: ast.withitem) -> bool:
    """`with shard.lock:` / `with route.lockset:` / `with
    router.all_locks:` — the VTPU010 shard-lock surface."""
    ctx = item.context_expr
    return (isinstance(ctx, ast.Attribute)
            and ctx.attr in SHARD_LOCK_ATTRS)


def _is_queue_lock_item(item: ast.withitem) -> bool:
    """`with self._lock:` / `with self._cond:` — the committer-side
    owning locks VTPU012 additionally accepts for coalesce helpers."""
    ctx = item.context_expr
    return (isinstance(ctx, ast.Attribute)
            and ctx.attr in QUEUE_LOCK_ATTRS)


class _FileChecker(ast.NodeVisitor):
    def __init__(self, path: str, tree: ast.Module):
        self.path = path
        self.tree = tree
        self.basename = os.path.basename(path)
        # confinement sites are matched as (parent package dir,
        # basename) pairs — scheduler/core.py specifically, not any
        # file that happens to share the basename (vtpu_torch/trace/core.py
        # exists); the declarative rules consume parent_pkg via the
        # engine's ctx protocol
        parent = os.path.basename(os.path.dirname(os.path.abspath(path)))
        self.parent_pkg = parent
        # vtpu_torch/trace/ is the one place allowed to construct Span objects
        # (the tracer itself); everyone else goes through the context
        # manager (VTPU007)
        self.in_trace_pkg = parent == "trace"
        # VTPU018 sidecar exemptions: vtpu_torch/monitor/ (the coordinator's
        # crash-replayable intent record) and vtpu_torch/enforce/ (defines
        # the sidecar surface + the workload-side drain_ack API)
        self.in_monitor_pkg = parent == "monitor"
        self.in_enforce_pkg = parent == "enforce"
        self.findings: List[Finding] = []
        self.metrics: List[Tuple[str, int, str, bool]] = []
        # context stacks
        self._decide_depth = 0
        self._shard_lock_depth = 0
        self._queue_lock_depth = 0
        self._func_stack: List[str] = []

    def run(self) -> None:
        self.visit(self.tree)

    def _flag(self, node: ast.AST, rule: str, msg: str) -> None:
        self.findings.append(
            Finding(self.path, getattr(node, "lineno", 1), rule, msg))

    # the engine's ctx protocol (vtpu_torch/lint/engine.py): flag + the named
    # lock conventions a declarative rule's guarded_by can demand
    flag = _flag

    def under(self, guard: str) -> bool:
        if guard == "decide":
            return self._under_locked_convention()
        if guard == "shard":
            return self._under_shard_lock_convention()
        if guard == "batch":
            return self._under_batch_lock_convention()
        raise ValueError(f"unknown guard convention {guard!r}")

    # -- context tracking --------------------------------------------------

    def visit_With(self, node: ast.With) -> None:
        holds = any(_is_decide_lock_item(i) for i in node.items)
        shard = any(_is_shard_lock_item(i) for i in node.items)
        queue = any(_is_queue_lock_item(i) for i in node.items)
        if holds:
            self._decide_depth += 1
        if shard:
            self._shard_lock_depth += 1
        if queue:
            self._queue_lock_depth += 1
        self.generic_visit(node)
        if holds:
            self._decide_depth -= 1
        if shard:
            self._shard_lock_depth -= 1
        if queue:
            self._queue_lock_depth -= 1

    def _visit_func(self, node) -> None:
        self._func_stack.append(node.name)
        self.generic_visit(node)
        self._func_stack.pop()

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    def _under_locked_convention(self) -> bool:
        if self._decide_depth > 0:
            return True
        return any(name.endswith("_locked") for name in self._func_stack)

    def _under_shard_lock_convention(self) -> bool:
        """VTPU010: lexically under ANY shard-shaped lock (a single
        shard's .lock, an ordered Route .lockset, the all-shards set,
        or the classic _decide_lock — which IS the all-shards set), or
        in a function whose own name carries the `_locked` contract."""
        if self._shard_lock_depth > 0 or self._decide_depth > 0:
            return True
        return any(name.endswith("_locked") for name in self._func_stack)

    def _under_batch_lock_convention(self) -> bool:
        """VTPU012: the shard-lock surface PLUS the committer's own
        `_lock`/`_cond` — batch/coalesce helpers exist on both sides of
        the decide/commit split, each with its own owning lock."""
        return (self._under_shard_lock_convention()
                or self._queue_lock_depth > 0)

    def _at_module_scope(self) -> bool:
        return not self._func_stack

    # -- call-site rules ---------------------------------------------------

    def visit_Call(self, node: ast.Call) -> None:
        func = node.func
        if isinstance(func, ast.Attribute):
            self._check_kube_verb(node, func)
            self._check_environ(node, func)
        if isinstance(func, (ast.Name, ast.Attribute)):
            self._check_metric_ctor(node, func)
            self._check_span_site(node, func)
            self._check_durable_write(node, func)
            # VTPU018 sidecar half: the drain request/ack files are a
            # path-token scan, not a guarded-by rule — stays lexical
            self._check_drain_sidecar(node, func)
        # every guarded-by/confined-to rule (VTPU002/008/010/012/013/
        # 014/015/016/017/018-stamp) now runs declaratively: the
        # engine matches this call against the GuardRule entries in
        # vtpu_torch/contracts.py, with this checker as the lock/flag ctx
        _engine.check_call(self, node)
        self.generic_visit(node)

    def _check_durable_write(self, node: ast.Call, func) -> None:
        """VTPU009: durable node-plane state (allocation checkpoint,
        quarantine markers) is written only via vtpu_torch/util/atomicio.py —
        write-to-temp + fsync + rename. A naked open(path, 'w') on such
        a path tears the file under SIGKILL, which is the exact crash
        window the checkpoint exists to survive."""
        if self.basename == "atomicio.py":
            return  # the helper itself
        name = func.attr if isinstance(func, ast.Attribute) else func.id
        if name != "open" or not node.args:
            return
        mode = ""
        if len(node.args) >= 2 and isinstance(node.args[1], ast.Constant) \
                and isinstance(node.args[1].value, str):
            mode = node.args[1].value
        for kw in node.keywords:
            if kw.arg == "mode" and isinstance(kw.value, ast.Constant) \
                    and isinstance(kw.value.value, str):
                mode = kw.value.value
        if not any(c in mode for c in "wa+x"):
            return
        target = ast.dump(node.args[0]).lower()
        if any(tok in target for tok in DURABLE_STATE_TOKENS):
            self._flag(node, "VTPU009",
                       "naked open(..., %r) on a durable checkpoint/"
                       "quarantine path: write it through vtpu_torch/"
                       "util/atomicio.py (atomic_write_json/atomic_write_"
                       "bytes) so a SIGKILL mid-write can never tear "
                       "the file a restarted daemon recovers from"
                       % mode)

    def _check_span_site(self, node: ast.Call, func) -> None:
        """VTPU007: spans only exist inside `with tracer.span(...)` —
        naked Span() constructions or manual span .start() calls leak
        unfinished spans (never ring-buffered, never journaled, and the
        stage histogram silently loses the sample)."""
        if self.in_trace_pkg:
            return
        name = func.attr if isinstance(func, ast.Attribute) else func.id
        if name == "Span":
            self._flag(node, "VTPU007",
                       "naked Span(...) construction: create spans only "
                       "via `with tracer.span(...)` so every span is "
                       "finished and recorded exactly once")
            return
        if name != "start" or not isinstance(func, ast.Attribute):
            return
        recv = func.value
        spanish = False
        if isinstance(recv, ast.Call):
            f2 = recv.func
            n2 = (f2.attr if isinstance(f2, ast.Attribute)
                  else f2.id if isinstance(f2, ast.Name) else "")
            spanish = n2 in ("span", "Span")
        elif isinstance(recv, ast.Name):
            spanish = recv.id == "span" or recv.id.endswith("_span")
        elif isinstance(recv, ast.Attribute):
            spanish = recv.attr == "span" or recv.attr.endswith("_span")
        if spanish:
            self._flag(node, "VTPU007",
                       "manual span .start(): spans are context-manager "
                       "only (`with tracer.span(...)`) — a hand-started "
                       "span that never exits is never recorded")

    def _check_kube_verb(self, node: ast.Call,
                         func: ast.Attribute) -> None:
        if func.attr not in KUBE_VERBS:
            return
        if self.basename in HOT_PATH_BASENAMES:
            self._flag(node, "VTPU001",
                       f"blocking KubeClient call '{func.attr}' in "
                       f"hot-path module {self.basename}: filter() "
                       "scoring must stay pure in-memory compute")
        elif self._decide_depth > 0:
            self._flag(node, "VTPU001",
                       f"blocking KubeClient call '{func.attr}' inside "
                       "a `with self._decide_lock:` block: the decide "
                       "lock serializes every filter — apiserver I/O "
                       "here stalls the whole scheduling pipeline")

    def visit_Assign(self, node: ast.Assign) -> None:
        # the store-shaped declarative rules (VTPU010's scoreboard
        # stores, VTPU017's ownership-map stores) — StoreRule entries
        # in vtpu_torch/contracts.py
        _engine.check_store(self, node)
        self.generic_visit(node)

    def _check_drain_sidecar(self, node: ast.Call, func) -> None:
        """VTPU018 (sidecar half): the drain request/ack sidecars
        (`vtpu.drain.json` / `vtpu.drain.ack.json`) are written only
        by vtpu_torch/monitor/ (the coordinator's crash-replayable intent
        record) and vtpu_torch/enforce/ (defines the surface + the
        workload-side `drain_ack` API) — detected as any write-shaped
        call whose path expression names the sidecar constants/files.
        The stamp-encoder half of VTPU018 is a GuardRule registry
        entry now; this half is a path-token scan, so it stays
        lexical. Harness/test writes carry explicit waivers."""
        name = func.attr if isinstance(func, ast.Attribute) else func.id
        if name in ("atomic_write_json", "atomic_write_bytes") \
                and node.args:
            target = ast.dump(node.args[0]).lower()
            if any(tok in target for tok in DRAIN_SIDECAR_TOKENS) \
                    and not (self.in_monitor_pkg
                             or self.in_enforce_pkg):
                self._flag(node, "VTPU018",
                           "drain sidecar written outside "
                           "vtpu_torch/monitor/ and vtpu_torch/enforce/: the "
                           "request file is the coordinator's "
                           "crash-replayable intent record and the "
                           "ack is the workload's durable answer — "
                           "a writer anywhere else forges the "
                           "handshake (docs/migration.md)")

    def _check_environ(self, node: ast.Call,
                       func: ast.Attribute) -> None:
        if self.basename == "env.py":
            return
        chain = _attr_chain(func)
        if chain[-3:] == ["os", "environ", "get"] or \
                chain[-2:] == ["os", "getenv"]:
            self._flag(node, "VTPU003",
                       "raw environment read: use the shared parsers in "
                       "vtpu_torch/util/env.py (env_int/env_float/env_str/"
                       "env_bool) so malformed values degrade to "
                       "defaults instead of crashing at import")

    def visit_Subscript(self, node: ast.Subscript) -> None:
        # os.environ["X"] reads (writes are test-harness territory and
        # out of the default scope)
        if (isinstance(node.ctx, ast.Load)
                and self.basename != "env.py"
                and _attr_chain(node.value)[-2:] == ["os", "environ"]):
            self._flag(node, "VTPU003",
                       "raw os.environ[...] read: use the shared "
                       "parsers in vtpu_torch/util/env.py")
        self.generic_visit(node)

    # -- exception handling (VTPU004) --------------------------------------

    def visit_ExceptHandler(self, node: ast.ExceptHandler) -> None:
        broad = node.type is None or (
            isinstance(node.type, ast.Name)
            and node.type.id in ("Exception", "BaseException"))
        # a handler that neither calls anything (log/metric/cleanup)
        # nor re-raises swallows the failure invisibly
        if broad and not self._handler_acts(node):
            what = ("bare except:" if node.type is None
                    else f"except {node.type.id}:")
            self._flag(node, "VTPU004",
                       f"blind {what} handler (no call, no raise): "
                       "log it, count it, or narrow the exception type "
                       "— silent swallowing in watch/sweep/commit loops "
                       "freezes state with no operator signal")
        self.generic_visit(node)

    @staticmethod
    def _handler_acts(node: ast.ExceptHandler) -> bool:
        for stmt in node.body:
            for sub in ast.walk(stmt):
                if isinstance(sub, (ast.Call, ast.Raise)):
                    return True
        return False

    # -- metrics (VTPU005) -------------------------------------------------

    def _check_metric_ctor(self, node: ast.Call, func) -> None:
        name = func.attr if isinstance(func, ast.Attribute) else func.id
        registered = name in REGISTERED_METRIC_CTORS
        family = name in FAMILY_METRIC_CTORS
        if not (registered or family):
            return
        metric = None
        if node.args and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str):
            metric = node.args[0].value
        for kw in node.keywords:
            if kw.arg == "name" and isinstance(kw.value, ast.Constant) \
                    and isinstance(kw.value.value, str):
                metric = kw.value.value
        if metric is None:
            return  # not a metric definition (e.g. typing.Counter)
        if not (METRIC_NAME_RE.match(metric)
                or metric in REFERENCE_METRIC_FAMILIES):
            self._flag(node, "VTPU005",
                       f"metric name '{metric}' does not match "
                       "vGPU[A-Za-z]+ and is no reference-inherited "
                       "family (one grep family for every dashboard)")
        if registered and not self._at_module_scope():
            self._flag(node, "VTPU005",
                       f"registry-backed metric '{metric}' constructed "
                       "inside a function: prometheus_client registers "
                       "at construction, so a second call raises "
                       "'Duplicated timeseries' — define it once at "
                       "module scope")
        self.metrics.append((metric, node.lineno, self.path, registered))


def lint_file(path: str) -> Tuple[List[Finding],
                                  List[Tuple[str, int, str, bool]]]:
    """Lint one Python file; returns (unwaived findings, metric defs —
    metric defs still carry their own waiver filtering upstream)."""
    with open(path, "r", encoding="utf-8") as f:
        source = f.read()
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return ([Finding(path, e.lineno or 1, "VTPU000",
                         f"syntax error: {e.msg}")], [])
    checker = _FileChecker(path, tree)
    checker.run()
    waivers = Waivers.parse(source)
    findings = apply_waivers(checker.findings, waivers, path)
    # metric-name duplicate checks happen repo-wide; pre-filter the ones
    # individually waived so a waived name can't trip the cross-file pass
    metrics = [m for m in checker.metrics
               if waivers.covering(m[1], "VTPU005") is None]
    return findings, metrics


def check_duplicate_metrics(
        metrics: List[Tuple[str, int, str, bool]]) -> List[Finding]:
    by_name: Dict[str, List[Tuple[str, int, str, bool]]] = {}
    for m in metrics:
        by_name.setdefault(m[0], []).append(m)
    out: List[Finding] = []
    for name, defs in sorted(by_name.items()):
        if len(defs) < 2:
            continue
        sites = ", ".join(
            f"{os.path.relpath(p, REPO_ROOT)}:{ln}" for _, ln, p, _ in defs)
        for _, ln, p, _ in defs:
            out.append(Finding(
                p, ln, "VTPU005",
                f"metric name '{name}' defined {len(defs)} times "
                f"({sites}): each name must be registered exactly once"))
    return out


# ---------------------------------------------------------------------------
# VTPU006: shared-region ABI drift
# ---------------------------------------------------------------------------

C_INT_TYPES = {
    "int32_t": "i32", "uint32_t": "u32",
    "int64_t": "i64", "uint64_t": "u64",
    "char": "char",
}
CTYPES_TO_NORM = {
    "c_int32": "i32", "c_uint32": "u32",
    "c_int64": "i64", "c_uint64": "u64",
    "c_char": "char", "c_byte": "byte",
}
#: C types mirrored as opaque blobs (platform-dependent width; presence,
#: name and position are checked, the byte count is the runtime
#: sizeof() assert's job)
OPAQUE_C_TYPES = {"pthread_mutex_t"}

_DEFINE_RE = re.compile(
    r"^\s*#define\s+(VTPU_[A-Z0-9_]+)\s+\(?(0x[0-9a-fA-F]+|-?\d+)[uUlL)]*")
_FIELD_RE = re.compile(
    r"^\s*([A-Za-z_][A-Za-z0-9_]*)\s+([A-Za-z_][A-Za-z0-9_]*)"
    r"((?:\s*\[\s*[A-Za-z0-9_]+\s*\])*)\s*;")
_DIM_RE = re.compile(r"\[\s*([A-Za-z0-9_]+)\s*\]")


def _strip_c_comments(text: str) -> str:
    text = re.sub(r"/\*.*?\*/", " ", text, flags=re.S)
    return re.sub(r"//[^\n]*", "", text)


@dataclass
class CStruct:
    name: str
    fields: List[Tuple[str, str, List[int]]]  # (name, norm type, dims)


def parse_header(path: str) -> Tuple[Dict[str, int], Dict[str, CStruct]]:
    """#define constants + struct layouts from shared_region.h."""
    with open(path, "r", encoding="utf-8") as f:
        raw = f.read()
    consts: Dict[str, int] = {}
    for line in raw.splitlines():
        m = _DEFINE_RE.match(line)
        if m:
            consts[m.group(1)] = int(m.group(2), 0)
    text = _strip_c_comments(raw)

    def resolve_dim(tok: str) -> int:
        if tok.isdigit():
            return int(tok)
        if tok in consts:
            return consts[tok]
        raise ValueError(f"unresolvable array dim {tok!r} in {path}")

    structs: Dict[str, CStruct] = {}
    for m in re.finditer(
            r"typedef\s+struct\s+([A-Za-z_][A-Za-z0-9_]*)?\s*\{(.*?)\}"
            r"\s*([A-Za-z_][A-Za-z0-9_]*)\s*;", text, flags=re.S):
        body, tname = m.group(2), m.group(3)
        fields: List[Tuple[str, str, List[int]]] = []
        for line in body.split(";"):
            fm = _FIELD_RE.match(line + ";")
            if not fm:
                continue
            ctype, fname, dims_raw = fm.group(1), fm.group(2), fm.group(3)
            dims = [resolve_dim(d) for d in _DIM_RE.findall(dims_raw)]
            if ctype in C_INT_TYPES:
                norm = C_INT_TYPES[ctype]
            elif ctype in OPAQUE_C_TYPES:
                norm = "opaque"
            else:
                norm = f"struct:{ctype}"
            fields.append((fname, norm, dims))
        structs[tname] = CStruct(tname, fields)
    return consts, structs


@dataclass
class PyStruct:
    name: str
    fields: List[Tuple[str, str, List[int]]]


def parse_ctypes_mirror(path: str) -> Tuple[Dict[str, int],
                                            Dict[str, PyStruct]]:
    """Module constants + ctypes.Structure layouts from region.py."""
    with open(path, "r", encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    consts: Dict[str, int] = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and isinstance(node.value, ast.Constant) \
                and isinstance(node.value.value, int):
            consts[node.targets[0].id] = node.value.value

    def norm_type(expr: ast.AST) -> Tuple[str, List[int]]:
        """ctypes expr -> (normalized base, dims outer-first)."""
        if isinstance(expr, ast.BinOp) and isinstance(expr.op, ast.Mult):
            base, dims = norm_type(expr.left)
            right = expr.right
            if isinstance(right, ast.Constant):
                n = int(right.value)
            elif isinstance(right, ast.Name) and right.id in consts:
                n = consts[right.id]
            else:
                raise ValueError(
                    f"unresolvable array length "
                    f"{ast.dump(right)} in {path}")
            # ctypes (inner * n) wraps OUTERMOST-last: (c_char*64)*16 is
            # 16 elements of char[64] -> dims [16, 64]
            return base, [n] + dims
        name = None
        if isinstance(expr, ast.Attribute):
            name = expr.attr
        elif isinstance(expr, ast.Name):
            name = expr.id
        if name in CTYPES_TO_NORM:
            return CTYPES_TO_NORM[name], []
        if name:
            return f"struct:{name}", []
        raise ValueError(f"unrecognized ctypes type in {path}: "
                         f"{ast.dump(expr)}")

    structs: Dict[str, PyStruct] = {}
    for node in tree.body:
        if not isinstance(node, ast.ClassDef):
            continue
        for stmt in node.body:
            if not (isinstance(stmt, ast.Assign)
                    and len(stmt.targets) == 1
                    and isinstance(stmt.targets[0], ast.Name)
                    and stmt.targets[0].id == "_fields_"
                    and isinstance(stmt.value, (ast.List, ast.Tuple))):
                continue
            fields = []
            for elt in stmt.value.elts:
                if not (isinstance(elt, ast.Tuple)
                        and len(elt.elts) == 2
                        and isinstance(elt.elts[0], ast.Constant)):
                    raise ValueError(
                        f"unparseable _fields_ entry in {path}: "
                        f"{ast.dump(elt)}")
                fname = elt.elts[0].value
                base, dims = norm_type(elt.elts[1])
                fields.append((fname, base, dims))
            structs[node.name] = PyStruct(node.name, fields)
    return consts, structs


#: C typedef name -> ctypes.Structure class name
ABI_STRUCT_PAIRS = (
    ("vtpu_proc_slot_t", "ProcSlot"),
    ("vtpu_prof_callsite_t", "ProfCallsite"),
    ("vtpu_shared_region_t", "SharedRegionStruct"),
)
#: header constant -> mirror constant (magic included: a new magic is a
#: new ABI family and both sides must move together)
ABI_CONST_PAIRS = (
    ("VTPU_SHARED_MAGIC", "VTPU_SHARED_MAGIC"),
    ("VTPU_SHARED_VERSION", "VTPU_SHARED_VERSION"),
    # v8 rolling-upgrade floor: both sides must agree on which leftover
    # ABIs are a transient skip vs definitive corruption, or one side
    # quarantines what the other tolerates
    ("VTPU_SHARED_VERSION_MIN_COMPAT", "VTPU_SHARED_VERSION_MIN_COMPAT"),
    ("VTPU_MAX_DEVICES", "VTPU_MAX_DEVICES"),
    ("VTPU_MAX_PROCS", "VTPU_MAX_PROCS"),
    ("VTPU_UUID_LEN", "VTPU_UUID_LEN"),
    # v5 header-integrity plane: both sides must digest the same bytes
    # with the same FNV-1a parameters, or the monitor quarantines every
    # healthy region on the node
    ("VTPU_HEADER_CSUM_INIT", "VTPU_HEADER_CSUM_INIT"),
    ("VTPU_HEADER_CSUM_PRIME", "VTPU_HEADER_CSUM_PRIME"),
    # v6 profile plane: histogram geometry, callsite-class and
    # pressure-kind indices — a one-sided renumbering would silently
    # relabel every exported metric, a bucket-geometry drift would bin
    # C-written events under Python-rendered boundaries that lie
    ("VTPU_PROF_BUCKETS", "VTPU_PROF_BUCKETS"),
    ("VTPU_PROF_BUCKET_MIN_SHIFT", "VTPU_PROF_BUCKET_MIN_SHIFT"),
    ("VTPU_PROF_SAMPLE_DEFAULT", "VTPU_PROF_SAMPLE_DEFAULT"),
    ("VTPU_PROF_CS_BUF_ALLOC", "VTPU_PROF_CS_BUF_ALLOC"),
    ("VTPU_PROF_CS_BUF_FREE", "VTPU_PROF_CS_BUF_FREE"),
    ("VTPU_PROF_CS_CHARGE", "VTPU_PROF_CS_CHARGE"),
    ("VTPU_PROF_CS_UNCHARGE", "VTPU_PROF_CS_UNCHARGE"),
    ("VTPU_PROF_CS_EXECUTE", "VTPU_PROF_CS_EXECUTE"),
    ("VTPU_PROF_CS_TRANSFER", "VTPU_PROF_CS_TRANSFER"),
    ("VTPU_PROF_CS_DONE_WITH_BUFFER", "VTPU_PROF_CS_DONE_WITH_BUFFER"),
    ("VTPU_PROF_CS_QUOTA_CHECK", "VTPU_PROF_CS_QUOTA_CHECK"),
    ("VTPU_PROF_CALLSITES", "VTPU_PROF_CALLSITES"),
    ("VTPU_PROF_PK_CHARGE_RETRIES", "VTPU_PROF_PK_CHARGE_RETRIES"),
    ("VTPU_PROF_PK_CONTENTION_SPINS", "VTPU_PROF_PK_CONTENTION_SPINS"),
    ("VTPU_PROF_PK_AT_LIMIT_NS", "VTPU_PROF_PK_AT_LIMIT_NS"),
    ("VTPU_PROF_PK_NEAR_LIMIT_FAILURES",
     "VTPU_PROF_PK_NEAR_LIMIT_FAILURES"),
    ("VTPU_PROF_PK_TABLE_DROPS", "VTPU_PROF_PK_TABLE_DROPS"),
    # v8 host-memory pressure kinds
    ("VTPU_PROF_PK_HOST_NEAR_LIMIT_FAILURES",
     "VTPU_PROF_PK_HOST_NEAR_LIMIT_FAILURES"),
    ("VTPU_PROF_PK_HOST_OVER_EVENTS", "VTPU_PROF_PK_HOST_OVER_EVENTS"),
    ("VTPU_PROF_PRESSURE_KINDS", "VTPU_PROF_PRESSURE_KINDS"),
)

#: the v6 log2 bucket geometry constants BOTH binning implementations
#: must derive from (check_bucket_sources)
BUCKET_CONSTS = ("VTPU_PROF_BUCKET_MIN_SHIFT", "VTPU_PROF_BUCKETS")
#: mirror functions that render/bin buckets
BUCKET_PY_FUNCS = ("prof_bucket_index", "prof_bucket_bounds")
#: C function that bins
BUCKET_C_FUNC = "vtpu_prof_bucket_index"


def check_bucket_sources(source_c: str, mirror: str) -> List[Finding]:
    """VTPU006 companion: the C bucket-index function and the Python
    renderer's bucket functions must DERIVE their boundaries from the
    shared VTPU_PROF_BUCKET_* constants, not re-state them as literals
    (the constant-value diff above can't catch a hardcoded `7`)."""
    findings: List[Finding] = []
    try:
        with open(source_c, "r", encoding="utf-8") as f:
            c_src = _strip_c_comments(f.read())
    except OSError as e:
        return [Finding(source_c, 1, "VTPU006",
                        f"cannot read C source for the bucket check: {e}")]
    m = re.search(r"int\s+" + re.escape(BUCKET_C_FUNC)
                  + r"\s*\([^)]*\)\s*\{(.*?)\n\}", c_src, flags=re.S)
    if not m:
        findings.append(Finding(
            source_c, 1, "VTPU006",
            f"{BUCKET_C_FUNC}() not found (the Python renderer "
            "cross-checks against it)"))
    else:
        body = m.group(1)
        for const in BUCKET_CONSTS:
            if not re.search(rf"\b{const}\b", body):
                findings.append(Finding(
                    source_c, 1, "VTPU006",
                    f"{BUCKET_C_FUNC}() does not use {const}: bucket "
                    "boundaries must come from the shared header "
                    "constants, not literals"))
    try:
        with open(mirror, "r", encoding="utf-8") as f:
            tree = ast.parse(f.read(), filename=mirror)
    except (OSError, SyntaxError) as e:
        return findings + [Finding(mirror, 1, "VTPU006",
                                   f"cannot parse mirror: {e}")]
    # module-level functions only: a same-named convenience METHOD
    # (SharedRegion.prof_bucket_index delegates to the C library) is not
    # the renderer
    funcs = {node.name: node for node in tree.body
             if isinstance(node, ast.FunctionDef)}
    for fname in BUCKET_PY_FUNCS:
        node = funcs.get(fname)
        if node is None:
            findings.append(Finding(
                mirror, 1, "VTPU006",
                f"bucket function {fname}() missing from the mirror"))
            continue
        used = {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}
        for const in BUCKET_CONSTS:
            if const not in used:
                findings.append(Finding(
                    mirror, node.lineno, "VTPU006",
                    f"{fname}() does not use {const}: the renderer's "
                    "boundaries must come from the same constants the "
                    "C writer bins with"))
    return findings


def check_abi(header: str, mirror: str) -> List[Finding]:
    """VTPU006: diff shared_region.h against the ctypes mirror."""
    findings: List[Finding] = []
    try:
        c_consts, c_structs = parse_header(header)
    except (OSError, ValueError) as e:
        return [Finding(header, 1, "VTPU006", f"cannot parse header: {e}")]
    try:
        py_consts, py_structs = parse_ctypes_mirror(mirror)
    except (OSError, ValueError, SyntaxError) as e:
        return [Finding(mirror, 1, "VTPU006", f"cannot parse mirror: {e}")]

    for c_name, py_name in ABI_CONST_PAIRS:
        cv, pv = c_consts.get(c_name), py_consts.get(py_name)
        if cv is None or pv is None:
            findings.append(Finding(
                mirror, 1, "VTPU006",
                f"constant {c_name} missing from "
                f"{'header' if cv is None else 'mirror'}"))
        elif cv != pv:
            findings.append(Finding(
                mirror, 1, "VTPU006",
                f"constant {c_name} drifted: header={cv} mirror={pv}"))

    struct_map = dict(ABI_STRUCT_PAIRS)
    for c_name, py_name in ABI_STRUCT_PAIRS:
        cs, ps = c_structs.get(c_name), py_structs.get(py_name)
        if cs is None:
            findings.append(Finding(header, 1, "VTPU006",
                                    f"struct {c_name} not found in header"))
            continue
        if ps is None:
            findings.append(Finding(mirror, 1, "VTPU006",
                                    f"ctypes mirror {py_name} not found"))
            continue
        findings.extend(_diff_struct(cs, ps, struct_map, header, mirror))

    # v6 bucket-geometry source check: runs whenever the header's
    # sibling shared_region.c exists (perturbed-header fixtures in a
    # bare tmp dir skip it; the repo gate always has it)
    source_c = os.path.splitext(header)[0] + ".c"
    if os.path.isfile(source_c):
        findings.extend(check_bucket_sources(source_c, mirror))
    return findings


def _diff_struct(cs: CStruct, ps: PyStruct, struct_map: Dict[str, str],
                 header: str, mirror: str) -> List[Finding]:
    out: List[Finding] = []
    tag = f"{cs.name} vs {ps.name}"
    n = max(len(cs.fields), len(ps.fields))
    for i in range(n):
        cf = cs.fields[i] if i < len(cs.fields) else None
        pf = ps.fields[i] if i < len(ps.fields) else None
        if cf is None:
            out.append(Finding(mirror, 1, "VTPU006",
                               f"{tag}: mirror has extra trailing field "
                               f"'{pf[0]}' (#{i})"))
            continue
        if pf is None:
            out.append(Finding(mirror, 1, "VTPU006",
                               f"{tag}: mirror is missing field "
                               f"'{cf[0]}' (#{i})"))
            continue
        c_fname, c_type, c_dims = cf
        p_fname, p_type, p_dims = pf
        if c_fname != p_fname:
            out.append(Finding(
                mirror, 1, "VTPU006",
                f"{tag}: field #{i} name/order drift: header "
                f"'{c_fname}' vs mirror '{p_fname}'"))
            continue
        if c_type == "opaque":
            # width is platform-dependent (the runtime sizeof check owns
            # it); the mirror must model it as a byte blob of SOME size
            if not (p_type == "byte" and len(p_dims) == 1):
                out.append(Finding(
                    mirror, 1, "VTPU006",
                    f"{tag}: field '{c_fname}' is an opaque C type; "
                    f"mirror must be a c_byte array (got {p_type} "
                    f"{p_dims})"))
            continue
        want_type = c_type
        if c_type.startswith("struct:"):
            mapped = struct_map.get(c_type.split(":", 1)[1])
            want_type = f"struct:{mapped}" if mapped else c_type
        if want_type != p_type:
            out.append(Finding(
                mirror, 1, "VTPU006",
                f"{tag}: field '{c_fname}' width/type drift: header "
                f"{c_type}{c_dims or ''} vs mirror {p_type}"
                f"{p_dims or ''}"))
            continue
        if c_dims != p_dims:
            out.append(Finding(
                mirror, 1, "VTPU006",
                f"{tag}: field '{c_fname}' array shape drift: header "
                f"dims {c_dims} vs mirror dims {p_dims}"))
    return out


# ---------------------------------------------------------------------------
# VTPU011: marked C hot-path sections stay lock-free and metadata-free
# ---------------------------------------------------------------------------

HOTPATH_BEGIN_RE = re.compile(r"/\*\s*vtpu:\s*hot-path begin\b")
HOTPATH_END_RE = re.compile(r"/\*\s*vtpu:\s*hot-path end\b")
#: banned tokens between the markers (lexical: the section's own text, not
#: its callees'). The launch path memoizes each function's argument layout
#: (layout_read: cuFuncGetParamInfo / cuKernelGetParamInfo), its load
#: state and first-launch footprint (fp_first_*: cuFuncIsLoaded,
#: cuFuncLoad, cuFuncGetAttribute, cuFuncGetName), and reads a card's
#: UUID, memory pool and NVML state only at a context's creation and in
#: the heartbeat; none of those may appear per launch.
_METADATA_CALLS = (
    "cuFuncGetParamInfo", "cuKernelGetParamInfo", "cuFuncGetAttribute",
    "cuFuncGetName", "cuFuncIsLoaded", "cuFuncLoad", "cuDeviceGetUuid",
    "cuDeviceGetUuid_v2", "cuDeviceGetMemPool", "cuMemPoolGetAttribute",
    "cuDriverGetVersion", "cuPointerGetAttribute", "cuPointerGetAttributes",
    "cuMemGetInfo", "cuMemGetInfo_v2", "layout_read", "device_uuid",
    "device_pool", "pool_attr", "nvml_ready", "ctx_record_path")
HOTPATH_BANNED = (
    (re.compile(r"\bpthread_mutex_lock\s*\("),
     "pthread_mutex_lock(...): the marked sections are the lock-free "
     "launch gate and launch path; a lock here serializes every launch"),
    (re.compile(r"\b(?:%s)\s*\(" % "|".join(_METADATA_CALLS)),
     "driver metadata call per launch: the launch path memoizes it "
     "(argument layouts, load state, card identity); query it out of "
     "line"),
    (re.compile(r"\bnvml[A-Z]\w*\s*\("),
     "NVML call per launch: NVML is read at a context's creation and by "
     "the heartbeat, never on the launch path"),
)


def _strip_c_code_noise(lines: List[str]) -> List[str]:
    """Blank out comments and string literals line-by-line (tracking
    block comments across lines) so banned tokens inside either never
    count. Marker detection runs on the RAW lines before this."""
    out: List[str] = []
    in_comment = False
    for line in lines:
        buf: List[str] = []
        i = 0
        in_str: Optional[str] = None
        while i < len(line):
            ch = line[i]
            nxt = line[i:i + 2]
            if in_comment:
                if nxt == "*/":
                    in_comment = False
                    i += 2
                    continue
                i += 1
                continue
            if in_str:
                if ch == "\\":
                    i += 2
                    continue
                if ch == in_str:
                    in_str = None
                i += 1
                continue
            if nxt == "/*":
                in_comment = True
                i += 2
                continue
            if nxt == "//":
                break
            if ch in "\"'":
                in_str = ch
                i += 1
                continue
            buf.append(ch)
            i += 1
        out.append("".join(buf))
    return out


def check_c_hotpath(path: str) -> List[Finding]:
    """VTPU011: lexical scan of the marked hot-path sections."""
    try:
        with open(path, "r", encoding="utf-8") as f:
            source = f.read()
    except OSError as e:
        return [Finding(path, 1, "VTPU011",
                        f"cannot read C source: {e}")]
    lines = source.splitlines()
    stripped = _strip_c_code_noise(lines)
    findings: List[Finding] = []
    in_section = False
    begin_line = 0
    sections = 0
    for i, raw in enumerate(lines, start=1):
        if HOTPATH_BEGIN_RE.search(raw):
            if in_section:
                findings.append(Finding(
                    path, i, "VTPU011",
                    f"nested hot-path begin (previous at line "
                    f"{begin_line} never ended)"))
            in_section = True
            begin_line = i
            sections += 1
            continue
        if HOTPATH_END_RE.search(raw):
            if not in_section:
                findings.append(Finding(
                    path, i, "VTPU011",
                    "hot-path end without a matching begin"))
            in_section = False
            continue
        if not in_section:
            continue
        for banned_re, why in HOTPATH_BANNED:
            if banned_re.search(stripped[i - 1]):
                findings.append(Finding(path, i, "VTPU011", why))
    if in_section:
        findings.append(Finding(
            path, begin_line, "VTPU011",
            "hot-path begin never ended (unbalanced markers)"))
    if sections == 0:
        findings.append(Finding(
            path, 1, "VTPU011",
            "no `/* vtpu: hot-path begin */` markers found: the launch "
            "gate and launch path must stay marked so this rule keeps "
            "guarding them"))
    return apply_waivers(findings, Waivers.parse(source), path)


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

def _excluded(path: str) -> bool:
    rel = os.path.relpath(os.path.abspath(path), REPO_ROOT)
    return any(rel == d or rel.startswith(d + os.sep) for d in EXCLUDED_DIRS)


def iter_py_files(paths: List[str]) -> List[str]:
    """The .py files under ``paths``; a directory walk skips the excluded
    harness ports (a file named outright is read all the same)."""
    out: List[str] = []
    for p in paths:
        if os.path.isfile(p):
            out.append(p)
            continue
        for dirpath, dirnames, filenames in os.walk(p):
            dirnames[:] = [d for d in dirnames if d != "__pycache__"
                           and not _excluded(os.path.join(dirpath, d))]
            out.extend(os.path.join(dirpath, f)
                       for f in sorted(filenames) if f.endswith(".py"))
    return sorted(set(out))


def default_paths(root: str = REPO_ROOT) -> List[str]:
    return [os.path.join(root, p) for p in DEFAULT_PATHS]


#: v8 host-ledger region fields (VTPU014 C side): direct writes are
#: legal ONLY in shared_region.c (the vtpu_host_* primitives + the
#: checked setter own them); every other TU must call the primitives
HOST_LEDGER_FIELDS = ("host_used_agg", "host_used", "host_limit",
                      "host_oom_events")
# pointer-deref writes only: the shared region is always reached
# through a vtpu_shared_region_t* (r->, G.region->); a plain `.` store
# is a process-LOCAL struct copy (e.g. the shim's G.host_limit env
# mirror), which cannot corrupt the cross-process ledger
_HOST_FIELD_WRITE_RE = re.compile(
    r"->\s*(?:%s)\s*(?:=[^=]|\+=|-=|\+\+|--)"
    % "|".join(HOST_LEDGER_FIELDS))
_HOST_FIELD_ATOMIC_RE = re.compile(
    r"__atomic_(?:store_n|fetch_add|fetch_sub|exchange_n)\s*\(\s*&?[^,;]*"
    r"\b(?:%s)\b" % "|".join(HOST_LEDGER_FIELDS))


def check_c_host_ledger(lib_dir: str) -> List[Finding]:
    """VTPU014 (C side): in every .c of the C source dir but
    shared_region.c, a direct store or atomic RMW on a host-ledger field
    is a finding: libvgpu.so's charge path goes through the vtpu_host_*
    primitives, so every mutation lands inside the region's critical
    section with the aggregate kept."""
    findings: List[Finding] = []
    try:
        names = sorted(os.listdir(lib_dir))
    except OSError as e:
        return [Finding(lib_dir, 1, "VTPU014",
                        f"cannot scan lib dir: {e}")]
    for name in names:
        if not name.endswith(".c") or name == "shared_region.c":
            continue
        path = os.path.join(lib_dir, name)
        try:
            with open(path, "r", encoding="utf-8") as f:
                lines = f.read().splitlines()
        except OSError as e:
            findings.append(Finding(path, 1, "VTPU014",
                                    f"cannot read: {e}"))
            continue
        for lineno, line in enumerate(_strip_c_code_noise(lines),
                                      start=1):
            if _HOST_FIELD_WRITE_RE.search(line) \
                    or _HOST_FIELD_ATOMIC_RE.search(line):
                findings.append(Finding(
                    path, lineno, "VTPU014",
                    "direct write to a v8 host-ledger field outside "
                    "shared_region.c: route it through vtpu_host_* / "
                    "vtpu_region_set_host_limit_checked so the "
                    "mutation is locked, aggregated, and checksummed "
                    "(docs/gpu/static-analysis.md VTPU014)"))
    return findings


def run_lint(paths: List[str], header: Optional[str],
             mirror: Optional[str], abi: bool = True,
             hotpath_c: Optional[str] = None) -> List[Finding]:
    findings: List[Finding] = []
    all_metrics: List[Tuple[str, int, str, bool]] = []
    for path in iter_py_files(paths):
        file_findings, metrics = lint_file(path)
        findings.extend(file_findings)
        all_metrics.extend(metrics)
    findings.extend(check_duplicate_metrics(all_metrics))
    if abi and header and mirror:
        findings.extend(check_abi(header, mirror))
    if hotpath_c:
        findings.extend(check_c_hotpath(hotpath_c))
        # VTPU014 C side rides the same gate (and the same fixture
        # escape hatch: --no-hotpath skips both C scans)
        findings.extend(check_c_host_ledger(
            os.path.dirname(os.path.abspath(hotpath_c))))
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings
