"""VTPU019/VTPU020: the wire vocabulary stays in the registry
(hack/vtpucheck/wire.py in the port's terms).

VTPU019 (two halves):

* a string literal that looks like a wire key (it starts with a protocol
  domain, ``vtpu.io`` or ``tpu.google.com``, or a resource prefix,
  ``nvidia.com/`` or ``google.com/``, or reproduces a registered wire
  string) anywhere outside the registry (vtpu_torch/contracts.py and
  vtpu_torch/api/, the home of the port's names) is a finding, and so is
  a key built from the bare domain (``f"{DOMAIN}/..."``);
* an env read through vtpu_torch/util/env.py (``env_int``/``env_float``/
  ``env_str``/``env_bool``) whose name is not a registered
  :class:`~vtpu_torch.contracts.EnvKnob` is a finding. The port names its
  knobs by constant (``api.ENV_SM_LIMIT``), so a name or attribute whose
  trailing identifier is a string constant of vtpu_torch.api is read as
  that string.

VTPU020: write-shaped uses (a dict-literal key, a subscript store, the
first argument of ``setdefault``/``pop``) of a writer-confined annotation
constant outside its declared writer modules.

Waivers use the inline syntax (``# vtpulint: ignore[VTPU019] <why>``);
the stale check (VTPU024) sees these findings before waivers.
"""

from __future__ import annotations

import ast
import os
from typing import List, Optional, Tuple

from vtpu_torch import api
from vtpu_torch.contracts import (
    ANNOTATION_BY_CONST,
    ENV_KNOB_BY_NAME,
    WIRE_LITERALS,
)
from vtpu_torch.lint.engine import site_allowed, trailing_name

#: a literal starting with any of these is wire vocabulary (the resource
#: prefixes are anchored with the slash, so unrelated hostnames such as
#: cloud.google.com labels stay out of scope)
WIRE_PREFIXES = ("vtpu.io/", "tpu.google.com/", "nvidia.com/",
                 "google.com/")
#: bare-domain literals (f-string building blocks) count too
WIRE_DOMAINS = ("vtpu.io", "tpu.google.com", "nvidia.com")

#: the env.py parser surface: the only legal raw-environ reads (VTPU003),
#: so their first argument is the env-knob universe
ENV_READERS = ("env_int", "env_float", "env_str", "env_bool")

#: only these names are owned by the registry; a read of a foreign
#: variable (HOME, KUBECONFIG) is out of scope
ENV_OWNED_PREFIXES = ("VTPU_", "VGPU_", "CUDA_", "GPU_", "LIBCUDA_",
                      "NVIDIA_", "ACTIVE_OOM", "KUBERNETES_SERVICE",
                      "NODE_NAME", "POD_NAME", "TPU_", "LIBVTPU_")

#: the modules allowed to define wire strings: the registry and the home
#: of the port's names
REGISTRY_SITES = (("*", "contracts.py"), ("api", "__init__.py"))

#: methods whose first argument is a write-shaped use of a key
WRITE_SHAPED_METHODS = ("setdefault", "pop")

#: vtpu_torch.api's string constants, for reads that name a knob by its
#: constant
API_STRINGS = {k: v for k, v in vars(api).items()
               if k.isupper() and isinstance(v, str)}


def env_name_of(expr: ast.AST) -> Optional[str]:
    """The env name a reader's first argument names: a string literal,
    or a vtpu_torch.api string constant by its name (``ENV_X`` or
    ``api.ENV_X``); None for anything else."""
    if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
        return expr.value
    name = trailing_name(expr)
    return API_STRINGS.get(name) if name else None


def _is_wire_string(value: str) -> bool:
    if value in WIRE_LITERALS or value in WIRE_DOMAINS:
        return True
    return any(value.startswith(p) for p in WIRE_PREFIXES)


class _WireChecker(ast.NodeVisitor):
    """Per-file walker collecting raw (pre-waiver) VTPU019/020 findings.

    Findings are plain (lineno, rule, message) tuples so the caller can
    wrap them in rules.py's Finding/waiver machinery without this
    module importing rules.py (the import points the other way)."""

    def __init__(self, path: str):
        self.path = path
        self.basename = os.path.basename(path)
        self.parent_pkg = os.path.basename(
            os.path.dirname(os.path.abspath(path)))
        self.raw: List[Tuple[int, str, str]] = []

    def _flag(self, node: ast.AST, rule: str, msg: str) -> None:
        self.raw.append((getattr(node, "lineno", 1), rule, msg))

    # -- VTPU019: naked wire literals ---------------------------------

    def _in_registry(self) -> bool:
        return site_allowed(self.parent_pkg, self.basename, REGISTRY_SITES)

    def visit_Constant(self, node: ast.Constant) -> None:
        if self._in_registry():
            return
        if isinstance(node.value, str) and _is_wire_string(node.value):
            self._flag(node, "VTPU019",
                       f"naked wire-protocol literal {node.value!r}: "
                       "the annotation/resource vocabulary is defined "
                       "once in vtpu_torch/api/ and declared in "
                       "vtpu_torch/contracts.py (layer, writers, fencing) — import the "
                       "constant instead of restating the string")

    def visit_JoinedStr(self, node: ast.JoinedStr) -> None:
        # f"{DOMAIN}/..." — minting a key outside the registry
        if self._in_registry():
            return
        for part in node.values:
            if isinstance(part, ast.FormattedValue) \
                    and trailing_name(part.value) in ("DOMAIN",
                                                      "TPU_DOMAIN",
                                                      "NVIDIA_DOMAIN"):
                self._flag(node, "VTPU019",
                           "wire key constructed from the bare domain "
                           "outside the registry: new annotation "
                           "keys are minted ONLY in the registry, with "
                           "an AnnotationKey entry declaring layer/"
                           "writers/fencing")
                return
        # literal fragments of an f-string count like plain constants
        for part in node.values:
            if isinstance(part, ast.Constant) \
                    and isinstance(part.value, str) \
                    and _is_wire_string(part.value):
                self._flag(node, "VTPU019",
                           f"naked wire-protocol literal "
                           f"{part.value!r} inside an f-string: "
                           "import the registry constant from "
                           "vtpu_torch/api/")
                return

    # -- VTPU019: unregistered env knobs ------------------------------

    def visit_Call(self, node: ast.Call) -> None:
        func = node.func
        name = (func.attr if isinstance(func, ast.Attribute)
                else func.id if isinstance(func, ast.Name) else "")
        knob = (env_name_of(node.args[0])
                if name in ENV_READERS and node.args else None)
        if knob is not None:
            if knob.startswith(ENV_OWNED_PREFIXES) \
                    and knob not in ENV_KNOB_BY_NAME:
                self._flag(node, "VTPU019",
                           f"env read {name}({knob!r}) names no "
                           "registered knob: declare it as an EnvKnob "
                           "in vtpu_torch/contracts.py (component + doc; "
                           "documented=True adds it to the "
                           "docs/gpu/config.md contract)")
        if isinstance(func, ast.Attribute) \
                and func.attr in WRITE_SHAPED_METHODS and node.args:
            self._check_confined_write(node, node.args[0],
                                       f".{func.attr}(...)")
        self.generic_visit(node)

    # -- VTPU020: writer confinement ----------------------------------

    def _check_confined_write(self, node: ast.AST, key_expr: ast.AST,
                              shape: str) -> None:
        const = trailing_name(key_expr)
        anno = ANNOTATION_BY_CONST.get(const)
        if anno is None or not anno.writers:
            return
        if site_allowed(self.parent_pkg, self.basename, anno.writers):
            return
        allowed = ", ".join(
            f"{p}/{b}" for p, b in anno.writers)
        self._flag(node, "VTPU020",
                   f"write-shaped use of {const} ({shape}) outside its "
                   f"registry-declared writers ({allowed}): "
                   f"{anno.key} is fenced durable state "
                   f"({anno.fencing or 'writer-confined'}) — route the "
                   "mutation through the owning module or extend "
                   "writers= in vtpu_torch/contracts.py with review")

    def visit_Dict(self, node: ast.Dict) -> None:
        for key in node.keys:
            if key is not None:
                self._check_confined_write(key, key, "dict-literal key")
        self.generic_visit(node)

    def visit_Assign(self, node: ast.Assign) -> None:
        for tgt in node.targets:
            if isinstance(tgt, ast.Subscript):
                self._check_confined_write(tgt, tgt.slice,
                                           "subscript store")
        self.generic_visit(node)


def scan_file(path: str, tree: ast.Module) -> List[Tuple[int, str, str]]:
    """Raw (pre-waiver) findings for one parsed file, as
    (lineno, rule, message) tuples."""
    checker = _WireChecker(path)
    checker.visit(tree)
    return checker.raw
