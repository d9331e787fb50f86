"""VTPU023 — every declared protocol crash edge has a chaos test.

The fenced protocols in ``vtpu_torch/contracts.py`` declare their crash-edge
state machines (:class:`~vtpu_torch.contracts.CrashEdge`). Chaos tests
register the edges they exercise with the pass-through decorator::

    @covers_edge("migrate:kill-after-stamp")
    def test_sigkill_after_stamp_absorbs_and_replays_exactly_once(...):

This checker reads the decorators STATICALLY (no test import, no
collection) from the port's files in ``tests/``, then diffs both directions:

* a declared edge with neither a registered test nor a registry waiver
  (``CrashEdge.waiver``) is a finding — the protocol grew a crash
  boundary nobody kills;
* a decorator naming an edge no protocol declares is a finding — the
  test documents a state machine the registry doesn't know (either the
  registry is stale or the edge id is a typo, and a typo silently
  un-covers the real edge).
"""

from __future__ import annotations

import ast
import os
from typing import Dict, List, Tuple

from vtpu_torch.contracts import ALL_EDGE_IDS, PROTOCOLS

#: where the port's tests live, relative to the repo root, and the files
#: read there: the port's own (the JAX package's tests tag the JAX
#: registry's edges with vtpu.contracts.covers_edge)
TESTS_DIR = "tests"
TEST_FILE_PREFIXES = ("test_torch_", "torch_")
#: the registry module, for pointing uncovered-edge findings at the
#: declaring line
CONTRACTS_REL = os.path.join("vtpu_torch", "contracts.py")


def collect_covered_edges(
        root: str) -> Tuple[Dict[str, List[Tuple[str, int, str]]],
                            List[Tuple[str, int, str, str]]]:
    """Scan tests/ for @covers_edge decorators.

    Returns (edge id -> [(path, line, test name)], scan findings for
    malformed decorators)."""
    covered: Dict[str, List[Tuple[str, int, str]]] = {}
    findings: List[Tuple[str, int, str, str]] = []
    tests = os.path.join(root, TESTS_DIR)
    for dirpath, dirnames, filenames in os.walk(tests):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for fname in sorted(filenames):
            if not (fname.endswith(".py")
                    and fname.startswith(TEST_FILE_PREFIXES)):
                continue
            path = os.path.join(dirpath, fname)
            try:
                with open(path, "r", encoding="utf-8") as f:
                    tree = ast.parse(f.read(), filename=path)
            except (OSError, SyntaxError):
                continue  # vtpulint owns syntax findings
            for node in ast.walk(tree):
                if not isinstance(node, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                    continue
                for deco in node.decorator_list:
                    if not (isinstance(deco, ast.Call)
                            and _is_covers_edge(deco.func)):
                        continue
                    for arg in deco.args:
                        if isinstance(arg, ast.Constant) \
                                and isinstance(arg.value, str):
                            covered.setdefault(arg.value, []).append(
                                (path, deco.lineno, node.name))
                        else:
                            findings.append((
                                path, deco.lineno, "VTPU023",
                                "covers_edge argument must be a string "
                                "literal edge id — the checker reads "
                                "it statically"))
    return covered, findings


def _is_covers_edge(func: ast.AST) -> bool:
    if isinstance(func, ast.Name):
        return func.id == "covers_edge"
    if isinstance(func, ast.Attribute):
        return func.attr == "covers_edge"
    return False


def _edge_decl_lines(root: str) -> Dict[str, int]:
    """edge id -> line in vtpu_torch/contracts.py declaring its CrashEdge
    (best-effort textual scan, for clickable findings)."""
    out: Dict[str, int] = {}
    path = os.path.join(root, CONTRACTS_REL)
    try:
        with open(path, "r", encoding="utf-8") as f:
            lines = f.readlines()
    except OSError:
        return out
    for p in PROTOCOLS:
        for e in p.edges:
            needle = f'"{e.name}"'
            for i, text in enumerate(lines, start=1):
                if "CrashEdge(" in text and needle in text:
                    out.setdefault(f"{p.name}:{e.name}", i)
                    break
            else:
                for i, text in enumerate(lines, start=1):
                    if needle in text:
                        out.setdefault(f"{p.name}:{e.name}", i)
                        break
    return out


def check_kill_edges(root: str) -> List[Tuple[str, int, str, str]]:
    """VTPU023 findings as (path, line, rule, message)."""
    covered, findings = collect_covered_edges(root)
    decl_lines = _edge_decl_lines(root)
    contracts = os.path.join(root, CONTRACTS_REL)

    waived = {}
    for p in PROTOCOLS:
        for e in p.edges:
            if e.waiver:
                waived[f"{p.name}:{e.name}"] = e.waiver

    for edge_id in sorted(ALL_EDGE_IDS):
        if edge_id in covered:
            continue
        if edge_id in waived:
            continue
        findings.append((
            contracts, decl_lines.get(edge_id, 1), "VTPU023",
            f"declared crash edge {edge_id} has no registered chaos "
            "test: add @covers_edge(\"" + edge_id + "\") to the test "
            "that kills this boundary, or record a reviewed waiver on "
            "the CrashEdge entry"))
    for edge_id in sorted(covered):
        if edge_id in ALL_EDGE_IDS:
            continue
        for path, line, test in covered[edge_id]:
            findings.append((
                path, line, "VTPU023",
                f"@covers_edge({edge_id!r}) on {test} names no "
                "declared edge: fix the id (a typo silently un-covers "
                "the real edge) or declare the CrashEdge in "
                "vtpu_torch/contracts.py"))
    return findings
