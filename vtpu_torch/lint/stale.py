"""VTPU024 — waivers must still suppress something.

A ``# vtpulint: ignore[VTPU0NN] <reason>`` comment is a reviewed,
explained exception. When the offending code is later fixed or
refactored away the waiver lingers — and a lingering waiver is a hole:
it will silently swallow the NEXT genuine finding that lands on that
line. This checker re-runs the per-file analyzers with waivers
DISABLED, then flags every waiver (per rule tag) that covers no raw
finding.

Scope: the Python lint scope (``vtpu_torch/`` but its bench/ and
northstar/) — the same files
whose waivers vtpulint honors. The raw finding set is the union of:

* rules.py's per-file AST findings (all bespoke + declarative rules);
* the repo-wide duplicate-metric pass over the UNFILTERED metric
  definitions (a VTPU005 waiver's whole job can be suppressing a
  cross-file duplicate, which the per-file view can't see);
* the wire findings (VTPU019/020), which share the waiver
  syntax.

A waiver covers findings on its own line and the line below (the
"line directly above" convention), so a waiver at line W is live iff
some raw finding with a matching rule sits at W or W+1.
"""

from __future__ import annotations

import ast
import os
from typing import Dict, List, Set, Tuple

from vtpu_torch.lint import rules, wire


def _raw_findings_by_file(
        paths: List[str]) -> Dict[str, List[Tuple[int, str]]]:
    """path -> [(line, rule)] with waivers DISABLED, plus each file's
    waiver table on the side (path -> Waivers)."""
    by_file: Dict[str, List[Tuple[int, str]]] = {}
    all_metrics: List[Tuple[str, int, str, bool]] = []
    for path in rules.iter_py_files(paths):
        with open(path, "r", encoding="utf-8") as f:
            source = f.read()
        try:
            tree = ast.parse(source, filename=path)
        except SyntaxError:
            continue  # vtpulint reports it; no waiver applies
        checker = rules._FileChecker(path, tree)
        checker.run()
        raw = [(f.line, f.rule) for f in checker.findings]
        raw.extend((line, rule)
                   for line, rule, _ in wire.scan_file(path, tree))
        by_file[path] = raw
        all_metrics.extend(checker.metrics)
    for f in rules.check_duplicate_metrics(all_metrics):
        by_file.setdefault(f.path, []).append((f.line, f.rule))
    return by_file


def check_stale_waivers(root: str) -> List[Tuple[str, int, str, str]]:
    """VTPU024 findings as (path, line, rule, message)."""
    paths = rules.default_paths(root)
    by_file = _raw_findings_by_file(paths)
    findings: List[Tuple[str, int, str, str]] = []
    for path in rules.iter_py_files(paths):
        with open(path, "r", encoding="utf-8") as f:
            source = f.read()
        waivers = rules.Waivers.parse(source)
        if not waivers.by_line:
            continue
        raw = by_file.get(path, [])
        hit_lines: Dict[str, Set[int]] = {}
        for line, rule in raw:
            hit_lines.setdefault(rule, set()).add(line)
        for wline, (tags, _reason) in sorted(waivers.by_line.items()):
            for rule in sorted(tags):
                lines = hit_lines.get(rule, set())
                if wline in lines or wline + 1 in lines:
                    continue
                findings.append((
                    path, wline, "VTPU024",
                    f"stale waiver: ignore[{rule}] here suppresses no "
                    "finding — the offending code moved or was fixed; "
                    "remove the waiver so it cannot swallow the next "
                    "genuine finding on this line"))
    return findings
