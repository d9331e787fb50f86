"""``python -m vtpu_torch.lint``: every rule of the port's static analysis.

Runs the per-file rules (VTPU001-018, with the VTPU006 ABI diff and the
VTPU011/VTPU014 C scans), then the registry rules (VTPU019-024), and
exits 1 on any finding, 2 on a usage error, 0 when the tree is clean.
``--write-docs`` regenerates docs/gpu/protocols.md first.
"""

from __future__ import annotations

import argparse
import ast
import os
import sys
from typing import List, Optional

from vtpu_torch.lint import docsync, killedges, rules, stale, wire
from vtpu_torch.lint.rules import Finding, Waivers, apply_waivers


def wire_findings(paths: List[str]) -> List[Finding]:
    out: List[Finding] = []
    for path in rules.iter_py_files(paths):
        with open(path, "r", encoding="utf-8") as f:
            source = f.read()
        try:
            tree = ast.parse(source, filename=path)
        except SyntaxError:
            continue  # the per-file rules report it
        raw = [Finding(path, line, rule, msg)
               for line, rule, msg in wire.scan_file(path, tree)]
        out.extend(apply_waivers(raw, Waivers.parse(source), path))
    return out


def apply_inline_waivers(findings: List[Finding]) -> List[Finding]:
    """Inline waivers for findings that land in Python files (a kill-edge
    typo in a test); doc findings pass through, since a generated file
    carries no reviewed comment."""
    by_path = {}
    for f in findings:
        by_path.setdefault(f.path, []).append(f)
    out: List[Finding] = []
    for path, group in sorted(by_path.items()):
        if not path.endswith(".py") or not os.path.isfile(path):
            out.extend(group)
            continue
        with open(path, "r", encoding="utf-8") as fh:
            waivers = Waivers.parse(fh.read())
        out.extend(apply_waivers(group, waivers, path))
    return out


def run(root: str = rules.REPO_ROOT, paths: Optional[List[str]] = None,
        abi: bool = True, hotpath: bool = True, docs: bool = True,
        kill_edges: bool = True, stale_waivers: bool = True
        ) -> List[Finding]:
    """Every finding of the port's lint over ``paths`` (default: the
    port's tree under ``root``), sorted."""
    paths = paths or rules.default_paths(root)
    findings = rules.run_lint(
        paths, os.path.join(root, rules.ABI_HEADER),
        os.path.join(root, rules.ABI_MIRROR), abi=abi,
        hotpath_c=os.path.join(root, rules.HOTPATH_C) if hotpath else None)
    findings.extend(wire_findings(paths))
    if docs:
        findings.extend(Finding(*t) for t in docsync.check_config_doc(root))
        findings.extend(Finding(*t)
                        for t in docsync.check_protocols_doc(root))
    if kill_edges:
        findings.extend(apply_inline_waivers(
            [Finding(*t) for t in killedges.check_kill_edges(root)]))
    if stale_waivers:
        findings.extend(Finding(*t) for t in stale.check_stale_waivers(root))
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m vtpu_torch.lint", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("paths", nargs="*",
                    help="files/dirs for the Python rules (default: "
                         "vtpu_torch/ but its bench/ and northstar/)")
    ap.add_argument("--root", default=rules.REPO_ROOT,
                    help="the checkout whose csrc/, docs/ and tests/ the "
                         "repo-wide rules read")
    ap.add_argument("--no-abi", action="store_true",
                    help="skip the VTPU006 header/mirror diff")
    ap.add_argument("--no-hotpath", action="store_true",
                    help="skip the VTPU011/VTPU014 C scans")
    ap.add_argument("--no-docs", action="store_true",
                    help="skip the VTPU021/022 doc checks")
    ap.add_argument("--no-kill-edges", action="store_true",
                    help="skip the VTPU023 crash-edge coverage check")
    ap.add_argument("--no-stale", action="store_true",
                    help="skip the VTPU024 stale-waiver check")
    ap.add_argument("--write-docs", action="store_true",
                    help="regenerate docs/gpu/protocols.md, then check")
    ap.add_argument("--list-rules", action="store_true")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rule in rules.ALL_RULES + rules.CONTRACT_RULES:
            print(f"{rule}  {rules.RULE_HELP[rule]}")
        return 0
    if args.write_docs:
        path = docsync.write_protocols_doc(args.root)
        print(f"vtpu_torch.lint: wrote {os.path.relpath(path)}")
    for p in args.paths:
        if not os.path.exists(p):
            print(f"vtpu_torch.lint: no such path: {p}", file=sys.stderr)
            return 2
    findings = run(args.root, args.paths or None, abi=not args.no_abi,
                   hotpath=not args.no_hotpath, docs=not args.no_docs,
                   kill_edges=not args.no_kill_edges,
                   stale_waivers=not args.no_stale)
    for f in findings:
        print(f.render(os.getcwd()))
    if findings:
        print(f"vtpu_torch.lint: {len(findings)} finding(s)",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
