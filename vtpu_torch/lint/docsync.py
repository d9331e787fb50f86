"""VTPU021/VTPU022 — the port's docs stay in lockstep with its registry
(hack/vtpucheck/docsync.py over docs/gpu/).

VTPU021: the env-knob tables in ``docs/gpu/config.md`` are field-diffed
against the registry's ``documented=True`` :class:`~vtpu_torch.contracts.
EnvKnob` subset, in BOTH directions — a table row naming an
unregistered knob and a documented knob with no table row are each a
finding. Same technique as VTPU006's shared_region.h/ctypes diff: the
doc is treated as one more mirror of the single source of truth.

VTPU022: ``docs/gpu/protocols.md`` is GENERATED from the registry
(annotations, env-knob summary, durable files, fenced protocols with
their crash-edge state machines). The checker re-renders and byte-diffs
the on-disk file; drift is a finding. ``python -m vtpu_torch.lint
--write-docs`` regenerates it.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Tuple

from vtpu_torch.contracts import (
    ANNOTATIONS,
    DURABLE_FILES,
    ENV_KNOBS,
    PROTOCOLS,
)

CONFIG_MD = os.path.join("docs", "gpu", "config.md")
PROTOCOLS_MD = os.path.join("docs", "gpu", "protocols.md")

#: a knob token in the FIRST cell of a config.md table row; the
#: ``[_i]`` suffix marks the per-device indexed family
_DOC_KNOB_RE = re.compile(r"`([A-Z][A-Z0-9_]*)(?:\[_i\])?`")


def documented_knobs_in_config(path: str) -> Dict[str, int]:
    """knob name -> first table-row line documenting it."""
    out: Dict[str, int] = {}
    with open(path, "r", encoding="utf-8") as f:
        for lineno, line in enumerate(f, start=1):
            line = line.strip()
            if not line.startswith("|"):
                continue
            cells = line.split("|")
            if len(cells) < 3:
                continue
            for name in _DOC_KNOB_RE.findall(cells[1]):
                out.setdefault(name, lineno)
    return out


def check_config_doc(root: str) -> List[Tuple[str, int, str, str]]:
    """VTPU021 findings as (path, line, rule, message)."""
    path = os.path.join(root, CONFIG_MD)
    try:
        doc = documented_knobs_in_config(path)
    except OSError as e:
        return [(path, 1, "VTPU021", f"cannot read config doc: {e}")]
    findings: List[Tuple[str, int, str, str]] = []
    registry = {k.name: k for k in ENV_KNOBS}
    documented = {k.name for k in ENV_KNOBS if k.documented}
    for name, lineno in sorted(doc.items()):
        if name not in registry:
            findings.append((
                path, lineno, "VTPU021",
                f"env table documents `{name}` but the registry has no "
                "such EnvKnob: declare it in vtpu_torch/contracts.py or drop "
                "the row — the table is a rendered view of the "
                "registry, not a second source of truth"))
        elif name not in documented:
            findings.append((
                path, lineno, "VTPU021",
                f"env table documents `{name}` but the registry marks "
                "it documented=False: flip the flag in "
                "vtpu_torch/contracts.py so both sides agree on the "
                "operator-facing surface"))
    for name in sorted(documented - set(doc)):
        findings.append((
            path, 1, "VTPU021",
            f"registry knob {name} (component "
            f"{registry[name].component}: {registry[name].doc}) is "
            "documented=True but has no docs/gpu/config.md table row — add "
            "the row or mark it documented=False"))
    return findings


# ---------------------------------------------------------------------------
# docs/gpu/protocols.md generation (VTPU022)
# ---------------------------------------------------------------------------

_HEADER = """\
<!-- GENERATED from vtpu_torch/contracts.py; do not edit by hand.
     Regenerate: python -m vtpu_torch.lint --write-docs
     Drift from the registry fails lint (VTPU022). -->

# Wire-protocol contracts of the GPU port

Four cooperating programs (the scheduler and its webhook, the device
plugin, the node monitor, and libvgpu.so in each container) share no
memory and no RPC surface. This file is the rendered view of
`vtpu_torch/contracts.py`: every annotation key, env knob, durable node
file and fenced multi-process protocol, with owning layer, allowed
writers and fencing. `python -m vtpu_torch.lint` holds the tree to the
declarations (docs/gpu/static-analysis.md).
"""


def render_protocols_md() -> str:
    out: List[str] = [_HEADER]

    out.append("\n## Annotation keys\n")
    out.append("| key | layer | fencing | writers | purpose |")
    out.append("|---|---|---|---|---|")
    for a in ANNOTATIONS:
        writers = ("any importer" if not a.writers
                   else ", ".join(f"`{p}/{b}`" for p, b in a.writers))
        out.append(f"| `{a.key}` | {a.layer} | {a.fencing or '—'} "
                   f"| {writers} | {a.doc} |")

    out.append("\n## Durable node files\n")
    out.append("| file | layer | fencing | purpose |")
    out.append("|---|---|---|---|")
    for f in DURABLE_FILES:
        out.append(f"| `{f.name}` | {f.layer} | {f.fencing} "
                   f"| {f.doc} |")

    out.append("\n## Env knobs\n")
    out.append("The full per-knob reference lives in docs/gpu/config.md "
               "(diffed against the registry by VTPU021); this is the "
               "component census.\n")
    by_comp: Dict[str, List[str]] = {}
    for k in ENV_KNOBS:
        by_comp.setdefault(k.component, []).append(k.name)
    out.append("| component | knobs |")
    out.append("|---|---|")
    for comp in sorted(by_comp):
        names = ", ".join(f"`{n}`" for n in sorted(by_comp[comp]))
        out.append(f"| {comp} | {names} |")

    out.append("\n## Fenced protocols and their crash edges\n")
    out.append("Every edge below must be exercised by a chaos test "
               "registered with `@covers_edge(\"<protocol>:<edge>\")` "
               "or carry a registry waiver — an uncovered edge fails "
               "lint (VTPU023).\n")
    for p in PROTOCOLS:
        out.append(f"### `{p.name}` — {p.title}\n")
        out.append(f"*Layers:* {', '.join(p.layers)}  ")
        out.append(f"*Fencing:* {p.fencing}  ")
        out.append(f"*Happy path:* {' → '.join(p.states)}  ")
        out.append(f"*Design doc:* {p.doc}\n")
        out.append("| edge | crash point | recovery obligation |")
        out.append("|---|---|---|")
        for e in p.edges:
            expect = e.expect
            if e.waiver:
                expect += f" *(uncovered by waiver: {e.waiver})*"
            out.append(f"| `{p.name}:{e.name}` | {e.at} | {expect} |")
        out.append("")
    return "\n".join(out).rstrip() + "\n"


def check_protocols_doc(root: str) -> List[Tuple[str, int, str, str]]:
    """VTPU022: byte-diff docs/gpu/protocols.md against the rendering."""
    path = os.path.join(root, PROTOCOLS_MD)
    want = render_protocols_md()
    try:
        with open(path, "r", encoding="utf-8") as f:
            have = f.read()
    except OSError:
        return [(path, 1, "VTPU022",
                 "docs/gpu/protocols.md missing: generate it with "
                 "`python -m vtpu_torch.lint --write-docs`")]
    if have == want:
        return []
    have_lines = have.splitlines()
    want_lines = want.splitlines()
    line = 1
    for i, (h, w) in enumerate(zip(have_lines, want_lines), start=1):
        if h != w:
            line = i
            break
    else:
        line = min(len(have_lines), len(want_lines)) + 1
    return [(path, line, "VTPU022",
             "docs/gpu/protocols.md drifted from the registry rendering "
             "(first differing line): the file is generated — change "
             "vtpu_torch/contracts.py, then `python -m vtpu_torch.lint "
             "--write-docs`")]


def write_protocols_doc(root: str) -> str:
    path = os.path.join(root, PROTOCOLS_MD)
    with open(path, "w", encoding="utf-8") as f:
        f.write(render_protocols_md())
    return path
