"""The Grafana dashboards of a GPU node, and what a scrape must serve for
each of their panels to show something.

``docs/gpu/dashboard.json`` and ``deploy/grafana/gpu-shim-profile.json``
are the twins of the JAX package's ``docs/tpu-dashboard.json`` and
``deploy/grafana/shim-profile.json``: panel for panel, each expression the
JAX one with every family renamed through the map of the exporter that
serves it (:func:`exporters`). Seven JAX selectors name a counter family
without the ``_total`` that ``prometheus_client`` serves its samples
under, so they match no series; their twins take it
(``tests/test_torch_dashboards.py`` lists them).

:func:`selectors` pulls each metric name and its label matchers out of a
PromQL expression. The dashboards use instant and range selectors,
aggregations, functions and arithmetic only, so a tokenizer does: no
PromQL engine. :func:`hold` checks one scrape of an exporter against every
selector of the dashboards that names a family the exporter serves, and
:func:`leakage` evaluates the quota-leakage panel on a scrape by hand.
"""

from __future__ import annotations

import json
import math
import os
import re
from typing import Dict, Iterable, List, NamedTuple, Optional, Tuple

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the GPU dashboards, as paths in the checkout
DASHBOARDS = ("docs/gpu/dashboard.json",
              "deploy/grafana/gpu-shim-profile.json")

#: the quota-leakage panel's expression and the bound it is read against:
#: the system's target, under 2% (BASELINE.md:29-31)
LEAKAGE_EXPR = ("max by (podname) (vGPU_device_memory_usage_in_bytes / "
                "vGPU_device_memory_limit_in_bytes) - 1")
LEAKAGE_BOUND = 0.02

#: what each family type serves its samples as
SAMPLE_SUFFIXES = {"counter": ("_total", "_created"),
                   "gauge": ("",),
                   "histogram": ("_bucket", "_count", "_sum", "_created")}
_SUFFIXES = ("_total", "_created", "_bucket", "_count", "_sum")

_KEYWORDS = {"by", "without", "on", "ignoring", "group_left", "group_right",
             "bool", "and", "or", "unless", "offset"}
_GROUPING = {"by", "without", "on", "ignoring", "group_left", "group_right"}
#: aggregation operators, which may take their grouping before their
#: argument (``sum by (kind) (...)``)
_AGGREGATIONS = {"sum", "min", "max", "avg", "group", "stddev", "stdvar",
                 "count", "count_values", "bottomk", "topk", "quantile"}
_TOKEN = re.compile(r"""
    (?P<str>"(?:[^"\\]|\\.)*")
  | (?P<range>\[[^\]]*\])
  | (?P<brace>\{[^}]*\})
  | (?P<num>\d+(?:\.\d+)?(?:[eE][+-]?\d+)?)
  | (?P<ident>[A-Za-z_:][A-Za-z0-9_:]*)
  | (?P<ws>\s+)
  | (?P<op>.)""", re.X)
_MATCHER = re.compile(
    r'\s*([A-Za-z_][A-Za-z0-9_]*)\s*(=~|!~|!=|=)\s*"((?:[^"\\]|\\.)*)"\s*,?')
_LABEL_VALUES = re.compile(r"label_values\(\s*([A-Za-z_:][A-Za-z0-9_:]*)")


class Selector(NamedTuple):
    """one metric selector of an expression"""
    name: str
    matchers: Tuple[Tuple[str, str, str], ...]


def selectors(expr: str) -> List[Selector]:
    """Every metric selector of a PromQL expression (or of a Grafana
    ``label_values(metric, label)`` template query), in order: its metric
    name and its ``(label, op, value)`` matchers."""
    m = _LABEL_VALUES.match(expr.strip())
    if m:
        return [Selector(m.group(1), ())]
    toks = [(t.lastgroup, t.group()) for t in _TOKEN.finditer(expr)
            if t.lastgroup != "ws"]
    out, i = [], 0
    while i < len(toks):
        kind, text = toks[i]
        nxt = toks[i + 1] if i + 1 < len(toks) else (None, "")
        if kind == "ident" and text in _GROUPING and nxt[1] == "(":
            i += 2
            while i < len(toks) and toks[i][1] != ")":
                i += 1                          # the label list
        elif (kind == "ident" and text not in _KEYWORDS and nxt[1] != "("
              and text not in _AGGREGATIONS):
            matchers = ()
            if nxt[0] == "brace":
                matchers = tuple(_MATCHER.findall(nxt[1][1:-1]))
                i += 1
            out.append(Selector(text, matchers))
        i += 1
    return out


def promql(sel: Selector) -> str:
    """a selector as PromQL writes it"""
    if not sel.matchers:
        return sel.name
    return sel.name + "{" + ", ".join(
        f'{label}{op}"{value}"' for label, op, value in sel.matchers) + "}"


def exporters() -> Dict[str, Dict[str, str]]:
    """exporter -> {JAX family: the port's family it serves}: the node
    monitor (:9394), the scheduler (:9395; the stage histogram of its
    spans too) and the serving gateway (its process's registry)."""
    from .gateway.metrics import METRIC_NAMES as gateway
    from .monitor.metrics import METRIC_NAMES as monitor
    from .scheduler.metrics import METRIC_NAMES as scheduler

    stage = "vTPUSchedulingStageLatency"
    return {"monitor": dict(monitor),
            "scheduler": dict(scheduler, **{stage: monitor[stage]}),
            "gateway": dict(gateway)}


def split_sample(name: str, families: Iterable[str]) -> Tuple[str, str]:
    """(family, suffix) of a sample name among ``families``: the name
    itself, else the name less one of the exposition's suffixes"""
    families = set(families)
    if name in families:
        return name, ""
    for suffix in _SUFFIXES:
        if name.endswith(suffix) and name[:-len(suffix)] in families:
            return name[:-len(suffix)], suffix
    raise KeyError(name)


def panels(dashboard: dict) -> List[dict]:
    """every panel of a dashboard, rows and the panels rows hold included,
    in order"""
    out = []
    for p in dashboard.get("panels", []):
        out.append(p)
        out.extend(p.get("panels", []))
    return out


def expressions(dashboard: dict) -> List[Tuple[str, str]]:
    """(where, expression) of every target and template query"""
    out = []
    for p in panels(dashboard):
        for t in p.get("targets", []):
            out.append((f"{p['title']} [{t.get('refId', '')}]", t["expr"]))
    for v in dashboard.get("templating", {}).get("list", []):
        q = v.get("query")
        out.append((f"${v['name']}", q["query"] if isinstance(q, dict)
                    else q))
    return out


def load(path: str) -> dict:
    with open(os.path.join(REPO, path)) as f:
        return json.load(f)


def dashboard_selectors() -> List[Tuple[str, Selector]]:
    """(dashboard: where, selector) of every selector of the GPU
    dashboards"""
    return [(f"{os.path.basename(p)}: {where}", s) for p in DASHBOARDS
            for where, expr in expressions(load(p))
            for s in selectors(expr)]


def parse(text: str) -> dict:
    """family -> (type, [(sample name, labels, value)]) of one text
    exposition"""
    from prometheus_client.parser import text_string_to_metric_families

    return {f.name: (f.type, [(s.name, s.labels, s.value)
                              for s in f.samples])
            for f in text_string_to_metric_families(text)}


def _matches(labels: dict, matchers) -> bool:
    for label, op, value in matchers:
        if label == "instance" or "$" in value:
            continue        # the scrape's target, a dashboard variable
        got = labels.get(label, "")
        hit = (re.fullmatch(value, got) is not None if op in ("=~", "!~")
               else got == value)
        if hit != (op in ("=", "=~")):
            return False
    return True


def hold(text: str, exporter: str,
         filled: Iterable[str]) -> Tuple[List[str], List[str]]:
    """One scrape of ``exporter`` against every dashboard selector that
    names one of its families, once a dashboard: (a line per selector,
    the failures). A selector fails when the scrape declares no such
    family, when its name is not a sample name of the family's type, or,
    for a family the run ``filled``, when no sample carries its name. Any
    other selector with no sample is reported as declared, with no
    sample."""
    served = set(exporters()[exporter].values())
    fams = parse(text)
    filled = set(filled)
    lines, failures = [], []
    seen = set()
    for where, sel in dashboard_selectors():
        try:
            family, suffix = split_sample(sel.name, served)
        except KeyError:
            continue                    # another exporter's family
        key = (where.split(":")[0], sel)
        if key in seen:
            continue
        seen.add(key)
        if family not in fams:
            failures.append(f"{where}: {sel.name}: {exporter} declares no "
                            f"family {family}")
            continue
        ftype, samples = fams[family]
        if suffix not in SAMPLE_SUFFIXES.get(ftype, ("",)):
            failures.append(f"{where}: {sel.name}: the {ftype} {family} "
                            f"serves no such sample")
            continue
        named = [s for s in samples if s[0] == sel.name]
        hits = [s for s in named if _matches(s[1], sel.matchers)]
        if named:
            state = f"{len(named)} samples, {len(hits)} matching"
        elif family in filled:
            state = "no sample"
            failures.append(f"{where}: {sel.name}: no sample, though this "
                            f"run fills {family}")
        else:
            state = "declared, no sample"
        lines.append(f"{promql(sel)}: {state}")
    return lines, failures


def leakage(text: str) -> Dict[str, float]:
    """The quota-leakage panel (:data:`LEAKAGE_EXPR`) on one scrape:
    usage over limit for each pair of samples with equal labels, the most
    of each pod, less 1. podname -> value."""
    fams = parse(text)

    def series(family):
        return {frozenset(labels.items()): v
                for _, labels, v in fams.get(family, ("", []))[1]}

    usage = series("vGPU_device_memory_usage_in_bytes")
    limit = series("vGPU_device_memory_limit_in_bytes")
    out: Dict[str, float] = {}
    for labels, used in usage.items():
        lim: Optional[float] = limit.get(labels)
        if lim is None:
            continue                    # no series to divide by: none
        ratio = used / lim if lim else math.inf
        pod = dict(labels).get("podname", "")
        out[pod] = max(out.get(pod, -math.inf), ratio)
    return {pod: v - 1 for pod, v in out.items()}
