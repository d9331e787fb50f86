"""The vgpu chart (deploy/helm/vgpu) rendered without helm.

The chart's templates use a small subset of Go's text/template and of
Sprig; :func:`render` evaluates exactly that subset and raises
:class:`ChartError` on any construct it does not know, so a template that
strays from it fails here instead of rendering something helm would not.
:func:`load_yaml` reads the YAML the chart and its values are written in
(block mappings and sequences, plain, quoted and block scalars, flow
sequences), again failing loudly outside it. Neither needs anything but
the standard library: chip_smoke.py renders the chart on the card's
machine to take the daemons' argv from it, and tests/test_torch_deploy.py
holds the loader to PyYAML.

The subset: ``{{ }}`` actions with ``-`` trim markers; ``if``/``else``/
``end``, ``define``/``end``, ``$var := pipeline``; pipelines of
``.Values``/``.Release``/``.Chart`` fields, ``$var``, string and number
literals and the functions in ``FUNCS``.
"""

from __future__ import annotations

import copy
import json
import os
import re
from typing import Any, Dict, List, Optional, Tuple

CHART_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "deploy", "helm", "vgpu")
RELEASE = "vgpu"
NAMESPACE = "kube-system"


class ChartError(ValueError):
    """A construct outside the subset, or a value the chart lacks."""


# ---------------------------------------------------------------------------
# YAML subset
# ---------------------------------------------------------------------------

_NUM_INT = re.compile(r"^[-+]?\d+$")
_NUM_FLOAT = re.compile(r"^[-+]?(\d+\.\d*|\.\d+|\d+)([eE][-+]?\d+)?$")


def _strip_comment(line: str) -> str:
    """``line`` without a trailing `` # comment`` outside quotes."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == "\\" and quote == '"':
                continue
            if ch == quote:
                quote = None
        elif ch in "\"'" and (i == 0 or line[i - 1] in " [{,:-"):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def _scalar(text: str) -> Any:
    t = text.strip()
    if t == "" or t in ("~", "null"):
        return None
    if t[0] == '"':
        if not t.endswith('"') or len(t) < 2:
            raise ChartError(f"unterminated string {t!r}")
        return json.loads(t)
    if t[0] == "'":
        if not t.endswith("'") or len(t) < 2:
            raise ChartError(f"unterminated string {t!r}")
        return t[1:-1].replace("''", "'")
    if t[0] == "[":
        if not t.endswith("]"):
            raise ChartError(f"flow sequence {t!r} spans lines")
        inner = t[1:-1].strip()
        return [_scalar(p) for p in _split_flow(inner)] if inner else []
    if t == "{}":
        return {}
    if t[0] in "{&*!|>%@`":
        raise ChartError(f"YAML construct outside the subset: {t!r}")
    if t in ("true", "false"):
        return t == "true"
    if _NUM_INT.match(t):
        return int(t)
    if _NUM_FLOAT.match(t):
        return float(t)
    return t


def _split_flow(inner: str) -> List[str]:
    parts, cur, quote = [], "", None
    for ch in inner:
        if quote:
            cur += ch
            if ch == quote:
                quote = None
        elif ch in "\"'":
            quote = ch
            cur += ch
        elif ch in "[]{}":
            raise ChartError(f"nested flow collection in [{inner}]")
        elif ch == ",":
            parts.append(cur)
            cur = ""
        else:
            cur += ch
    parts.append(cur)
    return parts


def _key_value(text: str) -> Optional[Tuple[str, str]]:
    """(key, rest) of a ``key: rest`` line, None for a plain scalar."""
    if text[0] in "\"'":
        end = text.index(text[0], 1)
        key, rest = _scalar(text[:end + 1]), text[end + 1:]
        if not rest.startswith(":"):
            return None
        return key, rest[1:]
    m = re.match(r"^([^\s:][^:]*?):(\s|$)", text)
    if not m:
        return None
    return m.group(1), text[m.end(1) + 1:]


class _Lines:
    def __init__(self, raw: List[str]):
        self.raw = raw
        self.i = 0

    def next_content(self) -> Optional[Tuple[int, str]]:
        """(indent, text) of the next non-blank, non-comment line, without
        consuming it."""
        while self.i < len(self.raw):
            line = _strip_comment(self.raw[self.i])
            if line.strip():
                if "\t" in line[:len(line) - len(line.lstrip())]:
                    raise ChartError("tab in indentation")
                return len(line) - len(line.lstrip()), line.strip()
            self.i += 1
        return None


def _block_scalar(lines: _Lines, style: str, parent: int) -> str:
    body: List[str] = []
    indent = None
    while lines.i < len(lines.raw):
        raw = lines.raw[lines.i].rstrip("\n")
        if raw.strip():
            ind = len(raw) - len(raw.lstrip())
            if ind <= parent:
                break
            if indent is None:
                indent = ind
            if ind < indent:
                raise ChartError("block scalar dedented inside its body")
            body.append(raw[indent:])
        else:
            body.append("")
        lines.i += 1
    while body and not body[-1]:
        body.pop()
    if style[0] == "|":
        text = "\n".join(body)
    else:
        text = " ".join(b for b in body if b)
    return text if style.endswith("-") else text + "\n"


def _value(lines: _Lines, rest: str, indent: int) -> Any:
    rest = _strip_comment(rest).strip()
    if rest in ("|", "|-", ">", ">-"):
        lines.i += 1
        return _block_scalar(lines, rest, indent)
    if rest:
        lines.i += 1
        return _scalar(rest)
    lines.i += 1
    nxt = lines.next_content()
    if nxt is None:
        return None
    ind, text = nxt
    if ind > indent or (ind == indent and text.startswith("- ")):
        return _block(lines, ind)
    return None


def _block(lines: _Lines, indent: int, first: Optional[str] = None) -> Any:
    """The mapping or sequence at ``indent``; ``first`` replaces the first
    line's text (a sequence item's inline content)."""
    nxt = lines.next_content()
    text = first if first is not None else nxt[1]
    if text == "-" or text.startswith("- "):
        out: List[Any] = []
        while True:
            nxt = lines.next_content()
            if nxt is None or nxt[0] < indent:
                return out
            ind, text = nxt
            if ind != indent or not (text == "-" or text.startswith("- ")):
                if ind > indent:
                    raise ChartError(f"bad indentation at {text!r}")
                return out
            item = text[1:].strip()
            if item in ("", "|", "|-", ">", ">-"):
                out.append(_value(lines, item, indent))
            elif item[0] != "[" and _key_value(item) is not None:
                out.append(_block(lines, indent + 2, first=item))
            else:
                lines.i += 1
                out.append(_scalar(item))
    out_map: Dict[str, Any] = {}
    first_line = True
    while True:
        nxt = lines.next_content()
        if nxt is None:
            return out_map
        ind, text = nxt
        if first_line and first is not None:
            text = first
        elif ind != indent:
            if ind > indent:
                raise ChartError(f"bad indentation at {text!r}")
            return out_map
        first_line = False
        kv = _key_value(text)
        if kv is None:
            raise ChartError(f"expected `key: value`, got {text!r}")
        key, rest = kv
        if key in out_map:
            raise ChartError(f"duplicate key {key!r}")
        out_map[key] = _value(lines, rest, indent)


def load_yaml(text: str) -> List[Any]:
    """Every document of ``text``, as PyYAML's safe_load_all gives them
    (None for an empty one after a ``---``)."""
    docs: List[Any] = []
    chunk: List[str] = []
    explicit = False  # the chunk began at a `---` (PyYAML's documents)
    for line in text.split("\n") + ["---"]:
        if line.rstrip() == "---":
            lines = _Lines(chunk)
            if lines.next_content() is None:
                if explicit:
                    docs.append(None)
            else:
                doc = _block(lines, lines.next_content()[0])
                if lines.next_content() is not None:
                    raise ChartError(
                        f"trailing YAML: {lines.next_content()[1]!r}")
                docs.append(doc)
            chunk = []
            explicit = True
        elif line.startswith("%") or line.startswith("..."):
            raise ChartError(f"YAML directive outside the subset: {line!r}")
        else:
            chunk.append(line)
    return docs


def dump_yaml(value: Any, indent: int = 0) -> str:
    """Block YAML of a mapping or sequence of scalars and collections (the
    chart's ``toYaml``)."""
    pad = " " * indent
    out: List[str] = []
    if isinstance(value, dict):
        for k, v in value.items():
            if isinstance(v, (dict, list)) and v:
                out.append(f"{pad}{_yaml_scalar(k)}:")
                out.append(dump_yaml(v, indent + 2))
            else:
                out.append(f"{pad}{_yaml_scalar(k)}: {_yaml_scalar(v)}")
    elif isinstance(value, list):
        for v in value:
            if isinstance(v, (dict, list)) and v:
                inner = dump_yaml(v, indent + 2)
                out.append(f"{pad}- {inner.lstrip()}")
            else:
                out.append(f"{pad}- {_yaml_scalar(v)}")
    else:
        return pad + _yaml_scalar(value)
    return "\n".join(out)


def _yaml_scalar(v: Any) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float)):
        return _go_str(v)
    if isinstance(v, dict) and not v:
        return "{}"
    if isinstance(v, list) and not v:
        return "[]"
    s = str(v)
    if _scalar(s) != s or s != s.strip() or ": " in s or s.startswith("-"):
        return json.dumps(s)
    return s


# ---------------------------------------------------------------------------
# Go template subset
# ---------------------------------------------------------------------------

_ACTION = re.compile(r"\{\{(-)?\s*(.*?)\s*(-)?\}\}", re.S)
_TOKEN = re.compile(r"""\s*(?:
    (?P<str>"(?:[^"\\]|\\.)*")
  | (?P<num>-?\d+(?:\.\d+)?)
  | (?P<var>\$[A-Za-z_0-9]*(?:\.[A-Za-z_][A-Za-z_0-9]*)*)
  | (?P<field>(?:\.[A-Za-z_][A-Za-z_0-9]*)+|\.)
  | (?P<ident>[A-Za-z_][A-Za-z_0-9]*)
  | (?P<punct>[()|])
  | (?P<assign>:=)
)""", re.X)


def _go_str(v: Any) -> str:
    """How text/template prints a value."""
    if v is None:
        raise ChartError("a value the chart does not define was printed")
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, float):
        return str(int(v)) if v.is_integer() else repr(v)
    if isinstance(v, (dict, list)):
        raise ChartError("a collection was printed without toYaml/toJson")
    return str(v)


def _truthy(v: Any) -> bool:
    return not (v is None or v is False or v == 0 or v == "" or
                (isinstance(v, (dict, list)) and not v))


def _indent(n: int, s: Any) -> str:
    pad = " " * int(n)
    return "\n".join(pad + line for line in _go_str(s).split("\n"))


def _default(dflt: Any, v: Any = None) -> Any:
    return v if _truthy(v) else dflt


def _and(*vs: Any) -> Any:
    for v in vs:
        if not _truthy(v):
            return v
    return vs[-1]


def _num(v: Any) -> float:
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        raise ChartError(f"comparison of a non-number {v!r}")
    return v


#: the Sprig and builtin functions the chart calls, by name: no others
FUNCS = {
    "default": _default,
    "quote": lambda v: json.dumps(_go_str(v)),
    "nindent": lambda n, s: "\n" + _indent(n, s),
    "toYaml": lambda v: dump_yaml(v),
    "toJson": lambda v: json.dumps(v, separators=(",", ":")),
    "ternary": lambda a, b, cond: a if _truthy(cond) else b,
    "and": _and,
    "not": lambda v: not _truthy(v),
    "ne": lambda a, b: a != b,
    "gt": lambda a, b: _num(a) > _num(b),
    "ge": lambda a, b: _num(a) >= _num(b),
    "int": lambda v: int(float(v)) if v not in (None, "") else 0,
}


def _tokens(expr: str) -> List[Tuple[str, str]]:
    out, pos = [], 0
    while pos < len(expr):
        if not expr[pos:].strip():
            break
        m = _TOKEN.match(expr, pos)
        if not m or m.end() == pos:
            raise ChartError(f"template expression outside the subset: "
                             f"{expr!r}")
        out.append((m.lastgroup, m.group(m.lastgroup)))
        pos = m.end()
    return out


class _Template:
    """One parsed template: a tree of text, output, assignment, if and
    define nodes."""

    def __init__(self, name: str, text: str, defines: Dict[str, list]):
        self.name = name
        self.defines = defines
        self.body = self._parse(text)

    def _parse(self, text: str) -> list:
        pieces: List[Any] = []
        pos = 0
        for m in _ACTION.finditer(text):
            pieces.append(("text", text[pos:m.start()]))
            pieces.append(("action", m.group(2), bool(m.group(1)),
                           bool(m.group(3))))
            pos = m.end()
        pieces.append(("text", text[pos:]))
        for i, p in enumerate(pieces):  # the trim markers
            if p[0] != "action":
                continue
            if p[2] and i > 0:
                pieces[i - 1] = ("text", pieces[i - 1][1].rstrip())
            if p[3] and i + 1 < len(pieces):
                pieces[i + 1] = ("text", pieces[i + 1][1].lstrip())
        root: List[Any] = []
        # (block kind, the list its nodes go to, its if node)
        stack: List[Tuple[str, list, Any]] = [("root", root, None)]
        for p in pieces:
            cur = stack[-1][1]
            if p[0] == "text":
                if p[1]:
                    cur.append(("text", p[1]))
                continue
            act = p[1]
            if act.startswith("/*"):
                raise ChartError(f"{self.name}: template comments are "
                                 "outside the subset")
            word = act.split(None, 1)[0] if act else ""
            if word == "if":
                node = ["if", act[2:].strip(), [], None]
                cur.append(node)
                stack.append(("if", node[2], node))
            elif word == "else":
                if act != "else" or stack[-1][0] != "if":
                    raise ChartError(f"{self.name}: `{act}` outside the "
                                     "subset or outside an if")
                node = stack[-1][2]
                node[3] = []
                stack[-1] = ("else", node[3], node)
            elif word == "define":
                name = json.loads(act[6:].strip())
                body: List[Any] = []
                self.defines[name] = body
                stack.append(("define", body, None))
            elif word == "end":
                if len(stack) == 1:
                    raise ChartError(f"{self.name}: `end` without a block")
                stack.pop()
            elif word in ("range", "with", "block", "template", "break",
                          "continue", "tpl"):
                raise ChartError(f"{self.name}: `{word}` is outside the "
                                 "subset")
            elif re.match(r"^\$[A-Za-z_0-9]+\s*:=", act):
                var, expr = act.split(":=", 1)
                cur.append(("set", var.strip(), expr.strip()))
            else:
                cur.append(("out", act))
        if len(stack) != 1:
            raise ChartError(f"{self.name}: unclosed `{stack[-1][0]}`")
        return root

    def execute(self, dot: Any, scope: Dict[str, Any],
                body: Optional[list] = None) -> str:
        out: List[str] = []
        for node in self.body if body is None else body:
            if node[0] == "text":
                out.append(node[1])
            elif node[0] == "out":
                out.append(_go_str(self._pipeline(node[1], dot, scope)))
            elif node[0] == "set":
                scope[node[1]] = self._pipeline(node[2], dot, scope)
            else:  # if
                branch = node[2] if _truthy(
                    self._pipeline(node[1], dot, scope)) else node[3]
                if branch:
                    out.append(self.execute(dot, scope, branch))
        return "".join(out)

    def _pipeline(self, expr: str, dot: Any, scope: Dict[str, Any]) -> Any:
        toks = _tokens(expr)
        val, rest = self._pipe(toks, dot, scope)
        if rest:
            raise ChartError(f"trailing tokens in {expr!r}")
        return val

    def _pipe(self, toks, dot, scope):
        val, toks = self._command(toks, dot, scope, None, False)
        while toks and toks[0] == ("punct", "|"):
            val, toks = self._command(toks[1:], dot, scope, val, True)
        return val, toks

    def _command(self, toks, dot, scope, piped, has_piped):
        if not toks:
            raise ChartError("empty command")
        kind, text = toks[0]
        if kind == "ident" and text not in ("true", "false", "nil"):
            args: List[Any] = []
            toks = toks[1:]
            while toks and toks[0] not in (("punct", "|"), ("punct", ")")):
                arg, toks = self._operand(toks, dot, scope)
                args.append(arg)
            if has_piped:
                args.append(piped)
            return self._call(text, args, dot), toks
        if has_piped:
            raise ChartError(f"`{text}` cannot take a piped value")
        return self._operand(toks, dot, scope)

    def _operand(self, toks, dot, scope):
        kind, text = toks[0]
        toks = toks[1:]
        if kind == "str":
            return json.loads(text), toks
        if kind == "num":
            return (float(text) if "." in text else int(text)), toks
        if kind == "ident":
            if text in ("true", "false"):
                return text == "true", toks
            if text == "nil":
                return None, toks
            raise ChartError(f"function `{text}` used as an argument "
                             "without parentheses")
        if kind == "field":
            return _lookup(dot, text), toks
        if kind == "var":
            name, _, path = text.partition(".")
            if name not in scope:
                raise ChartError(f"undefined variable {name}")
            return _lookup(scope[name], "." + path if path else "."), toks
        if (kind, text) == ("punct", "("):
            val, toks = self._pipe(toks, dot, scope)
            if not toks or toks[0] != ("punct", ")"):
                raise ChartError("unbalanced parentheses")
            return val, toks[1:]
        raise ChartError(f"unexpected `{text}`")

    def _call(self, name: str, args: List[Any], dot: Any) -> Any:
        if name == "include":
            if len(args) != 2 or args[0] not in self.defines:
                raise ChartError(f"include of an undefined template "
                                 f"{args[:1]}")
            return self.execute(args[1], {"$": args[1]},
                                self.defines[args[0]])
        if name not in FUNCS:
            raise ChartError(f"function `{name}` is outside the subset")
        try:
            return FUNCS[name](*args)
        except TypeError as e:
            raise ChartError(f"{name}{tuple(args)}: {e}") from None


def _lookup(obj: Any, path: str) -> Any:
    if path == ".":
        return obj
    for part in path.strip(".").split("."):
        if not isinstance(obj, dict) or part not in obj:
            raise ChartError(f"the chart has no value {path}")
        obj = obj[part]
    return obj


def _merge(base: Dict[str, Any], over: Dict[str, Any]) -> Dict[str, Any]:
    out = copy.deepcopy(base)
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def _read(path: str) -> str:
    with open(path, "r", encoding="utf-8") as f:
        return f.read()


def chart_files(chart_dir: str = CHART_DIR) -> List[str]:
    """The chart's templates, relative to templates/, sorted."""
    tdir = os.path.join(chart_dir, "templates")
    out = []
    for dirpath, _, files in os.walk(tdir):
        out.extend(os.path.relpath(os.path.join(dirpath, f), tdir)
                   for f in files if f.endswith((".yaml", ".tpl")))
    return sorted(out)


def render(values: Optional[Dict[str, Any]] = None,
           release: str = RELEASE, namespace: str = NAMESPACE,
           chart_dir: str = CHART_DIR) -> Dict[str, str]:
    """Each manifest template's text, rendered at the chart's values with
    ``values`` merged over them (as ``helm template --set``)."""
    (chart,) = load_yaml(_read(os.path.join(chart_dir, "Chart.yaml")))
    (vals,) = load_yaml(_read(os.path.join(chart_dir, "values.yaml")))
    dot = {
        "Values": _merge(vals, values or {}),
        "Release": {"Name": release, "Namespace": namespace,
                    "Service": "Helm"},
        "Chart": {"Name": chart["name"], "Version": chart["version"],
                  "AppVersion": chart["appVersion"]},
    }
    defines: Dict[str, list] = {}
    templates = []
    for rel in chart_files(chart_dir):
        t = _Template(rel, _read(os.path.join(chart_dir, "templates", rel)),
                      defines)
        if not rel.endswith(".tpl"):
            templates.append(t)
    return {t.name: t.execute(dot, {"$": dot}) for t in templates}


def objects(values: Optional[Dict[str, Any]] = None,
            **kw) -> List[Dict[str, Any]]:
    """Every object the chart renders (its documents that are not empty),
    in template order."""
    out = []
    for _name, text in sorted(render(values, **kw).items()):
        out.extend(d for d in load_yaml(text) if d is not None)
    return out


def container(objs: List[Dict[str, Any]], name: str) -> Dict[str, Any]:
    """The one container called ``name`` among the chart's workloads."""
    found = [c for o in objs
             for c in (o.get("spec", {}).get("template", {})
                       .get("spec", {}).get("containers", []))
             if c.get("name") == name]
    if len(found) != 1:
        raise ChartError(f"{len(found)} containers named {name}")
    return found[0]


#: the chart's containers that run a daemon of the port, and its module
DAEMONS = {"device-plugin": "vtpu_torch.plugin",
           "monitor": "vtpu_torch.monitor",
           "vgpu-scheduler-extender": "vtpu_torch.scheduler"}


def daemon_argv(objs: List[Dict[str, Any]], name: str) -> List[str]:
    """The argv the chart gives the daemon of container ``name``: its
    command after ``python -m <module>``."""
    cmd = container(objs, name)["command"]
    if cmd[:3] != ["python", "-m", DAEMONS[name]]:
        raise ChartError(f"{name} runs {cmd[:3]}, not python -m "
                         f"{DAEMONS[name]}")
    return [str(a) for a in cmd[3:]]
