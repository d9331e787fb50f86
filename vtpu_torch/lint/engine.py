"""The generalized guarded-by / confined-to engine (hack/vtpucheck/engine.py
over the port's registry).

One AST analyzer runs every declarative :class:`vtpu_torch.contracts.GuardRule`
/ :class:`~vtpu_torch.contracts.StoreRule` — the five bespoke lock-confinement
rules (VTPU002/010/012/015/017) plus the writer-confinement rules that
shared their shape (VTPU008/013/014/016/018-stamp) are now registry
entries instead of hand-written visitor methods.

The engine is deliberately host-agnostic: it receives a tiny context
protocol (``basename`` / ``parent_pkg`` / ``under(guard)`` /
``flag(node, rule, msg)``) from rules.py's per-file walker, which keeps
the lock-context tracking (`with` depth counters, the ``*_locked``
caller convention) and the waiver machinery exactly where they were —
fixtures and waivers behave unchanged.

Matching semantics preserved from the legacy rules:

* selector misses SKIP silently (an unrelated object's ``plan_locked``
  is not ours — receiver qualifiers gate that);
* a confinement violation flags and STOPS that rule (the legacy
  flag-and-return: no double finding for also missing the lock);
* ``guard_suffix`` limits the lock requirement to matching names
  (``_complete_eviction`` is a deliberate post-commit hook);
* ``forbid_guard`` inverts the check (``take_over`` self-deadlocks
  from under the shard locks it is about to take).
"""

from __future__ import annotations

import ast
from typing import Iterable, Tuple

from vtpu_torch.contracts import (
    GUARD_RULES,
    STORE_RULES,
    GuardRule,
    Site,
    StoreRule,
)


def trailing_name(expr: ast.AST) -> str:
    """The identifier a receiver expression 'ends' in: ``a.b.slices``
    -> ``slices``, ``engine`` -> ``engine``, else ``""``."""
    if isinstance(expr, ast.Attribute):
        return expr.attr
    if isinstance(expr, ast.Name):
        return expr.id
    return ""


def site_allowed(parent_pkg: str, basename: str,
                 sites: Iterable[Site]) -> bool:
    """True when (parent_pkg, basename) matches a confinement site.
    ``"*"`` wildcards either half: ``("monitor", "*")`` is the whole
    package, ``("*", "codec.py")`` is the defining module wherever it
    lives (so its doctests and test copies stay exempt)."""
    for pkg, base in sites:
        if (pkg == "*" or pkg == parent_pkg) \
                and (base == "*" or base == basename):
            return True
    return False


def _match_call(rule: GuardRule, node: ast.Call) -> Tuple[bool, str, str]:
    """(matched, called name, receiver name) for a Call against a rule's
    selector fields; receiver qualifiers that miss mean 'not ours'."""
    func = node.func
    if isinstance(func, ast.Attribute):
        name = func.attr
        recv = func.value
    elif isinstance(func, ast.Name) and rule.bare_name:
        name = func.id
        recv = None
    else:
        return False, "", ""
    if rule.methods and name not in rule.methods:
        return False, "", ""
    if rule.suffix and not name.endswith(rule.suffix):
        return False, "", ""
    if not rule.methods and not rule.suffix:
        return False, "", ""
    recv_name = ""
    if rule.receiver_self_attrs:
        if not (isinstance(recv, ast.Attribute)
                and isinstance(recv.value, ast.Name)
                and recv.value.id == "self"
                and recv.attr in rule.receiver_self_attrs):
            return False, "", ""
        recv_name = recv.attr
    if rule.receiver_attr:
        if not (isinstance(recv, ast.Attribute)
                and recv.attr == rule.receiver_attr):
            return False, "", ""
        recv_name = recv.attr
    if rule.receiver_names:
        recv_name = trailing_name(recv) if recv is not None else ""
        if recv_name not in rule.receiver_names:
            return False, "", ""
    if rule.receiver_contains:
        recv_name = trailing_name(recv) if recv is not None else ""
        if rule.receiver_contains not in recv_name:
            return False, "", ""
    if rule.requires_kwarg:
        if not any(kw.arg == rule.requires_kwarg
                   for kw in node.keywords):
            return False, "", ""
    return True, name, recv_name


def check_call(ctx, node: ast.Call) -> None:
    """Run every GuardRule against one call site. ``ctx`` is rules.py's
    per-file checker adapter (basename / parent_pkg / under / flag)."""
    for rule in GUARD_RULES:
        matched, name, recv = _match_call(rule, node)
        if not matched:
            continue
        if rule.confined_to and not site_allowed(
                ctx.parent_pkg, ctx.basename, rule.confined_to):
            ctx.flag(node, rule.rule,
                     rule.confine_message.format(name=name, recv=recv))
            continue
        if rule.forbid_guard:
            if ctx.under(rule.forbid_guard):
                ctx.flag(node, rule.rule,
                         rule.guard_message.format(name=name, recv=recv))
            continue
        if not rule.guarded_by:
            continue
        if rule.guard_suffix and not name.endswith(rule.guard_suffix):
            continue
        if not ctx.under(rule.guarded_by):
            ctx.flag(node, rule.rule,
                     rule.guard_message.format(name=name, recv=recv))


def check_store(ctx, node: ast.Assign) -> None:
    """Run every StoreRule against one assignment's targets."""
    for tgt in node.targets:
        for rule in STORE_RULES:
            attr = _store_target_attr(rule, tgt)
            if attr is None:
                continue
            if rule.confined_to:
                if site_allowed(ctx.parent_pkg, ctx.basename,
                                rule.confined_to):
                    continue
                ctx.flag(node, rule.rule,
                         rule.message.format(attr=attr))
                continue
            if rule.guarded_by and not ctx.under(rule.guarded_by):
                ctx.flag(node, rule.rule, rule.message.format(attr=attr))


def _store_target_attr(rule: StoreRule, tgt: ast.AST):
    if rule.attr_targets and isinstance(tgt, ast.Attribute) \
            and tgt.attr in rule.attr_targets:
        return tgt.attr
    if rule.subscript_of and isinstance(tgt, ast.Subscript) \
            and isinstance(tgt.value, ast.Attribute) \
            and tgt.value.attr in rule.subscript_of:
        return tgt.value.attr
    return None
