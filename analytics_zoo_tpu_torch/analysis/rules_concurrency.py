"""Concurrency rules — unlocked shared-state writes in thread-backed
classes and lock-order inversions.

The serving engine, frontend and broker all follow one pattern: a class
spawns ``threading.Thread(target=self._run)`` and the rest of its methods
are called from other threads. Attributes touched on **both** sides of
that boundary are shared state; writes to them must hold the class's
lock. The rule reconstructs the thread-reachable method set from the AST
(entry = any ``Thread(target=self.X)``, closure over ``self.Y()`` calls)
and flags cross-boundary writes that are not under a ``with self.*lock``
— thread-confined attributes (written and read only inside the thread's
own call tree) are deliberately not flagged.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Set, Tuple

from analytics_zoo_tpu_torch.analysis.core import (
    FileContext, Finding, Rule, ancestors, register,
)

_FUNCS = (ast.FunctionDef, ast.AsyncFunctionDef)

#: attribute-name fragments that identify a lock-ish context manager
_LOCKISH = ("lock", "cv", "cond", "mutex", "sem")


def _is_lockish_ctx(expr: ast.AST) -> bool:
    """``with self._lock:`` / ``with state.cv:`` — the guard we accept."""
    cur = expr
    while isinstance(cur, ast.Call):
        cur = cur.func
    if isinstance(cur, ast.Attribute):
        return any(m in cur.attr.lower() for m in _LOCKISH)
    if isinstance(cur, ast.Name):
        return any(m in cur.id.lower() for m in _LOCKISH)
    return False


def _under_lock(node: ast.AST) -> bool:
    for a in ancestors(node):
        if isinstance(a, ast.With) and any(
                _is_lockish_ctx(item.context_expr) for item in a.items):
            return True
    return False


def _lock_name(expr: ast.AST) -> str:
    try:
        return ast.unparse(expr)
    except Exception:
        return "<lock>"


def _self_attr(node: ast.AST):
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self":
        return node.attr
    return None


class _ClassInfo:
    """Per-class maps a file rule needs: method bodies, self-call edges,
    thread-target entry methods, per-method self-attribute reads/writes."""

    def __init__(self, cls: ast.ClassDef, ctx: FileContext):
        self.cls = cls
        self.methods: Dict[str, ast.AST] = {
            n.name: n for n in cls.body if isinstance(n, _FUNCS)}
        self.entries: Set[str] = set()
        self.calls: Dict[str, Set[str]] = {}
        self.writes: Dict[str, List[ast.Attribute]] = {}
        self.reads: Dict[str, Set[str]] = {}
        for name, fn in self.methods.items():
            calls: Set[str] = set()
            writes: List[ast.Attribute] = []
            reads: Set[str] = set()
            for node in ast.walk(fn):
                if isinstance(node, ast.Call):
                    callee = _self_attr(node.func)
                    if callee:
                        calls.add(callee)
                    if self._thread_target(ctx, node):
                        tgt = self._target_method(node)
                        if tgt:
                            self.entries.add(tgt)
                attr = _self_attr(node)
                if attr is not None:
                    # AugAssign targets also carry Store ctx in py3.8+
                    if isinstance(node.ctx, ast.Store):
                        writes.append(node)
                    else:
                        reads.add(attr)
            self.calls[name] = calls
            self.writes[name] = writes
            self.reads[name] = reads

    @staticmethod
    def _thread_target(ctx: FileContext, call: ast.Call) -> bool:
        name = ctx.imports.resolve(call.func)
        return bool(name) and name.split(".")[-1] == "Thread"

    @staticmethod
    def _target_method(call: ast.Call):
        for kw in call.keywords:
            if kw.arg == "target":
                return _self_attr(kw.value)
        return None

    def reachable(self) -> Set[str]:
        """Methods the spawned thread can execute: closure of the entry
        set over ``self.X()`` edges."""
        seen: Set[str] = set()
        stack = [e for e in self.entries if e in self.methods]
        while stack:
            m = stack.pop()
            if m in seen:
                continue
            seen.add(m)
            stack.extend(c for c in self.calls.get(m, ())
                         if c in self.methods and c not in seen)
        return seen


@register
class EngineUnlockedWrite(Rule):
    """Unlocked write to an attribute shared across a thread boundary.

    In a class that spawns ``Thread(target=self.X)``, an attribute both
    (a) written inside the thread's reachable call tree and (b) touched
    by outside methods — or vice versa — is shared state. Every such
    write must sit under ``with self.<lock>:``. ``__init__`` is exempt
    (runs before the thread exists)."""

    id = "engine-unlocked-write"
    description = "cross-thread attribute write without a lock"

    def check_file(self, ctx: FileContext) -> Iterable[Finding]:
        for cls in ctx.walk():
            if not isinstance(cls, ast.ClassDef):
                continue
            info = _ClassInfo(cls, ctx)
            if not info.entries:
                continue
            reach = info.reachable()
            outside = [m for m in info.methods
                       if m not in reach and m != "__init__"]
            touched_outside: Set[str] = set()
            for m in outside:
                touched_outside |= info.reads[m]
                touched_outside |= {_self_attr(w) for w in info.writes[m]}
            touched_inside: Set[str] = set()
            for m in reach:
                touched_inside |= info.reads[m]
                touched_inside |= {_self_attr(w) for w in info.writes[m]}
            shared = touched_outside & touched_inside
            for side, methods in (("thread", reach), ("caller", outside)):
                for m in methods:
                    for w in info.writes[m]:
                        attr = _self_attr(w)
                        if attr in shared and not _under_lock(w):
                            yield Finding(
                                self.id, ctx.path, w.lineno, w.col_offset,
                                f"self.{attr} is written in "
                                f"{cls.name}.{m} ({side} side) and "
                                "touched across the thread boundary "
                                "without holding a lock — wrap the write "
                                "in `with self._lock:` (or confine the "
                                "attribute to one thread)")


@register
class LockOrder(Rule):
    """Inconsistent nested lock acquisition order within one file.

    ``with A: with B:`` in one place and ``with B: with A:`` in another
    is the classic deadlock; the rule records every nested (outer, inner)
    lock-attribute pair and flags the inversion where the second order
    appears."""

    id = "lock-order"
    description = "nested locks acquired in both orders"

    def check_file(self, ctx: FileContext) -> Iterable[Finding]:
        pairs: Dict[Tuple[str, str], ast.With] = {}
        for node in ctx.walk():
            if not isinstance(node, ast.With):
                continue
            inner = [i.context_expr for i in node.items
                     if _is_lockish_ctx(i.context_expr)]
            if not inner:
                continue
            outer = []
            for a in ancestors(node):
                if isinstance(a, ast.With):
                    outer.extend(i.context_expr for i in a.items
                                 if _is_lockish_ctx(i.context_expr))
            for o in outer:
                for i in inner:
                    pairs.setdefault(
                        (_lock_name(o), _lock_name(i)), node)
        for (o, i), node in pairs.items():
            if o != i and (i, o) in pairs:
                rev = pairs[(i, o)]
                if (node.lineno, o) > (rev.lineno, i):
                    yield Finding(
                        self.id, ctx.path, node.lineno, node.col_offset,
                        f"locks `{i}` → `{o}` here but `{o}` → `{i}` at "
                        f"line {rev.lineno} — pick one global order to "
                        "avoid an ABBA deadlock")
