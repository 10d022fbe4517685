"""Recompile-hazard rules — ``torch.compile`` / TorchScript misuse that
causes silent per-call or per-iteration recompilation.

A compile costs seconds and stalls whatever thread pays it; the
``zoo_jit_cache_misses_total`` counter detects a storm at runtime, these
rules catch the constructions that guarantee one before the code ever
reaches a card: a compiled callable built inside a loop, one built and
invoked in one expression (a fresh wrapper, and a fresh compile, per
call), and unhashable ``static_argnums``/``static_argnames`` values given
to a constructor.

The constructors are ``torch.compile``, ``torch.jit.script`` /
``trace`` / ``trace_module`` and the port's ``telemetry.instrument_jit``
(its recompile accounting around an eager callable).
"""

from __future__ import annotations

import ast
from typing import Iterable

from analytics_zoo_tpu_torch.analysis.core import (
    FileContext, Finding, Rule, ancestors, register,
)

#: fully-resolved callables that compile or trace a callable
COMPILERS = frozenset({"torch.compile", "torch.jit.script",
                       "torch.jit.trace", "torch.jit.trace_module"})
#: callee tails that wrap a callable in the recompile accounting
_JIT_TAILS = frozenset({"instrument_jit"})

_LOOPS = (ast.For, ast.While, ast.AsyncFor)
_STATIC_KWARGS = ("static_argnums", "static_argnames")


def is_jit_constructor(ctx: FileContext, node: ast.Call) -> bool:
    name = ctx.imports.resolve(node.func)
    if not name:
        return False
    if name in COMPILERS:
        return True
    parts = name.split(".")
    # a bare `instrument_jit` only counts when it resolves through an
    # import (telemetry.instrument_jit) — a local helper of that name
    # does not
    return len(parts) > 1 and parts[-1] in _JIT_TAILS


@register
class JitInLoop(Rule):
    """``torch.compile(...)`` (or TorchScript, or ``instrument_jit``)
    constructed inside a ``for``/``while`` body.

    Every iteration builds a fresh wrapper with an empty cache, so the
    first call of each iteration compiles again. Construct the compiled
    callable once outside the loop (or in ``__init__``) and call it
    inside."""

    id = "jit-in-loop"
    description = "compiled callable constructed inside a loop"

    def check_file(self, ctx: FileContext) -> Iterable[Finding]:
        for node in ctx.walk():
            if isinstance(node, ast.Call) \
                    and is_jit_constructor(ctx, node) \
                    and any(isinstance(a, _LOOPS) for a in ancestors(node)):
                yield Finding(
                    self.id, ctx.path, node.lineno, node.col_offset,
                    f"{ctx.imports.resolve(node.func)} constructed inside "
                    "a loop — build the compiled callable once outside and "
                    "reuse it")


@register
class JitCallInline(Rule):
    """``torch.compile(f)(x)`` — a compiled wrapper built and invoked in
    one expression, i.e. rebuilt on every call of the enclosing function.

    The per-call wrapper starts with an empty cache and compiles again at
    every call; hoist the ``torch.compile(f)`` to module/``__init__``
    scope."""

    id = "jit-call-inline"
    description = "compiled callable built and invoked in one expression"

    def check_file(self, ctx: FileContext) -> Iterable[Finding]:
        for node in ctx.walk():
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Call) \
                    and is_jit_constructor(ctx, node.func):
                yield Finding(
                    self.id, ctx.path, node.lineno, node.col_offset,
                    "compiled wrapper built and invoked in one expression "
                    "— a fresh compile per call; hoist the construction "
                    "out of the call path")


@register
class JitStaticUnhashable(Rule):
    """List/set/dict literals passed as ``static_argnums`` /
    ``static_argnames`` to a compile constructor.

    PyTorch's constructors have no static-argument descriptor:
    ``torch.compile`` specializes on every Python scalar it sees and
    guards on it, and TorchScript types its arguments. So in the port
    the rule matches only a JAX-style ``static_argnums`` /
    ``static_argnames`` keyword given to ``torch.compile``, TorchScript
    or ``instrument_jit`` — code carried over from JAX, which torch
    rejects at call time. Where such a descriptor keys a cache it must be
    hashable: use a tuple."""

    id = "jit-static-unhashable"
    description = ("unhashable static_argnums/static_argnames value given "
                   "to a compile constructor")

    def check_file(self, ctx: FileContext) -> Iterable[Finding]:
        for node in ctx.walk():
            if not (isinstance(node, ast.Call)
                    and is_jit_constructor(ctx, node)):
                continue
            for kw in node.keywords:
                if kw.arg in _STATIC_KWARGS and isinstance(
                        kw.value, (ast.List, ast.Set, ast.Dict)):
                    kind = type(kw.value).__name__.lower()
                    yield Finding(
                        self.id, ctx.path, kw.value.lineno,
                        kw.value.col_offset,
                        f"{kw.arg} given a {kind} literal — static arg "
                        "descriptors key the compile cache and must "
                        "be hashable; use a tuple")
