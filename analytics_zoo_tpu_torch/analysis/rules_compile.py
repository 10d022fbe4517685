"""Compile-ahead rules — builds reachable from serve/drain loops.

The serve loop swaps to an already-built rung, it never builds one: the
warm-up thread (``common/compile_ahead.py``, ``InferenceModel.warm_up``)
pays every first touch before traffic does. This rule keeps it that way.
Inside the loop of a dispatch/drain/serve/produce-named function, each
of these stalls the serve thread for seconds exactly when backlog is
highest:

- ``torch.compile`` / ``torch.jit.script`` / ``trace`` — a graph
  compile;
- a kernel build, ``ops._build.build`` / ``load`` — an ``nvcc`` run the
  first time a library is asked for;
- an autotune measurement, ``autotune.tune*`` / ``tune_pending`` /
  ``get_tuner().tune*`` — every candidate timed on the card;
- a CUDA-graph capture, ``torch.cuda.graph`` /
  ``make_graphed_callables`` / ``.capture_begin()``.

The warm-up path is exempt by design: code inside any ``*warm*``-named
function (``warm_up``, ``warm_decode``, ``_warm_rung``) is the sanctioned
home for builds, and a build with no enclosing hot loop (the first-call
path of a library) is not a finding.
"""

from __future__ import annotations

import ast
from typing import Iterable, Optional

from analytics_zoo_tpu_torch.analysis.core import (
    FileContext, Finding, Rule, ancestors, register,
)
from analytics_zoo_tpu_torch.analysis.rules_hotpath import (
    HOT_FN_TOKENS, _enclosing, _fn_tokens, _LOOPS, _nearest_function,
)
from analytics_zoo_tpu_torch.analysis.rules_jit import COMPILERS

_FUNCS = (ast.FunctionDef, ast.AsyncFunctionDef)

#: fully-resolved callables that capture a CUDA graph
_CAPTURES = frozenset({"torch.cuda.graph",
                       "torch.cuda.make_graphed_callables"})


def _in_warmup_code(node: ast.AST) -> bool:
    """True inside any ``*warm*``-named function — the sanctioned build
    path (warm_up / warm_decode / _warm_rung / worker closures whose
    enclosing function is warm-named)."""
    for a in ancestors(node):
        if isinstance(a, _FUNCS) and "warm" in a.name.lower():
            return True
    return False


def build_kind(ctx: FileContext, node: ast.Call) -> Optional[str]:
    """What a call builds on the spot, or None."""
    func = node.func
    name = ctx.imports.resolve(func)
    parts = name.split(".") if name else []
    if name in COMPILERS:
        return f"{name}() compiles a graph"
    if "_build" in parts[:-1] and parts[-1] in ("build", "load"):
        return f"{name}() builds a kernel library (nvcc)"
    if parts and (parts[-1] == "tune_pending" or (
            "autotune" in parts[:-1] and parts[-1].startswith("tune"))):
        return f"{name}() times autotune candidates on the card"
    if isinstance(func, ast.Attribute) and \
            func.attr.startswith("tune") and \
            isinstance(func.value, ast.Call) and \
            ctx.imports.resolve(func.value.func).endswith("get_tuner"):
        return f".{func.attr}() times autotune candidates on the card"
    if name in _CAPTURES:
        return f"{name}() captures a CUDA graph"
    if isinstance(func, ast.Attribute) and func.attr == "capture_begin":
        return ".capture_begin() captures a CUDA graph"
    return None


@register
class JitCompileInServeLoop(Rule):
    """A compile, kernel build, autotune measurement or CUDA-graph
    capture inside a serve/drain loop.

    In a hot-path package, such a call lexically inside a loop of a
    hot-named function (dispatch/drain/serve/produce/predict/fit/...)
    pays seconds on the latency-critical thread. Build it on the warm-up
    path instead (``InferenceModel.warm_up`` / ``warm_decode``,
    ``autotune.drain_after_warmup``) — warm-named functions are exempt."""

    id = "jit-compile-in-serve-loop"
    description = ("compile, kernel build, autotune or graph capture "
                   "inside a serve/drain loop")

    def check_file(self, ctx: FileContext) -> Iterable[Finding]:
        if not ctx.is_hot_path:
            return
        for node in ctx.walk():
            if not isinstance(node, ast.Call):
                continue
            what = build_kind(ctx, node)
            if what is None:
                continue
            fn = _nearest_function(node)
            if fn is None or not (_fn_tokens(fn.name) & HOT_FN_TOKENS):
                continue
            loops = [lp for lp in _enclosing(node, _LOOPS)
                     if _nearest_function(lp) is fn]
            if not loops:
                continue
            if _in_warmup_code(node):
                continue
            yield Finding(
                self.id, ctx.path, node.lineno, node.col_offset,
                f"{what} inside the `{fn.name}` loop — on the serve "
                "thread; do it on the warm-up path (warm_up / "
                "warm_decode) and swap to the result when ready")
