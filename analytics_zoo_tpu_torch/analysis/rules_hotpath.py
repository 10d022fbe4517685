"""Hot-path sync rules — wall-clock timing and implicit host↔device
synchronization in the serve/dispatch/train inner loops.

A single accidental host round-trip inside a dispatch loop (``.item()``,
``.cpu()``, ``float(tensor)``, ``np.asarray``, ``torch.cuda.synchronize``)
serializes the host against the card's queue and erases the overlap the
pipelined serve and fit loops were built for: the host waits for every
kernel queued before it, once per iteration.
"""

from __future__ import annotations

import ast
from typing import Iterable, List

from analytics_zoo_tpu_torch.analysis.core import (
    FileContext, Finding, Rule, ancestors, register,
)

#: wall-clock constructors banned from hot-path packages (stage stats and
#: deadlines must ride perf_counter/monotonic — NTP slew corrupts both)
_WALLCLOCK = frozenset({
    "time.time", "datetime.datetime.now", "datetime.datetime.utcnow",
    "datetime.datetime.today", "datetime.date.today",
})

#: function-name tokens that mark a dispatch/drain/step loop owner — the
#: loops inside these are the latency-critical inner loops
HOT_FN_TOKENS = frozenset({
    "dispatch", "drain", "step", "serve", "retire", "submit", "produce",
    "finish", "fetch", "run", "predict", "fit", "loop",
})

#: zero-argument methods that copy a tensor to the host or wait for the
#: card (``t.item()``, ``t.cpu()``, ``event.synchronize()``...)
SYNC_METHODS = frozenset({"item", "tolist", "cpu", "numpy", "synchronize"})
#: callee final components that force a host sync wherever they resolve
#: from (telemetry.traced_device_get, bare imports...)
_SYNC_TAILS = frozenset({"traced_device_get"})
#: fully-resolved names that force a host copy of their argument or wait
#: for the card
_SYNC_CALLS = frozenset({"numpy.asarray", "numpy.array",
                         "torch.cuda.synchronize"})
#: builtins that read a tensor's value on the host
CONVERTERS = frozenset({"float", "int", "bool"})

_LOOPS = (ast.For, ast.While, ast.AsyncFor, ast.ListComp, ast.SetComp,
          ast.DictComp, ast.GeneratorExp)
_FUNCS = (ast.FunctionDef, ast.AsyncFunctionDef)

#: identifiers in an ``if`` test that mark a deliberate, rate-limited
#: fence (the profiler's sampled steps) — sampled syncs are the design
_SAMPLING_MARKERS = ("sample", "prof")


def _fn_tokens(name: str) -> set:
    return set(t for t in name.lower().split("_") if t)


def _enclosing(node: ast.AST, kinds) -> List[ast.AST]:
    return [a for a in ancestors(node) if isinstance(a, kinds)]


def _nearest_function(node: ast.AST):
    for a in ancestors(node):
        if isinstance(a, _FUNCS):
            return a
    return None


def _test_identifiers(test: ast.AST) -> Iterable[str]:
    for n in ast.walk(test):
        if isinstance(n, ast.Name):
            yield n.id
        elif isinstance(n, ast.Attribute):
            yield n.attr


def _sampling_guarded(node: ast.AST, stop_at: ast.AST) -> bool:
    """True when an ``if`` between ``node`` and its function mentions a
    sampling/profiling identifier — the fence is intentional and bounded
    (StepProfiler.should_sample, tracer.should_sample...)."""
    for a in ancestors(node):
        if a is stop_at:
            return False
        if isinstance(a, ast.If) and any(
                any(m in ident.lower() for m in _SAMPLING_MARKERS)
                for ident in _test_identifiers(a.test)):
            return True
    return False


@register
class WallclockHotpath(Rule):
    """``time.time()`` / ``datetime.now()`` in serving/, common/, learn/.

    Wall-clock stamps there corrupt stage stats, deadlines and rate
    limiters under NTP slew — use ``time.perf_counter()`` (intervals) or
    ``time.monotonic()`` (deadlines). Legitimate wall-clock uses (event
    timestamps, dump filenames, checkpoint metadata) carry
    ``# zoolint: disable=wallclock-hotpath``."""

    id = "wallclock-hotpath"
    description = "wall-clock timing in a hot-path package"

    def check_file(self, ctx: FileContext) -> Iterable[Finding]:
        if not ctx.is_hot_path:
            return
        for node in ctx.walk():
            if not isinstance(node, ast.Call):
                continue
            name = ctx.imports.resolve(node.func)
            if name in _WALLCLOCK:
                yield Finding(
                    self.id, ctx.path, node.lineno, node.col_offset,
                    f"{name}() in a hot-path package — use "
                    "time.perf_counter() for intervals or "
                    "time.monotonic() for deadlines")


@register
class HotpathHostSync(Rule):
    """Implicit host↔device sync inside a dispatch/drain/step loop.

    Flags ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
    ``.to("cpu")``, ``torch.cuda.synchronize`` and an event's or stream's
    ``.synchronize()``, ``float``/``int``/``bool`` of a non-literal,
    ``np.asarray``/``np.array`` and ``traced_device_get`` calls that sit
    lexically inside a loop of a hot-named function
    (dispatch/drain/serve/produce/finish/fetch/run/predict/fit/...)
    in a hot-path package. Each one forces the host to wait for the
    card per iteration — exactly what the bounded in-flight window
    exists to avoid. Fence off-loop, fetch via the pipeline's drain, or
    guard with a sampling predicate (an ``if`` mentioning
    ``*sample*``/``*prof*`` is recognized)."""

    id = "hotpath-host-sync"
    description = "implicit device sync inside a hot dispatch loop"

    def check_file(self, ctx: FileContext) -> Iterable[Finding]:
        if not ctx.is_hot_path:
            return
        for node in ctx.walk():
            if not isinstance(node, ast.Call):
                continue
            label = sync_label(ctx, node)
            if label is None:
                continue
            fn = _nearest_function(node)
            if fn is None or not (_fn_tokens(fn.name) & HOT_FN_TOKENS):
                continue
            loops = [lp for lp in _enclosing(node, _LOOPS)
                     if _nearest_function(lp) is fn]
            if not loops:
                continue
            if _sampling_guarded(node, fn):
                continue
            yield Finding(
                self.id, ctx.path, node.lineno, node.col_offset,
                f"{label} inside the `{fn.name}` loop forces a host sync "
                "per iteration — hoist it out of the loop, use the "
                "pipeline drain, or guard it with a sampling predicate")


def _is_cpu_device(ctx: FileContext, expr: ast.AST) -> bool:
    """``"cpu"`` or ``torch.device("cpu")``."""
    if isinstance(expr, ast.Constant):
        return expr.value == "cpu"
    if isinstance(expr, ast.Call) and \
            ctx.imports.resolve(expr.func) == "torch.device" and \
            expr.args and isinstance(expr.args[0], ast.Constant):
        return expr.args[0].value == "cpu"
    return False


def to_host(ctx: FileContext, node: ast.Call) -> bool:
    """``t.to("cpu")`` / ``t.to(device="cpu")`` — a copy to the host."""
    func = node.func
    if not (isinstance(func, ast.Attribute) and func.attr == "to"):
        return False
    dev = node.args[0] if node.args else next(
        (kw.value for kw in node.keywords if kw.arg == "device"), None)
    return dev is not None and _is_cpu_device(ctx, dev)


def sync_label(ctx: FileContext, node: ast.Call):
    """A label for a call that syncs the host with the card, else None."""
    func = node.func
    name = ctx.imports.resolve(func)
    if isinstance(func, ast.Attribute) and func.attr in SYNC_METHODS \
            and not node.args and not node.keywords:
        return f"{name}()" if name in _SYNC_CALLS else f".{func.attr}()"
    if to_host(ctx, node):
        return '.to("cpu")'
    if name and (name.split(".")[-1] in _SYNC_TAILS
                 or name in _SYNC_CALLS):
        return f"{name}()"
    if name in CONVERTERS and len(node.args) == 1 \
            and not isinstance(node.args[0], ast.Constant):
        return f"{name}(<non-literal>)"
    return None
