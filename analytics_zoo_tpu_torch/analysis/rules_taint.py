"""PyTorch hot-path dataflow rules — device-value taint over
per-function CFGs plus the compiled-region closure on the ProjectModel
call graph.

* ``tainted-host-sync`` — values produced by a module call, a compiled
  or ``instrument_jit``-wrapped callable, a ``*_fn`` apply parameter, a
  copy to the card (``.to(device)`` / ``.cuda()``), a ``torch`` factory
  given ``device=`` or one of the port's kernel wrappers (``ops.*``)
  live on the card; converting one to host (``.item()``/``.tolist()``/
  ``.cpu()``/``.numpy()``/``.to("cpu")``/``float``/``int``/``bool``/
  ``np.asarray``) or branching on it inside a serve/decode/fit loop is
  an implicit host↔device sync per iteration. This is the *dataflow*
  sibling of the lexical ``hotpath-host-sync`` rule: it follows the
  value, so it fires in helpers the lexical rule's hot-name heuristic
  misses, and it catches implicit truthiness (``if y:``) the lexical
  rule cannot see.
* ``shape-dependent-branch-in-jit`` — python ``if``/``while`` on traced
  values inside a compiled body (a function given to ``torch.compile`` /
  ``torch.jit.script`` / ``trace``, a function run under a
  ``torch.cuda.graph`` capture, or anything the call graph says it
  reaches): a value test breaks the graph (or bakes one side into a
  capture), and a test on ``.shape``/``len()`` compiles one graph per
  shape — the recompile hazard class the runtime's compile counter only
  reports after the fact.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Set, Tuple

from analytics_zoo_tpu_torch.analysis.core import (
    CFG, FileContext, Finding, HOT_PATH_SEGMENTS, ProjectContext, Rule,
    ancestors, dataflow, module_name, register,
)
from analytics_zoo_tpu_torch.analysis.rules_hotpath import (
    CONVERTERS, HOT_FN_TOKENS, SYNC_METHODS, to_host,
)
from analytics_zoo_tpu_torch.analysis.rules_jit import (
    COMPILERS, is_jit_constructor,
)

_FUNCS = (ast.FunctionDef, ast.AsyncFunctionDef)
_LOOPS = (ast.For, ast.While, ast.AsyncFor)

#: callee tails that wrap a callable in the port's recompile accounting
_JIT_TAILS = frozenset({"instrument_jit"})
#: fully-resolved callables that capture a CUDA graph around a callable
_GRAPH_CAPTURES = frozenset({"torch.cuda.make_graphed_callables"})

#: packages whose files carry serve/decode/fit hot loops — the lexical
#: hot-path set plus inference/ (the decode loop lives there)
_TAINT_SEGMENTS = HOT_PATH_SEGMENTS | {"inference"}

#: host copies by resolved name (the converters of the lexical rule)
_HOST_COPIES = frozenset({"numpy.asarray", "numpy.array"})
#: value-reading methods of the lexical rule (``synchronize`` reads none)
_VALUE_METHODS = SYNC_METHODS - {"synchronize"}
#: local names that conventionally hold an ``nn.Module`` — calling one is
#: a forward on the card (as ``*_fn`` names a jitted apply in JAX)
_MODULE_NAMES = ("model", "module", "net")


def _nearest_function(node: ast.AST) -> Optional[ast.AST]:
    for a in ancestors(node):
        if isinstance(a, _FUNCS):
            return a
    return None


def _in_loop_of(node: ast.AST, fn: ast.AST) -> bool:
    for a in ancestors(node):
        if a is fn:
            return False
        if isinstance(a, _LOOPS):
            return True
    return False


def _names_in(node: Optional[ast.AST]) -> Set[str]:
    if node is None:
        return set()
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def _target_names(tgt: ast.AST) -> Set[str]:
    return {n.id for n in ast.walk(tgt)
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Store)}


def _is_module_name(name: str) -> bool:
    low = name.lower()
    return low in _MODULE_NAMES or any(
        low.endswith("_" + m) for m in _MODULE_NAMES)


def _device_arg(call: ast.Call) -> Optional[ast.AST]:
    if call.args:
        return call.args[0]
    return next((kw.value for kw in call.keywords if kw.arg == "device"),
                None)


def _moves_to_card(ctx: FileContext, call: ast.Call) -> bool:
    """``t.cuda()``, or ``t.to(dev)`` whose target is neither the host
    nor a dtype (``t.to(torch.float32)`` moves nothing)."""
    f = call.func
    if not isinstance(f, ast.Attribute):
        return False
    if f.attr == "cuda":
        return True
    if f.attr != "to" or to_host(ctx, call):
        return False
    dev = _device_arg(call)
    if dev is None:
        return False
    if isinstance(dev, ast.Attribute):
        name = ctx.imports.resolve(dev)
        if name.startswith("torch.") and name != "torch.device":
            return False                      # torch.float32, torch.int8
    return True


def _factory_on_card(ctx: FileContext, call: ast.Call,
                     name: str) -> bool:
    """A ``torch`` factory given a ``device=`` that is not the host."""
    if not name.startswith("torch."):
        return False
    for kw in call.keywords:
        if kw.arg == "device":
            v = kw.value
            return not (isinstance(v, ast.Constant) and v.value == "cpu")
    return False


def _kernel_wrapper(name: str) -> bool:
    """One of the port's kernel wrappers: a callable of an ``ops``
    package (``ops.flash_attention.flash_attention``, ``pa.paged_gather``
    after ``from ...ops import paged_attention as pa``)."""
    parts = name.split(".") if name else []
    return len(parts) > 1 and parts[0] != "torch" and "ops" in parts[:-1]


def _fn_tokens(name: str) -> Set[str]:
    return {t for t in name.lower().split("_") if t}


def source_call(ctx: FileContext, call: ast.Call,
                bound: Set[str] = frozenset()) -> bool:
    """Whether ``call`` yields a value on the card. ``bound`` are the
    function's locals bound to a compiled callable or an ``nn.X(...)``
    module, and the file's compiled functions."""
    f = call.func
    if isinstance(f, ast.Name):
        # the conventional apply parameter (predict_fn, step_fn,
        # apply_fn...) and module holder (model, net, *_module) — card
        # out unless proven otherwise
        if f.id in bound or f.id.endswith("_fn") or _is_module_name(f.id):
            return True
    elif isinstance(f, ast.Attribute):
        if f.attr == "forward" or _is_module_name(f.attr):
            return True                       # self.model(x), m.forward(x)
        if _moves_to_card(ctx, call):
            return True
    name = ctx.imports.resolve(f)
    return bool(name) and (_factory_on_card(ctx, call, name)
                           or _kernel_wrapper(name))


class _TaintScan:
    """Per-function taint facts: which locals may hold device values at
    each CFG block entry."""

    def __init__(self, ctx: FileContext, fn: ast.AST,
                 jit_locals: Set[str], jit_fns: Set[str],
                 module_locals: Set[str]):
        self.ctx = ctx
        self.fn = fn
        self.jit_locals = jit_locals    # locals bound to torch.compile(f)
        self.jit_fns = jit_fns          # file-level compiled function names
        self.module_locals = module_locals  # locals bound to nn.X(...)
        self.cfg: CFG = ctx.cfg(fn)
        self.facts = dataflow(
            self.cfg, self._transfer, init=frozenset(),
            bottom=frozenset(), join=lambda a, b: a | b)

    # ------------------------------------------------------- sources
    def source_call(self, call: ast.Call) -> bool:
        return source_call(self.ctx, call, self.jit_locals | self.jit_fns
                           | self.module_locals)

    def expr_tainted(self, expr: Optional[ast.AST],
                     tainted: frozenset) -> bool:
        if expr is None:
            return False
        for n in ast.walk(expr):
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load) \
                    and n.id in tainted:
                return True
            if isinstance(n, ast.Call) and self.source_call(n):
                return True
        return False

    # ------------------------------------------------------ transfer
    def _transfer(self, block, fact):
        s = block.stmt
        if s is None:
            return fact
        if isinstance(s, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            targets = s.targets if isinstance(s, ast.Assign) else [s.target]
            names: Set[str] = set()
            for t in targets:
                names |= _target_names(t)
            value = getattr(s, "value", None)
            rhs = self.expr_tainted(value, fact) or (
                isinstance(s, ast.AugAssign) and
                any(n in fact for n in names))
            return fact | names if rhs else fact - names
        if block.label == "loop-head" and \
                isinstance(s, (ast.For, ast.AsyncFor)):
            names = _target_names(s.target)
            if self.expr_tainted(s.iter, fact):
                return fact | names
            return fact - names
        return fact

    def fact_at(self, node: ast.AST) -> frozenset:
        cur: Optional[ast.AST] = node
        while cur is not None:
            hits = self.cfg.blocks_of(cur)
            if hits:
                return self.facts.get(hits[0], frozenset())
            cur = getattr(cur, "_zl_parent", None)
        return frozenset()


@register
class TaintedHostSync(Rule):
    """A card value synced to host inside a hot loop, found by taint.

    Tracks values produced by module calls (``y = self.model(x)``,
    ``net.forward(x)``, a local bound to ``nn.X(...)``), compiled or
    ``instrument_jit``-wrapped callables (``step = torch.compile(f)``
    then ``y = step(x)``), ``*_fn`` apply parameters, copies to the card
    (``x.to(dev)``, ``x.cuda()``), ``torch`` factories given ``device=``
    and the port's kernel wrappers (``ops.*``) through assignments, and
    flags host conversions (``.item()``/``.tolist()``/``.cpu()``/
    ``.numpy()``/``.to("cpu")``/``float``/``int``/``bool``/
    ``np.asarray``) and implicit truthiness (``if y:``) on them inside a
    loop. Syncs the lexical ``hotpath-host-sync`` rule already owns
    (hot-named function in a hot package) are skipped, so one defect
    reports once."""

    id = "tainted-host-sync"
    description = "device-tainted value forced to host inside a loop"

    def check_file(self, ctx: FileContext) -> Iterable[Finding]:
        if not (_TAINT_SEGMENTS & set(ctx.path.split("/")[:-1])):
            return
        jit_fns = {n.name for n in ctx.walk() if isinstance(n, _FUNCS)
                   and any(self._jit_decorator(ctx, d, _JIT_TAILS)
                           for d in n.decorator_list)}
        for fn in (n for n in ctx.walk() if isinstance(n, _FUNCS)):
            if not any(isinstance(n, _LOOPS) for n in ctx.walk(fn)):
                continue                    # every sink sits in a loop
            jit_locals, module_locals = set(), set()
            for n in ctx.walk(fn):
                if isinstance(n, ast.Assign) and len(n.targets) == 1 \
                        and isinstance(n.targets[0], ast.Name) \
                        and isinstance(n.value, ast.Call):
                    if is_jit_constructor(ctx, n.value):
                        jit_locals.add(n.targets[0].id)
                    elif self._module_constructor(ctx, n.value):
                        module_locals.add(n.targets[0].id)
            bound = jit_locals | jit_fns | module_locals
            if bound or any(isinstance(n, ast.Call) and
                            source_call(ctx, n) for n in ctx.walk(fn)):
                scan = _TaintScan(ctx, fn, jit_locals, jit_fns,
                                  module_locals)
                yield from self._sinks(ctx, fn, scan)

    @staticmethod
    def _module_constructor(ctx: FileContext, call: ast.Call) -> bool:
        name = ctx.imports.resolve(call.func)
        parts = name.split(".") if name else []
        return parts[:2] == ["torch", "nn"] and len(parts) > 2 and \
            parts[-1][:1].isupper()

    @staticmethod
    def _jit_decorator(ctx: FileContext, dec: ast.AST,
                       tails=_JIT_TAILS) -> bool:
        """``@torch.compile`` / ``@torch.compile(...)`` /
        ``@torch.jit.script`` / ``@partial(torch.compile, ...)``, and
        ``@<mod>.<tail>`` for ``tails``."""
        target = dec.func if isinstance(dec, ast.Call) else dec
        name = ctx.imports.resolve(target)
        parts = name.split(".") if name else []
        if name in COMPILERS or (len(parts) > 1 and parts[-1] in tails):
            return True
        if parts and parts[-1] == "partial" and isinstance(dec, ast.Call) \
                and dec.args:
            inner = ctx.imports.resolve(dec.args[0])
            ip = inner.split(".") if inner else []
            return inner in COMPILERS or (len(ip) > 1 and ip[-1] in tails)
        return False

    def _sinks(self, ctx: FileContext, fn: ast.AST,
               scan: _TaintScan) -> Iterable[Finding]:
        lexical_owns = ctx.is_hot_path and \
            bool(_fn_tokens(fn.name) & HOT_FN_TOKENS)
        for node in ctx.walk(fn):
            if _nearest_function(node) is not fn:
                continue
            if isinstance(node, ast.Call):
                label, method = self._sync_label(ctx, node)
                if label is None or not _in_loop_of(node, fn):
                    continue
                if lexical_owns:
                    continue        # hotpath-host-sync reports this one
                fact = scan.fact_at(node)
                if self._call_tainted(node, scan, fact, method):
                    yield Finding(
                        self.id, ctx.path, node.lineno, node.col_offset,
                        f"{label} on a device-tainted value inside the "
                        f"`{fn.name}` loop forces a host sync per "
                        "iteration — keep the value on the card or fence "
                        "it outside the loop")
            elif isinstance(node, (ast.If, ast.While)) and \
                    _in_loop_of(node, fn):
                fact = scan.fact_at(node)
                if self._branch_tainted(node.test, scan, fact):
                    yield Finding(
                        self.id, ctx.path, node.lineno, node.col_offset,
                        "branching on a device-tainted value inside the "
                        f"`{fn.name}` loop is an implicit host sync per "
                        "iteration — compute the predicate on host or "
                        "use torch.where")

    @staticmethod
    def _sync_label(ctx: FileContext,
                    node: ast.Call) -> Tuple[Optional[str], bool]:
        """(human label, is-method-sink) — every label is one the
        lexical rule also matches."""
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr in _VALUE_METHODS \
                and not node.args and not node.keywords:
            return f".{f.attr}()", True
        if to_host(ctx, node):
            return '.to("cpu")', True
        name = ctx.imports.resolve(f)
        if name in _HOST_COPIES or (
                name and name.split(".")[-1] == "traced_device_get"):
            return f"{name}()", False
        if name in CONVERTERS and len(node.args) == 1 and \
                not isinstance(node.args[0], ast.Constant):
            return f"{name}()", False
        return None, False

    @staticmethod
    def _call_tainted(node: ast.Call, scan: _TaintScan,
                      fact: frozenset, method: bool) -> bool:
        if method:                          # .item()/.cpu()/.to("cpu")
            return scan.expr_tainted(node.func.value, fact)
        return any(scan.expr_tainted(a, fact) for a in node.args)

    @staticmethod
    def _branch_tainted(test: ast.AST, scan: _TaintScan,
                        fact: frozenset) -> bool:
        """Bare truthiness / comparison on a tainted value — not
        ``is``/``isinstance`` checks (static at trace time)."""
        if isinstance(test, ast.Name):
            return test.id in fact
        if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
            return TaintedHostSync._branch_tainted(test.operand, scan, fact)
        if isinstance(test, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot)) for op in test.ops):
                return False
            return scan.expr_tainted(test, fact)
        if isinstance(test, ast.BoolOp):
            return any(TaintedHostSync._branch_tainted(v, scan, fact)
                       for v in test.values)
        return False


# ----------------------------------------- shape-dependent-branch-in-jit

class _JitEntry:
    __slots__ = ("qual",)

    def __init__(self, qual: str):
        self.qual = qual


def _capture_calls(ctx: FileContext) -> Set[int]:
    """ids of the calls made inside a ``with torch.cuda.graph(g):``
    body — each callee runs under the capture."""
    out: Set[int] = set()
    for node in ctx.walk():
        if not isinstance(node, (ast.With, ast.AsyncWith)):
            continue
        if not any(isinstance(it.context_expr, ast.Call) and
                   ctx.imports.resolve(it.context_expr.func) ==
                   "torch.cuda.graph" for it in node.items):
            continue
        for stmt in node.body:
            out.update(id(n) for n in ctx.walk(stmt)
                       if isinstance(n, ast.Call))
    return out


@register
class ShapeBranchInJit(Rule):
    """Python branching on traced values/shapes inside a compiled body.

    Compiled entries are functions decorated ``@torch.compile`` /
    ``@torch.compile(...)`` / ``@torch.jit.script`` /
    ``@partial(torch.compile, ...)``, passed to ``torch.compile`` /
    ``torch.jit.script`` / ``trace`` or ``make_graphed_callables``, or
    called inside a ``with torch.cuda.graph(g):`` capture; the compiled
    *region* is their call-graph closure on the ProjectModel (a helper
    called from a compiled body is traced too). Inside the region, an
    ``if``/``while`` whose test reads a traced parameter (every parameter
    at entries — PyTorch has no static-argument descriptor; arguments fed
    from traced caller values in helpers) either breaks the graph and
    syncs (value test; under a capture one side is baked in) or
    compiles one graph per shape (``.shape`` / ``len()`` test — the
    silent recompile hazard). ``is``/``is not``, ``isinstance`` and
    ``hasattr`` tests are static and exempt. Fix: ``torch.where`` /
    ``torch.cond`` for values; mark the dimension dynamic or branch
    outside the compiled region for shapes."""

    id = "shape-dependent-branch-in-jit"
    scope = "project"
    description = "python branch on a traced value/shape inside a " \
        "compiled region"

    def check_project(self, pctx: ProjectContext) -> Iterable[Finding]:
        model = pctx.model()
        entries = self._entries(pctx, model)
        if not entries:
            return
        region = model.reachable(entries)
        tainted = self._region_taint(model, entries, region)
        for qual in sorted(region):
            fn = model.functions.get(qual)
            if fn is None or fn.node is None or fn.is_test:
                continue
            yield from self._branches(fn, tainted.get(qual, frozenset()))

    # ------------------------------------------------------- entries
    def _entries(self, pctx: ProjectContext,
                 model) -> Dict[str, _JitEntry]:
        entries: Dict[str, _JitEntry] = {}
        for fn in model.functions.values():
            node = fn.node
            if node is None or not isinstance(node, _FUNCS):
                continue
            # instrument_jit wraps an eager callable: not a traced body
            if any(TaintedHostSync._jit_decorator(fn.ctx, dec, ())
                   for dec in node.decorator_list):
                entries[fn.qual] = _JitEntry(fn.qual)
        # functions handed to a compiler or a graph capture:
        # step = torch.compile(f), torch.cuda.make_graphed_callables(f, ..)
        for ctx in pctx.files:
            mod = module_name(ctx.path)
            for call in (n for n in ctx.walk()
                         if isinstance(n, ast.Call)):
                name = ctx.imports.resolve(call.func)
                if name not in COMPILERS and \
                        name not in _GRAPH_CAPTURES or not call.args:
                    continue
                arg = call.args[0]
                if not isinstance(arg, (ast.Name, ast.Attribute)):
                    continue
                r = model.resolve_dotted(ctx.imports.resolve(arg), mod)
                if r is None or r[0] != "func" or r[1].node is None:
                    continue
                entries[r[1].qual] = _JitEntry(r[1].qual)
        # callees of the calls made under a torch.cuda.graph capture
        captured: Set[int] = set()
        for ctx in pctx.files:
            captured |= _capture_calls(ctx)
        if captured:
            for _caller, callee, node, _held in model.call_sites:
                if node is not None and id(node) in captured:
                    cfn = model.functions.get(callee)
                    if cfn is not None and cfn.node is not None:
                        entries.setdefault(callee, _JitEntry(callee))
        return entries

    # -------------------------------------------------- region taint
    def _region_taint(self, model, entries: Dict[str, _JitEntry],
                      region: Set[str]) -> Dict[str, frozenset]:
        """Tainted (traced) local names per region function: non-static
        params at entries, call-site-fed params in helpers, closed over
        assignments — a bounded worklist over the call graph."""
        tainted: Dict[str, Set[str]] = {}
        for qual in entries:
            fn = model.functions.get(qual)
            if fn is None or fn.node is None:
                continue
            tainted[qual] = {
                p for p in self._param_names(fn.node)
                if p not in ("self", "cls")}
        for _ in range(4):
            changed = False
            # intraprocedural closure over straight-line assignments
            for qual in list(tainted):
                fn = model.functions.get(qual)
                if fn is None or fn.node is None:
                    continue
                t = tainted[qual]
                for n in fn.ctx.walk(fn.node):
                    if isinstance(n, ast.Assign) and \
                            _names_in(n.value) & t:
                        for tg in n.targets:
                            new = _target_names(tg) - t
                            if new:
                                t |= new
                                changed = True
            # interprocedural: traced args taint helper params
            for caller, callee, node, _held in model.call_sites:
                if caller not in tainted or callee not in region or \
                        not isinstance(node, ast.Call):
                    continue
                cfn = model.functions.get(callee)
                if cfn is None or cfn.node is None:
                    continue
                params = self._param_names(cfn.node)
                offset = 1 if params[:1] in (["self"], ["cls"]) and \
                    isinstance(node.func, ast.Attribute) else 0
                tset = tainted[caller]
                dst = tainted.setdefault(callee, set())
                for i, a in enumerate(node.args):
                    if _names_in(a) & tset and i + offset < len(params):
                        if params[i + offset] not in dst:
                            dst.add(params[i + offset])
                            changed = True
                for kw in node.keywords:
                    if kw.arg and _names_in(kw.value) & tset and \
                            kw.arg in params and kw.arg not in dst:
                        dst.add(kw.arg)
                        changed = True
            if not changed:
                break
        return {q: frozenset(v) for q, v in tainted.items()}

    @staticmethod
    def _param_names(node: ast.AST) -> List[str]:
        a = node.args
        return [p.arg for p in
                list(a.posonlyargs) + list(a.args) + list(a.kwonlyargs)]

    # ------------------------------------------------------ branches
    def _branches(self, fn, tainted: frozenset) -> Iterable[Finding]:
        if not tainted:
            return
        for node in fn.ctx.walk(fn.node):
            if not isinstance(node, (ast.If, ast.While)):
                continue
            if _nearest_function(node) is not fn.node:
                continue
            kind = self._test_kind(node.test, tainted)
            if kind is None:
                continue
            if kind == "shape":
                msg = ("python branch on the shape of a traced value "
                       f"inside compiled `{fn.name}` — one graph is "
                       "compiled per shape; mark the dimension dynamic "
                       "or branch outside the compiled region")
            else:
                msg = ("python branch on a traced value inside compiled "
                       f"`{fn.name}` — the graph breaks and syncs here "
                       "(a capture bakes one side in); use torch.where "
                       "/ torch.cond")
            yield Finding(self.id, fn.ctx.path, node.lineno,
                          node.col_offset, msg)

    @staticmethod
    def _test_kind(test: ast.AST, tainted: frozenset) -> Optional[str]:
        kind: Optional[str] = None
        for n in ast.walk(test):
            if isinstance(n, ast.Call):
                f = n.func
                nm = f.id if isinstance(f, ast.Name) else \
                    f.attr if isinstance(f, ast.Attribute) else ""
                if nm in ("isinstance", "hasattr", "getattr", "callable"):
                    return None
                if nm == "len" and n.args and \
                        _names_in(n.args[0]) & tainted:
                    kind = "shape"
            if isinstance(n, ast.Compare) and all(
                    isinstance(op, (ast.Is, ast.IsNot)) for op in n.ops):
                # `x is None` on an optional param: static when traced
                shadow = _names_in(n)
                tainted = tainted - shadow
            if isinstance(n, ast.Attribute) and \
                    n.attr in ("shape", "ndim", "size") and \
                    _names_in(n.value) & tainted:
                kind = "shape"
        if kind == "shape":
            return kind
        leaves = {x.id for x in ast.walk(test)
                  if isinstance(x, ast.Name) and x.id in tainted}
        if leaves:
            return "value"
        return None
