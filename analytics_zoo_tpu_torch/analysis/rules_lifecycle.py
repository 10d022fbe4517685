"""Resource-lifecycle rules — path-sensitive proofs over per-function
CFGs (analysis/core.py) that acquired resources settle on *every* path.

Four contracts, one engine:

* ``record-ack-leak`` — every entry dequeued from the broker
  (XREADGROUP/XCLAIM) or taken from an assembly bucket must reach
  exactly one settlement per loop iteration (an XACK append / ``xack``
  call, or a re-bin that keeps the record alive under its lease), and
  every list accumulating XACK commands must be flushed or escape on
  every path to function exit. This machine-checks the at-least-once
  delivery contract the serving engine's leases/redelivery design and
  the gen-kind push-back rest on.
* ``lock-release-path`` — a bare ``.acquire()`` must be matched by a
  ``.release()`` on every exit edge, exception edges included.
* ``span-pairing`` — paired enter/exit calls (``attach``/``detach``,
  ``add_hook``/``remove_hook``, ``arm``/``disarm``, ...) on the same
  receiver must balance on all paths when the function closes the pair
  at all; long-lived attaches (no matching exit anywhere in the
  function) are deliberately out of scope.
* ``kv-page-leak`` — KV pages taken from the shared decode pool
  (``.alloc_pages(...)`` bound to a local) must be freed or handed to a
  new owner on every path to every exit, the raise exit included. This
  machine-checks the paged-KV allocator contract the step-level decode
  scheduler rests on: a leaked page list shrinks the pool for
  every future admission, forever.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Set, Tuple

from analytics_zoo_tpu_torch.analysis.core import (
    CFG, FileContext, Finding, Rule, ancestors, dataflow, register,
    _is_lockish_expr,
)

_FUNCS = (ast.FunctionDef, ast.AsyncFunctionDef)
_LOOPS = (ast.For, ast.While, ast.AsyncFor)

#: mutator tails that move a value into a collection (set ``.add`` is
#: deliberately absent: dedupe-ring bookkeeping is not a settlement)
_BIN_MUTATORS = frozenset({"append", "appendleft", "extend", "extendleft"})

#: broker read calls whose result is a collection of leased entries
_OBTAIN_TAILS = frozenset({"xreadgroup", "xclaim"})

#: command tuples that settle a record's lease
_ACK_COMMANDS = frozenset({"XACK"})


def _functions(ctx: FileContext) -> Iterable[ast.AST]:
    for node in ctx.walk():
        if isinstance(node, _FUNCS):
            yield node


def _nearest_function(node: ast.AST) -> Optional[ast.AST]:
    for a in ancestors(node):
        if isinstance(a, _FUNCS):
            return a
    return None


def _nearest_loop(node: ast.AST) -> Optional[ast.AST]:
    for a in ancestors(node):
        if isinstance(a, _LOOPS):
            return a
        if isinstance(a, _FUNCS):
            return None
    return None


def _names_in(node: Optional[ast.AST]) -> Set[str]:
    if node is None:
        return set()
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def _stmt_blocks(cfg: CFG, ctx: FileContext, node: ast.AST) -> List[int]:
    """All CFG blocks carrying the statement that contains ``node`` —
    a ``finally`` statement owns one block per duplicated copy (normal,
    exceptional, and one per abrupt exit), and a settlement in any copy
    counts."""
    cur: Optional[ast.AST] = node
    while cur is not None:
        hits = cfg.blocks_of(cur)
        if hits:
            return list(hits)
        cur = getattr(cur, "_zl_parent", None)
    return []


def _stmt_block(cfg: CFG, ctx: FileContext, node: ast.AST) -> Optional[int]:
    """The first CFG block carrying the statement containing ``node``."""
    hits = _stmt_blocks(cfg, ctx, node)
    return hits[0] if hits else None


def _recv_text(expr: ast.AST) -> str:
    try:
        return ast.unparse(expr)
    except Exception:       # pragma: no cover - malformed receiver
        return ""


def _command_tuple(expr: ast.AST) -> Optional[str]:
    """The command word when ``expr`` is a broker command tuple literal
    like ``("XACK", stream, group, id)``."""
    if isinstance(expr, ast.Tuple) and expr.elts:
        head = expr.elts[0]
        if isinstance(head, ast.Constant) and isinstance(head.value, str) \
                and head.value.isupper():
            return head.value
    return None


# --------------------------------------------------------- record-ack-leak

class _LoopPlan:
    """Everything needed to solve one entry loop: its CFG blocks, the
    loop targets, derived/ack-valued locals, and the settlement blocks."""

    __slots__ = ("loop", "head", "after", "first_target", "derived",
                 "ack_vals", "settle_blocks", "complex")

    def __init__(self, loop: ast.AST):
        self.loop = loop
        self.head: int = -1
        self.after: int = -1
        self.first_target: str = ""
        self.derived: Set[str] = set()
        self.ack_vals: Set[str] = set()
        self.settle_blocks: Set[int] = set()
        self.complex = False


@register
class RecordAckLeak(Rule):
    """A dequeued record that neither acks nor re-bins on some path.

    Serving files only, and only functions that speak the ack protocol
    (mention ``"XACK"`` or call ``.xack``): for every loop over a
    broker-obtained entry collection, each iteration path must settle
    the entry exactly once — append its ack, re-bin the whole entry
    (value containing the entry-id loop target), or ``xack`` it
    directly. Separately, every local list accumulating XACK command
    tuples must be flushed (passed to a call — ``pipeline``,
    ``_mark_done``...) or escape (returned) on every path to exit; an
    ``if acks:`` truthiness guard is understood. Exception paths that
    propagate out of the function are *not* leaks — the lease/redelivery
    contract covers them — which keeps the rule quiet on code that lets
    errors escape to a supervised loop."""

    id = "record-ack-leak"
    description = "broker entry may exit a path un-acked and un-retained"

    def check_file(self, ctx: FileContext) -> Iterable[Finding]:
        if "serving" not in ctx.path.split("/")[:-1]:
            return
        for fn in _functions(ctx):
            if not self._has_ack_machinery(ctx, fn):
                continue
            yield from self._check_function(ctx, fn)

    @staticmethod
    def _has_ack_machinery(ctx: FileContext, fn: ast.AST) -> bool:
        for n in ctx.walk(fn):
            if isinstance(n, ast.Constant) and n.value in _ACK_COMMANDS:
                return True
            if isinstance(n, ast.Call) and \
                    isinstance(n.func, ast.Attribute) and \
                    n.func.attr == "xack":
                return True
        return False

    # ---------------------------------------------- entry collections
    def _entry_collections(self, ctx: FileContext,
                           fn: ast.AST) -> Tuple[Set[str], Set[str]]:
        """(local names, ``self.<attr>`` names) holding leased entries,
        by fixpoint over obtain calls, aliasing, slices, and re-bins."""
        locs: Set[str] = set()
        attrs: Set[str] = set()
        stmts = [n for n in ctx.walk(fn)]
        for _ in range(5):
            changed = False
            for n in stmts:
                if isinstance(n, ast.Assign) and len(n.targets) == 1:
                    tgt = n.targets[0]
                    if self._entryish(n.value, locs, attrs):
                        if isinstance(tgt, ast.Name) and tgt.id not in locs:
                            locs.add(tgt.id)
                            changed = True
                        elif isinstance(tgt, ast.Attribute) and \
                                isinstance(tgt.value, ast.Name) and \
                                tgt.value.id == "self" and \
                                tgt.attr not in attrs:
                            attrs.add(tgt.attr)
                            changed = True
                elif isinstance(n, ast.Call) and \
                        isinstance(n.func, ast.Attribute) and \
                        n.func.attr in _BIN_MUTATORS and len(n.args) == 1:
                    # a collection receiving whole records re-binned out
                    # of a tracked entry loop is an entry collection too
                    if not self._rebin_value(n.args[0], locs, attrs):
                        continue
                    recv = n.func.value
                    if isinstance(recv, ast.Name) and recv.id not in locs:
                        locs.add(recv.id)
                        changed = True
                    elif isinstance(recv, ast.Attribute) and \
                            isinstance(recv.value, ast.Name) and \
                            recv.value.id == "self" and \
                            recv.attr not in attrs:
                        attrs.add(recv.attr)
                        changed = True
            if not changed:
                break
        return locs, attrs

    def _entryish(self, expr: ast.AST, locs: Set[str],
                  attrs: Set[str]) -> bool:
        """Does ``expr`` evaluate to an entry collection (or part of
        one)? Obtain calls, tracked names/attrs, slices and
        concatenations of them."""
        if isinstance(expr, ast.Call):
            f = expr.func
            if isinstance(f, ast.Attribute):
                if f.attr in _OBTAIN_TAILS:
                    return True
                if f.attr in ("popleft", "pop") and \
                        self._entryish(f.value, locs, attrs):
                    return True
            return False
        if isinstance(expr, ast.Name):
            return expr.id in locs
        if isinstance(expr, ast.Attribute):
            return isinstance(expr.value, ast.Name) and \
                expr.value.id == "self" and expr.attr in attrs
        if isinstance(expr, ast.Subscript):
            return self._entryish(expr.value, locs, attrs)
        if isinstance(expr, ast.BinOp) and isinstance(expr.op, ast.Add):
            return self._entryish(expr.left, locs, attrs) or \
                self._entryish(expr.right, locs, attrs)
        return False

    def _rebin_value(self, expr: ast.AST, locs: Set[str],
                     attrs: Set[str]) -> bool:
        """A non-command value built from a *tracked* entry loop's
        targets — i.e. a whole record moving between collections."""
        if _command_tuple(expr) is not None:
            return False
        loop = _nearest_loop(expr)
        if loop is None or not isinstance(loop, (ast.For, ast.AsyncFor)):
            return False
        if not self._entryish(loop.iter, locs, attrs):
            return False
        first = self._first_target(loop)
        return bool(first) and first in _names_in(expr)

    @staticmethod
    def _first_target(loop: ast.AST) -> str:
        tgt = loop.target
        while isinstance(tgt, (ast.Tuple, ast.List)) and tgt.elts:
            tgt = tgt.elts[0]
        return tgt.id if isinstance(tgt, ast.Name) else ""

    # --------------------------------------------- per-iteration check
    def _check_function(self, ctx: FileContext,
                        fn: ast.AST) -> Iterable[Finding]:
        locs, attrs = self._entry_collections(ctx, fn)
        loops = []
        for n in ctx.walk(fn):
            if isinstance(n, (ast.For, ast.AsyncFor)) and \
                    _nearest_function(n) is fn and \
                    self._consuming_iter(n.iter, locs):
                loops.append(n)
        ack_lists = self._ack_lists(ctx, fn)
        if not loops and not ack_lists:
            return
        cfg = ctx.cfg(fn)
        for loop in loops:
            yield from self._solve_loop(ctx, fn, cfg, loop)
        for name, first_line in sorted(ack_lists.items()):
            yield from self._solve_flush(ctx, fn, cfg, name, first_line)

    def _consuming_iter(self, it: ast.AST, locs: Set[str]) -> bool:
        """Loops over *local* entry collections consume their records;
        iterating ``self._asm`` directly is a read-only peek."""
        if isinstance(it, ast.Name):
            return it.id in locs
        if isinstance(it, ast.Subscript):
            return self._consuming_iter(it.value, locs)
        return False

    def _plan(self, ctx: FileContext, fn: ast.AST, cfg: CFG,
              loop: ast.AST) -> Optional[_LoopPlan]:
        plan = _LoopPlan(loop)
        heads = cfg.blocks_of(loop)
        if not heads:
            return None
        plan.head = heads[0]
        exits = [d for d, k in cfg.block(plan.head).succs if k == "false"]
        plan.after = exits[0] if exits else -1
        plan.first_target = self._first_target(loop)
        if not plan.first_target:
            return None
        # derived locals + ack-valued locals, by fixpoint over the body
        body_stmts = [n for n in ctx.walk(loop)
                      if isinstance(n, ast.Assign) and len(n.targets) == 1
                      and isinstance(n.targets[0], ast.Name)
                      and _nearest_function(n) is fn]
        plan.derived = set(_names_in(loop.target))
        for _ in range(4):
            grew = False
            for a in body_stmts:
                tname = a.targets[0].id
                if tname in plan.derived:
                    continue
                if _names_in(a.value) & plan.derived:
                    plan.derived.add(tname)
                    if _command_tuple(a.value) in _ACK_COMMANDS:
                        plan.ack_vals.add(tname)
                    grew = True
            if not grew:
                break
        # settlement statements → blocks
        for n in ctx.walk(loop):
            if not (isinstance(n, ast.Call) and
                    isinstance(n.func, ast.Attribute)):
                continue
            kind = self._settles(n, plan)
            if kind is None:
                continue
            if _nearest_loop(n) is not loop:
                # a settlement in a nested loop settles 0..n times per
                # outer iteration — counting would lie either way
                plan.complex = True
                return plan
            plan.settle_blocks.update(_stmt_blocks(cfg, ctx, n))
        return plan

    def _settles(self, call: ast.Call, plan: _LoopPlan) -> Optional[str]:
        attr = call.func.attr
        if attr == "xack":
            args: Set[str] = set()
            for a in call.args:
                args |= _names_in(a)
            if plan.first_target in args or args & plan.derived:
                return "ack"
            return None
        if attr not in _BIN_MUTATORS or len(call.args) != 1:
            return None
        val = call.args[0]
        cmd = _command_tuple(val)
        if cmd is not None:
            return "ack" if cmd in _ACK_COMMANDS else None
        if isinstance(val, ast.Name) and val.id in plan.ack_vals:
            return "ack"
        if plan.first_target in _names_in(val):
            return "rebin"
        return None

    def _solve_loop(self, ctx: FileContext, fn: ast.AST, cfg: CFG,
                    loop: ast.AST) -> Iterable[Finding]:
        plan = self._plan(ctx, fn, cfg, loop)
        if plan is None or plan.complex or not plan.settle_blocks:
            # zero settlement statements at all: a transform/peek loop,
            # not a consume loop — the flush check still applies
            return
        head, after = plan.head, plan.after
        bottom: frozenset = frozenset()

        def transfer(block, fact):
            if block.idx in plan.settle_blocks:
                return frozenset(min(c + 1, 2) for c in fact)
            return fact

        def edge_fn(src, kind, fact):
            if src.idx == head and kind == "true":
                return frozenset((0,))      # fresh iteration
            return fact

        facts = dataflow(cfg, transfer, init=frozenset((0,)),
                         bottom=bottom, join=lambda a, b: a | b,
                         edge_fn=edge_fn)
        iter_ends: List[int] = []
        for b in cfg.blocks:
            for dst, kind in b.succs:
                if dst == head and kind in ("back", "continue"):
                    iter_ends.append(b.idx)
                elif dst == after and kind == "break":
                    iter_ends.append(b.idx)
                elif kind == "return" and \
                        isinstance(b.stmt, ast.Return) and \
                        _nearest_loop(b.stmt) is loop:
                    iter_ends.append(b.idx)
        leak = doubled = False
        for b in iter_ends:
            out = transfer(cfg.block(b), facts.get(b, bottom))
            leak = leak or 0 in out
            doubled = doubled or 2 in out
        it_name = _recv_text(loop.iter)
        if leak:
            yield Finding(
                self.id, ctx.path, loop.lineno, loop.col_offset,
                f"a record dequeued from `{it_name}` can finish a loop "
                "iteration without being acked or re-binned on some path "
                "— every leased entry must settle exactly once (ack it, "
                "append it to a bucket, or push it back)")
        if doubled:
            yield Finding(
                self.id, ctx.path, loop.lineno, loop.col_offset,
                f"a record dequeued from `{it_name}` settles more than "
                "once on some path (e.g. acked and re-binned) — it would "
                "be double-served or double-acked")

    # ------------------------------------------------- ack-list flush
    def _ack_lists(self, ctx: FileContext, fn: ast.AST) -> Dict[str, int]:
        """Locals born as ``[]``/``list()`` that accumulate XACK command
        tuples → first ack-append line."""
        born: Set[str] = set()
        for n in ctx.walk(fn):
            if isinstance(n, ast.Assign) and len(n.targets) == 1 and \
                    isinstance(n.targets[0], ast.Name):
                v = n.value
                if (isinstance(v, ast.List) and not v.elts) or \
                        (isinstance(v, ast.Call) and
                         isinstance(v.func, ast.Name) and
                         v.func.id == "list" and not v.args):
                    born.add(n.targets[0].id)
        out: Dict[str, int] = {}
        for n in ctx.walk(fn):
            if isinstance(n, ast.Call) and \
                    isinstance(n.func, ast.Attribute) and \
                    n.func.attr in _BIN_MUTATORS and \
                    isinstance(n.func.value, ast.Name) and \
                    n.func.value.id in born and len(n.args) == 1:
                v = n.args[0]
                acky = _command_tuple(v) in _ACK_COMMANDS
                if not acky and isinstance(v, ast.Name):
                    acky = any(
                        isinstance(a, ast.Assign) and
                        len(a.targets) == 1 and
                        isinstance(a.targets[0], ast.Name) and
                        a.targets[0].id == v.id and
                        _command_tuple(a.value) in _ACK_COMMANDS
                        for a in ctx.walk(fn) if isinstance(a, ast.Assign))
                if acky:
                    name = n.func.value.id
                    out.setdefault(name, n.lineno)
        return out

    def _solve_flush(self, ctx: FileContext, fn: ast.AST, cfg: CFG,
                     name: str, first_line: int) -> Iterable[Finding]:
        gen_blocks: Set[int] = set()
        kill_blocks: Set[int] = set()
        for n in ctx.walk(fn):
            if isinstance(n, ast.Call):
                if isinstance(n.func, ast.Attribute) and \
                        n.func.attr in _BIN_MUTATORS and \
                        isinstance(n.func.value, ast.Name) and \
                        n.func.value.id == name:
                    gen_blocks.update(_stmt_blocks(cfg, ctx, n))
                elif any(name in _names_in(a) for a in n.args) or \
                        any(name in _names_in(k.value) for k in n.keywords):
                    # flushed / handed off
                    kill_blocks.update(_stmt_blocks(cfg, ctx, n))
            elif isinstance(n, (ast.Return, ast.Yield)) and \
                    name in _names_in(getattr(n, "value", None)):
                # escapes to caller
                kill_blocks.update(_stmt_blocks(cfg, ctx, n))
        if not gen_blocks:
            return
        kill_blocks -= gen_blocks

        def transfer(block, fact):
            if block.idx in kill_blocks:
                return frozenset((0,))
            if block.idx in gen_blocks:
                return frozenset((1,))
            return fact

        def edge_fn(src, kind, fact):
            # `if acks:` — the false edge proves the list is empty
            test = None
            if src.label in ("branch", "loop-head") and \
                    isinstance(src.stmt, (ast.If, ast.While)):
                test = src.stmt.test
            if test is None:
                return fact
            plain, negated = self._truthiness_names(test)
            if kind == "false" and name in plain:
                return frozenset((0,))
            if kind == "true" and name in negated:
                return frozenset((0,))
            return fact

        facts = dataflow(cfg, transfer, init=frozenset((0,)),
                         bottom=frozenset(), join=lambda a, b: a | b,
                         edge_fn=edge_fn)
        if 1 in facts.get(cfg.exit, frozenset()):
            yield Finding(
                self.id, ctx.path, first_line, 0,
                f"ack list `{name}` can reach the end of "
                f"`{getattr(fn, 'name', '?')}` without being flushed or "
                "returned on some path — those XACKs would be dropped "
                "and the entries redelivered forever")

    @staticmethod
    def _truthiness_names(test: ast.AST) -> Tuple[Set[str], Set[str]]:
        """(names whose falsiness the false edge proves, names whose
        falsiness the true edge proves) for ``if a or b:`` / ``if not
        a:`` shaped tests."""
        plain: Set[str] = set()
        negated: Set[str] = set()
        leaves = test.values if isinstance(test, ast.BoolOp) and \
            isinstance(test.op, ast.Or) else [test]
        for leaf in leaves:
            if isinstance(leaf, ast.Name):
                plain.add(leaf.id)
            elif isinstance(leaf, ast.UnaryOp) and \
                    isinstance(leaf.op, ast.Not) and \
                    isinstance(leaf.operand, ast.Name):
                negated.add(leaf.operand.id)
        if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not) \
                and isinstance(test.operand, ast.Name):
            negated.add(test.operand.id)
        return plain, negated


# ----------------------------------------------- exit-coverage analyses

def _must_do_before_exit(ctx: FileContext, cfg: CFG, site: ast.AST,
                         done_blocks: Set[int]) -> bool:
    """True when every path from ``site``'s normal successors to any
    exit — the raise exit included — passes a ``done`` block. Backward
    reach-avoid: a block's fact says "an exit is reachable from my exit
    without doing it"."""

    def transfer(block, fact):
        return False if block.idx in done_blocks else fact

    facts = dataflow(cfg, transfer, init=True, bottom=False,
                     join=lambda a, b: a or b, backward=True)
    b = _stmt_block(cfg, ctx, site)
    if b is None:
        return True
    for dst, kind in cfg.block(b).succs:
        if kind == "exc":
            continue        # the acquire itself raising holds nothing
        if transfer(cfg.block(dst), facts.get(dst, False)):
            return False
    return True


def _matching_calls(ctx: FileContext, fn: ast.AST, attr: str,
                    recv: str) -> List[ast.Call]:
    out = []
    for n in ctx.walk(fn):
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute) \
                and n.func.attr == attr \
                and _recv_text(n.func.value) == recv \
                and _nearest_function(n) is fn:
            out.append(n)
    return out


@register
class LockReleasePath(Rule):
    """A bare ``.acquire()`` that some path never releases.

    Expression-statement ``acquire()`` calls on lockish receivers
    (``*lock*``, ``*sem*``, ``*cond*``...) must reach a ``.release()``
    on the same receiver on every path to every exit — the raise exit
    included, so an unguarded call between acquire and release is
    itself a finding. Acquires whose result is assigned/tested
    (``if not lock.acquire(timeout=...):``) are skipped; ``with lock:``
    never fires. Fix: use ``with``, or release in ``finally``."""

    id = "lock-release-path"
    description = "explicit lock acquire without release on every path"

    def check_file(self, ctx: FileContext) -> Iterable[Finding]:
        for fn in _functions(ctx):
            sites = []
            for n in ctx.walk(fn):
                if isinstance(n, ast.Expr) and isinstance(n.value, ast.Call) \
                        and isinstance(n.value.func, ast.Attribute) \
                        and n.value.func.attr == "acquire" \
                        and _is_lockish_expr(n.value.func.value) \
                        and _nearest_function(n) is fn:
                    sites.append(n)
            if not sites:
                continue
            cfg = ctx.cfg(fn)
            for site in sites:
                recv = _recv_text(site.value.func.value)
                done: Set[int] = set()
                for rel in _matching_calls(ctx, fn, "release", recv):
                    done.update(_stmt_blocks(cfg, ctx, rel))
                if _must_do_before_exit(ctx, cfg, site, done):
                    continue
                yield Finding(
                    self.id, ctx.path, site.lineno, site.col_offset,
                    f"`{recv}.acquire()` is not matched by "
                    f"`{recv}.release()` on every exit path (an exception "
                    "or early return leaves it held) — use `with "
                    f"{recv}:` or release in a `finally`")


#: call tails that take pages out of a shared KV pool
_KV_ALLOC_TAILS = frozenset({"alloc_pages"})


@register
class KvPageLeak(Rule):
    """KV pages allocated from the shared pool that some path strands.

    For every ``x = <pool>.alloc_pages(...)`` binding, each path from
    the allocation to each function exit — the raise exit included —
    must settle ownership of ``x``: free it back (``free_pages(x)``),
    hand it to a new owner (``x`` passed to any call — a cache
    constructor, an ``extend`` — or stored into object/collection state
    via an attribute/subscript assignment), or return/yield it to the
    caller. An unguarded early return or an unprotected call between
    the alloc and the settlement is itself a finding — the fix is a
    ``try/except: free_pages(x); raise`` around the handoff (the
    scheduler's admission path is the reference shape). A leaked page
    list never rejoins the free list, shrinking the pool for every
    future admission."""

    id = "kv-page-leak"
    description = "allocated KV pages may exit a path unfreed and unowned"

    def check_file(self, ctx: FileContext) -> Iterable[Finding]:
        for fn in _functions(ctx):
            sites = []
            for n in ctx.walk(fn):
                if isinstance(n, ast.Assign) and len(n.targets) == 1 \
                        and isinstance(n.targets[0], ast.Name) \
                        and isinstance(n.value, ast.Call) \
                        and isinstance(n.value.func, ast.Attribute) \
                        and n.value.func.attr in _KV_ALLOC_TAILS \
                        and _nearest_function(n) is fn:
                    sites.append(n)
            if not sites:
                continue
            cfg = ctx.cfg(fn)
            for site in sites:
                name = site.targets[0].id
                done = self._settle_blocks(ctx, fn, cfg, site, name)
                if _must_do_before_exit(ctx, cfg, site, done):
                    continue
                yield Finding(
                    self.id, ctx.path, site.lineno, site.col_offset,
                    f"pages allocated into `{name}` can reach a function "
                    "exit without being freed or handed off on some path "
                    "(an early return or an exception between the "
                    "alloc_pages and its settlement) — free them in an "
                    "except/finally or move the handoff adjacent to the "
                    "allocation")

    @staticmethod
    def _settle_blocks(ctx: FileContext, fn: ast.AST, cfg: CFG,
                       site: ast.AST, name: str) -> Set[int]:
        """Blocks where ownership of ``name`` settles: the pages are
        freed, passed to any call (handoff — the callee owns them now),
        stored into attribute/subscript state, or escape via
        return/yield."""
        done: Set[int] = set()
        for n in ctx.walk(fn):
            if _nearest_function(n) is not fn or n is site:
                continue
            if isinstance(n, ast.Call):
                if any(name in _names_in(a) for a in n.args) or \
                        any(name in _names_in(k.value)
                            for k in n.keywords):
                    done.update(_stmt_blocks(cfg, ctx, n))
            elif isinstance(n, (ast.Return, ast.Yield)) and \
                    name in _names_in(getattr(n, "value", None)):
                done.update(_stmt_blocks(cfg, ctx, n))
            elif isinstance(n, ast.Assign) and \
                    any(isinstance(t, (ast.Attribute, ast.Subscript))
                        for t in n.targets) and \
                    name in _names_in(n.value):
                done.update(_stmt_blocks(cfg, ctx, n))
        return done


#: enter-call tail -> exit-call tail for paired lifecycle calls
_SPAN_PAIRS = {
    "attach": "detach", "add_hook": "remove_hook", "arm": "disarm",
    "register": "unregister", "subscribe": "unsubscribe",
    "start_span": "end_span",
}


@register
class SpanPairing(Rule):
    """An enter/exit call pair that some path leaves unbalanced.

    For each expression-statement enter call (``attach``, ``add_hook``,
    ``arm``, ``register``, ``subscribe``, ``start_span``) whose matching
    exit call on the *same receiver* exists somewhere in the function,
    every path from the enter to every exit — exceptions included — must
    pass the exit call. Functions that attach without ever detaching
    (process-lifetime hooks like ``get_flight_recorder``) are out of
    scope by construction. Fix: move the exit call to a ``finally`` or
    wrap the pair in a context manager."""

    id = "span-pairing"
    description = "enter/exit pair unbalanced on some path"

    def check_file(self, ctx: FileContext) -> Iterable[Finding]:
        for fn in _functions(ctx):
            sites = []
            for n in ctx.walk(fn):
                if isinstance(n, ast.Expr) and isinstance(n.value, ast.Call) \
                        and isinstance(n.value.func, ast.Attribute) \
                        and n.value.func.attr in _SPAN_PAIRS \
                        and _nearest_function(n) is fn:
                    sites.append(n)
            if not sites:
                continue
            cfg = None
            for site in sites:
                enter = site.value.func.attr
                exit_attr = _SPAN_PAIRS[enter]
                recv = _recv_text(site.value.func.value)
                exits = _matching_calls(ctx, fn, exit_attr, recv)
                if not exits:
                    continue        # long-lived attach: not our contract
                if cfg is None:
                    cfg = ctx.cfg(fn)
                done: Set[int] = set()
                for x in exits:
                    done.update(_stmt_blocks(cfg, ctx, x))
                if _must_do_before_exit(ctx, cfg, site, done):
                    continue
                yield Finding(
                    self.id, ctx.path, site.lineno, site.col_offset,
                    f"`{recv}.{enter}()` is not balanced by "
                    f"`{recv}.{exit_attr}()` on every path to function "
                    "exit (an exception or early return skips it) — pair "
                    "them in a `finally` or a context manager")
