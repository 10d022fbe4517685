"""Interprocedural lock-discipline rules (zoolint v2).

``lock-order-inversion`` runs cycle detection over the *global*
lock-acquisition graph — edges come both from syntactic ``with`` nesting
and from held-lock propagation through the call graph, so an ABBA pair
split across ``serving/engine.py`` and ``common/fleet.py`` is caught.
Pure same-file syntactic nesting is left to the per-file ``lock-order``
rule (no double report).

``blocking-under-lock`` flags a blocking call (socket ops, ``join``,
``time.sleep``, a device wait, future ``.result()``, event ``.wait()``,
broker RPC) made while a *contended* lock is held — one that at least
two thread roots acquire — because the block then stalls every thread
queued on that lock, serve loop included. The device waits are PyTorch's
(``torch.cuda.synchronize``, ``traced_device_get``, and the argument-less
``.item()`` / ``.tolist()`` / ``.cpu()`` / ``.synchronize()`` that
``rules_hotpath`` reads too, in a module that imports torch) and JAX's
(``block_until_ready``, ``jax.device_get``), so the rule reads both
packages' trees alike.
"""

from __future__ import annotations

import ast
from typing import Iterable, Optional

from analytics_zoo_tpu_torch.analysis.core import (
    Finding, ProjectContext, Rule, _is_lockish_expr, register,
)

_SOCKET_METHODS = frozenset({"recv", "recv_into", "accept", "sendall",
                             "connect"})
#: argument-less methods that wait for the card or copy a tensor to the
#: host (a tensor's ``.item()``, an event's ``.synchronize()``), read in
#: a module that imports torch: elsewhere ``.item()`` / ``.tolist()`` are
#: numpy's or pandas', on the host
_DEVICE_WAIT_METHODS = frozenset({"item", "tolist", "cpu", "synchronize"})


def _imports_torch(imports) -> bool:
    return any(name == "torch" or name.startswith("torch.")
               for name in imports.names.values())


def _num_const(node) -> bool:
    return isinstance(node, ast.Constant) and \
        isinstance(node.value, (int, float)) and \
        not isinstance(node.value, bool)


def _blocking_desc(call: ast.Call, fn, model) -> Optional[str]:
    d = fn.ctx.imports.resolve(call.func)
    if d == "time.sleep":
        return "time.sleep"
    if d and (d.endswith(".block_until_ready") or d == "jax.device_get"
              or d == "torch.cuda.synchronize"
              or d.rsplit(".", 1)[-1] == "traced_device_get"):
        return d if d.startswith("torch.") else d.rsplit(".", 1)[-1]
    if not isinstance(call.func, ast.Attribute):
        return None
    attr = call.func.attr
    base = call.func.value
    if attr in _DEVICE_WAIT_METHODS and not call.args \
            and not call.keywords and _imports_torch(fn.ctx.imports):
        return f".{attr}()"
    if attr in _SOCKET_METHODS:
        return f"socket .{attr}()"
    if attr == "join":
        # thread/process join only: zero args or a numeric timeout —
        # str.join takes an iterable positional
        if d and d.startswith("os.path"):
            return None
        if isinstance(base, ast.Constant):
            return None
        timeout_kw = any(kw.arg == "timeout" for kw in call.keywords)
        if not call.args and not call.keywords:
            return ".join()"
        if timeout_kw or (len(call.args) == 1 and _num_const(call.args[0])):
            return ".join()"
        return None
    if attr == "wait" and not _is_lockish_expr(base):
        return ".wait()"
    if attr == "result" and not call.args:
        return ".result()"
    # any method on a BrokerClient-typed receiver is a socket round-trip
    recv_t = None
    if isinstance(base, ast.Name):
        recv_t = fn.local_types.get(base.id)
    elif isinstance(base, ast.Attribute) and \
            isinstance(base.value, ast.Name) and \
            base.value.id == "self" and fn.cls is not None:
        recv_t = model._attr_type(fn.cls, base.attr)
    if recv_t and recv_t.endswith(".BrokerClient"):
        return f"broker RPC .{attr}()"
    return None


def _lock_short(lock: str) -> str:
    parts = lock.split(".")
    return ".".join(parts[-2:]) if len(parts) >= 2 else lock


@register
class LockOrderInversion(Rule):
    id = "lock-order-inversion"
    scope = "project"
    description = ("two locks acquired in both orders across the global "
                   "(interprocedural, cross-file) acquisition graph")

    def check_project(self, pctx: ProjectContext) -> Iterable[Finding]:
        model = pctx.model()
        edges = model.lock_edges
        done = set()
        reported_locks = set()
        for (a, b) in sorted(edges):
            if (a, b) in done or (b, a) not in edges:
                continue
            done.add((a, b))
            done.add((b, a))
            pa, la, ia = edges[(a, b)]
            pb, lb, ib = edges[(b, a)]
            if pa == pb and not ia and not ib:
                # same-file syntactic nesting — the per-file lock-order
                # rule owns that report
                continue
            (path, line), other = max(((pa, la), (pb, lb))), \
                min(((pa, la), (pb, lb)))
            reported_locks.update((a, b))
            yield Finding(
                self.id, path, line, 0,
                f"locks '{_lock_short(a)}' and '{_lock_short(b)}' are "
                f"taken in both orders — here and via {other[0]}:"
                f"{other[1]} — an ABBA deadlock across the call graph; "
                f"pick one order and hold to it")
        # longer cycles (A->B->C->A) with no internal two-cycle
        for cyc in _cycles(edges):
            if len(cyc) < 3 or reported_locks.intersection(cyc):
                continue
            first = min(cyc)
            i = cyc.index(first)
            cyc = cyc[i:] + cyc[:i]
            nxt = cyc[1]
            path, line, _ = edges[(first, nxt)]
            chain = " -> ".join(_lock_short(x) for x in cyc + [cyc[0]])
            reported_locks.update(cyc)
            yield Finding(
                self.id, path, line, 0,
                f"lock-acquisition cycle {chain} — a deadlock once all "
                f"{len(cyc)} locks are contended; break one edge")


def _cycles(edges):
    """Simple cycles in the lock graph (Tarjan SCCs; each SCC of >=3
    nodes is reported as one cycle along existing edges)."""
    adj = {}
    for a, b in edges:
        adj.setdefault(a, set()).add(b)
        adj.setdefault(b, set())
    index, low, on, stack = {}, {}, set(), []
    out, counter = [], [0]

    def strongconnect(v):
        index[v] = low[v] = counter[0]
        counter[0] += 1
        stack.append(v)
        on.add(v)
        for w in sorted(adj.get(v, ())):
            if w not in index:
                strongconnect(w)
                low[v] = min(low[v], low[w])
            elif w in on:
                low[v] = min(low[v], index[w])
        if low[v] == index[v]:
            comp = []
            while True:
                w = stack.pop()
                on.discard(w)
                comp.append(w)
                if w == v:
                    break
            if len(comp) >= 3:
                out.append(_order_cycle(comp, adj))

    for v in sorted(adj):
        if v not in index:
            strongconnect(v)
    return [c for c in out if c]


def _order_cycle(comp, adj):
    """Walk the SCC along real edges to present a concrete cycle."""
    comp_set = set(comp)
    start = min(comp)
    path, seen = [start], {start}
    cur = start
    while True:
        nxts = [w for w in sorted(adj.get(cur, ()))
                if w in comp_set and w not in seen]
        back = [w for w in adj.get(cur, ()) if w == start]
        if back and len(path) >= 3:
            return path
        if not nxts:
            return path if len(path) >= 3 and start in adj.get(cur, ()) \
                else []
        cur = nxts[0]
        path.append(cur)
        seen.add(cur)


@register
class BlockingUnderLock(Rule):
    id = "blocking-under-lock"
    scope = "project"
    description = ("blocking call (socket/join/sleep/block_until_ready/"
                   "broker RPC) while holding a lock contended by >=2 "
                   "thread roots")

    def check_project(self, pctx: ProjectContext) -> Iterable[Finding]:
        model = pctx.model()
        for funcq in sorted(model.calls_in):
            fn = model.functions.get(funcq)
            if fn is None:
                continue
            may = model.may_held.get(funcq, frozenset())
            for call in model.calls_in[funcq]:
                desc = _blocking_desc(call, fn, model)
                if desc is None:
                    continue
                held = model._held_at(call, fn) | may
                contended = [L for L in sorted(held)
                             if len(model.lock_roots.get(L, ())) >= 2]
                if not contended:
                    continue
                lock = contended[0]
                who = ", ".join(sorted(model.lock_roots.get(lock, ())))
                yield Finding(
                    self.id, fn.ctx.path, call.lineno, call.col_offset,
                    f"blocking call ({desc}) while holding "
                    f"'{_lock_short(lock)}', a lock also taken from "
                    f"({who}) — the block stalls every thread queued on "
                    f"it; move the blocking call outside the critical "
                    f"section")
