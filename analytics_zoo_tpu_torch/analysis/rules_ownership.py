"""Interprocedural thread-ownership rules (zoolint v2).

Built on :class:`core.ProjectModel` — the project-wide call graph with
thread-root inference and runs-on propagation — so unlike the per-file
``engine-unlocked-write`` rule these see races that span modules: a
heartbeat thread in ``common/fleet.py`` reading an attribute the main
thread writes in ``serving/engine.py``, a module global mutated from the
shard pool, a non-daemon thread nobody joins.

A class may declare thread-confinement by contract in its docstring
("Not thread-safe", "thread-confined", "single-threaded"); its instance
attributes are then single-owner by design and never flagged — the
ownership report lists the class as confined-by-contract instead.
"""

from __future__ import annotations

from typing import Iterable

from analytics_zoo_tpu_torch.analysis.core import (
    Finding, ProjectContext, Rule, register,
)


def _short(key: str) -> str:
    """module.Class.attr -> Class.attr, module.GLOBAL -> GLOBAL."""
    parts = key.split(".")
    return ".".join(parts[-2:]) if len(parts) >= 2 else key


@register
class CrossThreadUnlockedState(Rule):
    id = "cross-thread-unlocked-state"
    scope = "project"
    description = ("instance attr / module global written without a lock "
                   "while reachable from >=2 thread roots (interprocedural)")

    def check_project(self, pctx: ProjectContext) -> Iterable[Finding]:
        model = pctx.model()
        for key in sorted(model.state):
            owner_cls = model.classes.get(key.rsplit(".", 1)[0])
            if owner_cls is not None and owner_cls.confined_by_contract:
                continue
            roots = model.state_roots(key)
            if len(roots) < 2:
                continue
            kind = "instance attr" if owner_cls is not None \
                else "module global"
            for acc in model.state.get(key, ()):
                if not acc.write or model.effective_locked(acc):
                    continue
                if not model.runs_on.get(acc.func):
                    continue   # dead code — no root reaches the writer
                fn = model.functions[acc.func]
                yield Finding(
                    self.id, fn.ctx.path, acc.node.lineno,
                    acc.node.col_offset,
                    f"{kind} '{_short(key)}' is written here without a "
                    f"lock but is reachable from {len(roots)} thread "
                    f"roots ({', '.join(sorted(roots))}) — guard the "
                    f"write with a lock or confine the state to one "
                    f"thread")


@register
class ThreadLeak(Rule):
    id = "thread-leak"
    scope = "project"
    description = ("Thread.start() with neither daemon=True nor a "
                   "reachable join() — leaks on shutdown")

    def check_project(self, pctx: ProjectContext) -> Iterable[Finding]:
        model = pctx.model()
        for sp in model.spawns:
            if sp.kind != "thread" or sp.func.is_test:
                continue
            if sp.daemon or not sp.started or sp.joined or sp.escapes:
                continue
            what = sp.target.rsplit(".", 1)[-1] if sp.target else "target"
            yield Finding(
                self.id, sp.func.ctx.path, sp.node.lineno,
                sp.node.col_offset,
                f"thread running '{what}' is started with neither "
                f"daemon=True nor a reachable join() — it outlives its "
                f"owner and blocks interpreter shutdown; mark it daemon "
                f"or join it on the stop path")
