"""zoolint core — per-file AST rule engine with inline suppressions.

The invariants the last three PRs rest on (no wall-clock in hot paths, no
implicit host syncs inside dispatch loops, no per-call compile construction,
locked engine shared state, a docs catalog that matches the registry) were
enforced by code review plus one brittle grep. This package turns them
into first-class static analysis: every rule is an AST visitor with a
stable id, findings carry ``path:line:col``, and any finding can be
silenced in place (``# zoolint: disable=RULE``) or grandfathered in the
committed baseline (see baseline.py) — so the clean-tree invariant is
``exit 0`` in CI, not tribal knowledge.

Two rule scopes:

- **file** rules see one parsed module at a time (``check_file``);
- **project** rules see every scanned file at once plus the repo root
  (``check_project``) — the catalog-drift checks that compare code
  against docs/observability.md live there.
"""

from __future__ import annotations

import ast
import hashlib
import os
import re
from collections import deque
from dataclasses import dataclass, field
from typing import (Any, Callable, Dict, Iterable, List, Optional, Sequence,
                    Set, Tuple)

#: path segments whose files count as hot-path (the serve/dispatch/train
#: inner loops) — hot-path-only rules look at these trees exclusively
HOT_PATH_SEGMENTS = frozenset({"serving", "common", "learn"})

_DISABLE_LINE = re.compile(
    r"#\s*zoolint:\s*disable(?:=(?P<rules>[\w,\- ]+))?")
_DISABLE_FILE = re.compile(
    r"#\s*zoolint:\s*disable-file=(?P<rules>[\w,\- ]+)")


@dataclass(frozen=True)
class Finding:
    """One rule violation at a source location. ``path`` is repo-relative
    posix so findings (and baseline fingerprints) are machine-portable."""

    rule: str
    path: str
    line: int
    col: int
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule}: " \
               f"{self.message}"


class _ParentAnnotator(ast.NodeVisitor):
    """Stamp ``_zl_parent`` on every node — rules walk ancestor chains
    (enclosing loop / function / ``with`` / ``if``) constantly."""

    def generic_visit(self, node):
        for child in ast.iter_child_nodes(node):
            child._zl_parent = node  # type: ignore[attr-defined]
        super().generic_visit(node)


def ancestors(node: ast.AST) -> Iterable[ast.AST]:
    cur = getattr(node, "_zl_parent", None)
    while cur is not None:
        yield cur
        cur = getattr(cur, "_zl_parent", None)


class ImportMap:
    """Local name -> qualified dotted name, from a module's imports.

    ``resolve(call.func)`` turns an AST callee into its dotted origin
    (``np.asarray`` -> ``numpy.asarray``, bare ``compile`` after ``from
    torch import compile`` -> ``torch.compile``) so rules match on
    canonical names, not on whatever alias a file picked."""

    def __init__(self, tree: ast.AST):
        self.names: Dict[str, str] = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    self.names[a.asname or a.name.split(".")[0]] = \
                        a.name if a.asname else a.name.split(".")[0]
            elif isinstance(node, ast.ImportFrom) and node.module \
                    and node.level == 0:
                for a in node.names:
                    self.names[a.asname or a.name] = \
                        f"{node.module}.{a.name}"

    def resolve(self, func: ast.AST) -> str:
        """Dotted name of a callee ('' when it isn't a plain name chain)."""
        parts: List[str] = []
        cur = func
        while isinstance(cur, ast.Attribute):
            parts.append(cur.attr)
            cur = cur.value
        if not isinstance(cur, ast.Name):
            return ""
        root = self.names.get(cur.id, cur.id)
        return ".".join([root] + list(reversed(parts)))


@dataclass
class FileContext:
    """Everything a file rule sees: parsed AST (parent-annotated), source
    lines, repo-relative path, import resolution, and hot-path flag."""

    path: str                    # repo-relative, posix separators
    source: str
    tree: ast.AST
    lines: List[str] = field(default_factory=list)
    imports: ImportMap = None  # type: ignore[assignment]
    _order: Optional[List[ast.AST]] = None
    _span: Optional[Dict[int, Tuple[int, int]]] = None
    _cfg_cache: Optional[Dict[int, Tuple[str, "CFG"]]] = None

    def __post_init__(self):
        self.lines = self.source.splitlines()
        if self.imports is None:
            self.imports = ImportMap(self.tree)

    def _index(self):
        """DFS pre-order of every node plus each node's subtree extent —
        built once, so repeated tree walks (model build + every file
        rule) are list iterations, not fresh ast.walk() traversals."""
        order: List[ast.AST] = []
        span: Dict[int, Tuple[int, int]] = {}
        stack: List[Tuple[ast.AST, bool]] = [(self.tree, False)]
        while stack:
            node, done = stack.pop()
            if done:
                start = span[id(node)][0]
                span[id(node)] = (start, len(order))
                continue
            span[id(node)] = (len(order), 0)
            order.append(node)
            stack.append((node, True))
            for child in reversed(list(ast.iter_child_nodes(node))):
                stack.append((child, False))
        self._order, self._span = order, span

    def walk(self, node: Optional[ast.AST] = None) -> List[ast.AST]:
        """All nodes under ``node`` (default: the whole module), node
        itself first. Equivalent node set to ``ast.walk`` (pre-order
        rather than breadth-first), served from the cached index."""
        if self._order is None:
            self._index()
        if node is None or node is self.tree:
            return self._order
        ext = self._span.get(id(node))
        if ext is None:                # node not from this tree
            return list(ast.walk(node))
        return self._order[ext[0]:ext[1]]

    @property
    def is_hot_path(self) -> bool:
        return bool(HOT_PATH_SEGMENTS
                    & set(self.path.split("/")[:-1]))

    def line_text(self, line: int) -> str:
        return self.lines[line - 1] if 0 < line <= len(self.lines) else ""

    def func_hash(self, func: ast.AST) -> str:
        """v2 normalized-statement hash of a function's source extent —
        the CFG cache validator. Same normalization as the baseline v2
        fingerprints (comments stripped, whitespace collapsed), so a
        comment/formatting edit does not invalidate a cached CFG."""
        from analytics_zoo_tpu_torch.analysis import baseline as _baseline
        lo = getattr(func, "lineno", 1)
        hi = getattr(func, "end_lineno", lo) or lo
        parts = []
        for ln in range(lo, hi + 1):
            text = " ".join(_baseline._strip_comment(
                self.line_text(ln)).split())
            if text:
                parts.append(text)
        digest = hashlib.sha256("\n".join(parts).encode("utf-8"))
        return digest.hexdigest()[:16]

    def cfg(self, func: ast.AST) -> "CFG":
        """The control-flow graph of ``func``, memoized per file and
        keyed by the v2 normalized-statement hash: every path-sensitive
        rule scanning this file shares one build per function body."""
        if self._cfg_cache is None:
            self._cfg_cache = {}
        fhash = self.func_hash(func)
        hit = self._cfg_cache.get(id(func))
        if hit is not None and hit[0] == fhash:
            CFG_STATS["hits"] += 1
            return hit[1]
        CFG_STATS["built"] += 1
        graph = CFG(func)
        self._cfg_cache[id(func)] = (fhash, graph)
        return graph


@dataclass
class ProjectContext:
    """What project rules see: every FileContext plus the repo root (for
    docs/ lookups). ``root`` may be None when no repo root was found —
    root-dependent rules then skip themselves."""

    files: List[FileContext]
    root: Optional[str]
    _model: Optional["ProjectModel"] = None

    def model(self) -> "ProjectModel":
        """The whole-program model (symbol table, call graph, thread
        roots, lock discipline) — built once per scan, shared by every
        interprocedural rule and the ownership report."""
        if self._model is None:
            self._model = ProjectModel(self.files)
        return self._model


class Rule:
    """Base rule. Subclasses set ``id`` (the stable suppression/baseline
    key), ``scope`` ('file' | 'project'), and override the matching
    ``check_*``. Rule ids are kebab-case and documented in
    docs/zoolint.md."""

    id: str = ""
    scope: str = "file"
    description: str = ""

    def check_file(self, ctx: FileContext) -> Iterable[Finding]:
        return ()

    def check_project(self, pctx: ProjectContext) -> Iterable[Finding]:
        return ()


_RULES: "Dict[str, Rule]" = {}


def register(rule_cls):
    """Class decorator: instantiate and add to the global rule registry
    (import-time, like pytest plugins — rules_*.py modules just need to
    be imported)."""
    rule = rule_cls()
    if not rule.id:
        raise ValueError(f"{rule_cls.__name__} has no id")
    if rule.id in _RULES:
        raise ValueError(f"duplicate rule id {rule.id!r}")
    _RULES[rule.id] = rule
    return rule_cls


def all_rules() -> Dict[str, Rule]:
    from analytics_zoo_tpu_torch.analysis import (  # noqa: F401
        rules_catalog, rules_compile, rules_concurrency, rules_dataplane,
        rules_hotpath, rules_jit, rules_lifecycle, rules_locks,
        rules_ownership, rules_taint,
    )
    return dict(_RULES)


# ------------------------------------------------------------ suppressions

def _parse_rule_list(raw: Optional[str]) -> Optional[frozenset]:
    """None = bare disable (all rules)."""
    if raw is None:
        return None
    return frozenset(r.strip() for r in raw.split(",") if r.strip())


def suppressed(ctx: FileContext, finding: Finding) -> bool:
    """True when the finding's source line carries ``# zoolint: disable``
    (bare = everything, ``=a,b`` = those rules) or the file carries a
    matching ``# zoolint: disable-file=a,b`` anywhere."""
    m = _DISABLE_LINE.search(ctx.line_text(finding.line))
    if m:
        rules = _parse_rule_list(m.group("rules"))
        if rules is None or finding.rule in rules:
            return True
    for line in ctx.lines:
        fm = _DISABLE_FILE.search(line)
        if fm and finding.rule in _parse_rule_list(fm.group("rules")):
            return True
    return False


# ------------------------------------------------- control-flow graphs
#
# Per-function CFGs power the path-sensitive rule families
# (rules_lifecycle, rules_taint). One statement per block keeps exception
# edges precise: a statement that may raise mid-block would otherwise
# leak the block-exit fact onto the handler edge. Synthetic (stmt=None)
# blocks mark structure: entry/exit/raise, branch joins, loop exits,
# finally copies, with-exit.

#: built/hit counters for the shared per-file CFG cache — reset by the
#: CLI per scan, printed by ``--timing`` and the zoolint CI lane.
CFG_STATS: Dict[str, int] = {"built": 0, "hits": 0}


class CFGBlock:
    """One CFG node. ``stmt`` holds at most one AST statement (None for
    synthetic blocks); ``label`` says what the block *means* — for
    ``branch``/``loop-head`` blocks the semantics cover only the test /
    iterator of the carried If/While/For node, never its body."""

    __slots__ = ("idx", "stmt", "label", "succs", "preds")

    def __init__(self, idx: int, stmt: Optional[ast.AST], label: str):
        self.idx = idx
        self.stmt = stmt
        self.label = label
        self.succs: List[Tuple[int, str]] = []   # (block idx, edge kind)
        self.preds: List[Tuple[int, str]] = []

    def __repr__(self):  # pragma: no cover - debugging aid
        at = getattr(self.stmt, "lineno", "-")
        return f"<B{self.idx} {self.label} L{at}>"


class CFG:
    """Control-flow graph of one function body.

    Edge kinds: ``normal`` (fallthrough), ``true``/``false`` (branch and
    loop test outcomes), ``back`` (loop back-edge), ``break``,
    ``continue``, ``return``, ``exc`` (exception edge). Exception edges
    are *optimistic by construction*: only statements that contain a
    call, an ``assert``, or a ``raise`` get them, routed through the
    enclosing handler/finally chain (``finally`` bodies are built twice —
    a shared normal copy and a shared exceptional copy — plus fresh
    inline copies for each abrupt ``return``/``break``/``continue`` that
    crosses them). Analyses that want pessimism simply include the
    ``raise`` exit in their checked exits; optimistic ones ignore it."""

    def __init__(self, func: ast.AST):
        self.func = func
        self.blocks: List[CFGBlock] = []
        self.entry = 0
        self.exit = 0
        self.raise_exit = 0
        self._stmt_blocks: Dict[int, List[int]] = {}
        _CFGBuilder(self).build(func)

    def block(self, idx: int) -> CFGBlock:
        return self.blocks[idx]

    def blocks_of(self, stmt: ast.AST) -> List[int]:
        """Every block carrying ``stmt`` — 2+ for finally-body and
        abrupt-exit duplication, else 0 or 1."""
        return list(self._stmt_blocks.get(id(stmt), ()))

    def edge_kinds(self) -> Set[str]:
        return {k for b in self.blocks for _, k in b.succs}


def _has_call(node: Optional[ast.AST]) -> bool:
    if node is None:
        return False
    return any(isinstance(n, ast.Call) for n in ast.walk(node))


_NO_RAISE_STMTS = (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef,
                   ast.Pass, ast.Global, ast.Nonlocal, ast.Break,
                   ast.Continue, ast.Import, ast.ImportFrom)


def _may_raise(stmt: ast.AST) -> bool:
    if isinstance(stmt, (ast.Raise, ast.Assert)):
        return True
    if isinstance(stmt, _NO_RAISE_STMTS):
        return False
    return _has_call(stmt)


class _TryFrame:
    __slots__ = ("handler_entries", "catch_all", "fin_exc_entry")

    def __init__(self, handler_entries, catch_all, fin_exc_entry):
        self.handler_entries = handler_entries
        self.catch_all = catch_all
        self.fin_exc_entry = fin_exc_entry


def _is_catch_all(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:
        return True
    names = [t] if not isinstance(t, ast.Tuple) else list(t.elts)
    for n in names:
        tail = n.attr if isinstance(n, ast.Attribute) else \
            n.id if isinstance(n, ast.Name) else ""
        if tail in ("Exception", "BaseException"):
            return True
    return False


class _CFGBuilder:
    def __init__(self, cfg: CFG):
        self.cfg = cfg
        self.frames: List[_TryFrame] = []       # enclosing try frames
        self.fin_pending: List[list] = []       # finalbodys abrupt exits cross
        self.loops: List[Tuple[int, int, int]] = []  # (head, after, fin depth)

    # -------------------------------------------------------- plumbing
    def _new(self, stmt: Optional[ast.AST], label: str) -> int:
        b = CFGBlock(len(self.cfg.blocks), stmt, label)
        self.cfg.blocks.append(b)
        if stmt is not None:
            self.cfg._stmt_blocks.setdefault(id(stmt), []).append(b.idx)
        return b.idx

    def _edge(self, src: Optional[int], dst: int, kind: str):
        if src is None:
            return
        self.cfg.blocks[src].succs.append((dst, kind))
        self.cfg.blocks[dst].preds.append((src, kind))

    def _exc_edges(self, b: int, frames: Optional[List[_TryFrame]] = None):
        """Route an exception raised at block ``b`` through the handler/
        finally chain: innermost handlers first; a catch-all stops the
        walk; a finally (exceptional copy) absorbs the escape — its tail
        continues outward with the frames outside it."""
        frames = self.frames if frames is None else frames
        for fr in reversed(frames):
            for h in fr.handler_entries:
                self._edge(b, h, "exc")
            if fr.catch_all:
                return
            if fr.fin_exc_entry is not None:
                self._edge(b, fr.fin_exc_entry, "exc")
                return
        self._edge(b, self.cfg.raise_exit, "exc")

    def _inline_finallys(self, cur: int, upto: int) -> int:
        """Fresh copies of every pending finally body from innermost down
        to depth ``upto`` — the path a return/break/continue actually
        executes on its way out. Each copy is built with only the
        *outer* finallys pending, so a return inside a finally body
        inlines outward instead of recursing into itself."""
        saved = self.fin_pending
        idx = len(saved)
        while idx > upto and cur is not None:
            idx -= 1
            self.fin_pending = saved[:idx]
            cur = self._seq(saved[idx], cur, "normal")
        self.fin_pending = saved
        return cur

    # ------------------------------------------------------- dispatch
    def build(self, func: ast.AST):
        self.cfg.entry = self._new(None, "entry")
        self.cfg.exit = self._new(None, "exit")
        self.cfg.raise_exit = self._new(None, "raise")
        cur = self._seq(getattr(func, "body", []), self.cfg.entry, "normal")
        self._edge(cur, self.cfg.exit, "normal")

    def _seq(self, stmts, cur: Optional[int], kind: str) -> Optional[int]:
        first = True
        for s in stmts:
            if cur is None:                 # unreachable tail: still built
                cur = self._new(None, "unreachable")
                first = False
            cur = self._stmt(s, cur, kind if first else "normal")
            first = False
        return cur

    def _stmt(self, node, cur, kind) -> Optional[int]:
        if isinstance(node, ast.If):
            return self._branch(node, cur, kind)
        if isinstance(node, (ast.While, ast.For, ast.AsyncFor)):
            return self._loop(node, cur, kind)
        if isinstance(node, ast.Try):
            return self._try(node, cur, kind)
        if isinstance(node, (ast.With, ast.AsyncWith)):
            return self._with(node, cur, kind)
        if isinstance(node, ast.Match):
            return self._match(node, cur, kind)
        b = self._new(node, type(node).__name__.lower())
        self._edge(cur, b, kind)
        if isinstance(node, ast.Return):
            if _may_raise(node):
                self._exc_edges(b)
            end = self._inline_finallys(b, 0)
            self._edge(end, self.cfg.exit, "return")
            return None
        if isinstance(node, ast.Raise):
            self._exc_edges(b)
            return None
        if isinstance(node, (ast.Break, ast.Continue)):
            if self.loops:
                head, after, depth = self.loops[-1]
                end = self._inline_finallys(b, depth)
                if isinstance(node, ast.Break):
                    self._edge(end, after, "break")
                else:
                    self._edge(end, head, "continue")
            return None
        if _may_raise(node):
            self._exc_edges(b)
        return b

    def _branch(self, node: ast.If, cur, kind) -> Optional[int]:
        b = self._new(node, "branch")
        self._edge(cur, b, kind)
        if _has_call(node.test):
            self._exc_edges(b)
        join = self._new(None, "join")
        tcur = self._seq(node.body, b, "true")
        self._edge(tcur, join, "normal")
        if node.orelse:
            ecur = self._seq(node.orelse, b, "false")
            self._edge(ecur, join, "normal")
        else:
            self._edge(b, join, "false")
        return join if self.cfg.blocks[join].preds else None

    def _loop(self, node, cur, kind) -> int:
        head = self._new(node, "loop-head")
        self._edge(cur, head, kind)
        test = node.test if isinstance(node, ast.While) else node.iter
        if _has_call(test):
            self._exc_edges(head)
        after = self._new(None, "loop-exit")
        self.loops.append((head, after, len(self.fin_pending)))
        bcur = self._seq(node.body, head, "true")
        self._edge(bcur, head, "back")
        self.loops.pop()
        if node.orelse:     # runs on normal exhaustion only (no break)
            ocur = self._seq(node.orelse, head, "false")
            self._edge(ocur, after, "normal")
        else:
            self._edge(head, after, "false")
        return after

    def _with(self, node, cur, kind) -> Optional[int]:
        b = self._new(node, "with")     # context exprs + __enter__
        self._edge(cur, b, kind)
        self._exc_edges(b)
        wcur = self._seq(node.body, b, "normal")
        if wcur is None:
            return None
        wx = self._new(None, "with-exit")   # __exit__ on the normal path
        self._edge(wcur, wx, "normal")
        return wx

    def _match(self, node: ast.Match, cur, kind) -> Optional[int]:
        head = self._new(node, "branch")
        self._edge(cur, head, kind)
        if _has_call(node.subject):
            self._exc_edges(head)
        join = self._new(None, "join")
        for case in node.cases:
            ccur = self._seq(case.body, head, "true")
            self._edge(ccur, join, "normal")
        self._edge(head, join, "false")     # no case matched
        return join

    def _try(self, node: ast.Try, cur, kind) -> Optional[int]:
        after = self._new(None, "join")
        handler_entries = [self._new(h, "except") for h in node.handlers]
        catch_all = any(_is_catch_all(h) for h in node.handlers)
        fin_exc = self._new(None, "finally-exc") if node.finalbody else None
        outer_frames = list(self.frames)

        # body + orelse raise into THIS frame's handlers/finally
        self.frames.append(_TryFrame(handler_entries, catch_all, fin_exc))
        if node.finalbody:
            self.fin_pending.append(node.finalbody)
        bcur = self._seq(node.body, cur, kind)
        if node.orelse and bcur is not None:
            bcur = self._seq(node.orelse, bcur, "normal")
        self.frames.pop()

        # handler bodies: an exception inside a handler escapes outward,
        # but still runs this try's finally on the way
        self.frames.append(_TryFrame([], False, fin_exc))
        hends = []
        for hb in handler_entries:
            hends.append(self._seq(self.cfg.blocks[hb].stmt.body,
                                   hb, "normal"))
        self.frames.pop()
        if node.finalbody:
            self.fin_pending.pop()

        if node.finalbody:
            # shared normal copy: body/orelse + handler completions
            fin_n = self._new(None, "finally")
            for e in [bcur] + hends:
                self._edge(e, fin_n, "normal")
            fcur = self._seq(node.finalbody, fin_n, "normal")
            self._edge(fcur, after, "normal")
            # shared exceptional copy: tail re-raises outward
            fe_cur = self._seq(node.finalbody, fin_exc, "normal")
            if fe_cur is not None:
                self._exc_edges(fe_cur, outer_frames)
        else:
            for e in [bcur] + hends:
                self._edge(e, after, "normal")
        return after if self.cfg.blocks[after].preds else None


def dataflow(cfg: CFG, transfer: Callable[[CFGBlock, Any], Any], *,
             init: Any, bottom: Any, join: Callable[[Any, Any], Any],
             backward: bool = False,
             edge_fn: Optional[Callable[[CFGBlock, str, Any], Any]] = None,
             ) -> Dict[int, Any]:
    """Generic worklist gen/kill solve over a CFG.

    Returns the fixpoint fact per block at its *entry* (forward) or
    *exit* (backward). ``transfer(block, fact)`` crosses the block in
    the analysis direction; ``edge_fn(src_block, kind, fact)`` may
    refine the fact per outgoing edge kind (``None`` = edge contributes
    nothing) — ``src_block`` is always the edge's source in CFG
    direction, i.e. the branch that owns the ``true``/``false`` kind.
    Facts must support ``==``; ``join`` must be monotone.

    Blocks carry one statement, so in forward mode an ``exc`` edge
    propagates the block's *entry* fact: a statement that raises did not
    complete its effect (an ``append`` that blew up appended nothing)."""
    facts: Dict[int, Any] = {b.idx: bottom for b in cfg.blocks}
    if backward:
        for s in (cfg.exit, cfg.raise_exit):
            facts[s] = init
    else:
        facts[cfg.entry] = init
    work = deque(range(len(cfg.blocks)))
    guard = 0
    limit = 64 * len(cfg.blocks) + 256
    while work and guard < limit:
        guard += 1
        i = work.popleft()
        crossed = transfer(cfg.blocks[i], facts[i])
        edges = cfg.blocks[i].preds if backward else cfg.blocks[i].succs
        for j, kind in edges:
            src = cfg.blocks[j] if backward else cfg.blocks[i]
            base = facts[i] if (kind == "exc" and not backward) else crossed
            f = base if edge_fn is None else edge_fn(src, kind, base)
            if f is None:
                continue
            merged = join(facts[j], f)
            if merged != facts[j]:
                facts[j] = merged
                work.append(j)
    return facts


# ------------------------------------------------------------------ engine

def find_repo_root(start: str) -> Optional[str]:
    """Walk up from ``start`` to the checkout root (the dir holding
    pyproject.toml / .git / docs/observability.md) — anchors the baseline
    path and the catalog rules' docs lookup."""
    cur = os.path.abspath(start)
    if os.path.isfile(cur):
        cur = os.path.dirname(cur)
    while True:
        if (os.path.exists(os.path.join(cur, "pyproject.toml"))
                or os.path.isdir(os.path.join(cur, ".git"))
                or os.path.isfile(
                    os.path.join(cur, "docs", "observability.md"))):
            return cur
        parent = os.path.dirname(cur)
        if parent == cur:
            return None
        cur = parent


def relpath(path: str, root: Optional[str]) -> str:
    """Repo-relative posix path — the form Finding.path and baseline
    entries use."""
    ap = os.path.abspath(path)
    if root and ap.startswith(os.path.abspath(root) + os.sep):
        ap = os.path.relpath(ap, root)
    return ap.replace(os.sep, "/")


_relpath = relpath


def parse_file(path: str, root: Optional[str]) -> Tuple[
        Optional[FileContext], Optional[Finding]]:
    """Parse one file into a FileContext, or a ``syntax-error`` finding —
    an unparseable file must fail the lint loudly, not crash the linter."""
    with open(path, "r", encoding="utf-8", errors="replace") as fh:
        source = fh.read()
    rel = _relpath(path, root)
    try:
        tree = ast.parse(source, filename=rel)
    except SyntaxError as e:
        return None, Finding("syntax-error", rel, e.lineno or 1,
                             (e.offset or 1) - 1,
                             f"file does not parse: {e.msg}")
    _ParentAnnotator().visit(tree)
    return FileContext(path=rel, source=source, tree=tree), None


def analyze_source(source: str, relpath: str,
                   rules: Optional[Sequence[Rule]] = None,
                   root: Optional[str] = None) -> List[Finding]:
    """Run file-scope rules over in-memory source — the unit-test entry
    point (project rules need a tree on disk; see ``analyze_paths``)."""
    try:
        tree = ast.parse(source, filename=relpath)
    except SyntaxError as e:
        return [Finding("syntax-error", relpath, e.lineno or 1,
                        (e.offset or 1) - 1,
                        f"file does not parse: {e.msg}")]
    _ParentAnnotator().visit(tree)
    ctx = FileContext(path=relpath.replace(os.sep, "/"), source=source,
                      tree=tree)
    use = [r for r in (rules if rules is not None
                       else all_rules().values()) if r.scope == "file"]
    out: List[Finding] = []
    for rule in use:
        for f in rule.check_file(ctx):
            if not suppressed(ctx, f):
                out.append(f)
    return sorted(out, key=lambda f: (f.path, f.line, f.col, f.rule))


def iter_python_files(paths: Sequence[str]) -> List[str]:
    out: List[str] = []
    for p in paths:
        if os.path.isfile(p):
            if p.endswith(".py"):
                out.append(p)
        else:
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = [d for d in dirnames
                               if d not in ("__pycache__", ".git",
                                            "build", ".eggs")]
                out.extend(os.path.join(dirpath, f)
                           for f in sorted(filenames) if f.endswith(".py"))
    return sorted(set(out))


def analyze_paths(paths: Sequence[str],
                  rules: Optional[Dict[str, Rule]] = None,
                  root: Optional[str] = None,
                  jobs: int = 1) -> List[Finding]:
    """Scan files/dirs with every registered rule (file + project scope),
    inline suppressions applied. Baseline filtering is the CLI's job —
    library callers (the pytest catalog cross-check) see raw findings.
    ``jobs`` > 1 parses files on a thread pool (output is identical —
    findings are sorted, and rules run after every parse lands)."""
    rules = rules if rules is not None else all_rules()
    if root is None and paths:
        root = find_repo_root(paths[0])
    files = iter_python_files(paths)
    if jobs and jobs > 1 and len(files) > 1:
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=jobs) as ex:
            parsed = list(ex.map(lambda p: parse_file(p, root), files))
    else:
        parsed = [parse_file(p, root) for p in files]
    contexts: List[FileContext] = []
    findings: List[Finding] = []
    for ctx, err in parsed:
        if err is not None:
            findings.append(err)
            continue
        contexts.append(ctx)
        for rule in rules.values():
            if rule.scope != "file":
                continue
            for f in rule.check_file(ctx):
                if not suppressed(ctx, f):
                    findings.append(f)
    pctx = ProjectContext(files=contexts, root=root)
    by_path = {c.path: c for c in contexts}
    for rule in rules.values():
        if rule.scope != "project":
            continue
        for f in rule.check_project(pctx):
            ctx = by_path.get(f.path)
            if ctx is None or not suppressed(ctx, f):
                findings.append(f)
    return sorted(findings, key=lambda f: (f.path, f.line, f.col, f.rule))


# ===================================================== whole-program model
#
# Everything below this line is the interprocedural half of zoolint: a
# project-wide symbol table + call graph, thread-root inference, a
# "runs-on" propagation pass, and lock/state bookkeeping. The four
# cross-file concurrency rules (rules_ownership.py, rules_locks.py) and
# the --ownership-report artifact (ownership.py) consume this model; the
# per-file rules never touch it.

_FUNC_DEFS = (ast.FunctionDef, ast.AsyncFunctionDef)

#: attribute/variable names that denote a synchronization object — same
#: heuristic the per-file concurrency rules use
_LOCKISH_NAMES = ("lock", "cv", "cond", "mutex", "sem")

#: types whose instances are internally synchronized — method calls on
#: them are not shared-state touches
THREAD_SAFE_TYPES = frozenset({
    "threading.Lock", "threading.RLock", "threading.Event",
    "threading.Condition", "threading.Semaphore",
    "threading.BoundedSemaphore", "threading.Barrier", "threading.local",
    "queue.Queue", "queue.SimpleQueue", "queue.LifoQueue",
    "queue.PriorityQueue",
    "concurrent.futures.ThreadPoolExecutor",
    "concurrent.futures.ProcessPoolExecutor",
    "concurrent.futures.thread.ThreadPoolExecutor",
})

#: container methods that mutate their receiver — ``self._q.append(x)``
#: is a *write* to ``_q`` for ownership purposes
MUTATOR_METHODS = frozenset({
    "append", "appendleft", "extend", "extendleft", "add", "insert",
    "remove", "discard", "pop", "popleft", "popitem", "clear", "update",
    "setdefault", "sort", "reverse",
})

#: construction-time methods — writes here are pre-publication, not races
_INIT_METHODS = frozenset({"__init__", "__new__", "__post_init__",
                           "__init_subclass__", "__set_name__"})

#: stdlib request-handler bases: every do_*/handle method on a subclass
#: is invoked by the (threading) server on its own thread
_HANDLER_BASES = ("BaseHTTPRequestHandler", "SimpleHTTPRequestHandler",
                  "StreamRequestHandler", "DatagramRequestHandler",
                  "BaseRequestHandler")

#: class docstring markers that declare thread-confinement by contract
#: ("Not thread-safe: one pipeline belongs to one producer thread") —
#: the JVM @NotThreadSafe equivalent. Instances are single-owner, so the
#: cross-thread rule does not flag their attributes; the ownership report
#: lists the class as confined-by-contract instead.
CONFINEMENT_MARKERS = ("not thread-safe", "not threadsafe",
                       "thread-confined", "single-threaded",
                       "thread-compatible")

#: method names too generic for the unique-name fallback resolution —
#: resolving ``d.get(...)`` to the one project class defining ``get``
#: would wire dict lookups into the call graph
_GENERIC_METHODS = frozenset({
    "get", "set", "put", "pop", "items", "keys", "values", "update",
    "append", "extend", "add", "remove", "clear", "copy", "join",
    "start", "run", "stop", "close", "read", "write", "open", "send",
    "recv", "result", "submit", "wait", "acquire", "release", "format",
    "strip", "split", "encode", "decode", "sort", "index", "count",
    "insert", "next", "flush", "seek", "tell", "info", "debug",
    "warning", "error", "exception", "observe", "inc", "dec", "labels",
    "record", "item", "mean", "sum", "min", "max", "reshape", "astype",
    "tolist", "numpy", "map", "filter", "reduce", "merge", "head",
    "apply", "groupby", "name", "all", "any", "size", "fields", "done",
    "cancel", "shutdown", "to_dict", "save", "load", "reset", "build",
    "call", "first",
})


def module_name(path: str) -> str:
    """Dotted module name from a repo-relative posix path."""
    mod = path[:-3] if path.endswith(".py") else path
    mod = mod.replace("/", ".")
    if mod.endswith(".__init__"):
        mod = mod[: -len(".__init__")]
    return mod.lstrip(".")


def _lockish_name(name: str) -> bool:
    low = name.lower()
    return any(t in low for t in _LOCKISH_NAMES)


def _is_lockish_expr(expr: ast.AST) -> bool:
    if isinstance(expr, ast.Attribute):
        return _lockish_name(expr.attr)
    if isinstance(expr, ast.Name):
        return _lockish_name(expr.id)
    return False


def _qualpath(node: ast.AST) -> str:
    parts = [node.name]  # type: ignore[attr-defined]
    for a in ancestors(node):
        if isinstance(a, _FUNC_DEFS + (ast.ClassDef,)):
            parts.append(a.name)
    return ".".join(reversed(parts))


def _owner_defs(node: ast.AST):
    """(nearest enclosing function def, nearest enclosing class def)."""
    fn = cl = None
    for a in ancestors(node):
        if fn is None and isinstance(a, _FUNC_DEFS):
            fn = a
        if cl is None and isinstance(a, ast.ClassDef):
            cl = a
        if fn is not None and cl is not None:
            break
    return fn, cl


def _const_kwarg(call: ast.Call, name: str):
    for kw in call.keywords:
        if kw.arg == name and isinstance(kw.value, ast.Constant):
            return kw.value.value
    return None


def _kwarg(call: ast.Call, name: str):
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


@dataclass
class FuncNode:
    """One function/method (or the per-module pseudo-function for
    module-level statements) in the project symbol table."""

    qual: str                     # <module dotted>.<qualpath>
    name: str
    module: str
    ctx: FileContext
    node: Optional[ast.AST]       # None for the <module> pseudo-function
    cls: Optional["ClassNode"] = None
    nested_in: Optional[str] = None
    local_types: Dict[str, str] = field(default_factory=dict)
    declared_globals: frozenset = frozenset()
    local_names: frozenset = frozenset()

    @property
    def qualpath(self) -> str:
        return self.qual[len(self.module) + 1:]

    @property
    def line(self) -> int:
        return getattr(self.node, "lineno", 1)

    @property
    def display(self) -> str:
        return f"{self.ctx.path}:{self.qualpath}"

    @property
    def is_test(self) -> bool:
        base = self.ctx.path.rsplit("/", 1)[-1]
        return (base.startswith("test_") or base == "conftest.py"
                or self.name.startswith("test_"))


@dataclass
class ClassNode:
    qual: str
    name: str
    module: str
    ctx: FileContext
    node: ast.ClassDef
    bases: List[str] = field(default_factory=list)
    methods: Dict[str, FuncNode] = field(default_factory=dict)
    attr_types: Dict[str, str] = field(default_factory=dict)
    confined_by_contract: bool = False


@dataclass
class ThreadSpawn:
    """One ``Thread(...)`` / ``pool.submit(...)`` / handler-registration
    site — the raw material for thread roots and the thread-leak rule."""

    func: FuncNode
    node: ast.Call
    kind: str                     # thread | executor | atexit | signal
    target: Optional[str]         # entry FuncNode qual when resolvable
    daemon: bool
    name_hint: Optional[str]
    started: bool
    joined: bool
    escapes: bool


@dataclass
class Root:
    """A thread root: an execution entry the scheduler (or the runtime)
    can start independently. ``main`` is the implicit root owning every
    externally-callable function."""

    rid: str
    kind: str                     # main|thread|executor|atexit|signal|handler
    entries: List[str]
    site: Optional[Tuple[str, int]] = None   # (path, line) of the spawn


@dataclass
class StateAccess:
    """One read/write of a shared-state key (``module.Class.attr`` or
    ``module.GLOBAL``). ``locks`` are the locks held *syntactically* (via
    ``with`` ancestors) at the access; callers add ``must_held`` of the
    enclosing function for the helper-method case."""

    state: str
    func: str
    node: ast.AST
    write: bool
    locks: frozenset


class ProjectModel:
    """Whole-program model over a set of parsed files.

    Build order: symbols -> attribute/local typing -> body scan (call
    edges, spawns, lock acquisitions, state accesses) -> roots ->
    runs-on propagation -> held-lock fixpoints -> lock graph. All
    consumers (rules, ownership report) read the finished fields."""

    def __init__(self, files: Sequence[FileContext]):
        self.files = list(files)
        self.functions: Dict[str, FuncNode] = {}
        self.classes: Dict[str, ClassNode] = {}
        self.globals: Dict[str, set] = {}
        self.aliases: Dict[str, str] = {}
        self.edges: Dict[str, set] = {}
        self.incoming: Dict[str, set] = {}
        self.call_sites: List[Tuple[str, str, Optional[ast.AST],
                                    frozenset]] = []
        self.calls_in: Dict[str, List[ast.Call]] = {}
        self.spawns: List[ThreadSpawn] = []
        self.roots: Dict[str, Root] = {}
        self.runs_on: Dict[str, frozenset] = {}
        self.must_held: Dict[str, frozenset] = {}
        self.may_held: Dict[str, frozenset] = {}
        #: raw lock acquisitions: (lock, func qual, With node, locks held
        #: via enclosing ``with`` blocks at that node)
        self.acquisitions: List[Tuple[str, str, ast.AST, frozenset]] = []
        #: (outer, inner) -> (path, line, interprocedural-only)
        self.lock_edges: Dict[Tuple[str, str], Tuple[str, int, bool]] = {}
        self.lock_roots: Dict[str, set] = {}
        self.state: Dict[str, List[StateAccess]] = {}
        self._mod_funcs: Dict[str, FuncNode] = {}
        self._method_index: Dict[str, List[FuncNode]] = {}
        #: top-level packages of the scanned files: an imported name
        #: rooted anywhere else (torch, numpy, ...) is outside the project
        self._project_tops = frozenset(
            module_name(c.path).split(".")[0] for c in self.files)
        self._build()

    # ------------------------------------------------------------ build
    def _build(self):
        for ctx in self.files:
            self._collect_symbols(ctx)
        self._infer_attr_types()
        for fn in self.functions.values():
            self._infer_local_types(fn)
        self._attr_types_from_locals()
        for ctx in self.files:
            self._scan_bodies(ctx)
        self._finish_roots()
        self._propagate_runs_on()
        self._propagate_held()
        self._build_lock_graph()

    # -------------------------------------------------------- symbols
    def _collect_symbols(self, ctx: FileContext):
        mod = module_name(ctx.path)
        pseudo = FuncNode(qual=f"{mod}.<module>", name="<module>",
                          module=mod, ctx=ctx, node=None)
        self._mod_funcs[ctx.path] = pseudo
        self.functions[pseudo.qual] = pseudo
        for node in ctx.walk():
            if isinstance(node, ast.ClassDef):
                cn = ClassNode(qual=f"{mod}.{_qualpath(node)}",
                               name=node.name, module=mod, ctx=ctx,
                               node=node)
                doc = (ast.get_docstring(node) or "").lower()
                cn.confined_by_contract = any(
                    m in doc for m in CONFINEMENT_MARKERS)
                for b in node.bases:
                    d = ctx.imports.resolve(b)
                    if d:
                        cn.bases.append(d)
                self.classes[cn.qual] = cn
        for node in ctx.walk():
            if isinstance(node, _FUNC_DEFS):
                encl_fn, encl_cls = _owner_defs(node)
                fn = FuncNode(qual=f"{mod}.{_qualpath(node)}",
                              name=node.name, module=mod, ctx=ctx,
                              node=node)
                if encl_cls is not None:
                    fn.cls = self.classes.get(
                        f"{mod}.{_qualpath(encl_cls)}")
                if encl_fn is not None:
                    fn.nested_in = f"{mod}.{_qualpath(encl_fn)}"
                decl, assigned = set(), set()
                for sub in ctx.walk(node):
                    if isinstance(sub, ast.Global):
                        decl.update(sub.names)
                    elif isinstance(sub, ast.Name) and isinstance(
                            sub.ctx, ast.Store):
                        assigned.add(sub.id)
                a = node.args
                params = [p.arg for p in
                          (a.posonlyargs + a.args + a.kwonlyargs)]
                if a.vararg:
                    params.append(a.vararg.arg)
                if a.kwarg:
                    params.append(a.kwarg.arg)
                fn.declared_globals = frozenset(decl)
                fn.local_names = (frozenset(assigned)
                                  | frozenset(params)) - fn.declared_globals
                self.functions[fn.qual] = fn
                if fn.cls is not None and \
                        getattr(node, "_zl_parent", None) is encl_cls:
                    fn.cls.methods[fn.name] = fn
                    self._method_index.setdefault(fn.name, []).append(fn)
        g = self.globals.setdefault(mod, set())
        for node in ctx.walk():
            if not isinstance(node, (ast.Assign, ast.AnnAssign,
                                     ast.AugAssign)):
                continue
            if _owner_defs(node) != (None, None):
                continue
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                if isinstance(t, ast.Name):
                    g.add(t.id)
                elif isinstance(t, (ast.Tuple, ast.List)):
                    g.update(e.id for e in t.elts
                             if isinstance(e, ast.Name))
            value = getattr(node, "value", None)
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and isinstance(value, (ast.Name, ast.Attribute)):
                d = ctx.imports.resolve(value)
                if d:
                    self.aliases[f"{mod}.{node.targets[0].id}"] = d

    # -------------------------------------------------------- resolution
    def _lookup_method(self, cls: ClassNode, name: str,
                       _depth: int = 0) -> Optional[FuncNode]:
        if name in cls.methods:
            return cls.methods[name]
        if _depth >= 4:
            return None
        for b in cls.bases:
            r = self.resolve_dotted(b, cls.module)
            if r and r[0] == "class" and r[1] is not cls:
                m = self._lookup_method(r[1], name, _depth + 1)
                if m is not None:
                    return m
        return None

    def resolve_dotted(self, dotted: str, mod: str = ""):
        """('func', FuncNode) | ('class', ClassNode) | None for a
        canonical dotted name, chasing module-level aliases."""
        for _ in range(4):
            if not dotted:
                return None
            cands = [dotted]
            if mod and "." not in dotted:
                cands.append(f"{mod}.{dotted}")
            for cand in cands:
                if cand in self.functions:
                    return ("func", self.functions[cand])
                if cand in self.classes:
                    return ("class", self.classes[cand])
            head, _, tail = dotted.rpartition(".")
            if head and tail:
                for cand in ([head, f"{mod}.{head}"]
                             if mod and "." not in head else [head]):
                    if cand in self.classes:
                        m = self._lookup_method(self.classes[cand], tail)
                        if m is not None:
                            return ("func", m)
            nxt = self.aliases.get(dotted)
            if nxt is None and mod and "." not in dotted:
                nxt = self.aliases.get(f"{mod}.{dotted}")
            if nxt is None:
                return None
            dotted = nxt
        return None

    def reachable(self, seeds: Iterable[str]) -> Set[str]:
        """Call-graph closure: every function qual reachable from
        ``seeds`` over ``edges`` — the interprocedural summary the
        path-sensitive rules piggyback on (e.g. the compiled-region closure
        of rules_taint)."""
        seen: Set[str] = set()
        stack = [q for q in seeds if q in self.functions]
        while stack:
            q = stack.pop()
            if q in seen:
                continue
            seen.add(q)
            stack.extend(c for c in self.edges.get(q, ())
                         if c in self.functions and c not in seen)
        return seen

    # ------------------------------------------------------------ typing
    def _resolve_type(self, expr, ctx: FileContext,
                      mod: str) -> Optional[str]:
        if expr is None:
            return None
        if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
            name = expr.value.split("[")[0].strip().strip('"\'')
            r = self.resolve_dotted(name, mod)
            return r[1].qual if r and r[0] == "class" else None
        if isinstance(expr, ast.Subscript):
            base = ctx.imports.resolve(expr.value)
            if base.rsplit(".", 1)[-1] == "Optional":
                return self._resolve_type(expr.slice, ctx, mod)
            return None
        if isinstance(expr, ast.BinOp):
            return (self._resolve_type(expr.left, ctx, mod)
                    or self._resolve_type(expr.right, ctx, mod))
        if isinstance(expr, (ast.Name, ast.Attribute)):
            d = ctx.imports.resolve(expr)
            if not d:
                return None
            r = self.resolve_dotted(d, mod)
            if r and r[0] == "class":
                return r[1].qual
            return d
        return None

    def _attr_type(self, cls: ClassNode, attr: str,
                   _depth: int = 0) -> Optional[str]:
        if attr in cls.attr_types:
            return cls.attr_types[attr]
        if _depth >= 4:
            return None
        for b in cls.bases:
            r = self.resolve_dotted(b, cls.module)
            if r and r[0] == "class" and r[1] is not cls:
                t = self._attr_type(r[1], attr, _depth + 1)
                if t is not None:
                    return t
        return None

    def _type_of_value(self, value, fn: FuncNode) -> Optional[str]:
        ctx, mod = fn.ctx, fn.module
        if isinstance(value, ast.Call):
            d = ctx.imports.resolve(value.func)
            if d:
                r = self.resolve_dotted(d, mod)
                if r and r[0] == "class":
                    return r[1].qual
                if r and r[0] == "func" and r[1].node is not None:
                    return self._resolve_type(
                        getattr(r[1].node, "returns", None),
                        r[1].ctx, r[1].module)
                if d in THREAD_SAFE_TYPES:
                    return d
            f = value.func
            if isinstance(f, ast.Attribute) and \
                    isinstance(f.value, ast.Name) and \
                    f.value.id == "self" and fn.cls is not None:
                m = self._lookup_method(fn.cls, f.attr)
                if m is not None and m.node is not None:
                    return self._resolve_type(
                        getattr(m.node, "returns", None), m.ctx, m.module)
            return None
        if isinstance(value, ast.Name):
            return fn.local_types.get(value.id)
        if isinstance(value, ast.Attribute) and \
                isinstance(value.value, ast.Name) and \
                value.value.id == "self" and fn.cls is not None:
            return self._attr_type(fn.cls, value.attr)
        return None

    def _param_types(self, fn: FuncNode) -> Dict[str, str]:
        out: Dict[str, str] = {}
        if fn.node is None:
            return out
        a = fn.node.args
        for p in a.posonlyargs + a.args + a.kwonlyargs:
            if p.annotation is not None:
                t = self._resolve_type(p.annotation, fn.ctx, fn.module)
                if t:
                    out[p.arg] = t
        return out

    def _infer_attr_types(self):
        for cls in self.classes.values():
            for m in cls.methods.values():
                params = self._param_types(m)
                for sub in m.ctx.walk(m.node):
                    tgt = None
                    if isinstance(sub, ast.Assign) and \
                            len(sub.targets) == 1:
                        tgt, val = sub.targets[0], sub.value
                    elif isinstance(sub, ast.AnnAssign):
                        tgt, val = sub.target, sub.value
                    else:
                        continue
                    if not (isinstance(tgt, ast.Attribute)
                            and isinstance(tgt.value, ast.Name)
                            and tgt.value.id == "self"):
                        continue
                    t = None
                    if isinstance(sub, ast.AnnAssign):
                        t = self._resolve_type(sub.annotation, m.ctx,
                                               m.module)
                    if t is None and isinstance(val, ast.Call):
                        d = m.ctx.imports.resolve(val.func)
                        if d:
                            r = self.resolve_dotted(d, m.module)
                            if r and r[0] == "class":
                                t = r[1].qual
                            elif d in THREAD_SAFE_TYPES:
                                t = d
                    if t is None and isinstance(val, ast.Name):
                        t = params.get(val.id)
                    if t and tgt.attr not in cls.attr_types:
                        cls.attr_types[tgt.attr] = t

    def _infer_local_types(self, fn: FuncNode):
        if fn.node is None:
            return
        fn.local_types.update(self._param_types(fn))
        for sub in fn.ctx.walk(fn.node):
            if isinstance(sub, ast.Assign) and len(sub.targets) == 1 \
                    and isinstance(sub.targets[0], ast.Name):
                t = self._type_of_value(sub.value, fn)
                if t and sub.targets[0].id not in fn.local_types:
                    fn.local_types[sub.targets[0].id] = t
            elif isinstance(sub, ast.AnnAssign) and \
                    isinstance(sub.target, ast.Name):
                t = self._resolve_type(sub.annotation, fn.ctx, fn.module)
                if t and sub.target.id not in fn.local_types:
                    fn.local_types[sub.target.id] = t

    def _attr_types_from_locals(self):
        for cls in self.classes.values():
            for m in cls.methods.values():
                for sub in m.ctx.walk(m.node):
                    if not (isinstance(sub, ast.Assign)
                            and len(sub.targets) == 1):
                        continue
                    tgt = sub.targets[0]
                    if isinstance(tgt, ast.Attribute) and \
                            isinstance(tgt.value, ast.Name) and \
                            tgt.value.id == "self" and \
                            isinstance(sub.value, ast.Name):
                        t = m.local_types.get(sub.value.id)
                        if t and tgt.attr not in cls.attr_types:
                            cls.attr_types[tgt.attr] = t

    # --------------------------------------------------------- body scan
    def _owner_func(self, node: ast.AST, mod: str,
                    pseudo: FuncNode) -> FuncNode:
        fn, _ = _owner_defs(node)
        if fn is None:
            return pseudo
        return self.functions.get(f"{mod}.{_qualpath(fn)}", pseudo)

    def _held_at(self, node: ast.AST, owner: FuncNode,
                 exclude: Optional[ast.AST] = None) -> frozenset:
        """Locks acquired by enclosing ``with`` blocks at ``node``."""
        held = set()
        for a in ancestors(node):
            if isinstance(a, (ast.With, ast.AsyncWith)) and a is not exclude:
                for item in a.items:
                    if _is_lockish_expr(item.context_expr):
                        held.add(self._lock_id(item.context_expr, owner))
        return frozenset(held)

    def _lock_id(self, expr: ast.AST, owner: FuncNode) -> str:
        if isinstance(expr, ast.Attribute):
            base = expr.value
            if isinstance(base, ast.Name) and base.id == "self" \
                    and owner.cls is not None:
                return f"{owner.cls.qual}.{expr.attr}"
            if isinstance(base, ast.Name):
                t = owner.local_types.get(base.id)
                if t and t in self.classes:
                    return f"{t}.{expr.attr}"
            d = owner.ctx.imports.resolve(expr)
            if d:
                return d
            return f"{owner.qual}.<{expr.attr}>"
        if isinstance(expr, ast.Name):
            if expr.id in self.globals.get(owner.module, ()) and \
                    expr.id not in owner.local_names:
                return f"{owner.module}.{expr.id}"
            if expr.id not in owner.local_names:
                # an imported module-level lock keeps its home identity,
                # so cross-file acquisitions of the same lock line up
                d = owner.ctx.imports.resolve(expr)
                if d and d != expr.id:
                    mod, _, name = d.rpartition(".")
                    if name in self.globals.get(mod, ()):
                        return d
            return f"{owner.qual}.{expr.id}"
        return f"{owner.qual}.<lock@{getattr(expr, 'lineno', 0)}>"

    def _state_key(self, expr: ast.AST,
                   owner: FuncNode) -> Optional[Tuple[str, ClassNode]]:
        """Shared-state key for an expression, or None. Returns the
        owning ClassNode for attribute state (None for globals)."""
        if isinstance(expr, ast.Attribute):
            base = expr.value
            cls = None
            if isinstance(base, ast.Name) and base.id == "self":
                cls = owner.cls
            elif isinstance(base, ast.Name):
                t = owner.local_types.get(base.id)
                cls = self.classes.get(t) if t else None
            elif isinstance(base, ast.Attribute) and \
                    isinstance(base.value, ast.Name) and \
                    base.value.id == "self" and owner.cls is not None:
                t = self._attr_type(owner.cls, base.attr)
                cls = self.classes.get(t) if t else None
            if cls is not None:
                attr = expr.attr
                if _lockish_name(attr) or attr in cls.methods:
                    return None
                t = self._attr_type(cls, attr)
                if t in THREAD_SAFE_TYPES:
                    return None
                return f"{cls.qual}.{attr}", cls
            d = owner.ctx.imports.resolve(expr)
            if d:
                head, _, tail = d.rpartition(".")
                if tail and not _lockish_name(tail) and \
                        tail in self.globals.get(head, ()):
                    return f"{d}", None
            return None
        if isinstance(expr, ast.Name):
            if expr.id in self.globals.get(owner.module, ()) and \
                    expr.id not in owner.local_names and \
                    not _lockish_name(expr.id):
                return f"{owner.module}.{expr.id}", None
        return None

    def _record_state(self, key, cls, owner: FuncNode, node: ast.AST,
                      write: bool):
        if owner.name in _INIT_METHODS or owner.node is None:
            return
        self.state.setdefault(key, []).append(StateAccess(
            state=key, func=owner.qual, node=node, write=write,
            locks=self._held_at(node, owner)))

    def _scan_bodies(self, ctx: FileContext):
        mod = module_name(ctx.path)
        pseudo = self._mod_funcs[ctx.path]
        order = ctx.walk()
        # owner per node, computed in one pass over the DFS pre-order:
        # a def claims its subtree slice; nested defs are visited later
        # and overwrite their sub-slice. The def node itself (incl. its
        # decorators/defaults, evaluated in the enclosing scope) keeps
        # the enclosing owner — same attribution _owner_func derives by
        # walking ancestors, minus the per-node ancestor walk.
        owners = [pseudo] * len(order)
        span = ctx._span
        for i, node in enumerate(order):
            if isinstance(node, _FUNC_DEFS):
                fn = self.functions.get(f"{mod}.{_qualpath(node)}")
                if fn is not None:
                    end = span[id(node)][1]
                    owners[i + 1:end] = [fn] * (end - i - 1)
        for i, node in enumerate(order):
            owner = owners[i]
            if isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    if _is_lockish_expr(item.context_expr):
                        self.acquisitions.append((
                            self._lock_id(item.context_expr, owner),
                            owner.qual, node,
                            self._held_at(node, owner, exclude=node)))
            elif isinstance(node, ast.Call):
                self._handle_call(owner, node, ctx, mod)
            elif isinstance(node, ast.Attribute) and \
                    isinstance(node.ctx, (ast.Store, ast.Del)):
                ks = self._state_key(node, owner)
                if ks is not None:
                    self._record_state(ks[0], ks[1], owner, node, True)
            elif isinstance(node, ast.Attribute) and \
                    isinstance(node.ctx, ast.Load):
                par = getattr(node, "_zl_parent", None)
                if isinstance(par, ast.Call) and par.func is node:
                    continue  # callee position — an edge, not state
                if isinstance(par, ast.Attribute) or \
                        isinstance(par, ast.Subscript) and par.value is node:
                    continue  # handled at the outer node
                ks = self._state_key(node, owner)
                if ks is not None:
                    self._record_state(ks[0], ks[1], owner, node, False)
            elif isinstance(node, ast.Subscript) and \
                    isinstance(node.ctx, (ast.Store, ast.Del)):
                ks = self._state_key(node.value, owner)
                if ks is not None:
                    self._record_state(ks[0], ks[1], owner, node, True)
            elif isinstance(node, ast.Name) and \
                    isinstance(node.ctx, ast.Load):
                par = getattr(node, "_zl_parent", None)
                if isinstance(par, (ast.Attribute, ast.Call)):
                    continue
                ks = self._state_key(node, owner)
                if ks is not None:
                    self._record_state(ks[0], ks[1], owner, node, False)
            elif isinstance(node, ast.Name) and \
                    isinstance(node.ctx, ast.Store):
                if node.id in owner.declared_globals:
                    self._record_state(f"{owner.module}.{node.id}", None,
                                       owner, node, True)

    # ----------------------------------------------------------- calls
    def _add_edge(self, caller: str, callee: str,
                  node: Optional[ast.AST], held: frozenset):
        self.edges.setdefault(caller, set()).add(callee)
        self.incoming.setdefault(callee, set()).add(caller)
        self.call_sites.append((caller, callee, node, held))

    def _resolve_callable(self, expr: ast.AST, owner: FuncNode):
        """('func', FuncNode) | ('class', ClassNode) | None for a callee
        or callback-reference expression."""
        if isinstance(expr, ast.Name):
            scope = owner
            while scope is not None:
                cand = f"{scope.qual}.{expr.id}"
                if cand in self.functions:
                    return ("func", self.functions[cand])
                scope = self.functions.get(scope.nested_in) \
                    if scope.nested_in else None
            d = owner.ctx.imports.resolve(expr)
            return self.resolve_dotted(d or expr.id, owner.module)
        if not isinstance(expr, ast.Attribute):
            return None
        base = expr.value
        if isinstance(base, ast.Name) and base.id == "self" \
                and owner.cls is not None:
            m = self._lookup_method(owner.cls, expr.attr)
            return ("func", m) if m is not None else None
        recv_t = None
        if isinstance(base, ast.Name):
            recv_t = owner.local_types.get(base.id)
        elif isinstance(base, ast.Attribute) and \
                isinstance(base.value, ast.Name) and \
                base.value.id == "self" and owner.cls is not None:
            recv_t = self._attr_type(owner.cls, base.attr)
        if recv_t and recv_t in self.classes:
            m = self._lookup_method(self.classes[recv_t], expr.attr)
            return ("func", m) if m is not None else None
        d = owner.ctx.imports.resolve(expr)
        if d:
            r = self.resolve_dotted(d, owner.module)
            if r is not None:
                return r
        if self._outside_receiver(base, owner):
            return None
        # unique-method-name fallback: exactly one project class defines
        # this (non-generic) method — resolve to it
        if expr.attr not in _GENERIC_METHODS:
            cands = self._method_index.get(expr.attr, ())
            if len(cands) == 1:
                return ("func", cands[0])
        return None

    def _outside_receiver(self, base: ast.AST, owner: FuncNode) -> bool:
        """True when ``base`` is a name chain rooted at an import of a
        module outside the project (``torch.cuda`` in
        ``torch.cuda.stream(s)``): its methods are never the project's,
        whatever their names."""
        while isinstance(base, ast.Attribute):
            base = base.value
        if not isinstance(base, ast.Name) or base.id in owner.local_names:
            return False
        origin = owner.ctx.imports.names.get(base.id)
        return origin is not None and \
            origin.split(".")[0] not in self._project_tops

    def _spawn_bookkeeping(self, owner: FuncNode, node: ast.Call):
        """started/joined/escapes/daemon facts for one Thread(...) call."""
        par = getattr(node, "_zl_parent", None)
        var = attr = None
        started = joined = escapes = False
        daemon = _const_kwarg(node, "daemon") is True
        if isinstance(par, ast.Attribute) and par.attr == "start":
            started = True
        elif isinstance(par, ast.Assign) and len(par.targets) == 1:
            tgt = par.targets[0]
            if isinstance(tgt, ast.Name):
                var = tgt.id
            elif isinstance(tgt, ast.Attribute) and \
                    isinstance(tgt.value, ast.Name) and \
                    tgt.value.id == "self":
                attr = tgt.attr
        elif isinstance(par, (ast.Return, ast.Yield)) or \
                isinstance(par, ast.Call):
            escapes = True
        scope = owner.node if owner.node is not None else owner.ctx.tree
        if var is not None:
            for sub in owner.ctx.walk(scope):
                if isinstance(sub, ast.Call) and \
                        isinstance(sub.func, ast.Attribute) and \
                        isinstance(sub.func.value, ast.Name) and \
                        sub.func.value.id == var:
                    if sub.func.attr == "start":
                        started = True
                    elif sub.func.attr == "join":
                        joined = True
                elif isinstance(sub, ast.Call) and any(
                        isinstance(a, ast.Name) and a.id == var
                        for a in sub.args):
                    escapes = True
                elif isinstance(sub, (ast.Return, ast.Yield)) and \
                        isinstance(getattr(sub, "value", None), ast.Name) \
                        and sub.value.id == var:
                    escapes = True
                elif isinstance(sub, ast.Assign) and \
                        isinstance(sub.value, ast.Name) and \
                        sub.value.id == var:
                    escapes = True
                elif isinstance(sub, ast.Assign) and \
                        isinstance(sub.targets[0], ast.Attribute) and \
                        isinstance(sub.targets[0].value, ast.Name) and \
                        sub.targets[0].value.id == var and \
                        sub.targets[0].attr == "daemon" and \
                        isinstance(sub.value, ast.Constant) and \
                        sub.value.value is True:
                    daemon = True
        if attr is not None:
            started = True  # published on the instance; assume managed
            search = owner.cls.node if owner.cls is not None else scope
            for sub in owner.ctx.walk(search):
                if isinstance(sub, ast.Call) and \
                        isinstance(sub.func, ast.Attribute) and \
                        sub.func.attr == "join":
                    joined = True
        return daemon, started, joined, escapes

    def _handle_call(self, owner: FuncNode, node: ast.Call,
                     ctx: FileContext, mod: str):
        self.calls_in.setdefault(owner.qual, []).append(node)
        # container mutation through a method call is a *write* to the
        # receiver state (self._q.append(x), GLOBAL.update(...))
        if isinstance(node.func, ast.Attribute) and \
                node.func.attr in MUTATOR_METHODS:
            ks = self._state_key(node.func.value, owner)
            if ks is not None:
                self._record_state(ks[0], ks[1], owner, node, True)
        d = ctx.imports.resolve(node.func)
        held = None  # computed lazily

        def site_held():
            nonlocal held
            if held is None:
                held = self._held_at(node, owner)
            return held

        # ---- thread/executor/handler registration sites become roots
        if d == "threading.Thread":
            target = _kwarg(node, "target")
            tq = None
            if target is not None and not isinstance(target, ast.Lambda):
                r = self._resolve_callable(target, owner)
                if r is not None and r[0] == "func":
                    tq = r[1].qual
            daemon, started, joined, escapes = \
                self._spawn_bookkeeping(owner, node)
            name = _const_kwarg(node, "name")
            self.spawns.append(ThreadSpawn(
                func=owner, node=node, kind="thread", target=tq,
                daemon=daemon, name_hint=name if isinstance(name, str)
                else None, started=started, joined=joined,
                escapes=escapes))
            return
        if d in ("atexit.register", "signal.signal") and node.args:
            arg = node.args[0] if d == "atexit.register" else (
                node.args[1] if len(node.args) > 1 else None)
            tq = None
            if arg is not None and not isinstance(arg, ast.Lambda):
                r = self._resolve_callable(arg, owner)
                if r is not None and r[0] == "func":
                    tq = r[1].qual
            self.spawns.append(ThreadSpawn(
                func=owner, node=node,
                kind="atexit" if d == "atexit.register" else "signal",
                target=tq, daemon=True, name_hint=None, started=True,
                joined=True, escapes=True))
            return

        # ---- ordinary call edge (typed receivers, imports, self.*)
        r = self._resolve_callable(node.func, owner)
        if r is None and isinstance(node.func, ast.Attribute) and \
                node.func.attr == "submit" and node.args:
            # untyped-receiver .submit(fn, ...): an executor dispatch —
            # the submitted callable becomes a pool root
            tq = None
            if not isinstance(node.args[0], ast.Lambda):
                rr = self._resolve_callable(node.args[0], owner)
                if rr is not None and rr[0] == "func":
                    tq = rr[1].qual
            self.spawns.append(ThreadSpawn(
                func=owner, node=node, kind="executor", target=tq,
                daemon=True, name_hint=None, started=True, joined=True,
                escapes=True))
            return
        callee_cls = None
        if r is not None and r[0] == "func":
            self._add_edge(owner.qual, r[1].qual, node, site_held())
        elif r is not None and r[0] == "class":
            callee_cls = r[1]
            init = self._lookup_method(callee_cls, "__init__")
            if init is not None:
                self._add_edge(owner.qual, init.qual, node, site_held())

        # ---- callback arguments: a project-function reference passed
        # into a call may be invoked by the receiver later
        for arg in list(node.args) + [kw.value for kw in node.keywords]:
            if not isinstance(arg, (ast.Name, ast.Attribute)):
                continue
            cb = self._resolve_callable(arg, owner)
            if cb is None or cb[0] != "func":
                continue
            if callee_cls is not None:
                # constructor capture: any method of the class may call it
                for m in callee_cls.methods.values():
                    self._add_edge(m.qual, cb[1].qual, None, frozenset())
            elif r is not None and r[0] == "func":
                self._add_edge(r[1].qual, cb[1].qual, None, frozenset())
            else:
                self._add_edge(owner.qual, cb[1].qual, node, site_held())

    # ----------------------------------------------------------- roots
    def _finish_roots(self):
        def add_root(rid, kind, entries, site):
            rid0, n = rid, 1
            while rid in self.roots:
                if self.roots[rid].kind == kind and \
                        set(self.roots[rid].entries) == set(entries):
                    return
                n += 1
                rid = f"{rid0}#{n}"
            self.roots[rid] = Root(rid=rid, kind=kind,
                                   entries=sorted(entries), site=site)

        for sp in self.spawns:
            if sp.func.is_test:
                continue
            site = (sp.func.ctx.path, sp.node.lineno)
            rid = sp.name_hint or (
                sp.target if sp.target is not None
                else f"{sp.kind}@{sp.func.qual}")
            add_root(rid, sp.kind, [sp.target] if sp.target else [], site)
        for cls in self.classes.values():
            if any(f.startswith("test_") or f == "conftest.py"
                   for f in (cls.ctx.path.rsplit("/", 1)[-1],)):
                continue
            chain = self._base_chain(cls)
            if any(b.rsplit(".", 1)[-1] in _HANDLER_BASES for b in chain):
                for name, m in cls.methods.items():
                    if name.startswith("do_") or name == "handle":
                        add_root(f"{cls.qual}.{name}", "handler",
                                 [m.qual], (cls.ctx.path, m.line))
            if any(b == "threading.Thread" for b in chain) and \
                    "run" in cls.methods:
                add_root(f"{cls.qual}.run", "thread",
                         [cls.methods["run"].qual],
                         (cls.ctx.path, cls.methods["run"].line))
        entries = set()
        for root in self.roots.values():
            entries.update(root.entries)
        main = []
        for fn in self.functions.values():
            if fn.node is None:
                main.append(fn.qual)   # module import runs on main
            elif fn.qual not in entries and fn.nested_in is None and \
                    not self.incoming.get(fn.qual) and \
                    not fn.name.startswith("do_"):
                main.append(fn.qual)
        self.roots["main"] = Root(rid="main", kind="main",
                                  entries=sorted(main), site=None)

    def _base_chain(self, cls: ClassNode, _depth: int = 0) -> List[str]:
        out = list(cls.bases)
        if _depth >= 4:
            return out
        for b in cls.bases:
            r = self.resolve_dotted(b, cls.module)
            if r and r[0] == "class" and r[1] is not cls:
                out.extend(self._base_chain(r[1], _depth + 1))
        return out

    # ----------------------------------------------------- propagation
    def _propagate_runs_on(self):
        on: Dict[str, set] = {}
        for root in self.roots.values():
            # atexit handlers execute ON the main thread (sequentially,
            # at shutdown) — they are listed as roots for the ownership
            # report but attribute their reachability to main, so
            # main-only state is not miscounted as cross-thread
            rid = "main" if root.kind == "atexit" else root.rid
            seen = set()
            stack = [e for e in root.entries if e in self.functions]
            while stack:
                q = stack.pop()
                if q in seen:
                    continue
                seen.add(q)
                stack.extend(self.edges.get(q, ()))
            for q in seen:
                on.setdefault(q, set()).add(rid)
        self.runs_on = {q: frozenset(s) for q, s in on.items()}

    def _propagate_held(self):
        """must_held = locks guaranteed held on *every* path into a
        function (intersection over call sites — the helper-method lock
        tracking); may_held = locks held on *some* path (union — feeds
        the lock-order graph and blocking-under-lock)."""
        sites: Dict[str, List[Tuple[str, frozenset]]] = {}
        for caller, callee, node, held in self.call_sites:
            sites.setdefault(callee, []).append((caller, held))
        # a root entry (or an externally-callable function — no project
        # callers) starts lock-free; its must-set is pinned at empty
        pinned = {e for r in self.roots.values() for e in r.entries}
        pinned.update(q for q in self.functions
                      if not self.incoming.get(q))
        must: Dict[str, Optional[frozenset]] = \
            {q: (frozenset() if q in pinned else None)
             for q in self.functions}      # None = no information yet
        may: Dict[str, frozenset] = \
            {q: frozenset() for q in self.functions}
        for _ in range(24):
            changed = False
            for callee, ss in sites.items():
                if callee not in must:
                    continue
                macc = set(may[callee])
                acc: Optional[frozenset] = None
                for caller, held in ss:
                    macc |= may.get(caller, frozenset()) | held
                    cm = must.get(caller)
                    if cm is None:
                        continue   # caller unreached so far: no info
                    inc = cm | held
                    acc = inc if acc is None else (acc & inc)
                if callee not in pinned and acc is not None \
                        and acc != must[callee]:
                    cur = must[callee]
                    must[callee] = acc if cur is None else (cur & acc)
                    if must[callee] != cur:
                        changed = True
                if macc != may[callee]:
                    may[callee] = frozenset(macc)
                    changed = True
            if not changed:
                break
        self.must_held = {q: (v or frozenset()) for q, v in must.items()}
        self.may_held = may

    def _build_lock_graph(self):
        for lock, funcq, node, anc in self.acquisitions:
            held_before = anc | self.may_held.get(funcq, frozenset())
            path = self.functions[funcq].ctx.path
            line = getattr(node, "lineno", 1)
            for h in held_before:
                if h == lock:
                    continue
                interproc = h not in anc
                prev = self.lock_edges.get((h, lock))
                if prev is None or (prev[2] and not interproc):
                    self.lock_edges[(h, lock)] = (path, line, interproc)
            self.lock_roots.setdefault(lock, set()).update(
                self.runs_on.get(funcq, frozenset()))

    # -------------------------------------------------------- queries
    def effective_locked(self, acc: StateAccess) -> bool:
        """Locked directly (``with`` ancestor) or via a helper method
        that is only ever called with a lock held."""
        return bool(acc.locks) or \
            bool(self.must_held.get(acc.func, frozenset()))

    def state_roots(self, key: str) -> frozenset:
        roots = set()
        for acc in self.state.get(key, ()):
            roots |= self.runs_on.get(acc.func, frozenset())
        return frozenset(roots)


def build_project(sources: Dict[str, str]) -> ProjectModel:
    """Whole-program model from in-memory sources (unit-test entry).
    Keys are repo-relative posix paths."""
    ctxs = []
    for rel, src in sorted(sources.items()):
        tree = ast.parse(src, filename=rel)
        _ParentAnnotator().visit(tree)
        ctxs.append(FileContext(path=rel.replace(os.sep, "/"),
                                source=src, tree=tree))
    return ProjectModel(ctxs)


def build_model_for_paths(paths: Sequence[str], root: Optional[str] = None,
                          jobs: int = 1) -> ProjectModel:
    """Parse ``paths`` and build the whole-program model (the
    --ownership-report path; findings are not computed)."""
    if root is None and paths:
        root = find_repo_root(paths[0])
    files = iter_python_files(paths)
    if jobs and jobs > 1 and len(files) > 1:
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=jobs) as ex:
            parsed = list(ex.map(lambda p: parse_file(p, root), files))
    else:
        parsed = [parse_file(p, root) for p in files]
    return ProjectModel([ctx for ctx, err in parsed if ctx is not None])
