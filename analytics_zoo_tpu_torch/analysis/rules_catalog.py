"""Catalog-drift rules — the code and the observability catalog must
agree.

docs/observability.md declares every ``zoo_*`` metric name **stable**
("tests and dashboards key on them") and documents the ``ZOO_*`` env
knobs; both packages keep those names. docs/observability_torch.md adds
what only the port reads, and lists the rows of observability.md the
port does not register, each with its reason, under a heading that says
so ("... not register ..."). Drift in either direction is a real bug: an
undocumented metric is invisible to dashboard authors, a documented-but-
unregistered metric is a dashboard keyed on nothing. These are
project-scope rules — they see every scanned file at once — and the same
check is exposed as a plain function, :func:`catalog_drift`, so a test
catches drift even without the CLI.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Iterable, List, Optional, Tuple

from analytics_zoo_tpu_torch.analysis.core import (
    Finding, ProjectContext, Rule, analyze_paths, find_repo_root, register,
)

_REGISTRY_METHODS = frozenset({"counter", "gauge", "histogram"})
_METRIC_PREFIX = "zoo_"
_ENV_PREFIX = "ZOO_"

#: catalog table rows: ``| `zoo_name` | kind | ...``
_DOC_METRIC_ROW = re.compile(r"^\|\s*`(zoo_[a-z0-9_]+)`", re.M)
#: any backticked/bare mention counts as "documented"
_DOC_METRIC_ANY = re.compile(r"\b(zoo_[a-z0-9_]+)\b")
_DOC_ENV_ANY = re.compile(r"\b(ZOO_[A-Z0-9_]+)\b")


#: the catalog files, repo-relative: the stable names both packages use,
#: then the port's own (either may be absent)
CATALOG_DOCS = ("docs/observability.md", "docs/observability_torch.md")

#: a heading whose section lists catalog rows the port does not register
_WAIVER_HEADING = re.compile(r"^#+ .*\bnot register", re.I)
_HEADING = re.compile(r"^#+ ")


def _read_catalog(root: Optional[str]) -> List[Tuple[str, str]]:
    """(repo-relative path, text) of each catalog file present."""
    if root is None:
        return []
    out = []
    for rel in CATALOG_DOCS:
        p = os.path.join(root, *rel.split("/"))
        if os.path.isfile(p):
            with open(p, "r", encoding="utf-8") as fh:
                out.append((rel, fh.read()))
    return out


def _read_docs(root: Optional[str]) -> Optional[str]:
    """Every catalog file's text, or None when there is none."""
    docs = _read_catalog(root)
    return "\n".join(text for _, text in docs) if docs else None


def _waived(text: str) -> set:
    """Metric rows listed under a "... not register ..." heading."""
    out, inside = set(), False
    for line in text.splitlines():
        if _HEADING.match(line):
            inside = bool(_WAIVER_HEADING.match(line))
        elif inside:
            m = _DOC_METRIC_ROW.match(line)
            if m:
                out.add(m.group(1))
    return out


def _registered_metrics(pctx: ProjectContext) -> List[
        Tuple[str, str, int, int]]:
    """Every ``reg.counter/gauge/histogram("zoo_...")`` registration in
    the scanned files: (metric, path, line, col)."""
    out = []
    for ctx in pctx.files:
        for node in ctx.walk():
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in _REGISTRY_METHODS
                    and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)
                    and node.args[0].value.startswith(_METRIC_PREFIX)):
                continue
            out.append((node.args[0].value, ctx.path,
                        node.lineno, node.col_offset))
    return out


def _env_reads(pctx: ProjectContext) -> List[Tuple[str, str, int, int]]:
    """Every ``ZOO_*`` env read: os.environ.get/[], os.getenv,
    environ.get — (var, path, line, col)."""
    out = []
    for ctx in pctx.files:
        for node in ctx.walk():
            var = None
            if isinstance(node, ast.Call):
                name = ctx.imports.resolve(node.func)
                tail = name.split(".")[-1] if name else ""
                if (name == "os.getenv"
                        or (tail == "get" and "environ" in name)) \
                        and node.args \
                        and isinstance(node.args[0], ast.Constant):
                    var = node.args[0].value
            elif isinstance(node, ast.Subscript):
                base = node.value
                if isinstance(base, ast.Attribute) \
                        and base.attr == "environ":
                    sl = node.slice
                    if isinstance(sl, ast.Constant):
                        var = sl.value
            if isinstance(var, str) and var.startswith(_ENV_PREFIX):
                out.append((var, ctx.path, node.lineno, node.col_offset))
    return out


#: the port's package root marker (see ``_scan_covers_package``)
PACKAGE_WITNESS = "analytics_zoo_tpu_torch/__init__.py"


def _scan_covers_package(pctx: ProjectContext) -> bool:
    """Doc→code drift only makes sense when the scan includes the WHOLE
    package tree — a fixture-only or subtree scan registers few/no
    metrics and would flag every documented one. Scanning the package
    root always pulls in its __init__.py, so that file is the witness."""
    return any(c.path == PACKAGE_WITNESS for c in pctx.files)


@register
class MetricUndocumented(Rule):
    """A ``zoo_*`` metric registered in code but absent from the
    catalog (docs/observability.md, docs/observability_torch.md)."""

    id = "metric-undocumented"
    scope = "project"
    description = "registered zoo_* metric missing from the docs catalog"

    def check_project(self, pctx: ProjectContext) -> Iterable[Finding]:
        docs = _read_docs(pctx.root)
        if docs is None:
            return
        documented = set(_DOC_METRIC_ANY.findall(docs))
        for metric, path, line, col in _registered_metrics(pctx):
            if metric not in documented:
                yield Finding(
                    self.id, path, line, col,
                    f"metric {metric!r} is registered here but missing "
                    "from the catalog (docs/observability.md) — add a "
                    "row (metric names are a stable interface)")


@register
class MetricUndeclared(Rule):
    """A catalog row whose metric no scanned code registers — a
    dashboard keyed on nothing. Rows that docs/observability_torch.md
    lists under a "... not register ..." heading are the port's stated
    choices and are skipped."""

    id = "metric-undeclared"
    scope = "project"
    description = "docs catalog row with no registration in code"

    def check_project(self, pctx: ProjectContext) -> Iterable[Finding]:
        catalog = _read_catalog(pctx.root)
        if not catalog or not _scan_covers_package(pctx):
            return
        registered = {m for m, *_ in _registered_metrics(pctx)}
        waived = set()
        for _, text in catalog:
            waived |= _waived(text)
        for doc_rel, docs in catalog:
            for m in _DOC_METRIC_ROW.finditer(docs):
                metric = m.group(1)
                if metric not in registered and metric not in waived:
                    line = docs.count("\n", 0, m.start()) + 1
                    yield Finding(
                        self.id, doc_rel, line, 0,
                        f"catalog documents {metric!r} but nothing in the "
                        "scanned tree registers it — remove the row or "
                        "restore the metric")


@register
class EnvvarUndocumented(Rule):
    """A ``ZOO_*`` env var read in code but never mentioned in the
    catalog."""

    id = "envvar-undocumented"
    scope = "project"
    description = "ZOO_* env var read but undocumented"

    def check_project(self, pctx: ProjectContext) -> Iterable[Finding]:
        docs = _read_docs(pctx.root)
        if docs is None:
            return
        documented = set(_DOC_ENV_ANY.findall(docs))
        for var, path, line, col in _env_reads(pctx):
            if var not in documented:
                yield Finding(
                    self.id, path, line, col,
                    f"env var {var!r} is read here but undocumented — "
                    "mention it in docs/observability.md (or, read by "
                    "the port alone, docs/observability_torch.md)")


def catalog_drift(root: Optional[str] = None) -> List[Finding]:
    """The catalog checks as a plain function: scan the repo's
    ``analytics_zoo_tpu_torch`` package with only the three catalog
    rules. tests/test_torch_zoolint.py asserts this returns [] so the
    tests fail on drift even where the CLI is not run."""
    if root is None:
        root = find_repo_root(os.path.dirname(os.path.abspath(__file__)))
    if root is None:
        raise RuntimeError("repo root not found")
    rules = {r.id: r for r in (
        MetricUndocumented(), MetricUndeclared(), EnvvarUndocumented())}
    return analyze_paths([os.path.join(root, "analytics_zoo_tpu_torch")],
                         rules=rules, root=root)
