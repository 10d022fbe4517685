"""Data-plane rules — row-at-a-time pandas in the shard transform layer.

The Flare argument (PAPERS.md 1703.08219): an interpreted per-row data
plane dominates end-to-end recsys time, so the Friesian transforms were
rewritten as fixed-width numpy kernels (friesian/feature/table.py). This
rule keeps them that way: a ``Series.map(lambda ...)`` or
``DataFrame.apply(..., axis=1)`` in ``analytics_zoo_tpu_torch/data/`` or
a ``friesian/`` package re-introduces a Python call per row. The legacy
``ZOO_DATA_VECTORIZE=0`` bodies are baselined
(dev/zoolint-torch-baseline.json);
the sanctioned row-wise seam is ``transform_python_udf``, whose UDF arrives
as a parameter, not a lambda.
"""

from __future__ import annotations

import ast
from typing import Iterable, List

from analytics_zoo_tpu_torch.analysis.core import (
    FileContext, Finding, Rule, ancestors, register,
)

#: path segments that mark the data plane (matches both the shipped
#: ``analytics_zoo_tpu_torch/data``/``friesian`` trees and test fixtures)
_DATA_PLANE_SEGMENTS = frozenset({"data", "friesian"})

_FUNCS = (ast.FunctionDef, ast.AsyncFunctionDef)


def _in_data_plane(path: str) -> bool:
    return bool(_DATA_PLANE_SEGMENTS & set(path.split("/")[:-1]))


def _nested_def_names(node: ast.AST) -> set:
    """Names of functions defined inside the enclosing functions of
    ``node`` — a ``.map(pad_one)`` where ``pad_one`` is a nested def is a
    per-row Python kernel just like a lambda."""
    names = set()
    for a in ancestors(node):
        if isinstance(a, _FUNCS):
            for n in ast.walk(a):
                if isinstance(n, _FUNCS) and n is not a:
                    names.add(n.name)
    return names


def _axis_is_1(call: ast.Call) -> bool:
    for kw in call.keywords:
        if kw.arg == "axis" and isinstance(kw.value, ast.Constant) \
                and kw.value.value in (1, "columns"):
            return True
    return False


@register
class RowwiseMapInDataPlane(Rule):
    id = "rowwise-map-in-data-plane"
    description = ("Series.map(lambda)/nested-def or DataFrame.apply(axis=1) "
                   "in the data plane — a Python call per row; write a "
                   "vectorized numpy/pandas kernel instead")

    def check_file(self, ctx: FileContext) -> Iterable[Finding]:
        if not _in_data_plane(ctx.path):
            return
        for node in ctx.walk():
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)):
                continue
            attr = node.func.attr
            if attr == "map":
                hit = None
                for arg in node.args:
                    if isinstance(arg, ast.Lambda):
                        hit = "a lambda"
                    elif isinstance(arg, ast.Name) \
                            and arg.id in _nested_def_names(node):
                        hit = f"nested def `{arg.id}`"
                if hit:
                    yield Finding(
                        self.id, ctx.path, node.lineno, node.col_offset,
                        f".map({hit}) in the data plane runs a Python call "
                        "per row — replace with a vectorized kernel "
                        "(preallocated ndarray fill / searchsorted take), "
                        "or route real UDFs through transform_python_udf")
            elif attr == "apply" and _axis_is_1(node):
                yield Finding(
                    self.id, ctx.path, node.lineno, node.col_offset,
                    ".apply(axis=1) in the data plane materializes a Series "
                    "per row — use column-wise numpy ops instead")
