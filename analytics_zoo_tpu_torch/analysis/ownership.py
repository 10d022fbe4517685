"""Thread-ownership report — the reviewable artifact behind
``--ownership-report``.

Renders the :class:`core.ProjectModel` into a markdown map (and a JSON
twin next to it) answering the questions a concurrency review starts
with: which thread roots exist and where are they spawned, which shared
state does each root own exclusively, which state is shared and which
lock guards it, and which classes opt out via a confinement contract.
``docs/concurrency_torch.md`` is the committed rendering for the port's
tree; tests/test_torch_zoolint_interproc.py regenerates it and fails on
drift, so the map can never silently fall behind the code.

Everything here is deterministic (sorted iteration, no timestamps) —
regenerating from an unchanged tree is byte-identical.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

from analytics_zoo_tpu_torch.analysis.core import ProjectModel

REPORT_SCHEMA_VERSION = 1

_GENERATED_NOTE = (
    "<!-- Generated by `python -m analytics_zoo_tpu_torch.analysis "
    "--ownership-report docs/concurrency_torch.md`. Do not edit by hand: "
    "tests/test_torch_zoolint_interproc.py regenerates this file and "
    "fails on drift. -->")

#: the package named in the map's introduction when the scanned files
#: do not share one top-level directory
_DEFAULT_PACKAGE = "analytics_zoo_tpu_torch"


def _package(model: ProjectModel) -> str:
    """The top-level directory every scanned file lies under."""
    tops = {c.path.split("/", 1)[0] for c in model.files if "/" in c.path}
    return tops.pop() if len(tops) == 1 else _DEFAULT_PACKAGE


def _root_sort_key(rid: str) -> Tuple[int, str]:
    return (0 if rid == "main" else 1, rid)


def _state_rows(model: ProjectModel) -> List[dict]:
    """One row per shared-state key: owning roots, guarding locks, and a
    classification (confined / guarded / unlocked-shared)."""
    rows = []
    for key in sorted(model.state):
        accesses = model.state[key]
        live = [a for a in accesses
                if model.runs_on.get(a.func, frozenset())]
        if not live:
            continue
        owner_cls = model.classes.get(key.rsplit(".", 1)[0])
        roots = sorted(model.state_roots(key), key=_root_sort_key)
        writes = [a for a in live if a.write]
        locks = set()
        unlocked_writes = 0
        for a in writes:
            held = set(a.locks) | set(
                model.must_held.get(a.func, frozenset()))
            if held:
                locks |= held
            else:
                unlocked_writes += 1
        if owner_cls is not None and owner_cls.confined_by_contract:
            classification = "confined-by-contract"
        elif len(roots) <= 1:
            classification = "confined"
        elif writes and unlocked_writes == 0:
            classification = "lock-guarded"
        elif not writes:
            classification = "read-only"
        else:
            classification = "shared-unlocked"
        # main confines most of the tree by definition — inventorying
        # every main-only key would bury the signal; the map reports
        # state owned by a *spawned* root or shared between roots
        if roots == ["main"]:
            continue
        rows.append({
            "state": key,
            "kind": "attr" if owner_cls is not None else "global",
            "roots": roots,
            "locks": sorted(locks),
            "classification": classification,
            "reads": sum(1 for a in live if not a.write),
            "writes": len(writes),
        })
    return rows


def build_report(model: ProjectModel) -> dict:
    """The JSON-shaped ownership map (markdown renders from this)."""
    roots = []
    for rid in sorted(model.roots, key=_root_sort_key):
        r = model.roots[rid]
        reach = sorted(q for q, on in model.runs_on.items() if rid in on)
        roots.append({
            "root": rid,
            "kind": r.kind,
            "site": f"{r.site[0]}:{r.site[1]}" if r.site else None,
            # main's entry set is "every externally-callable function" —
            # too big to inventory usefully; the definition suffices
            "entries": [] if rid == "main" else sorted(r.entries),
            "reachable_functions": len(reach),
        })
    state = _state_rows(model)
    by_root: Dict[str, List[str]] = {}
    for row in state:
        if row["classification"] in ("confined", "confined-by-contract") \
                and len(row["roots"]) == 1:
            by_root.setdefault(row["roots"][0], []).append(row["state"])
    locks = [{"lock": lock,
              "roots": sorted(model.lock_roots[lock], key=_root_sort_key)}
             for lock in sorted(model.lock_roots)]
    confined = [c.qual for c in
                sorted(model.classes.values(), key=lambda c: c.qual)
                if c.confined_by_contract]
    return {
        "version": REPORT_SCHEMA_VERSION,
        "roots": roots,
        "owned_state": {rid: sorted(keys)
                        for rid, keys in sorted(by_root.items())},
        "state": state,
        "locks": locks,
        "confined_classes": confined,
    }


def _md_table(headers: List[str], rows: List[List[str]]) -> List[str]:
    out = ["| " + " | ".join(headers) + " |",
           "|" + "|".join("---" for _ in headers) + "|"]
    out += ["| " + " | ".join(r) + " |" for r in rows]
    return out


def render_markdown(report: dict,
                    package: str = _DEFAULT_PACKAGE) -> str:
    lines = ["# Thread-ownership map", "", _GENERATED_NOTE, "",
             "The whole-program analyzer's view of every thread root in "
             f"`{package}`, the state each root owns, and the "
             "locks guarding what is shared. See `docs/zoolint.md` for "
             "the rules enforcing this map.", ""]

    lines += ["## Thread roots", ""]
    rows = []
    for r in report["roots"]:
        if r["root"] == "main":
            entries = "*(every externally-callable function)*"
        else:
            shown = r["entries"][:4]
            entries = ", ".join(f"`{e}`" for e in shown) or "—"
            extra = len(r["entries"]) - len(shown)
            if extra > 0:
                entries += f", … +{extra} more"
        rows.append([f"`{r['root']}`", r["kind"], r["site"] or "—",
                     entries, str(r["reachable_functions"])])
    lines += _md_table(
        ["root", "kind", "spawned at", "entry", "reaches"], rows)

    lines += ["", "## Exclusively-owned state", "",
              "State only ever touched from one root — thread-confined "
              "by construction, no lock needed.", ""]
    owned = report["owned_state"]
    if owned:
        rows = [[f"`{rid}`", ", ".join(f"`{k}`" for k in keys)]
                for rid, keys in owned.items()]
        lines += _md_table(["root", "owns"], rows)
    else:
        lines += ["(none)"]

    lines += ["", "## Shared state", "",
              "State reachable from two or more roots, with the lock "
              "that guards every write (or the baseline entry that "
              "justifies its absence).", ""]
    rows = []
    for row in report["state"]:
        if len(row["roots"]) < 2 or \
                row["classification"] == "confined-by-contract":
            continue
        locks = ", ".join(f"`{x}`" for x in row["locks"]) or "—"
        rows.append([f"`{row['state']}`", row["classification"], locks,
                     ", ".join(f"`{r}`" for r in row["roots"])])
    if rows:
        lines += _md_table(["state", "class", "guarded by", "roots"], rows)
    else:
        lines += ["(none)"]

    lines += ["", "## Locks", ""]
    rows = [[f"`{x['lock']}`",
             ", ".join(f"`{r}`" for r in x["roots"]) or "—"]
            for x in report["locks"]]
    lines += _md_table(["lock", "acquired from"], rows)

    lines += ["", "## Confined-by-contract classes", "",
              "Docstring-declared single-owner types (\"Not "
              "thread-safe\", \"thread-compatible\", …) — their "
              "attributes are exempt from `cross-thread-unlocked-state` "
              "because confinement is the documented API contract.", ""]
    lines += [f"- `{c}`" for c in report["confined_classes"]] or ["(none)"]
    lines.append("")
    return "\n".join(lines)


def write_report(model: ProjectModel, md_path: str,
                 json_path: Optional[str] = None) -> Tuple[str, str]:
    """Write the markdown map at ``md_path`` and its JSON twin next to
    it (``<md_path minus extension>.json`` unless given). Returns both
    paths."""
    report = build_report(model)
    if json_path is None:
        json_path = os.path.splitext(md_path)[0] + ".json"
    for p in (md_path, json_path):
        d = os.path.dirname(os.path.abspath(p))
        os.makedirs(d, exist_ok=True)
    with open(md_path, "w", encoding="utf-8") as fh:
        fh.write(render_markdown(report, _package(model)))
    with open(json_path, "w", encoding="utf-8") as fh:
        json.dump(report, fh, indent=2, sort_keys=False)
        fh.write("\n")
    return md_path, json_path
