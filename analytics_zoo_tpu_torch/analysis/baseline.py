"""zoolint baseline — committed, fingerprinted grandfather list.

A finding the team decides to live with (with a one-line justification)
goes in ``dev/zoolint-torch-baseline.json`` instead of an inline suppression —
the source line stays clean and the debt is inventoried in one reviewable
place. Fingerprints (version 2) hash the rule id, the repo-relative path
and the *normalized statement text* (continuation lines joined, comments
stripped, whitespace collapsed, plus an occurrence index for duplicates)
— NOT the line number and NOT the raw wrapping — so edits elsewhere in a
file, and even re-wrapping the offending statement across lines, never
invalidate the baseline, while any semantic edit to the statement itself
retires the entry (the finding resurfaces and must be re-justified or
fixed).
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, Iterable, List, Optional, Tuple

from analytics_zoo_tpu_torch.analysis.core import Finding

BASELINE_VERSION = 2
#: default location, relative to the repo root
DEFAULT_BASELINE = os.path.join("dev", "zoolint-torch-baseline.json")

def _read_lines(root: Optional[str], finding: Finding,
                cache: Dict[str, List[str]]) -> List[str]:
    path = finding.path
    if root is not None and not os.path.isabs(path):
        path = os.path.join(root, path)
    cached = cache.get(path)
    if cached is not None:
        return cached
    try:
        with open(path, "r", encoding="utf-8", errors="replace") as fh:
            lines = fh.read().splitlines()
    except OSError:
        lines = []
    cache[path] = lines
    return lines


def _strip_comment(line: str) -> str:
    """Drop a trailing ``#`` comment, respecting string literals (a naive
    quote-state scan — good enough for fingerprint normalization; an
    f-string with a quoted ``#`` inside a format spec is vanishingly rare
    on a *flagged* line, and mis-stripping only widens the fingerprint)."""
    quote = ""
    i = 0
    while i < len(line):
        c = line[i]
        if quote:
            if c == "\\":
                i += 2
                continue
            if line.startswith(quote, i):
                i += len(quote)
                quote = ""
                continue
        elif c in "\"'":
            quote = line[i:i + 3] if line.startswith(c * 3, i) else c
            i += len(quote)
            continue
        elif c == "#":
            return line[:i]
        i += 1
    return line


def _stmt_text(root: Optional[str], finding: Finding,
               cache: Dict[str, List[str]]) -> str:
    """Fingerprint text: the whole logical statement starting
    at the finding's line — physical lines joined while brackets stay
    open or a backslash continuation is pending — with comments stripped
    and whitespace runs collapsed. Re-wrapping the statement over more or
    fewer lines produces the same text."""
    lines = _read_lines(root, finding, cache)
    i = finding.line - 1
    if i < 0 or i >= len(lines):
        return ""
    parts: List[str] = []
    depth = 0
    for j in range(i, min(i + 40, len(lines))):
        line = _strip_comment(lines[j])
        cont = line.rstrip().endswith("\\")
        if cont:
            line = line.rstrip()[:-1]
        parts.append(line.strip())
        # bracket depth outside string literals (same naive scan)
        quote = ""
        k = 0
        while k < len(line):
            c = line[k]
            if quote:
                if c == "\\":
                    k += 2
                    continue
                if line.startswith(quote, k):
                    k += len(quote)
                    quote = ""
                    continue
            elif c in "\"'":
                quote = line[k:k + 3] if line.startswith(c * 3, k) else c
                k += len(quote)
                continue
            elif c in "([{":
                depth += 1
            elif c in ")]}":
                depth = max(0, depth - 1)
            k += 1
        if depth == 0 and not cont:
            break
    return " ".join(" ".join(parts).split())


def fingerprints(findings: Iterable[Finding], root: Optional[str]
                 ) -> List[Tuple[Finding, str]]:
    """Stable fingerprint per finding. Identical (rule, path, text)
    triples get an occurrence counter so N copies of the same offending
    statement need N baseline entries — deleting one resurfaces one."""
    # file cache scoped to this call: callers may edit sources between
    # fingerprint passes (the round-trip tests do)
    cache: Dict[str, List[str]] = {}
    counts: Dict[str, int] = {}
    out = []
    for f in sorted(findings, key=lambda f: (f.path, f.line, f.col, f.rule)):
        base = f"{f.rule}\x00{f.path}\x00{_stmt_text(root, f, cache)}"
        n = counts.get(base, 0)
        counts[base] = n + 1
        digest = hashlib.sha256(
            f"{base}\x00{n}".encode("utf-8")).hexdigest()[:16]
        out.append((f, digest))
    return out


def load(path: str) -> Dict[str, dict]:
    """fingerprint -> entry dict. Missing file = empty baseline."""
    if not os.path.isfile(path):
        return {}
    with open(path, "r", encoding="utf-8") as fh:
        data = json.load(fh)
    version = data.get("version")
    if version != BASELINE_VERSION:
        raise ValueError(
            f"baseline {path}: unsupported version {version!r}")
    return {e["fingerprint"]: e for e in data.get("entries", ())}


def save(path: str, findings: Iterable[Finding], root: Optional[str],
         justifications: Optional[Dict[str, str]] = None) -> int:
    """Write a baseline covering ``findings``. Existing justifications at
    ``path`` are preserved for fingerprints that survive; new entries get
    a TODO marker that review is expected to replace."""
    prior = {}
    if os.path.isfile(path):
        try:
            prior = load(path)
        except ValueError:
            prior = {}
    entries = []
    for f, fp in fingerprints(findings, root):
        just = (justifications or {}).get(fp) \
            or prior.get(fp, {}).get("justification") \
            or "TODO: justify or fix"
        entries.append({"fingerprint": fp, "rule": f.rule, "path": f.path,
                        "line": f.line, "message": f.message,
                        "justification": just})
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w", encoding="utf-8") as fh:
        json.dump({"version": BASELINE_VERSION, "entries": entries},
                  fh, indent=2, sort_keys=False)
        fh.write("\n")
    return len(entries)


def prune(path: str, stale_fps: Iterable[str]) -> int:
    """Rewrite the baseline at ``path`` without the given fingerprints,
    preserving entry order and justifications. Returns how many entries
    were removed. A missing file prunes nothing."""
    if not os.path.isfile(path):
        return 0
    with open(path, "r", encoding="utf-8") as fh:
        data = json.load(fh)
    drop = set(stale_fps)
    entries = [e for e in data.get("entries", ())
               if e.get("fingerprint") not in drop]
    removed = len(data.get("entries", ())) - len(entries)
    if removed:
        data["entries"] = entries
        with open(path, "w", encoding="utf-8") as fh:
            json.dump(data, fh, indent=2, sort_keys=False)
            fh.write("\n")
    return removed


def apply(findings: List[Finding], baseline: Dict[str, dict],
          root: Optional[str]) -> Tuple[List[Finding], List[dict]]:
    """(surviving findings, stale baseline entries). A stale entry's
    offending statement was fixed or edited — it should be deleted from
    the baseline file (reported as a warning, never a failure)."""
    matched = set()
    out = []
    for f, fp in fingerprints(findings, root):
        if fp in baseline:
            matched.add(fp)
        else:
            out.append(f)
    stale = [e for fp, e in baseline.items() if fp not in matched]
    return out, stale
