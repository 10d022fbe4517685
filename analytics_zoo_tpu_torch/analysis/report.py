"""zoolint reporters — human (one finding per line, grep/editor-friendly),
GitHub workflow annotations, and JSON (stable schema for CI tooling;
schema changes bump ``JSON_SCHEMA_VERSION`` and are asserted by
tests/test_torch_zoolint.py)."""

from __future__ import annotations

import json
from typing import Dict, List, Optional

from analytics_zoo_tpu_torch.analysis.baseline import fingerprints
from analytics_zoo_tpu_torch.analysis.core import Finding

JSON_SCHEMA_VERSION = 1


def human_report(findings: List[Finding], stale: List[dict]) -> str:
    lines = [f.format() for f in findings]
    for e in stale:
        lines.append(
            f"warning: stale baseline entry {e['fingerprint']} "
            f"({e['rule']} at {e['path']}) no longer matches — delete it")
    if findings:
        by_rule: Dict[str, int] = {}
        for f in findings:
            by_rule[f.rule] = by_rule.get(f.rule, 0) + 1
        summary = ", ".join(f"{r}={n}" for r, n in sorted(by_rule.items()))
        lines.append(f"zoolint: {len(findings)} finding(s) ({summary})")
    else:
        lines.append("zoolint: clean")
    return "\n".join(lines)


def github_report(findings: List[Finding], stale: List[dict]) -> str:
    """GitHub Actions workflow-annotation lines — `--format=github` in
    CI makes every finding a review annotation on the touched line."""
    def esc(msg: str) -> str:
        # the annotation grammar reserves %, \r, \n in the message part
        return (msg.replace("%", "%25").replace("\r", "%0D")
                   .replace("\n", "%0A"))

    lines = [f"::error file={f.path},line={f.line},col={f.col + 1},"
             f"title=zoolint {f.rule}::{esc(f.message)}"
             for f in findings]
    lines += [f"::warning file={e['path']},title=zoolint stale baseline::"
              f"baseline entry {e['fingerprint']} ({e['rule']}) no longer "
              f"matches - delete it" for e in stale]
    if not lines:
        lines.append("::notice title=zoolint::clean")
    return "\n".join(lines)


def json_report(findings: List[Finding], stale: List[dict],
                root: Optional[str]) -> str:
    fps = dict((id(f), fp) for f, fp in fingerprints(findings, root))
    by_rule: Dict[str, int] = {}
    for f in findings:
        by_rule[f.rule] = by_rule.get(f.rule, 0) + 1
    obj = {
        "version": JSON_SCHEMA_VERSION,
        "findings": [
            {"rule": f.rule, "path": f.path, "line": f.line, "col": f.col,
             "message": f.message, "fingerprint": fps[id(f)]}
            for f in findings],
        "stale_baseline": [e["fingerprint"] for e in stale],
        "summary": {"total": len(findings), "by_rule": by_rule},
    }
    return json.dumps(obj, indent=2)
