"""``python -m analytics_zoo_tpu_torch.analysis`` — the zoolint CLI.

Exit codes: 0 clean (modulo baseline + inline suppressions), 1 findings,
2 usage error, 3 internal crash (so CI can tell "the tree has findings"
from "the linter itself broke"). tests/test_torch_zoolint.py and
chip_smoke.py's phase 26 require exit 0 on the port's tree and exit 1
on tests/fixtures/zoolint_torch's seeded violations.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
import traceback
from typing import List, Optional

from analytics_zoo_tpu_torch.analysis import baseline as baseline_lib
from analytics_zoo_tpu_torch.analysis import report
from analytics_zoo_tpu_torch.analysis.core import (
    CFG_STATS, all_rules, analyze_paths, build_model_for_paths,
    find_repo_root, iter_python_files, relpath,
)


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m analytics_zoo_tpu_torch.analysis",
        description="zoolint for the PyTorch port: AST-based static "
                    "analysis "
                    "(hot-path syncs, recompile hazards, whole-program "
                    "concurrency, catalog drift)")
    p.add_argument("paths", nargs="*", default=["analytics_zoo_tpu_torch"],
                   help="files/directories to scan "
                        "(default: analytics_zoo_tpu_torch)")
    p.add_argument("--format", choices=("human", "json"),
                   default="human",
                   help="human (default) or json (stable schema)")
    p.add_argument("--rules", metavar="ID[,ID...]",
                   help="run only these rule ids")
    p.add_argument("--list-rules", action="store_true",
                   help="print the rule catalog and exit")
    p.add_argument("--jobs", type=int, default=0, metavar="N",
                   help="parse files with N threads (0 = auto)")
    p.add_argument("--baseline", metavar="PATH",
                   help="baseline file (default: <repo>/dev/"
                        "zoolint-torch-baseline.json when it exists)")
    p.add_argument("--no-baseline", action="store_true",
                   help="ignore any baseline file")
    p.add_argument("--write-baseline", action="store_true",
                   help="write the current findings to the baseline "
                        "(preserving surviving justifications) and exit 0")
    p.add_argument("--prune-baseline", nargs="?", const="report",
                   choices=("report", "fix"), metavar="fix",
                   help="list baseline entries whose fingerprint matched "
                        "no finding in this scan; --prune-baseline=fix "
                        "also deletes them from the file (exit 0 either "
                        "way)")
    p.add_argument("--timing", action="store_true",
                   help="print scan wall time and CFG cache statistics "
                        "to stderr")
    p.add_argument("--ownership-report", metavar="PATH",
                   help="write the whole-program thread-ownership map "
                        "(markdown at PATH, JSON next to it) and exit 0")
    return p


def _jobs(args) -> int:
    if args.jobs > 0:
        return args.jobs
    return min(8, os.cpu_count() or 1)


def main(argv: Optional[List[str]] = None) -> int:
    args = _parser().parse_args(argv)
    try:
        return _run(args)
    except SystemExit:
        raise
    except BaseException:
        traceback.print_exc()
        print("zoolint: internal error (exit 3) — this is a linter bug, "
              "not a finding", file=sys.stderr)
        return 3


def _run(args) -> int:
    rules = all_rules()
    if args.list_rules:
        for rid in sorted(rules):
            r = rules[rid]
            print(f"{rid:28s} [{r.scope:7s}] {r.description}")
        return 0
    if args.rules:
        wanted = {r.strip() for r in args.rules.split(",") if r.strip()}
        unknown = wanted - set(rules)
        if unknown:
            print(f"unknown rule id(s): {', '.join(sorted(unknown))}",
                  file=sys.stderr)
            return 2
        rules = {rid: r for rid, r in rules.items() if rid in wanted}
    for p in args.paths:
        if not os.path.exists(p):
            print(f"no such path: {p}", file=sys.stderr)
            return 2
    root = find_repo_root(args.paths[0])

    if args.ownership_report:
        model = build_model_for_paths(args.paths, root=root,
                                      jobs=_jobs(args))
        from analytics_zoo_tpu_torch.analysis import ownership
        md, js = ownership.write_report(model, args.ownership_report)
        print(f"ownership report written: {md} + {js} "
              f"({len(model.roots)} roots)")
        return 0

    CFG_STATS["built"] = CFG_STATS["hits"] = 0
    t0 = time.perf_counter()
    findings = analyze_paths(args.paths, rules=rules, root=root,
                             jobs=_jobs(args))
    if args.timing:
        n_files = sum(1 for _ in iter_python_files(args.paths))
        print(f"zoolint: scanned {n_files} files in "
              f"{time.perf_counter() - t0:.2f}s (CFGs "
              f"built={CFG_STATS['built']} "
              f"cache-hits={CFG_STATS['hits']})", file=sys.stderr)

    baseline_path = args.baseline
    if baseline_path is None and root is not None:
        cand = os.path.join(root, baseline_lib.DEFAULT_BASELINE)
        if os.path.isfile(cand) or args.write_baseline:
            baseline_path = cand
    if args.write_baseline:
        if baseline_path is None:
            print("--write-baseline needs --baseline or a repo root",
                  file=sys.stderr)
            return 2
        n = baseline_lib.save(baseline_path, findings, root)
        print(f"baseline written: {baseline_path} ({n} entries)")
        return 0
    if args.prune_baseline:
        if baseline_path is None or not os.path.isfile(baseline_path):
            print("--prune-baseline: no baseline file to prune")
            return 0
        try:
            entries = baseline_lib.load(baseline_path)
        except ValueError as e:
            print(str(e), file=sys.stderr)
            return 2
        # like apply() below, only entries this run could have re-found
        # are judged — a partial scan must never prune what it cannot see
        scanned = {relpath(p, root) for p in iter_python_files(args.paths)}
        in_scope = {fp: e for fp, e in entries.items()
                    if e["path"] in scanned and e["rule"] in rules}
        _, stale = baseline_lib.apply(findings, in_scope, root)
        if not stale:
            print(f"baseline {baseline_path}: 0 stale entries "
                  f"({len(in_scope)} in scope)")
            return 0
        for e in stale:
            print(f"stale baseline entry {e['fingerprint']} "
                  f"({e['rule']} at {e['path']}:{e['line']})")
        if args.prune_baseline == "fix":
            n = baseline_lib.prune(
                baseline_path, {e["fingerprint"] for e in stale})
            print(f"baseline pruned: {baseline_path} "
                  f"({n} entries removed)")
        else:
            print(f"{len(stale)} stale entr"
                  f"{'y' if len(stale) == 1 else 'ies'} — re-run with "
                  f"--prune-baseline=fix to delete them")
        return 0

    stale: List[dict] = []
    if baseline_path is not None and not args.no_baseline:
        try:
            entries = baseline_lib.load(baseline_path)
        except ValueError as e:
            print(str(e), file=sys.stderr)
            return 2
        # a partial scan (subset of paths or --rules) must not report
        # out-of-scope baseline entries as stale — judge staleness only
        # for entries this run could have re-found
        scanned = {relpath(p, root) for p in iter_python_files(args.paths)}
        in_scope = {fp: e for fp, e in entries.items()
                    if e["path"] in scanned and e["rule"] in rules}
        findings, stale = baseline_lib.apply(findings, in_scope, root)

    if args.format == "json":
        print(report.json_report(findings, stale, root))
    else:
        print(report.human_report(findings, stale))
    return 1 if findings else 0
