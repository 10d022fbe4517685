"""zoolint for the PyTorch port — AST-based, PyTorch-aware static
analysis for this codebase's real failure modes, with the JAX package's
rule ids. Rule catalog: docs/zoolint.md, with the port's readings of the
framework-bound rules in docs/zoolint_torch.md; thread-ownership map:
docs/concurrency_torch.md (regenerate with ``--ownership-report``). The
analyser reads source text only: it imports neither torch nor anything
of the package it scans.

Five rule families:

- **hot-path sync** (`wallclock-hotpath`, `hotpath-host-sync`) — wall-
  clock timing and implicit host↔device syncs in the serve/dispatch/train
  inner loops under serving/, common/, learn/;
- **recompile hazard** (`jit-in-loop`, `jit-call-inline`,
  `jit-static-unhashable`, `jit-compile-in-serve-loop`) — compile
  constructions that silently recompile, and builds on the serve thread;
- **concurrency, per-file** (`engine-unlocked-write`, `lock-order`) —
  unlocked cross-thread attribute writes in Thread-spawning classes,
  same-file ABBA lock inversions;
- **concurrency, whole-program** (`cross-thread-unlocked-state`,
  `lock-order-inversion`, `blocking-under-lock`, `thread-leak`) — a
  project-wide call graph with thread-root inference and runs-on
  propagation catches races, inversions, and leaks that span modules;
- **catalog drift** (`metric-undocumented`, `metric-undeclared`,
  `envvar-undocumented`) — code vs docs/observability.md (and
  docs/observability_torch.md) agreement.

The path-sensitive rules (`record-ack-leak`, `lock-release-path`,
`span-pairing`, `tainted-host-sync`, `shape-dependent-branch-in-jit`,
`kv-page-leak`) run a dataflow solver over per-function CFGs.

CLI: ``python -m analytics_zoo_tpu_torch.analysis [paths...]``. Suppress a
finding in place with ``# zoolint: disable=RULE`` (or grandfather it in
``dev/zoolint-torch-baseline.json`` with a justification).
"""

from analytics_zoo_tpu_torch.analysis.core import (  # noqa: F401
    Finding, Rule, all_rules, analyze_paths, analyze_source,
    build_model_for_paths, build_project, find_repo_root,
)
from analytics_zoo_tpu_torch.analysis.rules_catalog import (  # noqa: F401
    catalog_drift,
)

__all__ = ["Finding", "Rule", "all_rules", "analyze_paths",
           "analyze_source", "build_model_for_paths", "build_project",
           "catalog_drift", "find_repo_root"]
