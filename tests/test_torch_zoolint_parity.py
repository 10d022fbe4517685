"""The port's zoolint against the JAX package's, on the same trees.

The 15 rules not bound to a framework (wall clock, the concurrency and
lock rules, the catalog, the data plane and the lifecycle rules) must
report the same (rule, path, line, col) set as JAX's analyser: on JAX's
seeded fixture trees (the fleet tree with ``analytics_zoo_tpu/`` renamed
``analytics_zoo_tpu_torch/`` for the port), on the port's own tree and
on the JAX package. Both read the same catalog (docs/observability.md)
and look for their own package witness. And the port's
``--ownership-report`` over the JAX package writes JAX's
docs/concurrency.md, with only the generated note naming the tool
changed. JAX's analyser is imported only inside the fixtures.

The port's call graph differs from JAX's in one place: it never joins a
call on a name imported from outside the scanned packages
(``torch.cuda.stream(s)``, ``json.dump(...)``) to a project method by the
method's name alone (``ProjectModel._outside_receiver``). Where a tree
has such calls, the comparison runs twice: with that check switched off
the sets are equal, and with it on the port reports JAX's set less the
findings that only those false edges made, named here one by one.
"""

import os
import shutil

import pytest

from analytics_zoo_tpu_torch.analysis import analyze_paths
from analytics_zoo_tpu_torch.analysis import cli
from analytics_zoo_tpu_torch.analysis import rules_catalog
from analytics_zoo_tpu_torch.analysis.core import ProjectModel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

NEUTRAL = frozenset({
    "wallclock-hotpath", "engine-unlocked-write", "lock-order",
    "cross-thread-unlocked-state", "lock-order-inversion",
    "blocking-under-lock", "thread-leak", "metric-undocumented",
    "metric-undeclared", "envvar-undocumented",
    "rowwise-map-in-data-plane", "record-ack-leak", "lock-release-path",
    "span-pairing", "kv-page-leak",
})


@pytest.fixture
def jax_zoolint():
    """JAX's analyser: its analyze_paths and its catalog module."""
    from analytics_zoo_tpu.analysis import analyze_paths as jax_analyze
    from analytics_zoo_tpu.analysis import all_rules as jax_rules
    from analytics_zoo_tpu.analysis import rules_catalog as jax_catalog
    return jax_analyze, jax_rules, jax_catalog


@pytest.fixture
def one_catalog(monkeypatch):
    """The port reads observability.md alone, as JAX does."""
    monkeypatch.setattr(rules_catalog, "CATALOG_DOCS",
                        ("docs/observability.md",))


@pytest.fixture
def jax_call_graph(monkeypatch):
    """Switch the port's outside-receiver check off: JAX's call graph.
    Returns the function that switches it back on."""
    check = ProjectModel._outside_receiver
    monkeypatch.setattr(ProjectModel, "_outside_receiver",
                        lambda self, base, owner: False)
    return lambda: monkeypatch.setattr(ProjectModel, "_outside_receiver",
                                       check)


def _line_of(path, text):
    """1-based line of the one line of ``path`` that holds ``text``."""
    with open(os.path.join(REPO, path), encoding="utf-8") as fh:
        hits = [i for i, line in enumerate(fh, 1) if text in line]
    assert len(hits) == 1, (path, text, hits)
    return hits[0]


def _keys(findings, rename=None):
    out = set()
    for f in findings:
        if f.rule not in NEUTRAL:
            continue
        path = f.path
        if rename is not None:
            path = path.replace(*rename)
        out.add((f.rule, path, f.line, f.col))
    return out


def test_rule_sets_agree(jax_zoolint):
    _, jax_rules, _ = jax_zoolint
    from analytics_zoo_tpu_torch.analysis import all_rules
    assert set(all_rules()) == set(jax_rules())
    assert NEUTRAL < set(all_rules()) and len(NEUTRAL) == 15


def test_seeded_fixture_parity(tmp_path, jax_zoolint, one_catalog):
    jax_analyze, _, _ = jax_zoolint
    (tmp_path / ".git").mkdir()
    (tmp_path / "docs").mkdir()
    shutil.copy(os.path.join(REPO, "docs", "observability.md"),
                tmp_path / "docs" / "observability.md")
    tree = tmp_path / "tests" / "fixtures" / "zoolint"
    shutil.copytree(os.path.join(REPO, "tests", "fixtures", "zoolint"),
                    tree, ignore=shutil.ignore_patterns("__pycache__"))
    mine = _keys(analyze_paths([str(tree)], root=str(tmp_path)))
    theirs = _keys(jax_analyze([str(tree)], root=str(tmp_path)))
    assert mine == theirs
    # every neutral family but the package-wide catalog row fires here
    assert {k[0] for k in mine} == NEUTRAL - {"metric-undeclared"}


def test_fleet_fixture_parity(tmp_path, jax_zoolint, one_catalog):
    jax_analyze, _, _ = jax_zoolint
    src = os.path.join(REPO, "tests", "fixtures", "zoolint_fleet")
    theirs_root, mine_root = tmp_path / "jax", tmp_path / "port"
    shutil.copytree(src, theirs_root)
    shutil.copytree(os.path.join(src, "docs"), mine_root / "docs")
    shutil.copytree(os.path.join(src, "analytics_zoo_tpu"),
                    mine_root / "analytics_zoo_tpu_torch")
    theirs = _keys(jax_analyze([str(theirs_root / "analytics_zoo_tpu")],
                               root=str(theirs_root)))
    mine = _keys(analyze_paths([str(mine_root / "analytics_zoo_tpu_torch")],
                               root=str(mine_root)),
                 rename=("analytics_zoo_tpu_torch/", "analytics_zoo_tpu/"))
    assert mine == theirs
    assert {k[0] for k in mine} == {"metric-undeclared"}


def test_port_tree_parity(monkeypatch, jax_zoolint, one_catalog,
                          jax_call_graph):
    """Over the port, JAX's analyser with its package witness pointed at
    the port's __init__.py (so its catalog rows are checked) reports the
    same neutral findings as the port's own on JAX's call graph; on the
    port's, the finding of a false edge goes: the broker's ``stream``
    (reached from automl's ``torch.cuda.stream``). The shard pool's wait
    under ``InferenceModel._lock``, a second such finding before C34's
    repair, no longer shows on either graph: ``InferenceModel._counted``
    wraps outside the lock, so the lock reaches nothing through
    ``instrument_jit``. ``blocking-under-lock`` reads PyTorch's device
    waits in the port's analyser alone (C34), and the port's tree holds
    none under a contended lock, so the sets stay equal."""
    jax_analyze, _, jax_catalog = jax_zoolint
    monkeypatch.setattr(
        jax_catalog, "_scan_covers_package",
        lambda pctx: any(c.path == rules_catalog.PACKAGE_WITNESS
                         for c in pctx.files))
    pkg = os.path.join(REPO, "analytics_zoo_tpu_torch")
    mine = _keys(analyze_paths([pkg], root=REPO, jobs=4))
    theirs = _keys(jax_analyze([pkg], root=REPO, jobs=4))
    assert mine == theirs
    jax_call_graph()
    refined = _keys(analyze_paths([pkg], root=REPO, jobs=4))
    broker = "analytics_zoo_tpu_torch/serving/broker.py"
    assert theirs - refined == {
        ("cross-thread-unlocked-state", broker,
         _line_of(broker, "return self.streams.setdefault("), 15),
    }
    assert refined < theirs
    # with observability.md alone, the port's three waived compile rows
    # and the port-only knob read as findings in both
    assert {(r, p) for r, p, _l, _c in mine
            if r in ("metric-undeclared", "envvar-undocumented")} == {
        ("metric-undeclared", "docs/observability.md"),
        ("envvar-undocumented",
         "analytics_zoo_tpu_torch/serving/config.py"),
    }


def test_jax_package_parity(monkeypatch, jax_zoolint, one_catalog,
                            jax_call_graph):
    """Equal on JAX's call graph; on the port's, JAX's baselined shard
    pool wait (the twin of the port's) is the one finding that goes, and
    JAX's one other ``blocking-under-lock`` finding
    (``inference/quantize.py:65``) stays. The port's rule also reads
    PyTorch's device waits (C34), but none in JAX's tree: the
    argument-less ``.item()`` / ``.tolist()`` it reads only in a module
    that imports torch, and Friesian's table calls numpy's and pandas'
    under ``InferenceModel._lock`` through the graph's false edges."""
    jax_analyze, _, _ = jax_zoolint
    monkeypatch.setattr(rules_catalog, "PACKAGE_WITNESS",
                        "analytics_zoo_tpu/__init__.py")
    pkg = os.path.join(REPO, "analytics_zoo_tpu")
    mine = _keys(analyze_paths([pkg], root=REPO, jobs=4))
    theirs = _keys(jax_analyze([pkg], root=REPO, jobs=4))
    assert mine == theirs
    jax_call_graph()
    refined = _keys(analyze_paths([pkg], root=REPO, jobs=4))
    assert theirs - refined == {
        ("blocking-under-lock", "analytics_zoo_tpu/data/shard.py", 160,
         22)}
    assert refined < theirs
    assert ("blocking-under-lock", "analytics_zoo_tpu/inference/quantize.py",
            65, 15) in refined


def test_ownership_report_over_the_jax_package(tmp_path, monkeypatch,
                                               capsys, jax_call_graph):
    """On JAX's call graph, JAX's docs/concurrency.md but for the note
    naming the tool."""
    monkeypatch.chdir(REPO)
    out = tmp_path / "concurrency.md"
    assert cli.main(["analytics_zoo_tpu", "--ownership-report",
                     str(out)]) == 0
    capsys.readouterr()
    mine = out.read_text().splitlines()
    theirs = open(os.path.join(REPO, "docs", "concurrency.md"),
                  encoding="utf-8").read().splitlines()
    assert len(mine) == len(theirs)
    differ = [(a, b) for a, b in zip(mine, theirs) if a != b]
    assert len(differ) == 1, differ[:3]
    a, b = differ[0]
    assert a.startswith("<!-- Generated by `python -m "
                        "analytics_zoo_tpu_torch.analysis ")
    assert b.startswith("<!-- Generated by `python -m "
                        "analytics_zoo_tpu.analysis ")
    with open(os.path.join(REPO, "docs", "concurrency.json")) as fh:
        assert (tmp_path / "concurrency.json").read_text() == fh.read()


# ------------------------------------------- the CLI's github and migrate

@pytest.fixture
def jax_cli():
    from analytics_zoo_tpu.analysis import cli as jax_cli_mod
    from analytics_zoo_tpu.analysis import report as jax_report
    return jax_cli_mod, jax_report


def _two_finding_tree(root):
    """An anchored checkout with two wallclock findings (a neutral rule,
    the same finding in both analysers), one of them repeated so the
    fingerprints' occurrence index is exercised."""
    (root / ".git").mkdir(parents=True)
    mod = root / "serving" / "mod.py"
    mod.parent.mkdir()
    mod.write_text("import time\n\n\ndef stamp():\n"
                   "    return time.time()\n\n\ndef again():\n"
                   "    return time.time()\n\n\ndef msg():\n"
                   "    return max(time.time(),  # 100% wall\n"
                   "               0)\n")
    return mod


def _run(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


@pytest.mark.parametrize("case", ["findings", "clean", "stale"])
def test_cli_github_format_matches_jax(tmp_path, capsys, jax_cli, case):
    """``--format github``: the port's lines are JAX's, byte for byte, on
    the same tree: one ``::error`` a finding (messages escaped), a
    ``::warning`` a stale baseline entry, ``::notice`` when clean."""
    jax_cli_mod, _ = jax_cli
    mod = _two_finding_tree(tmp_path)
    argv = ["--format", "github"]
    if case == "clean":
        mod.write_text("import time\n\n\ndef stamp():\n"
                       "    return time.perf_counter()\n")
        argv += ["--no-baseline"]
    elif case == "stale":
        bl = tmp_path / "baseline.json"
        assert cli.main(["--write-baseline", "--baseline", str(bl),
                         str(mod)]) == 0
        mod.write_text("import time\n\n\ndef stamp():\n"
                       "    return time.time()\n")
        argv += ["--baseline", str(bl)]
    else:
        argv += ["--no-baseline"]
    capsys.readouterr()
    mine = _run(cli.main, argv + [str(mod)], capsys)
    theirs = _run(jax_cli_mod.main, argv + [str(mod)], capsys)
    assert mine == theirs
    lines = mine[1].splitlines()
    if case == "findings":
        assert mine[0] == 1
        assert [ln.split("::")[1].split(",")[0] for ln in lines] == [
            "error file=serving/mod.py"] * 3
    elif case == "clean":
        assert mine[0] == 0 and lines == ["::notice title=zoolint::clean"]
    else:
        assert mine[0] == 0
        assert sum(ln.startswith("::warning") for ln in lines) == 2


def test_github_report_matches_jax_on_the_fixture(jax_cli):
    """The reporter on the seeded fixture's findings (every family) and
    two stale entries, one message with the grammar's reserved
    characters: JAX's text, one ``::error`` line a finding."""
    _, jax_report = jax_cli
    from analytics_zoo_tpu_torch.analysis import report
    from analytics_zoo_tpu_torch.analysis.core import Finding
    findings = analyze_paths(
        [os.path.join(REPO, "tests", "fixtures", "zoolint_torch")],
        root=REPO)
    findings.append(Finding("wallclock-hotpath", "serving/x.py", 3, 4,
                            "50% of\r\nthe time"))
    stale = [{"fingerprint": "0123456789abcdef", "rule": "lock-order",
              "path": "a.py"}, {"fingerprint": "fedcba9876543210",
                                "rule": "thread-leak", "path": "b.py"}]
    mine = report.github_report(findings, stale)
    assert mine == jax_report.github_report(findings, stale)
    lines = mine.splitlines()
    assert sum(ln.startswith("::error ") for ln in lines) == len(findings)
    assert "50%25 of%0D%0Athe time" in lines[len(findings) - 1]


def _v1_baseline(path, findings, root, extra=()):
    """A version-1 baseline written by hand: each fingerprint the sha256
    of rule, path, the raw stripped line and an occurrence index."""
    import hashlib
    import json
    counts, entries = {}, []
    for f in sorted(findings, key=lambda f: (f.path, f.line, f.col,
                                             f.rule)):
        with open(os.path.join(root, f.path), encoding="utf-8") as fh:
            text = fh.read().splitlines()[f.line - 1].strip()
        base = f"{f.rule}\x00{f.path}\x00{text}"
        n = counts.get(base, 0)
        counts[base] = n + 1
        fp = hashlib.sha256(f"{base}\x00{n}".encode()).hexdigest()[:16]
        entries.append({"fingerprint": fp, "rule": f.rule, "path": f.path,
                        "line": f.line, "message": f.message,
                        "justification": f"kept on purpose, line {f.line}"})
    entries.extend(extra)
    path.write_text(json.dumps({"version": 1, "entries": entries}))


def test_cli_migrate_baseline_matches_jax(tmp_path, capsys, jax_cli):
    """``--migrate-baseline`` on a version-1 baseline written by the
    test: the port's output and rewritten file are JAX's (the surviving
    justifications kept, the stale entry dropped and named); a second
    run says the file is already version 2; a scan that meets a
    version-1 file exits 2 naming the flag, as JAX's does."""
    import json
    jax_cli_mod, _ = jax_cli
    stale = {"fingerprint": "00000000deadbeef", "rule": "wallclock-hotpath",
             "path": "serving/gone.py", "line": 3, "message": "m",
             "justification": "a file since deleted"}
    runs = {}
    for who, main in (("port", cli.main), ("jax", jax_cli_mod.main)):
        root = tmp_path / who
        mod = _two_finding_tree(root)
        findings = analyze_paths([str(mod)], root=str(root))
        assert len(findings) == 3
        bl = root / "baseline.json"
        _v1_baseline(bl, findings, str(root), extra=[stale])
        scan = _run(main, ["--baseline", str(bl), str(mod)], capsys)
        first = _run(main, ["--migrate-baseline", "--baseline", str(bl),
                            str(mod)], capsys)
        data = json.loads(bl.read_text())
        second = _run(main, ["--migrate-baseline", "--baseline", str(bl),
                             str(mod)], capsys)
        after = _run(main, ["--baseline", str(bl), str(mod)], capsys)
        runs[who] = (scan, first, data, second, after, str(root))
    port, jax = runs["port"], runs["jax"]
    # the scan of a version-1 file: exit 2, the message naming the flag
    # and each package's module
    assert port[0][0] == jax[0][0] == 2
    assert port[0][2].replace(port[5], "<root>").replace(
        "analytics_zoo_tpu_torch.analysis", "analytics_zoo_tpu.analysis") \
        == jax[0][2].replace(jax[5], "<root>")
    assert "--migrate-baseline" in port[0][2]
    for a, b in ((port[1], jax[1]), (port[3], jax[3])):
        assert a[0] == b[0] == 0
        assert a[1].replace(port[5], "<root>") == \
            b[1].replace(jax[5], "<root>")
    assert "baseline migrated" in port[1][1] and "(3 entries)" in port[1][1]
    assert "dropped stale entry 00000000deadbeef" in port[1][1]
    assert "already version 2" in port[3][1]
    assert port[2] == jax[2] and port[2]["version"] == 2
    assert [e["justification"] for e in port[2]["entries"]] == [
        "kept on purpose, line 5", "kept on purpose, line 9",
        "kept on purpose, line 13"]
    assert port[4][0] == jax[4][0] == 0
    assert "zoolint: clean" in port[4][1]
