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
    port's, two findings of false edges go: the broker's ``stream``
    (reached from automl's ``torch.cuda.stream``) and the shard pool's
    wait under ``InferenceModel._lock``."""
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
    shard = "analytics_zoo_tpu_torch/data/shard.py"
    assert theirs - refined == {
        ("cross-thread-unlocked-state", broker,
         _line_of(broker, "return self.streams.setdefault("), 15),
        ("blocking-under-lock", shard,
         _line_of(shard, "yield fut.result()"), 22),
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
    pool wait (the twin of the port's) is the one finding that goes."""
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
