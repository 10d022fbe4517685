"""The port's zoolint (``analytics_zoo_tpu_torch.analysis``): golden
per-rule fixtures in PyTorch's idioms, suppression and baseline round
trips, JSON schema stability, the CLI's exit codes, and the self-scan
invariant (the port's tree is clean modulo
dev/zoolint-torch-baseline.json, and every baseline entry carries a
written reason)."""

import json
import os
import textwrap

import pytest

from analytics_zoo_tpu_torch.analysis import (
    all_rules, analyze_paths, analyze_source, catalog_drift,
)
from analytics_zoo_tpu_torch.analysis import baseline as baseline_lib
from analytics_zoo_tpu_torch.analysis import report

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "analytics_zoo_tpu_torch")
FIXTURE = os.path.join(REPO, "tests", "fixtures", "zoolint_torch")

ALL_RULES = {
    "wallclock-hotpath", "hotpath-host-sync",
    "jit-in-loop", "jit-call-inline", "jit-static-unhashable",
    "jit-compile-in-serve-loop",
    "engine-unlocked-write", "lock-order",
    "cross-thread-unlocked-state", "lock-order-inversion",
    "blocking-under-lock", "thread-leak",
    "metric-undocumented", "metric-undeclared", "envvar-undocumented",
    "rowwise-map-in-data-plane",
    "record-ack-leak", "lock-release-path", "span-pairing",
    "tainted-host-sync", "shape-dependent-branch-in-jit",
    "kv-page-leak",
}


def _scan(source, relpath="serving/mod.py"):
    return analyze_source(textwrap.dedent(source), relpath)


def _rules_of(findings):
    return sorted({f.rule for f in findings})


@pytest.fixture(scope="module")
def port_findings():
    """Raw findings (suppressions applied, no baseline) over the port."""
    return analyze_paths([PKG], root=REPO, jobs=4)


# ------------------------------------------------------------ rule catalog

def test_rule_registry_complete():
    """All 22 of JAX's rule ids, so a suppression or a baseline entry
    means the same in both packages."""
    rules = all_rules()
    assert set(rules) == ALL_RULES
    for rid, rule in rules.items():
        assert rule.id == rid
        assert rule.scope in ("file", "project")
        assert rule.description


def test_analyser_imports_no_torch_and_nothing_outside_itself():
    """An ast tool: no module of the analyser imports torch, and no
    module of the port outside analysis/ imports it."""
    import ast
    bad = []
    for dirpath, _dirs, files in os.walk(PKG):
        for name in files:
            if not name.endswith(".py"):
                continue
            path = os.path.join(dirpath, name)
            rel = os.path.relpath(path, PKG).replace(os.sep, "/")
            inside = rel.startswith("analysis/")
            tree = ast.parse(open(path, encoding="utf-8").read())
            for node in ast.walk(tree):
                mods = []
                if isinstance(node, ast.Import):
                    mods = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.module:
                    mods = [node.module]
                for m in mods:
                    if inside and m.split(".")[0] == "torch":
                        bad.append((rel, m))
                    if not inside and m.startswith(
                            "analytics_zoo_tpu_torch.analysis"):
                        bad.append((rel, m))
    assert bad == []


def test_cli_loads_no_jax():
    """The tool stands alone: its CLI runs in a process where importing
    JAX or the JAX package would fail. (The port's package loads torch
    on import; the analyser's own modules import none, as the test above
    holds.)"""
    import subprocess
    import sys
    code = ("import sys\n"
            "for m in ('jax', 'flax', 'analytics_zoo_tpu'):\n"
            "    sys.modules[m] = None\n"
            "from analytics_zoo_tpu_torch.analysis import cli\n"
            "sys.exit(cli.main(['--list-rules']))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert len(out.stdout.splitlines()) == len(ALL_RULES)


# --------------------------------------------------------------- wallclock

def test_wallclock_flagged_in_hot_path():
    src = """
    import time
    def stamp():
        return time.time()
    """
    (f,) = _scan(src, "analytics_zoo_tpu_torch/serving/mod.py")
    assert f.rule == "wallclock-hotpath"
    assert f.line == 4


def test_wallclock_alias_and_datetime_resolved():
    src = """
    import time as clock
    import datetime
    def stamp():
        return clock.time(), datetime.datetime.now()
    """
    fs = _scan(src, "learn/mod.py")
    assert [f.rule for f in fs] == ["wallclock-hotpath"] * 2


def test_wallclock_ignored_outside_hot_path():
    src = """
    import time
    def stamp():
        return time.time()
    """
    assert _scan(src, "analytics_zoo_tpu_torch/zouwu/mod.py") == []
    ok = """
    import time
    def span():
        return time.perf_counter() - time.monotonic()
    """
    assert _scan(ok, "serving/mod.py") == []


# ----------------------------------------------------------- hotpath sync

_SYNCS = [
    ("out += float(b.loss)", "float(<non-literal>)"),
    ("out += int(b.count)", "int(<non-literal>)"),
    ("out += bool(b.done)", "bool(<non-literal>)"),
    ("out += b.loss.item()", ".item()"),
    ("rows = b.ids.tolist()", ".tolist()"),
    ("rows = b.logits.cpu()", ".cpu()"),
    ("rows = b.logits.detach().numpy()", ".numpy()"),
    ('rows = b.logits.to("cpu")', '.to("cpu")'),
    ("rows = b.logits.to(device='cpu')", '.to("cpu")'),
    ('rows = b.logits.to(torch.device("cpu"))', '.to("cpu")'),
    ("torch.cuda.synchronize()", "torch.cuda.synchronize()"),
    ("torch.cuda.synchronize(0)", "torch.cuda.synchronize()"),
    ("b.done_event.synchronize()", ".synchronize()"),
    ("rows = np.asarray(b)", "numpy.asarray()"),
    ("rows = np.array(b)", "numpy.array()"),
    ("rows = telemetry.traced_device_get(b)",
     "analytics_zoo_tpu_torch.common.telemetry.traced_device_get()"),
]


@pytest.mark.parametrize("stmt,label", _SYNCS,
                         ids=[s for s, _ in _SYNCS])
def test_host_sync_in_dispatch_loop(stmt, label):
    """Each PyTorch sync the lexical rule matches, one per case."""
    src = f"""
    import numpy as np
    import torch
    from analytics_zoo_tpu_torch.common import telemetry
    def dispatch(batches):
        out = 0.0
        for b in batches:
            {stmt}
        return out
    """
    fs = _scan(src)
    assert [f.rule for f in fs] == ["hotpath-host-sync"], fs
    assert label in fs[0].message


def test_host_sync_on_device_moves_and_dtype_casts_not_flagged():
    src = """
    import torch
    def dispatch(batches, dev):
        for b in batches:
            x = b.to(dev)
            y = b.to(torch.float32)
            z = b.cuda()
            w = b.to("cuda", non_blocking=True)
        return x, y, z, w
    """
    assert _scan(src) == []


def test_host_sync_requires_hot_function_and_loop():
    src = """
    import torch
    def summarize(batches):
        for b in batches:
            torch.cuda.synchronize()
    """
    assert _scan(src) == []
    src = """
    import torch
    def drain(pending):
        torch.cuda.synchronize()
        return pending.cpu()
    """
    assert _scan(src) == []


def test_host_sync_sampling_guard_exempts():
    src = """
    def run_epoch(steps, profiler):
        for s in steps:
            if profiler.should_sample():
                s.done.synchronize()
    """
    assert _scan(src) == []


def test_host_sync_float_of_literal_ok():
    src = """
    def step_loop(xs):
        acc = 0.0
        for x in xs:
            acc += float("1.5") + int("2")
        return acc
    """
    assert _scan(src) == []


# ------------------------------------------------------------------- jit

@pytest.mark.parametrize("ctor", ["torch.compile", "torch.jit.script",
                                  "torch.jit.trace",
                                  "telemetry.instrument_jit"])
def test_jit_in_loop(ctor):
    src = f"""
    import torch
    from analytics_zoo_tpu_torch.common import telemetry
    def build(fns, xs):
        out = []
        for f in fns:
            out.append({ctor}(f))
        return out
    """
    (f,) = _scan(src, "mod.py")
    assert f.rule == "jit-in-loop"


def test_jit_in_comprehension_not_flagged():
    src = """
    import torch
    def build(fns):
        return [torch.compile(f) for f in fns]
    """
    assert _scan(src, "mod.py") == []


def test_jit_call_inline_and_from_import():
    src = """
    from torch import compile
    def apply(f, x):
        return compile(f)(x)
    """
    fs = _scan(src, "mod.py")
    assert "jit-call-inline" in _rules_of(fs)


def test_jit_static_unhashable_list_vs_tuple():
    src = """
    import torch
    bad = torch.compile(lambda a, b: a, static_argnums=[0])
    good = torch.compile(lambda a, b: a, static_argnums=(0,))
    named = torch.compile(lambda a, b: a, static_argnames=["b"])
    options = torch.compile(lambda a: a, options={"trace.enabled": False})
    """
    fs = _scan(src, "mod.py")
    assert [f.rule for f in fs] == ["jit-static-unhashable"] * 2
    assert [f.line for f in fs] == [3, 5]


def test_local_helper_named_compile_not_flagged():
    src = """
    def instrument_jit(f):
        return f
    def compile(f):
        return f
    def apply(f, x):
        return instrument_jit(f)(x), compile(f)(x)
    """
    assert _scan(src, "mod.py") == []


# -------------------------------------------------- compile-in-serve-loop

_BUILDS = [
    ("step = torch.compile(model)", "compiles a graph"),
    ("step = torch.jit.script(model)", "compiles a graph"),
    ('_build.load("flash_attention")', "builds a kernel library"),
    ("_build.build()", "builds a kernel library"),
    ("autotune.tune_attention(b, 128, 12, 64)", "autotune"),
    ("autotune.tune_pending()", "autotune"),
    ('autotune.get_tuner().tune_thunks("k", "key", {})', "autotune"),
    ("g = torch.cuda.make_graphed_callables(model, (b,))",
     "captures a CUDA graph"),
    ("graph.capture_begin()", "captures a CUDA graph"),
]


@pytest.mark.parametrize("stmt,what", _BUILDS, ids=[s for s, _ in _BUILDS])
def test_compile_in_serve_loop_flagged(stmt, what):
    src = f"""
    import torch
    from analytics_zoo_tpu_torch.ops import _build, autotune
    def serve_drain(model, rungs, graph):
        for b in rungs:
            {stmt}
    """
    fs = [f for f in _scan(src) if f.rule == "jit-compile-in-serve-loop"]
    assert len(fs) == 1, _scan(src)
    assert what in fs[0].message


def test_compile_in_serve_loop_graph_capture_context():
    src = """
    import torch
    def serve_drain(step, rungs, graph):
        outs = []
        for b in rungs:
            with torch.cuda.graph(graph):
                outs.append(step(b))
        return outs
    """
    assert _rules_of(_scan(src)) == ["jit-compile-in-serve-loop"]


def test_compile_in_serve_loop_baselines():
    # warm-named functions are the sanctioned build path; re.compile,
    # keras compile and str.lower() are not builds; non-hot packages
    # exempt
    src = """
    import re
    import torch
    def warm_serve_loop(model, rungs):
        return [torch.compile(model) for _ in rungs]
    def produce(rows, net):
        for r in rows:
            net.compile(r.opt, r.loss)
            if re.compile(r.pat):
                yield r.name.lower()
    """
    assert _scan(src) == []
    hot_elsewhere = """
    from analytics_zoo_tpu_torch.ops import _build
    def serve_drain(rungs):
        for b in rungs:
            _build.load("paged_attention")
    """
    assert _scan(hot_elsewhere, "analytics_zoo_tpu_torch/zouwu/mod.py") == []


def test_compile_outside_loop_not_flagged():
    # one build at function entry (a library's first call) is fine
    src = """
    from analytics_zoo_tpu_torch.ops import _build
    def predict(x):
        lib = _build.load("embedding_bag")
        return lib(x)
    """
    assert _scan(src) == []


# ----------------------------------------------------------- concurrency

def test_unlocked_write_across_thread_boundary():
    src = """
    import threading
    class Engine:
        def __init__(self):
            self._lock = threading.Lock()
            self.n = 0
        def start(self):
            threading.Thread(target=self._run).start()
        def _run(self):
            self.n += 1
        def read(self):
            self.n = 0
    """
    fs = _scan(src, "mod.py")
    assert [f.rule for f in fs] == ["engine-unlocked-write"] * 2


def test_locked_write_is_clean():
    src = """
    import threading
    class Engine:
        def __init__(self):
            self._lock = threading.Lock()
            self.n = 0
        def start(self):
            threading.Thread(target=self._run).start()
        def _run(self):
            with self._lock:
                self.n += 1
        def read(self):
            with self._lock:
                return self.n
    """
    assert _scan(src, "mod.py") == []


def test_thread_confined_attr_is_clean():
    src = """
    import threading
    class Engine:
        def __init__(self):
            self._streak = 0
        def start(self):
            threading.Thread(target=self._run).start()
        def _run(self):
            self._streak += 1
    """
    assert _scan(src, "mod.py") == []


def test_lock_order_inversion():
    src = """
    class M:
        def fwd(self):
            with self.a_lock:
                with self.b_lock:
                    pass
        def bwd(self):
            with self.b_lock:
                with self.a_lock:
                    pass
    """
    assert _rules_of(_scan(src, "mod.py")) == ["lock-order"]
    src_consistent = """
    class M:
        def fwd(self):
            with self.a_lock:
                with self.b_lock:
                    pass
        def also_fwd(self):
            with self.a_lock:
                with self.b_lock:
                    pass
    """
    assert _scan(src_consistent, "mod.py") == []


# --------------------------------------------------- rowwise in data plane

def test_rowwise_map_flagged_in_data_plane():
    src = """
    def pad(d, seq_len):
        d["h"] = d["h"].map(lambda h: list(h)[:seq_len])
        return d
    """
    (f,) = _scan(src, "analytics_zoo_tpu_torch/data/mod.py")
    assert f.rule == "rowwise-map-in-data-plane"
    assert f.line == 3
    (f,) = _scan(src, "analytics_zoo_tpu_torch/friesian/feature/mod.py")
    assert f.rule == "rowwise-map-in-data-plane"


def test_rowwise_nested_def_and_apply_axis1_flagged():
    src = """
    def xform(d):
        def pad_one(h):
            return list(h) + [0]
        d["h"] = d["h"].map(pad_one)
        d["t"] = d.apply(lambda r: sum(r.values), axis=1)
        d["u"] = d.apply(lambda r: sum(r.values), axis="columns")
        return d
    """
    fs = _scan(src, "analytics_zoo_tpu_torch/data/mod.py")
    assert [f.rule for f in fs] == ["rowwise-map-in-data-plane"] * 3


def test_rowwise_dict_param_and_axis0_not_flagged():
    src = """
    def xform(d, func, mapping):
        d["e"] = d["e"].map(mapping)
        d["f"] = d["f"].map({1: 2})
        d["g"] = d["g"].map(len)
        d["s"] = d.apply(sum)
        return d
    """
    assert _scan(src, "analytics_zoo_tpu_torch/data/mod.py") == []


def test_rowwise_silent_outside_data_plane_and_suppressed():
    src = """
    def pad(d, seq_len):
        d["h"] = d["h"].map(lambda h: list(h)[:seq_len])
        return d
    """
    assert _scan(src, "analytics_zoo_tpu_torch/zouwu/mod.py") == []
    assert _scan(src, "analytics_zoo_tpu_torch/serving/mod.py") == []
    sup = """
    def pad(d, seq_len):
        d["h"] = d["h"].map(  # zoolint: disable=rowwise-map-in-data-plane
            lambda h: list(h))
        return d
    """
    assert _scan(sup, "analytics_zoo_tpu_torch/data/mod.py") == []


# ---------------------------------------------------------- suppressions

def test_line_suppression_bare_and_named():
    src = """
    import time
    def stamp():
        a = time.time()  # zoolint: disable
        b = time.time()  # zoolint: disable=wallclock-hotpath
        c = time.time()  # zoolint: disable=jit-in-loop
        return a, b, c
    """
    fs = _scan(src)
    assert len(fs) == 1 and fs[0].line == 6


def test_file_suppression():
    src = """
    # zoolint: disable-file=wallclock-hotpath,hotpath-host-sync
    import time
    def dispatch(xs):
        for x in xs:
            x.cpu()
        return time.time()
    """
    assert _scan(src) == []


# -------------------------------------------------------------- baseline

def test_baseline_round_trip(tmp_path):
    mod = tmp_path / "serving" / "mod.py"
    mod.parent.mkdir()
    mod.write_text("import time\n\n\ndef stamp():\n"
                   "    return time.time()\n")
    findings = analyze_paths([str(mod)], root=str(tmp_path))
    assert _rules_of(findings) == ["wallclock-hotpath"]
    bl = tmp_path / "baseline.json"
    assert baseline_lib.save(str(bl), findings, str(tmp_path),
                             justifications=None) == 1
    entries = baseline_lib.load(str(bl))
    left, stale = baseline_lib.apply(findings, entries, str(tmp_path))
    assert left == [] and stale == []
    # fingerprints key on statement text, not line number
    mod.write_text("import time\n\n# a new comment\n\n\ndef stamp():\n"
                   "    return time.time()\n")
    findings2 = analyze_paths([str(mod)], root=str(tmp_path))
    left, stale = baseline_lib.apply(findings2, entries, str(tmp_path))
    assert left == [] and stale == []
    # editing the statement retires the entry and resurfaces the finding
    mod.write_text("import time\n\n\ndef stamp():\n"
                   "    return time.time() + 0\n")
    findings3 = analyze_paths([str(mod)], root=str(tmp_path))
    left, stale = baseline_lib.apply(findings3, entries, str(tmp_path))
    assert len(left) == 1 and len(stale) == 1


def test_baseline_preserves_justifications(tmp_path):
    mod = tmp_path / "common" / "mod.py"
    mod.parent.mkdir()
    mod.write_text("import time\nT = time.time()\n")
    findings = analyze_paths([str(mod)], root=str(tmp_path))
    bl = str(tmp_path / "baseline.json")
    baseline_lib.save(bl, findings, str(tmp_path))
    entries = baseline_lib.load(bl)
    fp = next(iter(entries))
    entries[fp]["justification"] = "module-load timestamp, not a loop"
    with open(bl, "w") as fh:
        json.dump({"version": baseline_lib.BASELINE_VERSION,
                   "entries": list(entries.values())}, fh)
    baseline_lib.save(bl, findings, str(tmp_path))
    assert baseline_lib.load(bl)[fp]["justification"] == \
        "module-load timestamp, not a loop"


@pytest.mark.parametrize("version", [1, 99])
def test_baseline_rejects_unknown_version(tmp_path, version):
    """Only version 2 loads. A version-1 (raw line) file is refused with
    JAX's pointer to ``--migrate-baseline``, which rewrites it
    (tests/test_torch_zoolint_parity.py); any other version is
    unsupported."""
    bl = tmp_path / "baseline.json"
    bl.write_text('{"version": %d, "entries": []}' % version)
    want = ("analytics_zoo_tpu_torch.analysis --migrate-baseline"
            if version == 1 else "unsupported version")
    with pytest.raises(ValueError, match=want):
        baseline_lib.load(str(bl))


def test_default_baseline_is_the_ports_own():
    assert baseline_lib.DEFAULT_BASELINE == os.path.join(
        "dev", "zoolint-torch-baseline.json")


# ---------------------------------------------------------- JSON schema

def test_json_report_schema(tmp_path):
    mod = tmp_path / "learn" / "mod.py"
    mod.parent.mkdir()
    mod.write_text("import time\nT = time.time()\n")
    findings = analyze_paths([str(mod)], root=str(tmp_path))
    obj = json.loads(report.json_report(
        findings, [{"fingerprint": "deadbeefdeadbeef"}], str(tmp_path)))
    assert obj["version"] == report.JSON_SCHEMA_VERSION == 1
    assert set(obj) == {"version", "findings", "stale_baseline", "summary"}
    (f,) = obj["findings"]
    assert set(f) == {"rule", "path", "line", "col", "message",
                      "fingerprint"}
    assert f["path"] == "learn/mod.py"
    assert obj["stale_baseline"] == ["deadbeefdeadbeef"]
    assert obj["summary"] == {"total": 1,
                              "by_rule": {"wallclock-hotpath": 1}}


# ----------------------------------------------------- tree + fixture scan

def test_port_tree_clean_modulo_baseline(port_findings):
    entries = baseline_lib.load(
        os.path.join(REPO, baseline_lib.DEFAULT_BASELINE))
    left, stale = baseline_lib.apply(port_findings, entries, REPO)
    assert left == [], "\n".join(f.format() for f in left)
    assert stale == [], stale


def test_no_baseline_lists_exactly_the_baseline(port_findings):
    """``--no-baseline`` reads exactly the baseline's entries, each with
    a written reason."""
    entries = baseline_lib.load(
        os.path.join(REPO, baseline_lib.DEFAULT_BASELINE))
    fps = [fp for _f, fp in baseline_lib.fingerprints(port_findings, REPO)]
    assert sorted(fps) == sorted(entries)
    for e in entries.values():
        j = e["justification"].strip()
        assert len(j) > 40 and not j.startswith("TODO"), e


def test_catalog_drift_is_clean():
    """The port registers every metric of the catalog but the three
    compile metrics observability_torch.md explains (C32, C33 repaired),
    and documents every knob it reads."""
    assert catalog_drift(REPO) == []


def test_seeded_fixture_trips_every_family():
    findings = analyze_paths([FIXTURE], root=REPO)
    got = set(_rules_of(findings))
    # metric-undeclared can't fire here by design: the fixture scan does
    # not cover analytics_zoo_tpu_torch/, so doc-side rows are not checked
    assert got == ALL_RULES - {"metric-undeclared"}
    sup = [f for f in findings
           if f.path.endswith("bad_hotpath.py") and f.line >= 29]
    assert sup == []


def test_metric_undeclared_requires_full_package_scan(tmp_path):
    pkg = tmp_path / "analytics_zoo_tpu_torch"
    pkg.mkdir()
    (pkg / "__init__.py").write_text("")
    (pkg / "serving").mkdir()
    (pkg / "serving" / "mod.py").write_text("X = 1\n")
    (tmp_path / "docs").mkdir()
    (tmp_path / "docs" / "observability.md").write_text(
        "| `zoo_ghost_total` | counter |\n")
    fs = analyze_paths([str(pkg)], root=str(tmp_path))
    assert [f.rule for f in fs] == ["metric-undeclared"]
    assert fs[0].path == "docs/observability.md"
    fs = analyze_paths([str(pkg / "serving")], root=str(tmp_path))
    assert fs == []


def test_metric_undeclared_reads_the_ports_catalog(tmp_path):
    """A row of observability.md the port waives in
    observability_torch.md, with its reason, is not a finding; a row of
    the port's own catalog that nothing registers is, at its line."""
    pkg = tmp_path / "analytics_zoo_tpu_torch"
    pkg.mkdir()
    (pkg / "__init__.py").write_text(
        "def reg(r):\n    r.counter('zoo_seen_total', 'h')\n"
        "    r.gauge('zoo_port_only', 'h')\n")
    docs = tmp_path / "docs"
    docs.mkdir()
    (docs / "observability.md").write_text(
        "| `zoo_seen_total` | counter |\n| `zoo_waived_total` | counter |\n")
    (docs / "observability_torch.md").write_text(
        "# Port\n\n| `zoo_port_only` | gauge |\n| `zoo_port_ghost` | g |\n\n"
        "## Rows the port does not register\n\n"
        "| `zoo_waived_total` | no such thing in PyTorch |\n")
    fs = analyze_paths([str(pkg)], root=str(tmp_path))
    assert [(f.rule, f.path, f.line) for f in fs] == [
        ("metric-undeclared", "docs/observability_torch.md", 4)]


def test_fleet_fixture_trips_metric_undeclared(tmp_path):
    """JAX's fleet fixture under the port's package name: a documented
    ``zoo_fleet_*`` metric no code registers reads ``metric-undeclared``
    on a full-package scan; its registered twin stays clean."""
    import shutil
    src = os.path.join(REPO, "tests", "fixtures", "zoolint_fleet")
    shutil.copytree(os.path.join(src, "docs"), tmp_path / "docs")
    shutil.copytree(os.path.join(src, "analytics_zoo_tpu"),
                    tmp_path / "analytics_zoo_tpu_torch")
    fs = analyze_paths([str(tmp_path / "analytics_zoo_tpu_torch")],
                       root=str(tmp_path))
    undeclared = [f for f in fs if f.rule == "metric-undeclared"]
    assert len(undeclared) == 1, [f.format() for f in fs]
    assert "zoo_fleet_ghost_total" in undeclared[0].message
    assert not any("zoo_fleet_present_total" in f.message for f in fs)


# -------------------------------------------------------------------- CLI

def test_cli_default_scan_exits_clean(monkeypatch, capsys):
    """``python -m analytics_zoo_tpu_torch.analysis`` from the repo root
    scans the port with its baseline and exits 0."""
    from analytics_zoo_tpu_torch.analysis import cli
    monkeypatch.chdir(REPO)
    rc = cli.main([])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "zoolint: clean" in out and "stale" not in out


def test_cli_partial_scan_keeps_baseline_quiet(monkeypatch, capsys):
    # gan.py's baselined findings are out of scope when scanning
    # serving/ only — neither surfaced nor reported stale
    from analytics_zoo_tpu_torch.analysis import cli
    monkeypatch.chdir(REPO)
    rc = cli.main(["analytics_zoo_tpu_torch/serving"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "stale" not in out


def _cli_tree(tmp_path):
    """A minimal anchored checkout with one wallclock finding."""
    (tmp_path / ".git").mkdir()
    mod = tmp_path / "serving" / "mod.py"
    mod.parent.mkdir()
    mod.write_text("import time\n\n\ndef stamp():\n"
                   "    return time.time()\n")
    return mod


def test_cli_exit_codes_distinguish_usage_and_crash(monkeypatch, capsys):
    from analytics_zoo_tpu_torch.analysis import cli
    assert cli.main(["/no/such/path.py"]) == 2
    assert cli.main(["--rules", "bogus-rule", "."]) == 2

    def boom(*a, **k):
        raise RuntimeError("linter bug")
    monkeypatch.setattr(cli, "analyze_paths", boom)
    assert cli.main(["--no-baseline", "."]) == 3
    err = capsys.readouterr().err
    assert "internal error" in err and "RuntimeError" in err


def test_cli_fixture_exits_one_and_jobs_parallel_matches_serial(capsys):
    from analytics_zoo_tpu_torch.analysis import cli
    args = ["--no-baseline", "--format=json", FIXTURE]
    rc1 = cli.main(["--jobs", "1"] + args)
    out1 = capsys.readouterr().out
    rc4 = cli.main(["--jobs", "4"] + args)
    out4 = capsys.readouterr().out
    assert rc1 == rc4 == 1
    assert json.loads(out1) == json.loads(out4)


def test_cli_list_rules(capsys):
    from analytics_zoo_tpu_torch.analysis import cli
    assert cli.main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    assert {line.split()[0] for line in out.splitlines()} == ALL_RULES


def test_cli_baseline_survives_rewrapping(tmp_path, capsys):
    """A written baseline silences its finding through the CLI, and the
    fingerprint survives re-wrapping the statement over other lines."""
    from analytics_zoo_tpu_torch.analysis import cli
    mod = _cli_tree(tmp_path)
    (tmp_path / "dev").mkdir()
    bl = tmp_path / "dev" / "zoolint-torch-baseline.json"
    assert cli.main([str(mod)]) == 1
    assert cli.main(["--write-baseline", str(mod)]) == 0
    assert "baseline written" in capsys.readouterr().out
    assert cli.main([str(mod)]) == 0
    capsys.readouterr()
    mod.write_text("import time\n\n\ndef stamp():\n"
                   "    return max(time.time(),\n               0 * 1)\n")
    findings = analyze_paths([str(mod)], root=str(tmp_path))
    bl.write_text(json.dumps({"version": 2, "entries": [
        {"fingerprint": fp, "rule": f.rule, "path": f.path,
         "line": f.line, "message": f.message,
         "justification": "known wallclock, kept on purpose"}
        for f, fp in baseline_lib.fingerprints(findings, str(tmp_path))]}))
    mod.write_text("import time\n\n\ndef stamp():\n"
                   "    return max(time.time(), 0 * 1)\n")
    findings2 = analyze_paths([str(mod)], root=str(tmp_path))
    left, stale = baseline_lib.apply(
        findings2, baseline_lib.load(str(bl)), str(tmp_path))
    assert left == [] and stale == []
    assert cli.main([str(mod)]) == 0
    assert "zoolint: clean" in capsys.readouterr().out


def test_cli_ownership_report(tmp_path, capsys):
    from analytics_zoo_tpu_torch.analysis import cli
    _cli_tree(tmp_path)
    out_md = tmp_path / "docs" / "concurrency_torch.md"
    rc = cli.main(["--ownership-report", str(out_md),
                   str(tmp_path / "serving")])
    assert rc == 0
    assert "ownership report written" in capsys.readouterr().out
    assert out_md.is_file()
    js = json.loads((tmp_path / "docs" / "concurrency_torch.json")
                    .read_text())
    assert [r["root"] for r in js["roots"]][0] == "main"


def test_syntax_error_is_a_finding(tmp_path):
    mod = tmp_path / "broken.py"
    mod.write_text("def broken(:\n")
    findings = analyze_paths([str(mod)], root=str(tmp_path))
    assert [f.rule for f in findings] == ["syntax-error"]
