"""The port's zoolint, path-sensitive half: CFG construction, the
worklist solver, the six path-sensitive rules (positive and negative per
rule, the taint sources and sinks in PyTorch's idioms), the CFG cache,
the CLI surface (--timing, --prune-baseline) and the acceptance demo — a
hand-introduced exception-edge ack drop in the port's serving/engine.py
that record-ack-leak must catch."""

import ast
import json
import os
import textwrap

import pytest

from analytics_zoo_tpu_torch.analysis import analyze_paths, analyze_source
from analytics_zoo_tpu_torch.analysis import cli
from analytics_zoo_tpu_torch.analysis.core import (
    CFG, CFG_STATS, dataflow, parse_file,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "analytics_zoo_tpu_torch")
FIXTURE = os.path.join(REPO, "tests", "fixtures", "zoolint_torch")
ENGINE = os.path.join(PKG, "serving", "engine.py")


def _cfg(src):
    tree = ast.parse(textwrap.dedent(src))
    fn = tree.body[0]
    return CFG(fn), fn


def _scan(src, relpath="serving/mod.py"):
    return analyze_source(textwrap.dedent(src), relpath)


def _rules_of(findings):
    return {f.rule for f in findings}


# ------------------------------------------------------------ golden CFGs

def test_cfg_loop_break_continue_edges():
    g, fn = _cfg("""
    def f(xs):
        t = 0
        for x in xs:
            if x < 0:
                continue
            if x > 9:
                break
            t = t + x
        return t
    """)
    assert {"true", "false", "back", "break", "continue",
            "return"} <= g.edge_kinds()
    head = g.blocks_of(fn.body[1])[0]
    back_srcs = [b.idx for b in g.blocks
                 for d, k in b.succs if d == head and k == "back"]
    cont_srcs = [b.idx for b in g.blocks
                 for d, k in b.succs if d == head and k == "continue"]
    assert back_srcs and cont_srcs
    brk = [d for b in g.blocks for d, k in b.succs if k == "break"]
    assert brk and head not in brk


def test_cfg_try_finally_duplicates_finally_body():
    g, fn = _cfg("""
    def f(x):
        try:
            return g(x)
        finally:
            done()
    """)
    copies = g.blocks_of(fn.body[0].finalbody[0])
    assert len(copies) == 3
    assert any((g.exit, "return") in g.block(b).succs for b in copies)
    assert any((g.raise_exit, "exc") in g.block(b).succs for b in copies)


def test_cfg_exception_edges_route_to_handler():
    g, fn = _cfg("""
    def f(x):
        try:
            y = decode(x)
        except ValueError:
            y = None
        return y
    """)
    rb = g.blocks_of(fn.body[0].body[0])[0]
    hb = g.blocks_of(fn.body[0].handlers[0].body[0])[0]
    reach, seen = [rb], set()
    while reach:
        cur = reach.pop()
        if cur in seen:
            continue
        seen.add(cur)
        reach.extend(d for d, _k in g.block(cur).succs)
    assert hb in seen
    # a non-catch-all handler still lets the exception escape
    assert g.raise_exit in seen


def test_cfg_with_desugaring():
    g, fn = _cfg("""
    def f(graph, step, x):
        with torch.cuda.graph(graph):
            y = step(x)
        return y
    """)
    w = fn.body[0]
    wb = g.blocks_of(w)
    assert len(wb) == 1 and g.block(wb[0]).label == "with"
    assert (g.raise_exit, "exc") in g.block(wb[0]).succs
    body = g.blocks_of(w.body[0])[0]
    assert [d for d, _k in g.block(body).succs
            if g.block(d).label == "with-exit"]


def test_dataflow_forward_join_over_branches_and_loops():
    g, fn = _cfg("""
    def f(a, xs):
        if a:
            x = 1
        else:
            x = 2
        n = 0
        for v in xs:
            n = n + 1
        return x + n
    """)

    def transfer(block, fact):
        s = block.stmt
        if isinstance(s, ast.Assign):
            return fact | {t.id for t in s.targets
                           if isinstance(t, ast.Name)}
        if block.label == "loop-head" and isinstance(s, ast.For):
            return fact | {s.target.id}
        return fact

    facts = dataflow(g, transfer, init=frozenset(), bottom=frozenset(),
                     join=lambda a, b: a | b)
    assert {"x", "n", "v"} <= facts[g.exit]


def test_dataflow_backward_reach_avoid():
    g, fn = _cfg("""
    def f(a):
        if a:
            return 1
        return 2
    """)
    ret1 = g.blocks_of(fn.body[0].body[0])[0]

    def transfer(block, fact):
        return False if block.idx == ret1 else fact

    facts = dataflow(g, transfer, init=True, bottom=False,
                     join=lambda a, b: a or b, backward=True)
    assert facts[g.entry] is True


# ------------------------------------------------------- record-ack-leak

_LEAK = """
def drain(client, stream, group):
    entries = client.xreadgroup(group, "w", {stream: ">"})
    acks = []
    for eid, payload in entries:
        if payload is None:
            continue
        acks.append(("XACK", stream, group, eid))
    client.pipeline(acks)
"""

_CLEAN = """
def drain(client, stream, group):
    entries = client.xreadgroup(group, "w", {stream: ">"})
    acks = []
    buckets = []
    for eid, payload in entries:
        if payload is None:
            acks.append(("XACK", stream, group, eid))
            continue
        buckets.append((eid, payload))
    if acks:
        client.pipeline(acks)
    return buckets
"""


def test_ack_leak_positive_and_negative():
    assert "record-ack-leak" in _rules_of(_scan(_LEAK))
    assert "record-ack-leak" not in _rules_of(_scan(_CLEAN))
    assert "record-ack-leak" not in _rules_of(_scan(_LEAK, "data/mod.py"))


def test_ack_leak_escaping_exception_is_not_a_leak():
    src = """
    def drain(client, stream, group):
        entries = client.xreadgroup(group, "w", {stream: ">"})
        acks = []
        for eid, payload in entries:
            decode(payload)
            acks.append(("XACK", stream, group, eid))
        client.pipeline(acks)
    """
    assert "record-ack-leak" not in _rules_of(_scan(src))


def test_ack_leak_double_settlement_and_unflushed():
    src = """
    def drain(client, stream, group):
        entries = client.xreadgroup(group, "w", {stream: ">"})
        acks = []
        buckets = []
        for eid, payload in entries:
            buckets.append((eid, payload))
            acks.append(("XACK", stream, group, eid))
        client.pipeline(acks)
    """
    f = [x for x in _scan(src) if x.rule == "record-ack-leak"]
    assert f and "more than once" in f[0].message
    unflushed = """
    def drain(client, stream, group):
        entries = client.xreadgroup(group, "w", {stream: ">"})
        acks = []
        for eid, p in entries:
            acks.append(("XACK", stream, group, eid))
    """
    f = [x for x in _scan(unflushed) if x.rule == "record-ack-leak"]
    assert f and "without being flushed" in f[0].message


def test_ack_flush_in_finally_counts_on_every_path():
    src = """
    def drain(client, stream, group):
        entries = client.xreadgroup(group, "w", {stream: ">"})
        acks = []
        try:
            for eid, p in entries:
                acks.append(("XACK", stream, group, eid))
        finally:
            client.pipeline(acks)
    """
    assert "record-ack-leak" not in _rules_of(_scan(src))


# ----------------------------------------------------- lock-release-path

def test_lock_release_positive_negative_and_tested_acquire():
    bad = """
    def submit(lock, jobs):
        lock.acquire()
        if not jobs:
            return 0
        n = len(jobs)
        lock.release()
        return n
    """
    good = """
    def submit(lock, jobs):
        lock.acquire()
        try:
            return len(jobs)
        finally:
            lock.release()
    """
    tested = """
    def submit(lock, jobs):
        got = lock.acquire(timeout=1.0)
        if not got:
            return 0
        return len(jobs)
    """
    raising = """
    def submit(lock, jobs):
        lock.acquire()
        payload = jobs.encode()
        lock.release()
        return payload
    """
    assert "lock-release-path" in _rules_of(_scan(bad))
    assert "lock-release-path" not in _rules_of(_scan(good))
    assert "lock-release-path" not in _rules_of(_scan(tested))
    assert "lock-release-path" in _rules_of(_scan(raising))


# --------------------------------------------------------- span-pairing

def test_span_pairing_positive_negative_and_carveout():
    bad = """
    def traced(tracer, batch):
        tracer.attach("s")
        if batch is None:
            return None
        out = list(batch)
        tracer.detach("s")
        return out
    """
    good = """
    def traced(tracer, batch):
        tracer.attach("s")
        try:
            return list(batch)
        finally:
            tracer.detach("s")
    """
    forever = """
    def install(tracer):
        tracer.attach("process-lifetime")
        return tracer
    """
    assert "span-pairing" in _rules_of(_scan(bad))
    assert "span-pairing" not in _rules_of(_scan(good))
    assert "span-pairing" not in _rules_of(_scan(forever))


# ----------------------------------------------------- tainted-host-sync

def test_taint_sync_positive_branch_and_negative():
    bad = """
    import numpy as np
    import torch

    def autoregress(params, seq, steps):
        step = torch.compile(seq)
        out = seq
        for _t in range(steps):
            out = step(params, out)
            host = np.asarray(out)
            if out:
                break
        return host
    """
    findings = [f for f in _scan(bad) if f.rule == "tainted-host-sync"]
    assert len(findings) == 2            # the asarray and the branch
    clean = """
    import numpy as np
    import torch

    def fenced(params, seq, steps):
        step = torch.compile(seq)
        out = seq
        for _t in range(steps):
            out = step(params, out)
        return np.asarray(out)
    """
    assert "tainted-host-sync" not in _rules_of(_scan(clean))


_SOURCES = [
    ("y = model(b)", "y.item()"),
    ("y = self.net(b)", "y.tolist()"),
    ("y = encoder_module(b)", "float(y)"),
    ("y = m.forward(b)", "y.cpu()"),
    ("y = layer(b)", "y.numpy()"),
    ("y = step(b)", 'y.to("cpu")'),
    ("y = b.to(dev)", "int(y)"),
    ("y = b.cuda()", "bool(y)"),
    ("y = torch.zeros(4, device=dev)", "np.asarray(y)"),
    ("y = fa.flash_attention(b, b, b)", "np.array(y)"),
    ("y = predict_fn(b)", "telemetry.traced_device_get(y)"),
]


@pytest.mark.parametrize("source,sink", _SOURCES,
                         ids=[f"{s} -> {k}" for s, k in _SOURCES])
def test_taint_sources_and_sinks(source, sink):
    """Each taint source of the port reaches each host conversion."""
    src = f"""
    import numpy as np
    import torch
    from torch import nn
    from analytics_zoo_tpu_torch.common import telemetry
    from analytics_zoo_tpu_torch.common.telemetry import instrument_jit
    from analytics_zoo_tpu_torch.ops import flash_attention as fa

    class Gen:
        def go(self, batches, dev):
            layer = nn.Linear(4, 4)
            step = instrument_jit(layer)
            out = []
            for b in batches:
                {source}
                out.append({sink})
            return out
    """
    fs = [f for f in _scan(src, "inference/mod.py")
          if f.rule == "tainted-host-sync"]
    assert len(fs) == 1, _scan(src, "inference/mod.py")


def test_taint_host_values_are_not_sources():
    src = """
    import numpy as np
    import torch

    def gen(batches):
        out = []
        for b in batches:
            y = b.to(torch.float32)
            z = torch.zeros(4, device="cpu")
            w = b.to("cpu")
            out.append(float(y) + float(z) + float(w))
        return out
    """
    assert "tainted-host-sync" not in _rules_of(_scan(src))


def test_taint_killed_by_reassignment():
    src = """
    def gen(model, xs):
        y = model(xs)
        y = 0
        total = 0
        for x in xs:
            total = total + float(y)
        return total
    """
    assert "tainted-host-sync" not in _rules_of(_scan(src))


def test_taint_fn_parameter_convention_and_scope():
    src = """
    def accumulate(predict_fn, batches):
        total = 0.0
        for b in batches:
            y = predict_fn(b)
            total = total + float(y)
        return total
    """
    assert "tainted-host-sync" in _rules_of(_scan(src))
    assert "tainted-host-sync" in _rules_of(_scan(src, "inference/gen.py"))
    assert "tainted-host-sync" not in _rules_of(_scan(src, "automl/gen.py"))


def test_taint_defers_to_the_lexical_rule():
    """In a hot-named function of a hot package the lexical rule owns
    the sync: one defect, one report."""
    src = """
    def dispatch(model, batches):
        for b in batches:
            y = model(b)
            y.item()
    """
    assert _rules_of(_scan(src)) == {"hotpath-host-sync"}


# ------------------------------------- shape-dependent-branch-in-jit

def test_jit_branch_fixture_lines():
    path = os.path.join(FIXTURE, "bad_jit_branch.py")
    findings = [f for f in analyze_paths([path], root=REPO)
                if f.rule == "shape-dependent-branch-in-jit"]
    by_kind = {(f.line, "shape" in f.message) for f in findings}
    src = open(path).read().splitlines()

    def line_of(text):
        return next(i for i, ln in enumerate(src, 1) if text in ln)
    assert (line_of("x.shape[0] > 8"), True) in by_kind
    assert (line_of("limit > 0"), False) in by_kind
    assert (line_of("eps > 0"), False) in by_kind   # via the call graph
    assert (line_of("len(x) > 4"), True) in by_kind  # under a capture
    # the eager caller and the `is None` controls stay quiet
    assert len(findings) == 4


@pytest.mark.parametrize("entry", [
    "@torch.compile\ndef f(x):",
    "@torch.compile(fullgraph=True)\ndef f(x):",
    "@torch.jit.script\ndef f(x):",
    "@functools.partial(torch.compile, dynamic=False)\ndef f(x):",
    "def f(x):",
])
def test_jit_branch_entries(tmp_path, entry):
    body = textwrap.indent("if x.shape[0] > 2:\n    return x\nreturn x\n",
                           "    ")
    tail = "" if entry.startswith("@") else \
        "\n\ng = torch.compile(f)\nh = torch.jit.trace(f, (1,))\n"
    (tmp_path / "mod.py").write_text(
        "import functools\nimport torch\n\n\n" + entry + "\n" + body + tail)
    fs = [f for f in analyze_paths([str(tmp_path)], root=str(tmp_path))
          if f.rule == "shape-dependent-branch-in-jit"]
    assert len(fs) == 1 and "shape" in fs[0].message


def test_jit_branch_eager_wrappers_not_entries(tmp_path):
    """instrument_jit wraps an eager callable: a branch there is fine."""
    (tmp_path / "mod.py").write_text(textwrap.dedent("""
        from analytics_zoo_tpu_torch.common import telemetry

        @telemetry.instrument_jit
        def f(x):
            if x.shape[0] > 2:
                return x
            return x
    """))
    fs = analyze_paths([str(tmp_path)], root=str(tmp_path))
    assert "shape-dependent-branch-in-jit" not in _rules_of(fs)


# ---------------------------------------------------------- kv-page-leak

def test_kv_page_leak_early_return_and_guarded_handoff():
    leak = """
    def admit(pool, cache_cls, enc, need, budget):
        pages = pool.alloc_pages(need)
        if need > budget:
            return None
        return cache_cls(pool, pages)
    """
    clean = """
    def admit(pool, cache_cls, validate, enc, need):
        pages = pool.alloc_pages(need)
        try:
            validate(enc)
            cache = cache_cls(pool, pages)
        except Exception:
            pool.free_pages(pages)
            raise
        return cache
    """
    assert "kv-page-leak" in _rules_of(_scan(leak))
    assert "kv-page-leak" not in _rules_of(_scan(clean))


def test_kv_page_leak_counts_the_raise_exit():
    src = """
    def admit(pool, cache_cls, validate, enc, need):
        pages = pool.alloc_pages(need)
        validate(enc)
        return cache_cls(pool, pages)
    """
    f = [x for x in _scan(src) if x.rule == "kv-page-leak"]
    assert f and "without being freed or handed off" in f[0].message


def test_kv_page_leak_loop_settlement_forms():
    src = """
    def retire(pool, seqs):
        recycled = []
        for seq in seqs:
            pages = pool.alloc_pages(seq.need)
            if seq.short:
                pool.free_pages(pages)
            else:
                recycled.append(pages)
        return recycled
    """
    assert "kv-page-leak" not in _rules_of(_scan(src))


def test_kv_page_leak_fixture_lines():
    path = os.path.join(FIXTURE, "serving", "bad_kv_page_leak.py")
    findings = [f for f in analyze_paths([path], root=REPO)
                if f.rule == "kv-page-leak"]
    tree = ast.parse(open(path).read())
    expected = set()
    for fn in tree.body:
        if isinstance(fn, ast.FunctionDef) and fn.name.endswith("_leak"):
            expected.add(min(n.lineno for n in ast.walk(fn)
                             if isinstance(n, ast.Assign)))
    assert {f.line for f in findings} == expected
    assert len(findings) == 2


def test_kv_page_leak_clean_on_the_ports_scheduler():
    """The port's PagedKVAllocator has ``alloc_pages`` too; its admission
    path frees on every exit."""
    sched = os.path.join(PKG, "inference", "decode_scheduler.py")
    src = open(sched).read()
    assert "def alloc_pages" in src and ".alloc_pages(" in src
    findings = [f for f in analyze_paths([sched, ENGINE], root=REPO)
                if f.rule == "kv-page-leak"]
    assert findings == []


# ------------------------------------------------------------ CFG cache

def test_cfg_cache_hits_and_rebuild():
    ctx, err = parse_file(ENGINE, REPO)
    assert err is None
    fn = next(n for n in ctx.walk()
              if isinstance(n, ast.FunctionDef) and n.name == "_produce")
    CFG_STATS["built"] = CFG_STATS["hits"] = 0
    g1 = ctx.cfg(fn)
    g2 = ctx.cfg(fn)
    assert g1 is g2
    assert CFG_STATS == {"built": 1, "hits": 1}
    ctx2, _ = parse_file(ENGINE, REPO)
    fn2 = next(n for n in ctx2.walk()
               if isinstance(n, ast.FunctionDef) and n.name == "_produce")
    assert ctx.func_hash(fn) == ctx2.func_hash(fn2)


# ------------------------------------------------ acceptance: engine demo

def test_hand_introduced_ack_drop_is_caught():
    """Delete the undecodable-record handler's ack in the port's engine
    and the path-sensitive rule must catch the exception-edge drop."""
    src = open(ENGINE, encoding="utf-8").read()
    lines = src.splitlines(keepends=True)
    idx = next(i for i, ln in enumerate(lines)
               if "dropping undecodable record" in ln)
    assert "term_acks.append(ack)" in lines[idx + 1]
    broken = "".join(lines[:idx + 1] + lines[idx + 2:])
    rel = "analytics_zoo_tpu_torch/serving/engine.py"
    before = [f for f in analyze_source(src, rel)
              if f.rule == "record-ack-leak"]
    after = [f for f in analyze_source(broken, rel)
             if f.rule == "record-ack-leak"]
    new = {f.line for f in after} - {f.line for f in before}
    assert len(new) == 1
    intake_line = max(i for i, ln in enumerate(lines, 1)
                      if "for eid, lane, payload in entries:" in ln
                      and i <= idx)
    assert new == {intake_line}


# -------------------------------------------------------------- CLI

def test_cli_timing_prints_cfg_stats(capsys):
    rc = cli.main(["--timing", "--no-baseline",
                   os.path.join(PKG, "analysis")])
    assert rc in (0, 1)
    err = capsys.readouterr().err
    assert "CFGs built=" in err and "cache-hits=" in err


def test_cli_prune_baseline_report_and_fix(tmp_path, capsys):
    (tmp_path / ".git").mkdir()
    mod = tmp_path / "mod.py"
    mod.write_text("X = 1\n")
    bl = tmp_path / "bl.json"
    bl.write_text(json.dumps({"version": 2, "entries": [
        {"fingerprint": "deadbeefdeadbeef", "rule": "wallclock-hotpath",
         "path": "mod.py", "line": 1, "message": "gone",
         "justification": "was justified once"}]}))
    assert cli.main([str(mod), "--baseline", str(bl),
                     "--prune-baseline"]) == 0
    out = capsys.readouterr().out
    assert "deadbeefdeadbeef" in out and "stale" in out
    assert len(json.loads(bl.read_text())["entries"]) == 1
    assert cli.main([str(mod), "--baseline", str(bl),
                     "--prune-baseline=fix"]) == 0
    assert json.loads(bl.read_text())["entries"] == []
    bl.write_text(json.dumps({"version": 2, "entries": [
        {"fingerprint": "cafecafecafecafe", "rule": "wallclock-hotpath",
         "path": "elsewhere.py", "line": 1, "message": "gone",
         "justification": "x"}]}))
    assert cli.main([str(mod), "--baseline", str(bl),
                     "--prune-baseline=fix"]) == 0
    assert len(json.loads(bl.read_text())["entries"]) == 1


def test_port_tree_path_sensitive_findings_are_the_baselined_ones():
    """The six path-sensitive rules on the port's tree: the engine's
    dedupe loop, the decode feedback and the multi-rank evaluate's mask,
    each baselined with its reason."""
    findings = [f for f in analyze_paths([PKG], root=REPO, jobs=4)
                if f.rule in ("record-ack-leak", "lock-release-path",
                              "span-pairing", "tainted-host-sync",
                              "shape-dependent-branch-in-jit",
                              "kv-page-leak")]
    assert {(f.rule, f.path) for f in findings} == {
        ("record-ack-leak", "analytics_zoo_tpu_torch/serving/engine.py"),
        ("tainted-host-sync",
         "analytics_zoo_tpu_torch/inference/generation.py"),
        ("tainted-host-sync", "analytics_zoo_tpu_torch/learn/estimator.py"),
    }
