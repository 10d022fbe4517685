"""The port's zoolint, whole-program half: call-graph construction,
thread-root inference, runs-on propagation, lock tracking through helper
methods (must-held), cross-file lock-cycle detection, and the generated
ownership map's drift check against docs/concurrency_torch.md."""

import json
import os
import textwrap

from analytics_zoo_tpu_torch.analysis import analyze_paths, build_project
from analytics_zoo_tpu_torch.analysis import ownership
from analytics_zoo_tpu_torch.analysis.core import build_model_for_paths

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _project(**sources):
    """build_project from dedented keyword sources; ``pkg__mod`` becomes
    ``pkg/mod.py``."""
    return build_project({
        name.replace("__", "/") + ".py": textwrap.dedent(src)
        for name, src in sources.items()
    })


# ------------------------------------------------------------- call graph

def test_call_graph_cross_module_edges():
    m = _project(
        app__worker="""
        def helper():
            return 1

        def run():
            return helper()
        """,
        app__main="""
        from app.worker import run

        def entry():
            return run()
        """,
    )
    assert "app.worker.helper" in m.edges["app.worker.run"]
    assert "app.worker.run" in m.edges["app.main.entry"]
    assert "app.main.entry" in m.incoming["app.worker.run"]


def test_call_graph_method_edges_via_self():
    m = _project(
        app__svc="""
        class Svc:
            def _step(self):
                pass

            def run(self):
                self._step()
        """,
    )
    assert "app.svc.Svc._step" in m.edges["app.svc.Svc.run"]


def test_library_calls_never_join_project_methods_by_name():
    """The unique-method-name fallback skips a receiver imported from
    outside the project: ``torch.cuda.stream(s)`` reaches no project
    ``stream`` method, while a call on a local of unknown type still
    resolves to the one class that defines the method."""
    m = _project(
        app__broker="""
        class State:
            def stream(self, name):
                return name
        """,
        app__search="""
        import torch
        import torch.cuda as tc

        def worker(s):
            with torch.cuda.stream(s):
                pass
            with tc.stream(s):
                pass

        def local(st):
            return st.stream("x")
        """,
    )
    assert "app.broker.State.stream" not in m.edges.get(
        "app.search.worker", set())
    assert "app.broker.State.stream" in m.edges["app.search.local"]


def test_fixture_library_receiver_reaches_no_project_method(monkeypatch):
    """tests/fixtures/zoolint_torch/fleet/ok_library_receiver.py: clean,
    and on JAX's call graph (the check off) its worker's
    ``torch.cuda.stream`` makes the main-only write a race."""
    path = os.path.join(REPO, "tests", "fixtures", "zoolint_torch",
                        "fleet", "ok_library_receiver.py")
    assert analyze_paths([path], root=REPO) == []
    from analytics_zoo_tpu_torch.analysis.core import ProjectModel
    monkeypatch.setattr(ProjectModel, "_outside_receiver",
                        lambda self, base, owner: False)
    (f,) = analyze_paths([path], root=REPO)
    assert f.rule == "cross-thread-unlocked-state"
    assert "StreamTable.streams" in f.message


# ------------------------------------------------------------ thread roots

def test_thread_root_inferred_from_spawn():
    m = _project(
        app__eng="""
        import threading

        class Engine:
            def start(self):
                self._t = threading.Thread(
                    target=self._run, name="zoo-serve", daemon=True)
                self._t.start()

            def _run(self):
                pass
        """,
    )
    assert m.roots["zoo-serve"].kind == "thread"
    assert m.roots["zoo-serve"].entries == ["app.eng.Engine._run"]


def test_executor_submit_and_atexit_roots():
    m = _project(
        app__pool="""
        import atexit
        from concurrent.futures import ThreadPoolExecutor

        def task():
            pass

        def _cleanup():
            pass

        def go():
            ex = ThreadPoolExecutor(max_workers=2)
            ex.submit(task)
            atexit.register(_cleanup)
        """,
    )
    kinds = {r.kind for r in m.roots.values()}
    assert "executor" in kinds and "atexit" in kinds


def test_pytest_only_roots_excluded():
    m = _project(
        tests__test_x="""
        import threading

        def test_spawns():
            t = threading.Thread(target=print)
            t.start()
            t.join()
        """,
    )
    assert all(r.kind == "main" for r in m.roots.values())


# --------------------------------------------------------- runs-on

def test_runs_on_propagates_through_calls():
    m = _project(
        app__eng="""
        import threading

        def leaf():
            pass

        def loop():
            leaf()

        class Engine:
            def start(self):
                threading.Thread(target=loop, name="zoo-w").start()
        """,
    )
    assert "zoo-w" in m.runs_on["app.eng.loop"]
    assert "zoo-w" in m.runs_on["app.eng.leaf"]
    assert "zoo-w" not in m.runs_on.get("app.eng.Engine.start", frozenset())


def test_atexit_root_folds_into_main_for_runs_on():
    m = _project(
        app__ctx="""
        import atexit

        def _shutdown():
            pass

        atexit.register(_shutdown)
        """,
    )
    assert any(r.kind == "atexit" for r in m.roots.values())
    assert m.runs_on["app.ctx._shutdown"] == frozenset({"main"})


# ------------------------------------------------- must-held via helpers

def test_lock_tracked_through_helper_method():
    m = _project(
        app__st="""
        import threading

        class Store:
            def __init__(self):
                self._lock = threading.Lock()
                self.n = 0

            def _bump_locked(self):
                self.n += 1

            def add(self):
                with self._lock:
                    self._bump_locked()

            def sub(self):
                with self._lock:
                    self._bump_locked()
        """,
    )
    assert any("_lock" in h for h in m.must_held["app.st.Store._bump_locked"])


def test_must_held_empty_when_one_caller_is_unlocked():
    m = _project(
        app__st="""
        import threading

        class Store:
            def __init__(self):
                self._lock = threading.Lock()
                self.n = 0

            def _bump(self):
                self.n += 1

            def add(self):
                with self._lock:
                    self._bump()

            def racy(self):
                self._bump()
        """,
    )
    assert m.must_held["app.st.Store._bump"] == frozenset()


def test_confinement_contract_exempts_a_class(tmp_path):
    """The port's NativeBlobStore states "Not thread-safe" as JAX's does:
    its handle is then the caller's to confine."""
    src = textwrap.dedent('''
        import threading

        class Store:
            """Not thread-safe: one store per owning thread."""

            def __init__(self):
                self.h = 1

            def close(self):
                self.h = None

        def pump(store):
            store.close()

        def start(store: Store):
            threading.Thread(target=pump, args=(store,)).start()
            store.close()
    ''')
    (tmp_path / "mod.py").write_text(src)
    fs = analyze_paths([str(tmp_path)], root=str(tmp_path))
    assert "cross-thread-unlocked-state" not in {f.rule for f in fs}
    m = build_model_for_paths([str(tmp_path)], root=str(tmp_path))
    assert "mod.Store" in ownership.build_report(m)["confined_classes"]


# ------------------------------------------------ cross-file lock cycles

def test_cross_file_lock_cycle_detected(tmp_path):
    (tmp_path / "locksmod.py").write_text(textwrap.dedent("""
        import threading

        LOCK_A = threading.Lock()
        LOCK_B = threading.Lock()

        def forward():
            with LOCK_A:
                with LOCK_B:
                    pass
    """))
    (tmp_path / "other.py").write_text(textwrap.dedent("""
        from locksmod import LOCK_A, LOCK_B

        def backward():
            with LOCK_B:
                with LOCK_A:
                    pass
    """))
    fs = analyze_paths([str(tmp_path)], root=str(tmp_path))
    assert "lock-order-inversion" in {f.rule for f in fs}


def test_same_file_abba_left_to_per_file_rule(tmp_path):
    (tmp_path / "abba.py").write_text(textwrap.dedent("""
        import threading

        LOCK_A = threading.Lock()
        LOCK_B = threading.Lock()

        def fwd():
            with LOCK_A:
                with LOCK_B:
                    pass

        def bwd():
            with LOCK_B:
                with LOCK_A:
                    pass
    """))
    rules = {f.rule for f in analyze_paths([str(tmp_path)],
                                           root=str(tmp_path))}
    assert "lock-order" in rules
    assert "lock-order-inversion" not in rules


# ------------------------------------------------------ ownership report

def test_ownership_report_structure():
    m = _project(
        app__eng="""
        import threading

        class Engine:
            def __init__(self):
                self._lock = threading.Lock()
                self.count = 0

            def start(self):
                threading.Thread(
                    target=self._run, name="zoo-serve",
                    daemon=True).start()

            def _run(self):
                with self._lock:
                    self.count += 1
        """,
    )
    rep = ownership.build_report(m)
    assert rep["version"] == ownership.REPORT_SCHEMA_VERSION
    rids = [r["root"] for r in rep["roots"]]
    assert rids[0] == "main" and "zoo-serve" in rids


def test_concurrency_torch_doc_has_no_drift(tmp_path):
    """docs/concurrency_torch.md and its JSON twin match a fresh
    regeneration over the port."""
    model = build_model_for_paths(
        [os.path.join(REPO, "analytics_zoo_tpu_torch")], root=REPO, jobs=2)
    md = tmp_path / "concurrency_torch.md"
    ownership.write_report(model, str(md))
    committed = os.path.join(REPO, "docs", "concurrency_torch.md")
    assert md.read_text() == open(committed).read(), \
        "docs/concurrency_torch.md is stale; regenerate with " \
        "`python -m analytics_zoo_tpu_torch.analysis " \
        "--ownership-report docs/concurrency_torch.md`"
    with open(os.path.join(REPO, "docs", "concurrency_torch.json")) as fh:
        js = json.load(fh)
    assert js == json.loads((tmp_path / "concurrency_torch.json")
                            .read_text())
    root_ids = " ".join(r["root"] for r in js["roots"])
    for expected in ("zoo-serving", "zoo-fleet-heartbeat",
                     "zoo-replica-supervisor", "zoo-warm-decode"):
        assert expected in root_ids
    assert "analytics_zoo_tpu_torch.data.native_store.NativeBlobStore" in \
        js["confined_classes"]
