"""The port's inference and serving examples on the CPU:
``examples_torch/{cluster_serving,torch_migration,model_inference,
image_classification_serving}.py`` run with ``--device cpu`` in one
subprocess, one after another (``tests/torch_examples.py``), as
``tests/test_examples.py`` runs their JAX twins.

Each run must exit 0, so its own asserts hold (every record answered,
the loss falls, the loaded torch module's outputs within 1e-4 of
torch's, top-1 agreement of the int8 model at least 0.98), and print its
lines. Where both packages compute from the same torch module seeded by
``torch.manual_seed(0)`` (JAX translates it), the outputs are held to
the JAX twin's run: cluster_serving's served classes and HTTP result, and
torch_migration's loss per epoch (within 2e-4 of the printed 4 decimals;
the fits themselves are held within 1e-5 by tests/test_torch_learn.py).
torch_migration's served classes are not: the port trains the module
itself, JAX a translated copy (ROADMAP C37). JAX runs only in the
``jax_runs`` fixture, which skips where JAX is absent.
"""

import re

import pytest

from torch_examples import (check, lines_starting, raises_without_cuda,
                            runner)

SCRIPTS = ["cluster_serving.py", "torch_migration.py",
           "model_inference.py", "image_classification_serving.py"]
LINES = {"cluster_serving.py": ("broker backend: native", "queue results:",
                                "http result:", "served: 18 records",
                                "pipeline gauges:"),
         "torch_migration.py": ("loss:", "final eval loss:",
                                "served classes:"),
         "model_inference.py": ("zoo model: (64, 3) rows sum to 1.0",
                                "served 4 concurrent callers",
                                "module: (16, 2)",
                                "torch model loaded; outputs match torch",
                                "quantized: "),
         "image_classification_serving.py": ("img-0 ->", "img-1 ->",
                                             "img-2 ->", "served 6 images")}


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    return runner(tmp_path_factory, batch=SCRIPTS)


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    pytest.importorskip("jax")
    return runner(tmp_path_factory, jax=True)


@pytest.mark.parametrize("script", SCRIPTS)
def test_example_runs_on_the_cpu(port_runs, script):
    check(port_runs(script), script, *LINES[script])


@pytest.mark.parametrize("script", SCRIPTS)
def test_example_raises_without_cuda(script, monkeypatch):
    raises_without_cuda(script, monkeypatch)


def test_cluster_serving_results_match_jax(port_runs, jax_runs):
    mine, theirs = port_runs("cluster_serving.py"), jax_runs(
        "cluster_serving.py")
    check(theirs, "examples/cluster_serving.py")
    for prefix in ("queue results:", "http result:", "served: 18 records"):
        a, b = lines_starting(mine, prefix), lines_starting(theirs, prefix)
        if prefix.startswith("served"):
            # the stage latencies after it are each process's own
            a, b = [x.split(";")[0] for x in a], [x.split(";")[0] for x in b]
        assert a == b and len(a) == 1, (prefix, a, b)


def _floats(line):
    return [float(v) for v in re.findall(r"-?\d+\.\d+", line)]


def test_torch_migration_losses_match_jax(port_runs, jax_runs):
    mine, theirs = port_runs("torch_migration.py"), jax_runs(
        "torch_migration.py")
    check(theirs, "examples/torch_migration.py")
    for prefix in ("loss:", "final eval loss:"):
        (a,), (b,) = lines_starting(mine, prefix), lines_starting(
            theirs, prefix)
        got, want = _floats(a), _floats(b)
        assert len(got) == len(want) > 0
        assert max(abs(x - y) for x, y in zip(got, want)) <= 2e-4, (a, b)
