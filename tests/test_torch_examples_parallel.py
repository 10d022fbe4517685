"""The port's examples that start ranks, on the CPU:
``examples_torch/{distributed_training,multihost_launch}.py`` run as
subprocesses with ``--device cpu`` (``tests/torch_examples.py``), their
ranks gloo processes on the host; both are marked slow, as JAX's are.

distributed_training's 8 ranks (JAX's 8 virtual devices) train NCF under
"dp", "fsdp" and "dp2,tp4", the pipelined MLP and LM under "dp2,pp4",
and hold ring attention to Ulysses under "dp2,sp4" within JAX's limits;
every rank must report the same global losses. multihost_launch's two
workers join through ``init_orca_context(cluster_mode="multihost",
coordinator_address=..., num_processes=2, process_id=...)``, feed their
own rows of each global batch and report one result; with the same data
and parameters as JAX's example its losses and evaluation are the JAX
twin's within 1e-5 (JAX runs only in that test, which skips where JAX
is absent).
"""

import json

import pytest

from torch_examples import check, lines_starting, raises_without_cuda, run

SCRIPTS = ["distributed_training.py", "multihost_launch.py"]


@pytest.mark.slow
def test_distributed_training_runs_on_the_cpu(tmp_path):
    res = run("distributed_training.py", tmp_path)
    check(res, "distributed_training.py", "dp         mesh={'data': 8}",
          "fsdp       mesh={'fsdp': 8}",
          "dp2,tp4    mesh={'data': 2, 'model': 4}",
          "dp2,pp4    pipeline loss=", "dp2,pp4    hetero-LM loss=",
          "dp2,sp4    ring == ulysses attention")


def _result(res):
    return json.loads(lines_starting(res, "MULTIHOST_RESULT ")[-1]
                      .split(" ", 1)[1])


@pytest.mark.slow
def test_multihost_launch_runs_on_the_cpu(tmp_path):
    res = run("multihost_launch.py", tmp_path / "port")
    check(res, "multihost_launch.py", "--- worker 0 (ok) ---",
          "--- worker 1 (ok) ---", "MULTIHOST_RESULT ")
    result = _result(res)
    assert result["process_count"] == result["global_devices"] == 2
    assert result["strategy"] == "dp" and len(result["loss"]) == 2
    pytest.importorskip("jax")
    theirs = run("multihost_launch.py", tmp_path / "jax", jax=True)
    check(theirs, "examples/multihost_launch.py", "MULTIHOST_RESULT ")
    want = _result(theirs)
    assert want["process_count"] == 2 and want["strategy"] == "dp"
    assert result["loss"] == pytest.approx(want["loss"], abs=1e-5)
    assert result["eval_loss"] == pytest.approx(want["eval_loss"],
                                                abs=1e-5)


@pytest.mark.parametrize("script", SCRIPTS)
def test_example_raises_without_cuda(script, monkeypatch):
    raises_without_cuda(script, monkeypatch)
