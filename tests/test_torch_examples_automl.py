"""The port's AutoML and AutoTS examples on the CPU:
``examples_torch/{automl_hp_search,autots_forecast}.py`` run as
subprocesses with ``--device cpu`` (``tests/torch_examples.py``), as
``tests/test_examples.py`` runs their JAX twins; autots_forecast is
marked slow, as JAX's is.

Each run must exit 0, so its own asserts hold (the restored best model's
validation MSE under 0.6 of the target's variance; the pipeline predicts,
evaluates and fits again), and print its lines. The searches' numbers
depend on each package's random initialisation and are not compared with
JAX's.
"""

import pytest

from torch_examples import SLOW, check, raises_without_cuda, run

SCRIPTS = ["automl_hp_search.py", "autots_forecast.py"]
LINES = {"automl_hp_search.py": ("best config: {'hidden': ",
                                 "best model val mse:"),
         "autots_forecast.py": ("forecast shape: (89, 1)", "evaluation:",
                                "incremental fit OK")}


@pytest.mark.parametrize("script", [
    pytest.param(s, marks=pytest.mark.slow) if s in SLOW else s
    for s in SCRIPTS])
def test_example_runs_on_the_cpu(script, tmp_path):
    check(run(script, tmp_path), script, *LINES[script])


@pytest.mark.parametrize("script", SCRIPTS)
def test_example_raises_without_cuda(script, monkeypatch):
    raises_without_cuda(script, monkeypatch)
