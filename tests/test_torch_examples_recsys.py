"""The port's recommendation and tabular examples on the CPU:
``examples_torch/{recommendation_ncf,wide_and_deep,fraud_detection}.py``
run with ``--device cpu`` in one subprocess, one after another
(``tests/torch_examples.py``), as ``tests/test_examples.py`` runs their
JAX twins.

Each run must exit 0, so its own asserts hold (the loss falls, the
checkpoint round trip within 1e-5, W&D's accuracy above 0.3, the fraud
model's AUC above 0.9), and print its lines. What comes from
deterministic host code is held to the JAX twin's run: Friesian's
engineered table that feeds W&D (``FeatureTable.to_pandas``, every
column and value) and its printed true ratings (the twin's table's
labels), and the fraud example's resampled shards (XShards' ``collect``)
and its printed resampling line. Lines of the fitted models depend on
each package's random initialisation and are not compared, so each twin
stops where its model is built. JAX runs only in the ``jax_runs``
fixture, which skips where JAX is absent.
"""

import numpy as np
import pandas as pd
import pytest

from torch_examples import (check, lines_starting, raises_without_cuda,
                            runner)

SCRIPTS = ["recommendation_ncf.py", "wide_and_deep.py",
           "fraud_detection.py"]
TAPS = {"wide_and_deep.py": [("table", "friesian.feature.table",
                              "FeatureTable.to_pandas")],
        "fraud_detection.py": [("shards", "data.shard",
                                "HostXShards.collect")]}
#: where the JAX twins stop: nothing after the model's construction is
#: compared
STOPS = {"wide_and_deep.py": [("models.recommendation.wide_and_deep",
                               "WideAndDeep.__init__")],
         "fraud_detection.py": [("learn.estimator", "Estimator.from_flax")]}
LINES = {"recommendation_ncf.py": ("train loss per epoch:", "eval:",
                                   "first predictions:",
                                   "checkpoint round-trip OK"),
         "wide_and_deep.py": ("train loss per epoch:", "eval:",
                              "predicted ratings:", "true ratings:"),
         "fraud_detection.py": ("resampled train set:",
                                "fraud detection: AUC")}


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    return runner(tmp_path_factory, taps=TAPS, batch=SCRIPTS)


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    pytest.importorskip("jax")
    return runner(tmp_path_factory, jax=True, taps=TAPS, stops=STOPS)


@pytest.mark.parametrize("script", SCRIPTS)
def test_example_runs_on_the_cpu(port_runs, script):
    check(port_runs(script), script, *LINES[script])


@pytest.mark.parametrize("script", SCRIPTS)
def test_example_raises_without_cuda(script, monkeypatch):
    raises_without_cuda(script, monkeypatch)


def test_wide_and_deep_friesian_table_matches_jax(port_runs, jax_runs):
    mine = port_runs("wide_and_deep.py")
    theirs = jax_runs("wide_and_deep.py")
    check(theirs, "examples/wide_and_deep.py")
    (got,), (want,) = mine.taps["table"], theirs.taps["table"]
    assert list(got.columns) == list(want.columns)
    assert len(got) == 6000
    pd.testing.assert_frame_equal(got, want, check_dtype=True)
    # the twin prints ``y[:8]`` of this table's labels after its fit
    assert lines_starting(mine, "true ratings:") == [
        "true ratings:      " + str(want["label"].to_numpy(
            np.int32)[:8].tolist())]


def test_fraud_detection_resampling_matches_jax(port_runs, jax_runs):
    mine = port_runs("fraud_detection.py")
    theirs = jax_runs("fraud_detection.py")
    check(theirs, "examples/fraud_detection.py")
    (got,), (want,) = mine.taps["shards"], theirs.taps["shards"]
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        assert sorted(a) == sorted(b) == ["x", "y"]
        np.testing.assert_array_equal(a["x"], b["x"])
        np.testing.assert_array_equal(a["y"], b["y"])
    assert lines_starting(mine, "resampled train set:") == \
        lines_starting(theirs, "resampled train set:") == [
            "resampled train set: 440 rows, 20.0% fraud (raw rate 0.52%)"]
