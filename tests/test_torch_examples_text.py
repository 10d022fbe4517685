"""The port's text and time-series examples on the CPU:
``examples_torch/{sentiment_analysis,qa_ranker,anomaly_detection}.py``
run with ``--device cpu`` in one subprocess, one after another
(``tests/torch_examples.py``), as ``tests/test_examples.py`` runs their
JAX twins.

Each run must exit 0, so its own asserts hold (validation accuracy above
0.8, MAP above 0.6, the threshold detector's recall at least 0.5), and
print its lines. What comes from deterministic host code is held to the
JAX twin's run: TextSet's vocabulary (``get_word_index``, every call)
and the ids it feeds the models (sentiment's collected dataset shards,
qa_ranker's relation samples, bitwise), and the threshold detector's
line. The fitted models' lines depend on each package's random
initialisation and are not compared, so the sentiment and anomaly twins
stop where their models are built (qa_ranker's reads its validation
samples after its fit). JAX runs only in the ``jax_runs`` fixture, which
skips where JAX is absent.
"""

import numpy as np
import pytest

from torch_examples import (assert_same, check, lines_starting,
                            raises_without_cuda, runner)

SCRIPTS = ["sentiment_analysis.py", "qa_ranker.py", "anomaly_detection.py"]
VOCAB = ("vocab", "feature.text.textset", "TextSet.get_word_index")
TAPS = {"sentiment_analysis.py": [VOCAB, ("data", "data.shard",
                                          "HostXShards.collect")],
        "qa_ranker.py": [VOCAB, ("samples", "feature.text.textset",
                                 "TextSet.get_samples")]}
#: where the JAX twins stop: nothing after the model's construction is
#: compared
STOPS = {"sentiment_analysis.py": [
             ("models.textclassification.text_classifier",
              "TextClassifier.__init__")],
         "anomaly_detection.py": [("zouwu.model.anomaly",
                                   "AEDetector.__init__")]}
LINES = {"sentiment_analysis.py": ("sentiment analysis: val accuracy",),
         "qa_ranker.py": ("train loss per epoch:", "validation NDCG@3 = "),
         "anomaly_detection.py": ("ThresholdDetector: ", "AEDetector: ")}


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


def test_sentiment_vocabulary_and_ids_match_jax(port_runs, jax_runs):
    mine = port_runs("sentiment_analysis.py")
    theirs = jax_runs("sentiment_analysis.py")
    check(theirs, "examples/sentiment_analysis.py")
    assert mine.taps["vocab"] == theirs.taps["vocab"]
    assert len(mine.taps["vocab"][0]) > 20
    assert_same(mine.taps["data"], theirs.taps["data"], "collect")
    # the last collect is the dataset the classifier trains on
    x = np.concatenate([s["x"] for s in mine.taps["data"][-1]])
    assert x.shape == (240, 16)


def test_qa_ranker_vocabulary_and_samples_match_jax(port_runs, jax_runs):
    mine, theirs = port_runs("qa_ranker.py"), jax_runs("qa_ranker.py")
    check(theirs, "examples/qa_ranker.py")
    assert mine.taps["vocab"] == theirs.taps["vocab"]
    assert len(mine.taps["samples"]) >= 2
    assert_same(mine.taps["samples"], theirs.taps["samples"], "samples")
    assert "6 queries" in lines_starting(mine, "validation")[0]


def test_threshold_detector_matches_jax(port_runs, jax_runs):
    mine = port_runs("anomaly_detection.py")
    theirs = jax_runs("anomaly_detection.py")
    check(theirs, "examples/anomaly_detection.py")
    assert lines_starting(mine, "ThresholdDetector:") == \
        lines_starting(theirs, "ThresholdDetector:") == [
            "ThresholdDetector: 18 anomalies, recall 1.00"]
