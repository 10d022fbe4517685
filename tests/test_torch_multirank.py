"""The port's fits across ranks against the JAX package, on the CPU
(mirrors JAX ``tests/test_multihost.py`` but its pipeline test, with
``tests/test_estimator.py``'s fsdp test, ``test_estimator_factories.py``'s
strategy tests and ``test_text_bert.py``'s tensor-parallel BERT).

The port's ranks are gloo processes on the host, started by
``parallel/launch.py`` (``tests/torch_multirank_workers.py``, no JAX):
one group of 2 ranks, one of 4 and one of 8, each launched once for the
module. JAX's side runs in this process on its 8 virtual CPU devices,
JAX's ``examples/multihost_launch.py`` model and data, from the same
parameters:

- "dp" over 2 and over 4 ranks, "fsdp" and "tp2" (JAX's Megatron rules
  for the MLP) over 2, "dp2,fsdp2" over 4, the streaming feed (each rank
  its own DISK_2 shards): the loss history within JAX's own ``atol=2e-4``
  of JAX's single-process run, every parameter within 1e-5 of JAX's
  after the fit, the same history on every rank;
- "tp4,dp2" over 8 ranks, the layout JAX refuses across processes
  (batch axes not process-major): each rank knows its data index, so it
  feeds correctly, held against JAX's single-process "tp4,dp2" (C27);
- ``from_keras`` keeps a model's strategy and rules; a keras model's
  predictions survive a new "dp,tp2" layout (every kernel split by
  output features: the Dense's column path);
- BERTClassifier under "dp,tp2" (``bert_tp_rules``): the query kernel is
  a block of half the heads, the history is the one-rank fit's within
  1e-5, the snapshot rank 0 wrote loads into a one-rank estimator whose
  predictions are the ranks' within 1e-6, and a sharded estimator
  resumes from it bitwise (JAX's own "dp,tp2" BERT, and NeuralCF under
  its tensor-parallel rules, are held in
  ``tests/test_torch_multirank_tp.py``).
"""

import os
import sys

import numpy as np
import pytest

from analytics_zoo_tpu_torch.parallel.launch import launch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKERS = os.path.join(REPO, "tests", "torch_multirank_workers.py")
EPOCHS = 2
BATCH = 32
BERT_CFG = dict(vocab=100, hidden_size=64, n_block=2, n_head=4,
                intermediate_size=128, max_position_len=32,
                hidden_drop=0.0, attn_drop=0.0)
TP_RULES = [["w1", [None, "model"]], ["b1", ["model"]],
            ["w2", ["model", None]]]


@pytest.fixture(autouse=True)
def _tmp_log_dir(tmp_path, monkeypatch):
    """The in-process fits' summaries go to the test's own directory."""
    from analytics_zoo_tpu_torch.learn import estimator
    monkeypatch.setattr(estimator, "DEFAULT_LOG_DIR", str(tmp_path / "tb"))


def _mh():
    sys.path.insert(0, os.path.join(REPO, "examples"))
    import multihost_launch as mh
    return mh


@pytest.fixture(scope="module")
def jax_runs():
    """JAX's single-process fits on its 8 virtual devices: "dp" (the
    reference of every layout, same math), "dp2,fsdp4" and "tp4,dp2"."""
    pytest.importorskip("jax")
    import jax
    from analytics_zoo_tpu.common import context as jctx
    mh = _mh()
    x, y = mh.make_data()
    out = {}
    for strategy in ("dp", "dp2,fsdp4", "tp4,dp2"):
        jctx.stop_orca_context()
        jctx.init_orca_context(cluster_mode="local")
        try:
            est = mh.build_estimator(x.shape[1], strategy)
            params = jax.device_get(est.adapter.params)
            hist = est.fit((x, y), epochs=EPOCHS, batch_size=BATCH,
                           shuffle=False)
            out[strategy] = {"loss": hist["loss"],
                             "params": jax.device_get(
                                 est._state["params"]),
                             "init": params}
        finally:
            jctx.stop_orca_context()
    out["data"] = (x, y)
    return out


def _mlp(name, strategy, jax_runs, rules=None, data="array"):
    x, y = jax_runs["data"]
    return {"name": name, "fn": "mlp_fit", "strategy": strategy,
            "rules": rules, "data": data, "epochs": EPOCHS, "batch": BATCH,
            "x": x.tolist(), "y": y.tolist(),
            "params": {k: np.asarray(v).tolist()
                       for k, v in jax_runs["dp"]["init"].items()}}


def _bert_data():
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 100, (32, 12)).astype(np.int32)
    return ids, (ids[:, 0] % 2).astype(np.int32)


@pytest.fixture(scope="module")
def ranks(jax_runs, tmp_path_factory):
    """Each rank group launched once; every rank's results."""
    path = str(tmp_path_factory.mktemp("bert_tp") / "ckpt")
    ids, labels = _bert_data()
    # an estimator takes the default mesh where it has the strategy's
    # axes (JAX's rule), so "dp" runs before the layouts that build others
    two = [_mlp("dp", "dp", jax_runs),
           _mlp("streaming", "dp", jax_runs, data="streaming"),
           _mlp("fsdp", "fsdp", jax_runs),
           _mlp("tp2", "tp2", jax_runs, TP_RULES),
           {"name": "keras", "fn": "keras_keeps_weights"},
           {"name": "bert", "fn": "bert_tp", "strategy": "dp,tp2",
            "config": BERT_CFG, "ids": ids.tolist(),
            "labels": labels.tolist(), "batch": 16, "path": path}]
    four = [_mlp("dp4", "dp", jax_runs),
            _mlp("dp2,fsdp2", "dp2,fsdp2", jax_runs)]
    eight = [_mlp("tp4,dp2", "tp4,dp2", jax_runs, TP_RULES),
             {"name": "rules", "fn": "keras_rules_kept"}]
    return {2: launch(f"{WORKERS}:fit_group", 2, args=(two,)),
            4: launch(f"{WORKERS}:fit_group", 4, args=(four,)),
            8: launch(f"{WORKERS}:fit_group", 8, args=(eight,)),
            "bert_path": path}


def _check_mlp(results, name, want):
    first = results[0][name]
    for r in results:
        # every rank reports the global history
        assert r[name]["loss"] == first["loss"]
    assert first["loss"][-1] < first["loss"][0]
    np.testing.assert_allclose(first["loss"], want["loss"], rtol=0,
                               atol=2e-4)
    for k, v in want["params"].items():
        np.testing.assert_allclose(np.asarray(first["params"][k]),
                                   np.asarray(v), rtol=0, atol=1e-5,
                                   err_msg=k)
    return first


@pytest.mark.parametrize("world, name", [(2, "dp"), (4, "dp4"),
                                         (2, "streaming")])
def test_dp_matches_jax(ranks, jax_runs, world, name):
    got = _check_mlp(ranks[world], name, jax_runs["dp"])
    assert got["mesh"] == {"data": world} and got["shards"] == {}


def test_fsdp_matches_dp(ranks, jax_runs):
    """Each parameter on its largest divisible dim over "fsdp", JAX's
    choice; the same math as dp."""
    got = _check_mlp(ranks[2], "fsdp", jax_runs["dp"])
    assert got["shards"] == {"w1": [8, 8], "b1": [8], "w2": [8, 1]}
    assert all(a == ["fsdp"] for a in got["axes"].values())


def test_dp2_fsdp2_matches_jax(ranks, jax_runs):
    """JAX ``test_fsdp_strategy``: parameters sharded over fsdp inside a
    data-parallel layout."""
    got = _check_mlp(ranks[4], "dp2,fsdp2", jax_runs["dp2,fsdp4"])
    assert got["mesh"] == {"data": 2, "fsdp": 2}
    assert set(got["shards"]) == {"w1", "b1", "w2"}


def test_tp_spans_ranks(ranks, jax_runs):
    """JAX's Megatron rules for the MLP over "model" across the ranks;
    the batch replicated (every rank feeds the whole batch)."""
    got = _check_mlp(ranks[2], "tp2", jax_runs["dp"])
    assert got["shards"] == {"w1": [8, 8], "b1": [8], "w2": [8, 1]}


def test_non_process_major_layout_feeds_correctly(ranks, jax_runs):
    """C27: "tp4,dp2" (model-major), which JAX refuses across processes,
    against JAX's single-process run of the same strategy."""
    got = _check_mlp(ranks[8], "tp4,dp2", jax_runs["tp4,dp2"])
    assert got["mesh"] == {"model": 4, "data": 2}
    assert got["shards"] == {"w1": [8, 4], "b1": [4], "w2": [4, 1]}


def test_from_keras_keeps_strategy_and_rules(ranks):
    got = ranks[8][0]["rules"]
    assert got["strategy"] == "dp2,tp4"
    assert got["rules"] == [["kernel", [None, "model"]]]
    # the first kernel's 4 outputs split over tp4; 2 classes do not divide
    assert got["shards"] == {"dense_1.weight": [1, 4]}


def test_set_strategy_keeps_weights(ranks):
    got = ranks[2][0]["keras"]
    assert got["strategy"] == "dp,tp2"
    assert got["covered"] == ["dense_1.weight", "dense_2.weight"]
    np.testing.assert_allclose(np.asarray(got["after"]),
                               np.asarray(got["before"]), atol=1e-5)


def test_tensor_parallel_bert(ranks):
    """JAX ``test_tensor_parallel_bert`` and the snapshot of a sharded
    fit: one-rank load, sharded resume."""
    from analytics_zoo_tpu_torch.text import BERTClassifier, BertConfig
    got = ranks[2][0]["bert"]
    assert np.isfinite(got["loss"]).all()
    assert got["query_local"] == [32, 64] and got["query_whole"] == [64, 64]
    assert got["gathered"] == []
    assert got["resumed_bitwise"]
    ids, labels = _bert_data()
    one = BERTClassifier(num_classes=2, config=BertConfig(**BERT_CFG),
                         seq_len=12, device="cpu")
    one.fit(ids, labels, epochs=1, batch_size=16)
    np.testing.assert_allclose(got["steps"], one.estimator.step_losses,
                               rtol=0, atol=1e-5)
    loaded = BERTClassifier(num_classes=2, config=BertConfig(**BERT_CFG),
                            seq_len=12, device="cpu")
    loaded.load(ranks["bert_path"])
    np.testing.assert_allclose(np.asarray(loaded.predict(ids, batch_size=16)),
                               np.asarray(got["pred"]), rtol=0, atol=1e-6)


def test_launch_environment():
    """The launcher's ranks: torchrun's names, gloo, one thread each."""
    got = launch(f"{WORKERS}:environment", 2)
    assert [g["RANK"] for g in got] == ["0", "1"]
    assert {g["WORLD_SIZE"] for g in got} == {"2"}
    assert {g["backend"] for g in got} == {"gloo"}
    assert {g["threads"] for g in got} == {1}


def test_failing_rank_fails_the_launch():
    with pytest.raises(RuntimeError, match="of 2 exited with"):
        launch(f"{WORKERS}:no_such_function", 2, timeout=120)
