"""Sharded serving in the port against the JAX package, on the CPU
(mirrors JAX ``tests/test_sharded_serving.py``).

A sharded replica is a group of ranks (ROADMAP C28): every rank builds
the same sharded model, rank 0 serves and dispatches, the others follow
(``parallel/sharded_executable.py``). The ranks are gloo processes on the
host (``parallel/launch.py``, the rank functions in
``tests/torch_serving_workers.py``, no JAX), one group of 2 launched once
for the module. JAX runs in this process on its 8 virtual CPU devices
from the same flax parameters:

- ``ShardedExecutable``: a flax tree through
  ``flax_to_shard_state_dict``, the dispatch against the unsharded module
  (1e-5) and JAX's sharded predict; each rank's resident bytes below the
  whole model's, their sum at least the whole (the biases replicate), the
  ``zoo_shard_hbm_bytes{shard}`` gauge; without rules every rank holds
  the whole model; warmed rungs dispatch with no new miss on rank 0 and
  none past the first of each shape on the follower; JAX's own form, a
  pure ``fn(params, x)``, against the unsharded function;
- ``InferenceModel.shard``: predict against the unsharded model and
  JAX's ``shard("tp8")`` predict (1e-5), ``shard_info``, a warmed ladder
  dispatching with the misses flat, and ``unshard`` releasing the
  follower; ``shard`` on a sharded model raises on every rank, and after
  ``unshard`` the model shards again from its whole parameters;
- BERT under ``bert_tp_rules`` (half the heads a rank, every sharded
  parameter computed on as a block) and NeuralCF under its
  tensor-parallel rules (the tables by columns), against the one-rank
  predict;
- the fleet merge does not sum the shard gauges (in this process);
- a generate record on a Seq2Seq sharded "tp2" through ClusterServing
  and the FrontEnd: its result within 1e-5 of ``generate(mode="raw")``, a
  plain record beside it, at least ``steps`` decode spans on ``/trace``,
  and the ``sharding`` block (``n_shards`` = 2) on ``/healthz`` and in
  ``metrics()``.
"""

import os

import numpy as np
import pytest

from analytics_zoo_tpu_torch.common import telemetry
from analytics_zoo_tpu_torch.parallel.launch import launch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKERS = os.path.join(REPO, "tests", "torch_serving_workers.py")
RULES = [(r"kernel", (None, "model"))]
STEPS = 16
BERT = dict(vocab=100, hidden_size=64, n_block=2, n_head=4,
            intermediate_size=128, max_position_len=32, hidden_drop=0.0,
            attn_drop=0.0)
NCF = dict(user_count=50, item_count=40, class_num=5, user_embed=8,
           item_embed=8, hidden_layers=(16, 8), mf_embed=8)


def _lists(tree):
    if isinstance(tree, dict):
        return {k: _lists(v) for k, v in tree.items()}
    return np.asarray(tree).tolist()


@pytest.fixture(scope="module")
def jax_side():
    """JAX's keras MLP (the ``_Net`` of its test as keras layers), its
    parameters, and its ``shard("tp8")`` predict."""
    pytest.importorskip("jax")
    import jax
    from analytics_zoo_tpu.inference import InferenceModel
    from analytics_zoo_tpu.keras import Sequential
    from analytics_zoo_tpu.keras.layers import Dense
    m = Sequential()
    m.add(Dense(32, input_shape=(16,), activation="relu", name="fc1"))
    m.add(Dense(8, name="fc2"))
    im = InferenceModel().load_zoo(m)
    params = jax.device_get(im._params["params"])
    x = np.random.RandomState(3).randn(5, 16).astype(np.float32)
    plain = np.asarray(im.predict(x))
    im.shard("tp8", param_rules=RULES)
    return {"params": params, "x": x, "plain": plain,
            "sharded": np.asarray(im.predict(x)),
            "n_shards": im.shard_info()["n_shards"]}


@pytest.fixture(scope="module")
def ranks(jax_side):
    rng = np.random.RandomState(0)
    ids = rng.randint(0, BERT["vocab"], (4, 12))
    xn = np.stack([rng.randint(1, NCF["user_count"], 16),
                   rng.randint(1, NCF["item_count"], 16)], 1)
    params = _lists(jax_side["params"])
    cases = [dict(name="exec", fn="executable", params=params,
                  x=jax_side["x"].tolist()),
             dict(name="im", fn="inference_model", params=params,
                  x=jax_side["x"].tolist()),
             dict(name="reshard", fn="reshard", params=params,
                  x=jax_side["x"].tolist()),
             dict(name="bert", fn="bert_tp", config=BERT, seq=12,
                  ids=ids.tolist()),
             dict(name="ncf", fn="ncf_tp", ncf=NCF, x=xn.tolist()),
             dict(name="gen", fn="generate", steps=STEPS)]
    return launch(f"{WORKERS}:serve_group", 2, args=(cases,), timeout=600)


# ------------------------------------------------- ShardedExecutable

def test_sharded_dispatch_matches_unsharded(ranks, jax_side):
    got = ranks[0]["exec"]
    assert got["n_shards"] == 2
    assert got["err"] <= 1e-5
    # each rank computes on its column block of every kernel
    for r in ranks:
        assert r["exec"]["shapes"] == {"fc1.weight": [16, 16],
                                       "fc1.bias": [32],
                                       "fc2.weight": [4, 32],
                                       "fc2.bias": [8]}
    # JAX's sharded predict agrees with JAX's unsharded one
    np.testing.assert_allclose(jax_side["sharded"], jax_side["plain"],
                               rtol=1e-5, atol=1e-5)


def test_sharded_fn_matches_unsharded(ranks, jax_side):
    """JAX's form, ``ShardedExecutable(lambda p, x: ..., params, "tp2")``:
    the kernels are held as column blocks and gathered for the forward."""
    got = ranks[0]["exec"]["fn"]
    assert got["err"] <= 1e-5
    assert got["gathered"] == ["fc1.kernel", "fc2.kernel"]
    assert max(got["hbm"].values()) < got["total"]
    for r in ranks:
        assert r["exec"]["fn"]["shapes"] == {"fc1.kernel": [16, 16],
                                             "fc1.bias": [32],
                                             "fc2.kernel": [32, 4],
                                             "fc2.bias": [8]}
    assert ranks[1]["exec"]["fn"]["served"] == 1


def test_shard_hbm_proves_no_rank_holds_whole_model(ranks):
    got = ranks[0]["exec"]
    hbm, total = got["hbm"], got["total"]
    assert sorted(hbm) == ["0", "1"] and total > 0
    assert max(hbm.values()) < total
    assert sum(hbm.values()) >= total
    assert got["gauge"] == ["shard=0", "shard=1"]


def test_replicated_params_without_rules(ranks):
    rep = ranks[0]["exec"]["replicated"]
    assert max(rep["hbm"].values()) == rep["total"]
    assert min(rep["hbm"].values()) == rep["total"]


def test_warm_rungs_dispatch_without_recompile(ranks):
    got = ranks[0]["exec"]
    assert got["warm_outs"] == [[2, 8], [4, 8], [8, 8]]
    assert got["new_misses"] == 0
    # the follower: one miss a shape it ever saw (5 rows, then the three
    # warmed rungs), none after the warm-up
    assert ranks[1]["exec"]["new_misses"] == 4
    assert ranks[1]["exec"]["served"] == 7
    assert got["batch_spec"] == ["data", None]


# --------------------------------------------- InferenceModel seam

def test_inference_model_shard_matches_unsharded(ranks, jax_side):
    got = ranks[0]["im"]
    info = got["info"]
    assert info["n_shards"] == 2 and info["strategy"] == "dp,tp2"
    assert max(info["shard_hbm_bytes"].values()) < info["total_param_bytes"]
    np.testing.assert_allclose(got["pred"], got["plain"], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(got["pred"], jax_side["sharded"], rtol=0,
                               atol=1e-5)


def test_sharded_warm_ladder_dispatches_recompile_flat(ranks):
    got = ranks[0]["im"]
    assert got["shapes"] == [[n, 8] for n in (2, 3, 4, 5, 8)]
    assert got["new_misses"] == 0
    # the follower saw the first predict's 5 rows and the ladder's three
    # rungs, each once; unshard released it and dropped its sharding
    assert ranks[1]["im"]["new_misses"] == 4
    assert not any(r["im"]["sharded_after"] for r in ranks)


def test_shard_again_needs_the_whole_model(ranks):
    """A second ``shard`` on a sharded model raises on every rank (it
    would cut the blocks again); after ``unshard`` rank 0 holds the whole
    parameters, the follower no model, and a new shard from the whole
    parameters holds half of each kernel, not a quarter."""
    for r in ranks:
        got = r["reshard"]
        assert "unshard" in got["again"]
        assert got["shapes"] == {"fc1.weight": [16, 16], "fc1.bias": [32],
                                 "fc2.weight": [4, 32], "fc2.bias": [8]}
    lead = ranks[0]["reshard"]
    assert lead["whole"] == {"fc1.weight": [32, 16], "fc1.bias": [32],
                             "fc2.weight": [8, 32], "fc2.bias": [8]}
    assert lead["after"] == "predicted"
    assert ranks[1]["reshard"]["after"] == "no model loaded"
    assert lead["first"]["err"] <= 1e-5 and lead["second"]["err"] <= 1e-5


def test_bert_tp_serving(ranks):
    got = ranks[0]["bert"]
    assert got["err"] <= 1e-5
    assert got["gathered"] == []
    assert got["info"]["n_shards"] == 2
    for r in ranks:
        # 2 of the 4 heads a rank
        assert all(v == [32, 64] for v in r["bert"]["query"].values())


def test_ncf_tp_serving(ranks):
    got = ranks[0]["ncf"]
    assert got["err"] <= 1e-5
    assert {"mlp_user_embed.embedding", "mlp_item_embed.embedding",
            "mf_user_embed.embedding",
            "mf_item_embed.embedding"} <= set(got["covered"])
    assert ranks[1]["ncf"]["tables"]["mlp_user_embed.embedding"] == [
        NCF["user_count"] + 1, NCF["user_embed"] // 2]


# ------------------------------------------------------ fleet merge

def test_fleet_merge_does_not_sum_shard_gauges():
    a = {"zoo_shard_hbm_bytes": {"shard=0": 100.0, "shard=1": 80.0},
         "zoo_serving_requests_total": 5.0}
    b = {"zoo_shard_hbm_bytes": {"shard=0": 100.0, "shard=1": 90.0},
         "zoo_serving_requests_total": 7.0}
    merged = telemetry.MetricsRegistry.merge_snapshot(a, b)
    assert merged["zoo_shard_hbm_bytes"]["shard=0"] == 100.0
    assert merged["zoo_shard_hbm_bytes"]["shard=1"] == 90.0
    assert merged["zoo_serving_requests_total"] == 12.0
    assert telemetry.MetricsRegistry.merge_snapshot(
        {"zoo_kv_cache_rung": 16.0},
        {"zoo_kv_cache_rung": 8.0})["zoo_kv_cache_rung"] == 16.0


# -------------------------------------------------- end-to-end flow

def test_serving_generate_end_to_end(ranks):
    got = ranks[0]["gen"]
    assert got["res"] is not None
    res = np.asarray(got["res"])
    assert res.shape == (STEPS, 2)
    np.testing.assert_allclose(res, np.asarray(got["ref"]), rtol=1e-5,
                               atol=1e-5)
    assert got["plain_shape"] == [4, 2]
    assert got["spans"] >= STEPS
    for block in (got["sharding"], got["metrics_sharding"]):
        assert block["n_shards"] == 2
        assert block["shard_hbm_bytes"]
    # the follower ran prefill and every decode step
    assert ranks[1]["gen"]["served"] >= STEPS


def test_shard_without_ranks_raises():
    """One process is one rank: a strategy needing two raises naming the
    ranks, as the estimator does."""
    import torch
    from analytics_zoo_tpu_torch.inference import InferenceModel
    im = InferenceModel(device="cpu").load_torch(
        torch.nn.Linear(4, 4), np.zeros((1, 4), np.float32))
    with pytest.raises(ValueError, match="ranks"):
        im.shard("tp2", param_rules=RULES)
    assert im.shard_info() is None
