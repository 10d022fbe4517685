"""The port's tensor-parallel models across ranks against the JAX
package's 8-device runs, on the CPU.

Where ``tests/test_torch_multirank.py`` holds the strategies on JAX's
multihost MLP, this file holds the paths that compute on a rank's block
of a real model (``parallel/tensor_parallel.py``): BERT's Megatron pairs
in attention and the FFN (column-parallel query, key, value and
intermediate; row-parallel out and output) and NeuralCF's column-split
tables (looked up on their ``[rows, d/tp]`` blocks, the features
gathered) and column-parallel Dense layers.

JAX runs in this process on its 8 virtual CPU devices: BERTClassifier
under "dp,tp2" (JAX ``tests/test_text_bert.py``'s
``test_tensor_parallel_bert``, hidden 64, 2 blocks, 4 heads) and
NeuralCF (64 users x 32 items) under "tp2" and "dp2,tp2" with
``NeuralCF.tp_param_rules()``. The port's ranks are gloo processes
(``parallel/launch.py``, ``tests/torch_multirank_workers.py``, no JAX)
that start from JAX's initial parameters (each rank its block,
``convert.flax_to_shard_state_dict`` / ``flax_to_state_dict``): one
group of 2 ranks ("dp,tp2" BERT, "tp2" NCF) and one of 4 ("dp2,tp2"
NCF), each launched once for the module. Every rank feeds its block of
each global batch. Held: the loss history within JAX's own
``atol=2e-4`` and every parameter within 1e-5 of JAX's after the fit,
the same history on every rank, and the blocks each rank computes on.
"""

import os

import numpy as np
import pytest

from analytics_zoo_tpu_torch.parallel.launch import launch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKERS = os.path.join(REPO, "tests", "torch_multirank_workers.py")
BERT_CFG = dict(vocab=100, hidden_size=64, n_block=2, n_head=4,
                intermediate_size=128, max_position_len=32,
                hidden_drop=0.0, attn_drop=0.0)
BERT_OPT = ["sgd", 0.01]
NCF_ARGS = dict(user_count=64, item_count=32, class_num=5, user_embed=8,
                item_embed=8, hidden_layers=[16, 8], include_mf=True,
                mf_embed=8)
NCF_OPT = ["sgd", 0.5]
EPOCHS = 2
BERT_BATCH, NCF_BATCH = 16, 64


def _bert_data():
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 100, (32, 12)).astype(np.int32)
    return ids, (ids[:, 0] % 2).astype(np.int32)


def _ncf_data():
    rng = np.random.RandomState(1)
    x = np.stack([rng.randint(1, 65, 256), rng.randint(1, 33, 256)],
                 1).astype(np.float32)
    return x, ((x[:, 0] + x[:, 1]) % 5).astype(np.int32)


def _tolist(tree):
    return {k: _tolist(v) if isinstance(v, dict) else np.asarray(v).tolist()
            for k, v in tree.items()}


@pytest.fixture(scope="module")
def jax_runs():
    """JAX's fits on its 8 virtual devices: initial and final parameters
    and the loss history of each."""
    pytest.importorskip("jax")
    import jax
    from analytics_zoo_tpu.common import context as jctx
    from analytics_zoo_tpu.learn import optimizers as jopt
    from analytics_zoo_tpu.models.recommendation import NeuralCF
    from analytics_zoo_tpu.parallel import mesh as jmesh
    from analytics_zoo_tpu.text import BERTClassifier, BertConfig

    def opt(spec):
        return {"sgd": jopt.SGD, "adam": jopt.Adam}[spec[0]](spec[1])

    out = {}
    jctx.stop_orca_context()
    jctx.init_orca_context(cluster_mode="local")
    try:
        ids, labels = _bert_data()
        clf = BERTClassifier(2, config=BertConfig(**BERT_CFG), seq_len=12,
                             optimizer=opt(BERT_OPT), strategy="dp,tp2")
        init = jax.device_get(clf.estimator.adapter.params)
        hist = clf.fit(ids, labels, epochs=EPOCHS, batch_size=BERT_BATCH,
                       shuffle=False)
        out["bert"] = {"init": init, "loss": hist["loss"],
                       "params": jax.device_get(
                           clf.estimator._state["params"])}
    finally:
        jctx.stop_orca_context()
    x, y = _ncf_data()
    for strategy in ("tp2", "dp2,tp2"):
        jctx.init_orca_context(cluster_mode="local")
        try:
            if strategy == "dp2,tp2":
                # the layout's own 4 of the 8 devices
                jmesh.build_mesh(axes=("data", "model"), shape=(2, 2),
                                 devices=jax.devices()[:4])
            ncf = NeuralCF(**NCF_ARGS)
            ncf.model.set_strategy(strategy,
                                   param_rules=NeuralCF.tp_param_rules())
            ncf.model.compile(optimizer=opt(NCF_OPT),
                              loss="sparse_categorical_crossentropy")
            init = jax.device_get(ncf.model.get_weights())
            hist = ncf.model.fit(x, y, batch_size=NCF_BATCH,
                                 nb_epoch=EPOCHS, shuffle=False)
            assert "model" in ncf.model._estimator._mesh.axis_names
            out[strategy] = {"init": init, "loss": hist["loss"],
                             "params": jax.device_get(
                                 ncf.model.get_weights())}
        finally:
            jctx.stop_orca_context()
    return out


@pytest.fixture(scope="module")
def ranks(jax_runs):
    """Each rank group launched once; every rank's results."""
    ids, labels = _bert_data()
    x, y = _ncf_data()

    def ncf(strategy):
        return {"name": f"ncf {strategy}", "fn": "ncf_from_jax",
                "strategy": strategy, "args": NCF_ARGS, "opt": NCF_OPT,
                "epochs": EPOCHS, "batch": NCF_BATCH, "x": x.tolist(),
                "y": y.tolist(),
                "params": _tolist(jax_runs[strategy]["init"])}

    two = [{"name": "bert", "fn": "bert_from_jax", "strategy": "dp,tp2",
            "config": BERT_CFG, "opt": BERT_OPT, "epochs": EPOCHS,
            "batch": BERT_BATCH, "ids": ids.tolist(),
            "labels": labels.tolist(),
            "params": _tolist(jax_runs["bert"]["init"])},
           ncf("tp2")]
    return {2: launch(f"{WORKERS}:fit_group", 2, args=(two,)),
            4: launch(f"{WORKERS}:fit_group", 4, args=([ncf("dp2,tp2")],))}


def _check(results, name, want):
    """Every rank's history is the global one; the history and every
    parameter are JAX's."""
    from analytics_zoo_tpu_torch.convert import flax_to_state_dict
    first = results[0][name]
    for r in results:
        assert r[name]["loss"] == first["loss"]
    np.testing.assert_allclose(first["loss"], want["loss"], rtol=0,
                               atol=2e-4)
    whole = flax_to_state_dict(want["params"])
    assert set(first["params"]) == set(whole)
    for k, v in whole.items():
        np.testing.assert_allclose(np.asarray(first["params"][k]),
                                   v.numpy(), rtol=0, atol=1e-5, err_msg=k)
    return first


def test_bert_dp_tp2_matches_jax(ranks, jax_runs):
    """Megatron's layout on 2 of BERT's 4 heads a rank: every projection
    of attention and the FFN a block, nothing gathered whole for its
    product."""
    got = _check(ranks[2], "bert", jax_runs["bert"])
    assert got["loss"][-1] < got["loss"][0]
    assert got["gathered"] == []
    for i in range(BERT_CFG["n_block"]):
        pre = f"bert.block_{i}."
        for proj in ("query", "key", "value"):
            assert got["shards"][pre + f"attention.{proj}.weight"] == \
                [32, 64]
        assert got["shards"][pre + "attention.out.weight"] == [64, 32]
        assert got["shards"][pre + "intermediate.weight"] == [64, 64]
        assert got["shards"][pre + "output.weight"] == [64, 64]


@pytest.mark.parametrize("world, strategy", [(2, "tp2"), (4, "dp2,tp2")])
def test_ncf_tp_matches_jax(ranks, jax_runs, world, strategy):
    """The tables looked up on their column blocks, the Dense layers
    column-parallel (the 5-class head does not divide: replicated)."""
    got = _check(ranks[world], f"ncf {strategy}", jax_runs[strategy])
    assert got["mesh"] == ({"data": 1, "model": 2} if world == 2
                           else {"data": 2, "model": 2})
    assert got["gathered"] == []
    tables = {k: v for k, v in got["shards"].items() if "embed" in k}
    assert len(tables) == 4
    assert all(v[1] == 4 for v in tables.values())
