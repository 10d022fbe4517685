"""The BERT serving slice as a whole, on the CPU, against the JAX package.

- The classifier (``_ClassifierModule``, 2 classes, ``use_flash=True``,
  inputs ``input_ids`` and ``token_type_ids`` with no mask) through the
  JAX ``InferenceModel.load_flax`` and the port's
  ``InferenceModel(device="cpu").load_torch`` on the same parameters:
  logits within atol 2e-5 (fp32 sums in another order), over a ragged
  batch that crosses a ladder rung.
- ``ClusterServing`` answering int32 two-input records: each answer
  equals the direct predict within 1e-6 (a batch padded otherwise).
- The keras ``BERT`` layer inside a ``Model`` through ``load_zoo``
  against its JAX counterpart, within atol 2e-5; under the
  ``mixed_bfloat16`` policy the compute dtype reaches the BERT layers.

Small sizes: 2 blocks, hidden 64, 4 heads, sequences of 32.
"""

import flax.linen as fnn
import jax
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.inference import InferenceModel as JInferenceModel
from analytics_zoo_tpu.keras import Input as JInput, Model as JModel
from analytics_zoo_tpu.keras import layers as jl
from analytics_zoo_tpu.text import estimators as jest
from analytics_zoo_tpu.text.bert import BertConfig as JConfig
from analytics_zoo_tpu_torch.convert import flax_to_state_dict
from analytics_zoo_tpu_torch.inference import InferenceModel
from analytics_zoo_tpu_torch.keras import Input, Model
from analytics_zoo_tpu_torch.keras import layers as tl
from analytics_zoo_tpu_torch.serving import (Broker, ClusterServing,
                                             InputQueue, OutputQueue)
from analytics_zoo_tpu_torch.text import BertConfig
from analytics_zoo_tpu_torch.text import estimators as test_

ATOL = 2e-5
SMALL = dict(vocab=100, hidden_size=64, n_block=2, n_head=4,
             intermediate_size=128, max_position_len=64)
LENGTH = 32


@pytest.fixture(autouse=True)
def _one_torch_thread():
    # small shapes: one intra-op thread, so parallel test workers do not
    # oversubscribe the host's cores
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _no_autotune(monkeypatch, tmp_path):
    monkeypatch.setenv("ZOO_AUTOTUNE", "off")
    monkeypatch.setenv("ZOO_AUTOTUNE_CACHE",
                       str(tmp_path / "autotune.json"))


class _TwoInputClassifier(fnn.Module):
    """The JAX classifier fed ``(input_ids, token_type_ids)`` and no
    mask, the slice's inputs (its own ``__call__`` takes the mask
    positionally)."""

    config: JConfig
    n_classes: int

    @fnn.compact
    def __call__(self, input_ids, token_type_ids):
        return jest._ClassifierModule(self.config, self.n_classes,
                                      name="clf")(input_ids, token_type_ids,
                                                  None)


def _records(n, seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, SMALL["vocab"], (n, LENGTH)).astype(np.int32)
    seg = (np.arange(LENGTH)[None] >= rng.randint(4, LENGTH, (n, 1))
           ).astype(np.int32)
    return ids, seg


@pytest.fixture(scope="module")
def pair():
    """(JAX InferenceModel, port InferenceModel) on the same weights."""
    ids, seg = _records(2)
    jim = JInferenceModel().load_flax(
        _TwoInputClassifier(JConfig(use_flash=True, **SMALL), 2), (ids, seg))
    params = jax.device_get(jim._params["params"])["params"]["clf"]
    module = test_._ClassifierModule(BertConfig(use_flash=True, **SMALL), 2)
    module.load_state_dict(flax_to_state_dict(params))
    return jim, InferenceModel(device="cpu").load_torch(module, (ids, seg))


def test_classifier_predict_matches_jax(pair):
    jim, im = pair
    ids, seg = _records(11, seed=1)
    want = np.asarray(jim.predict((ids, seg), batch_size=4))
    got = im.predict((ids, seg), batch_size=4)
    assert got.shape == (11, 2) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_ragged_batch_across_a_ladder_rung(pair):
    jim, im = pair
    ids, seg = _records(13, seed=2)
    want = np.asarray(jim.predict((ids, seg), batch_size=13))
    im.set_ladder(4, 8)
    try:
        # 13 rows: a chunk of 8, then 5 padded to the rung of 8
        got = im.predict((ids, seg))
        np.testing.assert_allclose(got, want, atol=ATOL)
        np.testing.assert_allclose(im.predict((ids[:3], seg[:3])), want[:3],
                                   atol=ATOL)
    finally:
        im.set_ladder(8)


def test_load_torch_holds_a_copy():
    module = test_._ClassifierModule(BertConfig(**SMALL), 2)
    ids, seg = _records(3, seed=3)
    im = InferenceModel(device="cpu").load_torch(module, (ids, seg))
    before = im.predict((ids, seg))
    with torch.no_grad():
        module.classifier.bias.add_(1.0)
    np.testing.assert_array_equal(im.predict((ids, seg)), before)
    with pytest.raises(ValueError, match="takes 2 inputs"):
        im.predict((ids, seg, seg))


def test_cluster_serving_answers_int32_records(pair):
    _, im = pair
    ids, seg = _records(10, seed=4)
    want = im.predict((ids, seg), batch_size=4)
    with Broker.launch(backend="python") as broker, \
            ClusterServing(im, broker.port, batch_size=4) as serving:
        iq = InputQueue(port=broker.port)
        oq = OutputQueue(port=broker.port)
        try:
            uris = iq.enqueue_batch(
                (f"r{i}", {"input_ids": ids[i], "token_type_ids": seg[i]})
                for i in range(8))
            got = oq.query_many(uris, timeout=120, poll_interval=0.005)
            for i in (8, 9):
                uri = iq.enqueue(f"s{i}", input_ids=ids[i],
                                 token_type_ids=seg[i])
                got[uri] = oq.query(uri, timeout=60, poll_interval=0.005)
        finally:
            iq.close()
            oq.close()
        assert serving.metrics()["records_out"] == 10
    for i in range(10):
        uri = f"r{i}" if i < 8 else f"s{i}"
        assert got[uri].shape == (2,)
        np.testing.assert_allclose(got[uri], want[i], atol=1e-6)


def _keras_bert(L, I, M):
    ids, seg = I(shape=(LENGTH,)), I(shape=(LENGTH,))
    pooled = L.BERT(hidden_drop=0.0, attn_drop=0.0, **SMALL)([ids, seg])
    return M(input=[ids, seg], output=L.Dense(2)(pooled))


def test_keras_bert_layer_through_load_zoo_matches_jax():
    ids, seg = _records(5, seed=5)
    jmodel = _keras_bert(jl, JInput, JModel)
    jim = JInferenceModel().load_zoo(jmodel)
    want = np.asarray(jim.predict((ids.astype(np.float32),
                                   seg.astype(np.float32))))
    port = _keras_bert(tl, Input, Model)
    port.module.load_state_dict(flax_to_state_dict(
        jax.device_get(jim._params["params"])))
    got = InferenceModel(device="cpu").load_zoo(port).predict(
        (ids.astype(np.float32), seg.astype(np.float32)))
    assert set(port.module.state_dict()) >= {
        "bert_1.word_embeddings.embedding", "dense_1.weight"}
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_keras_attention_and_norm_layers_match_jax():
    rng = np.random.RandomState(6)
    x = rng.randn(3, 12, 32).astype(np.float32)

    def build(L, I, M):
        inp = I(shape=(12, 32))
        h = L.MultiHeadAttention(num_heads=4, head_dim=8)([inp, inp])
        return M(input=inp, output=L.LayerNormalization()(h))

    jm = build(jl, JInput, JModel).to_flax()
    variables = jm.init(jax.random.PRNGKey(0), x)
    want = np.asarray(jm.apply(variables, x))
    port = build(tl, Input, Model)
    port.module.load_state_dict(flax_to_state_dict(
        jax.device_get(variables["params"])))
    np.testing.assert_allclose(port.predict(x, device="cpu"), want,
                               atol=ATOL)


def test_keras_transformer_layer_matches_jax():
    ids = np.random.RandomState(7).randint(1, 50, (2, 10)).astype(np.float32)

    def build(L, I, M):
        inp = I(shape=(10,))
        return M(input=inp, output=L.TransformerLayer(
            vocab=50, hidden_size=16, n_block=1, n_head=2, seq_len=16,
            hidden_drop=0.0)(inp))

    jm = build(jl, JInput, JModel).to_flax()
    variables = jm.init(jax.random.PRNGKey(0), ids)
    want = np.asarray(jm.apply(variables, ids))
    port = build(tl, Input, Model)
    port.module.load_state_dict(flax_to_state_dict(
        jax.device_get(variables["params"])))
    got = port.predict(ids, device="cpu")
    assert got.shape == (2, 10, 16)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_bf16_policy_reaches_the_bert_layers():
    # mixed_bfloat16: the keras BERT, attention and norm layers compute in
    # bf16 with fp32 parameters, as in JAX (bf16 tolerance: 0.05, one or
    # two bf16 ulps of pooled values in [-1, 1] after 2 blocks)
    from analytics_zoo_tpu.keras import policy as jpolicy
    from analytics_zoo_tpu_torch.keras import policy

    ids, seg = _records(3, seed=8)
    x = (ids.astype(np.float32), seg.astype(np.float32))

    def build(L, I, M):
        i1, i2 = I(shape=(LENGTH,)), I(shape=(LENGTH,))
        pooled = L.BERT(hidden_drop=0.0, attn_drop=0.0, **SMALL)([i1, i2])
        return M(input=[i1, i2], output=L.LayerNormalization()(pooled))

    with jpolicy.policy_scope("mixed_bfloat16"):
        jm = build(jl, JInput, JModel).to_flax()
    variables = jm.init(jax.random.PRNGKey(0), *x)
    want = np.asarray(jm.apply(variables, *x), np.float32)
    with policy.policy_scope("mixed_bfloat16"):
        port = build(tl, Input, Model)
    port.module.load_state_dict(flax_to_state_dict(
        jax.device_get(variables["params"])))
    assert port.module.bert_1.config.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in port.module.parameters())
    with torch.no_grad():
        out = port.module(*(torch.from_numpy(a) for a in x))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), want, atol=0.05)
