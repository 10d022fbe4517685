"""The port's attention module, BERT, transformer and task heads against
the JAX package's.

Each JAX module is initialised in flax; its parameters go through
``analytics_zoo_tpu_torch.convert.flax_to_state_dict`` into the port, and
both run on the same numpy inputs on the CPU. fp32 agrees within atol
2e-5 (matmul and softmax sums in another order). bf16 agrees within 0.1
on hidden states and 0.05 on pooled outputs: LayerNorm outputs reach
|x| of about 4, where one bf16 ulp is 0.03, and the two frameworks round
gelu and the matmul epilogues at other points. ``use_flash=True`` runs
``blockwise_attention`` on both sides (the JAX autotuner is off, as it is
off the TPU). Small sizes: 2 blocks, hidden 64, 4 heads.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.ops.attention import AttentionModule as JAttention
from analytics_zoo_tpu.text import estimators as jest
from analytics_zoo_tpu.text.bert import BertConfig as JConfig
from analytics_zoo_tpu.text.bert import BertModule as JBert
from analytics_zoo_tpu.text.bert import TransformerModule as JTransformer
from analytics_zoo_tpu_torch.convert import flax_to_state_dict
from analytics_zoo_tpu_torch.ops import flash_attention as tfa
from analytics_zoo_tpu_torch.ops.attention import AttentionModule
from analytics_zoo_tpu_torch.text import (BertConfig, BertModule,
                                          TransformerModule,
                                          init_bert_weights)
from analytics_zoo_tpu_torch.text import estimators as test_

ATOL = 2e-5
BF16_SEQ, BF16_POOLED = 0.1, 0.05
SMALL = dict(vocab=100, hidden_size=64, n_block=2, n_head=4,
             intermediate_size=128, max_position_len=64)


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


def _batch(b=3, length=40, seed=0, vocab=100):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, (b, length)).astype(np.int32)
    seg = (rng.rand(b, length) < 0.5).astype(np.int32)
    mask = np.ones((b, length), np.int32)
    mask[0, length - 7:] = 0
    mask[1, length - 2:] = 0
    return ids, seg, mask


def _port(jmodule, module, *args):
    """(variables of the JAX module, the port module holding them)."""
    variables = jmodule.init(jax.random.PRNGKey(0), *args)
    module.load_state_dict(
        flax_to_state_dict(jax.device_get(variables["params"])))
    return variables, module.eval()


def _np(x):
    return np.asarray(x, np.float32)


def _torch_out(x):
    return x.float().numpy()


# ---------------------------------------------------------------- attention

@pytest.mark.parametrize("use_flash", [True, None, False])
@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("with_mask", [False, True])
def test_attention_module_matches_jax(use_flash, packed, with_mask):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 24, 64).astype(np.float32)
    kv = x if packed else rng.randn(2, 16, 48).astype(np.float32)
    mask = None
    if with_mask:
        mask = np.ones((2, 1, 1, kv.shape[1]), np.int32)
        mask[0, ..., -5:] = 0
    jm = JAttention(num_heads=4, head_dim=16, use_flash=use_flash)
    kv_arg = None if packed else jnp.asarray(kv)
    j_mask = None if mask is None else jnp.asarray(mask)
    variables, tm = _port(
        jm, AttentionModule(num_heads=4, head_dim=16, q_features=64,
                            kv_features=kv.shape[-1], use_flash=use_flash),
        jnp.asarray(x), kv_arg, j_mask)
    want = jm.apply(variables, jnp.asarray(x), kv_arg, mask=j_mask)
    tx = torch.from_numpy(x)
    with torch.no_grad():
        got = tm(tx, None if packed else torch.from_numpy(kv),
                 mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(_torch_out(got), _np(want), atol=ATOL)


def test_packed_path_feeds_strided_views(monkeypatch):
    # the packed projection's q, k, v are views of one [.., 3, h, d]
    # tensor; the flash wrapper takes them without a copy
    seen = {}
    orig = tfa.blockwise_attention

    def spy(q, k, v, causal=False):
        seen["strides"] = (q.stride(), q.is_contiguous())
        return orig(q, k, v, causal=causal)

    monkeypatch.setattr(tfa, "blockwise_attention", spy)
    m = AttentionModule(num_heads=4, head_dim=16, q_features=64,
                        use_flash=True)
    with torch.no_grad():
        m(torch.randn(2, 10, 64))
    assert seen["strides"] == ((10 * 3 * 64, 3 * 64, 16, 1), False)


# --------------------------------------------------------------------- BERT

@pytest.mark.parametrize("use_flash", [True, None, False])
@pytest.mark.parametrize("with_mask", [False, True])
def test_bert_module_matches_jax(use_flash, with_mask):
    ids, seg, mask = _batch()
    mask = mask if with_mask else None
    variables, tm = _port(JBert(JConfig(use_flash=use_flash, **SMALL)),
                          BertModule(BertConfig(use_flash=use_flash,
                                                **SMALL)),
                          ids, seg, mask)
    j_seq, j_pooled = JBert(JConfig(use_flash=use_flash, **SMALL)).apply(
        variables, ids, seg, mask)
    with torch.no_grad():
        seq, pooled = tm(torch.from_numpy(ids), torch.from_numpy(seg),
                         None if mask is None else torch.from_numpy(mask))
    assert seq.shape == (3, 40, 64) and pooled.shape == (3, 64)
    np.testing.assert_allclose(_torch_out(seq), _np(j_seq), atol=ATOL)
    np.testing.assert_allclose(_torch_out(pooled), _np(j_pooled), atol=ATOL)


@pytest.mark.parametrize("use_flash", [True, False])
def test_bert_module_bf16_matches_jax(use_flash):
    ids, seg, _ = _batch(seed=2)
    variables, tm = _port(
        JBert(JConfig(dtype=jnp.bfloat16, use_flash=use_flash, **SMALL)),
        BertModule(BertConfig(dtype=torch.bfloat16, use_flash=use_flash,
                              **SMALL)), ids, seg)
    j_seq, j_pooled = JBert(JConfig(dtype=jnp.bfloat16, use_flash=use_flash,
                                    **SMALL)).apply(variables, ids, seg)
    with torch.no_grad():
        seq, pooled = tm(torch.from_numpy(ids), torch.from_numpy(seg))
    # parameters stay fp32, the compute dtype reaches every block
    assert seq.dtype == pooled.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    np.testing.assert_allclose(_torch_out(seq), _np(j_seq), atol=BF16_SEQ)
    np.testing.assert_allclose(_torch_out(pooled), _np(j_pooled),
                               atol=BF16_POOLED)


def test_bert_param_names_match_flax_tree():
    ids, seg, _ = _batch()
    variables = JBert(JConfig(**SMALL)).init(jax.random.PRNGKey(0), ids, seg)
    want = set(flax_to_state_dict(jax.device_get(variables["params"])))
    got = set(BertModule(BertConfig(**SMALL)).state_dict())
    assert got == want
    assert {"word_embeddings.embedding", "block_1.attention.query.weight",
            "block_0.attn_norm.weight", "pooler.bias"} <= got


def test_padding_mask_blocks_attention():
    """Changing a masked-out token changes no unmasked position."""
    ids, seg, mask = _batch(b=2, length=12)
    mask[:] = 1
    mask[:, 9:] = 0
    m = init_bert_weights(BertModule(BertConfig(**SMALL)), seed=3).eval()
    ids2 = ids.copy()
    ids2[:, -1] = (ids2[:, -1] + 1) % 100
    with torch.no_grad():
        a, _ = m(torch.from_numpy(ids), torch.from_numpy(seg),
                 torch.from_numpy(mask))
        b, _ = m(torch.from_numpy(ids2), torch.from_numpy(seg),
                 torch.from_numpy(mask))
    torch.testing.assert_close(a[:, :9], b[:, :9], rtol=0, atol=1e-5)


def test_sequence_longer_than_positions_raises():
    m = BertModule(BertConfig(**SMALL))       # max_position_len=64
    with pytest.raises(ValueError, match="max_position_len"):
        m(torch.zeros((2, 65), dtype=torch.int32))


def test_token_ids_out_of_range_give_nan_rows_not_faults():
    # jnp.take's rule: no read outside the table, NaN rows instead
    m = init_bert_weights(BertModule(BertConfig(**SMALL)), seed=4).eval()
    ids = torch.zeros((1, 8), dtype=torch.int32)
    ids[0, 3] = 100                              # vocab is 100
    with torch.no_grad():
        seq, _ = m(ids)
    assert torch.isnan(seq[0, 3]).all()


# -------------------------------------------------------------- transformer

def test_transformer_module_matches_jax():
    ids, _, _ = _batch(b=2, length=20, seed=5, vocab=50)
    kw = dict(vocab=50, hidden_size=64, n_block=2, n_head=4,
              max_position_len=32)
    variables, tm = _port(JTransformer(**kw), TransformerModule(**kw), ids)
    want = JTransformer(**kw).apply(variables, ids)
    with torch.no_grad():
        got = tm(torch.from_numpy(ids))
    np.testing.assert_allclose(_torch_out(got), _np(want), atol=ATOL)


def test_transformer_causality():
    """Mutating a future token changes no past position."""
    rng = np.random.RandomState(1)
    ids = torch.from_numpy(rng.randint(1, 50, (4, 10)).astype(np.int32))
    m = init_bert_weights(TransformerModule(
        vocab=50, hidden_size=16, n_block=2, n_head=2, hidden_drop=0.0,
        max_position_len=16), seed=6).eval()
    ids2 = ids.clone()
    ids2[:, -1] = ids2[:, -1] % 49 + 1
    with torch.no_grad():
        a, b = m(ids), m(ids2)
    torch.testing.assert_close(a[:, :-1], b[:, :-1], rtol=0, atol=1e-5)
    assert float((a[:, -1] - b[:, -1]).abs().max()) > 1e-4


# -------------------------------------------------------------------- heads

@pytest.mark.parametrize("head", ["classifier", "ner", "squad"])
def test_heads_match_jax(head):
    ids, seg, mask = _batch(seed=7)
    cfg = dict(use_flash=True, **SMALL)
    jm = {"classifier": lambda: jest._ClassifierModule(JConfig(**cfg), 3),
          "ner": lambda: jest._NERModule(JConfig(**cfg), 5),
          "squad": lambda: jest._SQuADModule(JConfig(**cfg))}[head]()
    tm = {"classifier": lambda: test_._ClassifierModule(BertConfig(**cfg), 3),
          "ner": lambda: test_._NERModule(BertConfig(**cfg), 5),
          "squad": lambda: test_._SQuADModule(BertConfig(**cfg))}[head]()
    variables, tm = _port(jm, tm, ids, seg, mask)
    want = jm.apply(variables, ids, seg, mask)
    with torch.no_grad():
        got = tm(torch.from_numpy(ids), torch.from_numpy(seg),
                 torch.from_numpy(mask))
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(np.shape(w))
        np.testing.assert_allclose(_torch_out(g), _np(w), atol=ATOL)
