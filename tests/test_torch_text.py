"""The port's text pipeline and text layers against the JAX package's, on
the CPU.

- ``feature/text``: ``TextSet`` from texts, folders and csv files through
  tokenize, normalize, ``word2idx`` (each option), ``shape_sequence``
  (both truncation modes), ``generate_sample`` and ``to_dataset``;
  ``Relations.read`` / ``read_parquet``; the relation pairs and lists
  of QA ranking; ``load_glove``. Held bitwise: the same texts give the
  same vocabulary, the same ids and the same samples in both packages
  (JAX's host code, copied).
- ``Narrow``, ``WordEmbedding`` (frozen, 1-based ids, trainable,
  ``from_glove``) and ``Bidirectional`` (LSTM and GRU, every merge mode,
  with and without ``return_sequences``, ``mixed_bfloat16`` in
  tests/test_torch_recurrent_bf16.py): each built in both packages from
  the same parameters (``convert.flax_to_state_dict``), forward on the
  same inputs. Lookups and slices bitwise; ``Bidirectional`` within 1e-5
  (fp32, outputs of order 1: the port's GRU runs a side's gates as one
  product). The flax trees match leaf for leaf (``convert.flax_layout``),
  and a frozen table has no leaf, no gradient and no optimizer state.
JAX is imported by fixtures only.
"""

import importlib.util

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch import convert
from analytics_zoo_tpu_torch.feature.text import (Relation, Relations,
                                                  load_glove)
from analytics_zoo_tpu_torch.keras import Input, Model
from analytics_zoo_tpu_torch.keras import layers as tl

TEXTS = [
    "The quick brown fox jumps over the lazy dog",
    "A quick movie about a lazy dog",
    "the worst movie ever made, truly awful",
    "an awful film about an awful dog",
    "Don't stop: it's 3 o'clock, the dog's dinner!",
]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _logs_in_tmp(monkeypatch, tmp_path):
    from analytics_zoo_tpu_torch.learn import estimator
    monkeypatch.setattr(estimator, "DEFAULT_LOG_DIR", str(tmp_path))


@pytest.fixture(scope="module")
def jt():
    pytest.importorskip("jax")
    import jax
    from analytics_zoo_tpu.feature.text import textset
    from analytics_zoo_tpu.keras import Input as JInput
    from analytics_zoo_tpu.keras import Model as JModel
    from analytics_zoo_tpu.keras import layers as jl
    return dict(jax=jax, text=textset, Input=JInput, Model=JModel,
                layers=jl)


def _features(ts):
    return [dict(f) for f in ts._features()]


def _same_features(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            if k == "sample":
                assert g[k].keys() == w[k].keys()
                for sk in g[k]:
                    np.testing.assert_array_equal(g[k][sk], w[k][sk])
                    assert g[k][sk].dtype == w[k][sk].dtype
            else:
                assert g[k] == w[k], k


# ------------------------------------------------------------- TextSet

def _pipeline(mod, texts, w2i, length, mode, labels=None):
    ts = mod.TextSet.from_texts(texts, labels=labels, num_shards=2)
    ts = ts.tokenize().normalize().word2idx(**w2i)
    return ts.shape_sequence(length, mode).generate_sample()


@pytest.mark.parametrize("w2i,length,mode", [
    ({}, 6, "pre"), ({}, 12, "post"), ({"max_words_num": 5}, 6, "pre"),
    ({"remove_topN": 2}, 6, "post"), ({"min_freq": 2}, 8, "pre"),
    ({"existing_map": {"dog": 1, "awful": 2, "quick": 3}}, 5, "pre")])
def test_textset_pipeline_is_bitwise_jax(jt, w2i, length, mode):
    import analytics_zoo_tpu_torch.feature.text as port
    labels = [0, 0, 1, 1, 0]
    got = _pipeline(port, TEXTS, w2i, length, mode, labels)
    want = _pipeline(jt["text"], TEXTS, w2i, length, mode, labels)
    assert got.get_word_index() == want.get_word_index()
    _same_features(_features(got), _features(want))
    gd, wd = got.to_dataset().collect(), want.to_dataset().collect()
    assert len(gd) == len(wd) == 2
    for g, w in zip(gd, wd):
        np.testing.assert_array_equal(g["x"], w["x"])
        np.testing.assert_array_equal(g["y"], w["y"])
        assert g["x"].dtype == np.int32


def test_textset_read_folder_and_csv_match_jax(jt, tmp_path):
    import analytics_zoo_tpu_torch.feature.text as port
    for cls, txt in (("neg", "bad terrible"), ("pos", "good great"),
                     ("mid", "fine, ok")):
        d = tmp_path / "docs" / cls
        d.mkdir(parents=True)
        (d / "a.txt").write_text(txt)
        (d / "b.txt").write_text(txt + " " + cls)
    got = port.TextSet.read(str(tmp_path / "docs"))
    want = jt["text"].TextSet.read(str(tmp_path / "docs"))
    assert got.get_texts() == want.get_texts()
    assert got.get_labels() == want.get_labels() == [0, 0, 1, 1, 2, 2]
    csv = tmp_path / "q.csv"
    csv.write_text("id,text,label\nq1,what is a tpu,1\nq2,how fast,0\n")
    got = port.TextSet.read_csv(str(csv)).tokenize().word2idx()
    want = jt["text"].TextSet.read_csv(str(csv)).tokenize().word2idx()
    _same_features(_features(got), _features(want))


def test_load_glove_is_bitwise_jax(jt, tmp_path):
    p = tmp_path / "glove.txt"
    rng = np.random.default_rng(0)
    words = ["hello", "world", "dog", "cat"]
    p.write_text("".join(
        w + " " + " ".join(f"{v:.6f}" for v in rng.normal(size=3)) + "\n"
        for w in words) + "short 1.0\n")
    vocab = {"hello": 1, "dog": 2, "unseen": 3}
    got = load_glove(str(p), vocab, dim=3)
    want = jt["text"].load_glove(str(p), vocab, dim=3)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.float32 and not got[0].any()


# ------------------------------------------------------------ relations

def _corpora(mod):
    q = mod.TextSet.from_texts(["what is tpu", "how fast is light"],
                               ids=["q1", "q2"])
    a = mod.TextSet.from_texts(
        ["a tensor processing unit", "a kind of pasta",
         "three hundred thousand km per second", "a type of bird"],
        ids=["a1", "a2", "a3", "a4"])
    q = q.tokenize().normalize().word2idx().shape_sequence(4)
    a = (a.tokenize().normalize()
         .word2idx(existing_map=q.get_word_index()).shape_sequence(6))
    return q, a


RELS = [("q1", "a1", 1), ("q1", "a2", 0), ("q2", "a3", 1), ("q2", "a4", 0),
        ("q2", "a2", 0), ("q1", "a4", 0)]


@pytest.mark.parametrize("join", ["from_relation_pairs",
                                  "from_relation_lists"])
def test_relation_joins_are_bitwise_jax(jt, join):
    import analytics_zoo_tpu_torch.feature.text as port
    got = getattr(port.TextSet, join)(
        [Relation(*r) for r in RELS], *_corpora(port))
    want = getattr(jt["text"].TextSet, join)(
        [jt["text"].Relation(*r) for r in RELS], *_corpora(jt["text"]))
    _same_features(_features(got), _features(want))
    assert got.get_word_index() == want.get_word_index()


def test_relation_errors_match_jax(jt):
    import analytics_zoo_tpu_torch.feature.text as port
    for mod in (port, jt["text"]):
        q, a = _corpora(mod)
        with pytest.raises(KeyError):
            mod.TextSet.from_relation_pairs(
                [("qX", "a1", 1), ("qX", "a2", 0)], q, a)
        bare = mod.TextSet.from_texts(["no ids"]).tokenize().word2idx()
        with pytest.raises(ValueError, match="'id'"):
            mod.TextSet.from_relation_pairs([("q1", "a1", 1)], bare, a)


def test_relations_read_and_parquet(jt, tmp_path):
    p = tmp_path / "rel.csv"
    p.write_text("q1,a1,1\nq1,a2,0\n\nq2,a3,1\n")
    got = Relations.read(str(p))
    want = jt["text"].Relations.read(str(p))
    assert [r.to_tuple() for r in got] == [r.to_tuple() for r in want]
    assert got[0] == Relation("q1", "a1", 1)
    assert repr(got[1]) == repr(want[1])
    import pandas as pd
    pd.DataFrame({"id1": ["q1", "q2"], "id2": ["a2", "a3"],
                  "label": [0, 1]}).to_parquet(tmp_path / "rel.parquet")
    got = Relations.read_parquet(str(tmp_path / "rel.parquet"))
    want = jt["text"].Relations.read_parquet(str(tmp_path / "rel.parquet"))
    assert [r.to_tuple() for r in got] == [r.to_tuple() for r in want]


def test_read_parquet_names_pyarrow_when_missing(monkeypatch, tmp_path):
    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "pyarrow"
                        else real(name, *a))
    with pytest.raises(ImportError, match="pyarrow"):
        Relations.read_parquet(str(tmp_path / "rel.parquet"))


# --------------------------------------------------------------- layers

def _both(jt, make, xs, train=False):
    """``make(lib)``'s layer in a one-layer model of each package, the
    port's loaded with JAX's initial parameters; returns (port output,
    JAX output, JAX params, port model)."""
    jax = jt["jax"]
    jin = [jt["Input"](shape=x.shape[1:]) for x in xs]
    jm = jt["Model"](input=jin if len(xs) > 1 else jin[0],
                     output=make(jt["layers"])(jin if len(xs) > 1
                                               else jin[0]))
    module = jm.to_flax()
    variables = module.init({"params": jax.random.PRNGKey(0),
                             "dropout": jax.random.PRNGKey(1)}, *xs,
                            train=train)
    want = np.asarray(module.apply(variables, *xs, train=train))
    params = jax.device_get(variables.get("params", {}))
    tin = [Input(shape=x.shape[1:]) for x in xs]
    tm = Model(input=tin if len(xs) > 1 else tin[0],
               output=make(tl)(tin if len(xs) > 1 else tin[0]))
    tm.module.load_state_dict(convert.flax_to_state_dict(params))
    with torch.no_grad():
        got = tm.module(*[torch.from_numpy(x) for x in xs]).numpy()
    return got, want, params, tm


def _shapes(tree):
    return {k: _shapes(v) if isinstance(v, dict) else tuple(v.shape)
            for k, v in tree.items()}


@pytest.mark.parametrize("dim,offset,length,shape", [
    (1, 0, 3, (4, 7)), (1, 3, 4, (4, 7)), (2, 1, 2, (3, 5, 4)),
    (-1, 0, 2, (3, 5, 4))])
def test_narrow_is_bitwise_jax(jt, dim, offset, length, shape):
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    got, want, _, tm = _both(
        jt, lambda lib: lib.Narrow(dim, offset, length), [x])
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    node_shape = tm._outputs[0].shape
    assert node_shape == want.shape[1:]


def test_word_embedding_matches_jax(jt):
    table = np.random.RandomState(0).randn(10, 4).astype(np.float32)
    ids = np.array([[1, 3, 5], [2, 0, 9]], np.float32)
    # frozen: no params in either package, exact lookup
    got, want, params, tm = _both(
        jt, lambda lib: lib.WordEmbedding(table, trainable=False), [ids])
    assert params == {} and list(tm.module.parameters()) == []
    assert tm.module.state_dict() == {}
    assert convert.flax_layout(tm.module) == {}
    np.testing.assert_array_equal(got, want)
    # 1-based ids shift down, clamped at 0
    got, want, _, _ = _both(
        jt, lambda lib: lib.WordEmbedding(table, zero_based_id=False),
        [ids + 1])
    np.testing.assert_array_equal(got, want)
    # trainable: the pretrained table is the parameter
    got, want, params, tm = _both(
        jt, lambda lib: lib.WordEmbedding(table, trainable=True, name="we"),
        [ids])
    np.testing.assert_array_equal(got, want)
    assert _shapes(convert.flax_layout(tm.module)) == _shapes(params)
    np.testing.assert_array_equal(
        tm.module.state_dict()["we.embedding"].numpy(), table)


def test_word_embedding_from_glove_matches_jax(jt, tmp_path):
    p = tmp_path / "glove.txt"
    p.write_text("hello 1.0 2.0\nworld 3.0 4.0\nskip 9.0\n")
    vocab = {"hello": 1, "world": 2}
    we = tl.WordEmbedding.from_glove(str(p), vocab, 2)
    jwe = jt["layers"].WordEmbedding.from_glove(str(p), vocab, 2)
    np.testing.assert_array_equal(we.weights, jwe.weights)
    got, _, _, _ = _both(
        jt, lambda lib: lib.WordEmbedding.from_glove(str(p), vocab, 2),
        [np.array([[1, 2, 0]], np.float32)])
    np.testing.assert_array_equal(got[0], [[1.0, 2.0], [3.0, 4.0],
                                           [0.0, 0.0]])


def test_frozen_word_embedding_trains_nothing(tmp_path):
    """A fit moves the Dense after a frozen table and never the table: no
    gradient, no optimizer state, no leaf in the snapshot's trees."""
    table = np.random.RandomState(1).randn(12, 4).astype(np.float32)
    inp = Input(shape=(5,))
    h = tl.Flatten()(tl.WordEmbedding(table, name="glove")(inp))
    m = Model(input=inp, output=tl.Dense(2, activation="softmax")(h))
    m.compile(optimizer="adam", loss="sparse_categorical_crossentropy",
              device="cpu")
    rng = np.random.default_rng(0)
    x = rng.integers(0, 12, (32, 5)).astype(np.float32)
    y = rng.integers(0, 2, 32).astype(np.int32)
    before = m.module.glove.table.clone()
    dense = m.module.dense_1.weight.detach().clone()
    m.fit(x, y, batch_size=16, nb_epoch=1)
    assert torch.equal(m.module.glove.table, before)
    assert not torch.equal(m.module.dense_1.weight, dense)
    est = m.estimator
    assert est._names == ["dense_1.weight", "dense_1.bias"]
    tree = est._state_tree()
    assert set(tree["params"]) == {"dense_1"}
    assert tree["model_state"] == {}
    m.save_weights(str(tmp_path / "w"))
    m.load_weights(str(tmp_path / "w"))
    assert torch.equal(m.module.glove.table, before)


@pytest.mark.parametrize("rnn", ["LSTM", "GRU"])
@pytest.mark.parametrize("merge", ["concat", "sum", "mul", "ave"])
@pytest.mark.parametrize("sequences", [True, False])
def test_bidirectional_matches_jax(jt, rnn, merge, sequences):
    x = np.random.default_rng(2).normal(size=(3, 6, 4)).astype(np.float32)
    got, want, params, tm = _both(
        jt, lambda lib: lib.Bidirectional(
            getattr(lib, rnn)(5, return_sequences=sequences),
            merge_mode=merge), [x])
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert _shapes(convert.flax_layout(tm.module)) == _shapes(params)
    assert tm._outputs[0].shape == want.shape[1:]
    back = convert.state_dict_to_flax(tm.module.state_dict(), params)
    assert _shapes(back) == _shapes(params)


def test_bidirectional_keeps_order_and_reads_both_ends(jt):
    """The backward output at position t has read the sequence from its
    end down to t: its step 0 has read all of it, its last step only the
    last element (flax's keep_order=True)."""
    x = np.random.default_rng(3).normal(size=(2, 5, 3)).astype(np.float32)
    _, seq, params, _ = _both(
        jt, lambda lib: lib.Bidirectional(
            lib.GRU(4, return_sequences=True)), [x])
    last = x[:, -1:, :]
    _, tail, _, _ = _both(
        jt, lambda lib: lib.Bidirectional(
            lib.GRU(4, return_sequences=True)), [last])
    np.testing.assert_allclose(seq[:, -1, 4:], tail[:, 0, 4:], atol=1e-6)
    _, vec, _, _ = _both(
        jt, lambda lib: lib.Bidirectional(lib.GRU(4)), [x])
    np.testing.assert_allclose(vec[:, 4:], seq[:, 0, 4:], atol=1e-6)
    np.testing.assert_allclose(vec[:, :4], seq[:, -1, :4], atol=1e-6)
