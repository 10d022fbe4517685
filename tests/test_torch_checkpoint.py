"""Checkpoints in the JAX package's layout (``learn/checkpoint.py``), on
the CPU.

- **Encoding.** The port's own msgpack writer and reader against
  ``flax.serialization`` (msgpack 1.1.2 underneath): every form the
  encoding has (ints of each width, floats, str, bin, nil, bools, lists,
  maps of each size, arrays of each dtype, 0-d arrays, numpy scalars,
  bfloat16 through torch, chunked arrays), byte for byte both ways.
- **Bytes of a training state.** The JAX estimator's state after a few
  steps, saved by JAX and loaded by the port, is written back by the port
  byte for byte as ``flax.serialization.to_bytes`` of the JAX state: NCF
  with adam, with SGD (momentum and weight decay), with adamw, with adam
  under l2-norm clipping and with adam on a schedule, a 2-block BERT
  classifier (hidden 64, 4 heads), and a ``resnet-lite``, a
  ``mobilenet`` and a ``mobilenet-v2`` ImageClassifier (the batch norms'
  running statistics in ``model_state`` as flax's ``batch_stats``
  collection; the separable convolutions' nested trees; the grouped
  kernels).
- **InferenceModel.load_checkpoint.** A fit's snapshot restored into a
  fresh classifier's InferenceModel predicts bitwise the fitted
  estimator (``resnet-lite``, ``mobilenet-v2``); a JAX-written
  ``resnet-lite`` snapshot restores within 1e-5 of JAX's predict; a torch
  Sequential from ``Estimator.from_torch`` restores into a fresh module
  (JAX's tests/test_inference_net.py:322); no model, a quantized model
  and another model's snapshot are refused.
- **Cross loading, both ways.** NCF (``save_model``), the NCF with an
  item-history column (``save_weights``), Seq2Seq (``save_model``; greedy
  tokens equal) and the BERT classifier (``save``): predictions within
  NCF's 1e-5, Seq2Seq's 1e-5 (tests/test_torch_generation.py) and BERT's
  2e-5 (tests/test_torch_bert_slice.py), through ``ZooModel.load_model``
  and ``InferenceModel(device="cpu").load``.
- **Resume across packages.** JAX fits NCF one epoch and saves, the port
  loads and fits one more; then the roles swapped. Both are held to JAX's
  two-epoch fit at tests/test_torch_keras_train.py's tolerance (loss rtol
  1e-5; Adam's parameters within 1e-5 in all but 1% of each leaf and
  within 2 lr per step everywhere).
- **The committed JAX checkpoints** (``tests/data/jax_checkpoints``, made
  by ``dev/make_jax_checkpoints.py``) are what the JAX package writes now
  (``meta.json``'s time aside; predictions within 1e-6), and the port
  reads them without JAX.
- **Port counterparts** of the JAX tests of checkpoints, retries and
  auto-resume (tests/test_estimator.py, test_estimator_edge.py,
  test_resilience.py, test_keras.py): resume from a snapshot, retry from
  a snapshot and its budget, several-iteration snapshots, retention at
  ``checkpoint_max_to_keep``, a torn or wrong-model version skipped,
  auto-resume bitwise equal to an unfaulted run (epoch and mid-epoch
  snapshots; also for a model with batch norms, running statistics
  included), ``ZOO_FIT_MAX_RESUMES``, ``set_checkpoint``, weights of a
  TimeDistributed graph, and full-model ``save``/``load``.

JAX is imported by fixtures only.
"""

import copy
import json
import os

import numpy as np
import pytest
import torch
from torch import nn

from analytics_zoo_tpu_torch.common import resilience
from analytics_zoo_tpu_torch.common.context import OrcaContext
from analytics_zoo_tpu_torch.common.flax_compat import Dense
from analytics_zoo_tpu_torch.convert import (ParamLayout, flax_layout,
                                             flax_to_state_dict,
                                             state_dict_to_flax)
from analytics_zoo_tpu_torch.inference import InferenceModel
from analytics_zoo_tpu_torch.keras import Input, Model, Sequential
from analytics_zoo_tpu_torch.keras import layers as tl
from analytics_zoo_tpu_torch.keras.models import KerasNet
from analytics_zoo_tpu_torch.learn import Estimator
from analytics_zoo_tpu_torch.learn import checkpoint as ckpt
from analytics_zoo_tpu_torch.learn import optimizers as topt
from analytics_zoo_tpu_torch.learn.trigger import (EveryEpoch,
                                                   SeveralIteration)
from analytics_zoo_tpu_torch.models import NeuralCF, Seq2Seq
from analytics_zoo_tpu_torch.models.common import ZooModel
from analytics_zoo_tpu_torch.text import BERTClassifier, BertConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data", "jax_checkpoints")
USERS, ITEMS, WIDTH, HIST = 50, 40, 8, 8
NCF_ARGS = dict(user_count=USERS, item_count=ITEMS, class_num=5,
                user_embed=WIDTH, item_embed=WIDTH, hidden_layers=(16, 8),
                include_mf=True, mf_embed=WIDTH)
S2S_ARGS = dict(input_dim=4, output_dim=4, hidden_size=16, rnn_type="gru",
                num_layers=1, encoder_seq_len=5, decoder_seq_len=4)
BERT_SMALL = dict(vocab=100, hidden_size=64, n_block=2, n_head=4,
                  intermediate_size=128, max_position_len=32,
                  hidden_drop=0.0, attn_drop=0.0)
LOSS = "sparse_categorical_crossentropy"
BATCH, ROWS, LR = 64, 256, 1e-2


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _no_plan(monkeypatch, tmp_path):
    monkeypatch.setenv("ZOO_AUTOTUNE", "off")
    monkeypatch.setenv("ZOO_AUTOTUNE_CACHE", str(tmp_path / "autotune.json"))
    monkeypatch.delenv("ZOO_FAULT_PLAN", raising=False)
    monkeypatch.delenv("ZOO_FIT_MAX_RESUMES", raising=False)
    resilience.reset_for_tests()
    yield
    resilience.install_plan(None)


@pytest.fixture(scope="module")
def jx():
    """The JAX package's pieces these tests compare with."""
    pytest.importorskip("jax")
    import jax
    from flax import serialization
    from analytics_zoo_tpu.inference import InferenceModel as JIM
    from analytics_zoo_tpu.inference import generation as jgen
    from analytics_zoo_tpu.keras import Input as JInput
    from analytics_zoo_tpu.keras import Model as JModel
    from analytics_zoo_tpu.keras import layers as jl
    from analytics_zoo_tpu.learn import optimizers as jopt
    from analytics_zoo_tpu.models import Seq2Seq as JSeq2Seq
    from analytics_zoo_tpu.models.common import ZooModel as JZooModel
    from analytics_zoo_tpu.models.recommendation import NeuralCF as JNCF
    from analytics_zoo_tpu.text import BERTClassifier as JBERTClassifier
    from analytics_zoo_tpu.text.bert import BertConfig as JConfig
    return dict(jax=jax, ser=serialization, IM=JIM, gen=jgen, Input=JInput,
                Model=JModel, layers=jl, opt=jopt, Seq2Seq=JSeq2Seq,
                ZooModel=JZooModel, NeuralCF=JNCF,
                BERTClassifier=JBERTClassifier, Config=JConfig)


def _pairs(n, seed):
    rng = np.random.RandomState(seed)
    x = np.stack([rng.randint(1, USERS + 1, n),
                  rng.randint(1, ITEMS + 1, n)], 1).astype(np.float32)
    return x, ((x[:, 0] + x[:, 1]) % 5).astype(np.int32)


def _history(n, seed):
    rng = np.random.RandomState(seed + 100)
    lengths = rng.randint(1, HIST + 1, n)
    ids = rng.randint(1, ITEMS + 1, (n, HIST))
    return np.where(np.arange(HIST)[None] < lengths[:, None], ids,
                    0).astype(np.int32)


def hist_graph(Input, Model, layers):
    """NCF with a pooled item-history column, from either package."""
    ui = Input(shape=(2,))
    hist = Input(shape=(HIST,))
    mlp = layers.FusedEmbeddings(
        [("mlp_user_embed", USERS + 1, WIDTH),
         ("mlp_item_embed", ITEMS + 1, WIDTH)], combine="concat",
        name="mlp_embed_bag")(ui)
    pooled = layers.Embedding(ITEMS + 1, WIDTH, pooling="mean",
                              name="hist_embed")(hist)
    linear = layers.Dense(16, activation="relu")(
        layers.merge([mlp, pooled], mode="concat"))
    mf = layers.FusedEmbeddings(
        [("mf_user_embed", USERS + 1, WIDTH),
         ("mf_item_embed", ITEMS + 1, WIDTH)], combine="mul",
        name="mf_embed_bag")(ui)
    out = layers.Dense(5, activation="softmax")(
        layers.merge([linear, mf], mode="concat"))
    return Model(input=[ui, hist], output=out)


def _state_file(d):
    found = ckpt.find_latest_checkpoint(d)
    with open(os.path.join(found[0], "state.msgpack"), "rb") as fh:
        return fh.read()


def _jax_bytes(jx, est):
    """flax's bytes of a JAX estimator's live state."""
    jax = jx["jax"]
    return jx["ser"].to_bytes(jax.tree_util.tree_map(np.asarray, est._state))


# ------------------------------------------------------------- encoding

def _encodable(rng):
    return {
        "ints": {str(i): v for i, v in enumerate(
            [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
             2 ** 63 - 1, -1, -32, -33, -128, -129, -32768, -32769,
             -2 ** 31, -2 ** 31 - 1, -2 ** 63])},
        "floats": {"a": 0.5, "b": -1e300, "c": float("inf")},
        "strs": {"": "", "s31": "x" * 31, "s32": "y" * 32,
                 "s255": "z" * 255, "s256": "w" * 256,
                 "s70000": "v" * 70000, "utf": "é中"},
        "bin": {"b0": b"", "b300": bytes(range(256)) + b"\x00" * 44,
                "b70000": b"\x07" * 70000},
        "misc": {"none": None, "t": True, "f": False,
                 "list": [1, "a", None, [2.5, b"x"]],
                 "big_list": list(range(20))},
        "map15": {f"k{i}": i for i in range(15)},
        "map16": {f"k{i}": i for i in range(16)},
        "map70000": {f"k{i}": 0 for i in range(70000)},
        "arrays": {
            "f32": rng.randn(3, 4).astype(np.float32),
            "f64": rng.randn(5).astype(np.float64),
            "f16": rng.randn(2, 2).astype(np.float16),
            "i8": np.arange(-3, 3, dtype=np.int8),
            "i32_0d": np.asarray(7, np.int32),
            "i64": np.arange(4, dtype=np.int64).reshape(2, 2),
            "u8": np.arange(16, dtype=np.uint8),
            "bool": np.array([True, False]),
            "empty": np.zeros((0, 3), np.float32),
            "fortran": np.asfortranarray(rng.randn(3, 2)).astype(np.float32),
            "wide": rng.randn(17, 300).astype(np.float32),
        },
        "scalars": {"f": np.float32(1.5), "i": np.int64(-3)},
    }


def test_to_bytes_equals_flax_on_every_form(jx):
    tree = _encodable(np.random.RandomState(0))
    # in place: flax's copy would rebuild the maps with sorted keys; the
    # port writes maps in the tree's order, as flax does in place
    want = jx["ser"].msgpack_serialize(_encodable(np.random.RandomState(0)),
                                       in_place=True)
    assert ckpt.to_bytes(tree) == want
    back = ckpt.msgpack_restore(want)
    assert ckpt.to_bytes(back) == want
    ref = jx["ser"].msgpack_restore(want)
    assert back["strs"] == ref["strs"] and back["misc"] == ref["misc"]
    for k, v in ref["arrays"].items():
        assert back["arrays"][k].dtype == v.dtype
        np.testing.assert_array_equal(back["arrays"][k], v)
    assert type(back["scalars"]["f"]) is np.float32


def test_bfloat16_goes_through_torch(jx):
    import jax.numpy as jnp
    vals = np.random.RandomState(1).randn(3, 5).astype(np.float32)
    want = jx["ser"].msgpack_serialize(
        {"w": np.asarray(jnp.asarray(vals, jnp.bfloat16))})
    t = torch.from_numpy(vals).to(torch.bfloat16)
    assert ckpt.to_bytes({"w": t}) == want
    back = ckpt.msgpack_restore(want)["w"]
    assert back.dtype == torch.bfloat16 and torch.equal(back, t)


def test_chunked_arrays_match_flax(jx, monkeypatch):
    monkeypatch.setattr(ckpt, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(jx["ser"], "MAX_CHUNK_SIZE", 64)
    tree = {"big": np.arange(50, dtype=np.float32).reshape(5, 10),
            "small": np.ones(3, np.float32)}
    want = jx["ser"].msgpack_serialize(tree)
    assert ckpt.to_bytes(tree) == want
    np.testing.assert_array_equal(ckpt.msgpack_restore(want)["big"],
                                  tree["big"])


def test_truncated_and_mismatched_bytes_raise():
    data = ckpt.to_bytes({"a": np.ones(4, np.float32), "b": 1})
    with pytest.raises(ValueError, match="truncated"):
        ckpt.msgpack_restore(data[:-3])
    with pytest.raises(ValueError, match="trailing"):
        ckpt.msgpack_restore(data + b"\x00")
    with pytest.raises(ValueError, match="do not match"):
        ckpt.from_bytes({"a": None, "c": None}, data)


# ------------------------------------------------ bytes of a training state

def _ncf_pair(jx, opt, clip=False):
    jopt, topt_ = jx["opt"], topt
    make = {
        "adam": (lambda: jopt.Adam(LR), lambda: topt_.Adam(LR)),
        "sgd": (lambda: jopt.SGD(0.1, momentum=0.9, weightdecay=0.01),
                lambda: topt_.SGD(0.1, momentum=0.9, weightdecay=0.01)),
        "adamw": (lambda: jopt.AdamWeightDecay(LR, weight_decay=0.01),
                  lambda: topt_.AdamWeightDecay(LR, weight_decay=0.01)),
        "adam_schedule": (
            lambda: jopt.Adam(LR, leaningrate_schedule=jopt.Warmup(3)),
            lambda: topt_.Adam(LR, leaningrate_schedule=topt_.Warmup(3))),
    }[opt]
    j = jx["NeuralCF"](**NCF_ARGS)
    j.compile(optimizer=make[0](), loss=LOSS)
    t = NeuralCF(**NCF_ARGS)
    t.compile(optimizer=make[1](), loss=LOSS, device="cpu")
    if clip:
        j.model.set_gradient_clipping_by_l2_norm(0.5)
        t.model.set_gradient_clipping_by_l2_norm(0.5)
    return j, t


@pytest.mark.parametrize("opt,clip", [("adam", False), ("sgd", False),
                                      ("adamw", False), ("adam", True),
                                      ("adam_schedule", False)])
def test_state_bytes_equal_flax(jx, tmp_path, opt, clip):
    j, t = _ncf_pair(jx, opt, clip)
    j.fit(*_pairs(ROWS, 0), batch_size=BATCH, nb_epoch=1)
    want = _jax_bytes(jx, j.model.estimator)
    j.model.save_weights(str(tmp_path / "j"))
    assert _state_file(str(tmp_path / "j")) == want
    t.model.load_weights(str(tmp_path / "j"))
    est = t.model.estimator
    # (plain SGD keeps no count in optax's tree: its rate is constant)
    assert est._py_step == 4
    assert est._opt_state["count"] == (0 if opt == "sgd" else 4)
    assert ckpt.to_bytes(est._state_tree()) == want
    t.model.save_weights(str(tmp_path / "t"))
    assert _state_file(str(tmp_path / "t")) == want
    # from_bytes inverts to_bytes
    spec = est._state_tree(spec=True)
    assert ckpt.to_bytes(ckpt.from_bytes(spec, want)) == want


def test_bert_classifier_state_bytes_equal_flax(jx, tmp_path):
    rng = np.random.RandomState(2)
    ids = rng.randint(1, 100, (16, 16)).astype(np.int32)
    labels = rng.randint(0, 2, 16).astype(np.int32)
    j = jx["BERTClassifier"](2, config=jx["Config"](**BERT_SMALL),
                             seq_len=16)
    j.fit(ids, labels, epochs=1, batch_size=8)
    want = _jax_bytes(jx, j.estimator)
    j.save(str(tmp_path / "j"))
    t = BERTClassifier(2, config=BertConfig(**BERT_SMALL), seq_len=16,
                       device="cpu").load(str(tmp_path / "j"))
    assert ckpt.to_bytes(t.estimator._state_tree()) == want
    t.save(str(tmp_path / "t"))
    assert _state_file(str(tmp_path / "t")) == want
    np.testing.assert_allclose(t.predict(ids, batch_size=8),
                               np.asarray(j.predict(ids, batch_size=8)),
                               rtol=0, atol=2e-5)


def test_flax_layout_names_the_jax_tree(jx):
    """The layout the port derives without JAX equals JAX's tree."""
    jax = jx["jax"]
    j = jx["BERTClassifier"](2, config=jx["Config"](**BERT_SMALL),
                             seq_len=16)
    t = BERTClassifier(2, config=BertConfig(**BERT_SMALL), seq_len=16,
                       device="cpu")
    jtree = jax.device_get(j.estimator.adapter.params)
    like = flax_layout(t.estimator.model)
    flat = jax.tree_util.tree_flatten_with_path
    assert [(str(p), tuple(v.shape)) for p, v in flat(like)[0]] == \
        [(str(p), tuple(np.shape(v))) for p, v in flat(jtree)[0]]
    # a foreign module takes JAX's torch_to_jax names where JAX
    # translates it, else keeps its torch names
    layout = ParamLayout(nn.Sequential(nn.Conv1d(2, 3, 1)))
    assert layout.kind == "torch_tree" and \
        set(layout.like["0"]) == {"kernel", "bias"}
    layout = ParamLayout(nn.Sequential(nn.Conv3d(2, 3, 1)))
    assert not layout.flax and set(layout.like["0"]) == {"weight", "bias"}


# ------------------------------------------------- cross loading, both ways

def test_ncf_saved_by_jax_serves_in_the_port_and_back(jx, tmp_path):
    x, y = _pairs(ROWS, 1)
    j = jx["NeuralCF"](**NCF_ARGS)
    j.compile(optimizer=jx["opt"].Adam(LR), loss=LOSS)
    j.fit(x, y, batch_size=BATCH, nb_epoch=1)
    j.save_model(str(tmp_path / "j"))
    want = np.asarray(j.predict(x))
    t = ZooModel.load_model(str(tmp_path / "j"))
    assert isinstance(t, NeuralCF)
    np.testing.assert_allclose(t.predict(x, device="cpu"), want,
                               rtol=0, atol=1e-5)
    im = InferenceModel(device="cpu").load(str(tmp_path / "j"))
    np.testing.assert_allclose(im.predict(x), want, rtol=0, atol=1e-5)
    # the port trains on and saves; JAX serves it
    t.compile(optimizer=topt.Adam(LR), loss=LOSS, device="cpu")
    t.fit(x, y, batch_size=BATCH, nb_epoch=1)
    t.save_model(str(tmp_path / "t"))
    got = t.predict(x)
    back = jx["ZooModel"].load_model(str(tmp_path / "t"))
    np.testing.assert_allclose(np.asarray(back.predict(x)), got,
                               rtol=0, atol=1e-5)
    jim = jx["IM"]().load(str(tmp_path / "t"))
    np.testing.assert_allclose(np.asarray(jim.predict(x)), got,
                               rtol=0, atol=1e-5)


def test_history_column_ncf_weights_cross_both_ways(jx, tmp_path):
    x = [_pairs(ROWS, 2)[0], _history(ROWS, 2)]
    y = _pairs(ROWS, 2)[1]
    j = hist_graph(jx["Input"], jx["Model"], jx["layers"])
    j.compile(optimizer=jx["opt"].Adam(LR), loss=LOSS)
    j.fit(x, y, batch_size=BATCH, nb_epoch=1)
    j.save_weights(str(tmp_path / "j"))
    t = hist_graph(Input, Model, tl)
    t.compile(optimizer=topt.Adam(LR), loss=LOSS, device="cpu")
    t.load_weights(str(tmp_path / "j"))
    np.testing.assert_allclose(t.predict(x), np.asarray(j.predict(x)),
                               rtol=0, atol=1e-5)
    t.fit(x, y, batch_size=BATCH, nb_epoch=1)
    t.save_weights(str(tmp_path / "t"))
    j2 = hist_graph(jx["Input"], jx["Model"], jx["layers"])
    j2.compile(optimizer=jx["opt"].Adam(LR), loss=LOSS)
    j2.load_weights(str(tmp_path / "t"))
    np.testing.assert_allclose(np.asarray(j2.predict(x)), t.predict(x),
                               rtol=0, atol=1e-5)


def _greedy_with_margin(step, enc, start, steps, decode_loop):
    margins = []

    def watched(e, d):
        scores = np.asarray(step(e, d))
        top = np.sort(scores[:, len(margins), :], axis=-1)
        margins.append(float((top[:, -1] - top[:, -2]).min()))
        return scores
    out = decode_loop(watched, enc, start, 10, ladder=None, mode="greedy")
    assert min(margins) > 1e-4, margins
    return np.asarray(out)


def test_seq2seq_crosses_both_ways(jx, tmp_path):
    rng = np.random.default_rng(3)
    enc = rng.normal(size=(2, 5, 4)).astype(np.float32)
    dec = rng.normal(size=(2, 4, 4)).astype(np.float32)
    start = np.zeros((2, 4), np.float32)
    start[:, 0] = 1.0
    # JAX saves, the port loads
    j = jx["Seq2Seq"](**S2S_ARGS)
    j.save_model(str(tmp_path / "j"))
    jim = jx["IM"]().load_zoo(j)
    im = InferenceModel(device="cpu").load(str(tmp_path / "j"))
    np.testing.assert_allclose(im.predict((enc, dec)),
                               np.asarray(jim.predict((enc, dec))),
                               rtol=0, atol=1e-5)
    want = _greedy_with_margin(jim.decode_step_fn(), enc, start, 10,
                               jx["gen"].decode_loop)
    np.testing.assert_array_equal(im.generate(enc, start, 10), want)
    # the port saves, JAX loads
    t = Seq2Seq(**S2S_ARGS)
    t.save_model(str(tmp_path / "t"))
    jim2 = jx["IM"]().load(str(tmp_path / "t"))
    im2 = InferenceModel(device="cpu").load_zoo(t)
    np.testing.assert_allclose(np.asarray(jim2.predict((enc, dec))),
                               im2.predict((enc, dec)), rtol=0, atol=1e-5)
    want2 = _greedy_with_margin(jim2.decode_step_fn(), enc, start, 10,
                                jx["gen"].decode_loop)
    np.testing.assert_array_equal(im2.generate(enc, start, 10), want2)


def test_bert_classifier_crosses_both_ways(jx, tmp_path):
    rng = np.random.RandomState(4)
    ids = rng.randint(1, 100, (8, 16)).astype(np.int32)
    j = jx["BERTClassifier"](2, config=jx["Config"](**BERT_SMALL),
                             seq_len=16)
    j.save(str(tmp_path / "j"))
    t = BERTClassifier(2, config=BertConfig(**BERT_SMALL), seq_len=16,
                       device="cpu", seed=3).load(str(tmp_path / "j"))
    np.testing.assert_allclose(t.predict(ids, batch_size=8),
                               np.asarray(j.predict(ids, batch_size=8)),
                               rtol=0, atol=2e-5)
    t2 = BERTClassifier(2, config=BertConfig(**BERT_SMALL), seq_len=16,
                        device="cpu", seed=7)
    t2.save(str(tmp_path / "t"))
    j2 = jx["BERTClassifier"](2, config=jx["Config"](**BERT_SMALL),
                              seq_len=16).load(str(tmp_path / "t"))
    np.testing.assert_allclose(np.asarray(j2.predict(ids, batch_size=8)),
                               t2.predict(ids, batch_size=8),
                               rtol=0, atol=2e-5)


# ------------------------------------------------ resume across packages

def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    else:
        yield path, np.asarray(tree)


def _assert_adam_params(module, jparams, steps):
    got = dict(_leaves(state_dict_to_flax(module.state_dict(), jparams)))
    for path, want in _leaves(jparams):
        diff = np.abs(got[path] - want)
        assert np.mean(diff > 1e-5) <= 1e-2, (path, diff.max())
        assert diff.max() <= 2 * LR * steps, (path, diff.max())


def test_resume_across_packages_matches_a_two_epoch_jax_fit(jx, tmp_path):
    jax = jx["jax"]
    x, y = _pairs(ROWS, 3)
    steps = ROWS // BATCH
    ref = jx["NeuralCF"](**NCF_ARGS)
    ref.compile(optimizer=jx["opt"].Adam(LR), loss=LOSS)
    ref.model.save_weights(str(tmp_path / "j0"))
    ref.fit(x, y, batch_size=BATCH, nb_epoch=1)
    ref.model.save_weights(str(tmp_path / "j1"))
    second = ref.fit(x, y, batch_size=BATCH, nb_epoch=1)["loss"]
    final = jax.device_get(ref.model.get_weights())
    # JAX's first epoch, the port's second
    t = NeuralCF(**NCF_ARGS)
    t.compile(optimizer=topt.Adam(LR), loss=LOSS, device="cpu")
    t.model.load_weights(str(tmp_path / "j1"))
    assert t.model.estimator._epoch == 1
    got = t.fit(x, y, batch_size=BATCH, nb_epoch=1)["loss"]
    np.testing.assert_allclose(got, second, rtol=1e-5)
    _assert_adam_params(t.model.module, final, 2 * steps)
    # the port's first epoch, JAX's second
    t0 = NeuralCF(**NCF_ARGS)
    t0.compile(optimizer=topt.Adam(LR), loss=LOSS, device="cpu")
    t0.model.load_weights(str(tmp_path / "j0"))
    t0.fit(x, y, batch_size=BATCH, nb_epoch=1)
    t0.model.save_weights(str(tmp_path / "t1"))
    j = jx["NeuralCF"](**NCF_ARGS)
    j.compile(optimizer=jx["opt"].Adam(LR), loss=LOSS)
    j.model.load_weights(str(tmp_path / "t1"))
    got = j.fit(x, y, batch_size=BATCH, nb_epoch=1)["loss"]
    np.testing.assert_allclose(got, second, rtol=1e-5)
    t_final = NeuralCF(**NCF_ARGS)
    t_final.model.module.load_state_dict(flax_to_state_dict(
        jax.device_get(j.model.get_weights())))
    _assert_adam_params(t_final.model.module, final, 2 * steps)


# -------------------------------------------- the JAX-written files in git

def test_committed_jax_checkpoints_are_what_jax_writes(tmp_path):
    pytest.importorskip("jax")
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "make_jax_checkpoints",
        os.path.join(ROOT, "dev", "make_jax_checkpoints.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = str(tmp_path / "fresh")
    mod.write_all(out)
    names = sorted(os.path.relpath(os.path.join(d, f), out)
                   for d, _, fs in os.walk(out) for f in fs)
    assert names == sorted(os.path.relpath(os.path.join(d, f), DATA)
                           for d, _, fs in os.walk(DATA) for f in fs)
    for name in names:
        a, b = os.path.join(out, name), os.path.join(DATA, name)
        if name.endswith("meta.json"):
            ma, mb = json.load(open(a)), json.load(open(b))
            ma.pop("time"), mb.pop("time")
            assert ma == mb, name
        elif name.endswith(".npy"):
            np.testing.assert_allclose(np.load(a), np.load(b), rtol=0,
                                       atol=1e-6, err_msg=name)
        else:
            assert open(a, "rb").read() == open(b, "rb").read(), name


def test_port_reads_the_committed_jax_checkpoints():
    x = np.load(os.path.join(DATA, "ncf_x.npy"))
    im = InferenceModel(device="cpu").load(os.path.join(DATA, "ncf"))
    np.testing.assert_allclose(im.predict(x),
                               np.load(os.path.join(DATA, "ncf_pred.npy")),
                               rtol=0, atol=1e-5)
    s2s = InferenceModel(device="cpu").load(os.path.join(DATA, "seq2seq"))
    enc, dec, start = (np.load(os.path.join(DATA, f"seq2seq_{n}.npy"))
                       for n in ("enc", "dec", "start"))
    np.testing.assert_allclose(
        s2s.predict((enc, dec)),
        np.load(os.path.join(DATA, "seq2seq_pred.npy")), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(
        s2s.generate(enc, start, 10),
        np.load(os.path.join(DATA, "seq2seq_greedy.npy")))


def test_port_reads_the_committed_jax_wide_and_deep():
    xs = [np.load(os.path.join(DATA, f"wide_and_deep_{n}.npy"))
          for n in ("wide", "indicator", "embed", "continuous")]
    want = np.load(os.path.join(DATA, "wide_and_deep_pred.npy"))
    im = InferenceModel(device="cpu").load(os.path.join(DATA,
                                                        "wide_and_deep"))
    np.testing.assert_allclose(im.predict(tuple(xs)), want, rtol=0,
                               atol=1e-5)
    wnd = ZooModel.load_model(os.path.join(DATA, "wide_and_deep"))
    assert wnd.model_type == "wide_n_deep"
    np.testing.assert_allclose(wnd.predict(xs, device="cpu"), want, rtol=0,
                               atol=1e-5)


# ------------------------------------- counterparts of the JAX package's

class MLP(nn.Module):
    def __init__(self):
        super().__init__()
        self.hidden = Dense(4, 16)
        self.out = Dense(16, 1)

    def forward(self, x, train: bool = False):
        return self.out(torch.relu(self.hidden(x)))


def _reg_data(n=128, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 4)).astype(np.float32)
    y = (x @ np.array([[1.0], [-2.0], [0.5], [3.0]], np.float32)) + 0.1
    return x, y


def _mlp_est(mdir=None, seed=0):
    torch.manual_seed(seed)
    return Estimator.from_torch(model=MLP(), loss="mse", device="cpu",
                                model_dir=mdir)


def _params(est):
    return [p.detach().clone() for p in est.model.parameters()]


def test_module_outside_the_flax_rules_keeps_torch_names(tmp_path):
    """``from_torch`` of a module with no flax layout: the JAX layout with
    ``params`` named as JAX's ``torch_to_jax`` names a module it
    translates (a Linear's ``kernel`` transposed, a convolution's as it
    is), or nested by the torch names where JAX has no rule (a Conv3d);
    and back."""
    cases = ((nn.Conv1d(2, 3, 1), (16, 2, 4), {"bias", "kernel"}),
             (nn.Conv3d(2, 3, 1), (16, 2, 4, 1, 1), {"bias", "weight"}))
    for conv, shape, leaves in cases:
        def make(seed):
            torch.manual_seed(seed)
            return Estimator.from_torch(
                model=nn.Sequential(copy.deepcopy(conv), nn.Flatten(),
                                    nn.Linear(12, 1)),
                loss="mse", optimizer=topt.SGD(0.1, momentum=0.9),
                device="cpu")
        x = np.random.RandomState(3).randn(*shape).astype(np.float32)
        y = x.reshape(16, -1).sum(1)[:, None]
        a = make(0)
        a.fit((x, y), epochs=1, batch_size=8)
        path = str(tmp_path / type(conv).__name__)
        a.save(path)
        state = ckpt.msgpack_restore(_state_file(path))
        assert sorted(state["params"]) == ["0", "2"]
        assert set(state["params"]["0"]) == set(state["params"]["2"]) \
            == leaves
        assert sorted(state["opt_state"]["0"]["0"]["trace"]) == ["0", "2"]
        if "kernel" in leaves:
            np.testing.assert_array_equal(
                state["params"]["2"]["kernel"],
                a.model[2].weight.detach().numpy().T)
        b = make(1).load(path)
        for p, q in zip(_params(a), _params(b)):
            assert torch.equal(p, q)
        np.testing.assert_array_equal(b.fit((x, y), batch_size=8)["loss"],
                                      a.fit((x, y), batch_size=8)["loss"])


def test_checkpoint_resume(tmp_path):
    x, y = _reg_data()
    mdir = str(tmp_path / "ck")
    est = _mlp_est(mdir)
    est.fit((x, y), epochs=2, batch_size=32)
    path, version = ckpt.find_latest_checkpoint(mdir)
    assert version == est._py_step == 8
    est2 = _mlp_est(mdir, seed=1).load_orca_checkpoint(path)
    assert est2._py_step == version and est2._epoch == 2
    for a, b in zip(_params(est), _params(est2)):
        assert torch.equal(a, b)
    est3 = _mlp_est(seed=2).load_orca_checkpoint(mdir, version=4)
    assert est3._py_step == 4 and est3._epoch == 1


def test_retry_from_snapshot_on_injected_failure(tmp_path):
    x, y = _reg_data()
    est = _mlp_est(str(tmp_path / "ck"))
    est.fit((x, y), epochs=1, batch_size=32)   # EveryEpoch snapshot
    step_at_ckpt = est._py_step
    real_step = est._train_step
    calls = {"failures": 0}

    def bomb(bx, by):
        if calls["failures"] == 0:
            calls["failures"] += 1
            raise RuntimeError("injected chip failure")
        return real_step(bx, by)

    est._train_step = bomb
    h = est.fit((x, y), epochs=2, batch_size=32)
    assert calls["failures"] == 1
    assert len(h["loss"]) == 2 and all(np.isfinite(h["loss"]))
    assert est._py_step == step_at_ckpt + 2 * (len(x) // 32)
    assert est._epoch == 3


def test_retry_gives_up_after_budget(tmp_path):
    x, y = _reg_data()
    est = _mlp_est(str(tmp_path / "ck"))
    est.fit((x, y), epochs=1, batch_size=32)
    est.failure_retry_times = 2
    calls = []

    def always(bx, by):
        calls.append(1)
        raise RuntimeError("dead chip")

    est._train_step = always
    with pytest.raises(RuntimeError, match="dead chip"):
        est.fit((x, y), epochs=1, batch_size=32)
    assert len(calls) == 3          # the first try and two retries
    # without model_dir there is nothing to retry from
    est2 = _mlp_est()
    est2._train_step = always
    with pytest.raises(RuntimeError, match="dead chip"):
        est2.fit((x, y), epochs=1, batch_size=32)


def test_several_iteration_checkpoint_and_retention(tmp_path):
    x, y = _reg_data(64)
    mdir = str(tmp_path / "it")
    est = _mlp_est(mdir)
    OrcaContext.checkpoint_max_to_keep = 2
    try:
        est.fit((x, y), epochs=2, batch_size=8,
                checkpoint_trigger=SeveralIteration(3))
    finally:
        OrcaContext.checkpoint_max_to_keep = 5
    # fired at 3, 6, 9, 12, 15: the newest two are kept
    assert sorted(ckpt._list_versions(mdir)) == [12, 15]
    with open(os.path.join(mdir, "ckpt-15", "meta.json")) as fh:
        assert json.load(fh)["epoch"] == 1
    with pytest.raises(ValueError):
        OrcaContext.checkpoint_max_to_keep = 0


def _state(v=1.0, shape=(3, 2)):
    return {"params": {"w": np.full(shape, v, np.float32)},
            "step": np.asarray(3, np.int32)}


def test_validate_state_mismatches():
    good = _state()
    ckpt.validate_state(good, _state())
    with pytest.raises(ValueError, match="shape"):
        ckpt.validate_state(_state(shape=(4, 2)), good)
    with pytest.raises(ValueError, match="structure"):
        bad = dict(good)
        bad.pop("step")
        ckpt.validate_state(bad, good)
    with pytest.raises(ValueError, match="dtype"):
        ckpt.validate_state({"params": {"w": np.ones((3, 2))},
                             "step": good["step"]}, good)


def test_torn_file_falls_back_to_previous_version(tmp_path):
    d = str(tmp_path)
    ckpt.save_checkpoint(d, _state(1.0), iteration=4, epoch=1)
    ckpt.save_checkpoint(d, _state(2.0), iteration=8, epoch=2)
    torn = os.path.join(d, "ckpt-8", "state.msgpack")
    blob = open(torn, "rb").read()
    with open(torn, "wb") as fh:
        fh.write(blob[:len(blob) // 2])
    state, meta, path = ckpt.load_latest_checkpoint(d, _state())
    assert path.endswith("ckpt-4") and meta["iteration"] == 4
    assert float(state["params"]["w"][0, 0]) == 1.0


def test_wrong_model_checkpoint_is_skipped(tmp_path):
    d = str(tmp_path)
    ckpt.save_checkpoint(d, _state(), iteration=2, epoch=1)
    ckpt.save_checkpoint(d, _state(shape=(5, 4)), iteration=6, epoch=2)
    got = ckpt.load_latest_checkpoint(d, _state())
    assert got is not None and got[2].endswith("ckpt-2")
    assert ckpt.load_latest_checkpoint(str(tmp_path / "none"),
                                       _state()) is None


@pytest.mark.parametrize("trigger,plan", [
    (EveryEpoch, "wedge@step:10"),                    # epoch-2 snapshot
    (lambda: SeveralIteration(3), "wedge@step:11"),   # mid-epoch, step 9
    (lambda: SeveralIteration(4), "wedge@step:6+1")])  # two faults
def test_fit_auto_resume_bitwise_identical(tmp_path, trigger, plan):
    """A fault after a snapshot resumes from it and ends bitwise where an
    unfaulted run ends: parameters, optimizer state, step, history."""
    x, y = _reg_data(64)

    def run(faulted, mdir):
        resilience.install_plan(plan if faulted else None)
        est = _mlp_est(mdir)
        hist = est.fit((x, y), epochs=3, batch_size=16,
                       checkpoint_trigger=trigger(), auto_resume=faulted)
        resilience.install_plan(None)
        return est, hist

    a, ha = run(False, str(tmp_path / "a"))
    b, hb = run(True, str(tmp_path / "b"))
    assert a._py_step == b._py_step == 12 and a._epoch == b._epoch == 3
    assert ha == hb and a.step_losses == b.step_losses
    for p, q in zip(_params(a), _params(b)):
        assert torch.equal(p, q)
    for k in ("mu", "nu"):
        for p, q in zip(a._opt_state[k], b._opt_state[k]):
            assert torch.equal(p, q)


def test_fit_auto_resume_bounded_by_env(tmp_path, monkeypatch):
    monkeypatch.setenv("ZOO_FIT_MAX_RESUMES", "0")
    x, y = _reg_data(32)
    resilience.install_plan("wedge@step:3")
    est = _mlp_est(str(tmp_path / "m"))
    with pytest.raises(resilience.InjectedFault):
        est.fit((x, y), epochs=2, batch_size=16,
                checkpoint_trigger=EveryEpoch(), auto_resume=True)


def test_fault_plans_parse_count_and_nest():
    inj = resilience.FaultInjector("wedge@step:2+1, oom@dispatch")
    hits = [inj.check("step") is not None for _ in range(4)]
    assert hits == [False, True, True, False]
    assert inj.check("dispatch").kind == "oom"
    assert inj.counts() == {"step": 4, "dispatch": 1}
    # a scope's nested arrivals at its site do not count
    resilience.install_plan("wedge@step:3")
    with resilience.fault_scope("step"):
        resilience.maybe_fault("step")
    resilience.maybe_fault("step")
    with pytest.raises(resilience.InjectedFault, match="call #3"):
        resilience.maybe_fault("step")
    with pytest.raises(ValueError, match="kind@site"):
        resilience.FaultInjector("wedge-at-step")
    assert resilience.is_backend_loss(resilience.InjectedFault("w", "s", 1))
    assert resilience.is_backend_loss(RuntimeError("CUDA error: device lost"))
    assert not resilience.is_backend_loss(ValueError("bad shape"))
    assert resilience.fit_max_resumes(5) == 5


def test_set_checkpoint_snapshots_keras_fit(tmp_path):
    ncf = NeuralCF(**NCF_ARGS)
    ncf.set_checkpoint(str(tmp_path / "c"))      # before compile: kept
    ncf.compile(optimizer=topt.Adam(LR), loss=LOSS, device="cpu")
    ncf.fit(*_pairs(128, 4), batch_size=32, nb_epoch=2)
    assert sorted(ckpt._list_versions(str(tmp_path / "c"))) == [4, 8]
    ncf.model.set_checkpoint(str(tmp_path / "d"))
    ncf.fit(*_pairs(128, 4), batch_size=32, nb_epoch=1)
    assert ckpt._list_versions(str(tmp_path / "d")) == [12]


def test_time_distributed_checkpoint_stable(tmp_path):
    def build():
        s = Sequential()
        s.add(tl.LSTM(4, return_sequences=True, input_shape=(6, 3)))
        s.add(tl.TimeDistributed(tl.Dense(2)))
        return s
    m1 = build()
    for _ in range(3):      # burn global name counters
        tl.Dense(1)
    m2 = build()
    m1.save_weights(str(tmp_path / "w"))
    m2.load_weights(str(tmp_path / "w"))  # must not raise key mismatch
    x = np.random.RandomState(0).randn(2, 6, 3).astype(np.float32)
    np.testing.assert_array_equal(m2.predict(x, device="cpu"),
                                  m1.predict(x, device="cpu"))


def test_full_model_save_load_roundtrip(tmp_path):
    m = Sequential()
    m.add(tl.Dense(16, activation="relu", input_shape=(6,)))
    m.add(tl.Dropout(0.1))
    m.add(tl.Dense(3))
    m.compile(optimizer="adam", loss=LOSS + "_logits", device="cpu")
    rng = np.random.RandomState(0)
    x = rng.randn(64, 6).astype(np.float32)
    y = rng.randint(0, 3, 64).astype(np.int32)
    m.fit(x, y, batch_size=16, nb_epoch=2)
    want = m.predict(x[:8])
    m.save(str(tmp_path / "full"))
    loaded = KerasNet.load(str(tmp_path / "full"))
    np.testing.assert_array_equal(loaded.predict(x[:8]), want)
    # the compile settings and the optimizer state survived: training
    # goes on as it would have
    assert loaded.estimator._py_step == 8
    np.testing.assert_array_equal(
        loaded.fit(x, y, batch_size=16, nb_epoch=1)["loss"],
        m.fit(x, y, batch_size=16, nb_epoch=1)["loss"])


def test_functional_and_diverse_layers_save_load(tmp_path):
    a = Input(shape=(4,))
    ids = Input(shape=(3,))
    emb = tl.Flatten()(tl.Embedding(10, 2, name="emb")(ids))
    h = tl.merge([tl.Dense(8, activation="tanh")(a), emb], mode="concat")
    h = tl.LayerNormalization()(tl.Activation("gelu")(h))
    out = tl.Dense(2, activation="softmax")(tl.Dropout(0.2)(h))
    m = Model(input=[a, ids], output=out)
    m.compile(optimizer=topt.SGD(0.1, momentum=0.9), loss="mse",
              device="cpu")
    rng = np.random.RandomState(1)
    xa = rng.randn(16, 4).astype(np.float32)
    xi = rng.randint(0, 10, (16, 3)).astype(np.int32)
    m.fit([xa, xi], xa[:, :2], batch_size=8, nb_epoch=1)
    want = m.predict([xa, xi])
    m.save(str(tmp_path / "func"))
    loaded = KerasNet.load(str(tmp_path / "func"))
    np.testing.assert_array_equal(loaded.predict([xa, xi]), want)


# ------------------------------------------------- batch norms' statistics

def test_batch_norm_state_bytes_equal_flax(jx, tmp_path):
    """A ``resnet-lite`` fit by JAX for two steps: its state (the
    ``batch_stats`` collection in ``model_state`` included) read by the
    port and written back byte for byte as flax writes it."""
    _image_state_bytes_equal_flax(jx, tmp_path, "resnet-lite")


@pytest.mark.parametrize("name", ["mobilenet", "mobilenet-v2"])
def test_image_snapshot_bytes_equal_flax(jx, tmp_path, name):
    """The same for ``mobilenet`` (its separable convolutions' nested
    ``depthwise`` / ``pointwise`` trees) and ``mobilenet-v2`` (its
    grouped kernels ``[3, 3, 1, c]`` and 52 batch norms)."""
    _image_state_bytes_equal_flax(jx, tmp_path, name)


def _image_state_bytes_equal_flax(jx, tmp_path, name):
    from analytics_zoo_tpu.models.image.imageclassification import (
        ImageClassifier as JImageClassifier,
    )

    from analytics_zoo_tpu_torch.models import ImageClassifier
    kw = dict(class_num=2, model_name=name, image_size=16)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(16, 16, 16, 3)).astype(np.float32)
    y = rng.integers(0, 2, 16).astype(np.int32)
    j = JImageClassifier(**kw)
    j.compile(optimizer="adam", loss=LOSS)
    j.fit(x, y, batch_size=8, nb_epoch=1)
    jest = j.model.estimator
    assert sorted(jest._state["model_state"]) == (
        [] if name == "mobilenet" else ["batch_stats"])
    want = _jax_bytes(jx, jest)
    j.model.save_weights(str(tmp_path / "j"))
    assert _state_file(str(tmp_path / "j")) == want
    t = ImageClassifier(**kw)
    t.compile(optimizer="adam", loss=LOSS, device="cpu")
    t.model.load_weights(str(tmp_path / "j"))
    est = t.model.estimator
    assert est._py_step == 2
    assert ckpt.to_bytes(est._state_tree()) == want
    t.model.save_weights(str(tmp_path / "t"))
    assert _state_file(str(tmp_path / "t")) == want
    stats = jx["jax"].device_get(jest._state["model_state"]).get(
        "batch_stats", {})
    for layer, leaves in stats.items():
        for leaf, v in leaves.items():
            np.testing.assert_array_equal(
                getattr(t.model.module, layer)._buffers[leaf].numpy(), v)
    np.testing.assert_allclose(t.predict(x[:8], batch_size=8),
                               np.asarray(j.predict(x[:8], batch_size=8)),
                               rtol=0, atol=1e-5)


def _bn_net(seed=0):
    from analytics_zoo_tpu_torch.keras import Input, Model
    from analytics_zoo_tpu_torch.keras import layers as tl
    inp = Input(shape=(4,))
    h = tl.Dense(8)(inp)
    h = tl.BatchNormalization(momentum=0.9)(h)
    h = tl.Activation("relu")(h)
    model = Model(input=inp, output=tl.Dense(1)(h), seed=seed)
    model.compile(optimizer="adam", loss="mse", device="cpu")
    return model


def test_batch_norm_fit_auto_resume_mid_epoch_bitwise(tmp_path):
    """A mid-epoch snapshot (SeveralIteration(3)) of a model with a batch
    norm, a fault two steps later, auto-resume: parameters, running
    statistics, optimizer state and history bitwise an unfaulted run's."""
    x, y = _reg_data(64)

    def run(faulted, mdir):
        resilience.install_plan("wedge@step:11" if faulted else None)
        model = _bn_net()
        model.set_checkpoint(mdir)
        hist = model.fit(x, y, batch_size=16, nb_epoch=3,
                         checkpoint_trigger=SeveralIteration(3),
                         auto_resume=faulted)
        resilience.install_plan(None)
        return model, hist

    a, ha = run(False, str(tmp_path / "a"))
    b, hb = run(True, str(tmp_path / "b"))
    ea, eb_ = a.estimator, b.estimator
    assert ea._py_step == eb_._py_step == 12
    assert ha == hb and ea.step_losses == eb_.step_losses
    sa, sb = a.module.state_dict(), b.module.state_dict()
    assert sorted(sa) == sorted(sb)
    assert any(k.endswith(".var") for k in sa)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    for k in ("mu", "nu"):
        for p, q in zip(ea._opt_state[k], eb_._opt_state[k]):
            assert torch.equal(p, q)


# ------------------------------------- InferenceModel.load_checkpoint

def _lite_data(n=16, size=16, seed=7):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, size, size, 3)).astype(np.float32),
            rng.integers(0, 2, n).astype(np.int32))


@pytest.mark.parametrize("name", ["resnet-lite", "mobilenet-v2"])
def test_load_checkpoint_restores_a_keras_classifier(tmp_path, name):
    """A fit's snapshot (a checkpoint trigger every step) restored into
    a fresh classifier's InferenceModel predicts bitwise the fitted
    estimator at the same batch, running statistics included; the
    snapshot's directory and the version under it both load."""
    from analytics_zoo_tpu_torch.models import ImageClassifier
    kw = dict(class_num=2, model_name=name, image_size=16)
    x, y = _lite_data()
    clf = ImageClassifier(**kw)
    clf.compile(optimizer="adam", loss=LOSS, device="cpu")
    d = str(tmp_path / "ckpt")
    clf.model.estimator.model_dir = d
    clf.model.estimator.fit((x, y), epochs=1, batch_size=8,
                            checkpoint_trigger=SeveralIteration(1))
    want = clf.model.estimator.predict(x, batch_size=8)
    fresh = ImageClassifier(**kw)
    for path in (d, ckpt.find_latest_checkpoint(d)[0]):
        im = InferenceModel(device="cpu").load_zoo(fresh).load_checkpoint(
            path)
        np.testing.assert_array_equal(im.predict(x, batch_size=8), want)
    before = InferenceModel(device="cpu").load_zoo(fresh)
    assert not np.array_equal(before.predict(x, batch_size=8), want)


def test_load_checkpoint_reads_a_jax_written_snapshot(jx, tmp_path):
    """JAX fits ``resnet-lite`` and saves; the port's InferenceModel of
    a fresh port classifier restores it (params and ``batch_stats``) and
    predicts within 1e-5 of JAX's predict."""
    from analytics_zoo_tpu.models.image.imageclassification import (
        ImageClassifier as JImageClassifier,
    )

    from analytics_zoo_tpu_torch.models import ImageClassifier
    kw = dict(class_num=2, model_name="resnet-lite", image_size=16)
    x, y = _lite_data()
    j = JImageClassifier(**kw)
    j.compile(optimizer="sgd", loss=LOSS)
    j.fit(x, y, batch_size=8, nb_epoch=1)
    j.model.save_weights(str(tmp_path / "j"))
    im = InferenceModel(device="cpu").load_zoo(ImageClassifier(**kw))
    im.load_checkpoint(str(tmp_path / "j"))
    np.testing.assert_allclose(im.predict(x, batch_size=8),
                               np.asarray(j.predict(x, batch_size=8)),
                               rtol=0, atol=1e-5)


def test_load_checkpoint_of_a_torch_module(tmp_path):
    """JAX's tests/test_inference_net.py:322 on the port: a torch
    Sequential trained through ``Estimator.from_torch`` and saved, then
    restored into a fresh module of the same shape."""
    torch.manual_seed(0)
    m = nn.Sequential(nn.Linear(4, 8), nn.Tanh(), nn.Linear(8, 2))
    rng = np.random.RandomState(3)
    x = rng.randn(32, 4).astype(np.float32)
    y = (x.sum(1) > 0).astype(np.int32)
    est = Estimator.from_torch(
        model=m, loss="sparse_categorical_crossentropy_logits",
        optimizer="adam", device="cpu")
    est.fit((x, y), epochs=2, batch_size=8)
    path = str(tmp_path / "ckpt")
    est.save(path)
    want = np.asarray(est.predict(x, batch_size=8))
    fresh = nn.Sequential(nn.Linear(4, 8), nn.Tanh(), nn.Linear(8, 2))
    im = InferenceModel(device="cpu").load_torch(fresh, x[:1])
    im.load_checkpoint(path)
    np.testing.assert_allclose(im.predict(x, batch_size=8), want,
                               atol=1e-5)


def test_load_checkpoint_refuses_what_it_cannot_restore(tmp_path):
    """Before a load, after quantize, and a snapshot of another model."""
    from analytics_zoo_tpu_torch.models import ImageClassifier
    with pytest.raises(RuntimeError, match="load a model"):
        InferenceModel(device="cpu").load_checkpoint(str(tmp_path))
    x, y = _lite_data(8)
    clf = ImageClassifier(2, "resnet-lite", image_size=16)
    clf.compile(optimizer="adam", loss=LOSS, device="cpu")
    clf.model.save_weights(str(tmp_path / "lite"))
    other = InferenceModel(device="cpu").load_zoo(
        ImageClassifier(3, "resnet-lite", image_size=16))
    with pytest.raises(ValueError, match="shape"):
        other.load_checkpoint(str(tmp_path / "lite"))
    im = InferenceModel(device="cpu").load_zoo(clf)
    im.quantize(min_elems=64)
    with pytest.raises(RuntimeError, match="before quantize"):
        im.load_checkpoint(str(tmp_path / "lite"))
