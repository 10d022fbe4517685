"""The BERT task estimators ``BERTNER`` and ``BERTSQuAD`` and
``BertConfig.remat`` against the JAX package's, on the CPU.

- ``_ner_loss`` and ``_squad_loss`` on the same logits and labels (NER's
  with -1 labels) within 1e-6 of JAX's; NER's loss ignores what the
  masked positions hold.
- ``BERTNER`` (3 entities) and ``BERTSQuAD`` at hidden 64, 2 blocks, 4
  heads, 16 tokens, dropout 0, with ragged input masks, fit from the same
  parameters (``convert.flax_to_state_dict``) within the BERT-fit limits
  of ``tests/test_torch_estimator.py``: each epoch's loss within rtol
  1e-5, ``evaluate`` within rtol 1e-5, ``predict`` within atol 1e-5 (NER
  [n, L, 3]; SQuAD a (start, end) pair of [n, L], each row up to its
  mean: the ``qa`` bias takes no gradient in exact arithmetic, so Adam
  moves it on rounding noise, within 2 lr a step, as
  ``tests/test_torch_estimator.py`` holds attention's key bias; measured
  0.0023 after 3 steps at lr 1e-3).
- ``save`` / ``load`` across packages both ways: the loaded estimator
  predicts within atol 1e-5 of the one that saved.
- ``BertConfig(remat=True)`` (hidden 32, 2 blocks, 2 heads, 16 tokens,
  dropout 0; JAX's ``test_remat_forward_and_grad_equivalence``): the
  pooled output within 1e-6 and every gradient within 1e-5 of the plain
  module and of JAX's remat module (measured on this CPU: 0 from plain);
  with dropout 0.1 and through the flash path (its plain version here) a
  training step with remat is bitwise the step without, dropout's masks
  replayed in the recompute; a remat forward saves fewer bytes for the
  backward and keeps the products' outputs only
  (``text/bert.py``'s policy).

JAX is imported by fixtures only.
"""

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch.convert import (flax_to_state_dict,
                                             state_dict_to_flax)
from analytics_zoo_tpu_torch.learn import Estimator
from analytics_zoo_tpu_torch.learn import estimator as est_lib
from analytics_zoo_tpu_torch.text import (BERTNER, BERTSQuAD, BertConfig,
                                          BertModule, init_bert_weights)
from analytics_zoo_tpu_torch.text import bert as bert_lib
from analytics_zoo_tpu_torch.text.estimators import (_ClassifierModule,
                                                     _ner_loss, _squad_loss)

SMALL = dict(vocab=100, hidden_size=64, n_block=2, n_head=4,
             intermediate_size=128, max_position_len=32, hidden_drop=0.0,
             attn_drop=0.0)
REMAT = dict(vocab=100, hidden_size=32, n_block=2, n_head=2,
             intermediate_size=64, max_position_len=16, hidden_drop=0.0,
             attn_drop=0.0)
LENGTH = 16


@pytest.fixture(autouse=True)
def _one_torch_thread(monkeypatch, tmp_path):
    monkeypatch.setattr(est_lib, "DEFAULT_LOG_DIR", str(tmp_path / "logs"))
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from analytics_zoo_tpu.text import estimators as jtext
    from analytics_zoo_tpu.text.bert import BertConfig as JConfig
    from analytics_zoo_tpu.text.bert import BertModule as JBertModule
    return dict(jax=jax, jnp=jnp, text=jtext, Config=JConfig,
                BertModule=JBertModule)


def _inputs(n, seed):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, 100, (n, LENGTH)).astype(np.int32)
    seg = (np.arange(LENGTH)[None] >= rng.randint(2, LENGTH, (n, 1))
           ).astype(np.int32)
    mask = (np.arange(LENGTH)[None] < rng.randint(6, LENGTH + 1, (n, 1))
            ).astype(np.int32)
    return ids, seg, mask


def _labels(task, ids, seed):
    rng = np.random.RandomState(seed)
    if task == "ner":
        return (ids % 3).astype(np.int32)
    return np.sort(rng.randint(0, LENGTH, (len(ids), 2)), 1).astype(np.int32)


# ------------------------------------------------------------- losses

def test_task_losses_match_jax(jx):
    rng = np.random.RandomState(0)
    logits = rng.randn(4, 8, 3).astype(np.float32)
    labels = rng.randint(0, 3, (4, 8))
    labels[:, 6:] = -1
    labels[0, :] = -1                   # a row with no labelled token
    got = _ner_loss(torch.from_numpy(labels), torch.from_numpy(logits))
    want = np.asarray(jx["text"]._ner_loss(labels, logits))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    start, end = rng.randn(5, 8).astype(np.float32), \
        rng.randn(5, 8).astype(np.float32)
    pos = rng.randint(0, 8, (5, 2)).astype(np.int32)
    got = _squad_loss(torch.from_numpy(pos),
                      (torch.from_numpy(start), torch.from_numpy(end)))
    want = np.asarray(jx["text"]._squad_loss(pos, (start, end)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_ner_loss_ignores_padding():
    rng = np.random.RandomState(0)
    logits = torch.from_numpy(rng.randn(4, 8, 3).astype(np.float32))
    labels = rng.randint(0, 3, (4, 8))
    masked = labels.copy()
    masked[:, 6:] = -1
    garbage = labels.copy()
    garbage[:, 6:] = -7
    l1 = _ner_loss(torch.from_numpy(masked), logits)
    assert torch.equal(l1, _ner_loss(torch.from_numpy(garbage), logits))
    assert float((l1 - _ner_loss(torch.from_numpy(labels), logits)
                  ).abs().max()) > 1e-6
    assert torch.equal(torch.from_numpy(BERTNER._masked(
        labels, (np.arange(8) < 6)[None].repeat(4, 0).astype(np.int32))),
        torch.from_numpy(masked))


# ------------------------------------------------------------- the fits

def _pair(jx, task):
    cls = {"ner": (jx["text"].BERTNER, BERTNER),
           "squad": (jx["text"].BERTSQuAD, BERTSQuAD)}[task]
    args = (3,) if task == "ner" else ()
    jest = cls[0](*args, config=jx["Config"](**SMALL), seq_len=LENGTH)
    test = cls[1](*args, config=BertConfig(**SMALL), seq_len=LENGTH,
                  device="cpu")
    test.estimator.model.load_state_dict(
        flax_to_state_dict(jest.estimator.adapter.params))
    return jest, test


def _as_np(out):
    return tuple(np.asarray(o) for o in out) if isinstance(out, tuple) \
        else np.asarray(out)


@pytest.fixture(scope="module")
def jax_fits(jx, tmp_path_factory):
    """Per task: JAX's estimator after a fit, its history, evaluation and
    predictions, and where it saved itself."""
    out = {}
    for task in ("ner", "squad"):
        jest, _ = _pair(jx, task)
        ids, seg, mask = _inputs(24, 8)
        hist = jest.fit(ids, _labels(task, ids, 1), token_type_ids=seg,
                        input_mask=mask, epochs=1, batch_size=8)
        ide, sege, maske = _inputs(11, 10)
        ev = jest.evaluate(ide, _labels(task, ide, 2), token_type_ids=sege,
                           input_mask=maske, batch_size=8)
        pred = _as_np(jest.predict(ide, sege, maske, batch_size=8))
        path = str(tmp_path_factory.mktemp(task) / "j")
        jest.save(path)
        out[task] = dict(est=jest, hist=hist, ev=ev, pred=pred, path=path)
    return out


@pytest.mark.parametrize("task", ["ner", "squad"])
def test_task_fit_evaluate_predict_match_jax(jx, jax_fits, task):
    rec = jax_fits[task]
    _, test = _pair(jx, task)
    ids, seg, mask = _inputs(24, 8)
    got = test.fit(ids, _labels(task, ids, 1), token_type_ids=seg,
                   input_mask=mask, epochs=1, batch_size=8)
    np.testing.assert_allclose(got["loss"], rec["hist"]["loss"], rtol=1e-5)
    ide, sege, maske = _inputs(11, 10)
    ev = test.evaluate(ide, _labels(task, ide, 2), token_type_ids=sege,
                       input_mask=maske, batch_size=8)
    np.testing.assert_allclose(ev["loss"], rec["ev"]["loss"], rtol=1e-5)
    pred = test.predict(ide, sege, maske, batch_size=8)
    if task == "ner":
        assert pred.shape == (11, LENGTH, 3)
        np.testing.assert_allclose(pred, rec["pred"], rtol=0, atol=1e-5)
    else:
        # the qa bias takes no gradient in exact arithmetic (a shift of a
        # row's logits leaves its softmax alone), so Adam's steps on it
        # follow rounding noise: each row is held up to its mean, and the
        # raw logits within Adam's step bound (2 lr a step, 3 steps)
        assert isinstance(pred, tuple) and len(pred) == 2
        for p, w in zip(pred, rec["pred"]):
            assert p.shape == (11, LENGTH)
            np.testing.assert_allclose(p - p.mean(-1, keepdims=True),
                                       w - w.mean(-1, keepdims=True),
                                       rtol=0, atol=1e-5)
            np.testing.assert_allclose(p, w, rtol=0, atol=2 * 1e-3 * 3)


@pytest.mark.parametrize("task", ["ner", "squad"])
def test_task_save_load_cross_packages(jx, jax_fits, task, tmp_path):
    rec = jax_fits[task]
    ide, sege, maske = _inputs(11, 10)
    # JAX's save in the port
    _, test = _pair(jx, task)
    test.load(rec["path"])
    got = _as_np(test.predict(ide, sege, maske, batch_size=8))
    for g, w in zip(got if task == "squad" else (got,),
                    rec["pred"] if task == "squad" else (rec["pred"],)):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)
    # the port's save in JAX
    ids, seg, mask = _inputs(16, 3)
    test.fit(ids, _labels(task, ids, 4), token_type_ids=seg,
             input_mask=mask, epochs=1, batch_size=8)
    want = _as_np(test.predict(ide, sege, maske, batch_size=8))
    test.save(str(tmp_path / "t"))
    jest, _ = _pair(jx, task)
    jest.load(str(tmp_path / "t"))
    got = _as_np(jest.predict(ide, sege, maske, batch_size=8))
    for g, w in zip(got if task == "squad" else (got,),
                    want if task == "squad" else (want,)):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)


# ------------------------------------------------------------- remat

def _pooled_and_grads(module, ids, train=False):
    _, pooled = module(torch.from_numpy(ids), train=train)
    loss = torch.sum(pooled ** 2)
    names = [n for n, _ in module.named_parameters()]
    grads = torch.autograd.grad(loss, list(module.parameters()))
    return pooled.detach(), dict(zip(names, grads))


def test_remat_matches_plain_and_jax(jx):
    jax, jnp = jx["jax"], jx["jnp"]
    ids = np.random.RandomState(0).randint(0, 100, (2, 16)).astype(np.int32)
    jremat = jx["BertModule"](jx["Config"](**REMAT, remat=True))
    variables = jremat.init({"params": jax.random.PRNGKey(0),
                             "dropout": jax.random.PRNGKey(1)}, ids)
    jpooled = np.asarray(jremat.apply(variables, ids)[1])
    jgrads = jax.device_get(jax.grad(
        lambda v: jnp.sum(jremat.apply(v, ids)[1] ** 2))(variables)
    )["params"]
    state = flax_to_state_dict(jax.device_get(variables["params"]))
    plain = BertModule(BertConfig(**REMAT))
    remat = BertModule(BertConfig(**REMAT, remat=True))
    plain.load_state_dict(state)
    remat.load_state_dict(state)
    p_plain, g_plain = _pooled_and_grads(plain, ids)
    p_remat, g_remat = _pooled_and_grads(remat, ids)
    np.testing.assert_allclose(p_remat.numpy(), p_plain.numpy(), atol=1e-6)
    np.testing.assert_allclose(p_remat.numpy(), jpooled, atol=1e-6)
    for n, g in g_plain.items():
        np.testing.assert_allclose(g_remat[n].numpy(), g.numpy(), atol=1e-5)
    got = state_dict_to_flax(g_remat, jgrads)

    def leaves(tree, path=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, f"{path}/{k}")
        else:
            yield path, np.asarray(tree)

    have = dict(leaves(got))
    for path, want in leaves(jgrads):
        np.testing.assert_allclose(have[path], want, atol=1e-5,
                                   err_msg=path)


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_remat_step_replays_dropout_bitwise(dtype):
    """An estimator step (dropout drawn under the step's seed, inside
    fork_rng) with remat equals the step without, through the flash path
    (use_flash=True; its plain version on the CPU) and in bf16."""
    cfg = dict(SMALL, hidden_drop=0.1, attn_drop=0.1, use_flash=True,
               dtype=dtype)
    ids = np.random.RandomState(3).randint(0, 100, (8, LENGTH)).astype(
        np.int32)
    labels = (ids[:, 0] % 2).astype(np.int32)
    out = []
    for remat in (False, True):
        module = init_bert_weights(_ClassifierModule(
            BertConfig(remat=remat, **cfg), 2), seed=0)
        est = Estimator.from_torch(
            model=module, loss="sparse_categorical_crossentropy_logits",
            optimizer="adam", device="cpu")
        est._py_step = 7
        loss, grads = est._loss_and_grads(ids, labels)
        hist = est.fit((ids, labels), epochs=1, batch_size=4)
        out.append((loss, grads, hist, [p.detach().clone()
                                        for p in module.parameters()]))
    (l0, g0, h0, p0), (l1, g1, h1, p1) = out
    assert torch.equal(l0, l1) and h0 == h1
    for a, b in zip(g0 + p0, g1 + p1):
        assert torch.equal(a, b)


def test_remat_saves_less_and_keeps_the_products():
    ids = torch.from_numpy(np.random.RandomState(1).randint(
        0, 100, (4, LENGTH)).astype(np.int32))

    def saved_bytes(remat):
        module = init_bert_weights(BertModule(BertConfig(
            remat=remat, **dict(SMALL, use_flash=False))), seed=0)
        total = [0]

        def pack(t):
            total[0] += t.numel() * t.element_size()
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            _, pooled = module(ids, train=True)
        return total[0]

    assert saved_bytes(True) < 0.7 * saved_bytes(False)
    aten = torch.ops.aten
    policy = bert_lib.CheckpointPolicy
    for op in (aten.addmm.default, aten.mm.default):
        assert bert_lib._remat_policy(None, op) == policy.MUST_SAVE
    for op in (aten.bmm.default, aten.gelu.default,
               aten.native_layer_norm.default, aten._to_copy.default,
               aten.empty.memory_format):
        assert bert_lib._remat_policy(None, op) == policy.PREFER_RECOMPUTE
