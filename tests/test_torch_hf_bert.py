"""HuggingFace BERT weights into the port with no JAX: ``hf_bert_params``
against the real ``transformers.BertModel`` (randomly initialised from a
config, no download), including a ragged attention mask. Sequence outputs
at the valid positions and pooled outputs agree within atol 2e-5 (fp32,
two implementations of the same sums)."""

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from analytics_zoo_tpu_torch.text import (BertConfig, BertModule,  # noqa: E402
                                          hf_bert_params)

SMALL = dict(vocab=97, hidden_size=32, n_block=2, n_head=2,
             intermediate_size=64, max_position_len=48)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _hf_model():
    cfg = transformers.BertConfig(
        vocab_size=SMALL["vocab"], hidden_size=SMALL["hidden_size"],
        num_hidden_layers=SMALL["n_block"],
        num_attention_heads=SMALL["n_head"],
        intermediate_size=SMALL["intermediate_size"],
        max_position_embeddings=SMALL["max_position_len"],
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
        hidden_act="gelu", attn_implementation="eager")
    torch.manual_seed(0)
    return transformers.BertModel(cfg).eval()


def _port(sd, use_flash=None):
    cfg = BertConfig(hidden_drop=0.0, attn_drop=0.0, use_flash=use_flash,
                     **SMALL)
    module = BertModule(cfg)
    module.load_state_dict(hf_bert_params(sd, cfg))
    return module.eval()


@pytest.mark.parametrize("use_flash", [None, True])
def test_sequence_and_pooled_match_transformers(use_flash):
    hf = _hf_model()
    module = _port(hf, use_flash)
    rng = np.random.RandomState(0)
    ids = torch.from_numpy(rng.randint(0, SMALL["vocab"], (2, 16)))
    seg = torch.from_numpy((rng.rand(2, 16) < 0.5).astype(np.int64))
    mask = torch.ones((2, 16), dtype=torch.int64)
    mask[0, 11:] = 0                        # padded tails
    mask[1, 14:] = 0
    with torch.no_grad():
        seq, pooled = module(ids, seg, mask)
        want = hf(input_ids=ids, token_type_ids=seg, attention_mask=mask)
    # compare the valid positions: HF masks keys, not queries
    for b in range(2):
        n = int(mask[b].sum())
        torch.testing.assert_close(seq[b, :n], want.last_hidden_state[b, :n],
                                   rtol=0, atol=2e-5)
    torch.testing.assert_close(pooled, want.pooler_output, rtol=0,
                               atol=2e-5)
    # no mask: the flash path when asked (blockwise on the CPU)
    with torch.no_grad():
        seq, _ = module(ids, seg)
        want = hf(input_ids=ids, token_type_ids=seg)
    torch.testing.assert_close(seq, want.last_hidden_state, rtol=0,
                               atol=2e-5)


def test_bert_for_classification_dict_accepted():
    """BertFor* dicts (keys under 'bert.', extra head keys) load too."""
    hf = _hf_model()
    sd = {"bert." + k: v for k, v in hf.state_dict().items()}
    sd["classifier.weight"] = torch.zeros(2, 32)
    got = hf_bert_params(sd, BertConfig(**SMALL))
    torch.testing.assert_close(got["word_embeddings.embedding"],
                               hf.embeddings.word_embeddings.weight,
                               rtol=0, atol=0)
    assert set(got) == set(BertModule(BertConfig(**SMALL)).state_dict())


# ------------------------------------------------ load_hf_bert and C19
#
# The task estimators' ``load_hf`` against the JAX package's from the same
# parameters (JAX's initial tree through ``convert``): the encoder takes
# the source tensors bitwise, the head keeps its weights, a wrong config
# raises the port's ValueError ("config mismatch?", JAX's text; JAX's own
# can raise its reshape's first) and a wrong key a KeyError. C19: a fit
# of 2 steps, ``load_hf``, a fit of 2 more; the
# losses within rtol 1e-5 and every parameter within 1e-5 of JAX's
# (Adam, dropout off), and the host step and epoch restart at 0 as JAX's
# do, so the second fit's dropout seeds and snapshot steps are a fresh
# fit's.

def _zoo_config(cfg_cls, **over):
    return cfg_cls(hidden_drop=0.0, attn_drop=0.0, **{**SMALL, **over})


@pytest.fixture(scope="module")
def jtext():
    pytest.importorskip("jax")
    import jax
    from analytics_zoo_tpu.text import estimators
    from analytics_zoo_tpu.text.bert import BertConfig as JConfig
    return dict(jax=jax, BERTClassifier=estimators.BERTClassifier,
                Config=JConfig)


def _clf_pair(jtext):
    from analytics_zoo_tpu_torch.convert import flax_to_state_dict
    from analytics_zoo_tpu_torch.text import BERTClassifier
    jclf = jtext["BERTClassifier"](num_classes=3,
                                   config=_zoo_config(jtext["Config"]),
                                   seq_len=16)
    tclf = BERTClassifier(num_classes=3, config=_zoo_config(BertConfig),
                          seq_len=16, device="cpu")
    tclf.estimator.model.load_state_dict(flax_to_state_dict(
        jtext["jax"].device_get(jclf.estimator.adapter.params)))
    return jclf, tclf


def _clf_data(n, seed):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, SMALL["vocab"], (n, 16)).astype(np.int32)
    return ids, rng.randint(0, 3, n).astype(np.int32)


def test_task_load_hf_matches_jax(jtext):
    from analytics_zoo_tpu_torch.text import BERTClassifier, load_hf_bert
    hf = _hf_model()
    sd = hf.state_dict()
    jclf, tclf = _clf_pair(jtext)
    head = {k: v.clone() for k, v in
            tclf.estimator.model.state_dict().items()
            if not k.startswith("bert.")}
    jclf.load_hf(sd)
    assert tclf.load_hf(sd) is tclf
    got = tclf.estimator.model.state_dict()
    for k, v in hf_bert_params(sd, BertConfig(**SMALL)).items():
        assert torch.equal(got[f"bert.{k}"], v), k
    assert torch.equal(got["bert.word_embeddings.embedding"],
                       sd["embeddings.word_embeddings.weight"])
    for k, v in head.items():
        assert torch.equal(got[k], v), k
    ids, _ = _clf_data(4, 0)
    np.testing.assert_allclose(tclf.predict(ids),
                               np.asarray(jclf.predict(ids)), rtol=0,
                               atol=1e-5)
    # a config that does not fit the checkpoint raises before any write
    wrong = BERTClassifier(num_classes=3, seq_len=16, device="cpu",
                           config=_zoo_config(BertConfig, hidden_size=16))
    before = {k: v.clone() for k, v in
              wrong.estimator.model.state_dict().items()}
    with pytest.raises(ValueError, match="config mismatch"):
        wrong.load_hf(sd)
    for k, v in wrong.estimator.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    jwrong = jtext["BERTClassifier"](
        num_classes=3, seq_len=16,
        config=_zoo_config(jtext["Config"], hidden_size=16))
    with pytest.raises(ValueError, match="config mismatch|shape"):
        jwrong.load_hf(sd)
    with pytest.raises(KeyError, match="encoder"):
        load_hf_bert(tclf, sd, bert_key="encoder")


def test_c19_fit_load_hf_fit_matches_jax(jtext, tmp_path, monkeypatch):
    from analytics_zoo_tpu_torch.convert import state_dict_to_flax
    from analytics_zoo_tpu_torch.learn import estimator as est_mod
    monkeypatch.setattr(est_mod, "DEFAULT_LOG_DIR", str(tmp_path))
    sd = _hf_model().state_dict()
    jclf, tclf = _clf_pair(jtext)
    ids, labels = _clf_data(16, 1)
    losses = []
    for clf in (jclf, tclf):
        first = clf.fit(ids, labels, epochs=1, batch_size=8)
        clf.load_hf(sd)
        assert (clf.estimator._py_step, clf.estimator._epoch) == (0, 0)
        if clf is jclf:
            # JAX's fit does not rebuild the state load_hf dropped (its
            # predict and evaluate do): ROADMAP C19
            clf.estimator._init_state()
        second = clf.fit(ids, labels, epochs=1, batch_size=8)
        losses.append((first["loss"], second["loss"]))
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-5)
    assert (tclf.estimator._py_step, tclf.estimator._epoch) == \
        (jclf.estimator._py_step, jclf.estimator._epoch) == (2, 1)
    jparams = jtext["jax"].device_get(jclf.estimator._state["params"])
    mine = state_dict_to_flax(tclf.estimator.model.state_dict(), jparams)

    def leaves(tree, path=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, f"{path}/{k}")
            else:
                yield f"{path}/{k}", np.asarray(v)
    got = dict(leaves(mine))
    for path, want in leaves(jparams):
        np.testing.assert_allclose(got[path], want, rtol=0, atol=1e-5,
                                   err_msg=path)
