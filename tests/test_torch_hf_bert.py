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
