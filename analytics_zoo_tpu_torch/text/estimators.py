"""BERT task heads and estimators — classification, NER, SQuAD.

Counterpart of ``analytics_zoo_tpu/text/estimators.py`` (ref
pyzoo/zoo/tfpark/text/estimator/: ``BERTClassifier``, ``BERTNER``,
``BERTSQuAD``). The head modules are each a ``BertModule`` named ``bert``
plus one dense head under the flax tree's name. Inputs are ``(input_ids,
token_type_ids, input_mask)`` of shape [b, L]; the last two may be left
out of a module call (zeros and no mask).

``BERTClassifier``, ``BERTNER`` and ``BERTSQuAD`` fit, evaluate and
predict their heads through ``learn/estimator.py``'s ``TorchEstimator``.
Like the JAX estimators they fill a missing ``input_mask`` with ones and
pass it on, so their attention is the masked einsum chain under autograd
and never the flash kernels (ROADMAP C5). ``BERTNER`` trains on
``_ner_loss`` (per-token cross-entropy over the labels that are not -1;
``fit`` and ``evaluate`` write -1 where ``input_mask`` is 0) and
``BERTSQuAD`` on ``_squad_loss`` (the mean of the start and end
positions' cross-entropies); its ``predict`` returns ``(start, end)``
logits. ``save``/``load`` write and read the JAX package's layout
(``<path>/ckpt-<step>/``, the flax BERT tree with its ``[in, h, d]``
attention projections, the heads under flax's ``classifier``, ``ner``
and ``qa``), so an estimator saved by either package loads in the
other. Under a strategy with ``tp`` the estimator trains with
``bert_tp_rules()``, as JAX's does.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from analytics_zoo_tpu_torch.common.device import DeviceLike
from analytics_zoo_tpu_torch.common.flax_compat import Dense
from analytics_zoo_tpu_torch.learn.estimator import Estimator, TorchEstimator
from analytics_zoo_tpu_torch.learn.losses import _take_label, logsumexp
from analytics_zoo_tpu_torch.text.bert import (BertConfig, BertModule,
                                               bert_tp_rules,
                                               init_bert_weights)


class _BertHead(nn.Module):
    def __init__(self, config: BertConfig):
        super().__init__()
        self.config = config
        self.bert = BertModule(config)

    def _drop(self, x, train: bool):
        p = self.config.hidden_drop
        return F.dropout(x, p, training=train) if p > 0 else x


class _ClassifierModule(_BertHead):
    """Pooled [CLS] -> ``classifier`` Dense(n_classes) logits."""

    def __init__(self, config: BertConfig, n_classes: int):
        super().__init__(config)
        self.classifier = Dense(config.hidden_size, n_classes)

    def forward(self, input_ids, token_type_ids=None, input_mask=None,
                train: bool = False):
        _, pooled = self.bert(input_ids, token_type_ids, input_mask,
                              train=train)
        return self.classifier(self._drop(pooled, train))


class _NERModule(_BertHead):
    """Sequence -> ``ner`` Dense(n_entities) logits per token."""

    def __init__(self, config: BertConfig, n_entities: int):
        super().__init__(config)
        self.ner = Dense(config.hidden_size, n_entities)

    def forward(self, input_ids, token_type_ids=None, input_mask=None,
                train: bool = False):
        seq, _ = self.bert(input_ids, token_type_ids, input_mask,
                           train=train)
        return self.ner(self._drop(seq, train))


class _SQuADModule(_BertHead):
    """Sequence -> ``qa`` Dense(2) -> (start, end) logits [b, L]."""

    def __init__(self, config: BertConfig):
        super().__init__(config)
        self.qa = Dense(config.hidden_size, 2)

    def forward(self, input_ids, token_type_ids=None, input_mask=None,
                train: bool = False):
        seq, _ = self.bert(input_ids, token_type_ids, input_mask,
                           train=train)
        logits = self.qa(seq)
        return logits[..., 0], logits[..., 1]


def _ner_loss(y_true, logits):
    """(JAX ``_ner_loss``) Per-token cross-entropy with the positions
    labelled below 0 left out (``BERTNER.fit`` writes -1 where the input
    mask is 0), the mean over each row's labelled tokens."""
    y = torch.as_tensor(y_true, device=logits.device).to(torch.int32)
    logp = logits - logsumexp(logits)
    ce = -_take_label(logp, torch.clamp(y, min=0))
    valid = (y >= 0).to(ce.dtype)
    return (ce * valid).sum(-1) / torch.clamp(valid.sum(-1), min=1.0)


def _squad_loss(y_true, preds):
    """(JAX ``_squad_loss``) ``y_true`` [b, 2] (start, end positions),
    ``preds`` the (start, end) logits, each [b, L]: the mean of the two
    cross-entropies."""
    start_logits, end_logits = preds
    y = torch.as_tensor(y_true, device=start_logits.device).to(torch.int32)

    def ce(logits, idx):
        return -_take_label(logits - logsumexp(logits), idx)

    return 0.5 * (ce(start_logits, y[:, 0]) + ce(end_logits, y[:, 1]))


class _BertTaskEstimator:
    """Shared surface (ref BERTBaseEstimator: fit/evaluate/predict over
    bert feature arrays). The head's weights are drawn from ``seed``
    (``init_bert_weights``)."""

    def __init__(self, module, loss, optimizer, metrics, config: BertConfig,
                 seq_len: int, model_dir, strategy, seed: int,
                 device: DeviceLike):
        from analytics_zoo_tpu_torch.parallel.strategy import (
            ShardingStrategy,
        )
        self.config = config
        self.seq_len = seq_len
        # JAX's text/estimators.py: the encoder's tensor-parallel rules
        # whenever the strategy uses tp
        rules = (bert_tp_rules()
                 if "tp" in ShardingStrategy.parse(strategy).uses else None)
        self.estimator: TorchEstimator = Estimator.from_torch(
            model=init_bert_weights(module, seed), loss=loss,
            optimizer=optimizer, metrics=metrics, model_dir=model_dir,
            strategy=strategy, param_rules=rules, seed=seed, device=device)

    @staticmethod
    def _xy(input_ids, token_type_ids=None, input_mask=None, labels=None):
        ids = np.asarray(input_ids)
        seg = (np.zeros_like(ids) if token_type_ids is None
               else np.asarray(token_type_ids))
        msk = (np.ones_like(ids) if input_mask is None
               else np.asarray(input_mask))
        x = (ids, seg, msk)
        return x if labels is None else (x, np.asarray(labels))

    def fit(self, input_ids, labels, token_type_ids=None, input_mask=None,
            epochs: int = 1, batch_size: int = 32, **kw):
        data = self._xy(input_ids, token_type_ids, input_mask, labels)
        return self.estimator.fit(data, epochs=epochs,
                                  batch_size=batch_size, **kw)

    def evaluate(self, input_ids, labels, token_type_ids=None,
                 input_mask=None, batch_size: int = 32):
        data = self._xy(input_ids, token_type_ids, input_mask, labels)
        return self.estimator.evaluate(data, batch_size=batch_size)

    def predict(self, input_ids, token_type_ids=None, input_mask=None,
                batch_size: int = 32):
        x = self._xy(input_ids, token_type_ids, input_mask)
        # TorchEstimator.predict treats a tuple as multi-input features
        return self.estimator.predict(x, batch_size=batch_size)

    def save(self, path: str):
        """Weights and optimizer state into ``path/ckpt-<step>/``."""
        return self.estimator.save(path)

    def load(self, path: str):
        """Restore what ``save`` (of either package) wrote."""
        self.estimator.load(path)
        return self

    def load_hf(self, state_dict_or_path):
        """Initialise the encoder from a HuggingFace-format BERT checkpoint
        (a state dict, a live ``transformers`` module, or a ``torch.save``
        path) through ``hf_import.load_hf_bert``: the task head keeps its
        weights, the optimizer state, step and epoch restart. Fine-tune
        as usual afterwards."""
        from analytics_zoo_tpu_torch.text.hf_import import load_hf_bert
        load_hf_bert(self, state_dict_or_path)
        return self


class BERTClassifier(_BertTaskEstimator):
    """Sequence classification on the pooled output (ref
    tfpark/text/estimator BERTClassifier)."""

    def __init__(self, num_classes: int, config: Optional[BertConfig] = None,
                 seq_len: int = 128, optimizer="adam", metrics=None,
                 model_dir=None, strategy="dp", seed: int = 0,
                 device: DeviceLike = None):
        config = config or BertConfig()
        super().__init__(
            _ClassifierModule(config, num_classes),
            "sparse_categorical_crossentropy_logits", optimizer, metrics,
            config, seq_len, model_dir, strategy, seed, device)


class BERTNER(_BertTaskEstimator):
    """Token-level entity tagging on the sequence output (ref
    tfpark/text/estimator BERTNER). Padded positions (input_mask 0) are
    left out of the loss through -1 labels."""

    def __init__(self, num_entities: int, config: Optional[BertConfig] = None,
                 seq_len: int = 128, optimizer="adam", metrics=None,
                 model_dir=None, strategy="dp", seed: int = 0,
                 device: DeviceLike = None):
        config = config or BertConfig()
        super().__init__(
            _NERModule(config, num_entities), _ner_loss, optimizer, metrics,
            config, seq_len, model_dir, strategy, seed, device)

    @staticmethod
    def _masked(labels, input_mask):
        if input_mask is None:
            return labels
        return np.where(np.asarray(input_mask) > 0, np.asarray(labels), -1)

    def fit(self, input_ids, labels, token_type_ids=None, input_mask=None,
            epochs: int = 1, batch_size: int = 32, **kw):
        return super().fit(input_ids, self._masked(labels, input_mask),
                           token_type_ids, input_mask, epochs=epochs,
                           batch_size=batch_size, **kw)

    def evaluate(self, input_ids, labels, token_type_ids=None,
                 input_mask=None, batch_size: int = 32):
        return super().evaluate(input_ids, self._masked(labels, input_mask),
                                token_type_ids, input_mask,
                                batch_size=batch_size)


class BERTSQuAD(_BertTaskEstimator):
    """Extractive QA: start and end logits a position (ref
    tfpark/text/estimator BERTSQuAD); ``predict`` returns ``(start,
    end)``, each [n, L]."""

    def __init__(self, config: Optional[BertConfig] = None,
                 seq_len: int = 128, optimizer="adam", metrics=None,
                 model_dir=None, strategy="dp", seed: int = 0,
                 device: DeviceLike = None):
        config = config or BertConfig()
        super().__init__(
            _SQuADModule(config), _squad_loss, optimizer, metrics, config,
            seq_len, model_dir, strategy, seed, device)
