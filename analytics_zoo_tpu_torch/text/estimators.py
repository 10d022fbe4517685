"""BERT task heads — classification, NER, SQuAD.

Counterpart of the head modules of ``analytics_zoo_tpu/text/estimators.py``
(ref pyzoo/zoo/tfpark/text/estimator/: ``BERTClassifier``, ``BERTNER``,
``BERTSQuAD``): each is a ``BertModule`` named ``bert`` plus one dense
head under the flax tree's name. Inputs are ``(input_ids,
token_type_ids, input_mask)`` of shape [b, L]; the last two may be left
out (zeros and no mask). The estimators that fit and evaluate these heads
wait for the training slice.
"""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from analytics_zoo_tpu_torch.common.flax_compat import Dense
from analytics_zoo_tpu_torch.text.bert import BertConfig, BertModule


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
