"""Text models: BERT and the GPT-style transformer, and BERTClassifier.

Counterpart of ``analytics_zoo_tpu.text``; the ``BERTNER`` and
``BERTSQuAD`` estimators are not ported yet (their head modules are).
"""

from analytics_zoo_tpu_torch.text.bert import (
    BertConfig, BertModule, EncoderBlock, TransformerModule,
    init_bert_weights,
)
from analytics_zoo_tpu_torch.text.estimators import BERTClassifier
from analytics_zoo_tpu_torch.text.hf_import import hf_bert_params

__all__ = ["BERTClassifier", "BertConfig", "BertModule", "EncoderBlock",
           "TransformerModule", "hf_bert_params", "init_bert_weights"]
