"""Text models: BERT and the GPT-style transformer (serving side).

Counterpart of ``analytics_zoo_tpu.text``; the ``BERTClassifier`` /
``BERTNER`` / ``BERTSQuAD`` estimators wait for the training slice.
"""

from analytics_zoo_tpu_torch.text.bert import (
    BertConfig, BertModule, EncoderBlock, TransformerModule,
    init_bert_weights,
)
from analytics_zoo_tpu_torch.text.hf_import import hf_bert_params

__all__ = ["BertConfig", "BertModule", "EncoderBlock", "TransformerModule",
           "hf_bert_params", "init_bert_weights"]
