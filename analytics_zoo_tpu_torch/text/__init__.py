"""Text models: BERT and the GPT-style transformer, and the BERT task
estimators ``BERTClassifier``, ``BERTNER`` and ``BERTSQuAD``.

Counterpart of ``analytics_zoo_tpu.text``.
"""

from analytics_zoo_tpu_torch.text.bert import (
    BertConfig, BertModule, EncoderBlock, TransformerModule,
    init_bert_weights,
)
from analytics_zoo_tpu_torch.text.estimators import (
    BERTNER, BERTClassifier, BERTSQuAD,
)
from analytics_zoo_tpu_torch.text.hf_import import (hf_bert_params,
                                                    load_hf_bert)

__all__ = ["BERTClassifier", "BERTNER", "BERTSQuAD", "BertConfig",
           "BertModule", "EncoderBlock", "TransformerModule",
           "hf_bert_params", "init_bert_weights", "load_hf_bert"]
