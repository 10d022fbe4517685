"""TextClassifier — word embedding, a CNN, LSTM or GRU encoder and a
softmax head.

Counterpart of
``analytics_zoo_tpu/models/textclassification/text_classifier.py`` (ref
``pyzoo/zoo/models/textclassification/text_classifier.py`` and Scala
``TextClassifier.scala``): the same layers and names (``word_embedding``,
``conv1d_1``, ``dense_1``, ``dense_2``; the recurrent encoders' cells
``OptimizedLSTMCell_0`` / ``GRUCell_0``, as flax names them), so
parameters cross
packages through ``convert.py``. The reference reads GloVe into the
embedding table; here pass ``vocab_size`` and ``token_length`` and
install pretrained vectors afterwards (``models/migration.py``, or
``assign_layer_params``). Built under ``mixed_bfloat16`` the recurrent
encoders compute as flax's cells do (keras/layers.py).
"""

from __future__ import annotations

from analytics_zoo_tpu_torch.keras import Input, Model
from analytics_zoo_tpu_torch.keras import layers as zl
from analytics_zoo_tpu_torch.models.common import ZooModel, registry


@registry.register
class TextClassifier(ZooModel):
    """(ref text_classifier.py TextClassifier(class_num, embedding,
    sequence_length=500, encoder="cnn", encoder_output_dim=256))"""

    def __init__(self, class_num: int, vocab_size: int,
                 token_length: int = 200, sequence_length: int = 500,
                 encoder: str = "cnn", encoder_output_dim: int = 256):
        super().__init__()
        if encoder.lower() not in ("cnn", "lstm", "gru"):
            raise ValueError(
                f"encoder must be cnn/lstm/gru, got {encoder!r} "
                "(ref TextClassifier.scala unsupported-encoder check)")
        self.class_num = int(class_num)
        self.vocab_size = int(vocab_size)
        self.token_length = int(token_length)
        self.sequence_length = int(sequence_length)
        self.encoder = encoder.lower()
        self.encoder_output_dim = int(encoder_output_dim)
        self.model = self.build_model()

    def build_model(self):
        inp = Input(shape=(self.sequence_length,))
        emb = zl.Embedding(self.vocab_size + 1, self.token_length,
                           name="word_embedding")(inp)
        if self.encoder == "cnn":
            # ref: Convolution1D(encoder_output_dim, 5) + global max pool
            h = zl.Conv1D(self.encoder_output_dim, 5,
                          activation="relu")(emb)
            h = zl.GlobalMaxPooling1D()(h)
        elif self.encoder == "lstm":
            h = zl.LSTM(self.encoder_output_dim)(emb)
        else:
            h = zl.GRU(self.encoder_output_dim)(emb)
        h = zl.Dropout(0.2)(h)
        h = zl.Dense(128, activation="relu")(h)
        out = zl.Dense(self.class_num, activation="softmax")(h)
        return Model(input=inp, output=out)

    def _config(self):
        return dict(class_num=self.class_num, vocab_size=self.vocab_size,
                    token_length=self.token_length,
                    sequence_length=self.sequence_length,
                    encoder=self.encoder,
                    encoder_output_dim=self.encoder_output_dim)
