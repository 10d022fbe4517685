"""Seq2Seq — RNN encoder-decoder with a bridge.

Counterpart of ``analytics_zoo_tpu/models/seq2seq/seq2seq.py`` (ref Scala
``zoo/.../models/seq2seq/``). Same signature, same graph, same parameter
names: a multi-layer LSTM/GRU encoder, a dense ``bridge`` carrying its
last output into the decoder, a decoder that sees its teacher-forced input
concatenated with the bridged context at every step, and a
``TimeDistributed`` Dense head. ``fit`` trains teacher-forced on
``[encoder_input, decoder_input]`` and the targets, ``predict`` runs the
pair; ``infer`` generates autoregressively through
inference/generation.py.
"""

from __future__ import annotations

import numpy as np
import torch

from analytics_zoo_tpu_torch.common.device import DeviceLike
from analytics_zoo_tpu_torch.keras import Input, Model
from analytics_zoo_tpu_torch.keras import layers as zl
from analytics_zoo_tpu_torch.models.common import ZooModel, registry


@registry.register
class Seq2Seq(ZooModel):
    """(ref Seq2Seq.scala: Seq2Seq(encoder, decoder, inputShape,
    outputShape, bridge); here rnn_type/num_layers/hidden_size spell the
    encoder/decoder and ``bridge`` ∈ {"dense", None})"""

    def __init__(self, input_dim: int, output_dim: int, hidden_size: int = 64,
                 num_layers: int = 1, rnn_type: str = "lstm",
                 encoder_seq_len: int = 0, decoder_seq_len: int = 0,
                 bridge: str = "dense"):
        super().__init__()
        if rnn_type.lower() not in ("lstm", "gru"):
            raise ValueError(f"rnn_type must be lstm|gru, got {rnn_type!r}")
        self.input_dim = int(input_dim)
        self.output_dim = int(output_dim)
        self.hidden_size = int(hidden_size)
        self.num_layers = int(num_layers)
        self.rnn_type = rnn_type.lower()
        self.encoder_seq_len = int(encoder_seq_len)
        self.decoder_seq_len = int(decoder_seq_len)
        self.bridge = bridge
        self.model = self.build_model()

    def _rnn(self, units, return_sequences):
        cls = zl.LSTM if self.rnn_type == "lstm" else zl.GRU
        return cls(units, return_sequences=return_sequences)

    def build_model(self):
        enc_in = Input(shape=(self.encoder_seq_len or None, self.input_dim))
        dec_len = self.decoder_seq_len or None
        dec_in = Input(shape=(dec_len, self.output_dim))

        h = enc_in
        for _ in range(self.num_layers - 1):
            h = self._rnn(self.hidden_size, True)(h)
        context = self._rnn(self.hidden_size, False)(h)   # [b, H]
        if self.bridge == "dense":
            context = zl.Dense(self.hidden_size, activation="tanh",
                               name="bridge")(context)

        # the decoder sees its teacher-forced input + the bridged context
        # at every step
        rep = zl.Lambda(_repeat_like,
                        output_shape=(dec_len, self.hidden_size))(
            [context, dec_in])
        d = zl.merge([dec_in, rep], mode="concat", concat_axis=-1)
        for _ in range(self.num_layers):
            d = self._rnn(self.hidden_size, True)(d)
        out = zl.TimeDistributed(zl.Dense(self.output_dim))(d)
        return Model(input=[enc_in, dec_in], output=out)

    def fit(self, x, y=None, **kwargs):
        """``x``: the ``[enc_input, dec_input]`` pair (teacher forcing),
        ``y``: the targets; ``kwargs`` as ``KerasNet.fit`` takes them."""
        return self.model.fit(
            tuple(x) if isinstance(x, (list, tuple)) else x, y, **kwargs)

    def predict(self, x, **kwargs):
        """``x``: the ``[enc_input, dec_input]`` pair; ``kwargs`` as
        ``KerasNet.predict`` takes them."""
        return self.model.predict(
            tuple(x) if isinstance(x, (list, tuple)) else x, **kwargs)

    def infer(self, input_seq: np.ndarray, start_sign: np.ndarray,
              max_seq_len: int = 30, mode: str = "raw",
              temperature: float = 1.0, seed=None,
              device: DeviceLike = None) -> np.ndarray:
        """Autoregressive generation (ref Seq2Seq.infer): feed the decoder
        its own last prediction, the buffer riding the seq-length ladder
        (generation.decode_loop; bitwise the unpadded loop, as the decoder
        is causal in time). ``mode`` extends the reference's raw feedback
        with one-hot ``greedy``/``sample``."""
        from analytics_zoo_tpu_torch.inference import generation
        input_seq = np.asarray(input_seq)
        if max_seq_len <= 1:
            return np.zeros((input_seq.shape[0], 0, self.output_dim),
                            np.float32)
        return generation.decode_loop(
            lambda enc, dec: self.predict((enc, dec), device=device),
            input_seq, start_sign, int(max_seq_len) - 1,
            ladder=generation.seq_ladder(max_seq_len), mode=mode,
            temperature=temperature, seed=seed)

    def _config(self):
        return dict(input_dim=self.input_dim, output_dim=self.output_dim,
                    hidden_size=self.hidden_size, num_layers=self.num_layers,
                    rnn_type=self.rnn_type,
                    encoder_seq_len=self.encoder_seq_len,
                    decoder_seq_len=self.decoder_seq_len, bridge=self.bridge)


def _repeat_like(ctx: torch.Tensor, dec: torch.Tensor) -> torch.Tensor:
    """Tile [b, H] context across dec's time axis → [b, t_dec, H]."""
    return ctx[:, None, :].expand(-1, dec.shape[1], -1)
