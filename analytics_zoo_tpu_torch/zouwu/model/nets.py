"""Forecasting networks, trained through ``Estimator.from_torch``.

Counterpart of ``analytics_zoo_tpu/zouwu/model/nets.py:30-115``, with the
flax modules' parameter names (``convert.flax_layout`` gives the JAX
tree, so checkpoints cross packages):

- ``TemporalConvNet`` (ref ``pyzoo/zoo/zouwu/model/tcn.py:91``): blocks
  ``_TemporalBlock_<i>`` of two dilated causal convolutions (``Conv_0``,
  ``Conv_1``; each input first padded on the left by ``(k - 1) *
  dilation``, dilation ``2 ** i``), ReLU and dropout after each, a
  residual ``Dense_0`` only where the width changes, a ReLU over the
  sum; then a ``Dense_0`` head on the last step in fp32. Kernels start
  lecun-normal and biases at zero, as flax's do.
- ``VanillaLSTMNet``: stacked LSTMs (``OptimizedLSTMCell_<i>``, flax's
  cell and names, ``keras/layers.py``), dropout after each, a ``Dense_0``
  head on the last step.
- ``Seq2SeqNet``: an LSTM encoder, dropout on its last state, the state
  fed at every future step of an LSTM decoder, a ``Dense_0`` head.

- ``MTNetModule`` (ref ``MTNet_keras.py``; JAX nets.py:118-295): three
  encoders (``memory``, ``context``, ``query``), each a VALID ``Conv``
  over time (``<enc>_conv``), ReLU, dropout, then an attention-GRU stack
  (``<enc>_attgru``: ``W1``, ``b2`` and ``steps`` holding ``W2``, ``W3``,
  ``b3``, ``V`` and the cells ``gru_<i>``, where flax's ``nn.scan``
  broadcasts them); a softmax over the memories, a ``head`` Dense and the
  ``ar`` highway, in fp32. Its raw weights keep flax's names and shapes
  (``convert`` carries them as they are).

All take ``[batch, time, features]`` and give ``[batch, horizon]``;
``forward(x, train)`` applies dropout only with ``train=True``. ``dtype``
(e.g. ``torch.bfloat16``) is the compute dtype with fp32 parameters
(``keras/policy.py``); the heads stay fp32. The LSTMs take it as flax's
cells do (``keras/layers.py``): bf16 gates, an fp32 carry, fp32 outputs.
MTNet's attention GRUs follow JAX's module: their input and carry start
in the compute dtype (JAX makes the zero states in the input's dtype), so
under bf16 the whole recurrence is bf16 but the attention's softmax,
which is fp32.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from analytics_zoo_tpu_torch.common.flax_compat import Conv, Dense
from analytics_zoo_tpu_torch.keras.layers import (GRUCellModule,
                                                  OptimizedLSTMCellModule,
                                                  run_cell)

# the std of a standard normal truncated to [-2, 2] (flax's
# variance_scaling divides by it)
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(weight: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator] = None) -> None:
    """flax's ``lecun_normal``: a normal truncated to two deviations with
    variance ``1 / fan_in``."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std,
                              generator=generator)


def _flax_init(lin: nn.Module, fan_in: int,
               generator: Optional[torch.Generator]) -> nn.Module:
    lecun_normal_(lin.weight, fan_in, generator)
    if lin.bias is not None:
        with torch.no_grad():
            lin.bias.zero_()
    return lin


class _TemporalBlock(nn.Module):
    """Two dilated causal convolutions and the residual (JAX
    ``_TemporalBlock``, nets.py:76-97)."""

    def __init__(self, in_features: int, channels: int, kernel_size: int,
                 dilation: int, dropout: float,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.pad = (kernel_size - 1) * dilation
        self.dropout = float(dropout)
        self.Conv_0 = _flax_init(Conv(in_features, channels, kernel_size,
                                      dilation, dtype=dtype),
                                 kernel_size * in_features, generator)
        self.Conv_1 = _flax_init(Conv(channels, channels, kernel_size,
                                      dilation, dtype=dtype),
                                 kernel_size * channels, generator)
        if in_features != channels:
            self.Dense_0 = _flax_init(Dense(in_features, channels,
                                            dtype=dtype),
                                      in_features, generator)
        else:
            self.Dense_0 = None

    def forward(self, x, train: bool = False):
        y = x
        for conv in (self.Conv_0, self.Conv_1):
            y = conv(F.pad(y, (0, 0, self.pad, 0)))
            y = F.dropout(F.relu(y), self.dropout, training=train)
        res = x if self.Dense_0 is None else self.Dense_0(x)
        return F.relu(y + res.to(y.dtype))


class TemporalConvNet(nn.Module):
    """Dilated causal conv stack and a linear head (ref tcn.py:91; JAX
    nets.py:100-115). ``in_features`` is the input's last dimension."""

    def __init__(self, in_features: int, future_seq_len: int = 1,
                 num_channels: Sequence[int] = (30, 30, 30),
                 kernel_size: int = 7, dropout: float = 0.2,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        width = int(in_features)
        for i, ch in enumerate(num_channels):
            self.add_module(f"_TemporalBlock_{i}", _TemporalBlock(
                width, int(ch), kernel_size, 2 ** i, dropout, dtype,
                generator))
            width = int(ch)
        self.n_blocks = len(num_channels)
        self.Dense_0 = _flax_init(Dense(width, future_seq_len), width,
                                  generator)

    def forward(self, x, train: bool = False):
        for i in range(self.n_blocks):
            x = self._modules[f"_TemporalBlock_{i}"](x, train)
        return self.Dense_0(x[:, -1, :].float())


class VanillaLSTMNet(nn.Module):
    """Stacked LSTMs, dropout, a dense head on the last step (ref
    zouwu/model/VanillaLSTM.py; JAX nets.py:30-46)."""

    def __init__(self, in_features: int, output_dim: int = 1,
                 lstm_units: Sequence[int] = (32, 32),
                 dropouts: Sequence[float] = (0.2, 0.2),
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        width = int(in_features)
        self.dropouts = [float(dropouts[min(i, len(dropouts) - 1)])
                         for i in range(len(lstm_units))]
        for i, units in enumerate(lstm_units):
            self.add_module(f"OptimizedLSTMCell_{i}", OptimizedLSTMCellModule(
                width, int(units), torch.tanh, gen, dtype=dtype))
            width = int(units)
        self.n_layers = len(lstm_units)
        self.Dense_0 = _flax_init(Dense(width, output_dim), width, generator)

    def forward(self, x, train: bool = False):
        for i in range(self.n_layers):
            x = run_cell(self._modules[f"OptimizedLSTMCell_{i}"], x)
            if self.dropouts[i]:
                x = F.dropout(x, self.dropouts[i], training=train)
        return self.Dense_0(x[:, -1, :].float())


class Seq2SeqNet(nn.Module):
    """LSTM encoder-decoder emitting ``future_seq_len`` steps (ref
    zouwu/model/Seq2Seq.py; JAX nets.py:49-73): the encoder's last state,
    after dropout, is the decoder's input at every future step."""

    def __init__(self, in_features: int, future_seq_len: int = 1,
                 latent_dim: int = 64, dropout: float = 0.2,
                 output_dim: int = 1, dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        self.future_seq_len = int(future_seq_len)
        self.latent_dim = int(latent_dim)
        self.dropout = float(dropout)
        self.output_dim = int(output_dim)
        self.OptimizedLSTMCell_0 = OptimizedLSTMCellModule(
            int(in_features), self.latent_dim, torch.tanh, gen, dtype=dtype)
        self.OptimizedLSTMCell_1 = OptimizedLSTMCellModule(
            self.latent_dim, self.latent_dim, torch.tanh, gen, dtype=dtype)
        self.Dense_0 = _flax_init(Dense(self.latent_dim, self.output_dim),
                                  self.latent_dim, generator)

    def forward(self, x, train: bool = False):
        ctx = run_cell(self.OptimizedLSTMCell_0, x)[:, -1, :]
        if self.dropout:
            ctx = F.dropout(ctx, self.dropout, training=train)
        dec_in = ctx[:, None, :].expand(-1, self.future_seq_len, -1)
        dec = run_cell(self.OptimizedLSTMCell_1, dec_in)
        out = self.Dense_0(dec.float())
        return out[..., 0] if self.output_dim == 1 else out


def _trunc_normal(shape, generator: Optional[torch.Generator],
                  std: float = 0.1) -> nn.Parameter:
    """flax ``truncated_normal(stddev)``: ``std`` times a standard normal
    truncated to [-2, 2]."""
    t = torch.empty(shape)
    nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std,
                          generator=generator)
    return nn.Parameter(t)


def _gru_cell(in_features: int, features: int,
              generator: Optional[torch.Generator],
              dtype: Optional[torch.dtype]) -> GRUCellModule:
    """flax ``GRUCell``'s initial weights: lecun-normal input kernels,
    orthogonal recurrent kernels, zero biases."""
    gen = generator or torch.Generator().manual_seed(0)
    cell = GRUCellModule(in_features, features, torch.tanh, gen, dtype=dtype)
    with torch.no_grad():
        for name, _ in cell.INPUT:
            lecun_normal_(cell._modules[name].weight, in_features, gen)
        for name, _ in cell.RECURRENT:
            nn.init.orthogonal_(cell._modules[name].weight, generator=gen)
        for mod in cell.children():
            if mod.bias is not None:
                mod.bias.zero_()
    return cell


class _AttentionGRUStep(nn.Module):
    """One attention + stacked-GRU step (JAX ``_AttentionGRUStep``,
    nets.py:161-196); its weights are shared by every step, as flax's
    ``variable_broadcast="params"`` shares them:

        e  = tanh(X·W1 + b2 + (h·W2)[:, None]) · V        # [b, T, 1]
        a  = softmax_T(e)                                 # in fp32
        x~ = Σ_t a_t · X_t
        x' = [x_t ; x~] · W3 + b3
        h, states = stacked_GRU(x', states)
    """

    def __init__(self, d: int, hidden_sizes: Sequence[int],
                 dtype: Optional[torch.dtype],
                 generator: Optional[torch.Generator]):
        super().__init__()
        h_out = int(hidden_sizes[-1])
        self.W2 = _trunc_normal((h_out, d), generator)
        self.W3 = _trunc_normal((2 * d, d), generator)
        self.b3 = _trunc_normal((d,), generator)
        self.V = _trunc_normal((d, 1), generator)
        width = d
        for i, h in enumerate(hidden_sizes):
            self.add_module(f"gru_{i}", _gru_cell(width, int(h), generator,
                                                  dtype))
            width = int(h)
        self.n_cells = len(hidden_sizes)
        self.dtype = dtype

    def weights(self):
        """The step's weights in the compute dtype, and each cell's."""
        ws = (self.W2, self.W3, self.b3, self.V)
        if self.dtype is not None:
            ws = tuple(w.to(self.dtype) for w in ws)
        return ws, [self._modules[f"gru_{i}"].weights()
                    for i in range(self.n_cells)]

    def forward(self, states, x_t, x_all, xw1, weights):
        (w2, w3, b3, v), cell_ws = weights
        e = torch.tanh(xw1 + (states[-1] @ w2)[:, None, :]) @ v
        # the softmax over T in fp32, back in the compute dtype
        a = torch.softmax(e.float(), dim=1).to(e.dtype)
        x_weighted = torch.sum(a * x_all, dim=1)
        h = torch.cat([x_t, x_weighted], dim=-1) @ w3 + b3
        new_states = []
        for i, st in enumerate(states):
            h = self._modules[f"gru_{i}"].step(h, st, cell_ws[i])
            new_states.append(h)
        return new_states, h


class _AttentionGRU(nn.Module):
    """The reference's ``AttentionRNNWrapper`` around stacked GRU cells
    (ref MTNet_keras.py:51-231; JAX ``_AttentionGRU``, nets.py:118-158):
    ``X·W1 + b2`` once, then one ``_AttentionGRUStep`` per time step; the
    last step's output."""

    def __init__(self, d: int, hidden_sizes: Sequence[int],
                 dtype: Optional[torch.dtype],
                 generator: Optional[torch.Generator]):
        super().__init__()
        self.W1 = _trunc_normal((d, d), generator)
        self.b2 = _trunc_normal((d,), generator)
        self.steps = _AttentionGRUStep(d, hidden_sizes, dtype, generator)
        self.hidden_sizes = tuple(int(h) for h in hidden_sizes)
        self.dtype = dtype

    def forward(self, x):
        w1, b2 = self.W1, self.b2
        if self.dtype is not None:
            x = x.to(self.dtype)
            w1, b2 = w1.to(self.dtype), b2.to(self.dtype)
        states = [x.new_zeros((x.shape[0], h)) for h in self.hidden_sizes]
        xw1 = x @ w1 + b2                                   # [b, t, d]
        weights = self.steps.weights()
        h = None
        for t in range(x.shape[1]):
            states, h = self.steps(states, x[:, t], x, xw1, weights)
        return h


class MTNetModule(nn.Module):
    """Memory time-series network (ref MTNet_keras.py:234-446; JAX
    nets.py:199-295). The input is the long series ``[b, (long_num + 1) *
    time_step, F]``: the first ``long_num`` chunks are the memories, the
    last the query. Each encoder is a VALID convolution over time (kernel
    ``cnn_height``), ReLU, dropout (``cnn_dropout``, then ``rnn_dropout``
    if set) and an attention-GRU stack (``rnn_hid_sizes``); the memories
    fold into the batch. ``prob = softmax_n(memory · query)``, ``out =
    context * prob``, ``head`` on ``[out ; query]`` flattened, plus the
    ``ar`` highway on the last ``ar_window`` steps of every feature
    (none when ``ar_window == 0``). ``in_features`` is ``F``."""

    def __init__(self, in_features: int, output_dim: int = 1,
                 long_num: int = 4, time_step: int = 8,
                 cnn_hid_size: int = 32,
                 rnn_hid_sizes: Sequence[int] = (16, 32),
                 cnn_height: int = 3, ar_window: int = 4,
                 cnn_dropout: float = 0.1, rnn_dropout: float = 0.1,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if time_step < ar_window:
            raise ValueError("ar_window must not exceed time_step")
        if time_step < cnn_height:
            raise ValueError("cnn_height must not exceed time_step")
        self.in_features = int(in_features)
        self.output_dim = int(output_dim)
        self.long_num, self.time_step = int(long_num), int(time_step)
        self.rnn_hid_sizes = tuple(int(h) for h in rnn_hid_sizes)
        self.ar_window = int(ar_window)
        self.cnn_dropout, self.rnn_dropout = float(cnn_dropout), \
            float(rnn_dropout)
        self.dtype = dtype
        for enc in ("memory", "context", "query"):
            conv = Conv(self.in_features, int(cnn_hid_size), int(cnn_height),
                        dtype=dtype)
            with torch.no_grad():
                conv.weight.copy_(_trunc_normal(
                    conv.weight.shape, generator).data)
                conv.bias.fill_(0.1)
            self.add_module(f"{enc}_conv", conv)
            self.add_module(f"{enc}_attgru", _AttentionGRU(
                int(cnn_hid_size), self.rnn_hid_sizes, dtype, generator))
        h_last = self.rnn_hid_sizes[-1]
        self.head = self._dense((self.long_num + 1) * h_last, generator)
        self.ar = (self._dense(self.ar_window * self.in_features, generator)
                   if self.ar_window > 0 else None)

    def _dense(self, fan_in: int, generator) -> Dense:
        lin = Dense(fan_in, self.output_dim)
        with torch.no_grad():
            lin.weight.copy_(_trunc_normal((fan_in, self.output_dim),
                                           generator).data.T)
            lin.bias.fill_(0.1)
        return lin

    def _encoder(self, chunks, name: str, train: bool):
        y = F.relu(self._modules[f"{name}_conv"](chunks))
        y = F.dropout(y, self.cnn_dropout, training=train)
        if self.rnn_dropout:
            y = F.dropout(y, self.rnn_dropout, training=train)
        return self._modules[f"{name}_attgru"](y)

    def forward(self, x, train: bool = False):
        n, t = self.long_num, self.time_step
        b = x.shape[0]
        if x.shape[1] != (n + 1) * t:
            raise ValueError(
                f"expected seq len {(n + 1) * t}, got {x.shape[1]}")
        h_last = self.rnn_hid_sizes[-1]
        long_chunks = x[:, :n * t, :].reshape(b * n, t, x.shape[-1])
        short = x[:, n * t:, :]
        memory = self._encoder(long_chunks, "memory", train).float() \
            .reshape(b, n, h_last)
        context = self._encoder(long_chunks, "context", train).float() \
            .reshape(b, n, h_last)
        query = self._encoder(short, "query", train).float()
        prob = torch.softmax(torch.einsum("bnh,bh->bn", memory, query),
                             dim=-1)
        out = context * prob[..., None]
        pred_x = torch.cat([out, query[:, None, :]], dim=1).reshape(
            b, (n + 1) * h_last)
        y = self.head(pred_x)
        if self.ar is not None:
            y = y + self.ar(short[:, -self.ar_window:, :].reshape(b, -1)
                            .float())
        return y
