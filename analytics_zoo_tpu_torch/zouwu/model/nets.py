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

All take ``[batch, time, features]`` and give ``[batch, horizon]``;
``forward(x, train)`` applies dropout only with ``train=True``. ``dtype``
(e.g. ``torch.bfloat16``) is the compute dtype with fp32 parameters
(``keras/policy.py``); the heads stay fp32. The recurrent nets run in fp32
only and raise under a bf16 dtype, as the keras recurrent layers do
(ROADMAP A8). ``MTNetModule`` waits for ROADMAP A11.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from analytics_zoo_tpu_torch.common.flax_compat import Conv, Dense
from analytics_zoo_tpu_torch.keras.layers import OptimizedLSTMCellModule

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


def _check_fp32(net: str, dtype) -> None:
    if dtype is not None and dtype != torch.float32:
        raise NotImplementedError(
            f"{net} runs in float32 only; a compute dtype for the recurrent "
            "layers waits for a later slice (ROADMAP A8)")


def _run_lstm(cell: OptimizedLSTMCellModule, x: torch.Tensor
              ) -> torch.Tensor:
    """flax ``nn.RNN(cell)(x)``: every step's output, ``[b, t, units]``."""
    steps = x.transpose(0, 1)
    w = cell.weights()
    carry = cell.init_carry(steps[0])
    outs = []
    for x_t in steps:
        carry = cell.step(x_t, carry, w)
        outs.append(cell.output(carry))
    return torch.stack(outs, dim=1)


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
        _check_fp32("VanillaLSTMNet", dtype)
        gen = generator or torch.Generator().manual_seed(0)
        width = int(in_features)
        self.dropouts = [float(dropouts[min(i, len(dropouts) - 1)])
                         for i in range(len(lstm_units))]
        for i, units in enumerate(lstm_units):
            self.add_module(f"OptimizedLSTMCell_{i}", OptimizedLSTMCellModule(
                width, int(units), torch.tanh, gen))
            width = int(units)
        self.n_layers = len(lstm_units)
        self.Dense_0 = _flax_init(Dense(width, output_dim), width, generator)

    def forward(self, x, train: bool = False):
        for i in range(self.n_layers):
            x = _run_lstm(self._modules[f"OptimizedLSTMCell_{i}"], x)
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
        _check_fp32("Seq2SeqNet", dtype)
        gen = generator or torch.Generator().manual_seed(0)
        self.future_seq_len = int(future_seq_len)
        self.latent_dim = int(latent_dim)
        self.dropout = float(dropout)
        self.output_dim = int(output_dim)
        self.OptimizedLSTMCell_0 = OptimizedLSTMCellModule(
            int(in_features), self.latent_dim, torch.tanh, gen)
        self.OptimizedLSTMCell_1 = OptimizedLSTMCellModule(
            self.latent_dim, self.latent_dim, torch.tanh, gen)
        self.Dense_0 = _flax_init(Dense(self.latent_dim, self.output_dim),
                                  self.latent_dim, generator)

    def forward(self, x, train: bool = False):
        ctx = _run_lstm(self.OptimizedLSTMCell_0, x)[:, -1, :]
        if self.dropout:
            ctx = F.dropout(ctx, self.dropout, training=train)
        dec_in = ctx[:, None, :].expand(-1, self.future_seq_len, -1)
        dec = _run_lstm(self.OptimizedLSTMCell_1, dec_in)
        out = self.Dense_0(dec.float())
        return out[..., 0] if self.output_dim == 1 else out
