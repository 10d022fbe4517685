"""Transformer / BERT encoders as PyTorch modules.

Counterpart of ``analytics_zoo_tpu/text/bert.py`` (ref
``TransformerLayer.scala:56`` and ``BERT.scala:66``): ``BertConfig``, the
post-LN ``EncoderBlock``, ``BertModule`` (token, segment and position
embeddings, bidirectional blocks, pooled [CLS]) and ``TransformerModule``
(the GPT-style causal stack). Submodules carry the flax tree's names
(``word_embeddings``, ``block_0.attention.query``, ``attn_norm``,
``pooler``...), so ``convert.flax_to_state_dict`` and
``text/hf_import.py`` fill them key for key.

Attention goes through ``ops/attention.py``: with ``use_flash=True`` and
no mask, the flash kernel on CUDA; with ``use_flash=None`` (the default)
and no mask, the autotuner's verdict for the shape picks the flash kernel
or the einsum chain (``ops/autotune.py``; a miss is measured or queued,
and meanwhile the 2 GiB heuristic decides). ``dtype`` is the computation dtype of
every block, norms included (parameters stay fp32); embeddings are
looked up and summed in fp32. The modules train under autograd
(``learn/estimator.py``): dropout runs when ``train=True``, and with
``use_flash=True`` on CUDA the attention's gradients come from the flash
backward kernels.

``BertConfig.remat`` (JAX's ``nn.remat`` of each block with
``dots_with_no_batch_dims_saveable``) recomputes every encoder block in
the backward pass: non-reentrant ``torch.utils.checkpoint`` per block,
with the random state kept so dropout draws the same masks again, and a
selective policy that keeps the outputs of the weight-stationary products
(the packed projection, the attention output and the two FFN products:
``aten.addmm`` / ``aten.mm``) and recomputes the rest, attention
included. So the flash forward launches twice a block in a training step
(its ``out`` and ``lse`` come back through checkpoint's saved-tensor
hooks, and the recompute writes fresh buffers). Without a gradient to
take (``torch.no_grad``, inference) the blocks run plainly.

``bert_tp_rules()`` is JAX's tensor-parallel layout, verbatim: under a
strategy with ``tp`` (learn/estimator.py) each block runs Megatron's
layout on this rank's shards: query, key, value and intermediate split by
output features, out and output by input columns, one all_reduce after
each of the two, the attention (the flash kernels) on ``n_head / tp``
heads a rank; the word table split by columns is looked up on its block
and the features gathered.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from analytics_zoo_tpu_torch.common.flax_compat import Dense, Embed, LayerNorm
from analytics_zoo_tpu_torch.ops.attention import AttentionModule


@dataclass(frozen=True)
class BertConfig:
    """(ref BERT.scala:66 constructor params / bert config.json). The
    defaults are BERT-Base, Uncased."""

    vocab: int = 30522
    hidden_size: int = 768
    n_block: int = 12
    n_head: int = 12
    intermediate_size: int = 3072
    hidden_drop: float = 0.1
    attn_drop: float = 0.1
    max_position_len: int = 512
    type_vocab: int = 2
    initializer_range: float = 0.02
    # exact (erf) gelu, what BERT checkpoints were trained with
    gelu_exact: bool = True
    # computation dtype (params stay fp32), e.g. torch.bfloat16
    dtype: Optional[torch.dtype] = None
    # attention: None -> auto-select (on CUDA without a mask, the
    # autotuner's verdict, else the 2 GiB heuristic), True -> the flash
    # path (the kernel on CUDA) whenever there is no mask, False -> the
    # einsum chain
    use_flash: Optional[bool] = None
    # recompute each encoder block in the backward pass, keeping the
    # products' outputs (the module docstring)
    remat: bool = False

    @property
    def head_dim(self) -> int:
        if self.hidden_size % self.n_head:
            raise ValueError(f"hidden_size {self.hidden_size} is not a "
                             f"multiple of n_head {self.n_head}")
        return self.hidden_size // self.n_head


#: the weight-stationary products whose outputs remat keeps (JAX's
#: ``dots_with_no_batch_dims_saveable``: a batched product, attention's,
#: is recomputed)
_SAVED_PRODUCTS = frozenset({torch.ops.aten.addmm.default,
                             torch.ops.aten.mm.default})


def _remat_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_PRODUCTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


_remat_context = functools.partial(create_selective_checkpoint_contexts,
                                   _remat_policy)


def _positions(table, length: int, device) -> torch.Tensor:
    """The first ``length`` rows of a position table as ``[1, length,
    hidden]``: a slice, or, for a strategy's column block of the table,
    its lookup (``Embed``'s gathered path)."""
    if getattr(table.embedding, "_zoo_shard", None) is None:
        return table.embedding[:length][None]
    return table(torch.arange(length, dtype=torch.int32, device=device)[None])


def _gelu(x, exact: bool):
    return F.gelu(x, approximate="none" if exact else "tanh")


class EncoderBlock(nn.Module):
    """Post-LN transformer block: attention -> add & norm -> ffn -> add &
    norm."""

    def __init__(self, hidden_size: int, n_head: int, intermediate_size: int,
                 dropout: float = 0.1, attn_drop: float = 0.1,
                 causal: bool = False, dtype: Optional[torch.dtype] = None,
                 gelu_exact: bool = False, use_flash: Optional[bool] = None):
        super().__init__()
        self.dropout, self.gelu_exact = dropout, gelu_exact
        self.attention = AttentionModule(
            num_heads=n_head, head_dim=hidden_size // n_head,
            q_features=hidden_size, dropout=attn_drop, causal=causal,
            dtype=dtype, use_flash=use_flash)
        self.attn_norm = LayerNorm(hidden_size, eps=1e-12, dtype=dtype)
        self.intermediate = Dense(hidden_size, intermediate_size, dtype=dtype)
        self.output = Dense(intermediate_size, hidden_size, dtype=dtype)
        self.ffn_norm = LayerNorm(hidden_size, eps=1e-12, dtype=dtype)

    def sharded_params(self, shards) -> set:
        """Under a strategy, Megatron's layout: the attention's
        (``AttentionModule.sharded_params``), and ``intermediate`` split
        by its output features with ``output`` by its input columns over
        one axis (the FFN on this rank's columns, one all_reduce)."""
        from analytics_zoo_tpu_torch.parallel import tensor_parallel as tp
        sub = {n[len("attention."):]: v for n, v in shards.items()
               if n.startswith("attention.")}
        out = {"attention." + n for n in self.attention.sharded_params(sub)}
        axis = tp.covers(shards, ["intermediate.weight"], 0)
        if axis is not None and "output.bias" not in shards and \
                tp.covers(shards, ["output.weight"], 1, axis) is not None:
            out |= {"intermediate.weight", "output.weight"}
            if tp.covers(shards, ["intermediate.bias"], 0, axis):
                out.add("intermediate.bias")
        return out

    def _ffn(self, x):
        from analytics_zoo_tpu_torch.parallel import tensor_parallel as tp
        if tp.shard_of(self.intermediate.weight) is None:
            return self.output(_gelu(self.intermediate(x), self.gelu_exact))
        h = tp.column_linear(x, self.intermediate.weight,
                             self.intermediate.bias,
                             self.intermediate.compute_dtype, gather=False)
        return tp.row_linear(_gelu(h, self.gelu_exact), self.output.weight,
                             self.output.bias, self.output.compute_dtype)

    def forward(self, x, mask=None, train: bool = False):
        x = self.attn_norm(x + self.attention(x, mask=mask, train=train))
        h = self._ffn(x)
        if self.dropout > 0:
            h = F.dropout(h, self.dropout, training=train)
        return self.ffn_norm(x + h)


class BertModule(nn.Module):
    """BERT encoder; returns ``(sequence [b, L, hidden], pooled [b,
    hidden])``."""

    def __init__(self, config: BertConfig = BertConfig()):
        super().__init__()
        cfg = self.config = config
        hidden = cfg.hidden_size
        self.word_embeddings = Embed(cfg.vocab, hidden)
        self.position_embeddings = Embed(cfg.max_position_len, hidden)
        self.token_type_embeddings = Embed(cfg.type_vocab, hidden)
        self.embed_norm = LayerNorm(hidden, eps=1e-12, dtype=cfg.dtype)
        for i in range(cfg.n_block):
            self.add_module(f"block_{i}", EncoderBlock(
                hidden_size=hidden, n_head=cfg.n_head,
                intermediate_size=cfg.intermediate_size,
                dropout=cfg.hidden_drop, attn_drop=cfg.attn_drop,
                dtype=cfg.dtype, gelu_exact=cfg.gelu_exact,
                use_flash=cfg.use_flash))
        self.pooler = Dense(hidden, hidden, dtype=cfg.dtype)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                train: bool = False):
        cfg = self.config
        ids = torch.as_tensor(input_ids).to(torch.int32)
        length = ids.shape[1]
        if length > cfg.max_position_len:
            # a position past the table would read a NaN row; fail loudly
            raise ValueError(f"sequence length {length} exceeds "
                             f"max_position_len {cfg.max_position_len}")
        emb = self.word_embeddings(ids)
        emb = emb + _positions(self.position_embeddings, length, ids.device)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(ids)
        emb = emb + self.token_type_embeddings(
            torch.as_tensor(token_type_ids, device=ids.device))
        x = self.embed_norm(emb)
        if cfg.hidden_drop > 0:
            x = F.dropout(x, cfg.hidden_drop, training=train)
        mask = None
        if attention_mask is not None:
            # [b, L] 1/0 -> [b, 1, 1, L], over heads and queries
            mask = torch.as_tensor(attention_mask,
                                   device=ids.device)[:, None, None, :]
        remat = cfg.remat and torch.is_grad_enabled()
        for i in range(cfg.n_block):
            block = self._modules[f"block_{i}"]
            if remat:
                x = checkpoint(block, x, mask, train, use_reentrant=False,
                               context_fn=_remat_context,
                               preserve_rng_state=True)
            else:
                x = block(x, mask, train)
        pooled = torch.tanh(self.pooler(x[:, 0]))
        return x, pooled


class TransformerModule(nn.Module):
    """GPT-style causal decoder stack (token + position embeddings, causal
    blocks, tanh gelu); returns the sequence representation. Attention
    auto-selects its path (``use_flash=None``)."""

    def __init__(self, vocab: int, hidden_size: int = 768, n_block: int = 12,
                 n_head: int = 12, intermediate_size: Optional[int] = None,
                 hidden_drop: float = 0.1, attn_drop: Optional[float] = None,
                 max_position_len: int = 512,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.n_block, self.hidden_drop = n_block, hidden_drop
        self.max_position_len = max_position_len
        self.wte = Embed(vocab, hidden_size)
        self.wpe = Embed(max_position_len, hidden_size)
        inter = intermediate_size or 4 * hidden_size
        attn_drop = hidden_drop if attn_drop is None else attn_drop
        for i in range(n_block):
            self.add_module(f"block_{i}", EncoderBlock(
                hidden_size=hidden_size, n_head=n_head,
                intermediate_size=inter, dropout=hidden_drop,
                attn_drop=attn_drop, dtype=dtype, causal=True))

    def forward(self, input_ids, train: bool = False):
        ids = torch.as_tensor(input_ids).to(torch.int32)
        length = ids.shape[1]
        if length > self.max_position_len:
            raise ValueError(f"sequence length {length} exceeds "
                             f"max_position_len {self.max_position_len}")
        x = self.wte(ids) + _positions(self.wpe, length, ids.device)
        if self.hidden_drop > 0:
            x = F.dropout(x, self.hidden_drop, training=train)
        for i in range(self.n_block):
            x = self._modules[f"block_{i}"](x, train=train)
        return x


def bert_tp_rules() -> list:
    """Tensor-parallel partition rules for the encoder (JAX's, verbatim,
    against flax's paths and shapes): attention heads and the FFN width
    over the ``model`` axis, Megatron's layout (column-parallel
    query/key/value and intermediate, row-parallel out and output), and
    the word table by columns."""
    return [
        (r"attention/(query|key|value)/kernel", (None, "model", None)),
        (r"attention/out/kernel", ("model", None, None)),
        (r"intermediate/kernel", (None, "model")),
        (r"output/kernel", ("model", None)),
        (r"word_embeddings/embedding", (None, "model")),
    ]


def init_bert_weights(module: nn.Module, seed: int = 0,
                      std: float = 0.02) -> nn.Module:
    """Draw a BERT-style initialisation from a numpy seed, in the order of
    ``state_dict()``: weights and tables N(0, std), biases 0, norm weights
    1. Returns ``module``."""
    rng = np.random.RandomState(seed)
    norms = {name for name, m in module.named_modules()
             if isinstance(m, nn.LayerNorm)}
    state = {}
    for key, val in module.state_dict().items():
        owner, _, leaf = key.rpartition(".")
        if owner in norms:
            arr = np.full(val.shape, 1.0 if leaf == "weight" else 0.0)
        elif leaf == "bias":
            arr = np.zeros(val.shape)
        else:
            arr = rng.normal(0.0, std, val.shape)
        state[key] = torch.from_numpy(arr.astype(np.float32))
    module.load_state_dict(state)
    return module
