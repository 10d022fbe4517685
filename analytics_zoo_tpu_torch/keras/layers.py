"""zoo-Keras layers on PyTorch — the ones the NCF, BERT and Seq2Seq slices
use.

Counterpart of ``analytics_zoo_tpu/keras/layers.py``: the activation
table, ``Dense``, ``Activation``, ``Dropout``, ``Flatten``, ``Lambda``,
``Merge`` / ``merge``, ``FusedEmbeddings``, ``Embedding`` and
``SparseEmbedding`` over ``_EmbedTable``,
``LayerNormalization``, ``MultiHeadAttention``, ``TransformerLayer``,
``BERT``, the recurrent ``LSTM`` / ``GRU`` / ``SimpleRNN`` and
``TimeDistributed``. Layers are config objects; execution happens inside
the one ``GraphModule`` (engine.py). Parameter names follow the flax tree:
``<dense>.weight`` / ``.bias`` (``nn.Linear``, the flax kernel
transposed), ``<table>.embedding``, ``<norm>.weight`` (flax ``scale``),
the submodule names of text/bert.py under the layer's name, and the flax
cells' own names for the recurrent layers (``GRUCell_0.ir.weight``). The
rest of the layer library waits for later slices.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from analytics_zoo_tpu_torch.keras.engine import KerasLayer as _KerasLayerBase
from analytics_zoo_tpu_torch.keras.engine import Node, flax_autoname


class KerasLayer(_KerasLayerBase):
    """Layer base that records ``input_shape`` (used when a layer opens a
    Sequential) and snapshots the dtype policy at construction."""

    def __init__(self, name=None, input_shape=None):
        super().__init__(name)
        self.input_shape = tuple(input_shape) if input_shape is not None \
            else None
        from analytics_zoo_tpu_torch.keras import policy as _policy
        self.compute_dtype = _policy.compute_dtype()


# ---------------- activations (flax semantics) ----------------

_ACTIVATIONS = {
    "relu": F.relu, "sigmoid": torch.sigmoid, "tanh": torch.tanh,
    "softmax": lambda x: F.softmax(x, dim=-1),
    "log_softmax": lambda x: F.log_softmax(x, dim=-1),
    "softplus": F.softplus, "softsign": F.softsign,
    # flax's gelu is the tanh approximation
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "elu": F.elu, "selu": F.selu, "swish": F.silu, "silu": F.silu,
    "leaky_relu": F.leaky_relu, "relu6": lambda x: torch.clamp(x, 0, 6),
    "hard_sigmoid": lambda x: torch.clamp(0.2 * x + 0.5, 0.0, 1.0),
    "tanh_shrink": lambda x: x - torch.tanh(x),
    "softmin": lambda x: F.softmax(-x, dim=-1),
    "log_sigmoid": F.logsigmoid,
    "linear": lambda x: x, "identity": lambda x: x, None: lambda x: x,
}


def get_activation(act):
    if callable(act):
        return act
    if act in _ACTIVATIONS:
        return _ACTIVATIONS[act]
    raise ValueError(f"unknown activation {act!r}")


# ---------------- init helpers (keras init strings) ----------------
#
# Each fills a torch-layout tensor in place from the graph's generator.
# Values never match flax's (its RNG is derived from module paths): parity
# with the JAX package goes through convert.py, not through init.

def _glorot_uniform(t: torch.Tensor, g: torch.Generator):
    limit = math.sqrt(6.0 / (t.shape[0] + t.shape[-1]))
    t.uniform_(-limit, limit, generator=g)


_INITS: Dict[str, Callable[[torch.Tensor, torch.Generator], None]] = {
    "glorot_uniform": _glorot_uniform,
    "normal": lambda t, g: t.normal_(0.0, 0.05, generator=g),
    # keras-1 'uniform' is symmetric U(-0.05, 0.05)
    "uniform": lambda t, g: t.uniform_(-0.05, 0.05, generator=g),
    "zero": lambda t, g: t.zero_(), "zeros": lambda t, g: t.zero_(),
    "one": lambda t, g: t.fill_(1.0), "ones": lambda t, g: t.fill_(1.0),
}


def get_init(init):
    if callable(init):
        return init
    if init in _INITS:
        return _INITS[init]
    raise ValueError(f"unknown init {init!r}")


# ---------------- core layers ----------------

class Dense(KerasLayer):
    """(ref keras/layers/core.py Dense)"""

    def __init__(self, output_dim: int, activation=None,
                 init="glorot_uniform", bias: bool = True,
                 W_regularizer=None, b_regularizer=None, input_shape=None,
                 name=None):
        super().__init__(name, input_shape)
        if W_regularizer is not None or b_regularizer is not None:
            raise NotImplementedError(
                "parameter penalties (keras/regularizers.py) are not ported "
                "yet (ROADMAP A5)")
        self.output_dim = int(output_dim)
        self.activation = get_activation(activation)
        self.init = get_init(init)
        self.bias = bias

    def make_modules(self, in_shapes, generator):
        from analytics_zoo_tpu_torch.common import flax_compat
        s = in_shapes[0]
        if not s or s[-1] is None:
            raise ValueError(f"{self.name}: input width unknown; give the "
                             "model's Input a shape")
        lin = flax_compat.Dense(int(s[-1]), self.output_dim, bias=self.bias,
                                dtype=self.compute_dtype)
        with torch.no_grad():
            self.init(lin.weight, generator)
            if self.bias:
                lin.bias.zero_()
        return {self.name: lin}

    def apply(self, modules, args, train):
        return self.activation(modules[self.name](args[0]))

    def _infer_shape(self, in_shapes):
        s = in_shapes[0]
        return (s[:-1] + (self.output_dim,)) if s else None


class Activation(KerasLayer):
    def __init__(self, activation, input_shape=None, name=None):
        super().__init__(name, input_shape)
        self.fn = get_activation(activation)

    def apply(self, modules, args, train):
        return self.fn(args[0])

    def _infer_shape(self, in_shapes):
        return in_shapes[0]


class Dropout(KerasLayer):
    def __init__(self, p: float, input_shape=None, name=None):
        super().__init__(name, input_shape)
        self.p = p

    def apply(self, modules, args, train):
        return F.dropout(args[0], self.p, training=train)

    def _infer_shape(self, in_shapes):
        return in_shapes[0]


class Flatten(KerasLayer):
    def apply(self, modules, args, train):
        x = args[0]
        return x.reshape(x.shape[0], -1)

    def _infer_shape(self, in_shapes):
        s = in_shapes[0]
        return (math.prod(s),) if s else None


class Lambda(KerasLayer):
    """Wrap an arbitrary torch function (ref autograd.py Lambda:393).
    ``output_shape`` (without the batch dimension) is the port's addition:
    a layer after it that owns parameters needs its input width when the
    modules are built, and the function cannot say."""

    def __init__(self, function: Callable, output_shape=None,
                 input_shape=None, name=None):
        super().__init__(name, input_shape)
        self.function = function
        self.output_shape = tuple(output_shape) \
            if output_shape is not None else None

    def apply(self, modules, args, train):
        return self.function(*args)

    def _infer_shape(self, in_shapes):
        return self.output_shape


# ---------------- embeddings ----------------

class _EmbedTable(nn.Module):
    """Bare embedding-table parameter named ``embedding``, as in the flax
    tree; ``forward`` returns the table itself. The embedding layers read
    ``.embedding`` directly and feed it to the lookup kernels
    (ops/embedding_bag.py)."""

    def __init__(self, vocab: int, features: int):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(vocab, features))

    def forward(self):
        return self.embedding


class FusedEmbeddings(KerasLayer):
    """N per-column embedding tables served by ONE fused lookup.

    ``specs``: sequence of ``(table_name, vocab, dim)``. The input is
    ``[batch, n_tables]`` ids (a float input is cast to int32 by
    truncation) — ``ids[:, t]`` indexes table ``t`` — and the rows combine
    per ``combine``: "concat" (side by side, the NCF-MLP pattern) or
    "sum"/"mean"/"mul" (elementwise, equal dims; "mul" is the NCF GMF
    branch). On CUDA the lookup is the kernel of ops/csrc/embedding_bag.cu.

    Each table is a top-level module named ``table_name``, so the
    ``state_dict`` carries the flax tree's names (``mlp_user_embed.
    embedding``)."""

    def __init__(self, specs, combine: str = "concat", init="uniform",
                 zero_based_id: bool = True, input_shape=None, name=None):
        super().__init__(name, input_shape)
        self.specs = [(str(n), int(v), int(d)) for n, v, d in specs]
        if not self.specs:
            raise ValueError("FusedEmbeddings needs at least one table")
        if combine not in ("concat", "sum", "mean", "mul"):
            raise ValueError(f"unknown combine {combine!r}")
        if combine != "concat":
            dims = {d for _, _, d in self.specs}
            if len(dims) != 1:
                raise ValueError(f"combine={combine!r} needs equal dims, "
                                 f"got {sorted(dims)}")
        self.combine = combine
        self.init = get_init(init)
        self.zero_based_id = zero_based_id

    def make_modules(self, in_shapes, generator):
        mods = {}
        for tname, vocab, dim in self.specs:
            table = _EmbedTable(vocab, dim)
            with torch.no_grad():
                self.init(table.embedding, generator)
            mods[tname] = table
        return mods

    def apply(self, modules, args, train):
        from analytics_zoo_tpu_torch.ops.embedding_bag import (
            fused_embedding_lookup,
        )
        ids = args[0].to(torch.int32)
        if not self.zero_based_id:
            ids = ids - 1
        tables = []
        for tname, _, _ in self.specs:
            # the parameter itself: a module call's hook checks cost host
            # time on every forward
            t = modules[tname].embedding
            if self.compute_dtype is not None:
                t = t.to(self.compute_dtype)
            tables.append(t)
        return fused_embedding_lookup(tables, ids, combine=self.combine)

    def _infer_shape(self, in_shapes):
        s = in_shapes[0]
        if s is None:
            return None
        d = (sum(d for _, _, d in self.specs) if self.combine == "concat"
             else self.specs[0][2])
        return tuple(s[:-1]) + (d,)


class Embedding(KerasLayer):
    """(ref keras/layers/embeddings.py; Scala Embedding.scala).

    ``pooling``: None (default) keeps the per-id lookup ``[..., k] →
    [..., k, dim]`` (flax ``nn.Embed``: ``jnp.take``'s rule, the table
    cast to the policy's dtype first); "sum"/"mean" treat the last input
    axis as a bag of ids and pool their rows into one ``[..., dim]``
    vector per bag through ``embedding_bag`` (the CUDA bag kernel on the
    card). Ids are cast to int32 by truncation; ``zero_based_id=False``
    subtracts 1 first (1-based vocab ids). The table is registered as
    ``<name>.embedding``, as in the flax tree."""

    def __init__(self, input_dim: int, output_dim: int, init="uniform",
                 input_length=None, input_shape=None, name=None,
                 zero_based_id: bool = True, pooling=None):
        super().__init__(name, input_shape)
        if pooling not in (None, "sum", "mean"):
            raise ValueError(f"pooling must be None/'sum'/'mean', got "
                             f"{pooling!r}")
        self.input_dim, self.output_dim = int(input_dim), int(output_dim)
        self.init = get_init(init)
        self.zero_based_id = zero_based_id
        self.pooling = pooling

    def make_modules(self, in_shapes, generator):
        table = _EmbedTable(self.input_dim, self.output_dim)
        with torch.no_grad():
            self.init(table.embedding, generator)
        return {self.name: table}

    def apply(self, modules, args, train):
        from analytics_zoo_tpu_torch.ops.embedding_bag import (
            embedding_bag, embedding_lookup,
        )
        ids = args[0].to(torch.int32)
        if not self.zero_based_id:
            ids = ids - 1
        table = modules[self.name].embedding
        if self.compute_dtype is not None:
            table = table.to(self.compute_dtype)
        if self.pooling is not None:
            return embedding_bag(table, ids, mode=self.pooling)
        if self.input_dim == 1:
            # flax nn.Embed broadcasts a one-row table, whatever the id
            return table[0].expand(*ids.shape, self.output_dim)
        return embedding_lookup(table, ids)

    def _infer_shape(self, in_shapes):
        s = in_shapes[0]
        if s is None:
            return None
        if self.pooling is not None:
            return tuple(s[:-1]) + (self.output_dim,)
        return tuple(s) + (self.output_dim,)


class SparseEmbedding(Embedding):
    """(ref embeddings.py SparseEmbedding). As in the JAX package this is
    ``Embedding``: the gradient of a lookup is a dense table either way,
    and ``pooling="sum"/"mean"`` rides the bag kernel for multi-hot
    columns."""


# ---------------- merge ----------------

class Merge(KerasLayer):
    """(ref keras/layers Merge mode=sum/mul/concat/ave/dot/max...)"""

    def __init__(self, layers=None, mode: str = "sum", concat_axis: int = -1,
                 input_shape=None, name=None):
        super().__init__(name, input_shape)
        self.mode = mode
        self.concat_axis = concat_axis

    def apply(self, modules, args, train):
        m = self.mode
        if m in ("sum", "add"):
            out = args[0]
            for a in args[1:]:
                out = out + a
            return out
        if m == "sub":
            return args[0] - args[1]
        if m == "mul":
            out = args[0]
            for a in args[1:]:
                out = out * a
            return out
        if m == "div":
            return args[0] / args[1]
        if m in ("ave", "avg"):
            return sum(args) / len(args)
        if m == "max":
            return torch.stack(args).amax(0)
        if m == "min":
            return torch.stack(args).amin(0)
        if m == "concat":
            return torch.cat(args, dim=self.concat_axis)
        if m == "dot":
            return torch.sum(args[0] * args[1], dim=-1, keepdim=True)
        if m == "cos":
            a = args[0] / torch.linalg.norm(args[0], dim=-1, keepdim=True)
            b = args[1] / torch.linalg.norm(args[1], dim=-1, keepdim=True)
            return torch.sum(a * b, dim=-1, keepdim=True)
        raise ValueError(f"unknown merge mode {m!r}")

    def _infer_shape(self, in_shapes):
        # the flax layer infers no shape; the port needs one so a Dense
        # after a merge knows its input width when modules are built
        if any(s is None for s in in_shapes):
            return None
        if self.mode == "concat":
            nd = len(in_shapes[0])
            # a positive axis counts the batch dimension, shapes do not
            ax = self.concat_axis + nd if self.concat_axis < 0 \
                else self.concat_axis - 1
            out = list(in_shapes[0])
            out[ax] = sum(s[ax] for s in in_shapes)
            return tuple(out)
        if self.mode in ("dot", "cos"):
            return tuple(in_shapes[0][:-1]) + (1,)
        return tuple(in_shapes[0])


def merge_op(mode: str, concat_axis: int = -1) -> Merge:
    return Merge(mode=mode, concat_axis=concat_axis)


def merge(inputs: List[Node], mode: str = "sum", concat_axis: int = -1
          ) -> Node:
    """Functional merge (ref pyzoo keras merge())."""
    return Merge(mode=mode, concat_axis=concat_axis)(inputs)


# ---------------- recurrent ----------------
#
# Each cell mirrors flax's arithmetic with a loop over time and a zero
# initial carry. Not nn.GRU / nn.LSTM: cuDNN splits the biases and sums in
# its own way. Every product is one time step at [batch, .]: a product over
# [batch * time, .] would give cuBLAS a row count that grows with the
# decode rung, and with it possibly another kernel and other bits at live
# positions. The gates of one side (input or recurrent) run as one product
# of the concatenated weights; flax's OptimizedLSTMCell does the same, its
# GRUCell does not, so the port agrees with flax within fp32 rounding.

def _linear(in_f: int, out_f: int, bias: bool,
            generator: torch.Generator) -> nn.Linear:
    lin = nn.Linear(int(in_f), int(out_f), bias=bias)
    with torch.no_grad():
        lin.weight.normal_(0.0, 1.0 / math.sqrt(in_f), generator=generator)
        if bias:
            lin.bias.zero_()
    return lin


class _RNNCell(nn.Module):
    """A flax RNN cell's parameters: one ``nn.Linear`` per flax Dense,
    named as flax names them (``in`` and ``if`` are Python keywords, so
    they are registered with ``add_module``)."""

    #: (name, has a bias) of the input-side and of the recurrent Denses
    INPUT: Tuple[Tuple[str, bool], ...]
    RECURRENT: Tuple[Tuple[str, bool], ...]

    def __init__(self, in_features: int, features: int, activation,
                 generator: torch.Generator):
        super().__init__()
        for gates, fan_in in ((self.INPUT, in_features),
                              (self.RECURRENT, features)):
            for name, bias in gates:
                self.add_module(name, _linear(fan_in, features, bias,
                                              generator))
        self.features = int(features)
        self.activation = activation

    def _side(self, gates):
        mods = [self._modules[n] for n, _ in gates]
        w = torch.cat([m.weight for m in mods])
        if not any(b for _, b in gates):
            return w, None
        # a gate without a flax bias (GRU's hr, hz) adds a zero one: x + 0
        # is x
        return w, torch.cat([m.bias if m.bias is not None
                             else torch.zeros_like(m.weight[:, 0])
                             for m in mods])

    def weights(self):
        """The concatenated input-side and recurrent weights and biases,
        made once per forward."""
        return self._side(self.INPUT), self._side(self.RECURRENT)

    def init_carry(self, x0: torch.Tensor):
        return x0.new_zeros((x0.shape[0], self.features))

    def output(self, carry) -> torch.Tensor:
        return carry


class GRUCellModule(_RNNCell):
    """flax ``GRUCell``: ``r = σ(ir x + hr h)``, ``z = σ(iz x + hz h)``,
    ``n = act(in x + r ⊙ (hn h + b_hn))``, ``h' = (1 - z) ⊙ n + z ⊙ h``."""

    INPUT = (("ir", True), ("iz", True), ("in", True))
    RECURRENT = (("hr", False), ("hz", False), ("hn", True))

    def step(self, x, h, w):
        (wi, bi), (wh, bh) = w
        gi = F.linear(x, wi, bi)
        gh = F.linear(h, wh, bh)
        f = self.features
        rz = torch.sigmoid(gi[:, :2 * f] + gh[:, :2 * f])
        r, z = rz[:, :f], rz[:, f:]
        n = self.activation(gi[:, 2 * f:] + r * gh[:, 2 * f:])
        return (1.0 - z) * n + z * h


class OptimizedLSTMCellModule(_RNNCell):
    """flax ``OptimizedLSTMCell``: ``s = (h W_h + b_h) + x W_i`` in one
    product per side; ``i, f, o = σ(s)``, ``g = act(s)``, ``c' = f ⊙ c + i ⊙
    g``, ``h' = o ⊙ act(c')``."""

    INPUT = (("ii", False), ("if", False), ("ig", False), ("io", False))
    RECURRENT = (("hi", True), ("hf", True), ("hg", True), ("ho", True))

    def init_carry(self, x0):
        zero = x0.new_zeros((x0.shape[0], self.features))
        return zero, zero

    def output(self, carry):
        return carry[1]

    def step(self, x, carry, w):
        (wi, _), (wh, bh) = w
        c, h = carry
        s = F.linear(h, wh, bh) + F.linear(x, wi)
        f = self.features
        sig = torch.sigmoid(s)
        g = self.activation(s[:, 2 * f:3 * f])
        c = sig[:, f:2 * f] * c + sig[:, :f] * g
        return c, sig[:, 3 * f:] * self.activation(c)


class SimpleCellModule(_RNNCell):
    """flax ``SimpleCell``: ``h' = act(i x + h h)``."""

    INPUT = (("i", True),)
    RECURRENT = (("h", False),)

    def step(self, x, h, w):
        (wi, bi), (wh, _) = w
        return self.activation(F.linear(x, wi, bi) + F.linear(h, wh))


class _RNNBase(KerasLayer):
    cell_cls = None
    #: the flax cell's class name, which names its parameters
    flax_cell = None

    def __init__(self, output_dim: int, activation="tanh",
                 return_sequences: bool = False, go_backwards: bool = False,
                 input_shape=None, name=None):
        super().__init__(name, input_shape)
        self.output_dim = int(output_dim)
        self.activation = activation
        self.return_sequences = return_sequences
        self.go_backwards = go_backwards

    def make_modules(self, in_shapes, generator):
        if self.compute_dtype is not None:
            raise NotImplementedError(
                f"{type(self).__name__} runs in float32 only; a compute "
                "dtype policy for the recurrent layers waits for a later "
                "slice")
        s = in_shapes[0]
        if not s or s[-1] is None:
            raise ValueError(f"{self.name}: input width unknown; give the "
                             "model's Input a shape")
        cell = self.cell_cls(int(s[-1]), self.output_dim,
                             get_activation(self.activation), generator)
        return {flax_autoname(self.flax_cell): cell}

    def apply(self, modules, args, train):
        (cell,) = modules.values()
        x = args[0]
        if self.go_backwards:
            # flax RNN(reverse=True, keep_order=False): outputs in the
            # order the sequence was read
            x = torch.flip(x, dims=(1,))
        steps = x.transpose(0, 1).contiguous()     # [time, batch, in]
        w = cell.weights()
        carry = cell.init_carry(steps[0])
        outs = []
        for x_t in steps:
            carry = cell.step(x_t, carry, w)
            outs.append(cell.output(carry))
        if not self.return_sequences:
            return outs[-1]
        return torch.stack(outs, dim=1)

    def _infer_shape(self, in_shapes):
        s = in_shapes[0]
        if s is None:
            return None
        return (s[0], self.output_dim) if self.return_sequences \
            else (self.output_dim,)


class LSTM(_RNNBase):
    """(ref keras/layers/recurrent LSTM; flax's OptimizedLSTMCell)"""
    cell_cls = OptimizedLSTMCellModule
    flax_cell = "OptimizedLSTMCell"


class GRU(_RNNBase):
    cell_cls = GRUCellModule
    flax_cell = "GRUCell"


class SimpleRNN(_RNNBase):
    cell_cls = SimpleCellModule
    flax_cell = "SimpleCell"


class TimeDistributed(KerasLayer):
    """Apply a layer to every time step (ref keras TimeDistributed). The
    JAX layer folds time into the batch; here the inner layer runs once per
    step at ``[batch, ...]``, so its products' row count never depends on
    the sequence length (see the recurrent layers above)."""

    def __init__(self, layer: KerasLayer, name=None):
        super().__init__(name)
        self.layer = layer

    def make_modules(self, in_shapes, generator):
        # a user-chosen inner name is kept (save/load keys on it); only an
        # auto-generated one is replaced to keep the tree deterministic
        if getattr(self.layer, "_auto_named", False):
            self.layer.name = f"{self.name}_inner"
        s = in_shapes[0]
        return self.layer.make_modules([None if s is None else s[1:]],
                                       generator)

    def apply(self, modules, args, train):
        steps = args[0].transpose(0, 1).contiguous()
        return torch.stack([self.layer.apply(modules, [x_t], train)
                            for x_t in steps], dim=1)

    def _infer_shape(self, in_shapes):
        s = in_shapes[0]
        if s is None:
            return None
        inner = self.layer._infer_shape([s[1:]])
        return None if inner is None else (s[0],) + tuple(inner)


# ---------------- normalization ----------------

def _seed_from(generator: torch.Generator) -> int:
    """A numpy seed drawn from the graph's generator."""
    return int(torch.randint(0, 2 ** 31 - 1, (1,), generator=generator))


class LayerNormalization(KerasLayer):
    def __init__(self, epsilon: float = 1e-6, input_shape=None, name=None):
        super().__init__(name, input_shape)
        self.epsilon = epsilon

    def make_modules(self, in_shapes, generator):
        from analytics_zoo_tpu_torch.common.flax_compat import LayerNorm
        s = in_shapes[0]
        if not s or s[-1] is None:
            raise ValueError(f"{self.name}: input width unknown")
        return {self.name: LayerNorm(int(s[-1]), eps=self.epsilon,
                                     dtype=self.compute_dtype)}

    def apply(self, modules, args, train):
        return modules[self.name](args[0])

    def _infer_shape(self, in_shapes):
        return in_shapes[0]


# ---------------- attention / transformer / BERT ----------------

class MultiHeadAttention(KerasLayer):
    """Dot-product multi-head attention (ref pyzoo self_attention.py /
    Scala TransformerLayer.scala:56) over ops/attention.py. Call on
    ``[q]``, ``[q, kv]`` or ``[q, kv, mask]``."""

    def __init__(self, num_heads: int, head_dim: int, dropout: float = 0.0,
                 causal: bool = False, input_shape=None, name=None):
        super().__init__(name, input_shape)
        self.num_heads, self.head_dim = num_heads, head_dim
        self.dropout, self.causal = dropout, causal

    def make_modules(self, in_shapes, generator):
        from analytics_zoo_tpu_torch.ops.attention import AttentionModule
        from analytics_zoo_tpu_torch.text.bert import init_bert_weights
        q = in_shapes[0]
        kv = in_shapes[1] if len(in_shapes) > 1 else q
        if not q or not kv or q[-1] is None or kv[-1] is None:
            raise ValueError(f"{self.name}: input widths unknown")
        module = AttentionModule(
            num_heads=self.num_heads, head_dim=self.head_dim,
            q_features=int(q[-1]), kv_features=int(kv[-1]),
            dropout=self.dropout, causal=self.causal,
            dtype=self.compute_dtype)
        return {self.name: init_bert_weights(module, _seed_from(generator))}

    def apply(self, modules, args, train):
        q = args[0]
        kv = args[1] if len(args) > 1 else q
        mask = args[2] if len(args) > 2 else None
        return modules[self.name](q, kv, mask=mask, train=train)

    def _infer_shape(self, in_shapes):
        return in_shapes[0]


class TransformerLayer(KerasLayer):
    """GPT-style causal transformer over token ids
    (ref zoo/.../keras/layers/TransformerLayer.scala:56). Input: [b, L]
    token ids; output: [b, L, hidden_size]."""

    def __init__(self, vocab: int, hidden_size: int = 768, n_block: int = 12,
                 n_head: int = 12, seq_len: int = 512,
                 hidden_drop: float = 0.1, input_shape=None, name=None):
        super().__init__(name, input_shape)
        self.vocab, self.hidden_size = vocab, hidden_size
        self.n_block, self.n_head = n_block, n_head
        self.seq_len, self.hidden_drop = seq_len, hidden_drop

    def _infer_shape(self, in_shapes):
        s = in_shapes[0]
        return (None if s is None else s[0], self.hidden_size) \
            if s and len(s) == 1 else (s + (self.hidden_size,) if s else None)

    def make_modules(self, in_shapes, generator):
        from analytics_zoo_tpu_torch.text.bert import (TransformerModule,
                                                       init_bert_weights)
        module = TransformerModule(
            vocab=self.vocab, hidden_size=self.hidden_size,
            n_block=self.n_block, n_head=self.n_head,
            hidden_drop=self.hidden_drop, max_position_len=self.seq_len,
            dtype=self.compute_dtype)
        return {self.name: init_bert_weights(module, _seed_from(generator))}

    def apply(self, modules, args, train):
        return modules[self.name](args[0], train=train)


class BERT(KerasLayer):
    """BERT encoder layer (ref zoo/.../keras/layers/BERT.scala:66).

    Call on ``[ids]`` or ``[ids, token_types, mask]`` nodes. ``output``:
    ``"pooled"`` (default, [b, hidden]) or ``"sequence"`` ([b, L,
    hidden]). Attention auto-selects (``use_flash=None``), as in the JAX
    layer.
    """

    def __init__(self, vocab: int = 30522, hidden_size: int = 768,
                 n_block: int = 12, n_head: int = 12,
                 intermediate_size: int = 3072, max_position_len: int = 512,
                 hidden_drop: float = 0.1, attn_drop: float = 0.1,
                 output: str = "pooled", input_shape=None, name=None):
        super().__init__(name, input_shape)
        from analytics_zoo_tpu_torch.text.bert import BertConfig
        if output not in ("pooled", "sequence"):
            raise ValueError("output must be 'pooled' or 'sequence'")
        self.config = BertConfig(
            vocab=vocab, hidden_size=hidden_size, n_block=n_block,
            n_head=n_head, intermediate_size=intermediate_size,
            max_position_len=max_position_len, hidden_drop=hidden_drop,
            attn_drop=attn_drop, dtype=self.compute_dtype)
        self.output = output

    def _infer_shape(self, in_shapes):
        s = in_shapes[0]
        if self.output == "pooled":
            return (self.config.hidden_size,)
        return (None if s is None else s[0], self.config.hidden_size)

    def make_modules(self, in_shapes, generator):
        from analytics_zoo_tpu_torch.text.bert import (BertModule,
                                                       init_bert_weights)
        module = BertModule(self.config)
        return {self.name: init_bert_weights(
            module, _seed_from(generator), self.config.initializer_range)}

    def apply(self, modules, args, train):
        ids = args[0]
        seg = args[1] if len(args) > 1 else None
        mask = args[2] if len(args) > 2 else None
        seq, pooled = modules[self.name](ids, seg, mask, train=train)
        return pooled if self.output == "pooled" else seq
