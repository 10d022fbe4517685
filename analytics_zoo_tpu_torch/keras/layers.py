"""zoo-Keras layers on PyTorch — the ones the NCF, BERT and Seq2Seq slices
use.

Counterpart of ``analytics_zoo_tpu/keras/layers.py``: the activation
table, ``Dense``, ``Activation``, ``Dropout``, ``Flatten``, ``Lambda``,
``Merge`` / ``merge``, ``Narrow``, ``FusedEmbeddings``, ``Embedding``
and ``SparseEmbedding`` over ``_EmbedTable``, ``WordEmbedding`` (a
frozen table is a buffer, outside the flax tree, as in JAX),
``LayerNormalization``, ``MultiHeadAttention``, ``TransformerLayer``,
``BERT``, the recurrent ``LSTM`` / ``GRU`` / ``SimpleRNN`` (in fp32 or,
under ``mixed_bfloat16``, flax's mixed precision: bf16 gates, an fp32
carry and fp32 outputs), ``Bidirectional`` and ``TimeDistributed``, and
the image stack: ``Conv1D`` / ``Conv2D`` /
``Conv3D``, ``BatchNormalization``, the max and average pools (1-D to
3-D), the global pools and ``ZeroPadding1D/2D/3D``, ``SeparableConv2D``
(``SeparableConvolution2D``), ``LRN2D`` and ``KerasLayerWrapper`` (a
module of the port, such as a grouped ``flax_compat.Conv``, as a layer).
Tensors keep JAX's
channels-last layout (``[batch, *spatial, channels]``); the
convolutions and pools run on channels-first views of it
(common/flax_compat.py). Layers are config objects; execution happens inside
the one ``GraphModule`` (engine.py). Parameter names follow the flax tree:
``<dense>.weight`` / ``.bias`` (``nn.Linear``, the flax kernel
transposed; a convolution's ``[*k, in, out]`` kernel flattened the same
way), ``<table>.embedding``, ``<norm>.weight`` (flax ``scale``) and a
batch norm's ``<name>.mean`` / ``.var`` buffers (flax's ``batch_stats``),
the submodule names of text/bert.py under the layer's name, and the flax
cells' own names for the recurrent layers (``GRUCell_0.ir.weight``;
a ``Bidirectional``'s forward and backward cells ``<name>.GRUCell_0`` and
``<name>.GRUCell_1``, as flax names them inside the JAX layer);
``SeparableConv2D`` nests ``<name>.depthwise`` and ``<name>.pointwise``
as flax does.

The rest of JAX's library: the shape layers (``Reshape``, ``Permute``,
``ExpandDim``, ``Squeeze``, ``RepeatVector``, ``Select``,
``SelectTable``, ``GetShape``, ``Masking``, ``Constant``), cropping,
upsampling and ``ResizeBilinear``, the elementwise and threshold
layers, the layers with flax ``self.param`` leaves (``CAdd``, ``CMul``,
``Scale``, ``Mul``, ``PReLU``, ``SReLU``: ``_Params``, convert.py keeps
their names), the randomized ones (``RReLU``, ``GaussianNoise``,
``GaussianDropout``, ``GaussianSampler``, ``SpatialDropout1D/2D/3D``:
their draws from torch's generator, as ``Dropout``'s), the dilated,
transposed and shared convolutions, ``LocallyConnected1D/2D`` (a kernel
of their own shape), ``ConvLSTM2D/3D`` (flax's ``ConvLSTMCell_<n>``),
``WithinChannelLRN2D``, ``Highway``, ``MaxoutDense`` and ``SparseDense``.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from analytics_zoo_tpu_torch.common.flax_compat import (Conv, _tuple,
                                                        canonical_padding)
from analytics_zoo_tpu_torch.keras.engine import KerasLayer as _KerasLayerBase
from analytics_zoo_tpu_torch.keras.engine import Node, flax_autoname


class KerasLayer(_KerasLayerBase):
    """Layer base that records ``input_shape`` (used when a layer opens a
    Sequential), snapshots the dtype policy at construction and holds the
    layer's weight regularizers."""

    def __init__(self, name=None, input_shape=None):
        super().__init__(name)
        self.input_shape = tuple(input_shape) if input_shape is not None \
            else None
        from analytics_zoo_tpu_torch.keras import policy as _policy
        self.compute_dtype = _policy.compute_dtype()
        # flax leaf name ("kernel"/"bias") -> regularizer; the model adds
        # them up into one penalty on the training loss (ref BigDL
        # wRegularizer/bRegularizer on every layer)
        self.param_regularizers = {}

    def _set_regularizers(self, W_regularizer=None, b_regularizer=None):
        from analytics_zoo_tpu_torch.keras import regularizers as reg_lib
        if W_regularizer is not None:
            self.param_regularizers["kernel"] = reg_lib.get(W_regularizer)
        if b_regularizer is not None:
            self.param_regularizers["bias"] = reg_lib.get(b_regularizer)

    def penalty(self, lparams):
        """The regularization penalty of this layer's parameters, given as
        ``{flax leaf name: tensor}``. A kernel enters in the torch layout:
        Σ|w| and Σw² do not depend on it."""
        total = 0.0
        for key, reg in self.param_regularizers.items():
            if key in lparams:
                total += reg(lparams[key])
        return total


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
        self.output_dim = int(output_dim)
        self.activation = get_activation(activation)
        self.init = get_init(init)
        self.bias = bias
        self._set_regularizers(W_regularizer, b_regularizer)

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


class Narrow(KerasLayer):
    """``length`` elements from ``offset`` along ``dim`` (ref
    Narrow.scala; JAX ``lax.slice_in_dim``). ``dim`` counts the batch
    dimension, as in JAX."""

    def __init__(self, dim: int, offset: int, length: int = 1,
                 input_shape=None, name=None):
        super().__init__(name, input_shape)
        self.dim, self.offset, self.length = dim, offset, length

    def apply(self, modules, args, train):
        return args[0].narrow(self.dim, self.offset, self.length)

    def _infer_shape(self, in_shapes):
        s = in_shapes[0]
        if s is None:
            return None
        # shapes leave out the batch dimension
        ax = self.dim - 1 if self.dim >= 0 else len(s) + self.dim
        out = list(s)
        out[ax] = self.length
        return tuple(out)


class Lambda(KerasLayer):
    """Wrap an arbitrary torch function (ref autograd.py Lambda:393).
    A layer after it that owns parameters needs its input width when the
    modules are built: the output shape is found by calling the function
    once on meta tensors (a batch of 2, no data), or given as
    ``output_shape`` (without the batch dimension, the port's addition)
    where that cannot work (an input of unknown length, a function that
    leaves torch)."""

    def __init__(self, function: Callable, output_shape=None,
                 input_shape=None, name=None):
        super().__init__(name, input_shape)
        self.function = function
        self.output_shape = tuple(output_shape) \
            if output_shape is not None else None

    def apply(self, modules, args, train):
        return self.function(*args)

    def _infer_shape(self, in_shapes):
        if self.output_shape is not None:
            return self.output_shape
        if any(s is None or None in s for s in in_shapes):
            return None
        try:
            out = self.function(*[torch.empty((2,) + tuple(s), device="meta")
                                  for s in in_shapes])
        except Exception:
            return None
        return tuple(out.shape[1:]) if isinstance(out, torch.Tensor) \
            else None


def _flax_default_fill(module: nn.Module, generator: torch.Generator):
    """flax's default kernel init for a freshly built module: each weight
    of two or more dims normal with variance 1 / fan-in (the flattened
    kernel's second axis, ``[out, prod(k) * in / groups]``); biases stay
    as the module made them (zeros)."""
    with torch.no_grad():
        for p in module.parameters():
            if p.dim() >= 2:
                p.normal_(0.0, p.shape[1] ** -0.5, generator=generator)


def _meta_shape(module: nn.Module, in_shapes, **kwargs):
    """The output shape (without the batch) of ``module`` on inputs of
    ``in_shapes``, found on meta tensors (no data); None where unknown."""
    import copy
    if any(s is None or None in s for s in in_shapes):
        return None
    try:
        meta = copy.deepcopy(module).to("meta")
        out = meta(*[torch.empty((2,) + tuple(s), device="meta")
                     for s in in_shapes], **kwargs)
    except Exception:
        return None
    return tuple(out.shape[1:]) if isinstance(out, torch.Tensor) else None


class KerasLayerWrapper(KerasLayer):
    """A module of the port as a keras layer (ref wrappers.py:86
    KerasLayerWrapper; JAX wraps a flax module, the port wraps its
    counterpart, e.g. ``flax_compat.Conv(..., feature_group_count=c)``).
    Its parameters train with the rest of the model under the layer's
    name. Each model built from the layer gets its own copy of the
    module, its weights drawn by flax's default init from the graph's
    generator. ``call_with_train=True`` passes the keras train flag as
    the module's ``train=`` keyword (for modules with dropout or
    norms)."""

    def __init__(self, module: nn.Module, call_with_train: bool = False,
                 input_shape=None, name=None):
        super().__init__(name or getattr(module, "name", None), input_shape)
        self.module = module
        self.call_with_train = bool(call_with_train)

    def make_modules(self, in_shapes, generator):
        import copy
        mod = copy.deepcopy(self.module)
        _flax_default_fill(mod, generator)
        return {self.name: mod}

    def apply(self, modules, args, train):
        if self.call_with_train:
            return modules[self.name](*args, train=train)
        return modules[self.name](*args)

    def _infer_shape(self, in_shapes):
        kw = {"train": False} if self.call_with_train else {}
        return _meta_shape(self.module, in_shapes, **kw)


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
    ``use_kernel`` goes to ``fused_embedding_lookup`` (True on the CPU and
    False on CUDA raise there, ROADMAP C26).

    Each table is a top-level module named ``table_name``, so the
    ``state_dict`` carries the flax tree's names (``mlp_user_embed.
    embedding``)."""

    def __init__(self, specs, combine: str = "concat", init="uniform",
                 zero_based_id: bool = True,
                 use_kernel: Optional[bool] = None,
                 input_shape=None, name=None):
        super().__init__(name, input_shape)
        self.specs = [(str(n), int(v), int(d)) for n, v, d in specs]
        self.use_kernel = use_kernel
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
        return fused_embedding_lookup(tables, ids, combine=self.combine,
                                      use_kernel=self.use_kernel)

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


class _FrozenTable(nn.Module):
    """A frozen word-embedding table: a buffer, not a parameter (no
    gradient, no optimizer state), and left out of the ``state_dict`` and
    so of the checkpoint's trees, as JAX keeps it a closure constant."""

    def __init__(self, table: torch.Tensor):
        super().__init__()
        self.register_buffer("table", table, persistent=False)


class WordEmbedding(KerasLayer):
    """Pretrained word-embedding lookup, frozen by default (ref
    zoo/.../keras/layers/WordEmbedding.scala:49; JAX ``WordEmbedding``).
    ``weights``: ``[vocab, dim]``. A frozen table is a buffer of a
    ``_FrozenTable`` (nothing in the flax tree); a trainable one is a
    normal ``<name>.embedding`` parameter initialised to ``weights``.
    ``zero_based_id=False`` subtracts 1 from each id (at least 0)."""

    def __init__(self, weights: np.ndarray, trainable: bool = False,
                 zero_based_id: bool = True, input_shape=None, name=None):
        super().__init__(name, input_shape)
        self.weights = np.asarray(weights, np.float32)
        self.trainable = trainable
        self.zero_based_id = zero_based_id

    @classmethod
    def from_glove(cls, path: str, word_index: dict, dim: int,
                   trainable: bool = False, **kw) -> "WordEmbedding":
        """From a GloVe text file and a ``{word: 1-based index}``
        vocabulary (ref WordEmbedding.scala's loader). Row 0 is the zero
        pad vector and word k's vector is row k, so ids look up directly
        (``feature/text.load_glove``'s convention)."""
        table = np.zeros((max(word_index.values()) + 1, dim), np.float32)
        with open(path, "r", encoding="utf-8") as fh:
            for line in fh:
                parts = line.rstrip().split(" ")
                if parts[0] in word_index and len(parts) == dim + 1:
                    table[word_index[parts[0]]] = np.asarray(parts[1:],
                                                             np.float32)
        return cls(table, trainable=trainable, zero_based_id=True, **kw)

    def make_modules(self, in_shapes, generator):
        table = torch.from_numpy(self.weights.copy())
        if not self.trainable:
            return {self.name: _FrozenTable(table)}
        mod = _EmbedTable(*self.weights.shape)
        with torch.no_grad():
            mod.embedding.copy_(table)
        return {self.name: mod}

    def apply(self, modules, args, train):
        from analytics_zoo_tpu_torch.ops.embedding_bag import (
            embedding_lookup,
        )
        ids = args[0].to(torch.int32)
        if not self.zero_based_id:
            ids = torch.clamp(ids - 1, min=0)
        mod = modules[self.name]
        if self.trainable:
            # flax nn.Embed: jnp.take of the table cast to the dtype
            table = mod.embedding
            if self.compute_dtype is not None:
                table = table.to(self.compute_dtype)
            return embedding_lookup(table, ids)
        # JAX indexes the constant (ids clamped into the table), then
        # casts
        vocab = mod.table.shape[0]
        ids = torch.where(ids < 0, ids + vocab, ids).clamp(0, vocab - 1)
        out = mod.table[ids.long()]
        return out if self.compute_dtype is None \
            else out.to(self.compute_dtype)

    def _infer_shape(self, in_shapes):
        s = in_shapes[0]
        return tuple(s) + (self.weights.shape[1],) if s is not None \
            else None


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
#
# Under a compute dtype (keras/policy.py) a cell does what flax's does with
# ``dtype=bfloat16``, dtype for dtype: each Dense casts its input, kernel
# and bias to bf16, rounds the product to bf16 and adds the bias in bf16;
# the gates are bf16; the carry starts in the parameters' dtype (flax's
# ``initialize_carry`` uses ``param_dtype``), so LSTM's ``f * c + i * g``
# and GRU's ``(1 - z) * n + z * h`` promote to fp32 and the outputs come
# out fp32. SimpleCell's new carry is its bf16 activation: flax's scan
# refuses a carry whose dtype changes, and so does ``run_cell``.


def _dense(x, w, b, dtype):
    """One side's gates: ``x W^T + b``. Under a compute dtype, flax's
    ``Dense``: the input cast, the product rounded to the dtype, the bias
    added in it. A calibrated int8 cell's side is not a tensor but its
    integer product (inference/quantize.py ``Int8Side``), called on ``x``
    and the bias."""
    if not isinstance(w, torch.Tensor):
        return w(x, b)
    if dtype is None:
        return F.linear(x, w, b)
    y = F.linear(x.to(dtype), w)
    return y if b is None else y + b

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
                 generator: torch.Generator,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        for gates, fan_in in ((self.INPUT, in_features),
                              (self.RECURRENT, features)):
            for name, bias in gates:
                self.add_module(name, _linear(fan_in, features, bias,
                                              generator))
        self.features = int(features)
        self.activation = activation
        #: the compute dtype (None: the parameters' own)
        self.dtype = dtype

    def _side(self, gates):
        mods = [self._modules[n] for n, _ in gates]
        w = torch.cat([m.weight for m in mods])
        if not any(b for _, b in gates):
            b = None
        else:
            # a gate without a flax bias (GRU's hr, hz) adds a zero one:
            # x + 0 is x
            b = torch.cat([m.bias if m.bias is not None
                           else torch.zeros_like(m.weight[:, 0])
                           for m in mods])
        if self.dtype is not None:
            w = w.to(self.dtype)
            b = None if b is None else b.to(self.dtype)
        return w, b

    def weights(self):
        """The concatenated input-side and recurrent weights and biases,
        made (and cast to the compute dtype) once per forward."""
        return self._side(self.INPUT), self._side(self.RECURRENT)

    def _zeros(self, x0: torch.Tensor) -> torch.Tensor:
        # flax's initialize_carry: zeros in the parameters' dtype
        return torch.zeros((x0.shape[0], self.features), device=x0.device,
                           dtype=self._modules[self.INPUT[0][0]].weight.dtype)

    def init_carry(self, x0: torch.Tensor):
        return self._zeros(x0)

    def output(self, carry) -> torch.Tensor:
        return carry

    def hidden(self, carry) -> torch.Tensor:
        """The recurrent Denses' input (the hidden state) in ``carry``."""
        return carry


class GRUCellModule(_RNNCell):
    """flax ``GRUCell``: ``r = σ(ir x + hr h)``, ``z = σ(iz x + hz h)``,
    ``n = act(in x + r ⊙ (hn h + b_hn))``, ``h' = (1 - z) ⊙ n + z ⊙ h``."""

    INPUT = (("ir", True), ("iz", True), ("in", True))
    RECURRENT = (("hr", False), ("hz", False), ("hn", True))

    def step(self, x, h, w):
        (wi, bi), (wh, bh) = w
        gi = _dense(x, wi, bi, self.dtype)
        gh = _dense(h, wh, bh, self.dtype)
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
        zero = self._zeros(x0)
        return zero, zero

    def output(self, carry):
        return carry[1]

    def hidden(self, carry):
        return carry[1]

    def step(self, x, carry, w):
        (wi, _), (wh, bh) = w
        c, h = carry
        s = _dense(h, wh, bh, self.dtype) + _dense(x, wi, None, self.dtype)
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
        return self.activation(_dense(x, wi, bi, self.dtype) +
                               _dense(h, wh, None, self.dtype))


def _dtypes(carry):
    return tuple(t.dtype for t in carry) if isinstance(carry, tuple) \
        else (carry.dtype,)


def run_cell(cell: _RNNCell, x: torch.Tensor, reverse: bool = False,
             keep_order: bool = False) -> torch.Tensor:
    """flax ``nn.RNN(cell, reverse=, keep_order=)(x)``: every step's
    output, ``[batch, time, features]``. ``reverse`` reads the sequence
    from its end; the outputs stay in reading order unless
    ``keep_order``. A carry whose dtype changes across a step raises
    ``TypeError``, as flax's scan does."""
    steps = (torch.flip(x, dims=(1,)) if reverse else x).transpose(
        0, 1).contiguous()                      # [time, batch, in]
    w = cell.weights()
    carry = cell.init_carry(steps[0])
    want = _dtypes(carry)
    # int8 calibration (inference/quantize.py) observes each step's inputs
    observe = cell.__dict__.get("_zoo_observe")
    outs = []
    for x_t in steps:
        if observe is not None:
            observe(x_t, cell.hidden(carry))
        carry = cell.step(x_t, carry, w)
        if _dtypes(carry) != want:
            raise TypeError(
                f"scan body function carry input and carry output must have "
                f"equal types, but they differ: the input carry has dtype "
                f"{want} and the output carry {_dtypes(carry)} "
                f"({type(cell).__name__} under the compute dtype "
                f"{cell.dtype}; flax refuses it alike)")
        outs.append(cell.output(carry))
    out = torch.stack(outs, dim=1)
    return torch.flip(out, dims=(1,)) if reverse and keep_order else out


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

    def make_cell(self, in_shape, generator) -> _RNNCell:
        """A cell for inputs of ``in_shape``, computing in the layer's
        compute dtype (flax's cell ``dtype``)."""
        if not in_shape or in_shape[-1] is None:
            raise ValueError(f"{self.name}: input width unknown; give the "
                             "model's Input a shape")
        return self.cell_cls(int(in_shape[-1]), self.output_dim,
                             get_activation(self.activation), generator,
                             dtype=self.compute_dtype)

    def make_modules(self, in_shapes, generator):
        return {flax_autoname(self.flax_cell):
                self.make_cell(in_shapes[0], generator)}

    def apply(self, modules, args, train):
        (cell,) = modules.values()
        # flax RNN(reverse=go_backwards, keep_order=False): outputs in the
        # order the sequence was read
        out = run_cell(cell, args[0], reverse=self.go_backwards)
        return out if self.return_sequences else out[:, -1]

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


class _BiCells(nn.Module):
    """The two cells of a ``Bidirectional``, named as flax names them
    inside the JAX layer's module: the forward cell ``<Cell>_0``, the
    backward one ``<Cell>_1``."""

    def __init__(self, flax_cell: str, forward: _RNNCell,
                 backward: _RNNCell):
        super().__init__()
        self.names = (f"{flax_cell}_0", f"{flax_cell}_1")
        self.add_module(self.names[0], forward)
        self.add_module(self.names[1], backward)

    def cells(self):
        return self._modules[self.names[0]], self._modules[self.names[1]]


class Bidirectional(KerasLayer):
    """(ref keras Bidirectional; JAX ``Bidirectional``) The wrapped
    recurrent layer's cell run forward and backward over the sequence:
    the backward outputs come back in the sequence's order (flax's
    ``keep_order=True``), so without ``return_sequences`` the layer takes
    the forward's last step and the backward's first. ``merge_mode``:
    concat, sum, mul or ave."""

    def __init__(self, layer: _RNNBase, merge_mode: str = "concat",
                 name=None):
        super().__init__(name)
        self.layer = layer
        self.merge_mode = merge_mode

    def make_modules(self, in_shapes, generator):
        inner = self.layer
        return {self.name: _BiCells(
            inner.flax_cell, inner.make_cell(in_shapes[0], generator),
            inner.make_cell(in_shapes[0], generator))}

    def apply(self, modules, args, train):
        fwd_cell, bwd_cell = modules[self.name].cells()
        fwd = run_cell(fwd_cell, args[0])
        bwd = run_cell(bwd_cell, args[0], reverse=True, keep_order=True)
        if not self.layer.return_sequences:
            fwd, bwd = fwd[:, -1], bwd[:, 0]
        if self.merge_mode == "concat":
            return torch.cat([fwd, bwd], dim=-1)
        if self.merge_mode == "sum":
            return fwd + bwd
        if self.merge_mode == "mul":
            return fwd * bwd
        if self.merge_mode == "ave":
            return (fwd + bwd) / 2
        raise ValueError(f"bad merge_mode {self.merge_mode}")

    def _infer_shape(self, in_shapes):
        inner = self.layer._infer_shape(in_shapes)
        if inner is None or self.merge_mode != "concat":
            return inner
        return tuple(inner[:-1]) + (2 * inner[-1],)


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


class BatchNormalization(KerasLayer):
    """(ref keras BatchNormalization; JAX ``nn.BatchNorm`` over the last
    axis). Train mode (``fit``) normalises by the batch's statistics and
    moves the running ones; eval mode (``evaluate``, ``predict``) uses the
    running ones (``flax_compat.BatchNorm``)."""

    def __init__(self, epsilon: float = 1e-3, momentum: float = 0.99,
                 input_shape=None, name=None):
        super().__init__(name, input_shape)
        self.epsilon, self.momentum = epsilon, momentum

    def make_modules(self, in_shapes, generator):
        from analytics_zoo_tpu_torch.common.flax_compat import BatchNorm
        s = in_shapes[0]
        if not s or s[-1] is None:
            raise ValueError(f"{self.name}: input width unknown")
        return {self.name: BatchNorm(int(s[-1]), momentum=self.momentum,
                                     eps=self.epsilon,
                                     dtype=self.compute_dtype)}

    def apply(self, modules, args, train):
        return modules[self.name](args[0], train=train)

    def _infer_shape(self, in_shapes):
        return in_shapes[0]


# ---------------- convolutions / pooling ----------------

def _window_shape(spatial, window, strides, padding, dilation=None):
    """The spatial output shape of a window op, None where unknown."""
    from analytics_zoo_tpu_torch.common.flax_compat import (out_size,
                                                            resolve_pads)
    if any(d is None for d in spatial):
        return None
    dilation = dilation or (1,) * len(window)
    pads = resolve_pads(padding, spatial, window, strides, dilation)
    return tuple(out_size(n, k, s, d, lo, hi) for n, k, s, d, (lo, hi)
                 in zip(spatial, window, strides, dilation, pads))


def _conv_fill(init, weight: torch.Tensor, fan_in: int, fan_out: int,
               generator: torch.Generator) -> None:
    """A convolution's initial weight: glorot over the kernel's fans (as
    flax's initializers count them for ``[*k, in, out]``), any other
    init as it fills a Dense."""
    if init is _glorot_uniform:
        limit = math.sqrt(6.0 / (fan_in + fan_out))
        weight.uniform_(-limit, limit, generator=generator)
    else:
        init(weight, generator)


class _Conv(KerasLayer):
    """A convolution over ``[batch, *spatial, channels]`` (JAX
    ``nn.Conv``): subclasses set ``kernel``, ``strides``, ``padding`` and
    ``dilation``."""

    def _setup(self, nb_filter, kernel, strides, padding, dilation,
               activation, init, bias, W_regularizer=None,
               b_regularizer=None):
        self.nb_filter = int(nb_filter)
        self.kernel = tuple(int(k) for k in kernel)
        self.strides = tuple(int(s) for s in strides)
        self.padding = padding
        self.dilation = tuple(int(d) for d in dilation)
        self.activation = get_activation(activation)
        self.init = get_init(init)
        self.bias = bias
        self._set_regularizers(W_regularizer, b_regularizer)

    def make_modules(self, in_shapes, generator):
        from analytics_zoo_tpu_torch.common import flax_compat
        s = in_shapes[0]
        if not s or s[-1] is None:
            raise ValueError(f"{self.name}: input width unknown; give the "
                             "model's Input a shape")
        conv = flax_compat.Conv(int(s[-1]), self.nb_filter, self.kernel,
                                self.dilation, bias=self.bias,
                                dtype=self.compute_dtype,
                                strides=self.strides, padding=self.padding)
        area = math.prod(self.kernel)
        with torch.no_grad():
            _conv_fill(self.init, conv.weight, area * int(s[-1]),
                       area * self.nb_filter, generator)
            if conv.bias is not None:
                conv.bias.zero_()
        return {self.name: conv}

    def apply(self, modules, args, train):
        return self.activation(modules[self.name](args[0]))

    def _infer_shape(self, in_shapes):
        s = in_shapes[0]
        if not s:
            return None
        pad = canonical_padding(self.padding, len(self.kernel))
        out = _window_shape(s[:-1], self.kernel, self.strides, pad,
                            self.dilation)
        return None if out is None else out + (self.nb_filter,)


class Conv1D(_Conv):
    """(ref Convolution1D) input ``[batch, steps, channels]``."""

    def __init__(self, nb_filter: int, filter_length: int, activation=None,
                 border_mode: str = "valid", subsample_length: int = 1,
                 init="glorot_uniform", bias: bool = True,
                 dilation_rate: int = 1, W_regularizer=None,
                 b_regularizer=None, input_shape=None, name=None):
        super().__init__(name, input_shape)
        self._setup(nb_filter, (filter_length,), (subsample_length,),
                    border_mode.upper(), (dilation_rate,), activation, init,
                    bias, W_regularizer, b_regularizer)


Convolution1D = Conv1D


class Conv2D(_Conv):
    """(ref Convolution2D) input ``[batch, h, w, channels]``;
    ``border_mode`` "same"/"valid", an int, a pair or ``((top, bottom),
    (left, right))``."""

    def __init__(self, nb_filter: int, nb_row: int, nb_col: int,
                 activation=None, border_mode="valid", subsample=(1, 1),
                 init="glorot_uniform", bias: bool = True,
                 W_regularizer=None, b_regularizer=None, input_shape=None,
                 name=None):
        super().__init__(name, input_shape)
        self._setup(nb_filter, (nb_row, nb_col), _tuple(subsample, 2),
                    canonical_padding(border_mode, 2), (1, 1), activation,
                    init, bias, W_regularizer, b_regularizer)


Convolution2D = Conv2D


class Conv3D(_Conv):
    """(ref Convolution3D) input ``[batch, d1, d2, d3, channels]``."""

    def __init__(self, nb_filter: int, kernel_dim1: int, kernel_dim2: int,
                 kernel_dim3: int, activation=None, border_mode="valid",
                 subsample=(1, 1, 1), init="glorot_uniform",
                 bias: bool = True, input_shape=None, name=None):
        super().__init__(name, input_shape)
        self._setup(nb_filter, (kernel_dim1, kernel_dim2, kernel_dim3),
                    _tuple(subsample, 3), canonical_padding(border_mode, 3),
                    (1, 1, 1),
                    activation, init, bias)


Convolution3D = Conv3D


class _Separable(nn.Module):
    """A depthwise convolution (``c * depth_multiplier`` outputs, one
    group an input channel) then a 1x1 pointwise one, both with a bias:
    the flax tree ``{depthwise: {kernel, bias}, pointwise: {...}}``."""

    def __init__(self, depthwise: nn.Module, pointwise: nn.Module):
        super().__init__()
        self.depthwise = depthwise
        self.pointwise = pointwise

    def forward(self, x):
        return self.pointwise(self.depthwise(x))


class SeparableConv2D(KerasLayer):
    """Depthwise spatial convolution (``depth_multiplier`` outputs an
    input channel) followed by a 1x1 pointwise mix (ref
    convolutional.py:313 SeparableConvolution2D); ``border_mode``
    "same"/"valid"."""

    def __init__(self, nb_filter: int, nb_row: int, nb_col: int,
                 activation=None, border_mode="valid", subsample=(1, 1),
                 depth_multiplier: int = 1, input_shape=None, name=None):
        super().__init__(name, input_shape)
        self.nb_filter, self.kernel = int(nb_filter), (int(nb_row),
                                                       int(nb_col))
        self.activation = get_activation(activation)
        self.padding = border_mode.upper()
        self.strides = _tuple(subsample, 2)
        self.depth_multiplier = int(depth_multiplier)

    def make_modules(self, in_shapes, generator):
        from analytics_zoo_tpu_torch.common import flax_compat
        s = in_shapes[0]
        if not s or s[-1] is None:
            raise ValueError(f"{self.name}: input width unknown; give the "
                             "model's Input a shape")
        c = int(s[-1])
        mid = c * self.depth_multiplier
        sep = _Separable(
            flax_compat.Conv(c, mid, self.kernel, dtype=self.compute_dtype,
                             strides=self.strides, padding=self.padding,
                             feature_group_count=c),
            flax_compat.Conv(mid, self.nb_filter, (1, 1),
                             dtype=self.compute_dtype, padding="SAME"))
        _flax_default_fill(sep, generator)
        return {self.name: sep}

    def apply(self, modules, args, train):
        return self.activation(modules[self.name](args[0]))

    def _infer_shape(self, in_shapes):
        s = in_shapes[0]
        if not s:
            return None
        out = _window_shape(s[:-1], self.kernel, self.strides,
                            canonical_padding(self.padding, 2))
        return None if out is None else out + (self.nb_filter,)


SeparableConvolution2D = SeparableConv2D


class LRN2D(KerasLayer):
    """Cross-channel local response normalization over the last axis
    (ref convolutional.py LRN2D; BigDL SpatialCrossMapLRN's convention:
    ``alpha`` is divided by the window ``n``). The squared input is
    zero-padded on the channel axis and its ``n`` shifted slices are
    summed from the first, in JAX's order."""

    def __init__(self, alpha: float = 1e-4, k: float = 1.0,
                 beta: float = 0.75, n: int = 5, input_shape=None,
                 name=None):
        super().__init__(name, input_shape)
        self.alpha, self.k, self.beta, self.n = alpha, k, beta, n

    def apply(self, modules, args, train):
        x = args[0]
        c = x.shape[-1]
        half = self.n // 2
        pad = F.pad(torch.square(x), (half, half))
        win = pad[..., 0:c]
        for i in range(1, self.n):
            win = win + pad[..., i:i + c]
        return x / torch.pow(self.k + (self.alpha / self.n) * win,
                             self.beta)

    def _infer_shape(self, in_shapes):
        return in_shapes[0]


_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_AVG_POOL = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}


def pool(x: torch.Tensor, op: str, window, strides, padding):
    """flax ``max_pool`` / ``avg_pool`` (``lax.reduce_window``) on ``[batch,
    *spatial, channels]``: a max pool's padding is -inf, an average
    pool's is zeros counted in the mean (the window's full size divides).
    Symmetric padding of at most half the window rides torch's pool;
    other padding is ``F.pad`` first."""
    from analytics_zoo_tpu_torch.common import flax_compat as fc
    pads = fc.resolve_pads(padding, x.shape[1:-1], window, strides)
    if all(lo == hi and 2 * lo <= k for (lo, hi), k in zip(pads, window)):
        p = tuple(lo for lo, _ in pads)
    else:
        x = fc.pad_last(x, pads, float("-inf") if op == "max" else 0.0)
        p = 0
    xc = fc.channels_first(x)
    if op == "max":
        y = _MAX_POOL[len(window)](xc, window, strides, padding=p)
    else:
        y = _AVG_POOL[len(window)](xc, window, strides, padding=p,
                                   count_include_pad=True)
    return fc.channels_last(y)


class _Pool(KerasLayer):
    """JAX ``_Pool``: ``border_mode`` "valid"/"same", an int per side, or
    ``((lo, hi), ...)`` pairs (ceil-mode parity)."""

    op = "max"

    def __init__(self, pool_size, strides=None, border_mode="valid",
                 input_shape=None, name=None):
        super().__init__(name, input_shape)
        self.pool_size = tuple(pool_size)
        self.strides = tuple(strides or pool_size)
        self.padding = canonical_padding(border_mode, len(self.pool_size))

    def apply(self, modules, args, train):
        return pool(args[0], self.op, self.pool_size, self.strides,
                    self.padding)

    def _infer_shape(self, in_shapes):
        s = in_shapes[0]
        if not s:
            return None
        out = _window_shape(s[:-1], self.pool_size, self.strides,
                            self.padding)
        return None if out is None else out + (s[-1],)


class MaxPooling1D(_Pool):
    def __init__(self, pool_length: int = 2, stride=None,
                 border_mode="valid", input_shape=None, name=None):
        super().__init__((pool_length,), (stride or pool_length,),
                         border_mode, input_shape=input_shape, name=name)


class AveragePooling1D(MaxPooling1D):
    op = "avg"


class MaxPooling2D(_Pool):
    def __init__(self, pool_size=(2, 2), strides=None, border_mode="valid",
                 input_shape=None, name=None):
        super().__init__(_tuple(pool_size, 2),
                         _tuple(strides or pool_size, 2),
                         border_mode, input_shape=input_shape, name=name)


class AveragePooling2D(MaxPooling2D):
    op = "avg"


class MaxPooling3D(_Pool):
    def __init__(self, pool_size=(2, 2, 2), strides=None,
                 border_mode="valid", input_shape=None, name=None):
        super().__init__(_tuple(pool_size, 3),
                         _tuple(strides or pool_size, 3),
                         border_mode, input_shape=input_shape, name=name)


class AveragePooling3D(MaxPooling3D):
    op = "avg"


class _GlobalPool(KerasLayer):
    """A max or mean over the spatial axes ``1 .. rank``."""

    op, rank = "max", 1

    def apply(self, modules, args, train):
        dims = tuple(range(1, self.rank + 1))
        x = args[0]
        return x.amax(dim=dims) if self.op == "max" else x.mean(dim=dims)

    def _infer_shape(self, in_shapes):
        s = in_shapes[0]
        return None if not s else (s[-1],)


class GlobalMaxPooling1D(_GlobalPool):
    op, rank = "max", 1


class GlobalAveragePooling1D(_GlobalPool):
    op, rank = "avg", 1


class GlobalMaxPooling2D(_GlobalPool):
    op, rank = "max", 2


class GlobalAveragePooling2D(_GlobalPool):
    op, rank = "avg", 2


class GlobalMaxPooling3D(_GlobalPool):
    op, rank = "max", 3


class GlobalAveragePooling3D(_GlobalPool):
    op, rank = "avg", 3


class _ZeroPadding(KerasLayer):
    """Zeros around the spatial axes: ``pads`` holds a ``(lo, hi)`` pair
    per spatial dim."""

    pads: Tuple[Tuple[int, int], ...] = ()

    def apply(self, modules, args, train):
        from analytics_zoo_tpu_torch.common.flax_compat import pad_last
        return pad_last(args[0], self.pads)

    def _infer_shape(self, in_shapes):
        s = in_shapes[0]
        if not s:
            return None
        sp = tuple(None if n is None else n + lo + hi
                   for n, (lo, hi) in zip(s[:-1], self.pads))
        return sp + (s[-1],)


class ZeroPadding1D(_ZeroPadding):
    def __init__(self, padding: int = 1, input_shape=None, name=None):
        super().__init__(name, input_shape)
        self.padding = _tuple(padding, 2)
        self.pads = (self.padding,)


class ZeroPadding2D(_ZeroPadding):
    def __init__(self, padding=(1, 1), input_shape=None, name=None):
        super().__init__(name, input_shape)
        self.padding = _tuple(padding, 2)
        self.pads = tuple((p, p) for p in self.padding)


class ZeroPadding3D(_ZeroPadding):
    def __init__(self, padding=(1, 1, 1), input_shape=None, name=None):
        super().__init__(name, input_shape)
        self.padding = _tuple(padding, 3)
        self.pads = tuple((p, p) for p in self.padding)


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


# ---------------- shape layers ----------------

class Reshape(KerasLayer):
    """``[batch, *target_shape]`` (one entry may be -1)."""

    def __init__(self, target_shape, input_shape=None, name=None):
        super().__init__(name, input_shape)
        self.target_shape = tuple(target_shape)

    def apply(self, modules, args, train):
        x = args[0]
        return x.reshape((x.shape[0],) + self.target_shape)

    def _infer_shape(self, in_shapes):
        if -1 not in self.target_shape:
            return self.target_shape
        s = in_shapes[0]
        if s is None or None in s:
            return None
        known = math.prod(d for d in self.target_shape if d != -1)
        return tuple(math.prod(s) // known if d == -1 else d
                     for d in self.target_shape)


class Permute(KerasLayer):
    """``dims`` 1-based over the non-batch dims (keras convention)."""

    def __init__(self, dims, input_shape=None, name=None):
        super().__init__(name, input_shape)
        self.dims = tuple(dims)

    def apply(self, modules, args, train):
        return args[0].permute((0,) + self.dims)

    def _infer_shape(self, in_shapes):
        s = in_shapes[0]
        return tuple(s[d - 1] for d in self.dims) if s else None


class RepeatVector(KerasLayer):
    def __init__(self, n: int, input_shape=None, name=None):
        super().__init__(name, input_shape)
        self.n = n

    def apply(self, modules, args, train):
        x = args[0]
        return x[:, None, :].expand(x.shape[0], self.n, *x.shape[1:]) \
            .contiguous()

    def _infer_shape(self, in_shapes):
        s = in_shapes[0]
        return (self.n,) + tuple(s) if s else None


def _batch_axis(s, dim: int, extra: int = 0) -> int:
    """The position in the shape without the batch of axis ``dim`` of the
    batched tensor (``dim`` counts the batch, as JAX's layers do)."""
    return dim - 1 if dim >= 0 else len(s) + extra + dim


class Squeeze(KerasLayer):
    """``dim`` counts the batch dimension, as in JAX."""

    def __init__(self, dim: int, input_shape=None, name=None):
        super().__init__(name, input_shape)
        self.dim = dim

    def apply(self, modules, args, train):
        return args[0].squeeze(self.dim)

    def _infer_shape(self, in_shapes):
        s = in_shapes[0]
        if s is None:
            return None
        out = list(s)
        del out[_batch_axis(s, self.dim)]
        return tuple(out)


class ExpandDim(KerasLayer):
    """``dim`` counts the batch dimension, as in JAX."""

    def __init__(self, dim: int, input_shape=None, name=None):
        super().__init__(name, input_shape)
        self.dim = dim

    def apply(self, modules, args, train):
        return args[0].unsqueeze(self.dim)

    def _infer_shape(self, in_shapes):
        s = in_shapes[0]
        if s is None:
            return None
        out = list(s)
        out.insert(_batch_axis(s, self.dim, extra=1), 1)
        return tuple(out)


class Select(KerasLayer):
    """One index along ``dim`` (ref Select.scala; ``dim`` counts the
    batch)."""

    def __init__(self, dim: int, index: int, input_shape=None, name=None):
        super().__init__(name, input_shape)
        self.dim, self.index = dim, index

    def apply(self, modules, args, train):
        return args[0].select(self.dim, self.index)

    def _infer_shape(self, in_shapes):
        s = in_shapes[0]
        if s is None:
            return None
        out = list(s)
        del out[_batch_axis(s, self.dim)]
        return tuple(out)


class Constant(KerasLayer):
    """``value`` as a tensor (fp32 for floats, int32 for integers, as JAX
    makes it), on the device of the layer's input where it has one."""

    def __init__(self, value, name=None):
        super().__init__(name)
        self.value = value

    def apply(self, modules, args, train):
        arr = np.asarray(self.value)
        if arr.dtype.kind == "f":
            arr = arr.astype(np.float32)
        elif arr.dtype.kind in "iu":
            arr = arr.astype(np.int32)
        dev = args[0].device if args and isinstance(args[0], torch.Tensor) \
            else None
        return torch.as_tensor(arr, device=dev)


class Masking(KerasLayer):
    """Zero every step whose features all equal ``mask_value``."""

    def __init__(self, mask_value: float = 0.0, input_shape=None, name=None):
        super().__init__(name, input_shape)
        self.mask_value = mask_value

    def apply(self, modules, args, train):
        x = args[0]
        keep = torch.any(x != self.mask_value, dim=-1, keepdim=True)
        return x * keep.to(x.dtype)

    def _infer_shape(self, in_shapes):
        return in_shapes[0]


class GetShape(KerasLayer):
    """The input's shape as an int32 tensor."""

    def apply(self, modules, args, train):
        return torch.tensor(tuple(args[0].shape), dtype=torch.int32,
                            device=args[0].device)


class SelectTable(KerasLayer):
    """The ``index``-th input of a multi-input call (ref torch.py
    SelectTable)."""

    def __init__(self, index: int, input_shape=None, name=None):
        super().__init__(name, input_shape)
        self.index = index

    def apply(self, modules, args, train):
        return args[self.index]

    def _infer_shape(self, in_shapes):
        return in_shapes[self.index]


class Max(KerasLayer):
    """Max over one dim (``dim`` counts the batch; ref torch.py Max)."""

    def __init__(self, dim: int, input_shape=None, name=None):
        super().__init__(name, input_shape)
        self.dim = dim

    def apply(self, modules, args, train):
        return torch.amax(args[0], dim=self.dim)

    def _infer_shape(self, in_shapes):
        s = in_shapes[0]
        if s is None:
            return None
        out = list(s)
        del out[_batch_axis(s, self.dim)]
        return tuple(out)


# ---------------- cropping / upsampling / resizing ----------------

def _crop_pair(c):
    return (c, c) if isinstance(c, int) else tuple(c)


class _Crop(KerasLayer):
    """Crop ``(lo, hi)`` off each spatial dim."""

    def apply(self, modules, args, train):
        x = args[0]
        idx = [slice(None)]
        for ax, (lo, hi) in enumerate(self.cropping, start=1):
            idx.append(slice(lo, x.shape[ax] - hi))
        return x[tuple(idx)]

    def _infer_shape(self, in_shapes):
        s = in_shapes[0]
        if s is None:
            return None
        sp = tuple(None if n is None else n - lo - hi
                   for n, (lo, hi) in zip(s, self.cropping))
        return sp + tuple(s[len(self.cropping):])


class Cropping1D(_Crop):
    def __init__(self, cropping=(1, 1), input_shape=None, name=None):
        super().__init__(name, input_shape)
        self.cropping = (_crop_pair(cropping),)


class Cropping2D(_Crop):
    def __init__(self, cropping=((0, 0), (0, 0)), input_shape=None,
                 name=None):
        super().__init__(name, input_shape)
        self.cropping = tuple(_crop_pair(c) for c in cropping)


class Cropping3D(_Crop):
    def __init__(self, cropping=((1, 1), (1, 1), (1, 1)), input_shape=None,
                 name=None):
        super().__init__(name, input_shape)
        self.cropping = tuple(_crop_pair(c) for c in cropping)


class _UpSampling(KerasLayer):
    """Repeat each spatial element ``size[i]`` times along dim ``i``."""

    def apply(self, modules, args, train):
        x = args[0]
        for ax, s in enumerate(self.size, start=1):
            x = torch.repeat_interleave(x, s, dim=ax)
        return x

    def _infer_shape(self, in_shapes):
        s = in_shapes[0]
        if s is None:
            return None
        sp = tuple(None if n is None else n * k
                   for n, k in zip(s, self.size))
        return sp + tuple(s[len(self.size):])


class UpSampling1D(_UpSampling):
    def __init__(self, length: int = 2, input_shape=None, name=None):
        super().__init__(name, input_shape)
        self.length = length
        self.size = (int(length),)


class UpSampling2D(_UpSampling):
    def __init__(self, size=(2, 2), input_shape=None, name=None):
        super().__init__(name, input_shape)
        self.size = _tuple(size, 2)


class UpSampling3D(_UpSampling):
    def __init__(self, size=(2, 2, 2), input_shape=None, name=None):
        super().__init__(name, input_shape)
        self.size = _tuple(size, 3)


def _lerp_axis(arr: torch.Tensor, axis: int, out_len: int,
               in_len: int) -> torch.Tensor:
    """JAX ``ResizeBilinear``'s align-corners interpolation along one
    axis: ``in = out * (in_len - 1) / (out_len - 1)``."""
    dev = arr.device
    if out_len == 1 or in_len == 1:
        idx = torch.zeros(out_len, dtype=torch.long, device=dev)
        return torch.index_select(arr, axis, idx)
    pos = torch.linspace(0.0, in_len - 1.0, out_len, device=dev)
    lo = torch.floor(pos).long()
    hi = torch.clamp(lo + 1, max=in_len - 1)
    w = (pos - lo).to(arr.dtype)
    shape = [1] * arr.dim()
    shape[axis] = out_len
    w = w.reshape(shape)
    return torch.index_select(arr, axis, lo) * (1 - w) + \
        torch.index_select(arr, axis, hi) * w


class ResizeBilinear(KerasLayer):
    """(ref convolutional.py ResizeBilinear) ``[b, h, w, c]`` to ``[b,
    output_height, output_width, c]``. ``align_corners=False`` is
    ``jax.image.resize``'s half-pixel bilinear, which widens the triangle
    filter when it shrinks (torch's ``antialias=True``); ``True`` maps the
    corner pixels onto the corners."""

    def __init__(self, output_height: int, output_width: int,
                 align_corners: bool = False, input_shape=None, name=None):
        super().__init__(name, input_shape)
        self.oh, self.ow = output_height, output_width
        self.align_corners = align_corners

    def apply(self, modules, args, train):
        from analytics_zoo_tpu_torch.common import flax_compat as fc
        x = args[0]
        if not self.align_corners:
            y = F.interpolate(fc.channels_first(x), size=(self.oh, self.ow),
                              mode="bilinear", align_corners=False,
                              antialias=True)
            return fc.channels_last(y)
        ih, iw = x.shape[1], x.shape[2]
        return _lerp_axis(_lerp_axis(x, 1, self.oh, ih), 2, self.ow, iw)

    def _infer_shape(self, in_shapes):
        s = in_shapes[0]
        return (self.oh, self.ow, s[-1]) if s else None


# ---------------- elementwise math (ref keras/layers/torch.py) ----------

class _Elementwise(KerasLayer):
    """Parameter-free elementwise layer; subclasses set ``fn``."""

    def apply(self, modules, args, train):
        return self.fn(args[0])

    def _infer_shape(self, in_shapes):
        return in_shapes[0]


class Identity(_Elementwise):
    fn = staticmethod(lambda x: x)


class Exp(_Elementwise):
    fn = staticmethod(torch.exp)


class Log(_Elementwise):
    fn = staticmethod(torch.log)


class Sqrt(_Elementwise):
    fn = staticmethod(torch.sqrt)


class Square(_Elementwise):
    fn = staticmethod(torch.square)


class Negative(_Elementwise):
    fn = staticmethod(torch.negative)


class AddConstant(_Elementwise):
    def __init__(self, constant_scalar: float, input_shape=None, name=None):
        super().__init__(name, input_shape)
        self.fn = lambda x: x + constant_scalar


class MulConstant(_Elementwise):
    def __init__(self, constant_scalar: float, input_shape=None, name=None):
        super().__init__(name, input_shape)
        self.fn = lambda x: x * constant_scalar


class Power(_Elementwise):
    """``(shift + scale * x) ** power`` (ref torch.py Power)."""

    def __init__(self, power: float, scale: float = 1.0, shift: float = 0.0,
                 input_shape=None, name=None):
        super().__init__(name, input_shape)
        self.fn = lambda x: torch.pow(shift + scale * x, power)


class HardTanh(_Elementwise):
    def __init__(self, min_value: float = -1.0, max_value: float = 1.0,
                 input_shape=None, name=None):
        super().__init__(name, input_shape)
        self.fn = lambda x: torch.clamp(x, min_value, max_value)


class HardShrink(_Elementwise):
    def __init__(self, value: float = 0.5, input_shape=None, name=None):
        super().__init__(name, input_shape)
        self.fn = lambda x: torch.where(x.abs() > value, x, 0.0)


class SoftShrink(_Elementwise):
    def __init__(self, value: float = 0.5, input_shape=None, name=None):
        super().__init__(name, input_shape)
        self.fn = lambda x: torch.where(
            x > value, x - value, torch.where(x < -value, x + value, 0.0))


class Threshold(_Elementwise):
    """``x`` where ``x > th``, else ``v``."""

    def __init__(self, th: float = 1e-6, v: float = 0.0, input_shape=None,
                 name=None):
        super().__init__(name, input_shape)
        self.fn = lambda x: torch.where(x > th, x, float(v))


class BinaryThreshold(_Elementwise):
    def __init__(self, value: float = 1e-6, input_shape=None, name=None):
        super().__init__(name, input_shape)
        self.fn = lambda x: (x > value).to(torch.float32)


class LeakyReLU(_Elementwise):
    def __init__(self, alpha: float = 0.3, input_shape=None, name=None):
        super().__init__(name, input_shape)
        self.fn = lambda x: torch.where(x >= 0, x, alpha * x)


class ELU(_Elementwise):
    def __init__(self, alpha: float = 1.0, input_shape=None, name=None):
        super().__init__(name, input_shape)
        self.fn = lambda x: torch.where(x >= 0, x,
                                        alpha * (torch.exp(x) - 1.0))


class ThresholdedReLU(_Elementwise):
    def __init__(self, theta: float = 1.0, input_shape=None, name=None):
        super().__init__(name, input_shape)
        self.fn = lambda x: torch.where(x > theta, x, 0.0)


# ---------------- layers holding flax self.params ----------------

class _Params(nn.Module):
    """A module whose parameters are flax ``self.param`` leaves of a
    module named after the layer: ``leaves`` maps each flax leaf to its
    torch name and flax shape (``convert.flax_leaves``). A ``bias`` is
    held flattened, other leaves in their flax shape (convert.py's
    rules). ``fn(mod, x)`` computes the layer."""

    def __init__(self, fn, leaves: Dict[str, Tuple[str, tuple]],
                 init: Dict[str, Callable], generator: torch.Generator):
        super().__init__()
        self.fn = fn
        self._leaves = dict(leaves)
        for fname, (tname, shape) in leaves.items():
            held = (math.prod(shape),) if fname == "bias" else tuple(shape)
            t = torch.empty(held)
            with torch.no_grad():
                init[fname](t, generator)
            self.register_parameter(tname, nn.Parameter(t))

    def flax_tree_leaves(self):
        return dict(self._leaves)

    def leaf(self, fname: str) -> torch.Tensor:
        tname, shape = self._leaves[fname]
        return getattr(self, tname).reshape(shape)

    def forward(self, x):
        return self.fn(self, x)


def _fill(value):
    return lambda t, g: t.fill_(value)


class _ParamLayer(KerasLayer):
    """Shape-preserving layer whose work is one ``_Params`` module;
    subclasses give ``leaves(c)`` (c: the input's last width),
    ``init_fns()`` and the static ``compute(mod, x)``."""

    def make_modules(self, in_shapes, generator):
        s = in_shapes[0]
        c = None if not s else s[-1]
        return {self.name: _Params(type(self).compute, self.leaves(c),
                                   self.init_fns(), generator)}

    def apply(self, modules, args, train):
        return modules[self.name](args[0])

    def _infer_shape(self, in_shapes):
        return in_shapes[0]


class CAdd(_ParamLayer):
    """Learnable broadcast bias of shape ``size`` (batch excluded)."""

    def __init__(self, size, init="zero", input_shape=None, name=None):
        super().__init__(name, input_shape)
        self.size = tuple(size)
        self.init = get_init(init)

    def leaves(self, c):
        return {"bias": ("bias", self.size)}

    def init_fns(self):
        return {"bias": self.init}

    @staticmethod
    def compute(mod, x):
        return x + mod.leaf("bias")


class CMul(_ParamLayer):
    """Learnable broadcast scale of shape ``size``."""

    def __init__(self, size, init="one", input_shape=None, name=None):
        super().__init__(name, input_shape)
        self.size = tuple(size)
        self.init = get_init(init)

    def leaves(self, c):
        return {"weight": ("weight", self.size)}

    def init_fns(self):
        return {"weight": self.init}

    @staticmethod
    def compute(mod, x):
        return x * mod.leaf("weight")


class Scale(_ParamLayer):
    """``weight * x + bias``, both learnable of shape ``size``."""

    def __init__(self, size, input_shape=None, name=None):
        super().__init__(name, input_shape)
        self.size = tuple(size)

    def leaves(self, c):
        return {"weight": ("weight", self.size),
                "bias": ("bias", self.size)}

    def init_fns(self):
        return {"weight": _fill(1.0), "bias": _fill(0.0)}

    @staticmethod
    def compute(mod, x):
        return x * mod.leaf("weight") + mod.leaf("bias")


class Mul(_ParamLayer):
    """One learnable scalar multiplier."""

    def leaves(self, c):
        return {"weight": ("weight", ())}

    def init_fns(self):
        return {"weight": _fill(1.0)}

    @staticmethod
    def compute(mod, x):
        return x * mod.leaf("weight")


class PReLU(_ParamLayer):
    """Learnable per-channel slope below 0, from 0.25."""

    def leaves(self, c):
        return {"alpha": ("alpha", (c,))}

    def init_fns(self):
        return {"alpha": _fill(0.25)}

    @staticmethod
    def compute(mod, x):
        return torch.where(x >= 0, x, mod.leaf("alpha") * x)


class SReLU(_ParamLayer):
    """S-shaped ReLU, four learnable per-channel parameters: ``t_r + a_r
    (x - t_r)`` above ``t_r``, ``t_l + a_l (x - t_l)`` below ``t_l``,
    ``x`` between."""

    def leaves(self, c):
        return {k: (k, (c,)) for k in ("t_left", "a_left", "t_right",
                                       "a_right")}

    def init_fns(self):
        return {"t_left": _fill(0.0), "a_left": _fill(0.0),
                "t_right": _fill(1.0), "a_right": _fill(1.0)}

    @staticmethod
    def compute(mod, x):
        t_l, a_l = mod.leaf("t_left"), mod.leaf("a_left")
        t_r, a_r = mod.leaf("t_right"), mod.leaf("a_right")
        y = torch.where(x >= t_r, t_r + a_r * (x - t_r), x)
        return torch.where(x <= t_l, t_l + a_l * (x - t_l), y)


# ---------------- randomized layers ----------------
#
# Each draws, in training only, from torch's generator on the input's
# device, as ``Dropout`` does (the estimator seeds it a step); JAX draws
# from its "dropout" stream, so the two packages' draws differ and the
# tests hold their statistics and eval-mode outputs.

class RReLU(_Elementwise):
    """Randomized leaky ReLU: in training the slope below 0 is uniform in
    ``[lower, upper]``, in eval their mean."""

    def __init__(self, lower: float = 1.0 / 8, upper: float = 1.0 / 3,
                 input_shape=None, name=None):
        super().__init__(name, input_shape)
        self.lower, self.upper = lower, upper

    def apply(self, modules, args, train):
        x = args[0]
        if train:
            u = torch.empty_like(x).uniform_(self.lower, self.upper)
        else:
            u = (self.lower + self.upper) / 2.0
        return torch.where(x >= 0, x, u * x)


class GaussianNoise(_Elementwise):
    """Additive N(0, sigma) noise in training."""

    def __init__(self, sigma: float, input_shape=None, name=None):
        super().__init__(name, input_shape)
        self.sigma = sigma

    def apply(self, modules, args, train):
        x = args[0]
        if not train or self.sigma <= 0:
            return x
        return x + self.sigma * torch.randn_like(x)


class GaussianDropout(_Elementwise):
    """Multiplicative N(1, sqrt(p / (1 - p))) noise in training."""

    def __init__(self, p: float, input_shape=None, name=None):
        super().__init__(name, input_shape)
        if not 0 <= p < 1:
            raise ValueError("GaussianDropout needs 0 <= p < 1")
        self.p = p
        self.std = float(np.sqrt(p / (1.0 - p))) if p > 0 else 0.0

    def apply(self, modules, args, train):
        x = args[0]
        if not train or self.std == 0.0:
            return x
        return x * (1.0 + self.std * torch.randn_like(x))


class _SpatialDropout(_Elementwise):
    """Drop whole feature maps (channels-last) in training."""

    spatial_dims = 1

    def __init__(self, p: float = 0.5, input_shape=None, name=None):
        super().__init__(name, input_shape)
        self.p = p

    def apply(self, modules, args, train):
        x = args[0]
        if not train or self.p <= 0:
            return x
        shape = (x.shape[0],) + (1,) * self.spatial_dims + (x.shape[-1],)
        keep = torch.rand(shape, device=x.device) < 1.0 - self.p
        return torch.where(keep, x / (1.0 - self.p), 0.0)


class SpatialDropout1D(_SpatialDropout):
    spatial_dims = 1


class SpatialDropout2D(_SpatialDropout):
    spatial_dims = 2


class SpatialDropout3D(_SpatialDropout):
    spatial_dims = 3


class GaussianSampler(KerasLayer):
    """On ``[mean, log_var]``: ``mean + exp(log_var / 2) * eps`` in
    training, ``mean`` in eval (ref torch.py GaussianSampler)."""

    def apply(self, modules, args, train):
        mean, log_var = args
        if not train:
            return mean
        return mean + torch.exp(log_var / 2.0) * torch.randn_like(mean)

    def _infer_shape(self, in_shapes):
        return in_shapes[0]


# ---------------- convolution extensions (ref convolutional.py) --------

class AtrousConvolution1D(Conv1D):
    """Dilated ``Conv1D`` (``atrous_rate`` its dilation)."""

    def __init__(self, nb_filter: int, filter_length: int,
                 atrous_rate: int = 1, activation=None, border_mode="valid",
                 subsample_length: int = 1, init="glorot_uniform",
                 bias: bool = True, input_shape=None, name=None):
        super().__init__(nb_filter, filter_length, activation=activation,
                         border_mode=border_mode,
                         subsample_length=subsample_length, init=init,
                         bias=bias, dilation_rate=atrous_rate,
                         input_shape=input_shape, name=name)


class AtrousConvolution2D(_Conv):
    """Dilated 2-D convolution (ref AtrousConvolution2D); ``border_mode``
    as ``Conv2D``'s (SSD300's conv6: rate 6, padding 6)."""

    def __init__(self, nb_filter: int, nb_row: int, nb_col: int,
                 atrous_rate=(1, 1), activation=None, border_mode="valid",
                 subsample=(1, 1), init="glorot_uniform", bias: bool = True,
                 input_shape=None, name=None):
        super().__init__(name, input_shape)
        self._setup(nb_filter, (nb_row, nb_col), _tuple(subsample, 2),
                    canonical_padding(border_mode, 2),
                    _tuple(atrous_rate, 2), activation, init, bias)


class ShareConvolution2D(Conv2D):
    """(ref ShareConvolution2D, BigDL's memory-shared variant) the math
    of ``Conv2D``."""


def _conv_transpose_pads(k: int, s: int, padding: str) -> Tuple[int, int]:
    """``lax.conv_transpose``'s padding of the stride-dilated input."""
    if padding == "SAME":
        pad_len = k + s - 2
        pad_a = k - 1 if s > k - 1 else int(math.ceil(pad_len / 2))
    else:
        pad_len = k + s - 2 + max(k - s, 0)
        pad_a = k - 1
    return pad_a, pad_len - pad_a


class _Deconv(Conv):
    """flax ``nn.ConvTranspose`` (``transpose_kernel=False``): the input
    dilated by the strides (zeros between its elements), padded by
    ``lax.conv_transpose``'s rule and convolved with the kernel as it is,
    not flipped. The kernel is flax's ``[*k, in, out]``, held as
    ``flax_compat.Conv`` holds it."""

    def __init__(self, *args, dilate_by=(1, 1), **kwargs):
        super().__init__(*args, **kwargs)
        self.dilate_by = tuple(dilate_by)

    def forward(self, x):
        b, *sp, c = x.shape
        if any(s > 1 for s in self.dilate_by):
            z = x.new_zeros((b,) + tuple((n - 1) * s + 1 for n, s in
                                         zip(sp, self.dilate_by)) + (c,))
            z[(slice(None),) + tuple(slice(None, None, s)
                                     for s in self.dilate_by)] = x
            x = z
        return super().forward(x)


class Deconvolution2D(KerasLayer):
    """Transposed 2-D convolution (ref Deconvolution2D), flax
    ``nn.ConvTranspose``'s arithmetic; ``border_mode`` "valid"/"same"."""

    def __init__(self, nb_filter: int, nb_row: int, nb_col: int,
                 activation=None, border_mode="valid", subsample=(1, 1),
                 init="glorot_uniform", bias: bool = True, input_shape=None,
                 name=None):
        super().__init__(name, input_shape)
        self.nb_filter, self.kernel = int(nb_filter), (int(nb_row),
                                                       int(nb_col))
        self.activation = get_activation(activation)
        self.padding = border_mode.upper()
        if self.padding not in ("VALID", "SAME"):
            raise ValueError(f"unknown border_mode {border_mode!r}")
        self.strides = _tuple(subsample, 2)
        self.init = get_init(init)
        self.bias = bias

    def _pads(self):
        return tuple(_conv_transpose_pads(k, s, self.padding)
                     for k, s in zip(self.kernel, self.strides))

    def make_modules(self, in_shapes, generator):
        s = in_shapes[0]
        if not s or s[-1] is None:
            raise ValueError(f"{self.name}: input width unknown")
        conv = _Deconv(int(s[-1]), self.nb_filter, self.kernel,
                       bias=self.bias, dtype=self.compute_dtype,
                       padding=self._pads(), dilate_by=self.strides)
        area = math.prod(self.kernel)
        with torch.no_grad():
            _conv_fill(self.init, conv.weight, area * int(s[-1]),
                       area * self.nb_filter, generator)
            if conv.bias is not None:
                conv.bias.zero_()
        return {self.name: conv}

    def apply(self, modules, args, train):
        return self.activation(modules[self.name](args[0]))

    def _infer_shape(self, in_shapes):
        s = in_shapes[0]
        if not s or None in s:
            return None
        out = tuple((n - 1) * st + 1 + lo + hi - k + 1 for n, st, k, (lo, hi)
                    in zip(s[:-1], self.strides, self.kernel, self._pads()))
        return out + (self.nb_filter,)


class _LocalParams(nn.Module):
    """An unshared-weight kernel of flax shape ``kshape`` and its bias
    ``bshape``, held as convert.py flattens them (the kernel ``[in, out]``
    split where the bias's dims start, transposed; the bias flat)."""

    def __init__(self, kshape: tuple, bshape: Optional[tuple],
                 generator: torch.Generator):
        super().__init__()
        self.kshape, self.bshape = tuple(kshape), bshape
        n_out = len(bshape) if bshape else 1
        rows = math.prod(kshape[:len(kshape) - n_out])
        w = torch.empty(math.prod(kshape) // rows, rows)
        limit = math.sqrt(6.0 / (kshape[-2] + kshape[-1]))
        with torch.no_grad():
            w.uniform_(-limit, limit, generator=generator)
        self.weight = nn.Parameter(w)
        self.bias = nn.Parameter(torch.zeros(math.prod(bshape))) \
            if bshape else None

    def flax_tree_leaves(self):
        out = {"kernel": ("weight", self.kshape)}
        if self.bias is not None:
            out["bias"] = ("bias", self.bshape)
        return out

    def kernel(self) -> torch.Tensor:
        return self.weight.t().reshape(self.kshape)


class LocallyConnected1D(KerasLayer):
    """``Conv1D`` with a weight of its own at each output position (ref
    local.py:26): the patches ``[b, L', k * c]`` times the kernel ``[L',
    k * c, f]`` (flax tree ``kernel``, ``bias [L', f]``)."""

    def __init__(self, nb_filter: int, filter_length: int, activation=None,
                 subsample_length: int = 1, bias: bool = True,
                 W_regularizer=None, b_regularizer=None,
                 input_shape=None, name=None):
        super().__init__(name, input_shape)
        self.nb_filter, self.k = int(nb_filter), int(filter_length)
        self.activation = get_activation(activation)
        self.stride = int(subsample_length)
        self.bias = bias
        self._set_regularizers(W_regularizer, b_regularizer)

    def _out_len(self, L):
        return (L - self.k) // self.stride + 1

    def make_modules(self, in_shapes, generator):
        L, c = in_shapes[0]
        n = self._out_len(L)
        return {self.name: _LocalParams(
            (n, self.k * c, self.nb_filter),
            (n, self.nb_filter) if self.bias else None, generator)}

    def apply(self, modules, args, train):
        mod = modules[self.name]
        x = args[0]
        b, L, c = x.shape
        n = self._out_len(L)
        idx = (torch.arange(n, device=x.device)[:, None] * self.stride
               + torch.arange(self.k, device=x.device)[None, :])
        patches = x[:, idx, :].reshape(b, n, self.k * c)
        y = torch.einsum("blk,lkf->blf", patches, mod.kernel())
        if mod.bias is not None:
            y = y + mod.bias.view(n, self.nb_filter)
        return self.activation(y)

    def _infer_shape(self, in_shapes):
        s = in_shapes[0]
        return (self._out_len(s[0]), self.nb_filter) if s else None


class LocallyConnected2D(KerasLayer):
    """``Conv2D`` with unshared weights (ref local.py:74): kernel ``[oh,
    ow, kh * kw * c, f]``, bias ``[oh, ow, f]``; a patch's elements in
    ``(kh, kw, c)`` order, as JAX gathers them."""

    def __init__(self, nb_filter: int, nb_row: int, nb_col: int,
                 activation=None, subsample=(1, 1), bias: bool = True,
                 input_shape=None, name=None):
        super().__init__(name, input_shape)
        self.nb_filter = int(nb_filter)
        self.kernel = (int(nb_row), int(nb_col))
        self.activation = get_activation(activation)
        self.strides = _tuple(subsample, 2)
        self.bias = bias

    def _out(self, H, W):
        (kh, kw), (sh, sw) = self.kernel, self.strides
        return (H - kh) // sh + 1, (W - kw) // sw + 1

    def make_modules(self, in_shapes, generator):
        H, W, c = in_shapes[0]
        oh, ow = self._out(H, W)
        kh, kw = self.kernel
        return {self.name: _LocalParams(
            (oh, ow, kh * kw * c, self.nb_filter),
            (oh, ow, self.nb_filter) if self.bias else None, generator)}

    def apply(self, modules, args, train):
        mod = modules[self.name]
        x = args[0]
        b, H, W, c = x.shape
        (kh, kw), (sh, sw) = self.kernel, self.strides
        oh, ow = self._out(H, W)
        # [b, oh, ow, c, kh, kw] -> (kh, kw, c) order
        p = x.unfold(1, kh, sh).unfold(2, kw, sw)
        patches = p.permute(0, 1, 2, 4, 5, 3).reshape(b, oh, ow,
                                                      kh * kw * c)
        y = torch.einsum("bhwk,hwkf->bhwf", patches, mod.kernel())
        if mod.bias is not None:
            y = y + mod.bias.view(oh, ow, self.nb_filter)
        return self.activation(y)

    def _infer_shape(self, in_shapes):
        s = in_shapes[0]
        if not s or None in s:
            return None
        return self._out(s[0], s[1]) + (self.nb_filter,)


class _ConvLSTMCell(nn.Module):
    """flax ``nn.ConvLSTMCell``: ``gates = ih(x) + hh(h)`` (both SAME
    convolutions with a bias), split ``i, g, f, o``; ``c' = sigmoid(f + 1)
    * c + sigmoid(i) * tanh(g)``, ``h' = sigmoid(o) * tanh(c')``."""

    def __init__(self, in_features: int, features: int, kernel: tuple,
                 dtype):
        super().__init__()
        self.features = int(features)
        self.ih = Conv(in_features, 4 * features, kernel, dtype=dtype,
                       padding="SAME")
        self.hh = Conv(features, 4 * features, kernel, dtype=dtype,
                       padding="SAME")

    def forward(self, x, carry):
        c, h = carry
        gates = self.ih(x) + self.hh(h)
        i, g, f, o = torch.split(gates, self.features, dim=-1)
        f = torch.sigmoid(f + 1)
        new_c = f * c + torch.sigmoid(i) * torch.tanh(g)
        new_h = torch.sigmoid(o) * torch.tanh(new_c)
        return new_c, new_h


class ConvLSTM2D(KerasLayer):
    """Convolutional LSTM over ``[b, t, h, w, c]`` (ref
    convolutional_recurrent.py:26; JAX ``nn.RNN`` over ``nn.ConvLSTMCell``,
    whose parameters flax names ``ConvLSTMCell_<n>``, as here). A zero
    carry; ``go_backwards`` runs the steps in reverse and returns the
    outputs in the order they were computed, as ``nn.RNN(reverse=True)``
    does."""

    _kdims = 2

    def __init__(self, nb_filter: int, nb_kernel: int,
                 return_sequences: bool = False, go_backwards: bool = False,
                 border_mode: str = "same", input_shape=None, name=None):
        super().__init__(name, input_shape)
        self.nb_filter, self.nb_kernel = int(nb_filter), int(nb_kernel)
        self.return_sequences = return_sequences
        self.go_backwards = go_backwards
        if border_mode != "same":
            raise ValueError("ConvLSTM2D supports border_mode='same' only "
                             "(matching the reference's implementation)")

    def make_modules(self, in_shapes, generator):
        s = in_shapes[0]
        cell = _ConvLSTMCell(int(s[-1]), self.nb_filter,
                             (self.nb_kernel,) * self._kdims,
                             self.compute_dtype)
        _flax_default_fill(cell, generator)
        self._cell_key = flax_autoname("ConvLSTMCell")
        return {self._cell_key: cell}

    def apply(self, modules, args, train):
        (cell,) = modules.values()
        x = args[0]
        steps = range(x.shape[1] - 1, -1, -1) if self.go_backwards \
            else range(x.shape[1])
        dt = torch.promote_types(x.dtype, cell.ih.weight.dtype)
        zero = x.new_zeros(x.shape[:1] + x.shape[2:-1] + (self.nb_filter,),
                           dtype=dt)
        carry, outs = (zero, zero), []
        for t in steps:
            carry = cell(x[:, t], carry)
            outs.append(carry[1])
        return torch.stack(outs, 1) if self.return_sequences else outs[-1]

    def _infer_shape(self, in_shapes):
        s = in_shapes[0]
        if s is None:
            return None
        out = tuple(s[1:-1]) + (self.nb_filter,)
        return (s[0],) + out if self.return_sequences else out


class ConvLSTM3D(ConvLSTM2D):
    """(ref ConvLSTM3D) input ``[b, t, d1, d2, d3, c]``."""

    _kdims = 3


class WithinChannelLRN2D(KerasLayer):
    """Spatial (within-channel) LRN: ``x / (1 + alpha * mean)^beta``, the
    mean of ``x^2`` over a ``size x size`` SAME window counting the pad's
    zeros (ref WithinChannelLRN2D; flax ``avg_pool``)."""

    def __init__(self, size: int = 5, alpha: float = 1e-4,
                 beta: float = 0.75, input_shape=None, name=None):
        super().__init__(name, input_shape)
        self.size, self.alpha, self.beta = size, alpha, beta

    def apply(self, modules, args, train):
        x = args[0]
        mean = pool(torch.square(x), "avg", (self.size, self.size), (1, 1),
                    "SAME")
        return x / torch.pow(1.0 + self.alpha * mean, self.beta)

    def _infer_shape(self, in_shapes):
        return in_shapes[0]


# ---------------- dense variants (ref core.py) ----------------

class _Highway(nn.Module):
    def __init__(self, d: int, bias: bool, dtype, activation):
        super().__init__()
        from analytics_zoo_tpu_torch.common import flax_compat
        self.transform = flax_compat.Dense(d, d, bias=bias, dtype=dtype)
        self.h = flax_compat.Dense(d, d, bias=bias, dtype=dtype)
        self.activation = activation

    def forward(self, x):
        t = torch.sigmoid(self.transform(x))
        h = self.activation(self.h(x))
        return t * h + (1.0 - t) * x.to(t.dtype)


class Highway(KerasLayer):
    """``T * H(x) + (1 - T) * x`` with ``T = sigmoid(W_T x)``, ``H =
    act(W_H x)`` (ref core.py Highway; flax Denses ``transform`` and
    ``h``)."""

    def __init__(self, activation="tanh", bias: bool = True,
                 input_shape=None, name=None):
        super().__init__(name, input_shape)
        self.activation = get_activation(activation)
        self.bias = bias

    def make_modules(self, in_shapes, generator):
        mod = _Highway(int(in_shapes[0][-1]), self.bias, self.compute_dtype,
                       self.activation)
        _flax_default_fill(mod, generator)
        return {self.name: mod}

    def apply(self, modules, args, train):
        return modules[self.name](args[0])

    def _infer_shape(self, in_shapes):
        return in_shapes[0]


class _Maxout(nn.Module):
    def __init__(self, d: int, od: int, k: int, bias: bool, dtype):
        super().__init__()
        from analytics_zoo_tpu_torch.common import flax_compat
        self.Dense_0 = flax_compat.Dense(d, od * k, bias=bias, dtype=dtype)
        self.od, self.k = od, k

    def forward(self, x):
        y = self.Dense_0(x)
        return y.reshape(y.shape[:-1] + (self.k, self.od)).amax(-2)


class MaxoutDense(KerasLayer):
    """A Dense to ``nb_feature`` parallel outputs, then their max (ref
    core.py MaxoutDense; flax's Dense ``Dense_0``)."""

    def __init__(self, output_dim: int, nb_feature: int = 4,
                 bias: bool = True, input_shape=None, name=None):
        super().__init__(name, input_shape)
        self.output_dim, self.nb_feature = int(output_dim), int(nb_feature)
        self.bias = bias

    def make_modules(self, in_shapes, generator):
        mod = _Maxout(int(in_shapes[0][-1]), self.output_dim,
                      self.nb_feature, self.bias, self.compute_dtype)
        _flax_default_fill(mod, generator)
        return {self.name: mod}

    def apply(self, modules, args, train):
        return modules[self.name](args[0])

    def _infer_shape(self, in_shapes):
        s = in_shapes[0]
        return (s[:-1] + (self.output_dim,)) if s else None


class SparseDense(Dense):
    """(ref core.py SparseDense) a sparse input is densified: the math of
    ``Dense``."""
