"""Keras-style graph engine on PyTorch.

Counterpart of ``analytics_zoo_tpu/keras/engine.py``: users compose layer
objects (``Sequential().add(...)`` or the functional ``Input``/``Model``
graph), and the engine turns the whole graph into ONE ``nn.Module``,
:class:`GraphModule`, that walks the nodes in topological order exactly
as the flax ``GraphModule`` does.

Parameters are registered at the top level of the module under the names
the flax parameter tree uses (``dense_1``, ``mlp_user_embed``, ...), so a
flax tree maps key for key onto the ``state_dict`` (see ``convert.py``).
Calling one layer object on two nodes reuses its modules (weight sharing).
Modules are built when the ``GraphModule`` is, in topological order, with
their input widths taken from the nodes' inferred shapes and their initial
values drawn from one ``torch.Generator`` seeded by the caller. A layer
whose flax module is named by flax itself (an RNN cell: ``GRUCell_0``)
takes that name from :func:`flax_autoname`, which counts per class in
creation order within the graph being built, as flax does.
"""

from __future__ import annotations

import contextvars
import itertools
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch
from torch import nn

_id_counter = itertools.count()
_name_counters: Dict[str, itertools.count] = {}


def fresh_name(prefix: str) -> str:
    c = _name_counters.setdefault(prefix, itertools.count(1))
    return f"{prefix}_{next(c)}"


#: per-class counters of the GraphModule being built
_autonames: contextvars.ContextVar = contextvars.ContextVar(
    "zoo_flax_autonames", default=None)


def flax_autoname(cls_name: str) -> str:
    """The name flax gives the next unnamed ``cls_name`` submodule of the
    graph being built: ``GRUCell_0``, ``GRUCell_1``, ..."""
    counts = _autonames.get()
    if counts is None:
        raise RuntimeError("flax_autoname is only valid while a "
                           "GraphModule builds its modules")
    n = counts.get(cls_name, 0)
    counts[cls_name] = n + 1
    return f"{cls_name}_{n}"


class Node:
    """One tensor in the symbolic graph."""

    __slots__ = ("id", "layer", "inputs", "shape", "name")

    def __init__(self, layer: Optional["KerasLayer"], inputs: List["Node"],
                 shape: Optional[Tuple], name: str = ""):
        self.id = next(_id_counter)
        self.layer = layer
        self.inputs = inputs
        self.shape = shape  # without batch dim, may be None
        self.name = name

    # ---- autograd-style operator sugar (ref
    # pyzoo/zoo/pipeline/api/autograd.py Variable operators: +, -, *, / on
    # symbolic tensors), as the JAX engine's: a number becomes a Constant
    # node and the pair a Merge of the mode ----
    def __add__(self, other):
        return _sugar("add", self, _const(other, self))

    __radd__ = __add__

    def __sub__(self, other):
        return _sugar("sub", self, _const(other, self))

    def __rsub__(self, other):
        return _sugar("sub", _const(other, self), self)

    def __mul__(self, other):
        return _sugar("mul", self, _const(other, self))

    __rmul__ = __mul__

    def __truediv__(self, other):
        return _sugar("div", self, _const(other, self))

    def __rtruediv__(self, other):
        return _sugar("div", _const(other, self), self)

    def __neg__(self):
        return self * -1.0


def _const(v, like: Node) -> Node:
    """``v`` as a node: a Node as it is, anything else a ``Constant``
    placed on the device of ``like``'s tensor (its input)."""
    if isinstance(v, Node):
        return v
    from analytics_zoo_tpu_torch.keras.layers import Constant
    return Constant(v)([like])


def _sugar(mode: str, a: Node, b: Node) -> Node:
    """``merge_op(mode)`` of ``a`` and ``b``. A Constant has no inferred
    shape, so the result takes the symbolic side's, which the constant
    broadcasts against."""
    from analytics_zoo_tpu_torch.keras.layers import Constant, merge_op
    out = merge_op(mode)([a, b])
    if out.shape is None:
        known = [n.shape for n in (a, b)
                 if not isinstance(n.layer, Constant)]
        out.shape = known[0] if known else None
    return out


def Input(shape: Sequence[int], name: str = "") -> Node:
    """Symbolic input (shape excludes the batch dimension)."""
    return Node(None, [], tuple(shape), name or fresh_name("input"))


class KerasLayer:
    """Base layer: a config object that (a) can be called on Node(s) to
    build the graph, (b) knows how to run inside the graph module."""

    def __init__(self, name: Optional[str] = None):
        self._auto_named = name is None
        self.name = name or fresh_name(type(self).__name__.lower())

    # -- graph building --
    def __call__(self, x: Union[Node, List[Node]]) -> Node:
        inputs = x if isinstance(x, list) else [x]
        for i in inputs:
            if not isinstance(i, Node):
                raise TypeError(f"{self.name} called on non-Node {type(i)}")
        shape = self._infer_shape([i.shape for i in inputs])
        return Node(self, inputs, shape)

    def _infer_shape(self, in_shapes):
        return None

    # -- execution: override these --
    def make_modules(self, in_shapes: List[Optional[Tuple]],
                     generator: torch.Generator) -> Dict[str, nn.Module]:
        """The layer's parameter-holding modules, keyed by the top-level
        name each is registered under (empty for a parameter-free
        layer). ``in_shapes`` are the input nodes' shapes."""
        return {}

    def apply(self, modules: Dict[str, nn.Module], args: List[Any],
              train: bool):
        """Run the layer on ``args`` with the modules ``make_modules``
        returned."""
        raise NotImplementedError


def topo_sort(outputs: List[Node]) -> List[Node]:
    seen: Dict[int, Node] = {}
    order: List[Node] = []

    def visit(node: Node):
        if node.id in seen:
            return
        seen[node.id] = node
        for i in node.inputs:
            visit(i)
        order.append(node)

    for o in outputs:
        visit(o)
    return order


class GraphModule(nn.Module):
    """The ONE module executing the whole Keras graph."""

    def __init__(self, graph_inputs: Sequence[int],
                 graph_outputs: Sequence[int], order: Sequence[Node],
                 seed: int = 0):
        super().__init__()
        self.graph_inputs = tuple(graph_inputs)     # node ids
        self.graph_outputs = tuple(graph_outputs)
        self.order = tuple(order)                   # topo order
        generator = torch.Generator().manual_seed(int(seed))
        # layer name -> the top-level module names it owns
        self._layer_keys: Dict[str, Tuple[str, ...]] = {}
        token = _autonames.set({})
        try:
            self._build(generator)
        finally:
            _autonames.reset(token)

    def _build(self, generator: torch.Generator) -> None:
        for node in self.order:
            layer = node.layer
            if node.id in self.graph_inputs or layer.name in \
                    self._layer_keys:
                continue
            mods = layer.make_modules([i.shape for i in node.inputs],
                                      generator)
            for key, mod in mods.items():
                if key in self._modules or hasattr(self, key):
                    raise ValueError(
                        f"layer {layer.name!r}: module name {key!r} is "
                        "taken")
                self.add_module(key, mod)
            self._layer_keys[layer.name] = tuple(mods)

    def forward(self, *xs, train: bool = False):
        if len(xs) != len(self.graph_inputs):
            raise ValueError(f"model takes {len(self.graph_inputs)} inputs, "
                             f"got {len(xs)}")
        env: Dict[int, Any] = dict(zip(self.graph_inputs, xs))
        for node in self.order:
            if node.id in env:
                continue
            layer = node.layer
            mods = {k: self._modules[k] for k in self._layer_keys[layer.name]}
            args = [env[i.id] for i in node.inputs]
            env[node.id] = layer.apply(mods, args, train)
        outs = [env[i] for i in self.graph_outputs]
        return outs[0] if len(outs) == 1 else tuple(outs)
