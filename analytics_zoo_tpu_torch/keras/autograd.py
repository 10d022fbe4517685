"""Autograd — symbolic tensor math for custom layers and losses.

Counterpart of ``analytics_zoo_tpu/keras/autograd.py`` (ref
pyzoo/zoo/pipeline/api/autograd.py:32-568: module-level math functions,
``Variable:369`` operator overloads, ``Lambda:393``, ``CustomLoss``).
Every expression is a ``keras.engine.Node`` whose layer is a
parameter-free torch function, so autograd expressions mix freely with
zoo layers inside one ``GraphModule``; ``Node``'s ``+ - * /`` build
``Merge`` nodes (keras/engine.py).

Axes count the batch dimension, as in the reference. The port builds a
layer's modules from its input nodes' shapes when the graph is built, so
the shape ops here also infer their output shapes (JAX's flax modules
infer widths at their first call and need none).

    from analytics_zoo_tpu_torch.keras import autograd as A
    v1, v2 = A.Variable(input_shape=(3,)), A.Variable(input_shape=(3,))
    out = A.mean(A.abs(v1 - v2), axis=1)
    loss = A.CustomLoss(lambda yt, yp: A.mean(A.square(yt - yp)), (3,))
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple, Union

import numpy as np
import torch

from analytics_zoo_tpu_torch.keras.engine import (
    Input, KerasLayer, Node, topo_sort,
)


class LambdaLayer(KerasLayer):
    """A parameter-free op node: applies ``fn(*tensors)`` (ref
    autograd.Lambda:393 / LambdaLayer). ``out_shape``: shape without the
    batch dim, or a callable of the input shapes."""

    def __init__(self, fn: Callable, out_shape=None, name=None):
        super().__init__(name)
        self.fn = fn
        self.out_shape = out_shape

    def _infer_shape(self, in_shapes):
        if callable(self.out_shape):
            return self.out_shape(in_shapes)
        if self.out_shape is not None:
            return tuple(self.out_shape)
        return in_shapes[0]

    def apply(self, modules, args, train):
        return self.fn(*args)


# the reference's spelling
Lambda = LambdaLayer


def Variable(input_shape: Sequence[int], name: str = "") -> Node:
    """A symbolic tensor (ref autograd.Variable:369; batch dim excluded)."""
    return Input(shape=input_shape, name=name)


# ---- elementwise unary (ref autograd.py abs/exp/log/sqrt/square/...) ----
def abs(x: Node) -> Node:  # noqa: A001 — reference API name
    return LambdaLayer(torch.abs)(x)


def exp(x: Node) -> Node:
    return LambdaLayer(torch.exp)(x)


def log(x: Node) -> Node:
    return LambdaLayer(torch.log)(x)


def sqrt(x: Node) -> Node:
    return LambdaLayer(torch.sqrt)(x)


def square(x: Node) -> Node:
    return LambdaLayer(torch.square)(x)


def neg(x: Node) -> Node:
    return LambdaLayer(lambda a: -a)(x)


def softsign(x: Node) -> Node:
    return LambdaLayer(lambda a: a / (1 + torch.abs(a)))(x)


def softplus(x: Node) -> Node:
    # jax.nn.softplus is logaddexp(x, 0)
    return LambdaLayer(lambda a: torch.logaddexp(a, torch.zeros_like(a)))(x)


def clip(x: Node, min: float, max: float) -> Node:  # noqa: A002
    return LambdaLayer(lambda a: torch.clamp(a, min, max))(x)


def pow(x: Node, a: float) -> Node:  # noqa: A001
    return LambdaLayer(lambda v: v ** a)(x)


def epsilon() -> float:
    return 1e-7


# ---- axis reductions (axis counts the batch dim, as in the reference) ----
def _reduce_shape(axis, keepdims):
    def infer(in_shapes):
        s = in_shapes[0]
        if s is None:
            return None
        full = (None,) + tuple(s)  # batch-dim placeholder
        ax = axis % len(full) if axis is not None else None
        if ax is None:
            return ()
        out = [d for i, d in enumerate(full) if i != ax or keepdims]
        if keepdims:
            out[ax] = 1
        return tuple(out[1:])
    return infer


def _reducer(op: str, axis, keepdims: bool):
    def f(a):
        if axis is None:
            out = getattr(a, op)()
            return out.reshape((1,) * a.ndim) if keepdims else out
        return getattr(a, op)(dim=axis, keepdim=keepdims)
    return f


def mean(x: Node, axis: int = None, keepDims: bool = False) -> Node:
    return LambdaLayer(_reducer("mean", axis, keepDims),
                       out_shape=_reduce_shape(axis, keepDims))(x)


def sum(x: Node, axis: int = None, keepDims: bool = False) -> Node:  # noqa: A001
    return LambdaLayer(_reducer("sum", axis, keepDims),
                       out_shape=_reduce_shape(axis, keepDims))(x)


def max(x: Node, axis: int = None, keepDims: bool = False) -> Node:  # noqa: A001
    return LambdaLayer(_reducer("amax", axis, keepDims),
                       out_shape=_reduce_shape(axis, keepDims))(x)


def min(x: Node, axis: int = None, keepDims: bool = False) -> Node:  # noqa: A001
    return LambdaLayer(_reducer("amin", axis, keepDims),
                       out_shape=_reduce_shape(axis, keepDims))(x)


# ---- binary ----
def maximum(x: Node, y: Union[Node, float]) -> Node:
    if isinstance(y, Node):
        return LambdaLayer(torch.maximum)([x, y])
    return LambdaLayer(lambda a: torch.clamp_min(a, y))(x)


def minimum(x: Node, y: Union[Node, float]) -> Node:
    if isinstance(y, Node):
        return LambdaLayer(torch.minimum)([x, y])
    return LambdaLayer(lambda a: torch.clamp_max(a, y))(x)


def _batch_dot_shape(axes):
    def infer(in_shapes):
        a, b = in_shapes
        if a is None or b is None:
            return None
        if axes == (1, 1):
            return (1,)
        return (a[0], b[-1]) if axes == (2, 1) else (a[0], b[0])
    return infer


def batch_dot(x: Node, y: Node, axes: Tuple[int, int] = (2, 1)) -> Node:
    """Per-sample matmul (ref autograd.batch_dot; axes as in keras-1)."""
    def f(a, b):
        # keras batch_dot with default axes == batched matmul
        if axes == (2, 1):
            return torch.einsum("bij,bjk->bik", a, b)
        if axes == (1, 1):
            return torch.einsum("bi,bi->b", a, b)[:, None]
        if axes == (2, 2):
            return torch.einsum("bij,bkj->bik", a, b)
        raise ValueError(f"unsupported batch_dot axes {axes}")
    return LambdaLayer(f, out_shape=_batch_dot_shape(tuple(axes)))([x, y])


def dot(x: Node, y: Node) -> Node:
    def infer(in_shapes):
        a, b = in_shapes
        if a is None or b is None:
            return None
        return tuple(a[:-1]) + tuple(b[-1:])
    return LambdaLayer(lambda a, b: a @ b, out_shape=infer)([x, y])


def l2_normalize(x: Node, axis: int = -1) -> Node:
    def f(a):
        return a / torch.clamp_min(
            torch.linalg.vector_norm(a, dim=axis, keepdim=True), 1e-12)
    return LambdaLayer(f)(x)


# ---- shape ops ----
def _full_shape_op(fn):
    """Shape inference through ``fn`` on the full shape, the batch dim
    a placeholder 1."""
    def infer(in_shapes):
        if any(s is None or None in s for s in in_shapes):
            return None
        dummies = [np.empty((1,) + tuple(s), np.uint8) for s in in_shapes]
        return tuple(fn(*dummies).shape[1:])
    return infer


def expand_dims(x: Node, axis: int) -> Node:
    return LambdaLayer(
        lambda a: torch.unsqueeze(a, axis),
        out_shape=_full_shape_op(lambda a: np.expand_dims(a, axis)))(x)


def squeeze(x: Node, axis: int) -> Node:
    return LambdaLayer(
        lambda a: torch.squeeze(a, axis),
        out_shape=_full_shape_op(lambda a: np.squeeze(a, axis)))(x)


def stack(nodes: List[Node], axis: int = 1) -> Node:
    return LambdaLayer(
        lambda *xs: torch.stack(xs, dim=axis),
        out_shape=_full_shape_op(lambda *xs: np.stack(xs, axis=axis)))(
            list(nodes))


def concatenate(nodes: List[Node], axis: int = -1) -> Node:
    return LambdaLayer(
        lambda *xs: torch.cat(xs, dim=axis),
        out_shape=_full_shape_op(
            lambda *xs: np.concatenate(xs, axis=axis)))(list(nodes))


def contiguous(x: Node) -> Node:
    return x


# ------------------------------------------------------------- evaluation
def to_function(inputs: List[Node], output: Node) -> Callable:
    """A parameter-free autograd graph as a plain function
    ``fn(*tensors)``. Raises if the graph holds a layer with parameters
    (that needs the Keras Model API)."""
    order = topo_sort([output])
    probe = torch.Generator()
    for node in order:
        if node.layer is not None and node.layer.make_modules(
                [i.shape for i in node.inputs], probe):
            raise ValueError(
                f"graph contains parameterized layer {node.layer.name!r}; "
                "use the Keras Model API instead of to_function")
    input_ids = [n.id for n in inputs]

    def fn(*xs):
        env = dict(zip(input_ids, xs))
        for node in order:
            if node.id in env:
                continue
            if node.layer is None:
                raise ValueError(
                    "graph references an Input that was not passed in")
            env[node.id] = node.layer.apply(
                {}, [env[i.id] for i in node.inputs], False)
        return env[output.id]

    return fn


class CustomLoss:
    """A loss written as an autograd expression over (y_true, y_pred)
    (ref autograd.CustomLoss / CustomLossWithVariable). Usable anywhere a
    loss is: ``model.compile(loss=CustomLoss(fn, y_shape))``."""

    def __init__(self, loss_func: Callable[[Node, Node], Node],
                 y_shape: Sequence[int]):
        y_true = Variable(input_shape=tuple(y_shape), name="y_true")
        y_pred = Variable(input_shape=tuple(y_shape), name="y_pred")
        out = loss_func(y_true, y_pred)
        self._fn = to_function([y_true, y_pred], out)

    def __call__(self, y_true, y_pred):
        return self._fn(y_true, y_pred)

    # the reference's spelling: loss.forward(y_true, y_pred) on arrays
    def forward(self, y_true, y_pred):
        def as_t(a):
            if isinstance(a, torch.Tensor):
                return a
            arr = np.asarray(a)
            if arr.dtype == np.float64:
                arr = arr.astype(np.float32)
            return torch.from_numpy(np.ascontiguousarray(arr))
        with torch.no_grad():
            out = self._fn(as_t(y_true), as_t(y_pred))
        return out.detach().cpu().numpy()

