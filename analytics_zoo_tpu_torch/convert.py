"""Turn the JAX package's parameters into the port's, and back.

``flax_to_state_dict`` takes a flax parameter tree as numpy arrays (from
``jax.device_get(variables["params"])``) and returns the torch
``state_dict`` of the same model in the port, names kept:

- ``kernel`` -> ``weight`` in ``nn.Linear``'s ``[out, in]`` layout. A
  flax kernel is ``[in dims..., out dims...]`` and its bias has the out
  dims, so the kernel is flattened to ``[in, out]`` and transposed:
  ``nn.Dense`` ``[in, out]``, the attention projections ``[in, h, d]``
  (bias ``[h, d]``) and the attention output ``[h, d, out]`` (bias
  ``[out]``) all land as 2-D weights. A kernel without a bias has one out
  dim.
- ``bias`` -> ``bias``, flattened.
- ``scale`` (LayerNorm, BatchNorm) -> ``weight``.
- ``embedding`` stays ``[vocab, dim]``.
- a convolution's kernel ``[*k, in, out]`` is flattened to ``[prod(k) *
  in, out]`` and transposed like a Dense kernel (``flax_compat.Conv``).
- ``mean`` and ``var`` (a BatchNorm's ``batch_stats``) keep their names:
  ``flax_to_state_dict(variables["batch_stats"])`` gives the buffers
  ``<layer>.mean`` / ``<layer>.var``.
- flax's RNN cells (``GRUCell_0``, ``OptimizedLSTMCell_0``,
  ``SimpleCell_0``) are trees of Denses named ``ir``/``iz``/``in``/
  ``hr``/``hz``/``hn`` (GRU), ``ii``/``if``/``ig``/``io``/``hi``/... (LSTM)
  or ``i``/``h``; their kernels and biases follow the rules above, and the
  port's cells (keras/layers.py) register their Linears under the same
  names, ``in`` and ``if`` included.

- MTNet's attention weights (``W1``, ``b2``, ``W2``, ``W3``, ``b3``,
  ``V``: flax ``self.param``s, not Denses) and the MoE layer's (``gate``,
  ``w1``, ``b1``, ``w2``, ``b2``) keep their names and shapes,
  as do the keras layers' own ``self.param``s named ``weight``,
  ``alpha``, ``t_left``, ``a_left``, ``t_right`` and ``a_right``
  (``CMul``, ``Scale``, ``Mul``, ``PReLU``, ``SReLU``).
- a module with a ``flax_tree_leaves()`` method names its own leaves
  (``{flax leaf: (torch leaf, flax shape)}``): SSD's ``L2Norm``
  (``scale`` as ``weight``), the locally connected layers (a kernel of
  their own shape, held as the rules above flatten it) and the others
  whose parameters are flax ``self.param``s.
- a population's stacked members (``automl.population``): each leaf has
  the members on a leading axis, which ``lead=1`` passes over; one
  member's tree is ``member_tree`` of the stacked tree.

``flax_to_shard_state_dict(params, module, strategy, mesh)`` gives this
rank's block of that ``state_dict`` under a sharding strategy
(``shard_plan``: JAX's rules against ``flax_paths``, each flax spec
mapped onto the torch tensor's dims by ``TorchShard``); gathering every
rank's blocks gives back the whole, bit for bit.

``state_dict_to_flax`` is its inverse: the port's ``state_dict`` as a
flax tree of numpy arrays, shaped like a given flax tree (a 2-D weight
cannot say how its dims split into ``[in, h, d]``, so the tree's leaves
give the shapes).

flax derives its initial values from module paths, so the two packages
never initialise alike: this is how tests make both compute the same
function, and compare the parameters after training.

``flax_layout(module)`` gives that tree's shapes without JAX: each module
of the port that owns parameters knows its flax leaves (an ``nn.Linear``
a ``kernel [in, out]`` and a ``bias [out]``, or the shapes its
``flax_kernel_shape`` / ``flax_bias_shape`` attributes name, as the
attention projections' ``[in, h, d]`` and ``[h, d, out]``, or a
``flax_compat.Conv`` (a 2-D ``weight`` too) its ``[*k, in, out]``; a
LayerNorm or a BatchNorm a ``scale`` and a ``bias``; an embedding table
its ``embedding``).
``ParamLayout`` uses it to turn the parameters, and anything shaped like
them (Adam's moments, a momentum trace, L-BFGS's memories with a slot
axis in front), into the flax tree a checkpoint holds
(learn/checkpoint.py), and back. A module with a parameter outside
those rules keeps its torch names, nested at the dots.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional

import numpy as np
import torch
from torch import nn

#: flax leaf name -> torch leaf name
_LEAVES = {"kernel": "weight", "bias": "bias", "scale": "weight",
           "embedding": "embedding", "mean": "mean", "var": "var"}
#: flax leaves held as they are (MTNet's attention GRU; the keras
#: ``CMul`` / ``Scale`` / ``Mul`` weights, ``PReLU``'s and ``SReLU``'s;
#: the MoE layer's gate and expert-stacked weights)
_RAW = frozenset(("W1", "b2", "W2", "W3", "b3", "V", "weight", "alpha",
                  "t_left", "a_left", "t_right", "a_right", "gate", "w1",
                  "b1", "w2"))


def _linear_weight(kernel: np.ndarray, bias, lead: int = 0) -> np.ndarray:
    n_out = 1 if bias is None else max(np.ndim(bias) - lead, 1)
    n_in = kernel.ndim - lead - n_out
    rows = int(np.prod(kernel.shape[lead:lead + n_in]))
    return np.swapaxes(kernel.reshape(kernel.shape[:lead] + (rows, -1)),
                       -1, -2)


def flax_to_state_dict(params: Mapping, prefix: str = "", lead: int = 0
                       ) -> Dict[str, torch.Tensor]:
    """Flatten a flax ``params`` tree into a torch state dict. With
    ``lead``, every leaf has that many leading axes (an optimizer's
    per-slot memories) and the rules apply past them."""
    out: Dict[str, torch.Tensor] = {}
    for name, sub in params.items():
        key = f"{prefix}{name}"
        if isinstance(sub, Mapping):
            out.update(flax_to_state_dict(sub, prefix=key + ".", lead=lead))
            continue
        if name in _RAW:
            out[key] = torch.tensor(np.ascontiguousarray(sub),
                                    dtype=torch.float32)
            continue
        if name not in _LEAVES:
            raise KeyError(f"no torch counterpart for flax leaf {key!r}")
        arr = np.asarray(sub)
        if name == "kernel" and arr.ndim - lead >= 2:
            arr = _linear_weight(arr, params.get("bias"), lead)
        elif name == "bias":
            arr = arr.reshape(arr.shape[:lead] + (-1,))
        out[f"{prefix}{_LEAVES[name]}"] = torch.tensor(
            np.ascontiguousarray(arr), dtype=torch.float32)
    return out


def state_dict_to_flax(state_dict: Mapping, like: Mapping, prefix: str = "",
                       lead: tuple = ()) -> Dict:
    """The inverse of ``flax_to_state_dict``: a flax ``params`` tree of
    fp32 numpy arrays with the structure and leaf shapes of ``like`` (any
    tree whose leaves have ``.shape``), filled from ``state_dict``; with
    ``lead``, each tensor has those leading axes in front of its
    parameter's shape, and so has each leaf of the tree."""
    out: Dict = {}
    for name, sub in like.items():
        key = f"{prefix}{name}"
        if isinstance(sub, Mapping):
            out[name] = state_dict_to_flax(state_dict, sub, key + ".", lead)
            continue
        if name in _RAW:
            arr = state_dict[key].detach().cpu().float().numpy()
            out[name] = np.ascontiguousarray(
                arr.reshape(tuple(lead) + tuple(sub.shape)))
            continue
        if name not in _LEAVES:
            raise KeyError(f"no torch counterpart for flax leaf {key!r}")
        arr = state_dict[f"{prefix}{_LEAVES[name]}"].detach().cpu().float()
        arr = arr.numpy()
        if name == "kernel" and arr.ndim - len(lead) == 2:
            arr = np.swapaxes(arr, -1, -2)
        out[name] = np.ascontiguousarray(
            arr.reshape(tuple(lead) + tuple(sub.shape)))
    return out


def flax_leaves(module: nn.Module, params: Mapping[str, torch.Tensor]
                 ) -> Optional[Dict[str, tuple]]:
    """``{flax leaf: (torch leaf, flax shape)}`` of the parameters a
    module owns directly, or None when it follows no flax rule."""
    if hasattr(module, "flax_tree_leaves"):
        return dict(module.flax_tree_leaves())
    if isinstance(module, nn.Linear) or hasattr(module,
                                                "flax_kernel_shape"):
        out, inp = module.weight.shape
        leaves = {"kernel": ("weight", getattr(
            module, "flax_kernel_shape", (inp, out)))}
        if module.bias is not None:
            leaves["bias"] = ("bias", getattr(module, "flax_bias_shape",
                                              (out,)))
        return leaves
    from analytics_zoo_tpu_torch.common.flax_compat import BatchNorm
    if isinstance(module, (nn.LayerNorm, BatchNorm)) and \
            set(params) == {"weight", "bias"}:
        shape = tuple(module.weight.shape)
        return {"scale": ("weight", shape), "bias": ("bias", shape)}
    if set(params) == {"embedding"}:
        return {"embedding": ("embedding", tuple(params["embedding"].shape))}
    if params and set(params) <= _RAW:
        return {n: (n, tuple(p.shape)) for n, p in params.items()}
    return None


def member_tree(tree: Mapping, k: int) -> Dict:
    """Member ``k``'s tree of a stacked tree (every leaf's first axis
    the members)."""
    return {n: member_tree(v, k) if isinstance(v, Mapping)
            else np.asarray(v)[k] for n, v in tree.items()}


def stack_trees(trees) -> Dict:
    """The stacked tree of one tree per member (``member_tree``'s
    inverse)."""
    first = trees[0]
    return {n: stack_trees([t[n] for t in trees]) if isinstance(v, Mapping)
            else np.stack([np.asarray(t[n]) for t in trees])
            for n, v in first.items()}


def _sort_tree(tree):
    if isinstance(tree, dict):
        return {k: _sort_tree(tree[k]) for k in sorted(tree)}
    return tree


def nest(flat: Mapping[str, object]) -> Dict:
    """``{"a.b.c": x}`` as ``{"a": {"b": {"c": x}}}``, keys sorted."""
    tree: Dict = {}
    for key, val in flat.items():
        node = tree
        *path, leaf = key.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = val
    return _sort_tree(tree)


def flatten(tree: Mapping, prefix: str = "") -> Dict[str, object]:
    out: Dict[str, object] = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def flax_layout(module: nn.Module) -> Optional[Dict]:
    """The flax ``params`` tree of ``module`` as meta tensors of the flax
    leaf shapes (keys sorted, as ``jax.tree_util`` rebuilds a tree), or
    None when a parameter has no flax counterpart."""
    tree: Dict = {}
    covered = set()
    for mname, mod in module.named_modules():
        direct = dict(mod.named_parameters(recurse=False))
        if not direct:
            continue
        leaves = flax_leaves(mod, direct)
        if leaves is None:
            return None
        node = tree
        for part in mname.split(".") if mname else ():
            node = node.setdefault(part, {})
        for fname, (tname, shape) in leaves.items():
            node[fname] = torch.empty(tuple(shape), device="meta",
                                      dtype=direct[tname].dtype)
            covered.add(f"{mname}.{tname}" if mname else tname)
    if covered != {n for n, _ in module.named_parameters()}:
        return None
    return _sort_tree(tree)


def buffer_paths(module: nn.Module) -> Dict[str, tuple]:
    """``{buffer name: its path in the model_state tree}``: a
    BatchNorm's ``mean`` / ``var`` under ``batch_stats`` at the module's
    path, any other buffer at its torch name split at the dots. A buffer
    left out of the ``state_dict`` (a frozen ``WordEmbedding``'s table)
    has no path: JAX keeps it outside its trees."""
    from analytics_zoo_tpu_torch.common.flax_compat import BatchNorm
    out: Dict[str, tuple] = {}
    for mname, mod in module.named_modules():
        prefix = tuple(mname.split(".")) if mname else ()
        for bname, _ in mod.named_buffers(recurse=False):
            if bname in mod._non_persistent_buffers_set:
                continue
            key = f"{mname}.{bname}" if mname else bname
            out[key] = (("batch_stats",) if isinstance(mod, BatchNorm)
                        else ()) + prefix + (bname,)
    return out


class ParamLayout:
    """How a module's parameters map onto a checkpoint's ``params`` tree:
    flax's names and layouts where ``flax_layout`` knows the module, else
    the torch names nested at the dots. ``to_tree`` takes tensors keyed
    like the parameters (the parameters themselves, or optimizer state
    shaped like them) and gives host arrays; ``from_tree`` inverts it."""

    def __init__(self, module: nn.Module):
        self.names: List[str] = [n for n, _ in module.named_parameters()]
        #: buffer name -> its path in the model_state tree
        self.state_paths = buffer_paths(module)
        like = flax_layout(module)
        self.flax = like is not None
        self.like = like if self.flax else nest({
            n: torch.empty(tuple(p.shape), dtype=p.dtype, device="meta")
            for n, p in module.named_parameters()})

    def to_tree(self, tensors: Mapping[str, torch.Tensor],
                lead: tuple = ()) -> Dict:
        """``lead``: leading axes each tensor has in front of its
        parameter's shape (L-BFGS's memories); the layout applies past
        them."""
        if self.flax:
            return state_dict_to_flax(tensors, self.like, lead=lead)
        return nest({n: tensors[n].detach().cpu() for n in self.names})

    def from_tree(self, tree: Mapping, lead: int = 0
                  ) -> Dict[str, torch.Tensor]:
        if self.flax:
            return flax_to_state_dict(tree, lead=lead)
        return {n: torch.as_tensor(v) for n, v in flatten(tree).items()}

    def spec(self, lead: tuple = ()) -> Dict:
        """``like`` with ``lead`` in front of every leaf's shape."""
        def walk(tree):
            if isinstance(tree, Mapping):
                return {k: walk(v) for k, v in tree.items()}
            return torch.empty(tuple(lead) + tuple(tree.shape),
                               dtype=tree.dtype, device="meta")
        return walk(self.like) if lead else self.like

    def state_tree(self, buffers: Mapping[str, torch.Tensor]) -> Dict:
        """The ``model_state`` tree of ``buffers`` (keyed like the
        module's buffers; leaves as given, keys sorted)."""
        return nest({".".join(self.state_paths[k]): v
                     for k, v in buffers.items()})

    def state_from_tree(self, tree: Mapping) -> Dict[str, torch.Tensor]:
        """The inverse of ``state_tree``: tensors keyed by buffer name."""
        flat = flatten(tree)
        return {k: torch.as_tensor(flat[".".join(path)])
                for k, path in self.state_paths.items()}


# ------------------------------------------------- shards of a strategy

def flax_paths(module: nn.Module) -> Dict[str, tuple]:
    """``{torch parameter name: (flax path, flax shape, order)}``: the
    '/'-joined path the JAX package's rules read, the leaf's flax shape,
    and the order of flax's dims in which the torch tensor is that leaf
    (a kernel's out dims, then its in dims; ``torch = flax.transpose(
    order).reshape(torch shape)``). A module without a flax layout gives
    its torch names joined by '/' with torch's shapes."""
    out: Dict[str, tuple] = {}
    if flax_layout(module) is None:
        for name, p in module.named_parameters():
            shape = tuple(p.shape)
            out[name] = (name.replace(".", "/"), shape,
                         tuple(range(len(shape))))
        return out
    for mname, mod in module.named_modules():
        direct = dict(mod.named_parameters(recurse=False))
        if not direct:
            continue
        leaves = flax_leaves(mod, direct)
        prefix = mname.replace(".", "/") + "/" if mname else ""
        for fname, (tname, shape) in leaves.items():
            shape = tuple(shape)
            order = tuple(range(len(shape)))
            tshape = tuple(direct[tname].shape)
            if fname == "kernel" and len(tshape) == 2 and len(shape) >= 2:
                bias = leaves.get("bias")
                n_out = 1 if bias is None else max(len(bias[1]), 1)
                n_in = len(shape) - n_out
                order = tuple(range(n_in, len(shape))) + tuple(range(n_in))
            key = f"{mname}.{tname}" if mname else tname
            out[key] = (prefix + fname, shape, order)
    return out


class TorchShard:
    """How one torch parameter is sharded under a flax spec.

    ``view``: the torch tensor seen with flax's dims (in ``order``);
    ``dims``: ``{view dim: mesh axes}`` for the sharded dims; ``groups``:
    for each torch dim, the view dims it flattens. ``torch_dim`` is the
    torch dim a shard is a contiguous block of (one sharded view dim that
    leads its group), else None."""

    def __init__(self, name: str, path: str, spec: tuple, shape: tuple,
                 flax_shape: tuple, order: tuple, mesh):
        from analytics_zoo_tpu_torch.parallel.strategy import spec_axes
        self.name, self.path, self.spec = name, path, tuple(spec)
        self.shape, self.mesh = tuple(shape), mesh
        self.view = tuple(flax_shape[i] for i in order)
        self.dims: Dict[int, tuple] = {}
        for j, entry in enumerate(self.spec):
            axes = tuple(ax for ax in spec_axes(entry)
                         if mesh.shape.get(ax, 1) > 1)
            if axes:
                self.dims[order.index(j)] = axes
        # which view dims each torch dim flattens, greedily by size
        self.groups: List[List[int]] = []
        v = 0
        for size in self.shape:
            group, prod = [], 1
            while v < len(self.view) and (prod < size or not group or
                                          self.view[v] == 1) and \
                    prod * self.view[v] <= size:
                group.append(v)
                prod *= self.view[v]
                v += 1
            self.groups.append(group)
        self.local_view = tuple(
            n // self.ways(d) for d, n in enumerate(self.view))
        self.local_shape = tuple(
            int(np.prod([self.local_view[v] for v in g])) if g else 1
            for g in self.groups)
        self.torch_dim = None
        if len(self.dims) == 1:
            (vd,) = self.dims
            for t, g in enumerate(self.groups):
                if vd in g and all(self.view[u] == 1
                                   for u in g[:g.index(vd)]):
                    self.torch_dim = t

    def ways(self, view_dim: int) -> int:
        return int(np.prod([self.mesh.shape[ax]
                            for ax in self.dims.get(view_dim, ())]))

    @property
    def axes(self) -> set:
        return {ax for axes in self.dims.values() for ax in axes}

    def block(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's block of the whole tensor, contiguous, in the
        parameter's torch layout."""
        t = full.reshape(self.view)
        for vd, axes in self.dims.items():
            i = self.mesh.data_index(axes)
            step = self.view[vd] // self.ways(vd)
            t = t.narrow(vd, i * step, step)
        return t.contiguous().reshape(self.local_shape)

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        """The whole tensor from every rank's block (differentiable: the
        backward reduce-scatters)."""
        from analytics_zoo_tpu_torch.parallel.collectives import gather_axes
        t = local.reshape(self.local_view)
        for vd, axes in self.dims.items():
            t = gather_axes(t, self.mesh, axes, vd)
        return t.reshape(self.shape)

    def __repr__(self):
        return (f"TorchShard({self.name}: {self.path} {self.spec}, "
                f"{self.shape} -> {self.local_shape})")


def shard_plan(module: nn.Module, strategy, mesh) -> Dict[str, TorchShard]:
    """``{torch parameter name: TorchShard}`` of every parameter the
    strategy shards on ``mesh`` (rules read flax's paths and shapes,
    ``flax_paths``); the others are replicated."""
    out: Dict[str, TorchShard] = {}
    for name, (path, shape, order) in flax_paths(module).items():
        spec = strategy.param_spec(path, shape, mesh)
        param = module.get_parameter(name)
        shard = TorchShard(name, path, spec, tuple(param.shape), shape,
                           order, mesh)
        if shard.dims:
            out[name] = shard
    return out


def flax_to_shard_state_dict(params: Mapping, module: nn.Module, strategy,
                             mesh) -> Dict[str, torch.Tensor]:
    """This rank's block of ``flax_to_state_dict(params)`` under
    ``strategy`` on ``mesh``: the sharded parameters cut to the rank's
    block, the rest whole. Gathering every rank's blocks gives back the
    whole ``state_dict`` bit for bit."""
    sd = flax_to_state_dict(params)
    for name, shard in shard_plan(module, strategy, mesh).items():
        sd[name] = shard.block(sd[name])
    return sd
