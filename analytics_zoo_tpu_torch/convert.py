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


# ------------------------------------- JAX's names for a foreign module

class _NoTreeRule(Exception):
    """JAX's ``torch_to_jax`` has no rule for a module's type."""


class _TreeRefused(Exception):
    """JAX's rule for a module's type refuses its configuration."""


#: tensor methods JAX's translation covers (net/torch_net.py ``_METHODS``)
_TREE_METHODS = frozenset((
    "view", "reshape", "permute", "transpose", "flatten", "mean", "sum",
    "size", "contiguous", "squeeze", "unsqueeze"))


def _tree_functions():
    """The functions JAX's translation covers (its ``_FN_MAP``)."""
    import operator
    import torch.nn.functional as F
    return {torch.relu, F.relu, torch.tanh, torch.sigmoid, F.gelu,
            F.softmax, F.log_softmax, torch.add, operator.add, operator.sub,
            operator.mul, operator.truediv, operator.getitem,
            operator.matmul, torch.matmul, torch.flatten, torch.cat,
            torch.mean, torch.sum}


def _tree_rule(mod: nn.Module, prefix: str = ""):
    """JAX's rule for one module (net/torch_net.py
    ``_ModuleRule.translate``) as ``(params, buffers, needs_ctx)``: trees
    whose leaves are ``(torch name, transposed)`` (``prefix`` is the
    module's name in the whole), and whether JAX's rule reads the train
    flag (a BatchNorm, a live Dropout). ``_NoTreeRule`` where JAX has no
    rule, ``_TreeRefused`` where it raises."""
    def leaf(name, transposed=False):
        return (prefix + name, transposed)

    def refuse(why):
        raise _TreeRefused(f"{type(mod).__name__}: {why}")

    def sub(child, name):
        # a composite rule's part: JAX refuses one without a rule, or
        # with state or ctx
        try:
            p, b, ctx = _tree_rule(child, prefix + name + ".")
        except _NoTreeRule as e:
            raise _TreeRefused(str(e)) from e
        if b or ctx:
            refuse(f"{name} has frozen state or train-time randomness")
        return p

    def affine(m, names=("scale", "bias")):
        if m.weight is None or m.bias is None:
            refuse("no affine weight and bias")
        return {names[0]: leaf("weight"), names[1]: leaf("bias")}

    def with_bias(out):
        if mod.bias is not None:
            out["bias"] = leaf("bias")
        return out

    if isinstance(mod, nn.Linear):
        return with_bias({"kernel": leaf("weight", True)}), {}, False
    if isinstance(mod, (nn.Conv1d, nn.Conv2d)):
        if any(d != 1 for d in np.atleast_1d(mod.dilation)) or \
                mod.groups != 1:
            refuse("dilated/grouped conv")
        return with_bias({"kernel": leaf("weight")}), {}, False
    if isinstance(mod, nn.ConvTranspose2d):
        if any(d != 1 for d in np.atleast_1d(mod.dilation)) or \
                mod.groups != 1 or \
                any(p != 0 for p in np.atleast_1d(mod.output_padding)):
            refuse("dilated/grouped/output-padded")
        return with_bias({"kernel": leaf("weight")}), {}, False
    if isinstance(mod, nn.GroupNorm):
        # without affine JAX makes its own ones and zeros: no torch leaf
        return affine(mod), {}, False
    if isinstance(mod, (nn.BatchNorm1d, nn.BatchNorm2d)):
        if mod.running_mean is None:
            refuse("no running statistics")
        return affine(mod), {"mean": leaf("running_mean"),
                             "var": leaf("running_var")}, True
    if isinstance(mod, nn.LayerNorm):
        return affine(mod), {}, False
    if isinstance(mod, nn.Embedding):
        return {"embedding": leaf("weight")}, {}, False
    if isinstance(mod, nn.MultiheadAttention):
        if mod.in_proj_weight is None:
            refuse("distinct q/k/v embed dims")
        if mod.bias_k is not None or mod.add_zero_attn:
            refuse("add_bias_kv / add_zero_attn")
        p = {"in_w": leaf("in_proj_weight"),
             "out_w": leaf("out_proj.weight")}
        if mod.in_proj_bias is not None:
            p["in_b"] = leaf("in_proj_bias")
        if mod.out_proj.bias is not None:
            p["out_b"] = leaf("out_proj.bias")
        return p, {}, False
    if isinstance(mod, nn.TransformerEncoderLayer):
        import torch.nn.functional as F
        p = {"attn": sub(mod.self_attn, "self_attn"),
             "lin1": sub(mod.linear1, "linear1"),
             "lin2": sub(mod.linear2, "linear2"),
             "norm1": sub(mod.norm1, "norm1"),
             "norm2": sub(mod.norm2, "norm2")}
        act = mod.activation
        if isinstance(act, nn.Module):
            sub(act, "activation")
        elif act not in (F.relu, F.gelu, torch.relu):
            refuse(f"activation {act}")
        return p, {}, False
    if isinstance(mod, nn.TransformerEncoder):
        p = {f"layer{i}": sub(layer, f"layers.{i}")
             for i, layer in enumerate(mod.layers)}
        if mod.norm is not None:
            p["final_norm"] = sub(mod.norm, "norm")
        return p, {}, False
    if isinstance(mod, (nn.LSTM, nn.GRU)):
        if mod.bidirectional or (mod.dropout and mod.num_layers > 1) or \
                getattr(mod, "proj_size", 0):
            refuse("bidirectional, inter-layer dropout or proj_size")
        p = {}
        for i in range(mod.num_layers):
            p[f"wi{i}"] = leaf(f"weight_ih_l{i}")
            p[f"wh{i}"] = leaf(f"weight_hh_l{i}")
            if mod.bias:
                p[f"bi{i}"] = leaf(f"bias_ih_l{i}")
                p[f"bh{i}"] = leaf(f"bias_hh_l{i}")
        return p, {}, False
    if isinstance(mod, nn.Dropout):
        return {}, {}, float(mod.p) > 0.0
    if isinstance(mod, (nn.MaxPool2d, nn.AvgPool2d)):
        if getattr(mod, "ceil_mode", False) or (
                isinstance(mod, nn.AvgPool2d) and
                not mod.count_include_pad):
            refuse("ceil_mode or count_include_pad=False")
        return {}, {}, False
    if isinstance(mod, nn.AdaptiveAvgPool2d):
        if mod.output_size not in (1, (1, 1)):
            refuse("output size other than (1, 1)")
        return {}, {}, False
    if isinstance(mod, (nn.Identity, nn.Flatten, nn.ReLU, nn.LeakyReLU,
                        nn.ELU, nn.Softplus, nn.Hardtanh, nn.SiLU, nn.GELU,
                        nn.Tanh, nn.Sigmoid, nn.Softmax, nn.LogSoftmax)):
        return {}, {}, False
    raise _NoTreeRule(f"torch module {type(mod).__name__} has no rule")


def torch_tree_plan(module: nn.Module):
    """JAX's ``torch_to_jax`` naming of ``module``: ``(params, buffers)``
    trees whose leaves are ``(torch state_dict name, transposed)``, or
    None where JAX cannot translate the module.

    As JAX: a module with a rule of its own (an ``nn.LSTM``, an
    ``nn.TransformerEncoder`` passed alone) is the tree under ``root``;
    any other is traced by ``torch.fx``, each module call under its
    target with the dots kept (``"layers.0"``), each tensor attribute the
    forward reads under ``"attr.<target>"`` (a parameter in ``params``,
    any other tensor in ``buffers``). A Linear's ``kernel`` is its weight
    transposed; every other leaf is the torch tensor as it is (a
    convolution's ``kernel`` OIHW, an attention's ``in_w`` / ``out_w``)."""
    try:
        p, b, _ = _tree_rule(module)
        return {"root": p}, {"root": b}
    except _TreeRefused:
        return None
    except _NoTreeRule:
        pass                    # a container: JAX traces it
    import torch.fx as fx

    class Tracer(fx.Tracer):
        # a module standing in for a torch one (net/torch_net.py's
        # attention) is the leaf the torch one would be
        def is_leaf_module(self, m, qualname):
            return getattr(type(m), "_zoo_stands_for", None) is not None \
                or super().is_leaf_module(m, qualname)

    try:
        graph = Tracer().trace(module)
    except Exception:
        return None
    functions = _tree_functions()
    mods = dict(module.named_modules())
    params: Dict = {}
    buffers: Dict = {}
    for node in graph.nodes:
        try:
            if node.op == "call_module":
                p, b, _ = _tree_rule(mods[node.target], node.target + ".")
                if p:
                    params[node.target] = p
                if b:
                    buffers[node.target] = b
            elif node.op == "get_attr":
                t = module
                for part in node.target.split("."):
                    t = getattr(t, part)
                key = "attr." + node.target
                if isinstance(t, nn.Parameter):
                    params[key] = (node.target, False)
                elif isinstance(t, torch.Tensor):
                    buffers[key] = (node.target, False)
                else:
                    return None
            elif node.op == "call_function" and node.target not in functions:
                return None
            elif node.op == "call_method" and \
                    node.target not in _TREE_METHODS:
                return None
        except (_NoTreeRule, _TreeRefused):
            return None
    return params, buffers


def _tree_leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _tree_leaves(v, path + (k,))
        else:
            yield path + (k,), v


def _tree_from_leaves(pairs) -> Dict:
    tree: Dict = {}
    for path, v in pairs:
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return _sort_tree(tree)


def _tree_value(t: torch.Tensor, transposed: bool) -> torch.Tensor:
    t = t.detach()
    return t.transpose(-1, -2) if transposed else t


def torch_to_jax_tree(module: nn.Module) -> Dict:
    """``{"params", "buffers"}``: JAX's ``torch_to_jax(module)[1]`` for a
    module its rules cover, numpy arrays keyed and laid out as there
    (``torch_tree_plan``); ``ValueError`` for one they do not."""
    plan = torch_tree_plan(module)
    if plan is None:
        raise ValueError(f"JAX's torch_to_jax has no translation of "
                         f"{type(module).__name__}")
    sd = module.state_dict()

    def arrays(tree):
        return _tree_from_leaves(
            (path, np.array(_tree_value(sd[name], tr).cpu().numpy(),
                            copy=True))
            for path, (name, tr) in _tree_leaves(tree))
    return {"params": arrays(plan[0]), "buffers": arrays(plan[1])}


def jax_tree_to_state_dict(module: nn.Module, variables: Mapping
                           ) -> Dict[str, torch.Tensor]:
    """The inverse of ``torch_to_jax_tree``: JAX's ``{"params",
    "buffers"}`` of ``module`` as tensors keyed by the module's
    state_dict names, for ``load_state_dict(..., strict=False)``."""
    plan = torch_tree_plan(module)
    if plan is None:
        raise ValueError(f"JAX's torch_to_jax has no translation of "
                         f"{type(module).__name__}")
    out: Dict[str, torch.Tensor] = {}
    for part, tree in zip(("params", "buffers"), plan):
        given = dict(_tree_leaves(variables[part]))
        for path, (name, tr) in _tree_leaves(tree):
            if path in given:
                t = torch.as_tensor(np.ascontiguousarray(given[path]))
                out[name] = _tree_value(t, tr).contiguous()
    return out


def _foreign(module: nn.Module) -> bool:
    """A module the JAX package would take through ``from_torch``: none
    of its classes is the port's own (a port module mirrors a flax module
    and keeps flax's names), save the torch twins of
    ``models/migration*.py``."""
    for m in module.modules():
        name = type(m).__module__
        if getattr(type(m), "_zoo_stands_for", None) is not None:
            continue
        if name.startswith("analytics_zoo_tpu_torch") and \
                not name.startswith("analytics_zoo_tpu_torch.models."
                                    "migration"):
            return False
    return True


def _covering_tree_plan(module: nn.Module):
    """``torch_tree_plan`` where it names every parameter exactly once,
    else None."""
    plan = torch_tree_plan(module)
    if plan is None:
        return None
    names = [name for _, (name, _) in _tree_leaves(plan[0])]
    if sorted(names) != sorted(n for n, _ in module.named_parameters()):
        return None
    return plan


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
    """How a module's parameters map onto a checkpoint's ``params`` tree,
    as the JAX package names them:

    - a module of the port by flax's names and layouts (``flax_layout``);
    - a foreign module (``_foreign``: plain ``torch.nn`` building blocks,
      as a user hands ``Estimator.from_torch``) that JAX's
      ``torch_to_jax`` translates, by that translation's tree
      (``torch_tree_plan``), its buffers in ``model_state`` likewise;
    - anything else by the torch names nested at the dots.

    ``kind`` says which (``"flax"``, ``"torch_tree"`` or ``"torch"``).
    ``to_tree`` takes tensors keyed like the parameters (the parameters
    themselves, or optimizer state shaped like them) and gives host
    arrays; ``from_tree`` inverts it."""

    def __init__(self, module: nn.Module):
        self.names: List[str] = [n for n, _ in module.named_parameters()]
        plan = _covering_tree_plan(module) if _foreign(module) else None
        like = None if plan is not None else flax_layout(module)
        self.kind = "torch_tree" if plan is not None else \
            "flax" if like is not None else "torch"
        self.flax = self.kind == "flax"
        if self.kind == "torch_tree":
            self._leaves = dict(_tree_leaves(plan[0]))
            #: buffer name -> its path in the model_state tree
            self.state_paths = {name: path for path, (name, _) in
                                _tree_leaves(plan[1])}
            shapes = dict(module.named_parameters())
            like = _tree_from_leaves(
                (path, torch.empty(tuple(_tree_value(
                    shapes[name], tr).shape), dtype=shapes[name].dtype,
                    device="meta"))
                for path, (name, tr) in self._leaves.items())
        else:
            self.state_paths = buffer_paths(module)
        self.like = like if like is not None else nest({
            n: torch.empty(tuple(p.shape), dtype=p.dtype, device="meta")
            for n, p in module.named_parameters()})

    def torch_name(self, path) -> str:
        """The parameter name of the tree leaf at ``path`` (a sequence of
        keys)."""
        path = tuple(path)
        if self.kind == "torch_tree":
            return self._leaves[path][0]
        if self.kind == "flax":
            return ".".join(path[:-1] + (_LEAVES.get(path[-1], path[-1]),))
        return ".".join(path)

    def to_tree(self, tensors: Mapping[str, torch.Tensor],
                lead: tuple = ()) -> Dict:
        """``lead``: leading axes each tensor has in front of its
        parameter's shape (L-BFGS's memories); the layout applies past
        them."""
        if self.kind == "flax":
            return state_dict_to_flax(tensors, self.like, lead=lead)
        if self.kind == "torch_tree":
            return _tree_from_leaves(
                (path, _tree_value(tensors[name], tr).cpu().contiguous())
                for path, (name, tr) in self._leaves.items())
        return nest({n: tensors[n].detach().cpu() for n in self.names})

    def from_tree(self, tree: Mapping, lead: int = 0
                  ) -> Dict[str, torch.Tensor]:
        if self.kind == "flax":
            return flax_to_state_dict(tree, lead=lead)
        if self.kind == "torch_tree":
            given = dict(_tree_leaves(tree))
            return {name: _tree_value(torch.as_tensor(
                np.asarray(given[path])), tr).contiguous()
                for path, (name, tr) in self._leaves.items()}
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
        module's buffers; leaves as given, keys sorted). A buffer outside
        the JAX package's tree (a torch BatchNorm's
        ``num_batches_tracked``) is left out."""
        return _tree_from_leaves((self.state_paths[k], v)
                                 for k, v in buffers.items()
                                 if k in self.state_paths)

    def state_from_tree(self, tree: Mapping) -> Dict[str, torch.Tensor]:
        """The inverse of ``state_tree``: tensors keyed by buffer name."""
        flat = dict(_tree_leaves(tree))
        return {k: torch.as_tensor(flat[tuple(path)])
                for k, path in self.state_paths.items()}


# ------------------------------------------------- shards of a strategy

def flax_paths(module: nn.Module) -> Dict[str, tuple]:
    """``{torch parameter name: (flax path, flax shape, order)}``: the
    '/'-joined path the JAX package's rules read, the leaf's flax shape,
    and the order of flax's dims in which the torch tensor is that leaf
    (a kernel's out dims, then its in dims; ``torch = flax.transpose(
    order).reshape(torch shape)``). A foreign module JAX translates gives
    the paths of that translation's tree (``ParamLayout``), any other
    module without a flax layout its torch names joined by '/' with
    torch's shapes."""
    out: Dict[str, tuple] = {}
    layout = ParamLayout(module)
    if layout.kind == "torch_tree":
        for path, (name, tr) in layout._leaves.items():
            shape = tuple(_tree_value(module.get_parameter(name),
                                      tr).shape)
            order = (1, 0) if tr else tuple(range(len(shape)))
            out[name] = ("/".join(path), shape, order)
        return out
    if layout.kind == "torch":
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
