"""TorchNet — serve a foreign PyTorch module on the card.

Counterpart of ``analytics_zoo_tpu/net/torch_net.py``. The JAX package
must translate a torch module into a jax function (``torch_to_jax``: fx
tracing, one rule a layer); the port runs the module as torch does (ROADMAP
C30), a copy on the device in eval mode under ``inference_mode``. Two
things of JAX's translation carry over:

- ``params``: JAX's parameter tree of the module, the same keys, layouts
  and values (``convert.torch_to_jax_tree``: fx targets with the dots
  kept, a Linear's ``kernel`` its weight transposed, a convolution's OIHW
  as it is, an attention's ``in_w`` / ``out_w`` / ``in_b`` / ``out_b``,
  the recurrent ``wi<l>`` / ``wh<l>`` / ``bi<l>`` / ``bh<l>``, a bare
  leaf module under ``root``). A module JAX cannot translate keeps its
  torch names nested at the dots, as ``convert.ParamLayout`` does.
- the attention core: where JAX's rule calls the shared
  ``ops.attention.dot_product_attention`` (the Pallas flash kernel on
  the TPU), the port calls its own (the flash kernel B3 on the card, by
  the autotuner's verdict at ``use_flash=None``). ``swap_attention``
  turns each ``nn.MultiheadAttention`` of JAX's domain — one width for
  q, k and v, no ``bias_k``, no ``add_zero_attn`` — into a
  ``FlashMultiheadAttention`` with the same parameters, which takes that
  path when the call passes no mask, no ``is_causal`` and
  ``need_weights=False``, or leaves ``need_weights`` at its default
  where the caller never reads the weights (fx finds such call sites, as
  JAX's ``mha_weightless`` pass does). Any other call is torch's own
  attention, as JAX's ``need_weights=True`` branch materializes the
  probabilities.
"""

from __future__ import annotations

import copy
import operator
from typing import Dict, Set

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from analytics_zoo_tpu_torch.common.device import (DeviceLike, as_tensor,
                                                   resolve_device, to_numpy)


class FlashMultiheadAttention(nn.MultiheadAttention):
    """``nn.MultiheadAttention`` whose unmasked, weightless calls run the
    port's attention core on the module's own ``in_proj`` / ``out_proj``
    weights (state_dict names unchanged). Made by ``swap_attention``."""

    #: convert.py reads this: the module names and traces as the torch one
    _zoo_stands_for = nn.MultiheadAttention
    #: the caller never reads the weights at any call site (fx)
    _zoo_weightless = False

    def forward(self, query, key, value, key_padding_mask=None,
                need_weights=True, attn_mask=None,
                average_attn_weights=True, is_causal=False):
        wants_weights = need_weights and not self._zoo_weightless
        if wants_weights or key_padding_mask is not None or \
                attn_mask is not None or is_causal or query.dim() != 3:
            return super().forward(
                query, key, value, key_padding_mask=key_padding_mask,
                need_weights=need_weights, attn_mask=attn_mask,
                average_attn_weights=average_attn_weights,
                is_causal=is_causal)
        from analytics_zoo_tpu_torch.ops.attention import (
            dot_product_attention)
        if not self.batch_first:                   # (T, B, E) -> (B, T, E)
            query, key, value = (t.transpose(0, 1)
                                 for t in (query, key, value))
        e, h = self.embed_dim, self.num_heads
        wq, wk, wv = self.in_proj_weight.chunk(3)
        bq = bk = bv = None
        if self.in_proj_bias is not None:
            bq, bk, bv = self.in_proj_bias.chunk(3)

        def heads(x, w, b):
            y = F.linear(x, w, b)
            return y.reshape(y.shape[0], y.shape[1], h, e // h)

        out = dot_product_attention(heads(query, wq, bq),
                                    heads(key, wk, bk),
                                    heads(value, wv, bv))
        out = F.linear(out.reshape(out.shape[0], out.shape[1], e),
                       self.out_proj.weight, self.out_proj.bias)
        if not self.batch_first:
            out = out.transpose(0, 1)
        return out, None


def _keep_slow_path(module, args):
    """A no-op forward pre-hook. ``nn.TransformerEncoderLayer`` in eval
    mode without a gradient takes torch's fused fast path
    (``torch._transformer_encoder_layer_fwd``), which reads
    ``self_attn.in_proj_weight`` directly and never calls
    ``self_attn.forward``; it refuses that path for a layer any of whose
    modules carries a hook, so this hook on the swapped attention makes
    the layer call it."""
    return None


def _in_domain(m: nn.MultiheadAttention) -> bool:
    return m.in_proj_weight is not None and m.bias_k is None and \
        not m.add_zero_attn


def _weights_unused(node) -> bool:
    """Only element [0] of the (output, weights) pair is consumed (a dead
    ``getitem[1]`` of ``out, w = attn(...)`` is no consumption)."""
    if not node.users:
        return False
    for u in node.users:
        if not (u.op == "call_function" and u.target is operator.getitem
                and len(u.args) > 1):
            return False
        if u.args[1] != 0 and u.users:
            return False
    return True


def _weightless_targets(module: nn.Module) -> Set[str]:
    """The attention modules every call of which leaves ``need_weights``
    at its default (no keyword, at most four positional arguments) and
    reads only the output: JAX's ``mha_weightless`` pass, by module."""
    import torch.fx as fx

    class Tracer(fx.Tracer):
        def is_leaf_module(self, m, qualname):
            return isinstance(m, nn.MultiheadAttention) or \
                super().is_leaf_module(m, qualname)
    try:
        graph = Tracer().trace(module)
    except Exception:
        return set()
    mods = dict(module.named_modules())
    ok: Dict[str, bool] = {}
    for n in graph.nodes:
        if n.op == "call_module" and \
                isinstance(mods.get(n.target), nn.MultiheadAttention):
            good = "need_weights" not in n.kwargs and len(n.args) <= 4 \
                and _weights_unused(n)
            ok[n.target] = ok.get(n.target, True) and good
    return {t for t, good in ok.items() if good}


def swap_attention(module: nn.Module) -> int:
    """Turn, in place, each ``nn.MultiheadAttention`` of JAX's domain into
    a ``FlashMultiheadAttention`` (the same parameters and names), and
    keep every ``nn.TransformerEncoder`` off its nested-tensor path;
    returns how many were swapped."""
    found = [(name, m) for name, m in module.named_modules()
             if type(m) is nn.MultiheadAttention and _in_domain(m)]
    weightless = _weightless_targets(module) if found else set()
    for name, m in found:
        m.__class__ = FlashMultiheadAttention
        m._zoo_weightless = name in weightless
        m.register_forward_pre_hook(_keep_slow_path)
    for m in module.modules():
        if isinstance(m, nn.TransformerEncoder):
            m.use_nested_tensor = False
    return len(found)


def module_params(module: nn.Module) -> Dict:
    """JAX's ``torch_to_jax`` parameter tree of ``module`` (numpy), or,
    where JAX cannot translate it, the torch names nested at the dots."""
    from analytics_zoo_tpu_torch.convert import nest, torch_to_jax_tree
    try:
        return torch_to_jax_tree(module)["params"]
    except ValueError:
        return nest({n: p.detach().cpu().numpy().copy()
                     for n, p in module.named_parameters()})


class TorchNet:
    """Inference over a torch module (ref TorchNet.scala: frozen,
    forward-only). ``TorchNet(module).predict(x)`` runs on ``cuda`` unless
    ``device`` says otherwise; the module given is not changed."""

    def __init__(self, module: nn.Module, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.module = copy.deepcopy(module).to(self.device).eval()
        self.swapped = swap_attention(self.module)

    @property
    def params(self) -> Dict:
        return module_params(self.module)

    def predict(self, *inputs):
        xs = tuple(as_tensor(np.asarray(a) if not isinstance(
            a, torch.Tensor) else a, self.device) for a in inputs)
        with torch.inference_mode():
            out = self.module(*xs)
        return _host(out)

    __call__ = predict


def _host(out):
    """Outputs as numpy, nested tuples kept (an RNN's ``(out, (h, c))``)."""
    if isinstance(out, (tuple, list)):
        return tuple(_host(o) for o in out)
    if out is None:
        return None
    return to_numpy(out)
