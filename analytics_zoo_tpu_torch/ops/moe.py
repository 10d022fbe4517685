"""Mixture of experts with expert parallelism.

Counterpart of ``analytics_zoo_tpu/ops/moe.py`` (GShard / Switch style):

- ``top_k_gating(logits, k, capacity)`` -> ``(dispatch [N, E, C],
  combine [N, E, C], aux)``, JAX's: softmax gates, each of ``k`` passes
  takes every token's best remaining expert, its slot is its place in
  the expert's queue after the slots earlier passes filled, and tokens
  past an expert's capacity ``C`` are dropped (combine weight 0). ``aux``
  is Switch's load-balance loss, ``E * sum_e(fraction of tokens whose
  top choice is e * mean gate of e)``.
- ``MoEModule(n_experts, d_model, d_hidden, k=2, capacity_factor=1.25)``:
  JAX's parameters in JAX's shapes (``gate [d, E]``, ``w1 [E, d, h]``,
  ``b1 [E, h]``, ``w2 [E, h, d]``, ``b2 [E, d]``; ``convert.py`` carries
  them as they are), ``y = combine . FFN_e(dispatch . x)`` with a gelu
  FFN a expert and ``C = max(1, int(capacity_factor * N * k / E))``.
- ``ep_param_rules()``: JAX's rules, the expert-stacked weights over the
  ``expert`` axis.

Across ranks (a distributed default mesh, ``parallel/mesh.py``) the
module computes what JAX's does on the global batch:

- the gating is global over the batch axes (``data``, ``fsdp``): ``N`` is
  the global token count, each expert's queue runs through the ranks'
  tokens in data-index order (the counts of the ranks before this one
  offset its places), and ``aux`` reads the global fractions;
- with an ``expert`` axis of ``ep`` ranks each rank holds ``E / ep``
  experts. The tokens (replicated over the expert axis) are cut into
  ``ep`` chunks, rank ``j`` dispatches chunk ``j`` to every expert and
  one ``all_to_all`` takes each expert's slots to the rank that holds
  it (a slot holds one token, so the sum over the sources is exact); the
  experts' outputs come back by the reverse ``all_to_all``, and the
  chunks are all-gathered.

Under the estimator (learn/estimator.py) ``aux`` joins the objective
times ``aux_loss_weight``, as JAX's step consumes the sown value:
``collect_aux_losses()`` gathers the values of the forward passes run
inside it.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from analytics_zoo_tpu_torch.parallel import collectives
from analytics_zoo_tpu_torch.parallel import mesh as mesh_lib

_aux = threading.local()


@contextlib.contextmanager
def collect_aux_losses():
    """The load-balance losses of the MoE layers run inside, as a list."""
    prev = getattr(_aux, "losses", None)
    _aux.losses = []
    try:
        yield _aux.losses
    finally:
        _aux.losses = prev


def _one_hot(idx, n: int, dtype):
    return F.one_hot(idx.long(), n).to(dtype)


def _gating(logits, k: int, capacity: int, reduce=None, offsets=None,
            n_global=None):
    """``top_k_gating``'s body. ``reduce(t)``: the sum of ``t`` over the
    ranks that hold other tokens; ``offsets(counts)``: the counts of the
    ranks before this one in data-index order."""
    reduce = reduce or (lambda t: t)
    n, e = logits.shape
    n_global = n if n_global is None else n_global
    probs = torch.softmax(logits, dim=-1)
    top1 = torch.argmax(probs, dim=-1)
    frac_tokens = reduce(_one_hot(top1, e, probs.dtype).sum(0)) / n_global
    frac_probs = reduce(probs.sum(0)) / n_global
    aux = e * torch.sum(frac_tokens * frac_probs)

    dispatch = torch.zeros((n, e, capacity), dtype=logits.dtype,
                           device=logits.device)
    combine = torch.zeros_like(dispatch)
    residual = probs
    filled = torch.zeros((e,), dtype=logits.dtype, device=logits.device)
    for _ in range(k):
        choice = torch.argmax(residual, dim=-1)
        gate = torch.gather(residual, -1, choice[:, None])[:, 0]
        onehot = _one_hot(choice, e, logits.dtype)
        before = filled if offsets is None else \
            filled + offsets(onehot.sum(0))
        pos = (torch.cumsum(onehot, 0) - 1.0 + before[None, :]) * onehot
        in_cap = (pos < capacity) & (onehot > 0)
        pos_idx = torch.clamp(pos.to(torch.int32), 0, capacity - 1)
        slot = _one_hot(pos_idx, capacity, logits.dtype)
        contrib = torch.where(in_cap[..., None], slot,
                              torch.zeros((), dtype=slot.dtype,
                                          device=slot.device))
        dispatch = dispatch + contrib
        combine = combine + contrib * gate[:, None, None]
        filled = filled + reduce((onehot * in_cap).sum(0))
        residual = residual * (1.0 - onehot)
    return dispatch, combine, aux


def top_k_gating(logits: torch.Tensor, k: int, capacity: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """logits ``[N, E]`` -> (dispatch ``[N, E, C]`` one-hot, combine
    ``[N, E, C]`` weights, aux load-balance loss); the module docstring
    has the rule."""
    return _gating(logits, int(k), int(capacity))


def _batch_axes(mesh) -> List[str]:
    return [ax for ax in (mesh_lib.DATA_AXIS, mesh_lib.FSDP_AXIS)
            if mesh_lib.mesh_axis_size(mesh, ax) > 1]


class MoEModule(nn.Module):
    """Expert-parallel FFN block, ``[..., d_model] -> [..., d_model]``
    (the module docstring)."""

    def __init__(self, n_experts: int, d_model: int, d_hidden: int,
                 k: int = 2, capacity_factor: float = 1.25):
        super().__init__()
        self.n_experts, self.d_model = int(n_experts), int(d_model)
        self.d_hidden, self.k = int(d_hidden), int(k)
        self.capacity_factor = float(capacity_factor)
        e, d, h = self.n_experts, self.d_model, self.d_hidden
        self.gate = nn.Parameter(torch.empty(d, e))
        self.w1 = nn.Parameter(torch.empty(e, d, h))
        self.b1 = nn.Parameter(torch.zeros(e, h))
        self.w2 = nn.Parameter(torch.empty(e, h, d))
        self.b2 = nn.Parameter(torch.zeros(e, d))
        # flax's lecun_normal scale (fan_in over the non-output dims)
        for w in (self.gate, self.w1, self.w2):
            fan_in = w.numel() // w.shape[-1]
            nn.init.normal_(w, std=1.0 / math.sqrt(fan_in))
        #: tokens dispatched to this rank's experts by the last forward
        self.last_dispatch = None

    def _mesh(self):
        mesh = mesh_lib._default_mesh
        return mesh if mesh is not None and mesh.distributed else None

    def forward(self, x, train: bool = False):
        orig = x.shape
        tokens = x.reshape(-1, self.d_model)
        mesh = self._mesh()
        axes = _batch_axes(mesh) if mesh is not None else []
        shards = 1
        for ax in axes:
            shards *= mesh_lib.mesh_axis_size(mesh, ax)
        n_global = tokens.shape[0] * shards
        e = self.n_experts
        capacity = max(1, int(self.capacity_factor * n_global * self.k / e))
        logits = tokens @ self.gate.to(tokens.dtype)
        if axes:
            def reduce(t):
                for ax in axes:
                    t = collectives.all_reduce(t, mesh, ax)
                return t

            def offsets(counts):
                every = collectives.gather_axes(counts[None].detach(), mesh,
                                                axes, 0)
                return every[:mesh.data_index(axes)].sum(0)
            dispatch, combine, aux = _gating(logits, self.k, capacity,
                                             reduce, offsets, n_global)
        else:
            dispatch, combine, aux = _gating(logits, self.k, capacity)
        losses = getattr(_aux, "losses", None)
        if losses is not None:
            losses.append(aux)
        ep = mesh_lib.mesh_axis_size(mesh, mesh_lib.EXPERT_AXIS) \
            if mesh is not None else 1
        if ep == 1:
            self.last_dispatch = float(dispatch.detach().sum())
            expert_in = torch.einsum("nec,nd->ecd", dispatch, tokens)
            expert_out = self._ffn(expert_in, self.w1, self.b1, self.w2,
                                   self.b2)
            out = torch.einsum("nec,ecd->nd", combine, expert_out)
            return out.reshape(orig)
        return self._expert_parallel(tokens, dispatch, combine, mesh,
                                     ep).reshape(orig)

    @staticmethod
    def _ffn(expert_in, w1, b1, w2, b2):
        h = F.gelu(torch.einsum("ecd,edh->ech", expert_in, w1)
                   + b1[:, None, :], approximate="tanh")
        return torch.einsum("ech,ehd->ecd", h, w2) + b2[:, None, :]

    def _expert_parallel(self, tokens, dispatch, combine, mesh, ep: int):
        from analytics_zoo_tpu_torch.parallel import tensor_parallel as tp
        axis = mesh_lib.EXPERT_AXIS
        n = tokens.shape[0]
        if n % ep:
            raise ValueError(f"{n} tokens do not cut into {ep} chunks over "
                             f"the {axis!r} axis")
        e_loc = self.n_experts // ep
        j = mesh.coord(axis)
        # this rank's experts: its blocks of the expert-stacked weights
        # (ep_param_rules), or its block of replicated ones
        w = [p if tp.shard_of(p) is not None else
             tp.block(p, mesh, axis, 0)
             for p in (self.w1, self.b1, self.w2, self.b2)]
        chunk = n // ep
        mine = slice(j * chunk, (j + 1) * chunk)
        part = torch.einsum("nec,nd->ecd", dispatch[mine], tokens[mine])
        # each expert's slots to the rank that holds it; a slot holds one
        # token, so summing the sources adds zeros to it
        got = collectives.all_to_all(
            part.unflatten(0, (ep, e_loc)), mesh, axis, 0, 0)
        expert_in = got.sum(0)
        self.last_dispatch = float(
            dispatch.detach()[:, j * e_loc:(j + 1) * e_loc].sum())
        expert_out = self._ffn(expert_in, *w)
        partial = torch.einsum(
            "nec,ecd->nd", combine[:, j * e_loc:(j + 1) * e_loc], expert_out)
        back = collectives.all_to_all(partial.unflatten(0, (ep, chunk)),
                                      mesh, axis, 0, 0).sum(0)
        return collectives.all_gather(back, mesh, axis, 0)

    @staticmethod
    def sharded_params(shards) -> set:
        """Under a strategy: the expert-stacked weights split over the
        ``expert`` axis by experts (``ep_param_rules``) are computed on as
        blocks; any other shard is gathered."""
        return {n for n in ("w1", "b1", "w2", "b2")
                if n in shards and shards[n].torch_dim == 0
                and set(shards[n].axes) == {mesh_lib.EXPERT_AXIS}}


def ep_param_rules() -> list:
    """Partition rules sharding the expert-stacked weights over
    ``expert`` (JAX's)."""
    ax = mesh_lib.EXPERT_AXIS
    return [
        (r"/(w1|b1|w2|b2)$", (ax,)),
    ]
