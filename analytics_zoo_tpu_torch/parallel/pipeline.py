"""Pipeline parallelism: the GPipe schedule over the ``pipe`` axis of the
rank mesh.

Counterpart of ``analytics_zoo_tpu/parallel/pipeline.py``, with its
names. JAX runs one program on every device of the pipe axis and picks
each device's stage with ``lax.switch``; here each rank is one process
(ROADMAP C27) and runs its own stage only.

The schedule is JAX's: ``M + S - 1`` ticks for ``M`` microbatches over
``S`` stages. At tick ``t`` stage 0 takes microbatch ``min(t, M - 1)``,
stage ``s`` works on microbatch ``t - s``, and the last stage writes slot
``t - (S - 1)`` of its output buffer. After each tick the activations
move ``i -> i + 1`` with one ``ring_shift`` over the pipe axis (stage 0
ignores what comes round from the last). The last stage's buffer is
summed over the pipe axis with one ``all_reduce``, so every pipe rank
returns the same output (the other stages contribute zeros).

- A tick where a stage holds no microbatch of the batch (the bubble, and
  stage 0's clamped feed past ``M``) runs no stage: it ships zeros. In
  JAX those ticks compute on zeros or on a repeated microbatch and their
  results never reach the output, nor their cotangents the parameters,
  so outputs and gradients are the same.
- Differentiable: one autograd Function a call (``_Schedule``) keeps each
  live tick's graph and runs the reverse schedule in its backward. The
  cotangent of the output is summed over the pipe axis (the all_reduce's
  adjoint), each tick's cotangent comes back with the reverse shift, and
  every rank makes the same collectives in the same order whatever its
  stage (autograd alone would skip the shifts whose cotangents are zero
  on some ranks and not on others).
- The batch: each rank's ``x`` is its own rows (its block over ``data``,
  as every rank feeds its block, ``mesh.py``); the rows must divide into
  ``n_microbatches``.
- Stage parameters: a leaf marked as this rank's block (the estimator's
  ``pipe`` shard, ``tensor_parallel.shard_of``) is the stage's ``[1,
  ...]`` row; an unmarked leaf is the whole ``[S, ...]`` stack and the
  rank takes its row (its gradient lands in that row).
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from analytics_zoo_tpu_torch.parallel import collectives
from analytics_zoo_tpu_torch.parallel import mesh as mesh_lib


def _batch_layout(mesh, axis: str, rows: int, n_microbatches: int):
    """(pipe size S, dp size, microbatch rows); raises when this rank's
    ``rows`` do not divide into ``n_microbatches`` (JAX's global check,
    the global batch being ``rows x dp``)."""
    S = mesh_lib.mesh_axis_size(mesh, axis)
    dp = mesh_lib.mesh_axis_size(mesh, mesh_lib.DATA_AXIS)
    M = int(n_microbatches)
    if M < 1 or rows % M:
        raise ValueError(f"batch {rows * dp} not divisible by "
                         f"n_microbatches {M} x dp {dp}")
    return S, dp, rows // M


def _mesh_with_pipe(mesh, axis: str):
    if mesh is None:
        mesh = mesh_lib.get_default_mesh()
    if mesh_lib.mesh_axis_size(mesh, axis) < 2:
        raise ValueError(f"mesh has no usable {axis!r} axis: {mesh.shape}")
    return mesh


def _flatten(tree, out: list) -> None:
    """The leaves of a nested dict in ``jax.tree_util``'s order (keys
    sorted, depth first)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            _flatten(tree[k], out)
    else:
        out.append(tree)


def _rebuild(tree, leaves: list):
    """``tree``'s structure with ``leaves`` in ``_flatten``'s order."""
    it = iter(leaves)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(t[k]) for k in sorted(t)}
        return next(it)
    return walk(tree)


def _stage_rows(leaves: List[torch.Tensor], mesh, axis: str, S: int
                ) -> List[torch.Tensor]:
    """This rank's ``[1, ...]`` row of every stacked leaf."""
    from analytics_zoo_tpu_torch.parallel.tensor_parallel import shard_of
    first = leaves[0]
    if shard_of(first) is not None:
        for leaf in leaves:
            shard = shard_of(leaf)
            if shard is None or shard.axes != {axis} or leaf.shape[0] != 1:
                raise ValueError(
                    f"a stage parameter block must be one row over "
                    f"{axis!r} alone, got {shard}")
        return list(leaves)
    if first.shape[0] != S:
        raise ValueError(
            f"stacked params leading dim {first.shape[0]} != pipe size {S}")
    i = mesh.coord(axis)
    return [leaf[i:i + 1] for leaf in leaves]


class _Pipe:
    """One rank's part of a schedule: ``step(rows, act, feed_mb) ->
    (act_out, final_out)`` runs this rank's stage on its parameter rows
    (``final_out`` is read on the last stage only)."""

    def __init__(self, step: Callable, mesh, axis: str, S: int, M: int,
                 act_like: tuple, out_like: tuple):
        self.step, self.mesh, self.axis = step, mesh, axis
        self.S, self.M = S, M
        self.idx = mesh.coord(axis)
        self.group = mesh.axis_group(axis)
        self.act_shape, self.act_dtype = act_like
        self.out_shape, self.out_dtype = out_like

    @property
    def ticks(self) -> int:
        return self.M + self.S - 1

    def live(self, t: int) -> bool:
        return 0 <= t - self.idx < self.M

    @property
    def last(self) -> bool:
        return self.idx == self.S - 1

    def zeros_act(self, device):
        return torch.zeros(self.act_shape, dtype=self.act_dtype,
                           device=device)

    def shift(self, t: torch.Tensor, direction: int) -> torch.Tensor:
        return collectives._ring_shift_raw(t.contiguous(), self.mesh,
                                           self.axis, direction)

    def gather_out(self, buf: List[torch.Tensor], device) -> torch.Tensor:
        """The last stage's slots, summed over the pipe axis."""
        if self.last:
            out = torch.stack(buf).to(self.out_dtype)
        else:
            out = torch.zeros((self.M,) + tuple(self.out_shape),
                              dtype=self.out_dtype, device=device)
        return collectives._all_reduce_raw(out, self.group)

    def run(self, micro: torch.Tensor, rows: Sequence[torch.Tensor],
            keep_graph: bool = False):
        """The forward's ticks: the ``[M, mb, ...]`` output and, with
        ``keep_graph``, each live tick's ``(act, feed, out, fin)``, whose
        graphs the reverse schedule (``_Schedule.backward``) walks."""
        device = micro.device
        feed_grad = keep_graph and micro.requires_grad
        carry = self.zeros_act(device)
        saved, buf = {}, []
        for t in range(self.ticks):
            if self.live(t):
                act = carry if self.idx else self.zeros_act(device)
                feed = micro[min(t, self.M - 1)]
                if keep_graph:
                    act = act.detach().requires_grad_(self.idx > 0)
                    feed = feed.detach().requires_grad_(feed_grad)
                with torch.enable_grad() if keep_graph else \
                        contextlib.nullcontext():
                    out, fin = self.step(rows, act, feed)
                if keep_graph:
                    saved[t] = (act, feed, out, fin)
                    out = out.detach()
                if self.last:
                    buf.append(fin.detach())
            else:
                out = self.zeros_act(device)
            if t < self.ticks - 1:
                carry = self.shift(out, 1)
        return self.gather_out(buf, device), saved


class _Schedule(torch.autograd.Function):
    """The schedule with the reverse schedule as its backward (the module
    docstring)."""

    @staticmethod
    def forward(ctx, pipe: _Pipe, micro, *rows):
        rows_g = [r.detach().requires_grad_(r.requires_grad) for r in rows]
        out, saved = pipe.run(micro, rows_g, keep_graph=True)
        ctx.pipe, ctx.saved, ctx.rows_g = pipe, saved, rows_g
        ctx.feed_like = (micro.shape, micro.dtype) if micro.requires_grad \
            else None
        return out

    @staticmethod
    def backward(ctx, g_out):
        pipe, saved, rows_g = ctx.pipe, ctx.saved, ctx.rows_g
        g_buf = collectives._all_reduce_raw(g_out.contiguous(), pipe.group)
        device = g_out.device
        g_rows = [None] * len(rows_g)
        g_feed = None if ctx.feed_like is None else \
            torch.zeros(ctx.feed_like[0], dtype=ctx.feed_like[1],
                        device=device)
        g_recv = pipe.zeros_act(device)
        for t in reversed(range(pipe.ticks)):
            g_act = pipe.shift(g_recv, -1) if t < pipe.ticks - 1 \
                else pipe.zeros_act(device)
            if not pipe.live(t):
                g_recv = pipe.zeros_act(device)
                continue
            act, feed, out, fin = saved.pop(t)
            outs, gouts = [out], [g_act]
            if pipe.last:
                g_fin = g_buf[t - pipe.idx].to(fin.dtype)
                if fin is out:
                    gouts[0] = g_act + g_fin
                else:
                    outs.append(fin)
                    gouts.append(g_fin)
            wrt = [w for w in [act, feed, *rows_g] if w.requires_grad]
            got = dict(zip(map(id, wrt), torch.autograd.grad(
                outs, wrt, gouts, allow_unused=True)))
            for i, r in enumerate(rows_g):
                g = got.get(id(r))
                if g is not None:
                    g_rows[i] = g if g_rows[i] is None else g_rows[i] + g
            g_in, g_mb = got.get(id(act)), got.get(id(feed))
            g_recv = g_in if g_in is not None else pipe.zeros_act(device)
            if g_feed is not None and g_mb is not None:
                g_feed[min(t, pipe.M - 1)] += g_mb
        ctx.saved = None
        return (None, g_feed, *g_rows)


def _schedule(pipe: _Pipe, micro: torch.Tensor, rows) -> torch.Tensor:
    needs = torch.is_grad_enabled() and (micro.requires_grad or any(
        r.requires_grad for r in rows))
    if needs:
        return _Schedule.apply(pipe, micro, *rows)
    return pipe.run(micro, rows)[0]


def stack_stage_params(params_list):
    """S per-stage trees of one structure stacked along a new leading
    stage axis: the layout ``gpipe`` expects (dim 0 over ``pipe``)."""
    first = params_list[0]
    if isinstance(first, dict):
        return {k: stack_stage_params([p[k] for p in params_list])
                for k in first}
    return np.stack([np.asarray(p) if not isinstance(p, torch.Tensor)
                     else p.detach().cpu().numpy() for p in params_list])


def gpipe(stage_fn: Callable, stacked_params, x, *, mesh=None,
          n_microbatches: int, axis: str = mesh_lib.PIPE_AXIS):
    """``x`` (this rank's rows) through the S stages with the GPipe
    schedule; the output, the same on every pipe rank.

    - ``stage_fn(stage_params, activation) -> activation``: one stage;
      activations keep one shape across stages.
    - ``stacked_params``: a tree whose leaves have leading dim S
      (``stack_stage_params``), or this rank's ``[1, ...]`` blocks of them.
    """
    mesh = _mesh_with_pipe(mesh, axis)
    x = torch.as_tensor(x)
    S, _, mb = _batch_layout(mesh, axis, x.shape[0], n_microbatches)
    M = int(n_microbatches)
    leaves: list = []
    _flatten(stacked_params, leaves)
    leaves = [leaf if isinstance(leaf, torch.Tensor)
              else torch.as_tensor(leaf, device=x.device) for leaf in leaves]
    rows = _stage_rows(leaves, mesh, axis, S)
    idx = mesh.coord(axis)

    def step(rs, act, feed):
        p = _rebuild(stacked_params, [r[0] for r in rs])
        out = stage_fn(p, feed if idx == 0 else act)
        return out, out

    act_shape = (mb,) + tuple(x.shape[1:])
    pipe = _Pipe(step, mesh, axis, S, M, (act_shape, x.dtype),
                 (act_shape, x.dtype))
    out = _schedule(pipe, x.reshape((M,) + act_shape), rows)
    return out.reshape(x.shape)


def pack_stage_params(params_list):
    """S per-stage trees of different structures packed into one ``[S,
    maxlen]`` float32 array (rows zero-padded), with each stage's unravel
    function and size. A row flattens its tree as ``jax.flatten_util.
    ravel_pytree`` does (keys sorted, depth first), so JAX's packed
    matrix and this one are the same array."""
    flats, unravels, sizes = [], [], []
    for p in params_list:
        leaves: list = []
        _flatten(p, leaves)
        arrs = [np.asarray(leaf.detach().cpu() if isinstance(
            leaf, torch.Tensor) else leaf, np.float32) for leaf in leaves]
        flats.append(np.concatenate([a.ravel() for a in arrs])
                     if arrs else np.zeros(0, np.float32))
        unravels.append(_unraveler(p, [a.shape for a in arrs]))
        sizes.append(int(flats[-1].size))
    maxlen = max(sizes)
    packed = np.stack([np.pad(f, (0, maxlen - f.size)) for f in flats])
    return packed, unravels, sizes


def _unraveler(tree, shapes):
    counts = [int(np.prod(s)) for s in shapes]

    def unravel(vec):
        vec = torch.as_tensor(vec)
        leaves, off = [], 0
        for shape, n in zip(shapes, counts):
            leaves.append(vec[off:off + n].reshape(shape))
            off += n
        return _rebuild(tree, leaves)
    return unravel


def gpipe_hetero(stage_fns, unravels, sizes, packed, feed, *, mesh=None,
                 n_microbatches: int, act_shape, out_shape,
                 act_dtype=None, out_dtype=None,
                 axis: str = mesh_lib.PIPE_AXIS):
    """GPipe over heterogeneous stages (embedding, blocks and head inside
    the schedule). This rank runs ``stage_fns[s]`` for its stage ``s``
    alone, on its row of ``packed`` unravelled into that stage's tree.

    ``stage_fns[s](params_s, act, feed_mb) -> (act_out, final_out)``:
    ``act_out`` is ``(mb,) + act_shape`` for every stage (what the ring
    carries), ``final_out`` ``(mb,) + out_shape`` on the last stage (read
    there only: the others may return None, where JAX's return zeros).
    ``feed``: this rank's rows of the raw model input (e.g. token ids),
    handed to every stage, consumed by stage 0 (whose ``act`` is zeros).
    Differentiable in ``packed``."""
    mesh = _mesh_with_pipe(mesh, axis)
    S = mesh_lib.mesh_axis_size(mesh, axis)
    if S != len(stage_fns):
        raise ValueError(f"{len(stage_fns)} stages but pipe axis size {S}")
    feed = torch.as_tensor(feed)
    _, _, mb = _batch_layout(mesh, axis, feed.shape[0], n_microbatches)
    M = int(n_microbatches)
    if not isinstance(packed, torch.Tensor):
        packed = torch.as_tensor(packed, device=feed.device)
    (row,) = _stage_rows([packed], mesh, axis, S)
    s = mesh.coord(axis)
    fn, unravel, size = stage_fns[s], unravels[s], sizes[s]

    def step(rs, act, feed_mb):
        return fn(unravel(rs[0][0][:size]), act, feed_mb)

    pipe = _Pipe(step, mesh, axis, S, M,
                 ((mb,) + tuple(act_shape), act_dtype or torch.float32),
                 ((mb,) + tuple(out_shape), out_dtype or torch.float32))
    out = _schedule(pipe, feed.reshape((M, mb) + tuple(feed.shape[1:])),
                    [row])
    return out.reshape((feed.shape[0],) + tuple(out_shape))


def _ln(x, g, b, eps=1e-5):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * g + b


def _block_apply(p, h, nh):
    """Pre-LN causal transformer block on ``[mb, L, D]`` (plain-tree
    parameters, unravelled from a packed row); ``nh`` heads. JAX's einsum
    chain with its causal mask, and its tanh GELU."""
    D = h.shape[-1]
    L = h.shape[1]
    hd = D // nh
    x = _ln(h, p["ln1_g"], p["ln1_b"])

    def split(a):
        return a.reshape(a.shape[0], L, nh, hd)
    q, k, v = (split(x @ p[w]) for w in ("wq", "wk", "wv"))
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    cmask = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                  device=h.device))
    scores = torch.where(cmask, scores, torch.finfo(scores.dtype).min)
    probs = torch.softmax(scores, dim=-1)
    attn = torch.einsum("bhqk,bkhd->bqhd", probs, v)
    h = h + attn.reshape(h.shape[0], L, D) @ p["wo"]
    x = _ln(h, p["ln2_g"], p["ln2_b"])
    return h + F.gelu(x @ p["w1"] + p["b1"], approximate="tanh") \
        @ p["w2"] + p["b2"]


def _normal(gen, shape):
    return torch.randn(shape, generator=gen)


def _generator(rng) -> torch.Generator:
    return rng if isinstance(rng, torch.Generator) \
        else torch.Generator().manual_seed(int(rng))


class PipelinedTransformerLM:
    """Causal transformer LM whose embedding, blocks and head all live
    inside the schedule (heterogeneous stages): stage 0 is the embedding
    and a block, the middle stages a block, the last stage a block and
    the LM head. ``init`` / ``apply`` plug into ``Estimator.from_fn``;
    the one trainable leaf is the packed ``[S, maxlen]`` matrix on
    ``pipe``. ``apply_sequential`` runs the same stages one after
    another on the whole matrix: the oracle of the tests."""

    def __init__(self, vocab: int, d_model: int = 32, n_heads: int = 4,
                 d_ff: int = 64, seq_len: int = 16, n_stages: int = 4,
                 n_microbatches: int = 4, mesh=None):
        self.vocab, self.D, self.nh = vocab, d_model, n_heads
        self.d_ff, self.L = d_ff, seq_len
        self.S, self.M = n_stages, n_microbatches
        self.mesh = mesh
        self._unravels = None
        self._sizes = None

    def _block_params(self, gen):
        D, Fd = self.D, self.d_ff
        s = 1.0 / np.sqrt(D)
        return {
            "ln1_g": torch.ones(D), "ln1_b": torch.zeros(D),
            "ln2_g": torch.ones(D), "ln2_b": torch.zeros(D),
            "wq": _normal(gen, (D, D)) * s, "wk": _normal(gen, (D, D)) * s,
            "wv": _normal(gen, (D, D)) * s, "wo": _normal(gen, (D, D)) * s,
            "w1": _normal(gen, (D, Fd)) * s, "b1": torch.zeros(Fd),
            "w2": _normal(gen, (Fd, D)) / np.sqrt(Fd), "b2": torch.zeros(D),
        }

    def _stage_param_list(self, gen):
        stages = []
        for s in range(self.S):
            p = {"block": self._block_params(gen)}
            if s == 0:
                p["emb"] = _normal(gen, (self.vocab, self.D)) * 0.02
                p["pos"] = _normal(gen, (self.L, self.D)) * 0.02
            if s == self.S - 1:
                p["head"] = _normal(gen, (self.D, self.vocab)) \
                    / np.sqrt(self.D)
            stages.append(p)
        return stages

    def _stage_fns(self):
        L, D, nh = self.L, self.D, self.nh

        def first(p, act, tok):
            h = p["emb"][tok.long()] + p["pos"][None, :, :]
            return _block_apply(p["block"], h, nh), None

        def mid(p, act, tok):
            return _block_apply(p["block"], act, nh), None

        def last(p, act, tok):
            h = _block_apply(p["block"], act, nh)
            ones = torch.ones(D, dtype=h.dtype, device=h.device)
            return h, _ln(h, ones, torch.zeros_like(ones)) @ p["head"]

        return [first] + [mid] * (self.S - 2) + [last]

    def set_layout(self) -> "PipelinedTransformerLM":
        """The stages' unravel functions and sizes without drawing
        parameters (for params carried from elsewhere, e.g. JAX's packed
        matrix): the layout is the model's widths'."""
        gen = torch.Generator().manual_seed(0)
        _, self._unravels, self._sizes = pack_stage_params(
            self._stage_param_list(gen))
        return self

    def init(self, rng, tokens):
        """``{"pipe": [S, maxlen]}`` drawn from ``rng``: a
        ``torch.Generator`` (or an int seed), where JAX takes a key."""
        packed, self._unravels, self._sizes = pack_stage_params(
            self._stage_param_list(_generator(rng)))
        return {"pipe": torch.from_numpy(packed)}

    def apply(self, params, tokens):
        assert self._unravels is not None, "init first"
        return gpipe_hetero(
            self._stage_fns(), self._unravels, self._sizes, params["pipe"],
            tokens, mesh=self.mesh, n_microbatches=self.M,
            act_shape=(self.L, self.D), out_shape=(self.L, self.vocab))

    def apply_sequential(self, params, tokens):
        """The same stages, no pipeline, on the whole packed matrix."""
        fns = self._stage_fns()
        pipe = torch.as_tensor(params["pipe"])
        tokens = torch.as_tensor(tokens, device=pipe.device)
        act = torch.zeros((tokens.shape[0], self.L, self.D),
                          device=pipe.device)
        out = None
        for s, fn in enumerate(fns):
            vec = pipe[s][:self._sizes[s]]
            act, out = fn(self._unravels[s](vec), act, tokens)
        return out

    def param_rules(self):
        return [(r"pipe", (mesh_lib.PIPE_AXIS,))]


class PipelinedMLP:
    """S identical Dense + tanh stages over the pipe axis; the prologue
    and epilogue products replicated. ``init(generator, x)`` / ``apply(
    params, x)`` plug into ``Estimator.from_fn``."""

    def __init__(self, hidden: int, out_dim: int, n_stages: int,
                 n_microbatches: int = 4, mesh=None):
        self.hidden, self.out_dim = hidden, out_dim
        self.S, self.M = n_stages, n_microbatches
        self.mesh = mesh

    def init(self, rng, x):
        """The parameters drawn from ``rng`` (a ``torch.Generator`` or an
        int seed, where JAX takes a key): JAX's shapes and scales."""
        generator = _generator(rng)
        f_in = x.shape[-1]
        scale = 1.0 / np.sqrt(self.hidden)
        return {
            "w_in": _normal(generator, (f_in, self.hidden)) / np.sqrt(f_in),
            "stages": {
                "w": _normal(generator, (self.S, self.hidden, self.hidden))
                * scale,
                "b": torch.zeros((self.S, self.hidden)),
            },
            "w_out": _normal(generator, (self.hidden, self.out_dim)) * scale,
        }

    @staticmethod
    def _stage(p, h):
        return torch.tanh(h @ p["w"] + p["b"])

    def apply(self, params, x):
        h = torch.as_tensor(x) @ params["w_in"]
        h = gpipe(self._stage, params["stages"], h, mesh=self.mesh,
                  n_microbatches=self.M)
        return h @ params["w_out"]

    def apply_sequential(self, params, x):
        """The same stages one after another on the whole stack."""
        h = torch.as_tensor(x) @ params["w_in"]
        for s in range(self.S):
            h = self._stage({k: v[s] for k, v in params["stages"].items()},
                            h)
        return h @ params["w_out"]

    def param_rules(self):
        """The stacked stage dim on ``pipe`` for the estimator."""
        return [(r"stages/(w|b)", (mesh_lib.PIPE_AXIS,))]
