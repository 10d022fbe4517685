"""The port's multi-hot bag and the lookups' backward against the JAX
package's.

On the CPU (the plain versions), with inputs from numpy seeds:

- ``embedding_bag`` (and ``_bag_ref``) equals, bit for bit, both JAX's
  ``_bag_ref`` and the JAX Pallas ``_bag_kernel`` run by the CPU
  interpreter (``ZOO_PALLAS_INTERPRET=1``, ``use_kernel=True``): sum and
  mean, fp32 and bf16, empty bags, lengths past the bag, out-of-range ids
  past the length (masked), out-of-range ids before it (clamped) and
  float ids (truncated). ``embedding_bag_ragged`` equals JAX's.
- The backward plain versions against ``jax.vjp`` through both JAX
  routes. Through the kernel route (the custom VJP, ``_fused_bwd`` /
  ``_bag_bwd``): bit for bit, except the fused ``mean`` in fp32, where
  ``_fused_bwd`` divides by n and the port multiplies by the rounded
  reciprocal (autodiff of ``_fused_ref``, JAX's CPU training path): within
  one fp32 ulp. Through the reference route (autodiff of ``_fused_ref`` /
  ``_bag_ref``): the fused lookup bit for bit except ``mul`` over more than
  two tables (the port multiplies the other rows in ``_fused_bwd``'s
  order); the bag sums each row's updates slot by slot there, so it is
  held to the a-priori bound of two summation orders,
  ``2 (n - 1) u sum|x|`` per element (n updates of the row, u = 2^-24 fp32,
  2^-8 bf16).
- Both autograd Functions pass ``torch.autograd.gradcheck`` in float64;
  duplicate ids sum in position order (against a Python loop).

Long runs: past ``RUN_CHUNK`` (C) updates a row's gradient is summed in
two levels (chunks of C, then the chunk sums), so for rows taking C, C + 1
and 3C + 17 updates, the history column's padding row and a ``mul`` run,
both JAX routes are held to the bound of two summation orders, and the
plain version, bit for bit, to the two-level order written out as a numpy
loop in this file.

On the card only (marker ``cuda``): the bag and scatter kernels against
their plain versions bit for bit, also at long runs (C, C + 1, 3C + 17, a
row taking all 64 000 updates of the history column's batch, that batch's
padding row), two scatter launches giving the same bits, and one NCF
training step on the card moving all four tables.
JAX is imported by a fixture, so on a machine without it the ``cuda``
tests run: ``python -m pytest --noconftest -m cuda
tests/test_torch_embedding_bag_bwd.py``.
"""

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch.ops import embedding_bag as teb


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _interp(monkeypatch, tmp_path):
    monkeypatch.setenv("ZOO_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("ZOO_AUTOTUNE_CACHE",
                       str(tmp_path / "autotune.json"))


@pytest.fixture(scope="module")
def jeb():
    """The JAX package's lookup module."""
    return pytest.importorskip("analytics_zoo_tpu.ops.embedding_bag")


def _np(x):
    """Host float32 copy (bf16 widens exactly)."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x.astype("float32"))


def _assert_same_bits(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    nan_g, nan_w = np.isnan(got), np.isnan(want)
    np.testing.assert_array_equal(nan_g, nan_w)
    np.testing.assert_array_equal(got[~nan_g].view(np.uint32),
                                  want[~nan_w].view(np.uint32))


def _cast(arr, dtype):
    """(jax array, torch tensor) of ``arr`` in ``dtype``."""
    import jax.numpy as jnp
    j, t = jnp.asarray(arr), torch.from_numpy(np.ascontiguousarray(arr))
    if dtype == "bf16":
        return j.astype(jnp.bfloat16), t.to(torch.bfloat16)
    return j, t


def _bag_case(case, seed=0, vocab=11, dim=6, batch=24, bag=5):
    """(table, ids, lengths) numpy inputs for one named case."""
    rng = np.random.RandomState(seed)
    table = rng.randn(vocab, dim).astype(np.float32)
    ids = rng.randint(0, vocab, (batch, bag)).astype(np.int32)
    lengths = rng.randint(0, bag + 1, batch).astype(np.int32)
    lengths[:3] = (0, bag, 1)
    if case == "past_length_out_of_range":
        # slots at l >= len hold ids far out of range: masked, never read
        pos = np.arange(bag)[None, :]
        ids = np.where(pos >= lengths[:, None], 10 * vocab, ids)
    elif case == "clamped":
        ids = rng.randint(-2 * vocab, 2 * vocab, (batch, bag)).astype(
            np.int32)
    elif case == "long_lengths":
        lengths = rng.randint(bag, bag + 4, batch).astype(np.int32)
    elif case == "float_ids":
        ids = (ids + rng.uniform(0.0, 0.99, ids.shape)).astype(np.float32)
    elif case == "all_valid":
        lengths = None
    return table, ids, lengths


BAG_CASES = ["partial", "past_length_out_of_range", "clamped",
             "long_lengths", "float_ids", "all_valid"]


# ------------------------------------------------------------- forward

@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("case", BAG_CASES)
def test_bag_matches_jax_reference_and_kernel_bitwise(jeb, case, mode,
                                                      dtype):
    table, ids, lengths = _bag_case(case)
    jt, tt = _cast(table, dtype)
    got = teb.embedding_bag(tt, ids, lengths, mode)
    assert got.dtype == tt.dtype and got.shape == (ids.shape[0],
                                                   table.shape[1])
    for use_kernel in (False, True):
        want = jeb.embedding_bag(jt, ids, lengths, mode,
                                 use_kernel=use_kernel)
        _assert_same_bits(got, want)
    # the plain version itself, on the dispatcher's clamped int32 ids
    tid = torch.clamp(torch.as_tensor(ids).to(torch.int32), 0,
                      table.shape[0] - 1)
    tlen = torch.full((ids.shape[0],), ids.shape[1], dtype=torch.int32) \
        if lengths is None else torch.from_numpy(lengths)
    _assert_same_bits(teb._bag_ref(tt, tid, tlen, mode == "mean"),
                      jeb._bag_ref(jt, np.clip(np.asarray(ids).astype(
                          np.int32), 0, table.shape[0] - 1),
                          tlen.numpy(), mode == "mean"))


def test_empty_bags_are_exact_zeros():
    table = torch.randn(7, 4)
    ids = torch.tensor([[1, 2], [3, 4]])
    for mode in ("sum", "mean"):
        out = teb.embedding_bag(table, ids, torch.tensor([0, -2]), mode)
        assert torch.equal(out.view(torch.int32),
                           torch.zeros_like(out).view(torch.int32))


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_ragged_matches_jax(jeb, mode):
    import jax.numpy as jnp
    rng = np.random.RandomState(3)
    table = rng.randn(9, 5).astype(np.float32)
    counts = np.array([0, 3, 1, 0, 4, 2])
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    flat = rng.randint(0, 9, offsets[-1]).astype(np.int32)
    want = jeb.embedding_bag_ragged(jnp.asarray(table), jnp.asarray(flat),
                                    jnp.asarray(offsets), mode)
    got = teb.embedding_bag_ragged(torch.from_numpy(table),
                                   torch.from_numpy(flat),
                                   torch.from_numpy(offsets), mode)
    _assert_same_bits(got, want)


@pytest.mark.parametrize("bad", [
    dict(mode="max"), dict(ids=np.zeros((3,), np.int32)),
    dict(lengths=np.zeros((2,), np.int32)), dict(table=torch.zeros((0, 4)))])
def test_bag_rejects_bad_calls(bad):
    kw = dict(table=torch.zeros((5, 4)), ids=np.zeros((3, 2), np.int32),
              lengths=None, mode="sum")
    kw.update(bad)
    with pytest.raises(ValueError):
        teb.embedding_bag(**kw)


def test_non_cpu_tensors_never_take_the_plain_versions(monkeypatch):
    for name in ("_bag_ref", "_bag_bwd_ref", "_fused_bwd_ref"):
        monkeypatch.setattr(teb, name, None)
    with pytest.raises(ValueError, match="no embedding bag"):
        teb.embedding_bag(torch.empty((4, 2), device="meta"),
                          torch.zeros((3, 2)))


def test_plain_versions_count_no_launch():
    before = dict(bag=teb.bag_launches.value,
                  scatter=teb.scatter_launches.value)
    table = torch.randn(6, 3, requires_grad=True)
    teb.embedding_bag(table, torch.tensor([[1, 2, 3]]), mode="mean").sum() \
        .backward()
    assert table.grad is not None
    assert teb.bag_launches.value == before["bag"]
    assert teb.scatter_launches.value == before["scatter"]


# ------------------------------------------------------------- backward

def _jax_vjp(fn, primals, g):
    import jax
    _, vjp = jax.vjp(fn, *primals)
    return vjp(g)


def _row_sums(keys, updates, vocab):
    """(sum of |update| per row and column, number of updates per row)
    over the positions whose key is below ``vocab``."""
    total = np.zeros((vocab, updates.shape[1]))
    count = np.zeros(vocab)
    for k, row in zip(keys, np.abs(updates.astype(np.float64))):
        if k < vocab:
            total[k] += row
            count[k] += 1
    return total, count


def _pair_bound(keys, updates, vocab, unit):
    """Per element, the bound ``2 (n - 1) u sum|x|`` on the difference of
    two summation orders of each row's updates."""
    total, count = _row_sums(keys, updates, vocab)
    return 2 * np.maximum(count - 1, 0)[:, None] * unit * total


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("case", ["partial", "clamped",
                                  "past_length_out_of_range"])
def test_bag_backward_matches_jax(jeb, case, mode, dtype):
    table, ids, lengths = _bag_case(case, seed=4, batch=40)
    rng = np.random.RandomState(5)
    g = rng.randn(ids.shape[0], table.shape[1]).astype(np.float32)
    jt, tt = _cast(table, dtype)
    jg, tg = _cast(g, dtype)
    tw = tt.clone().requires_grad_(True)
    teb.embedding_bag(tw, ids, lengths, mode).backward(tg)
    got = tw.grad
    kernel_route = _jax_vjp(lambda t: jeb.embedding_bag(
        t, ids, lengths, mode, use_kernel=True), (jt,), jg)[0]
    _assert_same_bits(got, kernel_route)
    ref_route = _np(_jax_vjp(lambda t: jeb.embedding_bag(
        t, ids, lengths, mode, use_kernel=False), (jt,), jg)[0])
    cids = np.clip(ids.astype(np.int32), 0, table.shape[0] - 1)
    tlen = torch.from_numpy(lengths)
    keys = teb._bag_keys(torch.from_numpy(cids), tlen,
                         table.shape[0]).numpy()
    upd = _np(teb._bag_updates(tg, tlen, tt.dtype, mode == "mean"))
    unit = 2.0 ** -24 if dtype == "fp32" else 2.0 ** -8
    bound = _pair_bound(keys, np.repeat(upd, ids.shape[1], 0),
                        table.shape[0], unit)
    assert (np.abs(_np(got) - ref_route) <= bound).all()
    assert ref_route.shape == tuple(got.shape)


FUSED_CASES = [("concat", [3, 5]), ("sum", [4, 4, 4]), ("mean", [4, 4, 4]),
               ("mul", [4, 4]), ("mul", [4, 4, 4])]


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("combine,widths", FUSED_CASES)
def test_fused_backward_matches_jax(jeb, combine, widths, dtype):
    rng = np.random.RandomState(6)
    batch, vocab = 40, 11
    tables = [rng.randn(vocab + i, w).astype(np.float32)
              for i, w in enumerate(widths)]
    # ids over [-2V, 2V): some wrap, some are NaN rows that scatter nowhere
    ids = np.stack([rng.randint(-2 * t.shape[0], 2 * t.shape[0], batch)
                    for t in tables], 1).astype(np.int32)
    d_out = sum(widths) if combine == "concat" else widths[0]
    g = rng.randn(batch, d_out).astype(np.float32)
    pairs = [_cast(t, dtype) for t in tables]
    jts, tts = [p[0] for p in pairs], [p[1] for p in pairs]
    jg, tg = _cast(g, dtype)
    tws = [t.clone().requires_grad_(True) for t in tts]
    teb.fused_embedding_lookup(tws, ids, combine).backward(tg)
    routes = {uk: _jax_vjp(lambda *ts: jeb.fused_embedding_lookup(
        ts, ids, combine, use_kernel=uk), jts, jg) for uk in (False, True)}
    for i, tw in enumerate(tws):
        got = tw.grad
        assert got.dtype == tts[i].dtype
        if combine == "mul" and len(widths) > 2:
            # the port multiplies the other rows in _fused_bwd's order
            _assert_same_bits(got, routes[True][i])
            np.testing.assert_allclose(_np(got), _np(routes[False][i]),
                                       rtol=2.0 ** -22 if dtype == "fp32"
                                       else 2.0 ** -6, atol=0)
        elif combine == "mean" and dtype == "fp32":
            # g · fl(1/n) (autodiff of _fused_ref) vs _fused_bwd's g / n:
            # each update within 2 ulps, summed in the same order, so each
            # element within (n + 2) 2^-23 sum|x| over the row's n updates
            _assert_same_bits(got, routes[False][i])
            keys = teb._fused_keys(torch.from_numpy(ids[:, i]),
                                   tables[i].shape[0]).numpy()
            upd = _np(teb._fused_updates(tts, torch.from_numpy(ids), tg,
                                         combine, i))
            total, count = _row_sums(keys, upd, tables[i].shape[0])
            bound = (count + 2)[:, None] * 2.0 ** -23 * total
            assert (np.abs(_np(got) - _np(routes[True][i])) <= bound).all()
        else:
            _assert_same_bits(got, routes[False][i])
            _assert_same_bits(got, routes[True][i])


# ---------------------------------------------- long runs (two-level sum)

C = teb.RUN_CHUNK
LONG_CASES = [("one_row", C), ("one_row", C + 1), ("one_row", 3 * C + 17),
              ("bag_pad_sum", None), ("bag_pad_mean", None),
              ("mul", C + 30)]


def _bf16_round(x):
    """float32 ``x`` rounded to the nearest bf16, ties to even (finite
    values), kept as float32."""
    b = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return b.astype(np.uint32).view(np.float32)


def _two_level_numpy(vocab, keys, updates, bag, bf16):
    """The scatter's order, written out: each row's updates in position
    order; a run of at most C summed from zero, a longer one cut into
    chunks of C from its start, each chunk summed from zero, then the
    chunk sums summed from zero; every add in fp32, rounded to bf16 after
    each add for a bf16 table."""
    rnd = _bf16_round if bf16 else (lambda x: x)
    updates = np.asarray(updates, np.float32)

    def seq(xs):
        acc = np.zeros(updates.shape[1], np.float32)
        for x in xs:
            acc = rnd((acc + x).astype(np.float32))
        return acc

    out = np.zeros((vocab, updates.shape[1]), np.float32)
    for row in range(vocab):
        ups = [updates[p // bag] for p in range(len(keys)) if keys[p] == row]
        sums = [seq(ups[i:i + C]) for i in range(0, len(ups), C)]
        if sums:
            out[row] = sums[0] if len(sums) == 1 else seq(sums)
    return out


def _long_case(jeb, case, n_hot, dtype):
    """(port grads, JAX grads through both routes, per-table (keys,
    updates, bag, vocab)) of one long-run case."""
    rng = np.random.RandomState(11 if n_hot is None else n_hot)
    if case.startswith("bag_pad"):
        # the history column: pad id 0 after a length in [1, 8], no
        # lengths reaching the layer, so row 0 takes about 450 updates
        mode = case.rsplit("_", 1)[1]
        batch, bag, vocab = 128, 8, 13
        table = rng.randn(vocab, 5).astype(np.float32)
        lengths = rng.randint(1, bag + 1, batch)
        ids = np.where(np.arange(bag)[None, :] < lengths[:, None],
                       rng.randint(1, vocab, (batch, bag)), 0).astype(np.int32)
        g = rng.randn(batch, 5).astype(np.float32)
        jt, tt = _cast(table, dtype)
        jg, tg = _cast(g, dtype)
        tw = tt.clone().requires_grad_(True)
        teb.embedding_bag(tw, ids, None, mode).backward(tg)
        routes = [_jax_vjp(lambda t: jeb.embedding_bag(
            t, ids, None, mode, use_kernel=uk), (jt,), jg)[0]
            for uk in (False, True)]
        full = torch.full((batch,), bag, dtype=torch.int32)
        keys = teb._bag_keys(torch.from_numpy(ids), full, vocab).numpy()
        upd = _np(teb._bag_updates(tg, full, tt.dtype, mode == "mean"))
        return [tw.grad], [routes], [(keys, upd, bag, vocab)]
    combine = "mul" if case == "mul" else "concat"
    batch, vocab = n_hot + 40, 11
    widths = [4, 4] if combine == "mul" else [3, 5]
    tables = [rng.randn(vocab + i, w).astype(np.float32)
              for i, w in enumerate(widths)]
    ids = np.stack([rng.randint(0, t.shape[0], batch) for t in tables], 1)
    hot = 1 if combine == "mul" else 0
    col = np.where(ids[:, hot] == 3, 4, ids[:, hot])
    col[rng.permutation(batch)[:n_hot]] = 3   # row 3 takes n_hot updates
    ids[:, hot] = col
    ids = ids.astype(np.int32)
    d_out = sum(widths) if combine == "concat" else widths[0]
    g = rng.randn(batch, d_out).astype(np.float32)
    pairs = [_cast(t, dtype) for t in tables]
    jts, tts = [p[0] for p in pairs], [p[1] for p in pairs]
    jg, tg = _cast(g, dtype)
    tws = [t.clone().requires_grad_(True) for t in tts]
    teb.fused_embedding_lookup(tws, ids, combine).backward(tg)
    routes = [_jax_vjp(lambda *ts: jeb.fused_embedding_lookup(
        ts, ids, combine, use_kernel=uk), jts, jg) for uk in (False, True)]
    per_table = [(teb._fused_keys(torch.from_numpy(ids[:, i]),
                                  t.shape[0]).numpy(),
                  _np(teb._fused_updates(tts, torch.from_numpy(ids), tg,
                                         combine, i)), 1, t.shape[0])
                 for i, t in enumerate(tables)]
    return ([tw.grad for tw in tws],
            [[r[i] for r in routes] for i in range(len(tables))], per_table)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("case,n_hot", LONG_CASES)
def test_long_run_backward_within_pair_bound_of_jax(jeb, case, n_hot,
                                                    dtype):
    # past C updates a row's sum runs in two levels, so JAX's order and the
    # port's differ: both routes within the bound of two summation orders
    grads, routes, per_table = _long_case(jeb, case, n_hot, dtype)
    unit = 2.0 ** -24 if dtype == "fp32" else 2.0 ** -8
    longest = 0
    for got, jax_grads, (keys, upd, bag, vocab) in zip(grads, routes,
                                                       per_table):
        bound = _pair_bound(keys, np.repeat(upd, bag, 0), vocab, unit)
        for want in jax_grads:
            want = _np(want)
            assert want.shape == tuple(got.shape)
            assert (np.abs(_np(got) - want) <= bound).all()
        longest = max(longest, int(np.bincount(keys[keys < vocab]).max()))
    assert longest > C if n_hot is None else longest == n_hot


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("case,n_hot", LONG_CASES)
def test_scatter_plain_version_follows_the_two_level_order(jeb, case, n_hot,
                                                           dtype):
    grads, _, per_table = _long_case(jeb, case, n_hot, dtype)
    for got, (keys, upd, bag, vocab) in zip(grads, per_table):
        want = _two_level_numpy(vocab, keys, upd, bag, dtype == "bf16")
        _assert_same_bits(got, want)
        plain = teb._scatter_ref(vocab, torch.from_numpy(keys),
                                 torch.from_numpy(upd).to(got.dtype), bag)
        _assert_same_bits(plain, want)


def test_duplicate_ids_sum_in_position_order():
    # every id the same: the row's gradient is the sequential fp32 sum
    rng = np.random.RandomState(7)
    g = rng.randn(64, 3).astype(np.float32) * np.float32(1e3) ** rng.randint(
        -1, 2, (64, 1)).astype(np.float32)
    tables = [torch.zeros(5, 3, requires_grad=True)]
    ids = torch.full((64, 1), 2, dtype=torch.int32)
    teb.fused_embedding_lookup(tables, ids, "concat").backward(
        torch.from_numpy(g))
    want = np.zeros(3, np.float32)
    for row in g:
        want = (want + row).astype(np.float32)
    np.testing.assert_array_equal(tables[0].grad[2].numpy().view(np.uint32),
                                  want.view(np.uint32))
    assert not tables[0].grad[[0, 1, 3, 4]].any()


@pytest.mark.parametrize("combine", ["concat", "sum", "mean", "mul"])
def test_fused_function_gradcheck(combine):
    gen = torch.Generator().manual_seed(0)
    tables = [torch.randn(6 + i, 3, generator=gen, dtype=torch.float64,
                          requires_grad=True) for i in range(3)]
    ids = torch.randint(-6, 6, (8, 3), generator=gen, dtype=torch.int32)
    ids[0, 0] = 5
    ids[1, 0] = 5   # a duplicate
    assert torch.autograd.gradcheck(
        lambda *ts: teb.fused_embedding_lookup(ts, ids, combine), tables)


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_bag_function_gradcheck(mode):
    gen = torch.Generator().manual_seed(1)
    table = torch.randn(7, 3, generator=gen, dtype=torch.float64,
                        requires_grad=True)
    ids = torch.randint(-2, 9, (6, 4), generator=gen, dtype=torch.int32)
    lengths = torch.tensor([0, 1, 4, 2, 6, 3], dtype=torch.int32)
    assert torch.autograd.gradcheck(
        lambda t: teb.embedding_bag(t, ids, lengths, mode), (table,))


# ------------------------------------------------------------- the card

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_cuda_bag_and_its_backward_match_plain_bitwise(mode, dtype):
    dev = _cuda()
    gen = torch.Generator().manual_seed(2)
    table = torch.randn(3707, 20, generator=gen).to(dev, dtype)
    ids = torch.randint(-5, 3712, (1000, 8), generator=gen).to(dev)
    lengths = torch.randint(0, 9, (1000,), generator=gen).to(dev)
    g = torch.randn(1000, 20, generator=gen).to(dev, dtype)
    before = (teb.bag_launches.value, teb.scatter_launches.value)
    tw = table.clone().requires_grad_(True)
    got = teb.embedding_bag(tw, ids, lengths, mode)
    got.backward(g)
    torch.cuda.synchronize()
    assert (teb.bag_launches.value, teb.scatter_launches.value) == (
        before[0] + 1, before[1] + 1)
    cids = torch.clamp(ids.to(torch.int32), 0, 3706)
    lens = lengths.to(torch.int32)
    _assert_same_bits(got, teb._bag_ref(table, cids, lens, mode == "mean"))
    want = teb._bag_bwd_ref(3707, dtype, cids, lens, g, mode == "mean")
    _assert_same_bits(tw.grad, want)
    again = teb._bag_bwd_cuda(3707, dtype, cids, lens, g, mode == "mean")
    _assert_same_bits(again, tw.grad)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("combine", ["concat", "sum", "mean", "mul"])
def test_cuda_fused_backward_matches_plain_bitwise(combine, dtype):
    dev = _cuda()
    gen = torch.Generator().manual_seed(3)
    tables = [torch.randn(500 + i, 20, generator=gen).to(dev, dtype)
              for i in range(2)]
    ids = torch.randint(-1000, 1000, (1000, 2), generator=gen,
                        dtype=torch.int32).to(dev)
    ids[:100] = 7   # a hot row
    d_out = 40 if combine == "concat" else 20
    g = torch.randn(1000, d_out, generator=gen).to(dev, dtype)
    got = teb._fused_bwd_cuda(tables, ids, g, combine)
    want = teb._fused_bwd_ref(tables, ids, g, combine)
    again = teb._fused_bwd_cuda(tables, ids, g, combine)
    torch.cuda.synchronize()
    for a, b, c in zip(got, want, again):
        _assert_same_bits(a, b)
        _assert_same_bits(a, c)


def _history_batch(rng, batch=8000, bag=8, items=3706):
    """The item-history column's batch: a length in [1, bag], item ids in
    [1, items], pad id 0 after the length."""
    lengths = rng.randint(1, bag + 1, batch)
    ids = rng.randint(1, items + 1, (batch, bag))
    return np.where(np.arange(bag)[None, :] < lengths[:, None], ids,
                    0).astype(np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["run_C", "run_C_plus_1", "run_3C_plus_17",
                                  "one_row_64000", "history_pad_row",
                                  "history_pad_row_mean", "mul_long_run"])
def test_cuda_scatter_long_runs_match_plain_bitwise(case, dtype):
    dev = _cuda()
    rng = np.random.RandomState(len(case))
    if case.startswith(("history", "one_row")):
        # the bag's backward, pads counted (no lengths reach the layer):
        # row 0 takes about 28 000 of 64 000 updates, or row 5 all of them
        ids = _history_batch(rng) if case.startswith("history") else \
            np.full((8000, 8), 5, np.int32)
        ids = torch.from_numpy(ids).to(dev)
        lengths = torch.full((8000,), 8, dtype=torch.int32, device=dev)
        g = torch.from_numpy(rng.randn(8000, 20).astype(np.float32)).to(
            dev, dtype)
        mean = case.endswith("mean")
        got = [teb._bag_bwd_cuda(3707, dtype, ids, lengths, g, mean)]
        want = [teb._bag_bwd_ref(3707, dtype, ids, lengths, g, mean)]
        again = [teb._bag_bwd_cuda(3707, dtype, ids, lengths, g, mean)]
    else:
        n_hot = {"run_C": C, "run_C_plus_1": C + 1, "run_3C_plus_17":
                 3 * C + 17, "mul_long_run": 2 * C + 5}[case]
        combine = "mul" if case.startswith("mul") else "concat"
        batch = n_hot + 300
        tables = [torch.from_numpy(rng.randn(500 + i, 20).astype(
            np.float32)).to(dev, dtype) for i in range(2)]
        ids = np.stack([rng.randint(0, 500, batch) for _ in range(2)], 1)
        col = np.where(ids[:, 1] == 7, 8, ids[:, 1])
        col[rng.permutation(batch)[:n_hot]] = 7
        ids[:, 1] = col
        ids = torch.from_numpy(ids.astype(np.int32)).to(dev)
        d_out = 40 if combine == "concat" else 20
        g = torch.from_numpy(rng.randn(batch, d_out).astype(np.float32)).to(
            dev, dtype)
        got = teb._fused_bwd_cuda(tables, ids, g, combine)
        want = teb._fused_bwd_ref(tables, ids, g, combine)
        again = teb._fused_bwd_cuda(tables, ids, g, combine)
    torch.cuda.synchronize()
    for a, b, c in zip(got, want, again):
        _assert_same_bits(a, b)
        _assert_same_bits(a, c)


@pytest.mark.cuda
def test_cuda_training_step_moves_every_table():
    _cuda()
    from analytics_zoo_tpu_torch.learn import Estimator
    from analytics_zoo_tpu_torch.models import NeuralCF
    ncf = NeuralCF(user_count=50, item_count=40, class_num=5, user_embed=8,
                   item_embed=8, hidden_layers=(16, 8), include_mf=True,
                   mf_embed=8)
    module = ncf.model.module
    tables = {k: v.clone() for k, v in module.state_dict().items()
              if k.endswith(".embedding")}
    assert len(tables) == 4
    rng = np.random.RandomState(0)
    x = np.stack([rng.randint(1, 51, 64), rng.randint(1, 41, 64)],
                 1).astype(np.float32)
    y = rng.randint(0, 5, 64).astype(np.int32)
    before = teb.scatter_launches.value
    est = Estimator.from_torch(model=module, loss="sparse_categorical_"
                               "crossentropy", optimizer="adam",
                               device="cuda")
    est.fit((x, y), epochs=1, batch_size=64)
    assert teb.scatter_launches.value == before + 4
    state = module.state_dict()
    for name, old in tables.items():
        assert not torch.equal(state[name].cpu(), old), name
