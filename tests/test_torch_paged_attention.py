"""The port's paged decode kernels against the JAX package's.

analytics_zoo_tpu_torch/ops/paged_attention.py on the CPU (its plain
versions) against the JAX reference and the JAX Pallas kernels run by the
CPU interpreter (``ZOO_PALLAS_INTERPRET``): the gather bitwise (fp32 and
int8, a page used twice, full / mid-page / empty rows, stale pages, table
entries out of range, ``out_len``), the decode attention within ``rtol
2e-5, atol 2e-6`` (the limit JAX holds its kernel to) with empty rows
exactly zero. The attention's split plan (every page slot in one split,
from the shapes alone; one split where a block reaches the row in one
round) and the combine's sums (per-split partials folded by
``_combine_splits_ref`` against the reference and JAX's interpreted
kernel), the float64 reference the kernel is held to on the card, and the
kernel route's host work (no scales tensor for float32, indices passed
through) run on the CPU. Inputs come from numpy seeds. The CUDA kernels against the
plain versions run on the card only (marker ``cuda``). JAX is imported by
a fixture, so on a machine without it the JAX comparisons skip and the
``cuda`` tests run: ``python -m pytest --noconftest -m cuda
tests/test_torch_paged_attention.py``.
"""

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch.ops import paged_attention as tpa

N_PAGES, PS, DIM = 7, 4, 8
TABLE = np.array([[3, 1], [0, 6], [5, 5]], np.int32)   # a page used twice
LENGTHS = np.array([8, 5, 0], np.int32)                # full / mid / empty
RTOL, ATOL = 2e-5, 2e-6


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
def jpa():
    """The JAX package's paged kernels module."""
    return pytest.importorskip("analytics_zoo_tpu.ops.paged_attention")


def _pool(dtype="float32", seed=0, n_pages=N_PAGES, ps=PS, dim=DIM):
    rng = np.random.default_rng(seed)
    if dtype == "int8":
        pool = rng.integers(-127, 128, (n_pages, ps, dim)).astype(np.int8)
        scales = rng.uniform(0.005, 0.05, n_pages).astype(np.float32)
    else:
        pool = rng.standard_normal((n_pages, ps, dim)).astype(np.float32)
        scales = np.ones(n_pages, np.float32)
    return pool, scales


def _jax_gather(jpa, route, pool, table, lengths, scales, out_len=None):
    return np.asarray(jpa.paged_gather(pool, table, lengths, scales=scales,
                                       out_len=out_len,
                                       use_kernel=route == "pallas"))


def _port_gather(pool, table, lengths, scales, out_len=None):
    return tpa.paged_gather(torch.from_numpy(pool), table, lengths,
                            scales=scales, out_len=out_len).numpy()


# ------------------------------------------------------------ paged gather

@pytest.mark.parametrize("route", ["ref", "pallas"])
@pytest.mark.parametrize("case", ["plain", "stale", "out_of_range",
                                  "out_len"])
@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_gather_matches_jax_bitwise(jpa, dtype, case, route):
    """Bitwise against JAX's ``_gather_ref_core`` (``route="ref"``) and
    its interpreted Pallas kernel: the plain table; pages full of stale
    garbage past the live lengths (1e30 / 127, never read); table entries
    out of range on live positions (clamped, as JAX clamps); an
    ``out_len`` trim."""
    pool, scales = _pool(dtype)
    table, lengths, out_len = TABLE, LENGTHS, None
    if case == "stale":
        big = 127 if dtype == "int8" else 1e30
        pool[6] = big                        # recycled, never zeroed
        pool[1, 1:] = big                    # stale tail of a live page
        table = np.array([[1, 6], [6, 6]], np.int32)
        lengths = np.array([1, 0], np.int32)
    elif case == "out_of_range":
        table = np.array([[0, 99], [-3, 2]], np.int32)
        lengths = np.array([7, 8], np.int32)
    elif case == "out_len":
        out_len = 6
    got = _port_gather(pool, table, lengths, scales, out_len)
    want = _jax_gather(jpa, route, pool, table, lengths, scales, out_len)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    if case == "stale":
        assert not got[0, 1:].any() and not got[1].any()


def test_gather_out_len_trims_and_is_checked():
    pool, scales = _pool()
    full = _port_gather(pool, TABLE, LENGTHS, scales)
    assert full.shape == (3, 2 * PS, DIM)
    np.testing.assert_array_equal(
        _port_gather(pool, TABLE, LENGTHS, scales, out_len=5), full[:, :5])
    with pytest.raises(ValueError, match="out_len"):
        _port_gather(pool, TABLE, LENGTHS, scales, out_len=2 * PS + 1)
    with pytest.raises(ValueError, match="do not match"):
        _port_gather(pool, TABLE, LENGTHS[:2], scales)
    pt = torch.from_numpy(pool)
    with pytest.raises(ValueError, match="do not match"):
        tpa.paged_attention(np.ones((3, DIM + 1), np.float32), pt, pt,
                            TABLE, LENGTHS)


def test_plain_versions_count_no_launch_and_other_devices_raise():
    pool, scales = _pool()
    before = (tpa.gather_launches.value, tpa.attention_launches.value)
    _port_gather(pool, TABLE, LENGTHS, scales)
    tpa.paged_attention(np.ones((3, DIM), np.float32),
                        torch.from_numpy(pool), torch.from_numpy(pool),
                        TABLE, LENGTHS)
    assert (tpa.gather_launches.value,
            tpa.attention_launches.value) == before
    meta = torch.empty((N_PAGES, PS, DIM), device="meta")
    with pytest.raises(ValueError, match="no paged gather"):
        tpa.paged_gather(meta, TABLE, LENGTHS)
    with pytest.raises(ValueError, match="no paged attention"):
        tpa.paged_attention(torch.ones((3, DIM)), meta, meta, TABLE, LENGTHS)


# ------------------------------------------------- paged decode attention

ATTN_TABLE = np.array([[3, 1], [0, 6], [5, 2], [4, 4]], np.int32)
ATTN_LENGTHS = np.array([8, 5, 4, 0], np.int32)   # boundary at 4 = PS


@pytest.mark.parametrize("route", ["ref", "pallas"])
@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_attention_matches_jax(jpa, dtype, route):
    """Page-table indexing, masking and softmax against JAX's dense
    reference and its interpreted online-softmax kernel, across a full
    row, a mid-page length, a page-boundary length and an empty row."""
    k_pool, k_scales = _pool(dtype, seed=1)
    v_pool, v_scales = _pool(dtype, seed=2)
    q = np.random.default_rng(3).standard_normal((4, DIM)).astype(
        np.float32)
    got = tpa.paged_attention(
        q, torch.from_numpy(k_pool), torch.from_numpy(v_pool), ATTN_TABLE,
        ATTN_LENGTHS, k_scales=k_scales, v_scales=v_scales).numpy()
    want = np.asarray(jpa.paged_attention(
        q, k_pool, v_pool, ATTN_TABLE, ATTN_LENGTHS, k_scales=k_scales,
        v_scales=v_scales, use_kernel=route == "pallas"))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert not got[3].any()                      # empty row: exact zeros


def test_attention_softmax_scale_and_dead_pages(jpa):
    """An explicit ``softmax_scale``; a dead page poisoned with 1e3 (as
    JAX's test) and with inf / NaN changes no bit of the port's answer.
    JAX's Pallas kernel reads dead pages and gives NaN for the inf / NaN
    poison (ROADMAP C6); its reference does not, and the port follows
    it."""
    k_pool, _ = _pool(seed=7)
    v_pool, _ = _pool(seed=8)
    table = np.array([[1, 5]], np.int32)
    lengths = np.array([3], np.int32)        # page 5 dead, page 1 part-live
    q = np.ones((1, DIM), np.float32)

    def port(k, v):
        return tpa.paged_attention(q, torch.from_numpy(k),
                                   torch.from_numpy(v), table, lengths,
                                   softmax_scale=0.5).numpy()

    base = port(k_pool, v_pool)
    want = np.asarray(jpa.paged_attention_ref(q, k_pool, v_pool, table,
                                              lengths, softmax_scale=0.5))
    np.testing.assert_allclose(base, want, rtol=RTOL, atol=ATOL)
    for poison in (1e3, np.inf, np.nan):
        k, v = k_pool.copy(), v_pool.copy()
        k[5], v[5] = poison, -poison
        k[1, 3], v[1, 3] = poison, -poison   # the dead slot of page 1
        np.testing.assert_array_equal(port(k, v), base)
        jax_kernel = np.asarray(jpa.paged_attention(
            q, k, v, table, lengths, softmax_scale=0.5, use_kernel=True))
        if poison == 1e3:
            assert np.isfinite(jax_kernel).all()
        else:                                # 0 * inf: the whole row NaN
            assert np.isnan(jax_kernel).all()


# ------------------------------------ the split plan and the combine's sums

# (page_size, dim, int8): the decode slice's rows, JAX's test shape, the
# wide and long pools' rows in fp32 and int8, a dim that takes scalar loads
PLAN_ROWS = [(8, 8, False), (4, 8, True), (16, 128, False), (16, 128, True),
             (4, 6, False)]


@pytest.mark.parametrize("row", PLAN_ROWS)
@pytest.mark.parametrize("width", [1, 2, 5, 16, 257, 2048, 5000])
@pytest.mark.parametrize("batch", [1, 3, 8, 32, 527, 528, 4096])
def test_attention_plan_owns_every_slot_once(batch, width, row):
    """Every page slot in exactly one split, no split without a slot,
    ``1 <= splits <= width``, about ``SPLIT_WAVES`` blocks an SM, and one
    split where one block reaches a whole row in one round, the batch
    alone fills that many blocks or a row has one slot. The plan takes no
    lengths: they live on the device."""
    import inspect
    n_sm = 132
    ps, dim, quantized = row
    assert "lengths" not in inspect.signature(tpa._attention_plan).parameters
    splits, per = tpa._attention_plan(batch, width, ps, dim, quantized, n_sm)
    assert 1 <= splits <= min(width, tpa.MAX_SPLITS)
    owned = [slot for s in range(splits)
             for slot in range(s * per, min((s + 1) * per, width))]
    assert owned == list(range(width))
    assert (splits - 1) * per < width
    want = -(-tpa.SPLIT_WAVES * n_sm // batch)
    if want <= 1 or width == 1 \
            or width * ps <= tpa._block_reach(dim, quantized):
        assert splits == 1
    else:
        assert splits > 1 and 2 * splits >= min(want, width, tpa.MAX_SPLITS)


@pytest.mark.parametrize("row,reach", [((8, 8, False), 256),
                                       ((8, 8, True), 256),
                                       ((16, 128, False), 16),
                                       ((16, 128, True), 64),
                                       ((16, 64, False), 32),
                                       ((4, 6, False), 64),
                                       ((4, 1024, False), 4)])
def test_block_reach_follows_the_kernels_lanes(row, reach):
    """The positions a block takes in a round: 4 warps, 32 lanes over a
    group of lanes a position (16-byte vectors: 2 lanes at d 8, 32 at d
    128 fp32, 8 at d 128 int8; one element a lane at d 6), 4 vectors a
    lane ahead. The decode slice's 40 positions fit one round (one
    split, one launch); 4096 do not."""
    ps, dim, quantized = row
    assert tpa._block_reach(dim, quantized) == reach
    assert tpa._attention_plan(8, 5, ps, dim, quantized, 132)[0] == (
        1 if 5 * ps <= reach else 5)
    assert tpa._attention_plan(32, 256, ps, dim, quantized, 132)[0] > 1


SPLIT_PAGES, SPLIT_WIDTH = 9, 6
SPLIT_TABLE = np.random.default_rng(20).integers(
    0, SPLIT_PAGES, (6, SPLIT_WIDTH)).astype(np.int32)
# full / mid-page / one page / empty / one position / mid-page
SPLIT_LENGTHS = np.array([24, 13, 4, 0, 1, 9], np.int32)
_jax_split_want = {}


def _split_partials_ref(q, k_pool, v_pool, table, lengths, splits, *,
                        k_scales=None, v_scales=None):
    """What the split kernel writes for ``splits`` splits, in plain
    PyTorch: ``[batch, splits, dim + 2]`` of ``(m, l, acc)``, split ``s``
    over the live positions of page slots ``[s*P, (s+1)*P)``, ``P =
    ceil(width / splits)``, each by the reference's two passes. A split
    with no live position is ``(NEG_INF, 0, 0)``."""
    s, live, v = tpa._scores_ref(q, k_pool, v_pool, table, lengths,
                                 k_scales, v_scales, None)
    ps = k_pool.shape[1]
    width = s.shape[1] // ps
    per = -(-width // splits) * ps
    zero = torch.zeros(())
    parts = []
    for i in range(splits):
        si, li = s[:, i * per:(i + 1) * per], live[:, i * per:(i + 1) * per]
        if si.shape[1] == 0:
            m = torch.full((s.shape[0], 1), tpa.NEG_INF)
        else:
            m = si.amax(dim=1, keepdim=True)
        w = torch.where(li, torch.exp(si - m), zero)
        acc = torch.einsum("bn,bnd->bd", w, v[:, i * per:(i + 1) * per])
        parts.append(torch.cat([m, w.sum(dim=1, keepdim=True), acc], 1))
    return torch.stack(parts, 1)


def _split_case(dtype):
    k_pool, k_scales = _pool(dtype, seed=21, n_pages=SPLIT_PAGES)
    v_pool, v_scales = _pool(dtype, seed=22, n_pages=SPLIT_PAGES)
    q = np.random.default_rng(23).standard_normal((6, DIM)).astype(
        np.float32)
    return q, k_pool, v_pool, k_scales, v_scales


@pytest.mark.parametrize("splits", range(1, 9))
@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_split_partials_combine_to_the_reference(jpa, dtype, splits):
    """The split kernel's arithmetic in plain PyTorch: per-split partials
    folded by ``_combine_splits_ref`` agree with ``paged_attention_ref``
    and with JAX's interpreted ``_attn_pallas`` within the limit, for 1 to
    8 splits of 6 page slots (7 and 8 leave splits with no slot); a row
    of length 0 gives exact zeros; a split past its row's length is
    ``(NEG_INF, 0, 0)`` and adds nothing, bit for bit."""
    q, k_pool, v_pool, k_scales, v_scales = _split_case(dtype)
    quant = dtype == "int8"
    kw = dict(k_scales=torch.from_numpy(k_scales) if quant else None,
              v_scales=torch.from_numpy(v_scales) if quant else None)
    args = (torch.from_numpy(q), torch.from_numpy(k_pool),
            torch.from_numpy(v_pool), SPLIT_TABLE, SPLIT_LENGTHS)
    parts = _split_partials_ref(*args, splits, **kw)
    assert parts.shape == (6, splits, DIM + 2)
    got = tpa._combine_splits_ref(parts).numpy()
    want = tpa.paged_attention_ref(*args, **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    if dtype not in _jax_split_want:
        import jax.numpy as jnp
        _jax_split_want[dtype] = np.asarray(jpa._attn_pallas(
            jnp.asarray(q), jnp.asarray(k_pool), jnp.asarray(v_pool),
            jnp.asarray(SPLIT_TABLE), jnp.asarray(SPLIT_LENGTHS),
            jnp.asarray(k_scales), jnp.asarray(v_scales),
            1.0 / np.sqrt(DIM), quant))
    np.testing.assert_allclose(got, _jax_split_want[dtype], rtol=RTOL,
                               atol=ATOL)
    assert not got[3].any()
    per = -(-SPLIT_WIDTH // splits) * PS
    for b, n in enumerate(SPLIT_LENGTHS):
        for s in range(splits):
            if s * per >= n:
                assert parts[b, s, 0] == np.float32(tpa.NEG_INF)
                assert not parts[b, s, 1:].any()
    empty = torch.zeros((6, 3, DIM + 2))
    empty[:, :, 0] = tpa.NEG_INF
    padded = tpa._combine_splits_ref(torch.cat([parts, empty], 1)).numpy()
    np.testing.assert_array_equal(padded.view(np.int32), got.view(np.int32))


# ------------------------------------------------------ the kernels' route

def _kernel_route(monkeypatch):
    """Meta tensors taken as the card's: the device check passes them, the
    launchers are recorders, the plain versions are gone and building a
    scales tensor of ones fails. Returns the launchers' calls."""
    calls = []

    def gather(pool, table, lengths, scales, out_len):
        calls.append(dict(table=table, lengths=lengths, scales=scales))
        return torch.empty((table.shape[0], out_len, pool.shape[2]),
                           device="meta")

    def attention(q, k_pool, v_pool, table, lengths, k_scales, v_scales,
                  softmax_scale):
        calls.append(dict(q=q, table=table, lengths=lengths,
                          k_scales=k_scales, v_scales=v_scales))
        return torch.empty(q.shape, device="meta")

    def no_ones(*args):
        raise AssertionError("a scales tensor was built")

    monkeypatch.setattr(tpa, "_on_kernel_device", lambda dev, what: None)
    monkeypatch.setattr(tpa, "_gather_cuda", gather)
    monkeypatch.setattr(tpa, "_attention_cuda", attention)
    monkeypatch.setattr(tpa, "_scales_or_ones", no_ones)
    monkeypatch.setattr(tpa, "paged_gather_ref", None)
    monkeypatch.setattr(tpa, "paged_attention_ref", None)
    return calls


@pytest.mark.parametrize("given", [False, True])
def test_kernel_route_float32_builds_no_scales(monkeypatch, given):
    """A float32 pool hands the launchers no scales (the kernels read a
    null pointer as scale 1), given or not, and builds none; int32,
    contiguous tensors on the pool's device pass through as they are."""
    calls = _kernel_route(monkeypatch)
    pool = torch.empty((N_PAGES, PS, DIM), device="meta")
    table = torch.empty((3, 2), dtype=torch.int32, device="meta")
    lengths = torch.empty((3,), dtype=torch.int32, device="meta")
    q = torch.empty((3, DIM), device="meta")
    scales = torch.empty((N_PAGES,), device="meta") if given else None
    tpa.paged_gather(pool, table, lengths, scales)
    tpa.paged_attention(q, pool, pool, table, lengths, k_scales=scales,
                        v_scales=scales)
    gather, attention = calls
    assert gather["scales"] is None
    assert attention["k_scales"] is None and attention["v_scales"] is None
    for call in calls:
        assert call["table"] is table and call["lengths"] is lengths
    assert attention["q"] is q


def test_kernel_route_int8_passes_scales_and_converts_indices(monkeypatch):
    """An int8 pool hands its scales on as float32 (None stays None: the
    kernels read scale 1); indices of another dtype or layout become
    int32 and contiguous once."""
    calls = _kernel_route(monkeypatch)
    pool = torch.empty((N_PAGES, PS, DIM), dtype=torch.int8, device="meta")
    table = torch.empty((2, 3), dtype=torch.int64, device="meta").t()
    lengths = torch.empty((3,), dtype=torch.int64, device="meta")
    scales = torch.empty((N_PAGES,), dtype=torch.float32, device="meta")
    tpa.paged_gather(pool, table, lengths, scales)
    tpa.paged_gather(pool, table, lengths)
    tpa.paged_attention(torch.empty((3, DIM), device="meta"), pool, pool,
                        table, lengths, k_scales=scales)
    with_scales, without, attention = calls
    assert with_scales["scales"] is scales and without["scales"] is None
    assert attention["k_scales"] is scales and attention["v_scales"] is None
    for call in calls:
        assert call["table"].dtype == torch.int32
        assert call["table"].is_contiguous()
        assert call["lengths"].dtype == torch.int32


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_float64_reference_is_float32_reference_nearly_exactly(jpa, dtype):
    """``paged_attention_ref(..., dtype=torch.float64)``, what the kernel
    is held to on the card, computes the same function as the float32
    reference (JAX's, the CPU route): JAX's ``paged_attention_ref`` and
    the port's float32 one sit within the limit of it, empty rows are
    exact zeros, and the float32 reference is unchanged by the option."""
    import jax.numpy as jnp
    q, k_pool, v_pool, k_scales, v_scales = _split_case(dtype)
    quant = dtype == "int8"
    kw = dict(k_scales=torch.from_numpy(k_scales) if quant else None,
              v_scales=torch.from_numpy(v_scales) if quant else None)
    args = (torch.from_numpy(q), torch.from_numpy(k_pool),
            torch.from_numpy(v_pool), SPLIT_TABLE, SPLIT_LENGTHS)
    exact = tpa.paged_attention_ref(*args, dtype=torch.float64, **kw)
    assert exact.dtype == torch.float32 and exact.shape == (6, DIM)
    f32 = tpa.paged_attention_ref(*args, **kw)
    assert _same_bits(f32, tpa.paged_attention_ref(*args, dtype=torch.float32,
                                                   **kw))
    jax_ref = np.asarray(jpa.paged_attention_ref(
        jnp.asarray(q), jnp.asarray(k_pool), jnp.asarray(v_pool),
        jnp.asarray(SPLIT_TABLE), jnp.asarray(SPLIT_LENGTHS),
        k_scales=jnp.asarray(k_scales) if quant else None,
        v_scales=jnp.asarray(v_scales) if quant else None))
    np.testing.assert_allclose(f32.numpy(), jax_ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(jax_ref, exact.numpy(), rtol=RTOL, atol=ATOL)
    assert not exact[3].any()


# -------------------------------------------------------------- on the card

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _same_bits(a, b):
    return a.shape == b.shape and torch.equal(
        a.view(torch.int32), b.view(torch.int32))


# (n_pages, page_size, dim, batch, width): the decode slice's pool, a
# width that takes scalar loads (dim 6), a wide pool; batch 1 at 2048
# positions, d 64 and d 1024
CUDA_SHAPES = [(136, 8, 8, 8, 5), (9, 4, 6, 3, 3), (600, 16, 128, 32, 16),
               (160, 16, 128, 1, 128), (48, 8, 64, 4, 12), (40, 4, 1024, 3, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("shape", CUDA_SHAPES)
def test_cuda_gather_matches_plain_bitwise(shape, dtype):
    dev = _cuda()
    n_pages, ps, dim, batch, width = shape
    pool, scales = _pool(dtype, seed=11, n_pages=n_pages, ps=ps, dim=dim)
    rng = np.random.default_rng(12)
    table = rng.integers(-2, n_pages + 2, (batch, width)).astype(np.int32)
    cap = width * ps
    lengths = rng.integers(0, cap + 1, batch).astype(np.int32)
    lengths[:3] = [0, ps, cap][:batch]
    pool_t = torch.from_numpy(pool).to(dev)
    for out_len in (None, cap - 1):
        before = tpa.gather_launches.value
        got = tpa.paged_gather(pool_t, table, lengths, scales, out_len)
        want = tpa.paged_gather_ref(pool_t, table, lengths, scales, out_len)
        torch.cuda.synchronize()
        assert tpa.gather_launches.value == before + 1
        assert _same_bits(got, want)
    # a pool that starts 4 bytes into its storage takes the scalar path
    shifted = torch.empty(pool_t.numel() + 1, dtype=pool_t.dtype,
                          device=dev)[1:].view(pool_t.shape)
    shifted.copy_(pool_t)
    assert _same_bits(tpa.paged_gather(shifted, table, lengths, scales),
                      tpa.paged_gather_ref(pool_t, table, lengths, scales))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("shape", CUDA_SHAPES)
def test_cuda_attention_matches_plain(shape, dtype):
    dev = _cuda()
    n_pages, ps, dim, batch, width = shape
    k_pool, k_scales = _pool(dtype, seed=13, n_pages=n_pages, ps=ps,
                             dim=dim)
    v_pool, v_scales = _pool(dtype, seed=14, n_pages=n_pages, ps=ps,
                             dim=dim)
    rng = np.random.default_rng(15)
    table = rng.integers(0, n_pages, (batch, width)).astype(np.int32)
    lengths = rng.integers(0, width * ps + 1, batch).astype(np.int32)
    lengths[0] = 0
    q = torch.from_numpy(rng.standard_normal((batch, dim)).astype(
        np.float32)).to(dev)
    k_t, v_t = (torch.from_numpy(p).to(dev) for p in (k_pool, v_pool))
    kw = dict(k_scales=k_scales, v_scales=v_scales)
    before = tpa.attention_launches.value
    got = tpa.paged_attention(q, k_t, v_t, table, lengths, **kw)
    want = tpa.paged_attention_ref(q, k_t, v_t, table, lengths,
                                   dtype=torch.float64, **kw)
    torch.cuda.synchronize()
    assert tpa.attention_launches.value == before + 1
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    assert not got[0].any()
    # poisoning the pages no live position reads changes no bit
    live = {int(table[b, p]) for b in range(batch)
            for p in range(-(-int(lengths[b]) // ps))}
    dead = [p for p in range(n_pages) if p not in live]
    if dead and dtype == "float32":
        k_t[dead], v_t[dead] = float("nan"), float("inf")
        again = tpa.paged_attention(q, k_t, v_t, table, lengths, **kw)
        assert _same_bits(again, got)


@pytest.mark.cuda
def test_cuda_other_pool_dtypes_raise():
    dev = _cuda()
    pool = torch.zeros((4, 2, 8), dtype=torch.bfloat16, device=dev)
    with pytest.raises(TypeError, match="KV_DTYPES limit"):
        tpa.paged_gather(pool, np.zeros((1, 1), np.int32),
                         np.ones(1, np.int32))


def _cuda_attention_case(dev, shape, dtype):
    """A case on the card: the first row full, a row of length 0 where
    there are two, the rest drawn; scales for int8, none for float32."""
    n_pages, ps, dim, batch, width = shape
    k_pool, k_scales = _pool(dtype, seed=16, n_pages=n_pages, ps=ps,
                             dim=dim)
    v_pool, v_scales = _pool(dtype, seed=17, n_pages=n_pages, ps=ps,
                             dim=dim)
    rng = np.random.default_rng(18)
    table = rng.integers(0, n_pages, (batch, width)).astype(np.int32)
    lengths = rng.integers(0, width * ps + 1, batch).astype(np.int32)
    lengths[0] = width * ps
    if batch > 1:
        lengths[1] = 0
    q = rng.standard_normal((batch, dim)).astype(np.float32)
    quant = dtype == "int8"
    t = lambda x: torch.from_numpy(x).to(dev)          # noqa: E731
    return (t(q), t(k_pool), t(v_pool), t(table), t(lengths),
            t(k_scales) if quant else None, t(v_scales) if quant else None)


def _shifted(pool):
    """A contiguous copy of ``pool`` that starts one element into its
    storage: the kernels take their one-element loads."""
    out = torch.empty(pool.numel() + 1, dtype=pool.dtype,
                      device=pool.device)[1:].view(pool.shape)
    out.copy_(pool)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("shape", CUDA_SHAPES)
def test_cuda_attention_splits_same_bits(shape, dtype):
    """With one split and with several (the plan's, or every slot its
    own): within the limit of the plain version in float64, empty rows
    exactly zero,
    the same bits from a second call and with every dead page poisoned
    (NaN / inf, or 127 for int8), and a pool one element into its storage
    (one-element loads) within the limit too."""
    dev = _cuda()
    q, k_t, v_t, table, lengths, ks, vs = _cuda_attention_case(dev, shape,
                                                               dtype)
    n_pages, ps, dim, batch, width = shape
    sc = 1.0 / np.sqrt(dim)
    want = tpa.paged_attention_ref(q, k_t, v_t, table, lengths, k_scales=ks,
                                   v_scales=vs, dtype=torch.float64)
    planned = tpa._attention_plan(batch, width, ps, dim, dtype == "int8",
                                  tpa._sm_count(dev.index or 0))[0]
    pages = [-(-n // ps) for n in lengths.tolist()]
    live = {p for b in range(batch) for p in table[b, :pages[b]].tolist()}
    dead = [p for p in range(n_pages) if p not in live]
    for splits in sorted({1, planned, width}):
        before = (tpa.attention_launches.value,
                  tpa.attention_combine_launches.value)
        got = tpa._attention_cuda(q, k_t, v_t, table, lengths, ks, vs, sc,
                                  splits=splits)
        again = tpa._attention_cuda(q, k_t, v_t, table, lengths, ks, vs, sc,
                                    splits=splits)
        torch.cuda.synchronize()
        assert (tpa.attention_launches.value,
                tpa.attention_combine_launches.value) == (
            before[0] + 2, before[1] + 2 * (splits > 1))
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
        assert _same_bits(again, got)
        assert not got[lengths == 0].any()
        if dead:
            kp, vp = k_t.clone(), v_t.clone()
            if dtype == "int8":
                kp[dead], vp[dead] = 127, -127
            else:
                kp[dead], vp[dead] = float("nan"), float("inf")
            poisoned = tpa._attention_cuda(q, kp, vp, table, lengths, ks, vs,
                                           sc, splits=splits)
            assert _same_bits(poisoned, got)
        shifted = tpa._attention_cuda(q, _shifted(k_t), _shifted(v_t), table,
                                      lengths, ks, vs, sc, splits=splits)
        torch.testing.assert_close(shifted, want, rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_cuda_public_calls_launch_once_or_twice(dtype):
    """Under torch.inference_mode(), on tensors already on the card
    (``chip_smoke.one_launch``: launch counts and the profiler's launch
    calls and device activity): one ``cudaLaunchKernel`` a public gather
    (no scales made, no copy or fill), one a public attention that the
    plan does not split (the decode slice's 40 positions: one block's
    round), two (split and combine) one that it splits (64 slots of 8)."""
    dev = _cuda()
    import chip_smoke
    n_sm = tpa._sm_count(dev.index or 0)
    quant = dtype == "int8"
    q, k_t, v_t, table, lengths, ks, vs = _cuda_attention_case(
        dev, (136, 8, 8, 8, 5), dtype)
    chip_smoke.one_launch(torch, "paged_gather", "paged_gather_kernel",
                          lambda: tpa.paged_gather(k_t, table, lengths, ks))
    assert tpa._attention_plan(8, 5, 8, 8, quant, n_sm)[0] == 1
    chip_smoke.one_launch(
        torch, "paged_attention", "paged_attention_kernel",
        lambda: tpa.paged_attention(q, k_t, v_t, table, lengths,
                                    k_scales=ks, v_scales=vs))
    q, k_t, v_t, table, lengths, ks, vs = _cuda_attention_case(
        dev, (512, 8, 8, 8, 64), dtype)
    assert tpa._attention_plan(8, 64, 8, 8, quant, n_sm)[0] > 1
    chip_smoke.one_launch(
        torch, "paged_attention", "paged_attention_kernel",
        lambda: tpa.paged_attention(q, k_t, v_t, table, lengths,
                                    k_scales=ks, v_scales=vs),
        then=("paged_attention_combine", "paged_attention_combine_kernel"))
