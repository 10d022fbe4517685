"""The port's paged decode kernels against the JAX package's.

analytics_zoo_tpu_torch/ops/paged_attention.py on the CPU (its plain
versions) against the JAX reference and the JAX Pallas kernels run by the
CPU interpreter (``ZOO_PALLAS_INTERPRET``): the gather bitwise (fp32 and
int8, a page used twice, full / mid-page / empty rows, stale pages, table
entries out of range, ``out_len``), the decode attention within ``rtol
2e-5, atol 2e-6`` (the limit JAX holds its kernel to) with empty rows
exactly zero. Inputs come from numpy seeds. The CUDA kernels against the
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


# -------------------------------------------------------------- on the card

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _same_bits(a, b):
    return a.shape == b.shape and torch.equal(
        a.view(torch.int32), b.view(torch.int32))


# (n_pages, page_size, dim, batch, width): the decode slice's pool, a
# width that takes scalar loads (dim 6), a wide pool
CUDA_SHAPES = [(136, 8, 8, 8, 5), (9, 4, 6, 3, 3), (600, 16, 128, 32, 16)]


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
    want = tpa.paged_attention_ref(q, k_t, v_t, table, lengths, **kw)
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
    with pytest.raises(TypeError, match="ROADMAP A8"):
        tpa.paged_gather(pool, np.zeros((1, 1), np.int32),
                         np.ones(1, np.int32))
