"""The port's fused embedding lookup against the JAX package's.

analytics_zoo_tpu_torch/ops/embedding_bag.py on the CPU (its plain
version) must equal, bitwise, both the JAX reference ``_fused_ref`` and
the JAX Pallas kernel run by the CPU interpreter (``ZOO_PALLAS_INTERPRET``
with ``use_kernel=True``), for every combine, fp32 and bf16, mixed concat
widths and ids out of range. "Bitwise" treats every NaN as one value: a
NaN row's payload is not part of the contract. Inputs come from numpy
seeds. The CUDA kernel against the plain version runs on the card only
(marker ``cuda``). JAX is imported by a fixture, so on a machine without
it (the GPU machine) the comparisons with JAX skip and the ``cuda`` tests
run: ``python -m pytest --noconftest -m cuda
tests/test_torch_embedding_bag.py``.
"""

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch.ops import _build
from analytics_zoo_tpu_torch.ops import embedding_bag as teb


@pytest.fixture(autouse=True)
def _one_torch_thread():
    # tiny shapes: one intra-op thread, so parallel test workers do not
    # oversubscribe the host's cores
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _interp(monkeypatch, tmp_path):
    monkeypatch.setenv("ZOO_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("ZOO_AUTOTUNE_CACHE",
                       str(tmp_path / "autotune.json"))


def _tables(widths, seed=0, vocab=13):
    rng = np.random.RandomState(seed)
    return [rng.randn(vocab + i, d).astype(np.float32)
            for i, d in enumerate(widths)]


def _ids(tables, batch=9, seed=1, out_of_range=False):
    """Ids per column; with ``out_of_range`` over [-2V, 2V), so some
    wrap (in [-V, 0)) and some give NaN rows (outside [-V, V))."""
    rng = np.random.RandomState(seed)
    cols = []
    for t in tables:
        v = t.shape[0]
        lo, hi = (-2 * v, 2 * v) if out_of_range else (-v, v)
        cols.append(rng.randint(lo, hi, size=batch))
    return np.stack(cols, 1).astype(np.int32)


@pytest.fixture(scope="module")
def jeb():
    """The JAX package's lookup module."""
    return pytest.importorskip("analytics_zoo_tpu.ops.embedding_bag")


def _jax(tables, dtype):
    import jax.numpy as jnp
    jt = [jnp.asarray(t) for t in tables]
    return [t.astype(jnp.bfloat16) for t in jt] if dtype == "bf16" else jt


def _torch(tables, dtype):
    tt = [torch.from_numpy(t) for t in tables]
    return [t.to(torch.bfloat16) for t in tt] if dtype == "bf16" else tt


def _np(x):
    """Host float32 copy (bf16 widens exactly)."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype("float32"))


def _assert_same_bits(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    nan_g, nan_w = np.isnan(got), np.isnan(want)
    np.testing.assert_array_equal(nan_g, nan_w)
    np.testing.assert_array_equal(got[~nan_g].view(np.uint32),
                                  want[~nan_w].view(np.uint32))


CASES = [("concat", [8, 16, 4]), ("concat", [20, 20]), ("sum", [8, 8, 8]),
         ("mean", [8, 8, 8]), ("mean", [5] * 7), ("mul", [8, 8])]


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("combine,widths", CASES)
def test_plain_matches_jax_reference_bitwise(jeb, combine, widths, dtype):
    import jax.numpy as jnp
    tables = _tables(widths)
    ids = _ids(tables, batch=40, out_of_range=True)
    want = jeb._fused_ref(_jax(tables, dtype), jnp.asarray(ids), combine)
    got = teb.fused_embedding_lookup(_torch(tables, dtype),
                                     torch.from_numpy(ids), combine)
    assert got.dtype == (torch.bfloat16 if dtype == "bf16"
                         else torch.float32)
    _assert_same_bits(got, want)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("combine,widths", CASES)
def test_plain_matches_jax_pallas_kernel_bitwise(jeb, combine, widths,
                                                 dtype):
    import jax.numpy as jnp
    # the interpreted Pallas kernel clamps ids outside [-V, V) (the TPU
    # kernel never sees one): compare over the ids where it is defined,
    # negative wrapping ids included
    tables = _tables(widths, seed=2)
    ids = _ids(tables, batch=24, seed=3)
    want = jeb.fused_embedding_lookup(_jax(tables, dtype), jnp.asarray(ids),
                                      combine, use_kernel=True)
    got = teb.fused_embedding_lookup(_torch(tables, dtype),
                                     torch.from_numpy(ids), combine)
    _assert_same_bits(got, want)


def test_out_of_range_ids_follow_jnp_take(jeb):
    import jax.numpy as jnp
    table = np.arange(12, dtype=np.float32).reshape(6, 2)
    ids = np.array([0, 5, 6, -1, -6, -7, 100], np.int32)
    want = np.asarray(jnp.take(jnp.asarray(table), jnp.asarray(ids), axis=0))
    got = teb.embedding_lookup(torch.from_numpy(table), torch.from_numpy(ids))
    _assert_same_bits(got, want)
    assert np.isnan(want[[2, 5, 6]]).all()            # 6, -7, 100
    np.testing.assert_array_equal(want[3], table[5])  # -1 wraps


def test_float_ids_truncate_like_astype(jeb):
    import jax.numpy as jnp
    tables = _tables([4, 4])
    ids = np.array([[1.7, 2.9], [0.2, 11.99]], np.float32)
    want = jeb._fused_ref(_jax(tables, "fp32"),
                          jnp.asarray(ids).astype(jnp.int32), "sum")
    got = teb.fused_embedding_lookup(_torch(tables, "fp32"),
                                     torch.from_numpy(ids), "sum")
    _assert_same_bits(got, want)


def test_mean_uses_the_prerounded_reciprocal():
    # 1/3 and 1/7 are where "* float32(1/N)" and "/ N" differ
    tables = _tables([6] * 3, seed=5)
    ids = _ids(tables, batch=64, seed=6)
    got = teb.fused_embedding_lookup(_torch(tables, "fp32"),
                                     torch.from_numpy(ids), "mean")
    rows = [torch.from_numpy(t)[torch.from_numpy(ids[:, i]).long()]
            for i, t in enumerate(tables)]
    acc = (rows[0] + rows[1]) + rows[2]
    np.testing.assert_array_equal(
        got.numpy(), (acc * float(np.float32(1.0 / 3))).numpy())


@pytest.mark.parametrize("bad", ["combine", "widths", "ids", "device"])
def test_dispatcher_rejects_bad_calls(bad):
    tables = _torch(_tables([4, 4]), "fp32")
    ids = torch.zeros((3, 2), dtype=torch.int32)
    kw = {"combine": "sum"}
    if bad == "combine":
        kw["combine"] = "max"
    elif bad == "widths":
        tables = _torch(_tables([4, 6]), "fp32")
    elif bad == "ids":
        ids = torch.zeros((3, 3), dtype=torch.int32)
    else:
        kw["device"] = "cuda"
    with pytest.raises(ValueError):
        teb.fused_embedding_lookup(tables, ids, **kw)


def test_non_cpu_tensors_never_take_the_plain_version(monkeypatch):
    # anything that is not on the CPU goes to the kernel or raises
    monkeypatch.setattr(teb, "_fused_ref", None)
    tables = [torch.empty((4, 2), device="meta")] * 2
    with pytest.raises(ValueError, match="no fused lookup"):
        teb.fused_embedding_lookup(tables, torch.zeros((3, 2)), "concat")


def test_plain_version_counts_no_launch():
    before = teb.launches.value
    teb.fused_embedding_lookup(_torch(_tables([4, 4]), "fp32"),
                               torch.zeros((3, 2)), "mul")
    assert teb.launches.value == before


def test_build_names_libraries_by_content(monkeypatch):
    path = _build.lib_path("embedding_bag")
    assert path.parent == _build.BUILD_DIR and path.suffix == ".so"
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-g",))
    assert _build.lib_path("embedding_bag") != path


def test_launch_counters_reset():
    c = _build.launch_counter("test_counter")
    c.add(3)
    assert _build.launch_counts()["test_counter"] == 3
    _build.reset_launch_counts()
    assert c.value == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("combine,widths", CASES)
def test_cuda_kernel_matches_plain_bitwise(combine, widths, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    tables = [t.cuda() for t in _torch(_tables(widths, vocab=500), dtype)]
    ids = torch.from_numpy(_ids(tables, batch=1000,
                                out_of_range=True)).cuda()
    before = teb.launches.value
    got = teb.fused_embedding_lookup(tables, ids, combine)
    want = teb._fused_ref(tables, ids, combine)
    torch.cuda.synchronize()
    assert teb.launches.value == before + 1
    _assert_same_bits(got.cpu(), want.cpu())
