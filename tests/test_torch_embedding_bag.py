"""The port's fused embedding lookup against the JAX package's.

analytics_zoo_tpu_torch/ops/embedding_bag.py on the CPU (its plain
version) must equal, bitwise, both the JAX reference ``_fused_ref`` and
the JAX Pallas kernel run by the CPU interpreter (``ZOO_PALLAS_INTERPRET``
with ``use_kernel=True``), for every combine, fp32 and bf16, mixed concat
widths and ids out of range. "Bitwise" treats every NaN as one value: a
NaN row's payload is not part of the contract. Inputs come from numpy
seeds. The host path: without a gradient to keep, the public function
calls the launcher directly (the autograd Function only under a gradient);
the launcher's argument block is cached per set of tables and combine,
within a bound, safely across threads. The CUDA kernel against the plain
version runs on the card only (marker ``cuda``), also at a wide shape and
with rows that do not start on 16 bytes, and one public call under
inference mode is one launch. JAX is imported by a fixture, so on a machine without
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


# ------------------------------------------------- the host path's routes

def _kernel_route(monkeypatch):
    """Meta tensors taken as the card's: the device check passes them, the
    launcher is a recorder and the plain version is gone. Returns (the
    launcher's calls, the autograd Function's applies)."""
    calls, applied = [], []

    def launcher(tables, ids, combine):
        calls.append((combine, ids.dtype))
        return torch.empty((ids.shape[0], tables[0].shape[1]), device="meta")

    monkeypatch.setattr(teb, "_on_kernel_device", lambda dev, what: None)
    monkeypatch.setattr(teb, "_fused_cuda", launcher)
    monkeypatch.setattr(teb, "_fused_ref", None)
    apply = teb._FusedLookup.apply
    monkeypatch.setattr(teb._FusedLookup, "apply",
                        lambda *a: applied.append(a[0]) or apply(*a))
    return calls, applied


@pytest.mark.parametrize("context", ["grad_mode", "no_grad", "inference"])
@pytest.mark.parametrize("requires_grad", [False, True])
def test_kernel_route_skips_autograd_unless_a_gradient_is_wanted(
        monkeypatch, context, requires_grad):
    calls, applied = _kernel_route(monkeypatch)
    tables = [torch.empty((6, 4), device="meta",
                          requires_grad=requires_grad) for _ in range(2)]
    ids = torch.zeros((3, 2), dtype=torch.int32, device="meta")
    ctx = {"grad_mode": torch.enable_grad, "no_grad": torch.no_grad,
           "inference": torch.inference_mode}[context]
    with ctx():
        out = teb.fused_embedding_lookup(tables, ids, "sum")
    wanted = requires_grad and context == "grad_mode"
    assert calls == [("sum", torch.int32)]
    assert applied == (["sum"] if wanted else [])
    assert out.requires_grad == wanted


def test_fused_args_are_built_once_per_set_of_tables(monkeypatch):
    monkeypatch.setattr(teb, "_args_cache", {})
    tables = _torch(_tables([4, 4], vocab=20), "fp32")
    a = teb._fused_args(tables, "concat")
    assert (a.n_tables, a.d_out, a.combine, a.is_bf16) == (2, 8, 0, 0)
    assert list(a.table[:2]) == [t.data_ptr() for t in tables]
    assert list(a.vocab[:2]) == [20, 21] and list(a.dim[:2]) == [4, 4]
    assert list(a.offset[:2]) == [0, 4]
    assert a.inv_n == np.float32(0.5)
    # an equal key (a view of the same storage and shape) gets the block
    assert teb._fused_args([t.view(t.shape) for t in tables], "concat") is a
    changed = {
        "combine": (tables, "sum"),
        "storage": ([tables[0].clone(), tables[1]], "concat"),
        "shape": ([tables[0][:7], tables[1]], "concat"),
        "dtype": ([t.to(torch.bfloat16) for t in tables], "concat")}
    blocks = {k: teb._fused_args(*v) for k, v in changed.items()}
    for name, b in blocks.items():
        assert b is not a and bytes(b) != bytes(a), name
    assert blocks["combine"].d_out == 4 and blocks["combine"].combine == 1
    assert blocks["storage"].table[0] == changed["storage"][0][0].data_ptr()
    assert blocks["shape"].vocab[0] == 7
    assert blocks["dtype"].is_bf16 == 1
    # built again for an equal key, a block has the same bytes
    monkeypatch.setattr(teb, "_args_cache", {})
    assert bytes(teb._fused_args(tables, "concat")) == bytes(a)


def test_fused_args_cache_stays_within_its_bound_under_threads(monkeypatch):
    # more threads than cores, switching often: every block a thread gets
    # matches its own tables, and the cache never outgrows its bound
    import os
    import sys
    import threading
    monkeypatch.setattr(teb, "_args_cache", {})
    base = torch.zeros((4 * teb.ARGS_CACHE_SIZE, 3))
    errors, sizes = [], []

    def worker(lo):
        try:
            for n in range(lo, lo + teb.ARGS_CACHE_SIZE):
                args = teb._fused_args([base[:n + 1]], "concat")
                if args.vocab[0] != n + 1 or args.d_out != 3:
                    errors.append((n, args.vocab[0], args.d_out))
                sizes.append(len(teb._args_cache))
        except Exception as exc:   # noqa: BLE001 (reported below)
            errors.append(exc)

    threads = [threading.Thread(target=worker, args=(i * 7,))
               for i in range(2 * (os.cpu_count() or 4))]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors
    assert max(sizes) <= teb.ARGS_CACHE_SIZE
    assert 0 < len(teb._args_cache) <= teb.ARGS_CACHE_SIZE
    last = teb._fused_args([base[:5]], "sum")
    assert next(reversed(teb._args_cache.values())) is last


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("combine", ["concat", "sum", "mean", "mul"])
@pytest.mark.parametrize("case", ["wide", "misaligned", "mixed_misaligned",
                                  "wide_rows"])
def test_cuda_kernel_wide_and_misaligned_match_plain_bitwise(case, combine,
                                                             dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    if case == "wide":
        # 8 tables of 100 000 x 64 (the chip script's wide case, fewer rows)
        widths, vocab, batch = [64] * 8, 100_000, 4096
    elif case == "wide_rows":
        # more vectors a row than a warp has lanes
        widths, vocab, batch = [260, 260], 500, 1000
    else:
        widths = [20, 20] if case == "misaligned" or combine != "concat" \
            else [8, 16, 4, 20]
        vocab, batch = 500, 1000
    tables = [t.cuda() for t in _torch(_tables(widths, vocab=vocab), dtype)]
    if case.endswith("misaligned"):
        # a view whose rows start one element past 16 bytes
        flat = torch.empty(tables[0].numel() + 1, dtype=tables[0].dtype,
                           device="cuda")
        tables[0] = flat[1:].view(tables[0].shape).copy_(tables[0])
    ids = torch.from_numpy(_ids(tables, batch=batch,
                                out_of_range=True)).cuda()
    got = teb.fused_embedding_lookup(tables, ids, combine)
    want = teb._fused_ref(tables, ids, combine)
    torch.cuda.synchronize()
    _assert_same_bits(got.cpu(), want.cpu())


@pytest.mark.cuda
def test_cuda_public_call_under_inference_mode_is_one_launch():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    import chip_smoke   # its check: launch counts and the profiler's trace
    tables = [t.cuda() for t in _torch(_tables([20, 20], vocab=500), "fp32")]
    ids = torch.from_numpy(_ids(tables, batch=1000)).cuda()
    rec = chip_smoke.one_launch(
        torch, "fused_embedding_lookup", "fused_concat_kernel",
        lambda: teb.fused_embedding_lookup(tables, ids))
    assert rec["counts"] == {"fused_embedding_lookup": 1}
