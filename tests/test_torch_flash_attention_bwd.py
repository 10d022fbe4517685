"""The port's flash-attention backward against the JAX package's.

- ``_flash_bwd_ref`` (the plain version of the dq and dk/dv kernels)
  against the JAX Pallas backward ``_flash_bwd`` called directly and run
  by the CPU interpreter (``ZOO_PALLAS_INTERPRET=1``), from the same q, k,
  v, dO and the same forward output and lse, with zero and with random
  lse cotangents: fp32 within 5e-6 of the largest gradient (fp32 sums in
  another order; measured up to 6e-7); bf16 within 4e-3 of the largest
  gradient, one bf16 ulp (both round ds and p to bf16 at the same points
  from fp32 scores and dp summed in another order, so a rare rounding
  flip of ds moves a sum by one ulp of a term; measured up to 7e-4).
- The ``torch.autograd.Function`` on the CPU gives exactly
  ``_flash_bwd_ref``'s dq, dk and dv, and within 1e-5 the gradients that
  autograd takes through the plain forward; the lse cotangent of
  ``flash_attention_with_lse`` matches JAX's VJP of its
  ``flash_attention_with_lse`` (interpreted).
- Query rows that see no key (causal, sq > sk) get zero gradients and add
  nothing to dk and dv.
- chip_smoke.py's bf16 limit for the backward kernels (2 bf16 ulps + 1e-3
  of the largest gradient + BWD_BF16_FLIPS rounding flips of one ds or p,
  ``bwd_flip_scale``, with at most 2% of elements differing) passes the
  plain version with one ds or p flipped to its other bf16 neighbour by
  hand, and fails its three faulty controls (ds or p left unrounded).
- On the card only (marker ``cuda``): the kernels against the plain
  version on the same CUDA tensors, fp32 within 1e-5 of the largest
  gradient, bf16 within chip_smoke.py's limit; d 128, d 40 and rows the
  wrapper copies (d 20); two launches give the same bits; and one
  training step of a small BERT classifier through
  ``Estimator.from_torch`` launches both kernels once per block.

Inputs come from numpy seeds, b*h <= 4 and s <= 256 (interpreted Pallas
is slow). JAX is imported by a fixture, so on a machine without it the
``cuda`` tests run: ``python -m pytest --noconftest -m cuda
tests/test_torch_flash_attention_bwd.py``.
"""

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch.ops import _build
from analytics_zoo_tpu_torch.ops import flash_attention as tfa

RTOL, ATOL = 0, 5e-6
BF16_TOL = 4e-3


@pytest.fixture(autouse=True)
def _one_torch_thread():
    # small shapes: one intra-op thread, so parallel test workers do not
    # oversubscribe the host's cores
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _interp(monkeypatch, tmp_path):
    monkeypatch.setenv("ZOO_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("ZOO_AUTOTUNE", "off")
    monkeypatch.setenv("ZOO_AUTOTUNE_CACHE",
                       str(tmp_path / "autotune.json"))


@pytest.fixture(scope="module")
def jfa():
    """The JAX package's flash attention module."""
    return pytest.importorskip("analytics_zoo_tpu.ops.flash_attention")


def _arrays(sq, sk, seed, b=1, h=2, d=64):
    """q, k, v, dO and an lse cotangent from a numpy seed."""
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(b, s, h, d).astype(np.float32)
               for s in (sq, sk, sk))
    g = rng.randn(b, sq, h, d).astype(np.float32)
    glse = rng.randn(b * h, sq).astype(np.float32)
    return q, k, v, g, glse


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _jax_fwd_bwd(jfa, arrays, causal, bf16, with_glse):
    """(o, lse, dq, dk, dv) of the JAX Pallas kernels, as fp32 numpy."""
    import jax.numpy as jnp
    dt = jnp.bfloat16 if bf16 else jnp.float32
    q, k, v, g = (jnp.asarray(a, dt) for a in arrays[:4])
    o, lse = jfa._flash_fwd(q, k, v, causal, 128, 128, return_lse=True)
    grads = jfa._flash_bwd(q, k, v, o, lse, g, causal, 128, 128,
                           g_lse=jnp.asarray(arrays[4]) if with_glse
                           else None)
    return [np.asarray(a.astype(jnp.float32)) for a in (o, lse, *grads)]


def _close(got, want, rtol, atol_of_max):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=rtol,
                               atol=atol_of_max * float(np.abs(want).max()))


# (sq, sk, causal): square, ragged (JAX pads to its 128 tile), causal,
# cross-attention (plain and causal)
SHAPES = [(64, 64, False), (200, 200, False), (200, 200, True),
          (64, 192, False), (64, 192, True)]


@pytest.mark.parametrize("with_glse", [False, True])
@pytest.mark.parametrize("sq,sk,causal", SHAPES)
def test_plain_backward_matches_interpreted_pallas_kernels(
        jfa, sq, sk, causal, with_glse):
    arrays = _arrays(sq, sk, seed=sq + sk + causal + 2 * with_glse)
    o, lse, *want = _jax_fwd_bwd(jfa, arrays, causal, False, with_glse)
    q, k, v, g = (_t(a) for a in arrays[:4])
    got = tfa._flash_bwd_ref(q, k, v, _t(o), _t(lse), g, causal,
                             _t(arrays[4]) if with_glse else None)
    for name, a, b in zip("qkv", got, want):
        assert a.shape == b.shape and a.dtype == torch.float32, name
        _close(a, b, RTOL, ATOL)


@pytest.mark.parametrize("with_glse", [False, True])
@pytest.mark.parametrize("sq,sk,causal", [(64, 64, False), (200, 200, True),
                                          (64, 192, False)])
def test_plain_backward_bf16_matches_interpreted_pallas_kernels(
        jfa, sq, sk, causal, with_glse):
    arrays = _arrays(sq, sk, seed=3 + sq + causal + with_glse)
    o, lse, *want = _jax_fwd_bwd(jfa, arrays, causal, True, with_glse)
    q, k, v, g = (_t(a, torch.bfloat16) for a in arrays[:4])
    got = tfa._flash_bwd_ref(q, k, v, _t(o, torch.bfloat16), _t(lse), g,
                             causal, _t(arrays[4]) if with_glse else None)
    for name, a, b in zip("qkv", got, want):
        assert a.dtype == torch.bfloat16, name
        _close(a, b, 0, BF16_TOL)


def _leaves(arrays, dtype=torch.float32):
    q, k, v = (_t(a, dtype).requires_grad_(True) for a in arrays[:3])
    return q, k, v


@pytest.mark.parametrize("causal", [False, True])
def test_autograd_function_gives_the_plain_backward(causal):
    arrays = _arrays(72, 130, seed=21)
    q, k, v = _leaves(arrays)
    g = _t(arrays[3])
    before = _build.launch_counts()
    out = tfa.flash_attention(q, k, v, causal=causal)
    out.backward(g)
    o, lse = tfa._flash_fwd_ref(q.detach(), k.detach(), v.detach(), causal,
                                return_lse=True)
    assert torch.equal(out.detach(), o)
    want = tfa._flash_bwd_ref(q.detach(), k.detach(), v.detach(), o, lse,
                              g, causal)
    for got, ref in zip((q.grad, k.grad, v.grad), want):
        torch.testing.assert_close(got, ref, rtol=0, atol=0)
    # the CPU runs the plain versions and counts no launch
    assert _build.launch_counts() == before


@pytest.mark.parametrize("causal", [False, True])
def test_backward_agrees_with_autograd_through_the_plain_forward(causal):
    # two derivations of one function: the kernels' formula from the saved
    # lse, and autograd through the online softmax (fp32, sums in another
    # order), with a cotangent on the lse too
    arrays = _arrays(72, 130, seed=22)
    g, glse = _t(arrays[3]), _t(arrays[4])
    q, k, v = _leaves(arrays)
    out, lse = tfa.flash_attention_with_lse(q, k, v, causal=causal)
    torch.autograd.backward([out, lse], [g, glse])
    q2, k2, v2 = _leaves(arrays)
    out2, lse2 = tfa._flash_fwd_ref(q2, k2, v2, causal, return_lse=True)
    torch.autograd.backward([out2, lse2], [g, glse])
    for a, b in ((q.grad, q2.grad), (k.grad, k2.grad), (v.grad, v2.grad)):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_lse_cotangent_matches_jax_vjp(jfa, causal):
    import jax
    import jax.numpy as jnp
    arrays = _arrays(64, 128, seed=31 + causal)
    g, glse = arrays[3], arrays[4]
    _, vjp = jax.vjp(lambda q, k, v: jfa.flash_attention_with_lse(
        q, k, v, causal, 128, 128), *(jnp.asarray(a) for a in arrays[:3]))
    want = vjp((jnp.asarray(g), jnp.asarray(glse)))
    q, k, v = _leaves(arrays)
    out, lse = tfa.flash_attention_with_lse(q, k, v, causal=causal)
    torch.autograd.backward([out, lse], [_t(g), _t(glse)])
    for a, b in zip((q.grad, k.grad, v.grad), want):
        _close(a, np.asarray(b), RTOL, ATOL)


def test_unused_outputs_take_zero_cotangents():
    arrays = _arrays(40, 56, seed=41)
    q, k, v = _leaves(arrays)
    _, lse = tfa.flash_attention_with_lse(q, k, v)
    lse.sum().backward()
    o, lse_ref = tfa._flash_fwd_ref(q.detach(), k.detach(), v.detach(),
                                    return_lse=True)
    want = tfa._flash_bwd_ref(q.detach(), k.detach(), v.detach(), o,
                              lse_ref, torch.zeros_like(o), False,
                              torch.ones_like(lse_ref))
    for got, ref in zip((q.grad, k.grad, v.grad), want):
        torch.testing.assert_close(got, ref, rtol=0, atol=0)


def test_rows_without_keys_get_zero_gradients():
    # causal with sq > sk: the first sq - sk = 56 query rows see no key;
    # their output is a constant zero, so they get dq = 0, and dk, dv are
    # those of the remaining rows alone
    arrays = _arrays(96, 40, seed=3, h=1)
    q, k, v = _leaves(arrays)
    g = _t(arrays[3])
    out = tfa.flash_attention(q, k, v, causal=True)
    out.backward(g)
    assert torch.equal(q.grad[:, :56], torch.zeros_like(q.grad[:, :56]))
    q2, k2, v2 = _leaves((arrays[0][:, 56:], arrays[1], arrays[2]))
    tfa.flash_attention(q2, k2, v2, causal=True).backward(g[:, 56:])
    torch.testing.assert_close(q.grad[:, 56:], q2.grad, rtol=0, atol=1e-6)
    torch.testing.assert_close(k.grad, k2.grad, rtol=0, atol=1e-6)
    torch.testing.assert_close(v.grad, v2.grad, rtol=0, atol=1e-6)
    assert all(bool(torch.isfinite(t).all())
               for t in (q.grad, k.grad, v.grad))


def test_no_grad_calls_take_no_autograd_path():
    arrays = _arrays(16, 16, seed=5)
    q, k, v = _leaves(arrays)
    with torch.no_grad():
        out = tfa.flash_attention(q, k, v)
    assert out.grad_fn is None
    assert tfa.flash_attention(q, k, v).grad_fn is not None


def test_build_knows_the_backward_source():
    assert _build.SOURCES["flash_attention_bwd"] == "flash_attention_bwd.cu"
    assert _build.lib_path("flash_attention_bwd").parent == _build.BUILD_DIR
    assert "--fmad=false" not in _build.nvcc_flags("flash_attention_bwd")
    counts = _build.launch_counts()
    assert "flash_attention_bwd_dq" in counts
    assert "flash_attention_bwd_dkv" in counts


class _FakeBwdLib:
    """Records the calls the launch wrappers make into the kernel library."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            return 0
        return call


def test_launch_wrappers_marshal_the_kernel_arguments(monkeypatch):
    # the wrappers' argument lists, checked here because only the card
    # runs the kernels: which entry point, the pointers, the strides of
    # packed q/k/v views and of a strided dO, and the launch counts
    import contextlib
    import types
    lib = _FakeBwdLib()
    monkeypatch.setattr(tfa, "_bwd_lib", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=7))
    b, s, h, d = 2, 24, 3, 16
    q, k, v = torch.randn(b, s, 3, h, d).unbind(2)
    do = torch.randn(b, h, s, d).transpose(1, 2)
    lse, delta, glse = (torch.randn(b * h, s) for _ in range(3))
    before = _build.launch_counts()
    dq = tfa._flash_bwd_dq_cuda(q, k, v, do, lse, delta, True, glse)
    dk, dv = tfa._flash_bwd_dkv_cuda(q, k, v, do, lse, delta, True, None)
    after = _build.launch_counts()
    assert [c[0] for c in lib.calls] == ["zoo_flash_bwd_dq",
                                         "zoo_flash_bwd_dkv"]
    (_, a_dq), (_, a_dkv) = lib.calls
    ptrs = [t.data_ptr() for t in (q, k, v, do, lse, delta)]
    assert list(a_dq[:8]) == ptrs + [glse.data_ptr(), dq.data_ptr()]
    assert list(a_dkv[:9]) == ptrs + [None, dk.data_ptr(), dv.data_ptr()]
    for args, n_ptr in ((a_dq, 8), (a_dkv, 9)):
        assert len(args) == n_ptr + 21
        tail = args[n_ptr:]
        assert tail[:5] == (b, h, s, s, d)
        assert tail[5:17] == (*q.stride()[:3], *k.stride()[:3],
                              *v.stride()[:3], *do.stride()[:3])
        assert tail[17] == 1 and tail[19] == 0 and tail[20] == 7
        assert tail[18] == pytest.approx(d ** -0.5)
    assert dq.shape == q.shape and dk.shape == dv.shape == k.shape
    for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        assert after[name] == before[name] + 1
    with pytest.raises(ValueError, match="lse"):
        tfa._flash_bwd_dq_cuda(q, k, v, do, lse[:1], delta, True)
    with pytest.raises(ValueError, match="dO"):
        tfa._flash_bwd_dkv_cuda(q, k, v, do.double(), lse, delta, True)


def test_launch_wrappers_copy_rows_that_do_not_start_on_16_bytes(
        monkeypatch):
    # the kernels copy rows in 16-byte pieces: a view one element into its
    # storage (q) and a head dim of 20 bf16 (k, v: 40-byte rows) reach the
    # kernel as copies with rows zero-padded to 16 bytes; aligned q, dO
    # pass as they are
    import contextlib
    import types
    lib = _FakeBwdLib()
    monkeypatch.setattr(tfa, "_bwd_lib", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=7))
    seen = []
    aligned = tfa._rows_aligned
    monkeypatch.setattr(tfa, "_rows_aligned",
                        lambda t: seen.append(aligned(t)) or seen[-1])
    b, s, h = 2, 24, 3
    for dtype, d in ((torch.float32, 16), (torch.bfloat16, 20)):
        seen.clear()
        n = b * s * h * d
        q = torch.randn(n + 1).to(dtype)[1:].view(b, s, h, d)
        assert q.data_ptr() % 16 != 0
        k, v, do = (torch.randn(b, s, h, d).to(dtype) for _ in range(3))
        lse, delta = torch.randn(b * h, s), torch.randn(b * h, s)
        lib.calls.clear()
        tfa._flash_bwd_dq_cuda(q, k, v, do, lse, delta, False)
        (_, args), = lib.calls
        qa, ka, va, doa = seen
        vec = 16 // q.element_size()
        pad = -(-d // vec) * vec
        for got, t in zip((qa, ka, va, doa), (q, k, v, do)):
            assert torch.equal(got[..., :d], t)
            assert got.data_ptr() % 16 == 0
            assert all(st % vec == 0 for st in got.stride()[:3])
            assert not bool(got[..., d:].any())
        assert qa.data_ptr() != q.data_ptr() and qa.shape[3] == pad
        if d % vec == 0:
            # aligned tensors are read where they lie
            assert doa.data_ptr() == do.data_ptr()
        else:
            assert doa.data_ptr() != do.data_ptr()
        assert list(args[:4]) == [t.data_ptr() for t in seen]
        # the kernel is told the true head dim and the copies' strides
        assert args[8 + 4] == d
        assert args[8 + 5:8 + 17] == tuple(
            st for t in seen for st in t.stride()[:3])


# ------------------------------------------------- the bf16 limit (CPU)

def _cs():
    import chip_smoke
    return chip_smoke


def _flipped(x, at):
    """bf16 ``x`` rounded from fp32, with element ``at`` moved to the
    other bf16 neighbour of the fp32 value (a rounding flip)."""
    cs = _cs()
    xb = x.to(torch.bfloat16)
    lo = cs.truncate_to_bf16(x[at].reshape(1))        # toward zero
    hi = (lo.view(torch.int16) + 1).view(torch.bfloat16)
    out = xb.clone()
    out[at] = (hi if bool(xb[at] == lo[0]) else lo)[0]
    return out


@pytest.mark.parametrize("causal", [False, True])
def test_bf16_limit_passes_one_flip_and_fails_the_controls(causal):
    # the plain version with one ds (dq, dk) or one p (dv) moved to its
    # other bf16 neighbour, at the largest ds or p of the score matrix,
    # stays within chip_smoke.py's limit; ds or p left unrounded (its
    # three faulty controls) does not
    cs = _cs()
    b, h, s, d = 2, 3, 128, 64
    rng = np.random.RandomState(7 + causal)
    q, k, v, do = (torch.from_numpy(rng.randn(b, s, h, d).astype(
        np.float32)).to(torch.bfloat16) for _ in range(4))
    o, lse = tfa._flash_fwd_ref(q, k, v, causal, return_lse=True)
    delta = tfa._row_delta(o, do)
    args = (q, k, v, do, lse, delta, causal, None)
    want = (tfa._flash_bwd_dq_ref(*args), *tfa._flash_bwd_dkv_ref(*args))
    flips = cs.bwd_flip_scale(tfa, *args)
    p, ds, qf, kf, dof = tfa._p_ds(q, k, v, lse, do, delta, causal, None)
    at_ds = np.unravel_index(int(ds.abs().argmax()), ds.shape)
    at_p = np.unravel_index(int(p.argmax()), p.shape)
    dsf = _flipped(ds, at_ds).float()
    pf = _flipped(p, at_p).float()
    one_flip = (tfa._bshd(torch.matmul(dsf, kf), torch.bfloat16),
                tfa._bshd(torch.matmul(dsf.transpose(-1, -2), qf),
                          torch.bfloat16),
                tfa._bshd(torch.matmul(pf.transpose(-1, -2), dof),
                          torch.bfloat16))
    for name, got, w, flip in zip(("dq", "dk", "dv"), one_flip, want,
                                  flips):
        assert not torch.equal(got, w), name
        reading = cs.bwd_reading(got, w, torch.bfloat16, flip)
        assert cs.bwd_within(reading), (name, reading)
    for name, reading in cs.bwd_bf16_controls(tfa, args, want,
                                               flips).items():
        assert not cs.bwd_within(reading), (name, reading)


# ------------------------------------------------------------- on the card

def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the CUDA kernels)")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,sk,causal,packed,with_glse,d", [
    (128, 128, False, True, False, 64), (128, 128, False, True, True, 64),
    (256, 256, True, False, False, 64), (200, 200, False, False, True, 64),
    (64, 192, True, False, False, 64), (96, 40, True, False, False, 64),
    (256, 256, False, True, False, 128), (200, 200, True, False, True, 128),
    (200, 200, True, False, True, 40), (128, 128, False, True, False, 20)])
def test_cuda_kernels_match_plain(sq, sk, causal, packed, with_glse, d,
                                  dtype):
    _need_cuda()
    b, h = 2, 3
    gen = torch.Generator().manual_seed(sq + sk + d)
    if packed:
        qkv = torch.randn(b, sq, 3, h, d, generator=gen).cuda().to(dtype)
        q, k, v = qkv.unbind(2)
    else:
        q = torch.randn(b, sq, h, d, generator=gen).cuda().to(dtype)
        k, v = (torch.randn(b, sk, h, d, generator=gen).cuda().to(dtype)
                for _ in range(2))
    do = torch.randn(b, sq, h, d, generator=gen).cuda().to(dtype)
    glse = torch.randn(b * h, sq, generator=gen).cuda() if with_glse \
        else None
    o, lse = tfa.flash_attention_with_lse(q, k, v, causal)
    before = _build.launch_counts()
    got = tfa._flash_bwd_cuda(q, k, v, o, lse, do, causal, glse)
    again = tfa._flash_bwd_cuda(q, k, v, o, lse, do, causal, glse)
    torch.cuda.synchronize()
    after = _build.launch_counts()
    assert after["flash_attention_bwd_dq"] == \
        before["flash_attention_bwd_dq"] + 2
    assert after["flash_attention_bwd_dkv"] == \
        before["flash_attention_bwd_dkv"] + 2
    want = tfa._flash_bwd_ref(q, k, v, o, lse, do, causal, glse)
    flips = (None,) * 3
    if dtype == torch.bfloat16:
        cs = _cs()
        flips = cs.bwd_flip_scale(tfa, q, k, v, do, lse,
                                  tfa._row_delta(o, do), causal, glse)
    for name, a, a2, w, flip in zip("qkv", got, again, want, flips):
        assert torch.equal(a, a2), f"d{name} differs between two launches"
        assert a.shape == w.shape and a.is_contiguous()
        top = float(w.float().abs().max())
        if dtype == torch.float32:
            torch.testing.assert_close(a, w, rtol=0, atol=1e-5 * top)
        else:
            reading = cs.bwd_reading(a, w, dtype, flip)
            assert cs.bwd_within(reading), (name, reading)


@pytest.mark.cuda
def test_cuda_training_step_launches_both_backward_kernels():
    _need_cuda()
    from analytics_zoo_tpu_torch.learn import Estimator
    from analytics_zoo_tpu_torch.text import BertConfig, init_bert_weights
    from analytics_zoo_tpu_torch.text.estimators import _ClassifierModule
    n_block = 2
    module = init_bert_weights(_ClassifierModule(BertConfig(
        vocab=100, hidden_size=64, n_block=n_block, n_head=4,
        intermediate_size=128, max_position_len=64, use_flash=True), 2), 0)
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 100, (8, 64)).astype(np.int32)
    labels = rng.randint(0, 2, 8).astype(np.int32)
    est = Estimator.from_torch(
        model=module, loss="sparse_categorical_crossentropy_logits",
        optimizer="adam")
    _build.reset_launch_counts()
    hist = est.fit((ids, labels), epochs=1, batch_size=8)
    counts = _build.launch_counts()
    assert np.isfinite(hist["loss"]).all()
    for name in ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv"):
        assert counts[name] == n_block, (name, counts)
