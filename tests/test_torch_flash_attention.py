"""The port's flash attention against the JAX package's.

- ``_flash_fwd_ref`` (the CUDA kernel's plain version) against the JAX
  Pallas forward ``_flash_fwd`` run by the CPU interpreter
  (``ZOO_PALLAS_INTERPRET=1``), b=1, h=2, d=64: outputs within rtol 2e-3 /
  atol 2e-4 (the JAX kernel's own test tolerance), lse within 1e-4; in
  bf16, over the Pallas kernel's 128-key tiles, within 8e-3.
- ``_flash_fwd_ref`` over other key tiles: the same fp32 function within
  1e-6.
- ``blockwise_attention`` against JAX ``blockwise_attention``: fp32 within
  rtol 2e-4 / atol 2e-5 (sums in another order), bf16 within 2e-2 (both
  round the scores to bf16; one bf16 ulp at |x| < 4 is under 2e-2).
- The dispatch rules: CPU tensors take the plain version and count no
  launch; other devices never do. (The backward, which CUDA inputs that
  require grad go through, is tested in
  ``tests/test_torch_flash_attention_bwd.py``.)
- On the card only (marker ``cuda``): the kernel against its plain version,
  fp32 within 1e-5; bf16 within chip_smoke.py's limit, 2 bf16 ulps +
  1e-5 + FLASH_BF16_FLIPS rounding flips of a p (the kernel's fp32 scores
  and exp round in other ways than the plain version's;
  ``dev/flash_bf16_limit.py`` measures the basis) with at most 1% of the
  elements differing at all; the lse within 1e-5. Also at d 128 and
  96, on the packed projection's strided slices, and on rows the wrapper
  copies (d 20, a view one element in); and one BERT training step's
  gradients through the kernels against the einsum chain.

Inputs come from numpy seeds. JAX is imported by a fixture, so on a
machine without it (the GPU machine) the comparisons with JAX skip and the
``cuda`` tests run: ``python -m pytest --noconftest -m cuda
tests/test_torch_flash_attention.py``.
"""

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch.ops import _build
from analytics_zoo_tpu_torch.ops import flash_attention as tfa

RTOL, ATOL, LSE_TOL = 2e-3, 2e-4, 1e-4


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
    monkeypatch.setenv("ZOO_AUTOTUNE_CACHE",
                       str(tmp_path / "autotune.json"))


def _qkv(sq, sk, seed, b=1, h=2, d=64):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, s, h, d).astype(np.float32) for s in (sq, sk, sk)]


def _t(arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


@pytest.fixture(scope="module")
def jfa():
    """The JAX package's flash attention module."""
    return pytest.importorskip("analytics_zoo_tpu.ops.flash_attention")


def _j(arrays, bf16=False):
    import jax.numpy as jnp
    return [jnp.asarray(a, jnp.bfloat16 if bf16 else jnp.float32)
            for a in arrays]


# (sq, sk, causal): square, ragged (the kv_len path), cross-attention
SHAPES = [(256, 256, False), (256, 256, True), (200, 200, True),
          (200, 200, False), (64, 256, True), (64, 256, False)]


@pytest.mark.parametrize("sq,sk,causal", SHAPES)
def test_plain_version_matches_interpreted_pallas_kernel(jfa, sq, sk,
                                                        causal):
    arrays = _qkv(sq, sk, seed=sq + sk + causal)
    want, want_lse = jfa._flash_fwd(*_j(arrays), causal, 128, 128,
                                    return_lse=True)
    got, got_lse = tfa._flash_fwd_ref(*_t(arrays), causal, return_lse=True)
    assert got.shape == (1, sq, 2, 64) and got_lse.shape == (2, sq)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse),
                               rtol=LSE_TOL, atol=LSE_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_plain_version_bf16_matches_interpreted_pallas_kernel(jfa, causal):
    # both keep fp32 scores and round p to bf16 at the running maximum of
    # the same 128-key tiles; the output rounds to bf16 (one ulp at |x| < 1
    # is under 4e-3)
    arrays = _qkv(256, 256, seed=5)
    want = jfa._flash_fwd(*_j(arrays, bf16=True), causal, 128, 128)
    got = tfa._flash_fwd_ref(*_t(arrays, torch.bfloat16), causal,
                             block_k=128)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=8e-3)


@pytest.mark.parametrize("sq,sk,causal", SHAPES)
def test_blockwise_matches_jax_blockwise(jfa, sq, sk, causal):
    arrays = _qkv(sq, sk, seed=7 + sq + causal)
    want, want_lse = jfa.blockwise_attention(*_j(arrays), causal,
                                             return_lse=True)
    got, got_lse = tfa.blockwise_attention(*_t(arrays), causal,
                                           return_lse=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-5)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse),
                               rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_blockwise_bf16_matches_jax_blockwise(jfa, causal):
    arrays = _qkv(200, 200, seed=11)
    want = jfa.blockwise_attention(*_j(arrays, bf16=True), causal,
                                   block_k=64)
    got = tfa.blockwise_attention(*_t(arrays, torch.bfloat16), causal,
                                  block_k=64)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=2e-2)


def test_rows_that_see_no_key_give_zeros():
    # causal with sq > sk: the first sq - sk rows see no key at all
    q, k, v = _t(_qkv(96, 40, seed=3, h=1))
    out, lse = tfa._flash_fwd_ref(q, k, v, causal=True, return_lse=True)
    assert torch.equal(out[:, :56], torch.zeros_like(out[:, :56]))
    assert bool((lse[:, :56] == tfa.NEG_INF).all())
    # the rest is ordinary attention over their visible prefix
    full = tfa._flash_fwd_ref(q[:, 56:], k, v, causal=True)
    torch.testing.assert_close(out[:, 56:], full, rtol=0, atol=0)


@pytest.mark.parametrize("block_k", [16, 128, 256])
def test_plain_version_is_one_function_over_any_key_tile(block_k):
    # fp32: the tiles change only the order of the sums (within 1e-6);
    # causal cross-attention over a ragged sk, so the last tile ends past sk
    q, k, v = _t(_qkv(72, 200, seed=9))
    want, want_lse = tfa._flash_fwd_ref(q, k, v, True, return_lse=True)
    got, lse = tfa._flash_fwd_ref(q, k, v, True, return_lse=True,
                                  block_k=block_k)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=1e-6)


def test_cpu_wrappers_run_the_plain_version_without_launching():
    q, k, v = _t(_qkv(64, 80, seed=4))
    before = tfa.launches.value
    out = tfa.flash_attention(q, k, v, causal=True)
    out2, lse = tfa.flash_attention_with_lse(q, k, v, causal=True)
    want, want_lse = tfa._flash_fwd_ref(q, k, v, True, return_lse=True)
    for got, ref in ((out, want), (out2, want), (lse, want_lse)):
        torch.testing.assert_close(got, ref, rtol=0, atol=0)
    assert tfa.launches.value == before
    assert _build.launch_counts()["flash_attention_fwd"] == \
        tfa.launches.value


def test_non_cpu_tensors_never_take_the_plain_version(monkeypatch):
    monkeypatch.setattr(tfa, "_flash_fwd_ref", None)
    q = torch.empty((1, 4, 2, 8), device="meta")
    with pytest.raises(ValueError, match="no flash attention"):
        tfa.flash_attention(q, q, q)


@pytest.mark.parametrize("bad", ["rank", "heads", "dtype", "no_keys"])
def test_wrapper_rejects_bad_inputs(bad):
    q, k, v = _t(_qkv(8, 8, seed=1))
    if bad == "rank":
        q = q[0]
    elif bad == "heads":
        k = k[:, :, :1]
    elif bad == "dtype":
        v = v.double()
    else:
        k, v = k[:, :0], v[:, :0]
    with pytest.raises((ValueError, TypeError)):
        tfa.flash_attention(q, k, v)


def test_default_use_flash_follows_the_device_and_kernel_limits():
    has_cuda = torch.cuda.is_available()
    assert tfa.default_use_flash(512, 64) == has_cuda
    assert not tfa.default_use_flash(64, 64)
    assert not tfa.default_use_flash(512, tfa.MAX_HEAD_DIM + 1)


def test_build_knows_the_kernel_source():
    path = _build.lib_path("flash_attention")
    assert path.parent == _build.BUILD_DIR
    assert "--fmad=false" not in _build.nvcc_flags("flash_attention")
    assert "--fmad=false" in _build.nvcc_flags("embedding_bag")


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the CUDA kernel)")


def _assert_kernel_close(q, k, v, causal, out, lse):
    """Against the plain version: fp32 within 1e-5; bf16 within
    chip_smoke.py's limit, 2 bf16 ulps + 1e-5 + FLASH_BF16_FLIPS p
    rounding flips (``bf16_flip_scale``) with at most 1% of the elements
    differing; the lse within 1e-5."""
    want, want_lse = tfa._flash_fwd_ref(q, k, v, causal, return_lse=True)
    if out.dtype == torch.float32:
        torch.testing.assert_close(out, want, rtol=0, atol=1e-5)
    else:
        # the same roundings at the same points: a bf16 output differs by
        # a rounding flip of one ulp in few places, or by a flip of one p
        # where the kernel's fp32 score or exp and the plain version's
        # round p to different bf16 neighbours; p left unrounded or a
        # wrong rounding mode moves many
        import chip_smoke as cs
        reading = cs.bf16_reading(out, want, flip=cs.bf16_flip_scale(
            q, k, v, causal, want_lse))
        assert cs.bf16_within(reading), reading
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,sk,causal", SHAPES + [(96, 40, True)])
def test_cuda_kernel_matches_plain(sq, sk, causal, dtype):
    _need_cuda()
    q, k, v = (t.cuda() for t in _t(_qkv(sq, sk, seed=sq, b=2), dtype))
    before = tfa.launches.value
    out, lse = tfa.flash_attention_with_lse(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert tfa.launches.value == before + 1
    _assert_kernel_close(q, k, v, causal, out, lse)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["d128", "d96_causal", "packed_qkv",
                                    "packed_qkv_causal_ragged",
                                    "d20_rows_copied", "offset_by_one"])
def test_cuda_kernel_matches_plain_layouts(layout, dtype):
    # the d <= 128 instantiation (d 96 zero-padded in shared memory), the
    # packed projection's strided slices, and rows that do not start on 16
    # bytes (d 20; a view one element in), which the wrapper copies
    _need_cuda()
    gen = torch.Generator().manual_seed(len(layout))
    b, h, causal = 2, 3, "causal" in layout
    sq = sk = 200 if "ragged" in layout else 256
    d = {"d128": 128, "d96_causal": 96, "d20_rows_copied": 20}.get(
        layout, 64)
    if layout.startswith("packed"):
        qkv = torch.randn(b, sq, 3, h, d, generator=gen).cuda().to(dtype)
        q, k, v = qkv.unbind(2)
    elif layout == "offset_by_one":
        n = b * sq * h * d
        flat = torch.randn(3 * n + 1, generator=gen).cuda().to(dtype)
        q, k, v = (flat[1 + i * n:1 + (i + 1) * n].view(b, sq, h, d)
                   for i in range(3))
        assert q.data_ptr() % 16 != 0
    else:
        q, k, v = (torch.randn(b, sq, h, d, generator=gen).cuda().to(dtype)
                   for _ in range(3))
    out, lse = tfa.flash_attention_with_lse(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert out.shape == (b, sq, h, d) and out.is_contiguous()
    _assert_kernel_close(q, k, v, causal, out, lse)


def _bert_step(module, ids, labels):
    """One training step's loss and gradients by parameter name."""
    from analytics_zoo_tpu_torch.learn import losses
    logits = module(ids, train=True)
    loss = losses.get("sparse_categorical_crossentropy_logits")(
        labels, logits).mean()
    names, params = zip(*module.named_parameters())
    return float(loss.detach()), dict(zip(names, torch.autograd.grad(
        loss, params)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_cuda_training_step_gradients_within_fine_tuning_limits(dtype):
    # a BERT step through the forward kernel's lse and both backward
    # kernels against the einsum chain under autograd, dropout off: the
    # limits of the fine-tuning check on the card (loss within 1e-5 and
    # every gradient within 1e-4 of its largest element in fp32, TF32 off;
    # 1e-2 and 0.25 in bf16), the key biases against the largest gradient
    # (softmax ignores them: their gradient is rounding)
    _need_cuda()
    from analytics_zoo_tpu_torch.text import BertConfig, init_bert_weights
    from analytics_zoo_tpu_torch.text.estimators import _ClassifierModule
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dict(vocab=1000, hidden_size=256, n_block=2, n_head=4,
               intermediate_size=512, max_position_len=128, hidden_drop=0.0,
               attn_drop=0.0, dtype=dtype)
    rng = np.random.RandomState(0)
    ids = torch.from_numpy(rng.randint(0, 1000, (8, 128)).astype(
        np.int32)).cuda()
    labels = torch.from_numpy(rng.randint(0, 2, 8).astype(np.int32)).cuda()
    state = init_bert_weights(_ClassifierModule(BertConfig(**cfg), 2),
                              0).state_dict()
    runs = {}
    for use_flash in (True, False):
        module = _ClassifierModule(BertConfig(use_flash=use_flash, **cfg), 2)
        module.load_state_dict(state)
        before = _build.launch_counts()
        runs[use_flash] = _bert_step(module.cuda(), ids, labels)
        after = _build.launch_counts()
        if use_flash:
            for name in ("flash_attention_fwd", "flash_attention_bwd_dq",
                         "flash_attention_bwd_dkv"):
                assert after[name] == before.get(name, 0) + 2, name
    (lf, gf), (lc, gc) = runs[True], runs[False]
    loss_atol, rtol = (1e-5, 1e-4) if dtype is None else (1e-2, 0.25)
    assert np.isfinite(lf) and abs(lf - lc) <= loss_atol
    scale = max(float(g.float().abs().max()) for g in gc.values())
    for name, g in gc.items():
        top = scale if name.endswith("attention.key.bias") else \
            float(g.float().abs().max())
        err = float((gf[name].float() - g.float()).abs().max())
        assert err <= rtol * max(top, 1e-30), name
