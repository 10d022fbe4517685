"""The port's step-level decode scheduler, its paged KV pool (fp32 and
int8), the InferenceModel decode seams and generate records through
ClusterServing, on the CPU.

The scheduler's invariants hold bitwise within the port, as the JAX
package pins them (tests/test_decode_scheduler.py): interleaved equals
isolated decode across mid-flight admission, pauses, page recycling and
chunked prefill; speculative greedy equals greedy; the paged step equals
the host gather; int8 KV greedy equals fp32. The port's scheduler is also
held bitwise to JAX's on the same numpy step function, and the real
Seq2Seq model's seams to each other and to plain greedy ``generate``.
"""

import json

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch.common import compile_ahead
from analytics_zoo_tpu_torch.inference import InferenceModel, generation
from analytics_zoo_tpu_torch.inference.decode_scheduler import (
    DecodeScheduler, PagedKVAllocator, PagedKVCache, PagePoolExhausted,
    default_pool_pages,
)
from analytics_zoo_tpu_torch.models import Seq2Seq
from analytics_zoo_tpu_torch.ops import autotune
from analytics_zoo_tpu_torch.ops import paged_attention as tpa
from analytics_zoo_tpu_torch.serving import (Broker, ClusterServing,
                                             InputQueue, OutputQueue,
                                             ServingError)
from analytics_zoo_tpu_torch.serving import schema

DIM = 6


@pytest.fixture(autouse=True)
def _one_torch_thread(monkeypatch):
    monkeypatch.delenv("ZOO_KV_DTYPE", raising=False)
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _step_fn(scale=1.0):
    """Deterministic, strictly causal, row-independent decoder (JAX's
    test_decode_scheduler.py's)."""
    w = np.random.default_rng(0).normal(size=(DIM, DIM)).astype(np.float32)

    def fn(enc, dec):
        csum = np.cumsum(np.asarray(dec, np.float32), axis=1)
        return np.tanh(scale * (csum @ w) + np.asarray(
            enc, np.float32)[:, None, :])
    return fn


def _paged_fn(fn):
    """``(enc, pool, scales, table, lengths)`` seam over the port's plain
    paged gather."""
    def paged(enc, pool, scales, table, lengths):
        dec = tpa.paged_gather(torch.from_numpy(np.asarray(pool)), table,
                               lengths, scales=scales)
        return fn(enc, dec.numpy())
    return paged


def _enc(seed):
    return np.random.default_rng(seed).normal(size=DIM).astype(np.float32)


def _start():
    s = np.zeros(DIM, np.float32)
    s[0] = 1.0
    return s


def _reference(fn, enc_row, steps, **kw):
    return generation.decode_loop(
        fn, enc_row[None], _start()[None], steps, ladder=None, **kw)[0]


def _sched(fn, paged="off", **kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("max_seq", 16)
    kw.setdefault("page_size", 4)
    return DecodeScheduler(fn, paged_step_fn=_paged_fn(fn), paged=paged,
                           **kw)


# ------------------------------------------------------------- allocator

def test_allocator_sizing_zeroing_exhaustion_and_growth():
    alloc = PagedKVAllocator.for_grid(4, 17, DIM, page_size=8)
    assert alloc.n_pages == 4 * 3
    assert [alloc.pages_for(n) for n in (0, 1, 8, 9)] == [0, 1, 1, 2]
    assert default_pool_pages(8, 32, spec_k=0, page_size=8) == 8 * 5
    alloc = PagedKVAllocator(4, 2, DIM)
    held = alloc.alloc_pages(3)
    alloc._pool[held[0]].fill(7.0)
    with pytest.raises(PagePoolExhausted):
        alloc.alloc_pages(2)
    alloc.free_pages(held)
    big = alloc.alloc_pages(6)                # bigger than the pool: grows
    assert len(big) == 6 and alloc.n_pages == 6
    assert not alloc._pool[big].any()         # recycled pages zeroed
    assert alloc.page_nbytes == 2 * DIM * 4


def test_cache_append_truncate_gather_close():
    alloc = PagedKVAllocator(8, 2, DIM)
    cache = PagedKVCache(alloc, alloc.alloc_pages(2))
    rows = np.eye(DIM, dtype=np.float32)[:4]
    cache.append_block(rows[:3])
    assert cache.length == 3 and cache.token_id(1) == 1
    cache.append(rows[3])
    cache.append(rows[0])                     # past the reservation
    assert cache.length == 5 and cache.capacity == 6
    dst = np.zeros((8, DIM), np.float32)
    cache.gather_into(dst)
    assert np.array_equal(dst[:3], rows[:3]) and not dst[5:].any()
    np.testing.assert_array_equal(cache.page_table(4)[3:], [0])
    cache.truncate(2)
    dst[:] = 0.0
    cache.gather_into(dst)
    assert cache.length == 2 and not dst[2:].any()
    cache.close()
    cache.close()
    assert alloc.n_free == alloc.n_pages


# ------------------------------------------------- interleaving parity

@pytest.mark.parametrize("paged", ["off", "force"])
@pytest.mark.parametrize("case", ["isolated", "mid_flight", "recycling",
                                  "sample"])
def test_scheduler_matches_isolated_reference_bitwise(case, paged):
    fn = _step_fn()
    if case == "recycling":
        # the pool holds exactly two worst-case sequences (6 pages of 4)
        alloc = PagedKVAllocator.for_grid(2, 12, DIM, page_size=4)
        sched = _sched(fn, paged, max_batch=2, max_seq=11,
                       allocator=alloc, spec_k=0)
        short = sched.admit(_enc(3), _start(), 2, mode="greedy")
        long = sched.admit(_enc(4), _start(), 11, mode="greedy")
        with pytest.raises(PagePoolExhausted):
            sched.admit(_enc(5), _start(), 11, mode="greedy")
        while not short.done:
            sched.step()
        third = sched.admit(_enc(5), _start(), 4, mode="greedy")
        sched.drain()
        seqs = [(short, 3, 2), (long, 4, 11), (third, 5, 4)]
        assert alloc.n_free == alloc.n_pages
        if paged == "force":                  # dirty pages flowed back
            assert alloc.lazy_zero and alloc.zeros_skipped > 0
    elif case == "mid_flight":
        sched = _sched(fn, paged, max_seq=32)
        a = sched.admit(_enc(1), _start(), 10, mode="greedy")
        for _ in range(4):
            sched.step()
        b = sched.admit(_enc(2), _start(), 6, mode="greedy")
        sched.drain()
        seqs = [(a, 1, 10), (b, 2, 6)]
    else:
        kw = dict(mode="sample", temperature=0.7) if case == "sample" \
            else dict(mode="greedy")
        sched = _sched(fn, paged)
        seqs = []
        for i in range(3):
            seed = 100 + i if case == "sample" else None
            seqs.append((sched.admit(_enc(i), _start(), 5 + i, seed=seed,
                                     **kw), i, 5 + i))
        while sched.live:                     # a caller that pauses
            sched.step()
    for s, e, n in seqs:
        kw = dict(mode=s.mode, temperature=0.7,
                  seed=None if s.mode != "sample" else 100 + e)
        np.testing.assert_array_equal(s.result, _reference(fn, _enc(e), n,
                                                           **kw))
    assert (sched.paged_steps > 0) == (paged == "force")
    assert (sched.paged_fallbacks > 0) == (paged == "off")


def test_chunked_prefill_is_invisible():
    fn = _step_fn()
    prefill = np.random.default_rng(8).normal(
        size=(9, DIM)).astype(np.float32)

    def run(extra_load):
        sched = _sched(fn, "force", max_seq=32, prefill_chunk=4)
        if extra_load:
            sched.admit(_enc(6), _start(), 12, mode="greedy")
        seq = sched.admit(_enc(7), prefill, 5, mode="greedy")
        sched.drain()
        return seq.result

    np.testing.assert_array_equal(run(True), run(False))


@pytest.mark.parametrize("draft", ["perfect", "adversarial"])
def test_speculative_greedy_is_bitwise(draft):
    fn = _step_fn()
    dfn = fn if draft == "perfect" else (lambda e, d: -fn(e, d))
    sched = _sched(fn, max_seq=16, draft_fn=dfn, spec_k=3)
    seqs = [sched.admit(_enc(i), _start(), 8, mode="greedy")
            for i in range(2)]
    sampled = sched.admit(_enc(2), _start(), 6, mode="sample",
                          temperature=0.7, seed=42)
    sched.drain()
    for i, s in enumerate(seqs):
        np.testing.assert_array_equal(
            s.result, _reference(fn, _enc(i), 8, mode="greedy"))
    np.testing.assert_array_equal(
        sampled.result, _reference(fn, _enc(2), 6, mode="sample",
                                   temperature=0.7, seed=42))
    assert sched.spec_accept_ratio == (1.0 if draft == "perfect" else 0.0)
    assert sched.spec_proposed > 0
    assert sched.allocator.n_free == sched.allocator.n_pages


@pytest.mark.parametrize("config", ["plain", "spec", "paged_int8"])
def test_scheduler_matches_jax_scheduler_bitwise(config, monkeypatch):
    """The port's scheduler and JAX's, on the same numpy step function:
    the same generations and the same counters."""
    jds = pytest.importorskip("analytics_zoo_tpu.inference.decode_scheduler")
    fn = _step_fn()
    kw = dict(max_batch=4, max_seq=16, page_size=4)
    if config == "spec":
        kw.update(draft_fn=lambda e, d: fn(e, d) * (1 - 2 * (
            np.asarray(d).sum() % 2)), spec_k=2)
    if config == "paged_int8":
        monkeypatch.setenv("ZOO_KV_DTYPE", "int8")
        kw.update(paged="force", paged_step_fn=_paged_fn(fn))
    results = []
    for mod in (DecodeScheduler, jds.DecodeScheduler):
        sched = mod(fn, **kw)
        seqs = [sched.admit(_enc(i), _start(), 6 + i, mode=m, seed=i)
                for i, m in enumerate(("greedy", "raw", "sample"))]
        for _ in range(2):
            sched.step()
        seqs.append(sched.admit(_enc(9), _start(), 5, mode="greedy"))
        sched.drain()
        results.append(([s.result for s in seqs], sched.steps_run,
                         sched.spec_accept_ratio))
    (port, port_steps, port_ratio), (jax_, jax_steps, jax_ratio) = results
    for a, b in zip(port, jax_):
        np.testing.assert_array_equal(a, b)
    assert (port_steps, port_ratio) == (jax_steps, jax_ratio)


# --------------------------------------------------------------- int8 KV

def test_int8_kv_greedy_and_sample_are_bitwise_fp32(monkeypatch):
    fn = _step_fn()

    def run(mode, paged):
        sched = _sched(fn, paged)
        s = sched.admit(_enc(1), _start(), 9, mode=mode, temperature=0.8,
                        seed=11)
        sched.drain()
        return s.result.copy(), sched.allocator

    fp32 = {(m, p): run(m, p)[0] for m in ("greedy", "sample")
            for p in ("off", "force")}
    monkeypatch.setenv("ZOO_KV_DTYPE", "int8")
    for (mode, paged), want in fp32.items():
        got, alloc = run(mode, paged)
        assert alloc.quantized
        np.testing.assert_array_equal(got, want)
    # raw feeds real values back: int8 loses precision, within a bound
    raw_q = run("raw", "force")[0]
    monkeypatch.setenv("ZOO_KV_DTYPE", "float32")
    raw = run("raw", "force")[0]
    assert not np.array_equal(raw_q, raw)
    np.testing.assert_allclose(raw_q, raw, atol=0.05)


def test_int8_admits_more_at_fixed_bytes_and_requantizes():
    def admitted(kv_dtype):
        alloc = PagedKVAllocator.for_pool_bytes(8192, page_size=4, dim=DIM,
                                                kv_dtype=kv_dtype)
        sched = DecodeScheduler(_step_fn(), max_batch=64, max_seq=12,
                                page_size=4, allocator=alloc, spec_k=0)
        n = 0
        try:
            while True:
                sched.admit(_enc(n), _start(), 12, mode="greedy")
                n += 1
        except PagePoolExhausted:
            pass
        assert len(sched.abort_all()) == n and alloc.n_free == alloc.n_pages
        return n

    assert admitted("int8") >= 2 * admitted("float32") >= 2
    alloc = PagedKVAllocator(2, 4, DIM, kv_dtype="int8")
    cache = PagedKVCache(alloc, alloc.alloc_pages(1))
    small, big = (np.full(DIM, v, np.float32) for v in (0.01, 1.27))
    cache.append(small)
    cache.append(big)
    assert alloc.requants == 1
    step = 1.27 / 127.0
    assert np.allclose(cache.row(0), small, atol=step / 2 + 1e-7)
    assert np.allclose(cache.row(1), big, atol=step / 2 + 1e-7)


@pytest.mark.parametrize("bad", [
    dict(mode="beam"), dict(max_new_tokens=0),
    dict(start=np.zeros((1, 1, DIM), np.float32))])
def test_admission_validation(bad):
    sched = _sched(_step_fn())
    args = dict(enc=_enc(0), start=_start(), max_new_tokens=4)
    args.update(bad)
    with pytest.raises(ValueError):
        sched.admit(args.pop("enc"), args.pop("start"),
                    args.pop("max_new_tokens"), **args)
    with pytest.raises(ValueError, match="auto|force|off"):
        DecodeScheduler(_step_fn(), paged="sometimes")


# ------------------------------------------------------- the real model

@pytest.fixture(scope="module")
def s2s():
    """A small GRU Seq2Seq on the CPU with a pinned batch rung, its
    inputs and its plain greedy generation."""
    torch.set_num_threads(1)
    m = Seq2Seq(input_dim=4, output_dim=4, hidden_size=8, rnn_type="gru",
                encoder_seq_len=6, decoder_seq_len=4)
    im = InferenceModel(device="cpu").load_zoo(m)
    im.set_ladder(compile_ahead.BucketLadder(4, 4))
    rng = np.random.default_rng(5)
    enc = rng.standard_normal((4, 6, 4)).astype(np.float32)
    start = np.zeros((4, 4), np.float32)
    start[:, 0] = 1.0
    return im, enc, start, im.generate(enc, start, 10)


def test_generate_invariants_on_the_model(s2s):
    """Raw generate over the rungs equals the exact-length loop;
    speculative greedy (self-drafted) and the scheduler's interleaved and
    one-at-a-time streams equal plain greedy; warm_decode runs the grid."""
    im, enc, start, greedy = s2s
    assert im.warm_decode(11, paged_pool=(default_pool_pages(
        4, 10, spec_k=0), 8)) is None
    raw = im.generate(enc, start, 10, mode="raw",
                      ladder=generation.seq_ladder(11))
    exact = generation.decode_loop(im.decode_step_fn(), enc, start, 10,
                                   ladder=None, mode="raw")
    np.testing.assert_array_equal(raw, exact)
    np.testing.assert_array_equal(
        im.generate(enc, start, 10, draft=im, spec_k=4), greedy)
    for interleaved in (True, False):
        sched = DecodeScheduler(
            im.decode_step_fn(), max_batch=4, max_seq=10, spec_k=0,
            batch_ladder=compile_ahead.BucketLadder(4, 4))
        seqs = []
        for i in range(3):
            seqs.append(sched.admit(enc[i], start[i], 10))
            if not interleaved:
                sched.drain()
        sched.drain()
        for i, s in enumerate(seqs):
            np.testing.assert_array_equal(s.result, greedy[i])
    with pytest.raises(ValueError, match="2-input"):
        InferenceModel(device="cpu").load_torch(
            torch.nn.Linear(2, 2), np.zeros((1, 2))).decode_step_fn()


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_paged_seam_is_bitwise_the_host_gather(s2s, kv_dtype, monkeypatch,
                                               tmp_path):
    im, enc, start, greedy = s2s
    monkeypatch.setenv("ZOO_KV_DTYPE", kv_dtype)
    # tune_paged persists its verdict: into a file of this test's own
    monkeypatch.setenv("ZOO_AUTOTUNE_CACHE", str(tmp_path / "at.json"))
    autotune.reset_tuner()

    def run(paged):
        sched = DecodeScheduler(
            im.decode_step_fn(), max_batch=4, max_seq=10, spec_k=0,
            batch_ladder=compile_ahead.BucketLadder(4, 4),
            paged_step_fn=im.paged_decode_step_fn(), paged=paged)
        seqs = [sched.admit(enc[i], start[i], 10) for i in range(3)]
        for _ in range(3):
            sched.step()
        # the scheduler's live pool, tables and lengths feed the attention
        pool, scales, table, lengths = sched.live_state()
        q = np.random.default_rng(6).standard_normal(
            (len(lengths), 4)).astype(np.float32)
        pt = torch.from_numpy(pool)
        att = tpa.paged_attention(q, pt, pt, table, lengths,
                                  k_scales=scales, v_scales=scales)
        assert att.shape == (4, 4) and torch.isfinite(att).all()
        sched.drain()
        return [s.result for s in seqs], sched

    off, _ = run("off")
    forced, sched = run("force")
    for i, (a, b) in enumerate(zip(off, forced)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, greedy[i])
    assert sched.paged_steps == 10 and sched.allocator.kv_dtype == kv_dtype
    rec = sched.tune_paged(batch_rung=4, seq_rung=16, enc_shape=(6, 4),
                           iters=1)
    assert rec["kernel"] == "paged_step" and rec["speedup"] > 0
    assert rec["use_kernel"] == (rec["best_ms"] < rec["reference_ms"])
    autotune.reset_tuner()


# ---------------------------------------------------------------- serving

def test_generate_wire_form_matches_jax():
    jschema = pytest.importorskip("analytics_zoo_tpu.serving.schema")
    for req in ({}, {"max_new_tokens": 5, "mode": "sample",
                     "temperature": 0.5, "seed": 3}, {"n": 2, "m": "raw"}):
        assert schema.validate_generate(req) == \
            jschema.validate_generate(req)
    for bad in ({"n": 0}, {"mode": "beam"}, {"foo": 1}, [1]):
        with pytest.raises(ValueError):
            schema.validate_generate(bad)
    x = {"x": np.ones((2, 3), np.float32), "start": np.zeros(3, np.float32)}
    g = schema.validate_generate({"max_new_tokens": 4})
    uri, inputs, meta = jschema.decode_record_meta(
        schema.encode_record("u", x, trace={"g": g}))
    assert meta == {"g": g} and set(inputs) == set(x)
    payload = jschema.encode_record("v", x, trace={"id": "v", "g": g})
    assert schema.decode_record_meta(payload)[2]["g"] == g
    assert schema.decode_record(payload)[0] == "v"


def test_generate_records_through_cluster_serving(s2s, monkeypatch,
                                                  tmp_path):
    # paged="auto" follows the autotuner: in sync mode each step shape's
    # verdict is built at its first step. The verdict is injected (the
    # paged step wins; no real work is timed), so the engine's paged
    # route runs
    cache = tmp_path / "autotune.json"
    monkeypatch.setenv("ZOO_AUTOTUNE", "sync")
    monkeypatch.setenv("ZOO_AUTOTUNE_CACHE", str(cache))
    autotune.reset_tuner()

    def paged_wins(self, kernel, key, candidates, reference, iters=None):
        return self._finish(kernel, key, 2e-3, {"paged": 1e-3}, {}, 1)

    monkeypatch.setattr(autotune.Autotuner, "tune_thunks", paged_wins)
    im, enc, start, greedy = s2s
    with Broker.launch(backend="python") as broker, \
            ClusterServing(im, broker.port, batch_size=4) as serving:
        iq, oq = InputQueue(port=broker.port), OutputQueue(port=broker.port)
        uris = iq.enqueue_batch(
            ((f"g{i}", {"x": enc[i % 4], "start": start[i % 4]})
             for i in range(9)), generate={"max_new_tokens": 10})
        uris.append(iq.enqueue("one", generate={"max_new_tokens": 10},
                               x=enc[2], start=start[2]))
        iq.enqueue("no_start", generate={"max_new_tokens": 3}, x=enc[0])
        got = oq.query_many(uris, timeout=60)
        with pytest.raises(ServingError, match="'start'"):
            oq.query("no_start", timeout=30)
        assert broker.client().xpending("serving_stream", "serving") == 0
        iq.close()
        oq.close()
    for i in range(9):
        np.testing.assert_array_equal(got[f"g{i}"], greedy[i % 4])
    np.testing.assert_array_equal(got["one"], greedy[2])
    m = serving.metrics()
    assert m["records_out"] == 10 and m["records_failed"] == 1
    assert m["paged_steps"] > 0
    verdicts = json.loads(cache.read_text())
    assert verdicts and all(k.startswith("paged_step|torch-")
                            and v["use_kernel"] for k, v in verdicts.items())
    autotune.reset_tuner()


class _PredictOnly:
    def predict_async(self, x):
        return x

    def predict_fetch(self, pending):
        return pending


class _BrokenDecode(_PredictOnly):
    def decode_step_fn(self):
        def step(enc, dec):
            raise RuntimeError("device fell over")
        return step


@pytest.mark.parametrize("model,error", [
    (_PredictOnly, "decode_step_fn"), (_BrokenDecode, "device fell over")])
def test_generate_errors_reach_the_client(model, error):
    """A model without the decode seam, or a decode step that raises:
    every generate record gets an error result and its ack."""
    with Broker.launch(backend="python") as broker, \
            ClusterServing(model(), broker.port, batch_size=2) as serving:
        iq, oq = InputQueue(port=broker.port), OutputQueue(port=broker.port)
        for uri in ("g1", "g2"):
            iq.enqueue(uri, generate={}, x=np.ones(3, np.float32),
                       start=np.ones(3, np.float32))
        for uri in ("g1", "g2"):
            with pytest.raises(ServingError, match=error):
                oq.query(uri, timeout=30)
        assert broker.client().xpending("serving_stream", "serving") == 0
        iq.close()
        oq.close()
    assert serving.metrics()["records_failed"] == 2
