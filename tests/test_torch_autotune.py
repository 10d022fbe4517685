"""The port's autotuner (``ops/autotune.py``) and the dispatch that reads
its verdicts, on the CPU.

Mirrored from JAX's ``tests/test_autotune.py``, every case whose assertion
does not rest on real timing, with the clock injected (no test here times
real work): the verdict and its fields, candidate errors, ``tune_thunks``,
persistence across ``reset_tuner()``, a corrupt file ignored, the queue's
dedupe, drain and contained failure, no-ops under ``off`` or a cached
verdict, and the warm-up workers draining the queue.

Added for the port:
- the keys equal JAX's for the same arguments but for the platform tag
  (``torch-cpu`` where JAX writes ``cpu``);
- one cache file shared with a JAX ``Autotuner``: the port's write keeps
  the JAX entries on disk, and a fresh JAX tuner reads both packages';
- ``use_flash=None`` on the CPU takes the einsum chain whatever the
  verdict (within 1e-6 of JAX's ``dot_product_attention``); on a CUDA
  tensor (a stand-in object: the route is decided from the device and
  shapes before any kernel runs) it follows the verdict, and a miss is
  queued, tuned on the spot under ``sync``, or left alone under ``off``;
- ``use_kernel``: True on a CPU tensor raises, False on a CUDA device
  raises, None on the CPU equals JAX's reference (bitwise for the lookup
  and the bag);
- the ``tune_*`` entry points off the card: the kernel candidate errors,
  the verdict is the reference's, under JAX's key and fields;
- on a stand-in card a candidate that raises is a fault, never a verdict:
  ``tune``/``tune_thunks`` raise and save nothing, and ``use_flash=None``
  and ``paged="auto"`` raise instead of taking the einsum chain or the
  host gather (also for a record of the card with errors on disk);
- ``DecodeScheduler(paged="auto")``: the route follows an injected
  verdict, tokens bitwise ``paged="off"``'s; a miss under ``on`` queues and
  takes the gather.
JAX is imported by fixtures only.
"""

import json
import os
import threading
import types

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch.common import telemetry
from analytics_zoo_tpu_torch.inference import InferenceModel
from analytics_zoo_tpu_torch.inference.decode_scheduler import \
    DecodeScheduler
from analytics_zoo_tpu_torch.ops import _build, autotune
from analytics_zoo_tpu_torch.ops import attention as tatt
from analytics_zoo_tpu_torch.ops import embedding_bag as teb
from analytics_zoo_tpu_torch.ops import flash_attention as tfa
from analytics_zoo_tpu_torch.ops import paged_attention as tpa

RECORD_FIELDS = {"kernel", "best", "best_ms", "reference_ms", "speedup",
                 "use_kernel", "candidates_ms", "errors", "platform",
                 "iters"}


@pytest.fixture
def tuner_env(monkeypatch, tmp_path):
    """A tmp verdict file, tiny iters, the default mode; a fresh tuner
    and queue before and after."""
    path = str(tmp_path / "autotune.json")
    monkeypatch.setenv("ZOO_AUTOTUNE_CACHE", path)
    monkeypatch.setenv("ZOO_AUTOTUNE_ITERS", "2")
    monkeypatch.delenv("ZOO_AUTOTUNE", raising=False)
    autotune.reset_tuner()
    autotune._pending.clear()
    yield path
    autotune.reset_tuner()
    autotune._pending.clear()


@pytest.fixture
def fake_times(monkeypatch):
    """``Autotuner._time_candidate`` replaced: each callable's seconds
    come from ``times[fn]``; a callable marked as failing raises inside
    the timing, as a kernel that cannot build does."""
    times = {}

    def fake(fn, args, iters, chain=None):
        t = times[fn]
        if isinstance(t, Exception):
            raise t
        return t

    monkeypatch.setattr(autotune.Autotuner, "_time_candidate",
                        staticmethod(fake))
    return times


class _Clock:
    """A fake ``perf_counter``: thunks advance it by what they cost, and
    each reading by ``tick`` (so work that costs nothing still takes
    time)."""

    def __init__(self):
        self.t = 0.0
        self.tick = 0.0

    def perf_counter(self):
        self.t += self.tick
        return self.t

    def thunk(self, seconds):
        def run():
            self.t += seconds
            return np.zeros(4)
        return run


@pytest.fixture
def clock(monkeypatch):
    c = _Clock()
    monkeypatch.setattr(autotune, "time",
                        types.SimpleNamespace(perf_counter=c.perf_counter))
    return c


def _light(x):
    return x + 1.0


def _heavy(x):
    return x * 2.0


X = torch.ones((4, 4))


def _metric(name, **labels):
    snap = telemetry.snapshot().get(name, {})
    if not isinstance(snap, dict):
        return snap
    key = ",".join(f"{k}={v}" for k, v in labels.items())
    return snap.get(key, 0)


# ------------------------------------------------------------ measurement

def test_tune_picks_faster_candidate(tuner_env, fake_times):
    fake_times.update({_light: 0.001, _heavy: 0.004})
    runs0 = _metric("zoo_autotune_runs_total", kernel="demo")
    rec = autotune.get_tuner().tune(
        "demo", "demo|fast", {"light": _light}, _heavy, (X,), iters=2)
    assert set(rec) == RECORD_FIELDS
    assert rec["best"] == "light" and rec["use_kernel"] is True
    assert rec["best_ms"] == 1.0 and rec["reference_ms"] == 4.0
    assert rec["speedup"] == 4.0 and rec["candidates_ms"] == {"light": 1.0}
    assert rec["platform"] == "torch-cpu" and rec["iters"] == 2
    assert rec["errors"] == {}
    assert _metric("zoo_autotune_runs_total", kernel="demo") == runs0 + 1
    assert _metric("zoo_autotune_best_ms", kernel="demo") == 1.0
    assert _metric("zoo_autotune_speedup", kernel="demo") == 4.0


def test_tune_falls_back_when_reference_wins(tuner_env, fake_times):
    fake_times.update({_light: 0.001, _heavy: 0.004})
    falls0 = _metric("zoo_autotune_fallbacks_total", kernel="demo")
    rec = autotune.get_tuner().tune(
        "demo", "demo|slow", {"heavy": _heavy}, _light, (X,), iters=2)
    assert rec["best"] == "heavy" and rec["use_kernel"] is False
    assert rec["best_ms"] >= rec["reference_ms"]
    assert _metric("zoo_autotune_fallbacks_total",
                   kernel="demo") == falls0 + 1
    # a tie is not a win: use_kernel only on a strict win
    fake_times[_heavy] = 0.001
    assert autotune.get_tuner().tune(
        "demo", "demo|tie", {"heavy": _heavy}, _light, (X,),
        iters=2)["use_kernel"] is False


def test_tune_records_candidate_errors(tuner_env, fake_times):
    def broken(x):
        raise RuntimeError("no such kernel on this backend")

    fake_times.update({_light: 0.001, _heavy: 0.004,
                       broken: RuntimeError("no such kernel")})
    rec = autotune.get_tuner().tune(
        "demo", "demo|err", {"broken": broken, "light": _light},
        _heavy, (X,), iters=2)
    assert "broken" in rec["errors"] and "no such kernel" in \
        rec["errors"]["broken"]
    assert rec["best"] == "light" and rec["use_kernel"]
    rec2 = autotune.get_tuner().tune(
        "demo", "demo|allerr", {"broken": broken}, _light, (X,), iters=2)
    assert rec2["best"] is None and rec2["use_kernel"] is False
    assert rec2["best_ms"] is None and rec2["speedup"] is None


def test_time_candidate_chains_and_counts_on_the_host(clock):
    """The harness itself, on the host clock: one call outside the clock,
    then ``iters`` calls, each fed the previous output through ``chain``."""
    seen = []

    def fn(x):
        seen.append(float(x))
        clock.t += 0.5
        return x + 1

    per_call = autotune.Autotuner._time_candidate(
        fn, (torch.tensor(0.0),), 3, chain=lambda out, a: (out,))
    assert per_call == 0.5
    assert seen == [0.0, 0.0, 1.0, 2.0]


def test_tune_thunks_times_host_callables(tuner_env, clock):
    rec = autotune.get_tuner().tune_thunks(
        "paged_step", "step|fast", {"paged": clock.thunk(0.001)},
        clock.thunk(0.005), iters=2)
    assert rec["best"] == "paged" and rec["use_kernel"]
    assert rec["best_ms"] == 1.0 and rec["reference_ms"] == 5.0
    assert autotune.get_tuner().lookup("step|fast") == rec
    rec2 = autotune.get_tuner().tune_thunks(
        "paged_step", "step|slow", {"paged": clock.thunk(0.005)},
        clock.thunk(0.001), iters=2)
    assert rec2["use_kernel"] is False

    def boom():
        raise RuntimeError("thunk exploded")

    rec3 = autotune.get_tuner().tune_thunks(
        "paged_step", "step|err", {"paged": boom}, clock.thunk(0.001),
        iters=2)
    assert "paged" in rec3["errors"] and rec3["use_kernel"] is False


# ------------------------------------------------------------ persistence

def test_verdict_persists_across_tuner_instances(tuner_env, fake_times):
    fake_times.update({_light: 0.001, _heavy: 0.004})
    autotune.get_tuner().tune(
        "demo", "demo|persist", {"light": _light}, _heavy, (X,), iters=2)
    with open(tuner_env) as f:
        assert json.load(f)["demo|persist"]["best"] == "light"
    autotune.reset_tuner()
    hits0 = _metric("zoo_autotune_cache_hits_total", kernel="demo")
    rec = autotune.get_tuner().lookup("demo|persist", "demo")
    assert rec is not None and rec["use_kernel"]
    assert _metric("zoo_autotune_cache_hits_total",
                   kernel="demo") == hits0 + 1


def test_corrupt_cache_file_is_ignored(tuner_env):
    with open(tuner_env, "w") as f:
        f.write("{not json")
    assert autotune.get_tuner().lookup("anything") is None
    autotune.get_tuner().record("k", {"kernel": "demo", "use_kernel": False})
    autotune.reset_tuner()
    assert autotune.get_tuner().lookup("k")["kernel"] == "demo"


def test_record_keeps_what_another_process_wrote(tuner_env):
    tuner = autotune.get_tuner()
    assert tuner.lookup("mine") is None          # loaded the empty file
    with open(tuner_env, "w") as f:              # another writer meanwhile
        json.dump({"theirs": {"kernel": "other", "use_kernel": True}}, f)
    tuner.record("mine", {"kernel": "demo", "use_kernel": False})
    with open(tuner_env) as f:
        on_disk = json.load(f)
    assert set(on_disk) == {"theirs", "mine"}
    assert tuner.lookup("theirs")["kernel"] == "other"


# ---------------------------------------------------------- pending queue

def test_pending_queue_dedupes_and_drains(tuner_env):
    ran = []
    autotune.enqueue_tune("q|a", lambda: ran.append("a"))
    autotune.enqueue_tune("q|a", lambda: ran.append("dup"))
    autotune.enqueue_tune("q|b", lambda: ran.append("b"))
    assert autotune.pending_count() == 2
    assert _metric("zoo_autotune_pending") == 2
    assert autotune.tune_pending(limit=1) == 1
    assert autotune.pending_count() == 1
    assert autotune.tune_pending() == 1
    assert autotune.pending_count() == 0 == _metric("zoo_autotune_pending")
    assert sorted(ran) == ["a", "b"]


def test_pending_thunk_failure_is_contained(tuner_env, caplog):
    def boom():
        raise RuntimeError("tuning exploded")

    autotune.enqueue_tune("q|boom", boom)
    with caplog.at_level("ERROR"):
        assert autotune.tune_pending() == 1
    assert autotune.pending_count() == 0
    assert "q|boom" in caplog.text and "tuning exploded" in caplog.text


def test_enqueue_noop_when_off_or_already_cached(tuner_env, monkeypatch):
    autotune.get_tuner().record("q|done", {"use_kernel": False})
    autotune.enqueue_tune("q|done", lambda: None)
    assert autotune.pending_count() == 0
    monkeypatch.setenv("ZOO_AUTOTUNE", "off")
    autotune.enqueue_tune("q|off", lambda: None)
    assert autotune.pending_count() == 0


class _Tiny(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.lin = torch.nn.Linear(3, 2)

    def forward(self, x):
        return self.lin(x)


def test_warm_up_worker_drains_queue(tuner_env):
    """``InferenceModel.warm_up``'s thread runs the queue after its rungs,
    and drains it even when every rung is warm already."""
    from analytics_zoo_tpu_torch.common.compile_ahead import BucketLadder
    drained = threading.Event()
    autotune.enqueue_tune("q|warm", drained.set)
    im = InferenceModel(device="cpu").load_torch(_Tiny(),
                                                 np.zeros((1, 3), np.float32))
    im.set_ladder(BucketLadder(1, 4))
    t = im.warm_up()
    t.join(timeout=60)
    assert not t.is_alive() and drained.is_set()
    assert autotune.pending_count() == 0
    again = threading.Event()
    autotune.enqueue_tune("q|again", again.set)
    assert im.warm_up(block=True) is None
    assert again.is_set() and autotune.pending_count() == 0
    assert im.warm_up(block=True) is None        # nothing left: a no-op


def test_warm_decode_worker_drains_queue(tuner_env):
    """The serving engine's decode warm thread (``warm_decode``) too."""
    from analytics_zoo_tpu_torch.models import Seq2Seq
    m = Seq2Seq(input_dim=2, output_dim=2, hidden_size=4, rnn_type="gru",
                encoder_seq_len=3, decoder_seq_len=2)
    im = InferenceModel(device="cpu").load_zoo(m)
    drained = threading.Event()
    autotune.enqueue_tune("q|decode", drained.set)
    t = im.warm_decode(4, rungs=[1], block=False)
    t.join(timeout=60)
    assert not t.is_alive() and drained.is_set()


def test_warm_worker_stops_when_draining(tuner_env, monkeypatch):
    from analytics_zoo_tpu_torch.common import compile_ahead
    ran = []
    autotune.enqueue_tune("q|late", lambda: ran.append(1))
    monkeypatch.setattr(compile_ahead, "draining", lambda: True)
    assert autotune.drain_after_warmup() == 0
    assert ran == [] and autotune.pending_count() == 1


# ------------------------------------------------------------ the keys

@pytest.fixture(scope="module")
def jax_ops():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from analytics_zoo_tpu.ops import autotune as jat
    from analytics_zoo_tpu.ops import embedding_bag as jeb
    from analytics_zoo_tpu.ops import paged_attention as jpa
    return types.SimpleNamespace(jnp=jnp, at=jat, eb=jeb, pa=jpa)


def _as_port(key):
    return key.replace("|cpu|", "|torch-cpu|", 1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
def test_keys_equal_jax_but_for_the_platform(jax_ops, dtype, causal):
    jdt = getattr(jax_ops.jnp, dtype)
    tdt = getattr(torch, dtype)
    assert autotune.attention_key(32, 512, 512, 12, 64, tdt, causal) == \
        _as_port(jax_ops.at.attention_key(32, 512, 512, 12, 64, jdt, causal))
    shapes = [(6041, 20), (3707, 20)]
    assert teb._shapes_key("fused", shapes, "concat.b8000", tdt) == \
        _as_port(jax_ops.eb._shapes_key("fused", shapes, "concat.b8000",
                                        jdt))
    assert teb._shapes_key("bag", shapes[:1], "mean.b8000l8", tdt) == \
        _as_port(jax_ops.eb._shapes_key("bag", shapes[:1], "mean.b8000l8",
                                        jdt))
    for pdt, jpdt in ((torch.float32, jax_ops.jnp.float32),
                      (torch.int8, jax_ops.jnp.int8)):
        assert tpa.gather_key(8, 5, 8, 16, 40, pdt) == \
            _as_port(jax_ops.pa.gather_key(8, 5, 8, 16, 40, jpdt))
        assert tpa.attn_key(8, 5, 8, 16, 40, pdt) == \
            _as_port(jax_ops.pa.attn_key(8, 5, 8, 16, 40, jpdt))
    for kv in (np.float32, np.int8):
        assert tpa.step_key(8, 40, 8, 16, 40, kv, (8, 16)) == \
            _as_port(jax_ops.pa.step_key(8, 40, 8, 16, 40, kv, (8, 16)))


def test_one_file_shared_with_a_jax_tuner(tuner_env, jax_ops, fake_times):
    """JAX writes first; the port's write keeps JAX's entries; a fresh
    JAX tuner reads both packages' verdicts."""
    jt = jax_ops.at.Autotuner(cache_path=tuner_env)
    jt.record(jax_ops.at.attention_key(1, 64, 64, 2, 64,
                                       jax_ops.jnp.float32, False),
              {"kernel": "flash_attention", "use_kernel": True,
               "best": "64x64", "platform": "cpu"})
    fake_times.update({_light: 0.001, _heavy: 0.004})
    port_key = autotune.attention_key(1, 64, 64, 2, 64, torch.float32,
                                      False)
    autotune.get_tuner().tune("flash_attention", port_key,
                              {"light": _light}, _heavy, (X,), iters=2)
    with open(tuner_env) as f:
        on_disk = json.load(f)
    assert len(on_disk) == 2 and port_key in on_disk
    fresh = jax_ops.at.Autotuner(cache_path=tuner_env)
    assert fresh.lookup(port_key)["platform"] == "torch-cpu"
    jax_key = port_key.replace("|torch-cpu|", "|cpu|")
    assert fresh.lookup(jax_key)["platform"] == "cpu"
    # the port's dispatch asks for its own platform's key, never JAX's
    assert port_key != jax_key


# ------------------------------------------------- attention by verdict

def _qkv(b=1, s=64, h=2, d=16, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, h, d)).astype(np.float32)
            for _ in range(3)]


def test_use_flash_none_on_the_cpu_takes_the_einsum_chain(tuner_env,
                                                          jax_ops):
    from analytics_zoo_tpu.ops import attention as jatt
    q, k, v = _qkv()
    for platform in ("torch-cpu", "torch-cuda-sm90"):
        key = autotune.attention_key(1, 64, 64, 2, 16, torch.float32, False)
        autotune.get_tuner().record(
            key.replace("torch-cpu", platform),
            {"kernel": "flash_attention", "best": "128x64",
             "use_kernel": True})
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = tatt.dot_product_attention(tq, tk, tv, use_flash=None)
    np.testing.assert_array_equal(
        got.numpy(), tatt._reference_attention(tq, tk, tv).numpy())
    want = np.asarray(jatt.dot_product_attention(
        *(jax_ops.jnp.asarray(a) for a in (q, k, v)), use_flash=None))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    assert autotune.pending_count() == 0


class _CudaStandIn:
    """What ``_flash_ok`` reads of q and k: a CUDA device, the shape and
    dtype (no card needed: the route is decided before any launch)."""

    def __init__(self, shape, dtype=torch.float32):
        self.device = torch.device("cuda")
        self.shape = shape
        self.dtype = dtype


@pytest.fixture
def on_card(monkeypatch):
    monkeypatch.setattr(autotune, "kernels_available", lambda: True)
    monkeypatch.setattr(autotune, "_platform", lambda: "torch-cuda-sm90")
    monkeypatch.setattr(autotune, "_capturing", lambda: False)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_use_flash_none_on_cuda_follows_the_verdict(tuner_env, on_card,
                                                    use_kernel):
    q = _CudaStandIn((32, 512, 12, 64))
    key = autotune.attention_key(32, 512, 512, 12, 64, torch.float32, False)
    assert key.startswith("flash_attention|torch-cuda-sm90|")
    autotune.get_tuner().record(key, {"kernel": "flash_attention",
                                      "best": "128x64",
                                      "use_kernel": use_kernel})
    assert tatt._flash_ok(q, q, None) is use_kernel
    assert tatt._flash_ok(q, q, np.ones((1,))) is False     # a mask
    assert autotune.pending_count() == 0


def test_use_flash_none_miss_queues_tunes_or_skips(tuner_env, on_card,
                                                   monkeypatch):
    small = _CudaStandIn((2, 128, 2, 64))
    huge = _CudaStandIn((64, 4096, 16, 64))        # past 2 GiB of scores
    # on: queued, and the heuristic decides this time
    assert tatt._flash_ok(small, small, None) is False
    assert tatt._flash_ok(huge, huge, None) is True
    assert autotune.pending_count() == 2
    # sync: tuned on the spot (tune_attention stands in), the verdict rules
    autotune._pending.clear()
    calls = []
    monkeypatch.setattr(autotune, "tune_attention", lambda *a, **kw: (
        calls.append(a), {"use_kernel": True, "best": "128x64"})[1])
    monkeypatch.setenv("ZOO_AUTOTUNE", "sync")
    assert tatt._flash_ok(small, small, None) is True
    assert calls == [(2, 128, 2, 64, torch.float32)]
    # sync inside a graph capture: no measurement, queued instead
    monkeypatch.setattr(autotune, "_capturing", lambda: True)
    assert tatt._flash_ok(huge, huge, None) is True
    assert len(calls) == 1 and autotune.pending_count() == 1
    # off: no verdict read, nothing queued
    autotune._pending.clear()
    monkeypatch.setenv("ZOO_AUTOTUNE", "off")
    assert tatt._flash_ok(small, small, None) is False
    assert autotune.pending_count() == 0


def test_candidate_that_raises_on_the_card_is_a_fault(tuner_env, on_card,
                                                      fake_times):
    """On the card a candidate that raises is a kernel that did not build
    or launch: ``tune`` and ``tune_thunks`` raise, nothing is saved, and
    the key's next dispatch raises too, until a fresh tuner."""
    def broken(x):
        raise RuntimeError("no kernel image for this card")

    fake_times.update({_light: 0.001, _heavy: 0.004,
                       broken: RuntimeError("no kernel image")})
    runs0 = _metric("zoo_autotune_runs_total", kernel="demo")
    with pytest.raises(autotune.AutotuneFault, match="no kernel image"):
        autotune.get_tuner().tune(
            "demo", "demo|fault", {"broken": broken, "light": _light},
            _heavy, (X,), iters=2)

    def boom():
        raise RuntimeError("step kernel failed")

    with pytest.raises(autotune.AutotuneFault, match="step kernel failed"):
        autotune.get_tuner().tune_thunks(
            "paged_step", "step|fault", {"paged": boom}, lambda: np.ones(2),
            iters=1)
    assert autotune.get_tuner().lookup("demo|fault") is None
    assert _metric("zoo_autotune_runs_total", kernel="demo") == runs0
    assert not os.path.exists(tuner_env)
    for key in ("demo|fault", "step|fault"):
        with pytest.raises(autotune.AutotuneFault):
            autotune.check_fault(key)
    autotune.check_fault("demo|other")
    autotune.reset_tuner()
    autotune.check_fault("demo|fault")


def test_use_flash_none_raises_after_a_kernel_fault(tuner_env, on_card,
                                                    fake_times, monkeypatch):
    """A flash measurement that failed on the card never routes BERT to the
    einsum chain: the dispatch raises, whether the fault was met in this
    process (a queued tune drained by a warm-up worker) or a record of the
    card with errors is on disk."""
    q = _CudaStandIn((2, 128, 2, 64))
    key = autotune.attention_key(2, 128, 128, 2, 64, torch.float32, False)

    def broken(q, k, v):
        raise RuntimeError("flash kernel did not launch")

    fake_times.update({_light: 0.001, broken: RuntimeError("did not launch")})
    monkeypatch.setattr(autotune, "tune_attention", lambda *a, **kw:
                        autotune.get_tuner().tune(
                            "flash_attention", key, {"128x64": broken},
                            _light, (X,), iters=1))
    assert tatt._flash_ok(q, q, None) is False     # a miss: queued
    assert autotune.tune_pending() == 1            # the fault is logged
    with pytest.raises(autotune.AutotuneFault, match="did not launch"):
        tatt._flash_ok(q, q, None)
    monkeypatch.setenv("ZOO_AUTOTUNE", "sync")
    autotune.reset_tuner()
    with pytest.raises(autotune.AutotuneFault):
        tatt._flash_ok(q, q, None)                 # measured on the spot
    autotune.reset_tuner()
    autotune.get_tuner().record(key, {
        "kernel": "flash_attention", "best": None, "use_kernel": False,
        "errors": {"128x64": "RuntimeError('no kernel image')"},
        "platform": "torch-cuda-sm90"})
    with pytest.raises(autotune.AutotuneFault, match="no kernel image"):
        tatt._flash_ok(q, q, None)
    # off the card a candidate's error is JAX's record, and the route
    assert autotune.use_kernel({"errors": {"128x64": "x"}, "use_kernel":
                                False, "platform": "torch-cpu"}) is False


def test_auto_flash_attention_on_the_cpu_is_blockwise(tuner_env):
    q, k, v = (torch.from_numpy(a) for a in _qkv())
    for causal in (False, True):
        np.testing.assert_array_equal(
            autotune.auto_flash_attention(q, k, v, causal=causal).numpy(),
            tfa.blockwise_attention(q, k, v, causal=causal).numpy())
    assert autotune.pending_count() == 0


def test_tune_attention_off_the_card_falls_back(tuner_env, fake_times,
                                                monkeypatch):
    """Off the card the kernel candidate fails (as JAX's Pallas candidates
    fail off the TPU): the verdict is the reference's, with the
    launcher's one tile per head dim as the candidate's name."""
    monkeypatch.setattr(autotune.Autotuner, "_time_candidate",
                        staticmethod(lambda fn, args, iters, chain=None:
                                     (fn(*args), 0.002)[1]))
    rec = autotune.tune_attention(1, 64, 2, 16, dtype=torch.float32)
    assert set(rec) == RECORD_FIELDS
    assert rec["best"] is None and rec["use_kernel"] is False
    assert list(rec["errors"]) == ["128x64"]
    assert "card" in rec["errors"]["128x64"]
    key = autotune.attention_key(1, 64, 64, 2, 16, torch.float32, False)
    assert autotune.get_tuner().lookup(key) == rec
    assert tfa.kernel_tile(64) == (128, 64)
    assert tfa.kernel_tile(128) == (64, 64)


# ------------------------------------------------------------ use_kernel

def _tables(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((v, 4)).astype(np.float32)
            for v in (11, 7)]


def test_use_kernel_true_on_the_cpu_raises():
    tables = [torch.from_numpy(t) for t in _tables()]
    ids = torch.tensor([[1, 2], [3, 4]])
    with pytest.raises(ValueError, match="use_kernel=True"):
        teb.fused_embedding_lookup(tables, ids, "concat", use_kernel=True)
    with pytest.raises(ValueError, match="use_kernel=True"):
        teb.embedding_bag(tables[0], ids, use_kernel=True)
    pool = torch.zeros((4, 2, 3))
    table = torch.zeros((2, 2), dtype=torch.int32)
    lengths = torch.ones(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="use_kernel=True"):
        tpa.paged_gather(pool, table, lengths, use_kernel=True)
    with pytest.raises(ValueError, match="use_kernel=True"):
        tpa.paged_attention(torch.zeros((2, 3)), pool, pool, table, lengths,
                            use_kernel=True)


def test_use_kernel_false_on_a_cuda_tensor_raises():
    for what in ("fused lookup", "embedding bag", "paged gather"):
        with pytest.raises(ValueError, match="C26"):
            _build.check_use_kernel(torch.device("cuda", 0), False, what)
        _build.check_use_kernel(torch.device("cuda", 0), True, what)
        _build.check_use_kernel(torch.device("cuda", 0), None, what)


@pytest.mark.parametrize("combine", ["concat", "sum", "mean", "mul"])
@pytest.mark.parametrize("use_kernel", [None, False])
def test_use_kernel_on_the_cpu_equals_jax_reference(tuner_env, jax_ops,
                                                    monkeypatch, combine,
                                                    use_kernel):
    monkeypatch.setenv("ZOO_AUTOTUNE", "off")
    tables = _tables()
    if combine != "concat":
        tables = [tables[0], tables[0][:7].copy()]
    rng = np.random.default_rng(3)
    ids = np.stack([rng.integers(0, 7, 16), rng.integers(0, 7, 16)], 1)
    got = teb.fused_embedding_lookup([torch.from_numpy(t) for t in tables],
                                     ids, combine, use_kernel=use_kernel)
    want = jax_ops.eb.fused_embedding_lookup(
        tuple(jax_ops.jnp.asarray(t) for t in tables),
        jax_ops.jnp.asarray(ids), combine, use_kernel=False)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    bag_ids = rng.integers(0, 11, (16, 5))
    lengths = rng.integers(0, 6, 16)
    for mode in ("sum", "mean"):
        got = teb.embedding_bag(torch.from_numpy(tables[0]), bag_ids,
                                lengths, mode, use_kernel=use_kernel)
        want = jax_ops.eb.embedding_bag(
            jax_ops.jnp.asarray(tables[0]), jax_ops.jnp.asarray(bag_ids),
            jax_ops.jnp.asarray(lengths), mode, use_kernel=False)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_tune_entry_points_off_the_card(tuner_env, fake_times,
                                        monkeypatch):
    """Each ``tune_*`` runs its reference, records the kernel candidate's
    failure off the card and persists JAX's record under JAX's key."""
    monkeypatch.setattr(autotune.Autotuner, "_time_candidate",
                        staticmethod(lambda fn, args, iters, chain=None:
                                     (fn(*args), 0.003)[1]))
    recs = {
        teb._shapes_key("fused", [(11, 4), (7, 4)], "concat.b16",
                        torch.float32):
            teb.tune_fused_lookup([(11, 4), (7, 4)], 16),
        teb._shapes_key("bag", [(11, 4)], "mean.b16l5", torch.float32):
            teb.tune_bag(11, 4, 16, 5, "mean"),
        tpa.gather_key(4, 3, 2, 8, 10, torch.int8):
            tpa.tune_paged_gather(4, 3, 2, 8, 10, torch.int8),
        tpa.attn_key(4, 3, 2, 8, 10, torch.float32):
            tpa.tune_paged_attention(4, 3, 2, 8, 10),
    }
    autotune.reset_tuner()
    for key, rec in recs.items():
        assert set(rec) == RECORD_FIELDS
        assert rec["use_kernel"] is False and rec["best"] is None
        assert list(rec["errors"]) == ["cuda"]
        assert rec["reference_ms"] == 3.0
        assert autotune.get_tuner().lookup(key) == rec
    pool = torch.zeros((10, 2, 8), dtype=torch.int8)
    assert tpa.gather_decision(pool, torch.zeros((4, 3))) is False


# --------------------------------------------------- paged="auto" by verdict

DIM = 6


def _step_fn():
    w = np.random.default_rng(0).normal(size=(DIM, DIM)).astype(np.float32)

    def fn(enc, dec):
        csum = np.cumsum(np.asarray(dec, np.float32), axis=1)
        return np.tanh(csum @ w + np.asarray(enc, np.float32)[:, None, :])
    return fn


def _paged_fn(fn):
    def paged(enc, pool, scales, table, lengths):
        dec = tpa.paged_gather(torch.from_numpy(np.asarray(pool)), table,
                               lengths, scales=scales)
        return fn(enc, dec.numpy())
    return paged


def _decode(paged, n=3, steps=6):
    fn = _step_fn()
    sched = DecodeScheduler(fn, paged_step_fn=_paged_fn(fn), paged=paged,
                            max_batch=4, max_seq=16, page_size=4)
    start = np.zeros(DIM, np.float32)
    start[0] = 1.0
    seqs = [sched.admit(np.random.default_rng(i).normal(size=DIM).astype(
        np.float32), start, steps) for i in range(n)]
    sched.drain()
    return sched, [s.result for s in seqs]


@pytest.mark.parametrize("use_kernel", [True, False])
def test_paged_auto_route_follows_the_verdict(tuner_env, monkeypatch,
                                              use_kernel):
    monkeypatch.setenv("ZOO_AUTOTUNE", "sync")
    tuned = []

    def fake_tune_thunks(self, kernel, key, candidates, reference,
                         iters=None):
        tuned.append(key)
        rec = {"kernel": kernel, "best": "paged", "use_kernel": use_kernel}
        self.record(key, rec)
        return rec

    monkeypatch.setattr(autotune.Autotuner, "tune_thunks", fake_tune_thunks)
    sched, got = _decode("auto")
    _, want = _decode("off")
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert tuned and all(k.startswith("paged_step|torch-cpu|b")
                         for k in tuned)
    assert len(tuned) == len(set(tuned))          # one measurement a shape
    if use_kernel:
        assert sched.paged_steps > 0 and sched.paged_fallbacks == 0
    else:
        assert sched.paged_steps == 0 and sched.paged_fallbacks > 0


def test_paged_auto_raises_when_the_paged_step_fails_on_the_card(
        tuner_env, on_card, clock, monkeypatch):
    """A paged step that raises while measured on the card is a fault:
    ``paged="auto"`` raises it, in sync mode at once and in on mode at the
    step after a warm-up worker met it, and never quietly keeps taking the
    host gather."""
    clock.tick = 1e-3
    fn = _step_fn()

    def broken(enc, pool, scales, table, lengths):
        raise RuntimeError("paged_gather did not launch")

    def decode():
        sched = DecodeScheduler(fn, paged_step_fn=broken, paged="auto",
                                max_batch=4, max_seq=16, page_size=4)
        start = np.zeros(DIM, np.float32)
        sched.admit(np.ones(DIM, np.float32), start, 6)
        sched.drain()

    monkeypatch.setenv("ZOO_AUTOTUNE", "sync")
    with pytest.raises(autotune.AutotuneFault, match="did not launch"):
        decode()
    assert not os.path.exists(tuner_env)           # no verdict saved
    autotune.reset_tuner()
    monkeypatch.setenv("ZOO_AUTOTUNE", "on")
    decode()                                       # misses take the gather
    assert autotune.tune_pending() > 0             # the faults are logged
    with pytest.raises(autotune.AutotuneFault, match="did not launch"):
        decode()


def test_paged_auto_miss_queues_and_takes_the_gather(tuner_env, clock):
    clock.tick = 1e-3
    sched, got = _decode("auto")
    _, want = _decode("off")
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert sched.paged_steps == 0 and sched.paged_fallbacks > 0
    n = autotune.pending_count()
    assert n > 0
    assert autotune.tune_pending() == n            # real thunks, fake clock
    with open(tuner_env) as f:
        assert len([k for k in json.load(f)
                    if k.startswith("paged_step|")]) == n


def test_tune_paged_persists_under_step_key(tuner_env, clock):
    clock.tick = 1e-3
    fn = _step_fn()
    sched = DecodeScheduler(fn, paged_step_fn=_paged_fn(fn), paged="auto",
                            max_batch=4, max_seq=16, page_size=4)
    start = np.zeros(DIM, np.float32)
    sched.admit(np.ones(DIM, np.float32), start, 4)
    rec = sched.tune_paged(batch_rung=4, seq_rung=8, enc_shape=(DIM,))
    assert set(rec) == RECORD_FIELDS and rec["kernel"] == "paged_step"
    alloc = sched.allocator
    key = tpa.step_key(4, 8, 4, DIM, alloc.n_pages, alloc.kv_dtype, (DIM,))
    autotune.reset_tuner()
    assert autotune.get_tuner().lookup(key) == rec
