"""Warm-up and adaptive buckets on the CPU: ``InferenceModel.warm_up`` /
``wait_warm`` / ``rung_ready`` (one forward a rung on a background
thread, readiness only after it finished), a warm-up running beside
predicts leaving their results bitwise those of a quiet run, padded
predicts bitwise the unpadded ones, the engine growing its bucket only
onto ready rungs and shrinking it after sustained idle, the pad-fraction
histogram, and a process that exits while a warm-up is under way (the
counterparts of the JAX package's test_compile_ahead.py warm-up tests).
Small models: a 2-block BERT at hidden 32, NCF at narrow widths."""

import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch.common import compile_ahead, telemetry
from analytics_zoo_tpu_torch.inference import InferenceModel
from analytics_zoo_tpu_torch.models import NeuralCF
from analytics_zoo_tpu_torch.serving import (Broker, ClusterServing,
                                             InputQueue, OutputQueue)
from analytics_zoo_tpu_torch.text import BertConfig
from analytics_zoo_tpu_torch.text import estimators as test_

SMALL = dict(vocab=100, hidden_size=32, n_block=2, n_head=4,
             intermediate_size=64, max_position_len=32)
LENGTH = 16
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _records(n, seed):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 100, (n, LENGTH)).astype(np.int32),
            rng.randint(0, 2, (n, LENGTH)).astype(np.int32))


def _bert():
    torch.manual_seed(0)
    module = test_._ClassifierModule(BertConfig(**SMALL), 2)
    return InferenceModel(device="cpu").load_torch(module, _records(1, 0))


def _ncf():
    torch.manual_seed(0)
    ncf = NeuralCF(user_count=20, item_count=10, class_num=3, user_embed=4,
                   item_embed=4, hidden_layers=(8, 4), include_mf=True,
                   mf_embed=4)
    return InferenceModel(device="cpu").load_zoo(ncf)


def test_rung_ready_only_after_warm_up_ran():
    im = _bert()
    assert im.has_warm_spec()
    assert not any(im.rung_ready(r) for r in (2, 4, 8))
    assert im.warm_up() is None               # no ladder, no rungs
    im.set_ladder(2, 8)
    t = im.warm_up()
    assert isinstance(t, threading.Thread)
    assert im.wait_warm(timeout=60) is im and not t.is_alive()
    assert all(im.rung_ready(r) for r in (2, 4, 8))
    assert im.warm_up() is None               # nothing left to warm
    # a new model is cold again
    im.load_torch(test_._ClassifierModule(BertConfig(**SMALL), 2),
                  _records(1, 0))
    assert not im.rung_ready(2)
    # a zoo model learns its spec from its first predict
    ncf = _ncf()
    assert not ncf.has_warm_spec() and ncf.warm_up(rungs=(4,)) is None
    ncf.predict(np.ones((3, 2), np.float32))
    assert ncf.has_warm_spec()
    ncf.warm_up(rungs=(4,), block=True)
    assert ncf.rung_ready(4)


def test_warm_up_beside_predicts_leaves_them_bitwise():
    im = _bert()
    x = _records(6, seed=2)
    quiet = [im.predict(x, batch_size=4) for _ in range(3)]
    im.set_ladder(1, 16)
    busy = []
    t = im.warm_up()
    while t.is_alive() or len(busy) < 3:
        busy.append(im.predict(x, batch_size=4))
    im.wait_warm(timeout=60)
    for got in busy:
        np.testing.assert_array_equal(got, quiet[0])


def test_predict_padded_tail_bitwise():
    """A tail padded to its rung gives, row for row, the bits of the
    same rows in a full batch of that rung."""
    im = _bert()
    x = _records(10, seed=3)
    base = im.predict(x, batch_size=4)        # chunks 4, 4, 2 -> pad 4
    tail = im.predict((x[0][:3], x[1][:3]), batch_size=4)   # 3 -> pad 4
    np.testing.assert_array_equal(tail, base[:3])
    im.set_ladder(2, 8)
    im.warm_up(block=True)
    laddered = im.predict(x, batch_size=4)    # the tail of 2 rides rung 2
    np.testing.assert_array_equal(laddered[:8], base[:8])
    np.testing.assert_allclose(laddered, base, atol=1e-6)


def test_pad_to_rung_observes_fraction():
    telemetry.reset_for_tests()
    a = np.arange(6).reshape(3, 2)
    (out,) = compile_ahead.pad_to_rung([a], 4, site="t")
    np.testing.assert_array_equal(out[3], a[2])
    compile_ahead.pad_to_rung([a], 3, site="t")
    h = telemetry.snapshot()["zoo_bucket_pad_fraction"]["site=t"]
    assert h["count"] == 2 and h["sum"] == pytest.approx(0.25)
    with pytest.raises(ValueError):
        compile_ahead.pad_to_rung([a], 2)
    lad = compile_ahead.BucketLadder(2, 12)
    assert lad.rungs == (2, 4, 8, 12) and lad.up(8) == 12
    assert lad.down(2) == 2 and lad.down(12) == 8 and lad.up(12) == 12


class _Gated:
    """A model whose rungs are ready only when the test says so; it
    records the warm-up kicks."""

    def __init__(self):
        self.ready = set()
        self.kicked = []

    def predict(self, x):
        return np.asarray(x)

    def set_ladder(self, ladder):
        self.ladder = ladder

    def has_warm_spec(self):
        return True

    def warm_up(self, rungs=None):
        self.kicked.append(tuple(rungs))

    def rung_ready(self, r):
        return r in self.ready


def test_bucket_grows_only_onto_ready_rungs_and_shrinks_when_idle():
    model = _Gated()
    eng = ClusterServing(model, 0, batch_size=2, max_batch_size=8,
                         stream="t_grow")
    assert eng.ladder.rungs == (2, 4, 8)
    for _ in range(eng.BACKLOG_GROW_AFTER):
        eng._grow_batch_on_backlog(2)
    assert eng.batch_size == 2 and model.kicked == [(4,)]   # cold: held
    model.ready.add(4)
    eng._grow_batch_on_backlog(2)
    assert eng.batch_size == 4                               # now it grows
    assert telemetry.snapshot()["zoo_serving_batch_bucket"][
        "stream=t_grow"] == 4
    for _ in range(eng.IDLE_SHRINK_AFTER):
        eng._grow_batch_on_backlog(0)
    assert eng.batch_size == 2                               # one rung down
    assert eng.metrics()["batch_size"]["count"] == 2
    # without warm-up every rung reads ready
    eng = ClusterServing(_Gated(), 0, batch_size=2, max_batch_size=8,
                         warmup=False)
    for _ in range(eng.BACKLOG_GROW_AFTER):
        eng._grow_batch_on_backlog(2)
    assert eng.batch_size == 4


def test_serving_warms_the_ladder_and_grows_on_backlog(monkeypatch):
    """``ClusterServing(warmup=True)`` warms every rung at start() off
    the serve thread; a backlog then grows the bucket onto ready rungs
    only, and every result matches the predict."""
    im = _bert()
    x = _records(48, seed=6)
    want = {r: im.predict(x, batch_size=r) for r in (2, 4, 8)}
    grown = []
    orig = ClusterServing._set_bucket

    def spy(self, rung, why):
        grown.append((int(rung), im.rung_ready(rung)))
        orig(self, rung, why)

    monkeypatch.setattr(ClusterServing, "_set_bucket", spy)
    with Broker.launch(backend="native") as b, \
            ClusterServing(im, b.port, batch_size=2, max_batch_size=8,
                           pipeline_window=1) as eng:
        assert eng.wait_warm(timeout=60) is eng
        assert all(im.rung_ready(r) for r in eng.ladder.rungs)
        iq, oq = InputQueue(port=b.port), OutputQueue(port=b.port)
        uris = iq.enqueue_batch(
            (f"w{i}", {"input_ids": x[0][i], "token_type_ids": x[1][i]})
            for i in range(48))
        got = oq.query_many(uris, timeout=60)
        iq.close()
        oq.close()
    assert grown and all(ready for _, ready in grown), grown
    assert max(r for r, _ in grown) > 2
    # each result is the predict at the rung its batch rode (the CPU's
    # GEMMs may round a row otherwise at another place in the batch)
    for i, uri in enumerate(uris):
        assert any(np.allclose(got[uri], want[r][i], rtol=0, atol=1e-6)
                   for r in want), uri


def test_process_exits_cleanly_during_warm_up():
    """A short-lived process exits cleanly while a warm-up thread is mid
    ladder: the atexit drain stops the remaining rungs and joins the one
    in flight."""
    src = (
        "import sys, time, numpy as np, torch\n"
        "from analytics_zoo_tpu_torch.inference import InferenceModel\n"
        "class Slow(torch.nn.Module):\n"
        "    def forward(self, x):\n"
        "        time.sleep(0.2)\n"
        "        return x * 2\n"
        "im = InferenceModel(device='cpu').load_torch(\n"
        "    Slow(), np.zeros((1, 4), np.float32))\n"
        "im.set_ladder(1, 1024)\n"
        "t = im.warm_up()\n"
        "time.sleep(0.05)\n"
        "print('exiting', t.is_alive(), flush=True)\n")
    proc = subprocess.run([sys.executable, "-c", src], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == "exiting True"
    assert "Traceback" not in proc.stderr


def test_decode_warm_up_runs_the_ladder_at_start(monkeypatch):
    """``ZOO_SERVING_DECODE_MAX_SEQ`` > 0: ``start()`` also hands the
    model's ``warm_decode`` the engine's rungs, the draft's verify window
    and a page pool sized as the scheduler will size it."""
    from analytics_zoo_tpu_torch.inference import decode_scheduler

    class Decoder(_Gated):
        def __init__(self):
            super().__init__()
            self.decode_calls = []

        def warm_decode(self, max_seq, rungs=None, verify_k=0, block=True,
                        paged_pool=None):
            self.decode_calls.append((max_seq, tuple(rungs), verify_k,
                                      block, paged_pool))
            t = threading.Thread(target=lambda: None)
            t.start()
            return t

        def paged_decode_step_fn(self):
            raise AssertionError("not built by the warm-up")

    monkeypatch.setenv("ZOO_SERVING_DECODE_MAX_SEQ", "40")
    model = Decoder()
    eng = ClusterServing(model, 0, batch_size=2, max_batch_size=8,
                         draft_model=object(), spec_k=3)
    assert eng._kick_warmup() and eng.wait_warm(timeout=10) is eng
    assert model.kicked == [(2, 4, 8)]
    pages = decode_scheduler.default_pool_pages(8, 40, spec_k=3)
    assert model.decode_calls == [(40, (2, 4, 8), 3, False, (pages, 8))]
