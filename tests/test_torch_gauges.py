"""Two gauges of the observability catalog the port registers as the JAX
package does, each read from both packages' registries after the same
run (ROADMAP C32, C33):

- ``zoo_kv_cache_rung``: ``BucketedKVCache`` sets it to the live
  seq-length rung when it is built and whenever it grows, so a greedy
  ``generate`` of the decode Seq2Seq (bench.py's ``measure_decode``
  configuration at this file's small size) leaves the final rung there;
- ``zoo_data_prefetch_depth``: the streaming ``iter_batches`` of a
  ``DISK_n`` feed sets it to its ``prefetch_depth`` before its pool
  starts.
"""

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch import convert
from analytics_zoo_tpu_torch.common import compile_ahead, telemetry
from analytics_zoo_tpu_torch.common.context import OrcaContext
from analytics_zoo_tpu_torch.data import HostXShards, to_sharded_dataset
from analytics_zoo_tpu_torch.inference import InferenceModel, generation
from analytics_zoo_tpu_torch.models import Seq2Seq

#: bench.py's measure_decode model, cut to the test size bench.py's own
#: small run uses (batch 4, 8 steps, hidden 16)
DECODE = dict(input_dim=8, output_dim=8, hidden_size=16, rnn_type="gru",
              encoder_seq_len=8, decoder_seq_len=4)
BATCH, STEPS = 4, 8


@pytest.fixture
def jax_side():
    """The JAX package's telemetry, generation and data layer, with both
    registries fresh and the tier knobs put back after."""
    pytest.importorskip("jax")
    from analytics_zoo_tpu.common import telemetry as jtel
    from analytics_zoo_tpu.common.context import OrcaContext as JCtx
    from analytics_zoo_tpu.data import dataset as jdataset
    from analytics_zoo_tpu.data import shard as jshard
    from analytics_zoo_tpu.inference import generation as jgen
    jtel.reset_for_tests()
    telemetry.reset_for_tests()
    yield dict(telemetry=jtel, generation=jgen, dataset=jdataset,
               shard=jshard, ctx=JCtx)
    JCtx.train_data_store = "DRAM"
    OrcaContext.train_data_store = "DRAM"
    jtel.reset_for_tests()
    telemetry.reset_for_tests()


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _gauge(tel, name):
    return tel.snapshot().get(name)


def test_kv_cache_rung_set_at_build_and_growth(jax_side):
    """The cache's own contract in both packages: built on a ladder's
    first rung, then each growth, the gauge reads the live rung."""
    jgen, jtel = jax_side["generation"], jax_side["telemetry"]
    from analytics_zoo_tpu.common import compile_ahead as jca
    mine = generation.BucketedKVCache(3, 5, compile_ahead.BucketLadder(2, 16))
    theirs = jgen.BucketedKVCache(3, 5, jca.BucketLadder(2, 16))
    assert _gauge(telemetry, "zoo_kv_cache_rung") == \
        _gauge(jtel, "zoo_kv_cache_rung") == 2
    for i in range(5):
        row = np.full((3, 5), float(i), np.float32)
        mine.append(row)
        theirs.append(row)
        assert mine.rung == theirs.rung
        assert _gauge(telemetry, "zoo_kv_cache_rung") == \
            _gauge(jtel, "zoo_kv_cache_rung") == mine.rung
    assert mine.rung == 8


def test_kv_cache_rung_after_greedy_generate_matches_jax(jax_side):
    import jax
    from analytics_zoo_tpu.inference import InferenceModel as JIM
    from analytics_zoo_tpu.models import Seq2Seq as JSeq2Seq
    jtel = jax_side["telemetry"]
    rng = np.random.default_rng(7)
    enc = rng.standard_normal((BATCH, 8, 8)).astype(np.float32)
    start = np.zeros((BATCH, 8), np.float32)
    jim = JIM().load_zoo(JSeq2Seq(**DECODE))
    jim.predict((enc, np.zeros((BATCH, 1, 8), np.float32)))
    params = jax.device_get(jim._params["params"])
    port = Seq2Seq(**DECODE)
    port.model.module.load_state_dict(convert.flax_to_state_dict(params))
    im = InferenceModel(device="cpu").load_zoo(port)
    jtel.reset_for_tests()
    telemetry.reset_for_tests()
    want = np.asarray(jim.generate(enc, start, STEPS))
    got = im.generate(enc, start, STEPS)
    assert got.shape == want.shape == (BATCH, STEPS, 8)
    theirs = _gauge(jtel, "zoo_kv_cache_rung")
    # the cache holds the start token plus STEPS positions at the end
    assert theirs is not None and theirs >= STEPS + 1
    assert _gauge(telemetry, "zoo_kv_cache_rung") == theirs


@pytest.mark.parametrize("depth", [1, 3])
def test_prefetch_depth_gauge_matches_jax(jax_side, monkeypatch, depth):
    monkeypatch.setenv("ZOO_DATA_PREFETCH", str(depth))
    jtel = jax_side["telemetry"]
    OrcaContext.train_data_store = "DISK_4"
    jax_side["ctx"].train_data_store = "DISK_4"
    rng = np.random.RandomState(1)
    shards = [{"x": rng.randn(16, 3).astype(np.float32),
               "y": rng.randint(0, 2, 16).astype(np.int32)}
              for _ in range(8)]
    mine = to_sharded_dataset(HostXShards(shards))
    theirs = jax_side["dataset"].to_sharded_dataset(
        jax_side["shard"].HostXShards(shards))
    assert type(mine).__name__ == type(theirs).__name__ == \
        "StreamingShardedDataset"
    assert mine.prefetch_depth == theirs.prefetch_depth == depth
    assert _gauge(telemetry, "zoo_data_prefetch_depth") is None
    got = list(mine.iter_batches(16))
    want = list(theirs.iter_batches(16))
    assert len(got) == len(want) == 8
    assert _gauge(telemetry, "zoo_data_prefetch_depth") == \
        _gauge(jtel, "zoo_data_prefetch_depth") == depth
