"""The port's native tiered blob store (``data/native_store.py`` over its
own ``data/native/zstore.cpp``) and the ``NATIVE_n`` tier, on the CPU.

Mirrors JAX's ``tests/test_native_store.py``: the blob store's round trip,
eviction under capacity pressure, prefetch, the empty and the unknown
blob; the shard store's round trip with spill, XShards under
``NATIVE_4``, the context knob. Added for the port:
- the port's store and JAX's return the same shards for the same input;
- a fit fed from a ``NATIVE_2`` table is bitwise the ``DRAM`` fit (with
  ``shuffle=False``, and with shuffle: both tiers stream or gather the
  same windows), and the streaming feed keeps ``peak_window_rows`` within
  the tier's bound;
- with g++ missing (the PATH emptied, in a subprocess, the library not
  built), a ``NATIVE_n`` store raises ``NativeStoreCompileError`` naming
  g++: it never falls back to ``DISK_n``, as JAX's does.
The library is built by g++ into build/native at its first use.
"""

import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch.common.context import OrcaContext
from analytics_zoo_tpu_torch.data import HostXShards
from analytics_zoo_tpu_torch.data.dataset import (StreamingShardedDataset,
                                                  to_sharded_dataset)
from analytics_zoo_tpu_torch.data.native_store import (NativeBlobStore,
                                                       NativeShardStore)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _dram_after():
    yield
    OrcaContext.train_data_store = "DRAM"


class TestBlobStore:
    def test_put_get_roundtrip(self):
        store = NativeBlobStore(capacity_bytes=1 << 20)
        try:
            blobs = [bytes([i]) * (100 + i) for i in range(10)]
            ids = [store.put(b) for b in blobs]
            for i, b in zip(ids, blobs):
                assert store.get(i) == b
            assert store.count == 10
        finally:
            store.close()

    def test_eviction_under_capacity_pressure(self):
        store = NativeBlobStore(capacity_bytes=3 * 10_000)
        try:
            blobs = [np.random.RandomState(i).bytes(10_000)
                     for i in range(10)]
            ids = [store.put(b) for b in blobs]
            assert store.resident_bytes <= 3 * 10_000
            for i, b in zip(ids, blobs):
                assert store.get(i) == b
            stats = store.stats
            assert stats["misses"] > 0
            assert stats["hits"] + stats["misses"] == 10
        finally:
            store.close()

    def test_prefetch_stages_blobs(self):
        store = NativeBlobStore(capacity_bytes=2 * 10_000)
        try:
            blobs = [np.random.RandomState(i).bytes(10_000)
                     for i in range(6)]
            ids = [store.put(b) for b in blobs]
            store.prefetch(ids[:2])
            deadline = time.monotonic() + 5
            while time.monotonic() < deadline:
                if store.get(ids[0]) == blobs[0]:
                    break
                time.sleep(0.01)
            assert store.get(ids[1]) == blobs[1]
        finally:
            store.close()

    def test_empty_blob(self):
        store = NativeBlobStore(capacity_bytes=1000)
        try:
            assert store.get(store.put(b"")) == b""
        finally:
            store.close()

    def test_unknown_blob_raises(self):
        store = NativeBlobStore(capacity_bytes=1000)
        try:
            with pytest.raises(KeyError):
                store.get(12345)
        finally:
            store.close()


def _shards(seed=0, n=6, rows=100):
    rng = np.random.RandomState(seed)
    return [{"x": rng.randn(rows, 8).astype(np.float32),
             "y": rng.randint(0, 2, rows)} for _ in range(n)]


class TestNativeShardStore:
    def test_shard_roundtrip_with_spill(self):
        shards = _shards()
        store = NativeShardStore(shards, keep_fraction_denom=3)
        assert len(store) == 6 and store.tier == "NATIVE_3"
        for i in range(6):
            got = store.get(i)
            np.testing.assert_array_equal(got["x"], shards[i]["x"])
            np.testing.assert_array_equal(got["y"], shards[i]["y"])

    def test_xshards_native_tier(self):
        rng = np.random.RandomState(1)
        records = [{"x": rng.randn(50, 4)} for _ in range(8)]
        xs = HostXShards(records, tier="NATIVE_4")
        assert xs.tier == "NATIVE_4"
        out = xs.transform_shard(lambda s: {"x": s["x"] * 2}).collect()
        for rec, o in zip(records, out):
            np.testing.assert_array_equal(o["x"], rec["x"] * 2)

    def test_context_tier_setting(self):
        OrcaContext.train_data_store = "NATIVE_2"
        assert OrcaContext.train_data_store == "NATIVE_2"
        assert HostXShards([{"x": np.zeros(2)}]).tier == "NATIVE_2"
        with pytest.raises(ValueError):
            OrcaContext.train_data_store = "PMEM"

    def test_same_shards_as_the_jax_store(self):
        jns = pytest.importorskip("analytics_zoo_tpu.data.native_store")
        if jns.load_native_lib() is None:
            pytest.skip("the JAX package's store has no toolchain here")
        shards = _shards(seed=3, n=5, rows=300)
        mine = NativeShardStore(shards, keep_fraction_denom=4)
        theirs = jns.NativeShardStore(shards, keep_fraction_denom=4)
        assert mine.tier == theirs.tier and len(mine) == len(theirs)
        for i in (4, 0, 2, 1, 3):
            a, b = mine.get(i), theirs.get(i)
            for k in ("x", "y"):
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])


def _frames():
    import pandas as pd
    rng = np.random.default_rng(4)
    rows = 6
    base = pd.DataFrame({"a": np.arange(rows), "f": rng.random(rows)},
                        index=np.arange(10, 10 + rows))
    return {
        "array_cells": base.assign(
            h=list(rng.integers(0, 9, (rows, 4))),
            m=list(rng.random((rows, 2, 3)).astype(np.float32))),
        "int_lists": base.assign(l=[[int(v) for v in r] for r in
                                    rng.integers(-5, 5, (rows, 3))],
                                 e=[[] for _ in range(rows)]),
        "not_packable": base.assign(
            ragged=[[1] * (i % 3) for i in range(rows)],
            floats=[[1.5, 2] for _ in range(rows)],
            bools=[[True, False] for _ in range(rows)],
            mixed=[np.arange(2) if i % 2 else [1, 2] for i in range(rows)],
            strs=[f"s{i}" for i in range(rows)],
            objs=list(np.arange(rows * 2, dtype=object).reshape(rows, 2)),
            big=[[2 ** 70, 1] for _ in range(rows)]),
        "empty": base.iloc[0:0].assign(h=pd.Series([], dtype=object)),
    }


@pytest.mark.parametrize("name", ["array_cells", "int_lists",
                                  "not_packable", "empty"])
def test_shard_encoding_round_trips_exactly(name):
    """The store's blob of a DataFrame shard reads back the same frame:
    columns in order, index, dtypes, and every cell's type and value."""
    from analytics_zoo_tpu_torch.data.native_store import (decode_shard,
                                                           encode_shard)
    import pickle
    from analytics_zoo_tpu_torch.data import native_store
    frame = _frames()[name]
    blob = encode_shard(frame)
    packed = pickle.loads(blob)
    assert (type(packed) is tuple and packed[0] == native_store._PACKED) \
        == (name in ("array_cells", "int_lists"))
    back = decode_shard(blob)
    assert list(back.columns) == list(frame.columns)
    assert back.index.equals(frame.index)
    assert list(back.dtypes) == list(frame.dtypes)
    for c in frame.columns:
        for x, y in zip(frame[c].tolist(), back[c].tolist()):
            assert type(x) is type(y)
            if isinstance(x, (list, np.ndarray)):
                xa, ya = np.asarray(x), np.asarray(y)
                assert xa.dtype == ya.dtype and xa.shape == ya.shape
                assert np.array_equal(xa, ya)
                assert [type(v) for v in x] == [type(v) for v in y] \
                    if isinstance(x, list) else True
            else:
                assert x == y or (x != x and y != y)
    for other in ({"x": np.arange(3)}, [1, 2], np.zeros(4)):
        got = decode_shard(encode_shard(other))
        assert type(got) is type(other)


def _fit(tier, shuffle):
    """A small MLP's 2-epoch fit from 8 shards of 48 rows under ``tier``:
    the losses and the final parameters."""
    from analytics_zoo_tpu_torch.learn import Estimator
    OrcaContext.train_data_store = tier
    rng = np.random.RandomState(0)
    shards = HostXShards(
        [{"x": rng.randn(48, 4).astype(np.float32),
          "y": rng.randint(0, 2, 48).astype(np.int64)} for _ in range(8)])
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(4, 8), torch.nn.ReLU(),
                                torch.nn.Linear(8, 2), torch.nn.Softmax(-1))
    est = Estimator.from_torch(model=model,
                               loss="sparse_categorical_crossentropy",
                               optimizer="adam", device="cpu")
    hist = est.fit(shards, epochs=2, batch_size=32, shuffle=shuffle)
    return hist["loss"], [p.detach().clone() for p in model.parameters()]


@pytest.mark.parametrize("shuffle", [False, True])
def test_native_fit_is_bitwise_the_dram_fit(shuffle):
    dram_loss, dram_params = _fit("DRAM", shuffle)
    native_loss, native_params = _fit("NATIVE_2", shuffle)
    disk_loss, _ = _fit("DISK_2", shuffle)
    assert native_loss == disk_loss          # the same streaming windows
    if not shuffle:
        assert native_loss == dram_loss
        for a, b in zip(native_params, dram_params):
            assert torch.equal(a, b)


def test_native_feed_keeps_its_window_bound():
    OrcaContext.train_data_store = "NATIVE_4"
    shards = HostXShards([
        {"x": np.stack([np.arange(i * 32, (i + 1) * 32),
                        np.ones(32)], 1).astype(np.float32),
         "y": np.zeros(32, np.int32)} for i in range(8)])
    ds = to_sharded_dataset(shards)
    assert isinstance(ds, StreamingShardedDataset)
    seen = []
    for x, _, _ in ds.iter_batches(16, shuffle=True, seed=1):
        seen.extend(x[:, 0].astype(int).tolist())
    assert sorted(seen) == list(range(256))
    # windows of ceil(8 / 4) shards: 64 rows, plus a carry under a batch
    assert 64 <= ds.peak_window_rows < 64 + 16


def test_missing_gxx_raises_instead_of_falling_back(tmp_path):
    code = (
        "import sys\n"
        "import numpy as np\n"
        "from pathlib import Path\n"
        "from analytics_zoo_tpu_torch.data import HostXShards, "
        "native_store\n"
        f"native_store.BUILD_DIR = Path({str(tmp_path / 'native')!r})\n"
        "try:\n"
        "    HostXShards([np.arange(4)], tier='NATIVE_2')\n"
        "except native_store.NativeStoreCompileError as e:\n"
        "    print('RAISED', e)\n"
        "    sys.exit(0)\n"
        "print('NO ERROR')\n"
        "sys.exit(1)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PATH"] = ""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "RAISED" in out.stdout and "g++" in out.stdout
    assert not list((tmp_path / "native").glob("*.so"))
