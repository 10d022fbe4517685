"""The port's data layer (``data/shard.py``, ``data/dataset.py``,
``data/pandas``) against the JAX package's, on the CPU.

- The tests of JAX's ``tests/test_data.py`` that need no mesh, mirrored
  (its native-store fallback test becomes: ``NATIVE_n`` without g++
  raises ``NativeStoreCompileError`` instead of falling back to DISK_n).
- Cross-package, bitwise: ``partition`` (``num_shards`` given: JAX's CPU
  context has 8 devices, the port's 1), ``repartition``, ``partition_by``,
  ``split``, ``zip``, ``len``, ``__getitem__`` and ``unique`` give JAX's
  shards; ``save_pickle`` of either package loads in the other.
- Under ``DISK_4`` the streaming feed gives JAX's batches bitwise, with
  shuffle on and off, over two epochs, with ``drop_remainder`` on and off
  (mask included), and the same ``peak_window_rows``.
- ``ZOO_DATA_WORKERS=1`` and ``4`` give the same shards; the in-flight
  window stays bounded; a failing shard names its index.
- The data modules import, and stream numpy-dict shards, in a subprocess
  where pandas cannot be imported.
- Training from a ``DISK_n`` store: a fit streams, stays bounded, ends
  bitwise where the DRAM fit ends with ``shuffle=False``, and a faulted,
  auto-resumed streaming fit ends bitwise where an unfaulted one does.

JAX is imported by fixtures only.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

import analytics_zoo_tpu_torch.data.pandas as zoo_pandas
from analytics_zoo_tpu_torch.common import resilience
from analytics_zoo_tpu_torch.common.context import OrcaContext
from analytics_zoo_tpu_torch.data import (HostXShards, ShardedDataset,
                                          SharedValue,
                                          StreamingShardedDataset, XShards,
                                          to_sharded_dataset)
from analytics_zoo_tpu_torch.data import shard as shard_lib

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _reset(monkeypatch, tmp_path):
    from analytics_zoo_tpu_torch.learn import estimator
    monkeypatch.setattr(estimator, "DEFAULT_LOG_DIR", str(tmp_path / "logs"))
    monkeypatch.delenv("ZOO_DATA_WORKERS", raising=False)
    yield
    OrcaContext.train_data_store = "DRAM"
    OrcaContext.shard_size = None


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def jx():
    """The JAX package's data layer; its tier knob put back after."""
    pytest.importorskip("jax")
    from analytics_zoo_tpu.common.context import OrcaContext as JCtx
    from analytics_zoo_tpu.data import dataset, shard
    import analytics_zoo_tpu.data.pandas as jpandas
    yield dict(ctx=JCtx, shard=shard, dataset=dataset, pandas=jpandas)
    JCtx.train_data_store = "DRAM"
    JCtx.shard_size = None


def both_tiers(jx, tier):
    OrcaContext.train_data_store = tier
    jx["ctx"].train_data_store = tier


@pytest.fixture
def csv_dir(tmp_path):
    for i in range(3):
        df = pd.DataFrame({"a": np.arange(10) + i * 10,
                           "b": np.arange(10) * 2.0,
                           "label": (np.arange(10) % 2)})
        df.to_csv(tmp_path / f"f{i}.csv", index=False)
    return str(tmp_path)


def assert_same(a, b):
    """Bitwise equality of two shards (arrays, dicts, tuples, lists,
    DataFrames, Series)."""
    if isinstance(a, (pd.DataFrame, pd.Series)):
        pd.testing.assert_frame_equal(pd.DataFrame(a), pd.DataFrame(b))
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            assert_same(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b)
        for u, v in zip(a, b):
            assert_same(u, v)
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def assert_shards(got, want):
    g, w = got.collect(), want.collect()
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert_same(a, b)


# ------------------------------------------- JAX's tests/test_data.py

def test_partition_and_transform():
    x = {"x": np.arange(40).reshape(40, 1).astype(np.float32),
         "y": np.arange(40).astype(np.int32)}
    shards = XShards.partition(x, num_shards=4)
    assert shards.num_partitions() == 4
    assert len(shards) == 40
    doubled = shards.transform_shard(lambda d: {"x": d["x"] * 2,
                                                "y": d["y"]})
    got = np.concatenate([s["x"] for s in doubled.collect()])
    np.testing.assert_allclose(got[:, 0], np.arange(40) * 2)


def test_read_csv_repartition_partition_by(csv_dir):
    shards = zoo_pandas.read_csv(csv_dir)
    assert shards.num_partitions() == 3
    assert len(shards) == 30
    rep = shards.repartition(5)
    assert rep.num_partitions() == 5
    assert len(rep) == 30
    byp = shards.partition_by("label", num_partitions=2)
    for df in byp.collect():
        assert df["label"].nunique() <= 1
    assert sum(len(d) for d in byp.collect()) == 30
    assert set(shards["label"].unique().tolist()) == {0, 1}


def test_shard_size_knob(csv_dir):
    OrcaContext.shard_size = 7
    assert zoo_pandas.read_csv(csv_dir).num_partitions() == 5  # ceil(30/7)


def test_save_load_pickle(tmp_path, csv_dir):
    shards = zoo_pandas.read_csv(csv_dir)
    shards.save_pickle(str(tmp_path / "saved"), batchSize=2)
    loaded = XShards.load_pickle(str(tmp_path / "saved"))
    assert len(loaded) == 30
    assert XShards.load_pickle(str(tmp_path / "saved"),
                               minPartitions=6).num_partitions() == 6
    with pytest.raises(FileNotFoundError):
        XShards.load_pickle(str(tmp_path / "none"))


def test_disk_tier():
    OrcaContext.train_data_store = "DISK_2"
    x = {"x": np.ones((16, 2), np.float32), "y": np.zeros(16, np.int32)}
    shards = XShards.partition(x, num_shards=4)
    assert shards.tier == "DISK_2"
    assert len(shards) == 16
    assert sum(len(s["y"]) for s in shards.collect()) == 16
    # 1 of every 2 shards resident, every one spilled
    store = shards._store
    assert [s is not None for s in store._mem] == [True, False] * 2
    assert all(os.path.exists(p) for p in store._paths)


def test_native_tier_raises_instead_of_falling_back(monkeypatch, tmp_path):
    from analytics_zoo_tpu_torch.data import native_store
    monkeypatch.setattr(native_store, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(native_store, "_lib", None)
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(native_store.NativeStoreCompileError, match="g\\+\\+"):
        shard_lib._make_store([{"a": np.arange(4)}], "NATIVE_2")
    OrcaContext.train_data_store = "NATIVE_2"
    with pytest.raises(native_store.NativeStoreCompileError):
        HostXShards([{"a": np.arange(4)}])


def test_streaming_dataset_covers_all_rows_bounded():
    OrcaContext.train_data_store = "DISK_4"
    # 8 shards x 32 rows; the row id rides in column 0
    shards = HostXShards([
        {"x": np.stack([np.arange(i * 32, (i + 1) * 32),
                        np.ones(32)], 1).astype(np.float32),
         "y": np.zeros(32, np.int32)}
        for i in range(8)])
    ds = to_sharded_dataset(shards)
    assert isinstance(ds, StreamingShardedDataset)
    assert ds.n == 256 and ds.x is None
    for epoch in (0, 1):
        got = [x for x, y, m in
               ds.iter_batches(16, shuffle=True, seed=3, epoch=epoch)]
        ids = np.concatenate([g[:, 0] for g in got])
        assert sorted(ids.tolist()) == list(range(256))
    # window = ceil(8/4) = 2 shards (64 rows) + a carry under 16
    assert ds.peak_window_rows <= 64 + 16
    got = list(ds.iter_batches(48, drop_remainder=False))
    assert got[-1][2] is not None
    assert sum(int(m.sum()) if m is not None else len(x)
               for x, y, m in got) == 256


def test_fit_streams_from_tiered_store():
    from analytics_zoo_tpu_torch.common.flax_compat import Dense
    from analytics_zoo_tpu_torch.learn import Estimator
    OrcaContext.train_data_store = "DISK_2"
    rng = np.random.RandomState(0)
    shards = []
    for _ in range(8):
        x = rng.randn(64, 4).astype(np.float32)
        shards.append({"x": x, "y": (x.sum(1) > 0).astype(np.int32)})
    ds = to_sharded_dataset(HostXShards(shards))
    assert isinstance(ds, StreamingShardedDataset)
    torch.manual_seed(0)
    net = torch.nn.Sequential(Dense(4, 16), torch.nn.Tanh(), Dense(16, 2))
    est = Estimator.from_torch(model=net,
                               loss="sparse_categorical_crossentropy_logits",
                               optimizer="adam", device="cpu")
    h = est.fit(ds, epochs=4, batch_size=32)
    assert h["loss"][-1] < h["loss"][0]
    # window = ceil(8/2) = 4 shards = 256 rows (+ carry), not 512
    assert 0 < ds.peak_window_rows <= 256 + 32


def test_zip_split():
    a = HostXShards([np.arange(4), np.arange(4, 8)])
    b = HostXShards([np.arange(4) * 10, np.arange(4, 8) * 10])
    parts = a.zip(b).split()
    assert len(parts) == 2
    np.testing.assert_array_equal(parts[1].collect()[0], np.arange(4) * 10)
    with pytest.raises(ValueError, match="partition counts"):
        a.zip(HostXShards([np.arange(8)]))
    with pytest.raises(ValueError, match="lengths"):
        a.zip(HostXShards([np.arange(3), np.arange(4)]))


def test_sharded_dataset_batching():
    n = 35
    ds = ShardedDataset.from_ndarrays(
        {"u": np.arange(n, dtype=np.float32)}, np.arange(n, dtype=np.int32))
    batches = list(ds.iter_batches(8, shuffle=True, seed=1))
    assert len(batches) == 4 == ds.steps_per_epoch(8)
    assert all(b[0]["u"].shape == (8,) for b in batches)
    batches = list(ds.iter_batches(8, drop_remainder=False))
    assert len(batches) == 5 == ds.steps_per_epoch(8, drop_remainder=False)
    x, y, mask = batches[-1]
    assert x["u"].shape == (8,) and mask.sum() == 3
    e0 = np.concatenate([b[1] for b in ds.iter_batches(5, shuffle=True,
                                                       epoch=0)])
    e1 = np.concatenate([b[1] for b in ds.iter_batches(5, shuffle=True,
                                                       epoch=1)])
    assert not np.array_equal(e0, e1)
    assert set(e0.tolist()) == set(range(35))


def test_from_dataframe_cols():
    df = pd.DataFrame({"f1": np.arange(10.0), "f2": np.arange(10.0) * 2,
                       "y": np.arange(10)})
    ds = to_sharded_dataset(df, feature_cols=["f1", "f2"], label_cols="y")
    assert isinstance(ds.x, tuple) and len(ds.x) == 2
    assert ds.n == 10


# ------------------------------------------------- cross-package, bitwise

def _tree_data(kind):
    rng = np.random.RandomState(1)
    n = 37
    if kind == "dict":
        return {"x": rng.randn(n, 3).astype(np.float32),
                "y": rng.randint(0, 5, n).astype(np.int32)}
    if kind == "array":
        return rng.randn(n, 2, 2)
    return (rng.randn(n).astype(np.float32),
            [rng.randint(0, 9, n), {"a": np.arange(n), "b": np.ones(n)}])


@pytest.mark.parametrize("kind", ["dict", "array", "nested"])
@pytest.mark.parametrize("n", [1, 3, 8])
def test_partition_matches_jax(jx, kind, n):
    data = _tree_data(kind)
    assert_shards(XShards.partition(data, num_shards=n),
                  jx["shard"].XShards.partition(data, num_shards=n))


def _shard_lists():
    rng = np.random.RandomState(2)
    sizes = (5, 0, 12, 7)
    return {
        "dict": [{"x": rng.randn(k, 2).astype(np.float32),
                  "y": np.arange(k)} for k in sizes],
        "array": [rng.randn(k) for k in sizes],
        "frame": [pd.DataFrame({"a": rng.randn(k), "b": np.arange(k)},
                               index=np.arange(k) + 100 * i)
                  for i, k in enumerate(sizes)],
        "records": [[f"r{i}-{j}" for j in range(k)]
                    for i, k in enumerate(sizes)],
    }


@pytest.mark.parametrize("kind", ["dict", "array", "frame", "records"])
@pytest.mark.parametrize("m", [1, 3, 6, 30])
def test_repartition_matches_jax(jx, kind, m):
    shards = _shard_lists()[kind]
    assert_shards(HostXShards(shards).repartition(m),
                  jx["shard"].HostXShards(shards).repartition(m))


@pytest.mark.parametrize("cols,n", [("label", 2), (["a", "label"], 3),
                                    ("a", None)])
def test_partition_by_matches_jax(jx, csv_dir, cols, n):
    got = zoo_pandas.read_csv(csv_dir).partition_by(cols, num_partitions=n)
    want = jx["pandas"].read_csv(csv_dir).partition_by(cols,
                                                       num_partitions=n)
    assert_shards(got, want)
    with pytest.raises(TypeError, match="DataFrame"):
        HostXShards([np.arange(3)]).partition_by("a")


def test_readers_match_jax(jx, csv_dir, tmp_path):
    frames = zoo_pandas.read_csv(csv_dir).collect()
    out = tmp_path / "other"
    out.mkdir()
    for i, df in enumerate(frames):
        df.to_json(out / f"j{i}.json", orient="records", lines=True)
        df.to_parquet(out / f"p{i}.parquet")
    for reader, pattern, kw in (
            ("read_csv", csv_dir, {}),
            ("read_json", str(out / "j*.json"), {"orient": "records",
                                                 "lines": True}),
            ("read_parquet", str(out / "p*.parquet"), {})):
        for num in (None, 4):
            got = getattr(zoo_pandas, reader)(pattern, num_shards=num, **kw)
            want = getattr(jx["pandas"], reader)(pattern, num_shards=num,
                                                 **kw)
            assert_shards(got, want)
    pd.testing.assert_frame_equal(
        zoo_pandas.read_csv(csv_dir).to_pandas(),
        jx["pandas"].read_csv(csv_dir).to_pandas())
    with pytest.raises(FileNotFoundError):
        zoo_pandas.read_csv(str(out / "missing*.csv"))


def test_split_zip_len_getitem_unique_match_jax(jx, csv_dir):
    J = jx["shard"].HostXShards
    pairs = [(np.arange(4), np.arange(4) * 2.0), (np.arange(4, 9),
                                                  np.ones(5))]
    for g, w in zip(HostXShards(pairs).split(), J(pairs).split()):
        assert_shards(g, w)
    a, b = [np.arange(3), np.arange(3, 7)], [np.ones(3), np.zeros(4)]
    assert_shards(HostXShards(a).zip(HostXShards(b)), J(a).zip(J(b)))
    dicts = [{"x": np.arange(6).reshape(3, 2), "y": np.arange(3)},
             {"x": np.arange(8).reshape(4, 2), "y": np.arange(4)}]
    for data in (dicts, a, [3, "x", 1.5], pairs):
        assert len(HostXShards(data)) == len(J(data))
    assert_shards(HostXShards(dicts)["y"], J(dicts)["y"])
    frames = zoo_pandas.read_csv(csv_dir)
    jframes = jx["pandas"].read_csv(csv_dir)
    assert_shards(frames["label"], jframes["label"])
    assert_same(frames["a"].unique(), jframes["a"].unique())
    assert_same(HostXShards(a).unique(), J(a).unique())
    with pytest.raises(KeyError):
        HostXShards([np.arange(3)])["a"]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_save_pickle_loads_in_the_other_package(jx, tmp_path, writer):
    data = _shard_lists()
    shards = data["dict"] + data["frame"]
    path = str(tmp_path / "pk")
    if writer == "port":
        HostXShards(shards).save_pickle(path, batchSize=3)
        got = jx["shard"].XShards.load_pickle(path)
    else:
        jx["shard"].HostXShards(shards).save_pickle(path, batchSize=3)
        got = XShards.load_pickle(path)
    assert_shards(got, HostXShards(shards))
    assert sorted(os.listdir(path)) == [f"part-0000{i}.pkl"
                                        for i in range(3)]


def _stream_shards(n_shards=16, rows=(13, 20, 7, 31)):
    rng = np.random.RandomState(4)
    return [{"x": {"a": rng.randn(rows[i % 4], 3).astype(np.float32),
                   "ids": np.arange(rows[i % 4]) + 1000 * i},
             "y": rng.randn(rows[i % 4], 2).astype(np.float32)}
            for i in range(n_shards)]


@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("drop", [True, False])
def test_streaming_batches_match_jax_bitwise(jx, shuffle, drop):
    both_tiers(jx, "DISK_4")
    shards = _stream_shards()
    got_ds = to_sharded_dataset(HostXShards(shards))
    want_ds = jx["dataset"].to_sharded_dataset(jx["shard"].HostXShards(
        shards))
    assert type(got_ds).__name__ == type(want_ds).__name__ == \
        "StreamingShardedDataset"
    assert got_ds.n == want_ds.n and \
        got_ds.window_shards == want_ds.window_shards == 4
    for epoch in (0, 1):
        got = list(got_ds.iter_batches(24, shuffle, seed=7, epoch=epoch,
                                       drop_remainder=drop))
        want = list(want_ds.iter_batches(24, shuffle, seed=7, epoch=epoch,
                                         drop_remainder=drop))
        assert len(got) == len(want) > 0
        for (gx, gy, gm), (wx, wy, wm) in zip(got, want):
            assert_same(gx, wx)
            assert_same(gy, wy)
            assert (gm is None) == (wm is None)
            if gm is not None:
                assert_same(gm, wm)
        assert (got[-1][2] is not None) == (not drop)
    assert got_ds.peak_window_rows == want_ds.peak_window_rows > 0


def test_streaming_dataframe_shards_match_jax(jx):
    both_tiers(jx, "DISK_2")
    rng = np.random.RandomState(5)
    frames = [pd.DataFrame({"f1": rng.randn(k), "f2": rng.randn(k),
                            "y": rng.randint(0, 3, k)}) for k in (9, 4, 11)]
    kw = dict(feature_cols=["f1", "f2"], label_cols=["y"])
    got = list(to_sharded_dataset(HostXShards(frames), **kw).iter_batches(
        4, True, seed=1))
    want = list(jx["dataset"].to_sharded_dataset(
        jx["shard"].HostXShards(frames), **kw).iter_batches(4, True,
                                                            seed=1))
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert_same(g[:2], w[:2])


def test_dataset_transforms_match_jax(jx):
    x = {"a": np.arange(30, dtype=np.float32), "b": np.arange(60).reshape(
        30, 2)}
    y = np.arange(30) % 4
    got, want = ShardedDataset.from_ndarrays(x, y), \
        jx["dataset"].ShardedDataset.from_ndarrays(x, y)
    for g, w in zip(got.split(0.3, seed=2), want.split(0.3, seed=2)):
        assert_same((g.x, g.y), (w.x, w.y))
    assert_same(got.take(7).x, want.take(7).x)
    fn = lambda a, b: ({"a": a["a"] * 2, "b": a["b"]}, b + 1)  # noqa: E731
    assert_same(got.map(fn).y, want.map(fn).y)
    for bs in (4, 7, 30):
        assert got.steps_per_epoch(bs) == want.steps_per_epoch(bs)
        assert got.steps_per_epoch(bs, False) == \
            want.steps_per_epoch(bs, False)
    OrcaContext.train_data_store = "DISK_2"
    stream = to_sharded_dataset(XShards.partition({"x": x, "y": y},
                                                  num_shards=4))
    assert_same(stream.take(5).x, got.take(5).x)
    assert_same(stream.map(fn).y, got.map(fn).y)
    assert stream.split(0.5)[0].n == 15


@pytest.mark.parametrize("op", ["transform", "repartition", "map_reduce"])
def test_data_workers_give_the_same_shards(monkeypatch, op):
    OrcaContext.train_data_store = "DISK_3"
    shards = _shard_lists()["dict"] * 3
    runs = []
    for workers in ("1", "4"):
        monkeypatch.setenv("ZOO_DATA_WORKERS", workers)
        xs = HostXShards(shards)
        if op == "transform":
            runs.append(xs.transform_shard(
                lambda s, k: {"x": s["x"] * k, "y": s["y"]}, 3).collect())
        elif op == "repartition":
            runs.append(xs.repartition(5).collect())
        else:
            runs.append(xs.map_reduce_shard(lambda s: s["x"].sum(0),
                                            lambda a, b: a + b))
        stats = shard_lib.LAST_RUN_STATS[
            {"transform": "transform_shard"}.get(op, op)]
        assert stats["workers"] == int(workers)
        assert 1 <= stats["in_flight_peak"] <= int(workers) + 2
    assert_same(runs[0], runs[1])
    assert shard_lib.workers_busy == 0
    assert shard_lib.OP_TOTALS[{"transform": "transform_shard"}.get(
        op, op)][0] >= 2


def test_op_totals_lose_no_update_across_threads():
    """The pool's threads add to OP_TOTALS together (the streaming
    feed's window loads): no count is lost."""
    import threading
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(500):
                shard_lib.record_op("stress", 1e-3)
        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(prev)
    calls, seconds = shard_lib.OP_TOTALS.pop("stress")
    assert calls == 16 * 500
    assert seconds == pytest.approx(8.0)


@pytest.mark.parametrize("workers", ["1", "4"])
def test_failing_shard_names_its_index(monkeypatch, workers):
    monkeypatch.setenv("ZOO_DATA_WORKERS", workers)

    def boom(s):
        if s[0] == 5:
            raise ValueError("bad shard")
        return s

    with pytest.raises(shard_lib.ShardTransformError,
                       match="shard 2 failed") as err:
        HostXShards([np.arange(i, i + 2) for i in (1, 3, 5, 7)]
                    ).transform_shard(boom)
    assert err.value.shard_index == 2 and err.value.op == "transform_shard"


def test_first_cache_shared_value_and_alias():
    OrcaContext.train_data_store = "DISK_2"
    xs = HostXShards([np.arange(3), np.arange(3, 5)])
    assert xs.cache() is xs and xs.uncache() is xs
    assert_same(xs.first(), np.arange(3))
    with pytest.raises(IndexError):
        HostXShards([]).first()
    assert shard_lib.SparkXShards is HostXShards
    v = SharedValue({"k": 1})
    assert v.value == {"k": 1}
    v.unpersist()
    assert v.value is None
    assert HostXShards([1], transient=True).tier == "DRAM"


def test_data_modules_stream_without_pandas():
    code = (
        "import sys\n"
        "sys.modules['pandas'] = None\n"
        "import numpy as np\n"
        "import analytics_zoo_tpu_torch.data as d\n"
        "import analytics_zoo_tpu_torch.data.pandas\n"
        "import analytics_zoo_tpu_torch.zouwu.model\n"
        "from analytics_zoo_tpu_torch.common.context import OrcaContext\n"
        "OrcaContext.train_data_store = 'DISK_4'\n"
        "sh = d.XShards.partition({'x': np.arange(200.).reshape(100, 2),\n"
        "                          'y': np.arange(100)}, num_shards=8)\n"
        "ds = d.to_sharded_dataset(sh.repartition(12))\n"
        "assert type(ds).__name__ == 'StreamingShardedDataset'\n"
        "got = sorted(int(i) for _, y, _ in ds.iter_batches(\n"
        "    10, shuffle=True, seed=3) for i in y)\n"
        "assert got == list(range(100)), got\n"
        "try:\n"
        "    import pandas\n"
        "except ImportError:\n"
        "    print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "ok"


def _mlp():
    from analytics_zoo_tpu_torch.common.flax_compat import Dense
    torch.manual_seed(3)
    return torch.nn.Sequential(Dense(4, 8), torch.nn.Tanh(), Dense(8, 1))


def _reg_shards():
    rng = np.random.RandomState(6)
    x = rng.randn(96, 4).astype(np.float32)
    return {"x": x, "y": x[:, :1] * 0.5 - x[:, 1:2]}


def test_disk_fit_without_shuffle_ends_where_dram_ends():
    from analytics_zoo_tpu_torch.learn import Estimator
    data = _reg_shards()
    ends = {}
    for tier in ("DRAM", "DISK_4"):
        OrcaContext.train_data_store = tier
        xs = XShards.partition(data, num_shards=8)
        est = Estimator.from_torch(model=_mlp(), loss="mse",
                                   optimizer="adam", device="cpu")
        hist = est.fit(xs, epochs=2, batch_size=16, shuffle=False)
        ev = est.evaluate(xs, batch_size=20)
        pred = est.predict(xs, batch_size=20)
        ends[tier] = (hist, [p.detach().clone() for p in
                             est.model.parameters()], ev,
                      pred.collect()[0]["prediction"])
    (h0, p0, e0, q0), (h1, p1, e1, q1) = ends["DRAM"], ends["DISK_4"]
    assert h0 == h1 and e0 == e1
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))
    assert_same(q0, q1)


def test_streaming_fit_resumes_bitwise(tmp_path):
    from analytics_zoo_tpu_torch.learn import Estimator
    from analytics_zoo_tpu_torch.learn.trigger import SeveralIteration
    OrcaContext.train_data_store = "DISK_2"
    xs = XShards.partition(_reg_shards(), num_shards=6)

    def run(faulted, mdir):
        resilience.reset_for_tests()
        resilience.install_plan("wedge@step:8" if faulted else None)
        est = Estimator.from_torch(model=_mlp(), loss="mse",
                                   optimizer="adam", device="cpu",
                                   model_dir=mdir)
        hist = est.fit(xs, epochs=2, batch_size=16,
                       checkpoint_trigger=SeveralIteration(3),
                       auto_resume=faulted)
        resilience.install_plan(None)
        return est, hist

    a, ha = run(False, str(tmp_path / "a"))
    b, hb = run(True, str(tmp_path / "b"))
    assert a._py_step == b._py_step == 12
    assert ha == hb and a.step_losses == b.step_losses
    for p, q in zip(a.model.parameters(), b.model.parameters()):
        assert torch.equal(p, q)
