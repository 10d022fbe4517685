"""The port's Friesian ``FeatureTable`` (``friesian/feature/table.py``)
against the JAX package's, on the CPU.

Mirrors JAX's ``tests/test_friesian.py`` and ``tests/test_friesian_parity.py``:
- every ``Table`` / ``FeatureTable`` / ``StringIndex`` op gives the JAX
  package's frame bitwise from the same pandas input (columns, index,
  dtypes and every cell, list cells element for element), under the
  legacy row-wise bodies (``ZOO_DATA_VECTORIZE=0 ZOO_DATA_WORKERS=0``)
  and under the vectorized ones on 4 workers;
- within the port, the vectorized bodies equal the legacy ones wherever
  JAX's parity tests hold them equal, under 1 and 4 workers;
  ``_shard_seed`` keeps the negatives the same under any worker count;
- ``bench.py``'s transform chain (``_recsys_transforms``) at 2000 rows
  equals JAX's in both modes, and the vectorized chain is bitwise across
  worker counts. Legacy and vectorized chains are not equal to each other
  in either package: the vectorized ``add_hist_seq`` regroups rows by
  user, so ``add_negative_samples`` draws from other shard contents; their
  positive rows agree once sorted;
- an NCF fit (CPU) fed by the port's table through
  ``to_streaming_dataset`` against JAX's fit fed by JAX's table, from the
  same parameters (``convert.flax_to_state_dict``): the epoch's loss
  within rtol 1e-5, and after the first 5 steps on each table's first
  rows every parameter within 1e-5.
JAX is imported by fixtures only.
"""

import os
import types

import numpy as np
import pandas as pd
import pytest
import torch

from analytics_zoo_tpu_torch.friesian.feature import (FeatureTable,
                                                      StringIndex, Table)
from analytics_zoo_tpu_torch.friesian.feature import table as ttable

PORT = types.SimpleNamespace(FeatureTable=FeatureTable, Table=Table,
                             StringIndex=StringIndex)
LEGACY = {"ZOO_DATA_VECTORIZE": "0", "ZOO_DATA_WORKERS": "0"}


def _fast(workers):
    return {"ZOO_DATA_VECTORIZE": "1", "ZOO_DATA_WORKERS": str(workers)}


@pytest.fixture(scope="module")
def jax_pkg():
    pytest.importorskip("jax")
    from analytics_zoo_tpu.friesian.feature import (FeatureTable as JFT,
                                                    StringIndex as JSI,
                                                    Table as JT)
    return types.SimpleNamespace(FeatureTable=JFT, Table=JT, StringIndex=JSI)


@pytest.fixture(autouse=True)
def _autotune_off(monkeypatch, tmp_path):
    monkeypatch.setenv("ZOO_AUTOTUNE", "off")
    monkeypatch.setenv("ZOO_AUTOTUNE_CACHE", str(tmp_path / "at.json"))


def _under(monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)


def _same(a, b, where="result"):
    """Bitwise equality of op results: DataFrames (columns, index, dtypes,
    each cell with its dtype), dicts, lists and tuples, arrays, scalars."""
    if isinstance(a, pd.DataFrame):
        assert isinstance(b, pd.DataFrame), where
        assert list(a.columns) == list(b.columns), where
        assert a.index.equals(b.index), where
        for c in a.columns:
            assert a[c].dtype == b[c].dtype, (where, c)
            if a[c].dtype != object:
                pd.testing.assert_series_equal(a[c], b[c], check_exact=True)
                continue
            for i, (x, y) in enumerate(zip(a[c].tolist(), b[c].tolist())):
                _same(x, y, f"{where}[{c}][{i}]")
    elif isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), where
        for k in a:
            _same(a[k], b[k], f"{where}[{k}]")
    elif isinstance(a, (list, tuple)) and not (
            a and all(np.isscalar(v) for v in a)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif a is None or isinstance(a, str):
        assert a == b, where
    else:
        xa, ya = np.asarray(a), np.asarray(b)
        assert type(a) is type(b) or (np.isscalar(a) and np.isscalar(b)), \
            (where, type(a), type(b))
        assert xa.shape == ya.shape and xa.dtype == ya.dtype, where
        assert np.array_equal(xa, ya, equal_nan=xa.dtype.kind == "f"), \
            (where, a, b)


def ratings_df():
    return pd.DataFrame({
        "user": [1, 1, 1, 2, 2, 3, 3, 4],
        "item": [10, 11, 12, 10, 13, 11, 14, 10],
        "time": [1, 2, 3, 1, 2, 1, 2, 5],
        "price": [1.0, np.nan, 3.0, 4.0, 5.0, np.nan, 2.5, 8.0],
        "cat": ["a", "b", "a", "c", "a", None, "b", "d"],
    })


def hist_df():
    return pd.DataFrame({
        "user": [1, 1, 2, 2, 3, 3],
        "flat": [[1, 2], [3], [], [4, 5, 6, 7, 8], [9], []],
        "nested": [[[1, 2], [3, 4]], [[5, 6]], [],
                   [[7, 8], [9, 10], [11, 12]], [[13, 14]], []],
    })


def cat_df():
    return pd.DataFrame({
        "user": np.arange(12),
        "price": [1.0, np.nan, 3.0, 4.0, 5.0, np.nan,
                  2.0, 8.0, 1.5, 0.5, 7.0, 6.0],
        "cat": ["a", "b", "a", "c", "a", None, "b", "c", "d", "b", "a", "d"],
    })


def _idx_frames(indices):
    return [(i.col_name, i.to_pandas()) for i in indices]


def _shards(sharded):
    return sharded.collect()


# each op: P (the package's FeatureTable, Table, StringIndex) -> a result
OPS = {
    "size": lambda P: (P.FeatureTable.from_pandas(ratings_df(), 3).size(),
                       len(P.FeatureTable.from_pandas(ratings_df(), 2))),
    "select_drop_rename": lambda P: (
        P.FeatureTable.from_pandas(ratings_df(), 2).select(
            "user", "item").to_pandas(),
        P.FeatureTable.from_pandas(ratings_df(), 2).drop(
            "price").to_pandas(),
        P.FeatureTable.from_pandas(ratings_df(), 2).rename(
            {"user": "u"}).to_pandas()),
    "fillna_dropna": lambda P: (
        P.FeatureTable.from_pandas(ratings_df(), 2).fillna(
            0.0, ["price"]).to_pandas(),
        P.FeatureTable.from_pandas(ratings_df(), 2).dropna(
            ["price"]).to_pandas(),
        P.FeatureTable.from_pandas(ratings_df(), 3).dropna(
            how="all").to_pandas()),
    "median_fill_median": lambda P: (
        P.FeatureTable.from_pandas(cat_df(), 3).median("price").to_pandas(),
        P.FeatureTable.from_pandas(cat_df(), 3).fill_median(
            "price").to_pandas()),
    "clip_log_normalize": lambda P: (
        P.FeatureTable.from_pandas(ratings_df(), 2).fillna(
            0.0, ["price"]).clip(["price"], min=2.0, max=4.0).to_pandas(),
        P.FeatureTable.from_pandas(ratings_df(), 2).fillna(
            0.0, ["price"]).log(["price"]).to_pandas(),
        P.FeatureTable.from_pandas(cat_df(), 3).fill_median(
            "price").normalize(["price"]).to_pandas()),
    "filter_distinct": lambda P: (
        P.FeatureTable.from_pandas(ratings_df(), 2).filter(
            "user == 1").to_pandas(),
        P.FeatureTable.from_pandas(ratings_df(), 2).filter(
            lambda d: d["user"] == 2).to_pandas(),
        P.FeatureTable.from_pandas(pd.concat(
            [cat_df(), cat_df()], ignore_index=True), 4).distinct(
            ).to_pandas()),
    "join": lambda P: P.FeatureTable.from_pandas(ratings_df(), 2).join(
        P.Table.from_pandas(pd.DataFrame({"user": [1, 2, 3],
                                          "age": [20, 30, 40]}), 1),
        on="user").to_pandas(),
    "merge_cols_udf": lambda P: (
        P.FeatureTable.from_pandas(ratings_df(), 1).merge_cols(
            ["user", "item"], "ui").to_pandas(),
        P.FeatureTable.from_pandas(ratings_df(), 2).transform_python_udf(
            "user", "user2", lambda u: u * 2).to_pandas()),
    "gen_string_idx": lambda P: (
        _idx_frames(P.FeatureTable.from_pandas(cat_df(), 3).gen_string_idx(
            ["cat"])),
        _idx_frames(P.FeatureTable.from_pandas(cat_df(), 3).gen_string_idx(
            "cat", freq_limit=3)),
        P.FeatureTable.from_pandas(cat_df(), 3).gen_string_idx(
            "cat")[0].to_dict()),
    "encode_string": lambda P: P.FeatureTable.from_pandas(
        ratings_df(), 2).encode_string(
        "cat", P.FeatureTable.from_pandas(ratings_df(), 2).gen_string_idx(
            "cat")).to_pandas(),
    "category_encode_ind2ind": lambda P: (
        P.FeatureTable.from_pandas(cat_df(), 3).category_encode(
            ["cat"])[0].to_pandas(),
        P.FeatureTable.from_pandas(cat_df(), 3).gen_ind2ind(
            ["cat"], P.FeatureTable.from_pandas(cat_df(), 3).gen_string_idx(
                ["cat"])).to_pandas()),
    "cross_columns": lambda P: P.FeatureTable.from_pandas(
        ratings_df(), 2).fillna("z", ["cat"]).cross_columns(
        [["user", "item"], ["user", "cat", "time"], ["item"]],
        [100, 7, 5]).to_pandas(),
    "add_negative_samples": lambda P: P.FeatureTable.from_pandas(
        pd.DataFrame({"user": np.arange(20) % 5,
                      "item": (np.arange(20) * 3) % 50 + 1}), 4
    ).add_negative_samples(item_size=50, neg_num=2).to_pandas(),
    "add_hist_seq": lambda P: P.FeatureTable.from_pandas(
        ratings_df(), 3).add_hist_seq("user", ["item", "time"],
                                      sort_col="time", min_len=1,
                                      max_len=2).to_pandas(),
    "add_hist_seq_missing_users": lambda P: P.FeatureTable.from_pandas(
        ratings_df().assign(user=[1.0, np.nan, 1.0, 2.0, np.nan, 2.0, 2.0,
                                  3.0]), 2).add_hist_seq(
        "user", ["item"], min_len=1, max_len=3).to_pandas(),
    "add_neg_hist_seq": lambda P: P.FeatureTable.from_pandas(
        ratings_df(), 2).add_hist_seq("user", ["item"], min_len=1,
                                      max_len=4).add_neg_hist_seq(
        30, "item_hist_seq", neg_num=2).to_pandas(),
    "pad_mask": lambda P: (
        P.FeatureTable.from_pandas(hist_df(), 3).pad(
            ["flat", "nested"], seq_len=4).to_pandas(),
        P.FeatureTable.from_pandas(hist_df(), 2).pad(
            ["flat", "nested"], seq_len=2).to_pandas(),
        P.FeatureTable.from_pandas(hist_df(), 3).mask(
            ["flat", "nested"], seq_len=3).to_pandas()),
    "mask_pad_add_length": lambda P: P.FeatureTable.from_pandas(
        hist_df(), 2).mask_pad(padding_cols=["flat"], mask_cols=["flat"],
                               seq_len=4).add_length("nested").to_pandas(),
    "add_feature": lambda P: (
        P.FeatureTable.from_pandas(pd.DataFrame(
            {"item": [1, 2, 3], "hist": [[1, 2], [2, 9], []]}), 2
        ).add_feature(["item", "hist"], P.FeatureTable.from_pandas(
            pd.DataFrame({"item": [1, 2, 3], "cat": [7, 8, 9]}), 1),
            default_value=0).to_pandas(),
        P.FeatureTable.from_pandas(pd.DataFrame({"item": [1, 1, 2]}), 1
                                   ).add_feature(
            ["item"], P.FeatureTable.from_pandas(pd.DataFrame(
                {"item": [1, 2, 1], "cat": [7, 8, 70]}), 1),
            default_value=-1).to_pandas()),
    "to_sharded_arrays": lambda P: (
        _shards(P.FeatureTable.from_pandas(pd.DataFrame(
            {"user": np.arange(8), "item": np.arange(8) * 2,
             "label": [0, 1] * 4}), 3).to_sharded_arrays(
            ["user", "item"], "label")),
        _shards(P.FeatureTable.from_pandas(hist_df(), 2).pad(
            "flat", 3).to_sharded_arrays("flat"))),
}


@pytest.mark.parametrize("mode", ["legacy", "vectorized"])
@pytest.mark.parametrize("op", sorted(OPS))
def test_op_equals_jax(jax_pkg, monkeypatch, op, mode):
    _under(monkeypatch, LEGACY if mode == "legacy" else _fast(4))
    _same(OPS[op](PORT), OPS[op](jax_pkg), op)


def test_cross_columns_with_a_missing_value_raises_as_jax(jax_pkg):
    for P in (PORT, jax_pkg):
        with pytest.raises(Exception, match="expected str instance"):
            P.FeatureTable.from_pandas(ratings_df(), 2).cross_columns(
                [["user", "cat"]], [7]).to_pandas()


def test_parquet_round_trip_equals_jax(jax_pkg, tmp_path):
    pytest.importorskip("pyarrow")
    df = ratings_df().drop(columns=["cat"])
    FeatureTable.from_pandas(df, 2).write_parquet(str(tmp_path / "t"))
    jax_pkg.FeatureTable.from_pandas(df, 2).write_parquet(
        str(tmp_path / "j"))
    _same(FeatureTable.read_parquet(str(tmp_path / "j")).to_pandas(),
          jax_pkg.FeatureTable.read_parquet(str(tmp_path / "t")).to_pandas())
    [idx] = FeatureTable.from_pandas(ratings_df(), 1).gen_string_idx("cat")
    idx.write_parquet(str(tmp_path / "idx"))
    back = jax_pkg.StringIndex.read_parquet(str(tmp_path / "idx"))
    assert back.col_name == "cat" and back.to_dict() == idx.to_dict()


# legacy against vectorized within the port, where JAX's parity tests hold
PARITY = ("size", "select_drop_rename", "fillna_dropna",
          "median_fill_median", "clip_log_normalize", "gen_string_idx",
          "encode_string", "cross_columns", "pad_mask",
          "mask_pad_add_length", "add_feature", "to_sharded_arrays",
          "add_negative_samples")


def _canon_hist(df):
    df = df.sort_values(["user", "time"]).reset_index(drop=True)
    df["item_hist_seq"] = df["item_hist_seq"].map(list)
    df["time_hist_seq"] = df["time_hist_seq"].map(list)
    return df


@pytest.mark.parametrize("workers", [1, 4])
@pytest.mark.parametrize("op", PARITY + ("add_hist_seq",))
def test_vectorized_equals_legacy(monkeypatch, op, workers):
    _under(monkeypatch, LEGACY)
    legacy = OPS[op](PORT)
    _under(monkeypatch, _fast(workers))
    fast = OPS[op](PORT)
    if op == "add_hist_seq":
        legacy, fast = _canon_hist(legacy), _canon_hist(fast)
    # fast pad/mask cells are arrays where legacy ones are lists (JAX's
    # assert_cells_equal compares them as arrays, dtypes included)
    _same(_cells_as_arrays(legacy), _cells_as_arrays(fast), op)


def _cells_as_arrays(result):
    if isinstance(result, pd.DataFrame):
        out = result.copy()
        for c in out.columns:
            if out[c].dtype == object:
                out[c] = out[c].map(lambda v: np.asarray(v)
                                    if isinstance(v, list) else v)
        return out
    if isinstance(result, tuple):
        return tuple(_cells_as_arrays(r) for r in result)
    return result


def test_negatives_repeat_under_any_worker_count(monkeypatch):
    runs = []
    for workers in (0, 1, 4):
        _under(monkeypatch, _fast(workers))
        runs.append(OPS["add_neg_hist_seq"](PORT))
    for r in runs[1:]:
        _same(runs[0], r, "add_neg_hist_seq")


def test_shard_seed_is_content_derived(jax_pkg):
    from analytics_zoo_tpu.friesian.feature import table as jtable
    d = pd.DataFrame({"a": [1, 2, 3], "b": ["x", "y", "z"]})
    assert ttable._shard_seed(d) == ttable._shard_seed(d.copy())
    assert ttable._shard_seed(d) != ttable._shard_seed(d.assign(a=[1, 2, 4]))
    for frame in (d, d[["b"]], d.assign(a=[1, 2, 4])):
        assert ttable._shard_seed(frame) == jtable._shard_seed(frame)


# --------------------------------------------------- bench.py's chain

RECSYS_USERS, RECSYS_ITEMS, RECSYS_SEQ, RECSYS_SHARDS = 600, 300, 8, 8


def raw_df(rows=2000):
    """``bench.py``'s ``_recsys_raw_df`` (bench.py:1624) at ``rows``."""
    rng = np.random.default_rng(11)
    u = rng.integers(0, RECSYS_USERS, rows)
    i = rng.integers(0, RECSYS_ITEMS, rows)
    return pd.DataFrame({
        "user_code": np.char.add("u", u.astype(str)),
        "item_code": np.char.add("i", i.astype(str)),
        "time": rng.integers(0, 100_000, rows),
    })


def chain(FT, df):
    """``bench.py``'s ``_recsys_transforms`` (bench.py:1636)."""
    t = FT.from_pandas(df, RECSYS_SHARDS)
    indices = t.gen_string_idx(["user_code", "item_code"])
    t = t.encode_string(["user_code", "item_code"], indices)
    t = t.rename({"user_code": "user", "item_code": "item"})
    t = t.add_hist_seq("user", ["item"], sort_col="time",
                       min_len=1, max_len=RECSYS_SEQ)
    t = t.add_negative_samples(item_size=RECSYS_ITEMS, item_col="item",
                               neg_num=1)
    t = t.cross_columns([["user", "item"]], [100])
    t = t.mask_pad(padding_cols=["item_hist_seq"],
                   mask_cols=["item_hist_seq"], seq_len=RECSYS_SEQ)
    t = t.add_length("item_hist_seq")
    return t.merge_cols(["user", "item"], "features")


@pytest.fixture(scope="module")
def chains(jax_pkg):
    """Both packages' chain at 2000 rows, legacy and vectorized (4
    workers), and the port's vectorized on 1 worker."""
    out = {}
    saved = {k: os.environ.get(k) for k in LEGACY}
    try:
        for mode, env in (("legacy", LEGACY), ("fast", _fast(4)),
                          ("fast1", _fast(1))):
            os.environ.update(env)
            out[mode] = chain(FeatureTable, raw_df())
            if mode != "fast1":
                out["jax_" + mode] = chain(jax_pkg.FeatureTable, raw_df())
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return out


@pytest.mark.parametrize("mode", ["legacy", "fast"])
def test_bench_chain_equals_jax(chains, mode):
    _same(chains[mode].to_pandas(), chains["jax_" + mode].to_pandas(),
          f"chain {mode}")


def test_bench_chain_across_workers_and_modes(chains):
    fast, legacy = chains["fast"].to_pandas(), chains["legacy"].to_pandas()
    _same(fast, chains["fast1"].to_pandas(), "fast on 1 and 4 workers")
    # a row per visit after a user's first, and one negative each
    users = raw_df()["user_code"].nunique()
    assert len(fast) == len(legacy) == 2 * (2000 - users)
    assert (fast["label"] == 1).sum() == (legacy["label"] == 1).sum()

    def positives(d):
        d = d[d["label"] == 1].copy()
        for c in ("item_hist_seq", "item_hist_seq_mask", "features"):
            d[c] = d[c].map(lambda v: tuple(np.asarray(v).tolist()))
        return d.sort_values(list(d.columns)).reset_index(drop=True)

    _same(positives(fast), positives(legacy), "positive rows")
    for d in (fast, legacy):
        hist = np.stack(d["item_hist_seq"].map(np.asarray).to_list())
        assert hist.shape == (len(d), RECSYS_SEQ)
        neg = d[d["label"] == 0]["features"].map(lambda v: v[1])
        assert neg.between(1, RECSYS_ITEMS).all()


# --------------------------------------------------- the NCF fit it feeds

CHECK_STEPS = 5          # steps of the fit held parameter for parameter


def test_ncf_fit_from_the_table_matches_jax(chains, jax_pkg):
    import jax
    from analytics_zoo_tpu.learn.optimizers import Adam as JAdam
    from analytics_zoo_tpu.models.recommendation import NeuralCF as JNCF

    from analytics_zoo_tpu_torch.convert import (flax_to_state_dict,
                                                 state_dict_to_flax)
    from analytics_zoo_tpu_torch.learn.optimizers import Adam
    from analytics_zoo_tpu_torch.models import NeuralCF
    args = dict(user_count=RECSYS_USERS, item_count=RECSYS_ITEMS,
                class_num=2, user_embed=16, item_embed=16,
                hidden_layers=(32, 16), include_mf=True, mf_embed=16)
    lr, batch = 1e-3, 256

    def pair():
        """JAX's NCF and the port's from JAX's parameters, compiled."""
        jncf = JNCF(**args)
        jncf.compile(optimizer=JAdam(lr),
                     loss="sparse_categorical_crossentropy")
        tncf = NeuralCF(**args)
        tncf.model.module.load_state_dict(flax_to_state_dict(
            jax.device_get(jncf.model.get_weights())))
        tncf.compile(optimizer=Adam(lr),
                     loss="sparse_categorical_crossentropy", device="cpu")
        return (jncf, jncf.model._ensure_estimator(for_training=True),
                tncf, tncf.model._ensure_estimator(for_training=True))

    # the whole epoch, each package fed by its own table's stream
    _, jest, _, test = pair()
    jds = chains["jax_fast"].to_streaming_dataset(["features"], "label",
                                                  prefetch_depth=2)
    tds = chains["fast"].to_streaming_dataset(["features"], "label",
                                              prefetch_depth=2)
    assert tds.n == jds.n and tds.window_shards == jds.window_shards
    want = jest.fit(jds, epochs=1, batch_size=batch)
    got = test.fit(tds, epochs=1, batch_size=batch)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    assert torch.isfinite(torch.as_tensor(got["loss"])).all()

    # the first steps on each table's first rows, in order: every
    # parameter within 1e-5
    def rows(table):
        d = table.to_pandas().iloc[:CHECK_STEPS * batch]
        return (np.stack(d["features"].map(np.asarray).to_list()),
                d["label"].to_numpy())

    jncf, jest, tncf, test = pair()
    jest.fit(rows(chains["jax_fast"]), epochs=1, batch_size=batch,
             shuffle=False)
    test.fit(rows(chains["fast"]), epochs=1, batch_size=batch,
             shuffle=False)
    assert len(test.step_losses) == CHECK_STEPS
    jparams = jax.device_get(jncf.model.get_weights())
    mine = state_dict_to_flax(tncf.model.module.state_dict(), jparams)

    def leaves(tree, path=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, f"{path}/{k}")
        else:
            yield path, np.asarray(tree)

    got_leaves = dict(leaves(mine))
    for path, w in leaves(jparams):
        np.testing.assert_allclose(got_leaves[path], w, rtol=0, atol=1e-5,
                                   err_msg=path)
