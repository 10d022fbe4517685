"""Friesian FeatureTable: recsys tabular feature engineering.

The port's own copy of ``analytics_zoo_tpu/friesian/feature/table.py``
(ref ``pyzoo/zoo/friesian/feature/table.py``, Table/FeatureTable/
StringIndex, and the Scala kernels
``zoo/.../friesian/feature/Utils.scala:27-167``), over the port's
``data/shard.py``: tables are ``HostXShards`` of pandas DataFrames, so
every per-row op is a shard transform on the data pool. Every result is
bitwise the JAX package's on the same input. The output of a feature
pipeline is fixed-shape int/float ndarrays for the estimator's step —
padding/masking (``pad``/``mask``) is the ragged→static bridge.

Two data-plane generations coexist, as in JAX:

* the **fast path** (default): hot transforms are fixed-width numpy kernels
  and aggregations (``gen_string_idx``, ``normalize``, ``median``,
  ``distinct``, ``size``) are map-side combines over shards via
  ``HostXShards.map_reduce_shard`` — nothing gathers the table, so
  ``DISK_n``/``NATIVE_n`` tiers keep their bounded residency end to end;
* the **legacy path** (``ZOO_DATA_VECTORIZE=0``): the original row-at-a-time
  bodies, kept as the bitwise-parity baseline (the tests run both paths on
  the same inputs and compare element for element).

``to_streaming_dataset`` feeds ``fit`` through the port's
``data/dataset.StreamingShardedDataset``.
"""

from __future__ import annotations

import glob
import os
import re
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np

from analytics_zoo_tpu_torch.data.shard import HostXShards


class _Pandas:
    """pandas, imported at its first use: importing the port loads no
    pandas (``data/shard.py``'s rule)."""

    def __getattr__(self, name):
        import pandas
        return getattr(pandas, name)


pd = _Pandas()


def _as_list(x) -> List[str]:
    return [x] if isinstance(x, str) else list(x)


def _fast_enabled() -> bool:
    """``ZOO_DATA_VECTORIZE=0`` restores every legacy body — row-wise
    kernels *and* gather-style aggregations — as one parity/bench toggle."""
    return os.environ.get("ZOO_DATA_VECTORIZE", "1").strip().lower() \
        not in ("0", "false", "off")


def _shard_seed(d: pd.DataFrame) -> int:
    """Deterministic, shard-content-dependent RNG seed: equal-length shards
    with different rows draw different randoms, and reruns reproduce."""
    hashable = d.select_dtypes(exclude=["object"])
    if hashable.shape[1] == 0:
        hashable = d.astype(str)
    h = pd.util.hash_pandas_object(hashable, index=False).to_numpy()
    return int(h.sum() % np.uint64(2**31 - 1))


# ------------------------------------------------------ vectorized kernels

def _pad_one_rowwise(h, seq_len: int):
    """The legacy pad kernel — kept for ragged-inner cells the rectangular
    fill cannot express, and as the ``ZOO_DATA_VECTORIZE=0`` baseline."""
    h = list(h)[:seq_len]
    if h and isinstance(h[0], (list, np.ndarray)):
        inner = len(h[0])
        h = [list(x) for x in h]
        return h + [[0] * inner] * (seq_len - len(h))
    return h + [0] * (seq_len - len(h))


def _pad_cells(col: pd.Series, seq_len: int) -> pd.Series:
    """Pad/truncate every cell of a list column to ``seq_len`` with a single
    preallocated ``(rows, seq_len)`` (or ``(rows, seq_len, inner)``) zeros
    fill per group. Bitwise-matches ``_pad_one_rowwise`` — including the
    quirk that an *empty* cell inside a nested-list column pads flat to
    ``[0]*seq_len`` (it carries no inner width to copy)."""
    values = list(col)
    out: List = [None] * len(values)
    flat_idx: List[int] = []
    nested: Dict[int, List] = {}
    for i, h in enumerate(values):
        if seq_len > 0 and len(h) and isinstance(h[0], (list, np.ndarray)):
            try:
                arr = np.asarray([np.asarray(x) for x in h[:seq_len]])
            except ValueError:
                arr = None
            if arr is None or arr.ndim != 2 or arr.dtype.kind not in "biuf":
                out[i] = _pad_one_rowwise(h, seq_len)  # ragged/odd inner
            else:
                nested.setdefault(arr.shape[1], []).append((i, arr))
        else:
            flat_idx.append(i)
    if flat_idx:
        lens = np.fromiter((min(len(values[i]), seq_len) for i in flat_idx),
                           np.int64, count=len(flat_idx))
        parts = [np.asarray(values[i][:seq_len])
                 for i in flat_idx if min(len(values[i]), seq_len)]
        flat = np.concatenate(parts) if parts else None
        if flat is not None and flat.dtype.kind not in "biuf":
            for i in flat_idx:
                out[i] = _pad_one_rowwise(values[i], seq_len)
        else:
            mat = np.zeros((len(flat_idx), seq_len),
                           dtype=np.int64 if flat is None else flat.dtype)
            if flat is not None:
                mat[np.arange(seq_len) < lens[:, None]] = flat
            for j, i in enumerate(flat_idx):
                out[i] = mat[j]
    for inner, items in nested.items():
        lens = np.fromiter((a.shape[0] for _, a in items), np.int64,
                           count=len(items))
        dtype = np.result_type(*(a.dtype for _, a in items))
        big = np.zeros((len(items), seq_len, inner), dtype=dtype)
        stacked = np.concatenate([a for _, a in items], axis=0)
        big[np.arange(seq_len) < lens[:, None]] = stacked.astype(
            dtype, copy=False)
        for j, (i, _) in enumerate(items):
            out[i] = big[j]
    return pd.Series(out, index=col.index, dtype=object)


def _mask_cells(col: pd.Series, seq_len: int) -> pd.Series:
    lens = np.fromiter((min(len(h), seq_len) for h in col),
                       np.int64, count=len(col))
    mat = (np.arange(seq_len) < lens[:, None]).astype(np.int64)
    return pd.Series(list(mat), index=col.index, dtype=object)


class Table:
    """Base distributed table (ref table.py:35)."""

    def __init__(self, shards: HostXShards):
        self.shards = shards

    # ---------- constructors ----------

    @classmethod
    def from_pandas(cls, df: pd.DataFrame, num_shards: Optional[int] = None):
        n = num_shards or 1
        idx = np.array_split(np.arange(len(df)), max(1, n))
        return cls(HostXShards([df.iloc[i].reset_index(drop=True) for i in idx]))

    @classmethod
    def read_parquet(cls, paths: Union[str, List[str]]):
        """(ref table.py:285)"""
        paths = _as_list(paths)
        files = []
        for p in paths:
            if os.path.isdir(p):
                files += [os.path.join(p, f) for f in sorted(os.listdir(p))
                          if f.endswith(".parquet")]
            else:
                files.append(p)
        dfs = [pd.read_parquet(f) for f in files]
        return cls(HostXShards(dfs))

    @classmethod
    def read_json(cls, paths: Union[str, List[str]], cols=None):
        """(ref table.py:296)"""
        dfs = [pd.read_json(p, lines=True) for p in _as_list(paths)]
        if cols:
            dfs = [d[_as_list(cols)] for d in dfs]
        return cls(HostXShards(dfs))

    # ---------- internals ----------

    def _clone(self, shards: HostXShards) -> "Table":
        return type(self)(shards)

    def _map(self, fn: Callable[[pd.DataFrame], pd.DataFrame],
             op: str = "map") -> "Table":
        return self._clone(self.shards.transform_shard(fn, op=op))

    def to_pandas(self) -> pd.DataFrame:
        dfs = self.shards.collect()
        return pd.concat(dfs, ignore_index=True) if dfs else pd.DataFrame()

    def compute(self) -> "Table":
        """(ref table.py:64 — materialize; shards are eager here)"""
        self.shards.cache()
        return self

    @property
    def df(self) -> pd.DataFrame:
        return self.to_pandas()

    @property
    def schema(self):
        # shard 0 only — collect() would re-read every DISK_n spill file
        return self.shards.first().dtypes

    def size(self) -> int:
        """(ref table.py:79)"""
        if _fast_enabled():
            return int(self.shards.map_reduce_shard(
                len, lambda a, b: a + b, op="size"))
        return sum(len(s) for s in self.shards.collect())

    def __len__(self):
        return self.size()

    # ---------- row/column ops ----------

    def select(self, *cols) -> "Table":
        cols = [c for group in cols for c in _as_list(group)]
        return self._map(lambda d: d[cols], op="select")

    def drop(self, *cols) -> "Table":
        """(ref table.py:94)"""
        drop = [c for group in cols for c in _as_list(group)]
        return self._map(lambda d: d.drop(columns=drop), op="drop")

    def fillna(self, value, columns: Optional[Sequence[str]]) -> "Table":
        """(ref table.py:106)"""
        def fill(d):
            d = d.copy()
            cols = _as_list(columns) if columns else list(d.columns)
            d[cols] = d[cols].fillna(value)
            return d
        return self._map(fill, op="fillna")

    def dropna(self, columns=None, how="any", thresh=None) -> "Table":
        """(ref table.py:132)"""
        kw = {"thresh": thresh} if thresh is not None else {"how": how}
        return self._map(lambda d: d.dropna(
            subset=_as_list(columns) if columns else None,
            **kw).reset_index(drop=True), op="dropna")

    def distinct(self) -> "Table":
        """(ref table.py:148). Fast path: per-shard dedup, then pairwise
        concat+dedup in shard order — same first-occurrence rows and order
        as the gathered dedup, without materializing the table."""
        if _fast_enabled():
            full = self.shards.map_reduce_shard(
                lambda d: d.drop_duplicates(),
                lambda a, b: pd.concat([a, b],
                                       ignore_index=True).drop_duplicates(),
                op="distinct").reset_index(drop=True)
        else:
            full = self.to_pandas().drop_duplicates().reset_index(drop=True)
        n = max(1, self.shards.num_partitions())
        idx = np.array_split(np.arange(len(full)), n)
        return self._clone(HostXShards(
            [full.iloc[i].reset_index(drop=True) for i in idx]))

    def filter(self, condition: Union[str, Callable]) -> "Table":
        """(ref table.py:155; condition is a pandas query string or a
        row-mask callable)"""
        if callable(condition):
            return self._map(
                lambda d: d[condition(d)].reset_index(drop=True), op="filter")
        return self._map(lambda d: d.query(condition).reset_index(drop=True),
                         op="filter")

    def rename(self, columns: Dict[str, str]) -> "Table":
        """(ref table.py:252)"""
        return self._map(lambda d: d.rename(columns=columns), op="rename")

    def clip(self, columns, min=None, max=None) -> "Table":
        """(ref table.py:166)"""
        cols = _as_list(columns)

        def f(d):
            d = d.copy()
            d[cols] = d[cols].clip(lower=min, upper=max)
            return d
        return self._map(f, op="clip")

    def log(self, columns, clipping: bool = True) -> "Table":
        """log(x + 1), clipping negatives to 0 first (ref table.py:188)"""
        cols = _as_list(columns)

        def f(d):
            d = d.copy()
            for c in cols:
                v = d[c].astype(float)
                if clipping:
                    v = v.clip(lower=0)
                d[c] = np.log1p(v)
            return d
        return self._map(f, op="log")

    def _medians(self, cols: List[str]) -> Dict[str, float]:
        """Per-column medians. Fast path gathers only the non-null *column
        values* (not the table) as per-shard partials."""
        if _fast_enabled():
            parts = self.shards.map_reduce_shard(
                lambda d: {c: d[c].dropna().to_numpy(dtype=float)
                           for c in cols},
                lambda a, b: {c: np.concatenate([a[c], b[c]]) for c in cols},
                op="median")
            return {c: (float(np.median(parts[c])) if parts[c].size
                        else float("nan")) for c in cols}
        full = self.to_pandas()
        return {c: full[c].median() for c in cols}

    def median(self, columns) -> "Table":
        """table of (column, median) (ref table.py:223)"""
        cols = _as_list(columns)
        meds = self._medians(cols)
        med = pd.DataFrame({"column": cols,
                            "median": [meds[c] for c in cols]})
        return Table.from_pandas(med, 1)

    def fill_median(self, columns) -> "Table":
        """(ref table.py:206)"""
        cols = _as_list(columns)
        meds = self._medians(cols)

        def f(d):
            d = d.copy()
            for c in cols:
                d[c] = d[c].fillna(meds[c])
            return d
        return self._map(f, op="fill_median")

    def merge_cols(self, columns, target: str) -> "Table":
        """merge columns into one array column (ref table.py:240; already a
        single numpy conversion per shard)"""
        cols = _as_list(columns)

        def f(d):
            d = d.copy()
            d[target] = d[cols].values.tolist()
            return d.drop(columns=cols)
        return self._map(f, op="merge_cols")

    def transform_python_udf(self, in_col, out_col, udf_func) -> "Table":
        """(ref table.py:521 — the explicit row-wise escape hatch)"""
        def f(d):
            d = d.copy()
            d[out_col] = d[in_col].map(udf_func)
            return d
        return self._map(f, op="python_udf")

    def join(self, table: "Table", on=None, how="inner") -> "Table":
        """(ref table.py:534; hash-join via the gathered right side —
        the broadcast-join analog)"""
        right = table.to_pandas()
        on = _as_list(on) if on is not None else None
        return self._map(lambda d: d.merge(right, on=on, how=how), op="join")

    def show(self, n: int = 20, truncate: bool = True):
        """(ref table.py:268). Streams shards until ``n`` rows — never
        materializes (or re-reads the spill files of) the whole table."""
        heads, got = [], 0
        for s in self.shards._iter_shards():
            heads.append(s.head(n - got))
            got += len(heads[-1])
            if got >= n:
                break
        print(pd.concat(heads, ignore_index=True) if heads
              else pd.DataFrame())

    def write_parquet(self, path: str, mode: str = "overwrite"):
        """(ref table.py:279). ``overwrite`` clears stale ``part-*.parquet``
        from a previous larger write; ``append`` continues the part
        numbering; anything else raises."""
        if mode not in ("overwrite", "append"):
            raise ValueError(
                f"write_parquet mode must be 'overwrite' or 'append', "
                f"got {mode!r}")
        os.makedirs(path, exist_ok=True)
        existing = sorted(glob.glob(os.path.join(path, "part-*.parquet")))
        if mode == "overwrite":
            for f in existing:
                os.remove(f)
            start = 0
        else:
            nums = [int(m.group(1)) for f in existing
                    if (m := re.search(r"part-(\d+)\.parquet$", f))]
            start = max(nums, default=-1) + 1
        for i, shard in enumerate(self.shards._iter_shards()):
            shard.to_parquet(
                os.path.join(path, f"part-{start + i:05d}.parquet"))

    def col_names(self) -> List[str]:
        # shard 0 only (satellite: collect() re-read every spill file)
        return list(self.shards.first().columns)


class FeatureTable(Table):
    """(ref table.py:282 FeatureTable)"""

    # ---------- categorical encoding ----------

    def gen_string_idx(self, columns, freq_limit: Optional[int] = None
                       ) -> List["StringIndex"]:
        """Build per-column StringIndex: value → 1-based id ordered by
        frequency desc (ref table.py:326 + Utils.scala; ids of frequent
        values are small so embedding tables stay cache-friendly).
        ``freq_limit`` drops values seen fewer times.

        Fast path: merged per-shard ``value_counts`` kept in first-appearance
        order, then one stable sort — ties break by first appearance, same
        as the gathered hashtable order, so both paths agree."""
        cols = _as_list(columns)
        if _fast_enabled():
            def mapper(d):
                out = {}
                for c in cols:
                    s = d[c].dropna()
                    out[c] = s.value_counts().reindex(pd.unique(s))
                return out

            def reducer(a, b):
                out = {}
                for c in cols:
                    merged = a[c].add(b[c], fill_value=0)
                    new = b[c].index[~b[c].index.isin(a[c].index)]
                    out[c] = merged.reindex(a[c].index.append(new))
                return out

            counts = self.shards.map_reduce_shard(mapper, reducer,
                                                  op="gen_string_idx")
            vcs = {c: counts[c].astype(np.int64).sort_values(
                ascending=False, kind="stable") for c in cols}
        else:
            full = self.to_pandas()
            vcs = {c: full[c].dropna().value_counts() for c in cols}
        out = []
        for c in cols:
            vc = vcs[c]
            if freq_limit:
                vc = vc[vc >= int(freq_limit)]
            idx_df = pd.DataFrame({
                c: vc.index,
                "id": np.arange(1, len(vc) + 1, dtype=np.int64)})
            out.append(StringIndex(HostXShards([idx_df]), c))
        return out

    def encode_string(self, columns, indices) -> "FeatureTable":
        """Replace string values by their index id; unseen → 0
        (ref table.py:299)."""
        cols = _as_list(columns)
        if not isinstance(indices, list):
            indices = [indices]
        maps = []
        for ind in indices:
            if isinstance(ind, StringIndex):
                maps.append(ind.to_dict())
            else:
                maps.append(dict(ind))

        def f(d):
            d = d.copy()
            for c, m in zip(cols, maps):
                d[c] = d[c].map(m).fillna(0).astype(np.int64)
            return d
        return self._map(f, op="encode_string")

    def gen_ind2ind(self, cols, indices) -> "FeatureTable":
        """Table of the indexed projection of ``cols`` (ref table.py:356)."""
        projected = self.encode_string(cols, indices).select(cols)
        return FeatureTable(projected.shards)

    def cross_columns(self, crossed_columns: List[List[str]],
                      bucket_sizes: List[int]) -> "FeatureTable":
        """Hash-cross column groups into buckets; new column is named
        ``a_b`` (ref table.py:371, the wide-and-deep cross features)."""
        def f(d):
            d = d.copy()
            for group, size in zip(crossed_columns, bucket_sizes):
                name = "_".join(group)
                # JAX's row-wise ``agg("_".join, axis=1)`` strings, joined
                # column-wise (the same strings, so the same hashes); a
                # missing value takes the row-wise join, which raises as
                # JAX's does
                cols = [d[c].astype(str) for c in group]
                if any(c.isna().any() for c in cols):
                    joined = d[list(group)].astype(str).agg("_".join, axis=1)
                else:
                    joined = cols[0].str.cat(cols[1:], sep="_") \
                        if len(cols) > 1 else cols[0]
                # vectorized, deterministic across runs and hosts
                d[name] = (pd.util.hash_pandas_object(joined, index=False)
                           % np.uint64(size)).astype(np.int64)
            return d
        return self._map(f, op="cross_columns")

    def category_encode(self, columns, freq_limit=None):
        indices = self.gen_string_idx(columns, freq_limit)
        return self.encode_string(columns, indices), indices

    # ---------- numeric ----------

    def normalize(self, columns) -> "FeatureTable":
        """Global min-max scale to [0,1] (ref table.py:382 MinMaxScaler).
        Fast path: per-shard (min, max) partials, NaN-skipping combine."""
        cols = _as_list(columns)
        if _fast_enabled():
            ext = self.shards.map_reduce_shard(
                lambda d: {c: (d[c].min(), d[c].max()) for c in cols},
                lambda a, b: {c: (np.fmin(a[c][0], b[c][0]),
                                  np.fmax(a[c][1], b[c][1])) for c in cols},
                op="normalize")
            lo = {c: float(ext[c][0]) for c in cols}
            hi = {c: float(ext[c][1]) for c in cols}
        else:
            full = self.to_pandas()
            lo = {c: float(full[c].min()) for c in cols}
            hi = {c: float(full[c].max()) for c in cols}

        def f(d):
            d = d.copy()
            for c in cols:
                span = hi[c] - lo[c]
                d[c] = 0.0 if span == 0 else (d[c] - lo[c]) / span
            return d
        return self._map(f, op="normalize")

    # ---------- recsys sequence features ----------

    def add_negative_samples(self, item_size: int, item_col: str = "item",
                             label_col: str = "label", neg_num: int = 1
                             ) -> "FeatureTable":
        """Each row becomes 1 positive (label 1) + ``neg_num`` negatives with
        a random different item (label 0) (ref table.py:429; item ids are
        1-based like the string-index output). The RNG seed derives from the
        shard *content* (``_shard_seed``), so parallel execution draws the
        same negatives as serial."""
        def f(d):
            rng = np.random.RandomState(_shard_seed(d))
            rows = [d.assign(**{label_col: np.int64(1)})]
            for _ in range(neg_num):
                neg = d.copy()
                rand = rng.randint(1, item_size, size=len(d))
                # resample collisions with the positive item
                pos = d[item_col].to_numpy()
                coll = rand >= pos  # shift to skip the positive id
                rand = np.where(coll, rand + 1, rand)
                neg[item_col] = rand
                neg[label_col] = np.int64(0)
                rows.append(neg)
            return pd.concat(rows, ignore_index=True)
        return self._map(f, op="negative_samples")

    def _add_hist_seq_legacy(self, user_col, cols, sort_col, min_len,
                             max_len) -> "FeatureTable":
        full = self.to_pandas().sort_values([user_col, sort_col])
        out_rows = []
        for _, grp in full.groupby(user_col, sort=False):
            vals = {c: grp[c].tolist() for c in cols}
            for i in range(len(grp)):
                if i < min_len:
                    continue
                row = grp.iloc[i].to_dict()
                for c in cols:
                    row[f"{c}_hist_seq"] = vals[c][max(0, i - max_len):i]
                out_rows.append(row)
        out = pd.DataFrame(out_rows)
        return FeatureTable.from_pandas(
            out, self.shards.num_partitions()) if len(out) else \
            FeatureTable(HostXShards([out]))

    def add_hist_seq(self, user_col: str, cols, sort_col: str = "time",
                     min_len: int = 1, max_len: int = 100) -> "FeatureTable":
        """Per user (sorted by ``sort_col``) attach the preceding visit
        history as ``<col>_hist_seq`` lists; rows with history shorter than
        ``min_len`` are dropped (ref table.py:443).

        Fast path: reshuffle by ``user_col`` (``partition_by``, so each
        user's rows land in one shard), then a per-shard sort + groupby with
        array-slice history building — no global gather, no per-row
        ``iloc``/``to_dict``. Row order is per-partition rather than global,
        which training never depends on (shards are shuffled downstream)."""
        cols = _as_list(cols)
        if not _fast_enabled():
            return self._add_hist_seq_legacy(user_col, cols, sort_col,
                                             min_len, max_len)
        parts = self.shards.partition_by(user_col,
                                         self.shards.num_partitions())

        def empty_like(d):
            out = d.iloc[0:0].copy()
            for c in cols:
                out[f"{c}_hist_seq"] = pd.Series([], dtype=object)
            return out

        def per_shard(d):
            """JAX's per-user loop (a stable sort, then ``groupby`` without
            the missing users) as one pass: each user's rows are
            contiguous, so a row's rank in its user and its user's first
            row give the same kept rows (rank >= min_len), in the same
            order, with the same history slices."""
            d2 = d.sort_values([user_col, sort_col], kind="stable")
            d2 = d2[d2[user_col].notna()]
            keys = d2[user_col].to_numpy()
            n = len(keys)
            first = np.ones(n, bool)
            first[1:] = keys[1:] != keys[:-1]
            start = np.flatnonzero(first)[np.cumsum(first) - 1]
            pos = np.flatnonzero(np.arange(n) - start >= min_len)
            if not len(pos):
                return empty_like(d)
            out = d2.iloc[pos].reset_index(drop=True)
            lo = np.maximum(start[pos], pos - max_len)
            for c in cols:
                a = d2[c].to_numpy()
                out[f"{c}_hist_seq"] = pd.Series(
                    [a[i:j].tolist() for i, j in zip(lo, pos)],
                    index=out.index, dtype=object)
            return out

        return FeatureTable(parts.transform_shard(per_shard,
                                                  op="add_hist_seq"))

    def add_neg_hist_seq(self, item_size: int, item_history_col: str,
                         neg_num: int) -> "FeatureTable":
        """For every history list attach ``neg_num`` random negative lists
        of the same length as ``neg_<col>`` (ref table.py:458)."""
        def f(d):
            rng = np.random.RandomState(_shard_seed(d))
            d = d.copy()
            d[f"neg_{item_history_col}"] = [
                [[int(x) for x in rng.randint(1, item_size + 1, size=len(h))]
                 for _ in range(neg_num)]
                for h in d[item_history_col]]
            return d
        return self._map(f, op="neg_hist_seq")

    def _pad_legacy(self, cols, seq_len) -> "FeatureTable":
        def f(d):
            d = d.copy()
            for c in cols:
                d[c] = d[c].map(lambda h: _pad_one_rowwise(h, seq_len))
            return d
        return self._map(f, op="pad")

    def pad(self, padding_cols, seq_len: int = 100) -> "FeatureTable":
        """Pad/truncate list columns to ``seq_len`` with 0
        (ref table.py:473; the ragged→static-shape bridge)."""
        cols = _as_list(padding_cols)
        if not _fast_enabled():
            return self._pad_legacy(cols, seq_len)

        def f(d):
            d = d.copy()
            for c in cols:
                d[c] = _pad_cells(d[c], seq_len)
            return d
        return self._map(f, op="pad")

    def _mask_legacy(self, cols, seq_len) -> "FeatureTable":
        def f(d):
            d = d.copy()
            for c in cols:
                d[f"{c}_mask"] = d[c].map(
                    lambda h: [1] * min(len(h), seq_len) +
                              [0] * max(seq_len - len(h), 0))
            return d
        return self._map(f, op="mask")

    def mask(self, mask_cols, seq_len: int = 100) -> "FeatureTable":
        """Attach ``<col>_mask`` 0/1 validity vectors (ref table.py:485);
        int64 rows of one broadcast comparison on the fast path."""
        cols = _as_list(mask_cols)
        if not _fast_enabled():
            return self._mask_legacy(cols, seq_len)

        def f(d):
            d = d.copy()
            for c in cols:
                d[f"{c}_mask"] = _mask_cells(d[c], seq_len)
            return d
        return self._map(f, op="mask")

    def mask_pad(self, padding_cols, mask_cols, seq_len: int = 100
                 ) -> "FeatureTable":
        """(ref table.py:508)"""
        return self.mask(mask_cols, seq_len).pad(padding_cols, seq_len)

    def add_length(self, col_name: str) -> "FeatureTable":
        """Attach ``<col>_length`` (ref table.py:497)."""
        if not _fast_enabled():
            def g(d):
                d = d.copy()
                d[f"{col_name}_length"] = d[col_name].map(len)
                return d
            return self._map(g, op="add_length")

        def f(d):
            d = d.copy()
            d[f"{col_name}_length"] = np.fromiter(
                (len(h) for h in d[col_name]), np.int64, count=len(d))
            return d
        return self._map(f, op="add_length")

    def _add_feature_legacy(self, cols, lookup,
                            default_value) -> "FeatureTable":
        def get(v):
            if isinstance(v, (list, np.ndarray)):
                return [lookup.get(x, default_value) for x in v]
            return lookup.get(v, default_value)

        def f(d):
            d = d.copy()
            for c in cols:
                d[f"{c}_feature"] = d[c].map(get)
            return d
        return self._map(f, op="add_feature")

    def add_feature(self, item_cols, feature_tbl: "FeatureTable",
                    default_value) -> "FeatureTable":
        """Map item ids (scalars or lists) through a (key→feature) lookup
        table; the lookup's first column is the key, second the feature
        (ref table.py:548). Fast path: one sorted-key ``searchsorted`` take
        per column (list cells concatenated, looked up once, and split back
        by offsets)."""
        cols = _as_list(item_cols)
        lookup_df = feature_tbl.to_pandas()
        key_c, val_c = lookup_df.columns[:2]
        # dict first so duplicate keys resolve last-wins, like the legacy map
        lookup = dict(zip(lookup_df[key_c].tolist(),
                          lookup_df[val_c].tolist()))
        if not _fast_enabled():
            return self._add_feature_legacy(cols, lookup, default_value)
        keys = np.asarray(list(lookup.keys()))
        vals = np.asarray(list(lookup.values()))
        if keys.dtype.kind not in "biuf" or vals.dtype.kind not in "biuf":
            return self._add_feature_legacy(cols, lookup, default_value)
        order = np.argsort(keys, kind="stable")
        sk, sv = keys[order], vals[order]

        def take(arr):
            arr = np.asarray(arr)
            if not len(sk):
                return np.full(arr.shape, default_value)
            pos = np.clip(np.searchsorted(sk, arr), 0, len(sk) - 1)
            hit = sk[pos] == arr
            return np.where(hit, sv[pos], default_value)

        def f(d):
            d = d.copy()
            for c in cols:
                col = d[c]
                listy = [isinstance(v, (list, np.ndarray)) for v in col]
                if not any(listy):
                    d[f"{c}_feature"] = take(col.to_numpy())
                elif all(listy):
                    lens = np.fromiter((len(v) for v in col), np.int64,
                                       count=len(col))
                    flat = np.concatenate(
                        [np.asarray(v) for v in col]) if lens.sum() \
                        else np.zeros(0, sk.dtype)
                    looked = take(flat)
                    cells = [a.tolist() for a in np.split(
                        looked, np.cumsum(lens)[:-1])]
                    d[f"{c}_feature"] = pd.Series(cells, index=d.index,
                                                  dtype=object)
                else:
                    cells = [take(np.asarray(v)).tolist()
                             if isinstance(v, (list, np.ndarray))
                             else take(np.asarray([v]))[0].item()
                             for v in col]
                    d[f"{c}_feature"] = pd.Series(cells, index=d.index,
                                                  dtype=object)
            return d
        return self._map(f, op="add_feature")

    # ---------- model feed ----------

    def _to_sharded_arrays_legacy(self, cols, label_col):
        def f(d):
            xs = [np.stack(d[c].map(np.asarray).to_list())
                  if d[c].map(lambda v: isinstance(v, (list, np.ndarray))).any()
                  else d[c].to_numpy()
                  for c in cols]
            out = {"x": xs[0] if len(xs) == 1 else xs}
            if label_col:
                out["y"] = d[label_col].to_numpy()
            return out
        return self.shards.transform_shard(f, op="to_arrays")

    def to_sharded_arrays(self, feature_cols, label_col: Optional[str] = None):
        """{'x': [...], 'y': ...} ndarray shards for Estimator.fit; the fast
        path emits C-contiguous arrays ready for ``pad_to_rung``."""
        cols = _as_list(feature_cols)
        if not _fast_enabled():
            return self._to_sharded_arrays_legacy(cols, label_col)

        def f(d):
            xs = []
            for c in cols:
                col = d[c]
                if col.dtype == object and any(
                        isinstance(v, (list, np.ndarray)) for v in col):
                    arr = np.stack([np.asarray(v) for v in col])
                else:
                    arr = col.to_numpy()
                xs.append(np.ascontiguousarray(arr))
            out = {"x": xs[0] if len(xs) == 1 else xs}
            if label_col:
                out["y"] = np.ascontiguousarray(d[label_col].to_numpy())
            return out
        return self.shards.transform_shard(f, op="to_arrays")

    def to_streaming_dataset(self, feature_cols, label_col=None,
                             prefetch_depth: Optional[int] = None):
        """Feed ``Estimator.fit`` straight from the (possibly tiered) raw
        DataFrame shards: each window's pandas→numpy conversion runs on the
        data pool concurrently with device steps (``prefetch_depth``
        windows in flight; docs/data_plane.md)."""
        from analytics_zoo_tpu_torch.data.dataset import \
            StreamingShardedDataset
        return StreamingShardedDataset(self.shards,
                                       feature_cols=_as_list(feature_cols),
                                       label_cols=label_col,
                                       prefetch_depth=prefetch_depth)


class StringIndex(Table):
    """value→id mapping table (ref table.py:586)."""

    def __init__(self, shards: HostXShards, col_name: str):
        super().__init__(shards)
        self.col_name = col_name

    def _clone(self, shards):
        return StringIndex(shards, self.col_name)

    @classmethod
    def read_parquet(cls, paths, col_name: Optional[str] = None):
        """(ref table.py:596 — col name = the non-'id' column)"""
        t = Table.read_parquet(paths)
        cols = [c for c in t.col_names() if c != "id"]
        return cls(t.shards, col_name or cols[0])

    def to_dict(self) -> Dict:
        df = self.to_pandas()
        return dict(zip(df[self.col_name], df["id"]))

    def size(self) -> int:
        return super().size()
