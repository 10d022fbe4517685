"""XShards — a partitioned collection of host objects.

The port's own copy of ``analytics_zoo_tpu/data/shard.py`` (ref
pyzoo/zoo/orca/data/shard.py:25-485): shards are numpy-dict shards,
pandas DataFrames or any Python objects, held in this process.

- **Tiers** (ref FeatureSet DRAM/PMEM/DISK_n, FeatureSet.scala:556):
  "DRAM" keeps shards as live objects; "DISK_n" pickles every shard to a
  spill file and keeps 1 of every n resident, reading the rest on demand;
  "NATIVE_n" keeps them in the C++ arena (``data/native_store.py``), about
  1/n of their bytes resident, spilling the rest. The tier comes from
  ``OrcaContext.train_data_store`` unless given. A "NATIVE_n" store whose
  library g++ cannot build raises ``NativeStoreCompileError``: it never
  quietly becomes "DISK_n".
- **The data pool**: shard transforms run on a shared thread pool
  (``ZOO_DATA_WORKERS``, default ``min(8, cpu count)``; <= 1 runs them in
  the caller's thread), in shard order, with a bounded in-flight window
  (workers + 2) so a spill store takes transformed shards as they stream
  out; a failing shard raises :class:`ShardTransformError` with its
  index. ``LAST_RUN_STATS[op]`` holds the last run's shard count, workers
  and in-flight peak. Every run is observed on the telemetry registry as
  JAX's is: ``zoo_data_transform_seconds{op}`` (a histogram of a run's
  wall seconds) and ``zoo_data_workers_busy`` (the shard tasks in
  flight). ``OP_TOTALS[op]`` (``[calls, seconds]``) and ``workers_busy``
  are views of them.
- **The default shard count** is the active context's ``num_devices``
  (one without a context), as in JAX.

API parity (the reference's method names): ``partition``,
``from_records``, ``transform_shard``, ``map_reduce_shard``, ``first``,
``collect``, ``num_partitions``, ``cache``/``uncache``, ``repartition``
(JAX's row-range plan), ``partition_by`` (``pd.util.hash_pandas_object``,
so the buckets equal JAX's), ``unique``, ``split``, ``zip``, ``__len__``,
``__getitem__``, ``save_pickle``/``load_pickle`` (the same files as
JAX's, readable by either package), ``to_pandas``, ``SharedValue`` and the
``SparkXShards`` alias. pandas is imported only where a DataFrame is
handled: a shard is a DataFrame only if pandas is already loaded.
"""

from __future__ import annotations

import collections
import collections.abc
import functools
import glob
import os
import pickle
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np

from analytics_zoo_tpu_torch.common.context import (OrcaContext,
                                                    active_context,
                                                    check_tier)


def _is_dataframe(x) -> bool:
    """True for a pandas DataFrame; never imports pandas (no DataFrame
    exists unless pandas is loaded)."""
    pd = sys.modules.get("pandas")
    return pd is not None and isinstance(x, pd.DataFrame)


def _flatten(tree) -> Tuple[list, Callable[[list], Any]]:
    """(leaves of nested dicts, tuples and lists, a function that rebuilds
    the tree from new leaves)."""
    if isinstance(tree, dict):
        keys = list(tree)
        parts = [_flatten(tree[k]) for k in keys]
    elif isinstance(tree, (tuple, list)):
        keys = None
        parts = [_flatten(v) for v in tree]
    else:
        return [tree], lambda leaves: leaves[0]
    sizes = [len(p[0]) for p in parts]
    leaves = [leaf for p in parts for leaf in p[0]]

    def rebuild(new):
        out, at = [], 0
        for (_, fn), n in zip(parts, sizes):
            out.append(fn(new[at:at + n]))
            at += n
        if keys is not None:
            return dict(zip(keys, out))
        return type(tree)(out)

    return leaves, rebuild


# --------------------------------------------------------------- data pool

DEFAULT_DATA_WORKERS = min(8, os.cpu_count() or 1)

_POOL_LOCK = threading.Lock()
_POOL: Optional[ThreadPoolExecutor] = None
_POOL_SIZE = 0

#: per-op stats of the most recent run; writes hold _STATS_LOCK
_STATS_LOCK = threading.Lock()
LAST_RUN_STATS: Dict[str, Dict[str, Any]] = {}


def _data_metrics():
    from analytics_zoo_tpu_torch.common import telemetry
    reg = telemetry.get_registry()
    return (reg.histogram("zoo_data_transform_seconds",
                          "wall seconds per data-plane op", ("op",)),
            reg.gauge("zoo_data_workers_busy",
                      "in-flight shard tasks in the data pool"))


class _OpTotals(collections.abc.Mapping):
    """``OP_TOTALS[op] -> [calls, wall seconds]``: a view of the
    registry's ``zoo_data_transform_seconds{op}`` series (count and sum);
    ``pop(op)`` reads one and drops it."""

    def _series(self) -> Dict[str, Any]:
        hist, _ = _data_metrics()
        return {c.labelvalues[0]: c for c in hist.children()}

    def __getitem__(self, op: str) -> List[float]:
        c = self._series()[op]
        return [c.count, c.sum]

    def __iter__(self):
        return iter(self._series())

    def __len__(self) -> int:
        return len(self._series())

    def pop(self, op: str) -> List[float]:
        hist, _ = _data_metrics()
        with hist._lock:
            c = hist._children.pop((op,))
        return [c.count, c.sum]


#: op -> [calls, wall seconds] over every run (a view of the histogram)
OP_TOTALS = _OpTotals()


def __getattr__(name: str):
    # ``workers_busy``: shard tasks in flight on the pool right now (a
    # view of the registry's gauge)
    if name == "workers_busy":
        return int(_data_metrics()[1].value)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def data_workers() -> int:
    """Worker count for shard transforms. ``ZOO_DATA_WORKERS`` <= 1 means
    serial execution in the caller's thread (the parity baseline)."""
    raw = os.environ.get("ZOO_DATA_WORKERS", "").strip()
    if raw:
        try:
            return int(raw)
        except ValueError:
            pass
    return DEFAULT_DATA_WORKERS


def get_data_pool() -> ThreadPoolExecutor:
    """The shared executor for shard transforms and streaming prefetch:
    at least one thread even when ``ZOO_DATA_WORKERS=0``, so prefetch
    still overlaps the device; rebuilt when the knob changes."""
    global _POOL, _POOL_SIZE
    n = max(1, data_workers())
    with _POOL_LOCK:
        if _POOL is None or _POOL_SIZE != n:
            if _POOL is not None:
                _POOL.shutdown(wait=False)
            _POOL = ThreadPoolExecutor(max_workers=n,
                                       thread_name_prefix="zoo-data")
            _POOL_SIZE = n
        return _POOL


def record_op(op: str, seconds: float) -> None:
    """Observe one run of ``op`` on ``zoo_data_transform_seconds``."""
    _data_metrics()[0].labels(op).observe(seconds)


def _set_busy(n: int) -> None:
    _data_metrics()[1].set(n)


class ShardTransformError(RuntimeError):
    """A shard function failed; carries the failing shard's index."""

    def __init__(self, shard_index: int, op: str, cause: BaseException):
        super().__init__(
            f"shard {shard_index} failed in {op}: {type(cause).__name__}: "
            f"{cause}")
        self.shard_index = shard_index
        self.op = op


def _map_shards(fn: Callable[[Any], Any], n: int,
                get: Callable[[int], Any], op: str):
    """Ordered map of ``fn`` over ``get(0..n-1)``: on the data pool when
    ``ZOO_DATA_WORKERS`` > 1, serial otherwise. Yields in shard order with
    at most workers + 2 shards in flight; shards are fetched on the
    calling thread (stores need no lock) and transformed on the pool."""
    t0 = time.perf_counter()
    workers = data_workers()
    stats = {"op": op, "shards": n, "workers": max(1, workers),
             "in_flight_peak": 0}
    try:
        if workers <= 1 or n <= 1:
            for i in range(n):
                stats["in_flight_peak"] = max(stats["in_flight_peak"], 1)
                try:
                    yield fn(get(i))
                except ShardTransformError:
                    raise
                except Exception as e:
                    raise ShardTransformError(i, op, e) from e
            return
        pool = get_data_pool()
        window = workers + 2
        pending: collections.deque = collections.deque()
        nxt = 0
        while nxt < n or pending:
            while nxt < n and len(pending) < window:
                pending.append((nxt, pool.submit(fn, get(nxt))))
                nxt += 1
                stats["in_flight_peak"] = max(stats["in_flight_peak"],
                                              len(pending))
                _set_busy(len(pending))
            i, fut = pending.popleft()
            try:
                yield fut.result()
            except ShardTransformError:
                raise
            except Exception as e:
                raise ShardTransformError(i, op, e) from e
            _set_busy(len(pending))
    finally:
        _set_busy(0)
        record_op(op, time.perf_counter() - t0)
        with _STATS_LOCK:
            LAST_RUN_STATS[op] = dict(stats)


# ------------------------------------------------------------------ stores

def _make_store(shards: Iterable[Any], tier: str):
    """The store of ``tier``: the native arena for "NATIVE_n", else a DRAM
    list or spill files."""
    tier = check_tier(tier)
    if tier.startswith("NATIVE_"):
        from analytics_zoo_tpu_torch.data.native_store import \
            NativeShardStore
        return NativeShardStore(
            shards, keep_fraction_denom=max(1, int(tier.split("_", 1)[1])))
    return _ShardStore(shards, tier)


class _ShardStore:
    """Shard storage: a DRAM list, or spill files keeping 1 of every n
    shards resident. Takes its input one shard at a time, so transformed
    shards spill as they arrive."""

    def __init__(self, shards: Iterable[Any], tier: str = "DRAM"):
        self.tier = check_tier(tier)
        if self.tier == "DRAM":
            self._mem = list(shards)
            self._paths = None
            return
        keep = max(1, int(self.tier.split("_", 1)[1]))
        self._dir = tempfile.mkdtemp(prefix="zoo_tpu_shards_")
        self._paths = []
        self._mem = []
        for i, s in enumerate(shards):
            p = os.path.join(self._dir, f"shard-{i:05d}.pkl")
            with open(p, "wb") as fh:
                pickle.dump(s, fh, protocol=pickle.HIGHEST_PROTOCOL)
            self._paths.append(p)
            self._mem.append(s if i % keep == 0 else None)

    def __len__(self):
        return len(self._mem)

    def get(self, i: int):
        s = self._mem[i]
        if s is None and self._paths is not None:
            with open(self._paths[i], "rb") as fh:
                s = pickle.load(fh)
        return s

    def all(self):
        return [self.get(i) for i in range(len(self))]


# ----------------------------------------------------------------- XShards

class XShards:
    """Abstract base (ref shard.py:25-70)."""

    def transform_shard(self, func: Callable, *args) -> "XShards":
        raise NotImplementedError

    def collect(self) -> List[Any]:
        raise NotImplementedError

    def num_partitions(self) -> int:
        raise NotImplementedError

    @classmethod
    def load_pickle(cls, path: str, minPartitions: Optional[int] = None
                    ) -> "HostXShards":
        """Load shards saved by ``save_pickle`` in either package (ref
        shard.py:60-71)."""
        files = sorted(glob.glob(os.path.join(path, "part-*.pkl")))
        if not files:
            raise FileNotFoundError(f"no shard pickles under {path}")
        shards = []
        for f in files:
            with open(f, "rb") as fh:
                shards.extend(pickle.load(fh))
        out = HostXShards(shards)
        if minPartitions and out.num_partitions() < minPartitions:
            out = out.repartition(minPartitions)
        return out

    @staticmethod
    def _default_num_shards() -> int:
        ctx = active_context()
        return 1 if ctx is None else ctx.num_devices

    @staticmethod
    def from_records(records, num_shards: Optional[int] = None
                     ) -> "HostXShards":
        """Partition a flat list of opaque records (feature objects, rows)
        into contiguous shards without descending into them."""
        n = num_shards or XShards._default_num_shards()
        n = max(1, min(n, len(records))) if records else 1
        splits = np.array_split(np.arange(len(records)), n)
        return HostXShards([[records[i] for i in idx] for idx in splits])

    @staticmethod
    def partition(data, num_shards: Optional[int] = None) -> "HostXShards":
        """Partition an ndarray, or a dict / (nested) list or tuple of
        them, into shards along axis 0 (ref shard.py:73-127)."""
        n = num_shards or XShards._default_num_shards()
        leaves, rebuild = _flatten(data)
        if not leaves:
            raise ValueError("empty data")
        lengths = {len(a) for a in leaves}
        if len(lengths) != 1:
            raise ValueError(f"all arrays must share axis-0 length, got "
                             f"{lengths}")
        total = lengths.pop()
        if total < n:
            raise ValueError(f"cannot split {total} rows into {n} shards")
        return HostXShards(rebuild([np.asarray(a)[idx] for a in leaves])
                           for idx in np.array_split(np.arange(total), n))


class HostXShards(XShards):
    """Shards held in this process (ref SparkXShards, shard.py:129), in
    the store of ``tier`` (default ``OrcaContext.train_data_store``);
    ``transient=True`` keeps them in DRAM whatever the tier."""

    def __init__(self, shards: Iterable[Any], transient: bool = False,
                 tier: Optional[str] = None):
        if tier is None:
            tier = OrcaContext.train_data_store
        self._store = _make_store(shards, "DRAM" if transient else tier)
        self.tier = self._store.tier

    # -- core --
    def transform_shard(self, func: Callable, *args,
                        op: str = "transform_shard") -> "HostXShards":
        """``func(shard, *args)`` on every shard, on the data pool, in
        shard order."""
        fn = (lambda s: func(s, *args)) if args else func
        return HostXShards(
            _map_shards(fn, self.num_partitions(), self._store.get, op))

    def map_reduce_shard(self, map_fn: Callable, reduce_fn: Callable,
                         op: str = "map_reduce") -> Any:
        """``map_fn`` per shard on the data pool, ``reduce_fn`` folding the
        partials in shard order."""
        it = _map_shards(map_fn, self.num_partitions(), self._store.get, op)
        return functools.reduce(reduce_fn, it)

    def _iter_shards(self):
        for i in range(len(self._store)):
            yield self._store.get(i)

    def first(self):
        """Shard 0 alone; reads no other shard."""
        if not len(self._store):
            raise IndexError("first() on empty XShards")
        return self._store.get(0)

    def collect(self) -> List[Any]:
        return self._store.all()

    def num_partitions(self) -> int:
        return len(self._store)

    def cache(self):
        return self

    def uncache(self):
        return self

    # -- restructuring --
    def repartition(self, num_partitions: int) -> "HostXShards":
        """Type-aware merge/split (ref shard.py:219-293: numpy-dict rows
        merged key by key, DataFrames concatenated, arrays concatenated,
        anything else as a list of records), planned as global row ranges
        with ``np.array_split``'s sizes and assembled per output shard on
        the data pool."""
        n_in = self.num_partitions()
        if n_in == 0:
            return self
        first = self.first()
        get = self._store.get

        if _is_dataframe(first):
            import pandas as pd
            rows = len
            sl = lambda s, a, b: s.iloc[a:b]  # noqa: E731
            combine = lambda ps: pd.concat(ps, ignore_index=False) \
                if len(ps) != 1 else ps[0]  # noqa: E731
        elif isinstance(first, dict) and all(
                isinstance(v, np.ndarray) for v in first.values()):
            keys = list(first.keys())
            rows = lambda s: len(s[keys[0]]) if keys else 0  # noqa: E731
            sl = lambda s, a, b: {k: s[k][a:b] for k in keys}  # noqa: E731
            combine = lambda ps: {  # noqa: E731
                k: np.concatenate([p[k] for p in ps]) for k in keys}
        elif isinstance(first, np.ndarray):
            rows = len
            sl = lambda s, a, b: s[a:b]  # noqa: E731
            combine = lambda ps: np.concatenate(ps) \
                if len(ps) != 1 else ps[0]  # noqa: E731
        else:
            as_records = lambda s: list(s) \
                if isinstance(s, (list, tuple)) else [s]  # noqa: E731
            rows = lambda s: len(as_records(s))  # noqa: E731
            sl = lambda s, a, b: as_records(s)[a:b]  # noqa: E731
            combine = lambda ps: [r for p in ps for r in p]  # noqa: E731

        lengths = [rows(get(i)) for i in range(n_in)]
        total = sum(lengths)
        m = num_partitions
        sizes = [total // m + (1 if j < total % m else 0) for j in range(m)]
        offsets = np.cumsum([0] + lengths)
        plans = []
        lo = 0
        for size in sizes:
            hi = lo + size
            plan = []
            for si in range(n_in):
                a = max(lo, offsets[si])
                b = min(hi, offsets[si + 1])
                if a < b:
                    plan.append((si, int(a - offsets[si]),
                                 int(b - offsets[si])))
            plans.append(plan)
            lo = hi

        def build(plan):
            ps = [sl(get(si), a, b) for (si, a, b) in plan]
            return combine(ps) if ps else combine([sl(get(0), 0, 0)])

        return HostXShards(
            _map_shards(build, m, lambda j: plans[j], "repartition"))

    def partition_by(self, cols, num_partitions: Optional[int] = None
                     ) -> "HostXShards":
        """Hash-partition DataFrame shards by column(s) (ref
        shard.py:295-339): each shard split on the data pool by
        ``hash_pandas_object(s[cols], index=False) % n``, then each bucket
        concatenated in shard order."""
        n_in = self.num_partitions()
        if not n_in or not _is_dataframe(self.first()):
            raise TypeError("partition_by requires pandas DataFrame shards")
        import pandas as pd
        if isinstance(cols, str):
            cols = [cols]
        n = num_partitions or n_in

        def split_one(s):
            codes = pd.util.hash_pandas_object(
                s[cols], index=False).to_numpy() % n
            return [s[codes == i] for i in range(n)]

        buckets: List[List[Any]] = [[] for _ in range(n)]
        for parts in _map_shards(split_one, n_in, self._store.get,
                                 "partition_by"):
            for i, p in enumerate(parts):
                buckets[i].append(p)
        return HostXShards(
            pd.concat(b, ignore_index=False) if len(b) != 1 else b[0]
            for b in buckets)

    def unique(self) -> np.ndarray:
        """Distinct elements over series/array shards (ref
        shard.py:341-358)."""
        vals = [np.unique(np.asarray(s)) for s in self._iter_shards()]
        return np.unique(np.concatenate(vals)) if vals else np.array([])

    def split(self) -> List["HostXShards"]:
        """If each shard is a tuple/list of k elements, k XShards (ref
        shard.py:360-387); else ``[self]``."""
        shards = self.collect()
        ks = {len(s) for s in shards if isinstance(s, (list, tuple))}
        if len(ks) != 1:
            return [self]
        k = ks.pop()
        return [HostXShards([s[i] for s in shards]) for i in range(k)]

    def zip(self, other: "HostXShards") -> "HostXShards":
        """Pairwise zip of equal partition counts and shard lengths (ref
        shard.py:389-411). Transient: the pairs are views of shards the
        two stores already hold."""
        if not isinstance(other, HostXShards):
            raise TypeError("XShards.zip takes HostXShards")
        if self.num_partitions() != other.num_partitions():
            raise ValueError("XShards.zip: partition counts differ")

        def pairs():
            for i in range(self.num_partitions()):
                x, y = self._store.get(i), other._store.get(i)
                if hasattr(x, "__len__") and hasattr(y, "__len__") \
                        and len(x) != len(y):
                    raise ValueError("XShards.zip: shard lengths differ")
                yield (x, y)

        return HostXShards(pairs(), transient=True)

    # -- misc --
    def __len__(self):
        total = 0
        for s in self._iter_shards():
            if isinstance(s, dict):
                # numpy-dict shard: rows, not keys
                vals = list(s.values())
                total += len(vals[0]) if vals else 0
            elif hasattr(s, "__len__"):
                total += len(s)
            else:
                total += 1
        return total

    def __getitem__(self, key):
        """Column selection on dict/DataFrame shards (ref
        shard.py:432-441)."""
        def get_data(data):
            if isinstance(data, dict) or _is_dataframe(data):
                return data[key]
            raise KeyError(f"cannot index shard of type {type(data)}")
        return HostXShards((get_data(s) for s in self._iter_shards()),
                           transient=True)

    def save_pickle(self, path: str, batchSize: int = 10) -> "HostXShards":
        """``part-<i>.pkl`` files of ``batchSize`` shards each (ref
        shard.py:417-427)."""
        os.makedirs(path, exist_ok=True)
        shards = self.collect()
        for i in range(0, len(shards), batchSize):
            with open(os.path.join(path, f"part-{i // batchSize:05d}.pkl"),
                      "wb") as fh:
                pickle.dump(shards[i:i + batchSize], fh,
                            protocol=pickle.HIGHEST_PROTOCOL)
        return self

    def to_pandas(self):
        import pandas as pd
        return pd.concat(self.collect(), ignore_index=False)


# the name reference user code uses
SparkXShards = HostXShards


class SharedValue:
    """Broadcast-value analog (ref shard.py:472-485): a holder with
    ``.value``."""

    def __init__(self, data):
        self._data = data

    @property
    def value(self):
        return self._data

    def unpersist(self):
        self._data = None
