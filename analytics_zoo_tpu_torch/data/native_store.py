"""ctypes binding for the native tiered blob store (``data/native/zstore.cpp``).

The port's own copy of ``analytics_zoo_tpu/data/native_store.py`` (ref the
JNI PMEM allocator and the tiered FeatureSet natives,
PersistentMemoryAllocator.java:19-44, NativeArray.scala:23-27,
FeatureSet.scala DRAM/PMEM/DISK_n). Python keeps only handles; the bytes
live in the native arena or its spill files.

``NativeShardStore`` is the ``NATIVE_n`` tier of ``data/shard.py``:
pickled shards as blobs, an LRU DRAM window of about 1/n of the bytes,
spill to disk, and the next shards prefetched on sequential access. A
pandas shard's object columns whose cells are same-shape numeric arrays,
or equal-length lists of ints (Friesian's history, mask and feature
columns), are stored as one 2-D array each and rebuilt as cells of the
same types and values when read: pickling them one object a cell cost
seven times the DRAM chain at MovieLens-1M's shape (ROADMAP R15).

The library is built at its first use by ``g++ -O2 -std=c++17 -shared
-fPIC -pthread`` into ``build/native/`` at the repository root. A build
that cannot run or fails raises :class:`NativeStoreCompileError`, which
names g++; the JAX package falls back to its Python tiers instead, while
the port never turns ``NATIVE_n`` into ``DISK_n`` (ROADMAP C26).
"""

from __future__ import annotations

import ctypes
import hashlib
import itertools
import operator
import os
import pickle
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Any, Iterable, List, Sequence

_SRC = Path(__file__).resolve().parent / "native" / "zstore.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
GXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lib = None
_lib_lock = threading.Lock()


class NativeStoreCompileError(RuntimeError):
    """``g++`` could not build the native store (missing or failed)."""


def lib_path() -> Path:
    """The library's path, named by a digest of the source and flags, so
    an edited source is rebuilt."""
    digest = hashlib.sha256(_SRC.read_bytes()
                            + " ".join(GXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libzstore-{digest[:16]}.so"


def load_native_lib() -> ctypes.CDLL:
    """Compile (once) and load libzstore; raises
    :class:`NativeStoreCompileError` when g++ is missing or fails."""
    global _lib
    with _lib_lock:
        if _lib is None:
            _lib = _bind(ctypes.CDLL(str(_build())))
        return _lib


def _build() -> Path:
    so = lib_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(_SRC)],
                       check=True, capture_output=True, text=True,
                       timeout=180)
    except FileNotFoundError as e:
        raise NativeStoreCompileError(
            "NATIVE_n needs g++ to build data/native/zstore.cpp, and g++ "
            "was not found") from e
    except subprocess.CalledProcessError as e:
        tmp.unlink(missing_ok=True)
        raise NativeStoreCompileError(
            f"g++ failed to build data/native/zstore.cpp:\n{e.stderr}") from e
    except subprocess.TimeoutExpired as e:
        tmp.unlink(missing_ok=True)
        raise NativeStoreCompileError(
            "g++ timed out building data/native/zstore.cpp") from e
    os.replace(tmp, so)   # atomic: a concurrent loader never reads half
    return so


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.zstore_create.restype = ctypes.c_void_p
    lib.zstore_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
    lib.zstore_put.restype = ctypes.c_int64
    lib.zstore_put.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                               ctypes.c_uint64]
    lib.zstore_size.restype = ctypes.c_int64
    lib.zstore_size.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.zstore_get.restype = ctypes.c_int64
    lib.zstore_get.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                               ctypes.c_void_p, ctypes.c_uint64]
    lib.zstore_prefetch.restype = None
    lib.zstore_prefetch.argtypes = [ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_int64),
                                    ctypes.c_uint64]
    for fn in ("zstore_resident_bytes", "zstore_count", "zstore_hits",
               "zstore_misses"):
        getattr(lib, fn).restype = ctypes.c_uint64
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    lib.zstore_destroy.restype = None
    lib.zstore_destroy.argtypes = [ctypes.c_void_p]
    return lib


class NativeBlobStore:
    """Raw byte-blob store over the native arena.

    Not thread-safe: the arena locks its own state, but ``close()`` frees
    the handle, so callers keep one store per owning thread or serialize
    ``close`` against gets in flight."""

    def __init__(self, capacity_bytes: int, directory: str = None):
        self._lib = load_native_lib()
        self._dir = directory or tempfile.mkdtemp(prefix="zstore_")
        self._h = self._lib.zstore_create(self._dir.encode(),
                                          int(capacity_bytes))
        if not self._h:
            raise RuntimeError("zstore_create failed")

    def put(self, data: bytes) -> int:
        blob_id = self._lib.zstore_put(self._h, data, len(data))
        if blob_id < 0:
            raise IOError("zstore_put failed (disk spill error?)")
        return blob_id

    def get(self, blob_id: int) -> bytes:
        size = self._lib.zstore_size(self._h, blob_id)
        if size < 0:
            raise KeyError(f"unknown blob {blob_id}")
        buf = ctypes.create_string_buffer(size)
        got = self._lib.zstore_get(self._h, blob_id, buf, size)
        if got != size:
            raise IOError(f"zstore_get failed for blob {blob_id}")
        return buf.raw

    def prefetch(self, ids: Sequence[int]):
        n = len(ids)
        if n:
            self._lib.zstore_prefetch(self._h, (ctypes.c_int64 * n)(*ids), n)

    @property
    def resident_bytes(self) -> int:
        return self._lib.zstore_resident_bytes(self._h)

    @property
    def count(self) -> int:
        return self._lib.zstore_count(self._h)

    @property
    def stats(self) -> dict:
        return {"hits": self._lib.zstore_hits(self._h),
                "misses": self._lib.zstore_misses(self._h),
                "resident_bytes": self.resident_bytes,
                "count": self.count}

    def close(self):
        if self._h:
            self._lib.zstore_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


_PACKED = "zoo-native-packed-frame"


def _pack_column(cells):
    """``("array", 2-D array)`` for cells that are numeric ndarrays of one
    shape and dtype, ``("ints", 2-D int64 array)`` for lists of one length
    holding Python ints only, else None."""
    import numpy as np
    kinds = set(map(type, cells))
    if kinds == {np.ndarray}:
        dtypes = set(map(operator.attrgetter("dtype"), cells))
        shapes = set(map(operator.attrgetter("shape"), cells))
        if len(dtypes) != 1 or len(shapes) != 1 \
                or next(iter(dtypes)).kind not in "biuf":
            return None
        return "array", np.stack(cells)
    if kinds == {list}:
        lengths = set(map(len, cells))
        if len(lengths) != 1 or set(map(
                type, itertools.chain.from_iterable(cells))) - {int}:
            return None
        try:
            return "ints", np.array(list(cells), dtype=np.int64).reshape(
                len(cells), lengths.pop())
        except OverflowError:
            return None
    return None


def encode_shard(shard) -> bytes:
    """A shard's blob: ``pickle`` of it, a DataFrame's packable object
    columns (``_pack_column``) as one array each."""
    from analytics_zoo_tpu_torch.data.shard import _is_dataframe
    if not _is_dataframe(shard) or not len(shard) \
            or not shard.columns.is_unique:
        return pickle.dumps(shard, protocol=pickle.HIGHEST_PROTOCOL)
    packed = {}
    for c in shard.columns:
        if shard[c].dtype == object:
            got = _pack_column(shard[c].to_numpy())
            if got is not None:
                packed[c] = got
    if not packed:
        return pickle.dumps(shard, protocol=pickle.HIGHEST_PROTOCOL)
    return pickle.dumps((_PACKED, shard.drop(columns=list(packed)), packed,
                         list(shard.columns)),
                        protocol=pickle.HIGHEST_PROTOCOL)


def decode_shard(blob: bytes):
    """The shard ``encode_shard`` wrote: packed columns rebuilt as object
    columns of ndarray rows or int lists, in the original column order."""
    obj = pickle.loads(blob)
    if not (isinstance(obj, tuple) and len(obj) == 4
            and obj[0] == _PACKED):
        return obj
    import pandas as pd
    _, rest, packed, order = obj
    out = rest.copy()
    for c, (kind, arr) in packed.items():
        out[c] = pd.Series(list(arr) if kind == "array" else arr.tolist(),
                           index=rest.index, dtype=object)
    return out[order]


class NativeShardStore:
    """The shard store of a ``NATIVE_n`` tier (the interface of
    ``data/shard.py``'s ``_ShardStore``): pickled shards in the native
    arena, about 1/n of their bytes resident (at least 1 MiB), the next
    ``prefetch_ahead`` shards prefetched on each get. Takes its input one
    shard at a time, as the spill store does; the arena's capacity is
    fixed when it is created, so the shards are pickled first."""

    def __init__(self, shards: Iterable[Any], keep_fraction_denom: int = 2,
                 prefetch_ahead: int = 2):
        blobs = [encode_shard(s) for s in shards]
        total = sum(len(b) for b in blobs)
        capacity = max(total // max(1, keep_fraction_denom), 1 << 20)
        self._store = NativeBlobStore(capacity)
        self._ids: List[int] = [self._store.put(b) for b in blobs]
        self._ahead = prefetch_ahead
        self.tier = f"NATIVE_{keep_fraction_denom}"

    def __len__(self):
        return len(self._ids)

    def get(self, i: int):
        nxt = self._ids[i + 1:i + 1 + self._ahead]
        if nxt:
            self._store.prefetch(nxt)
        return decode_shard(self._store.get(self._ids[i]))

    def all(self):
        return [self.get(i) for i in range(len(self))]

    @property
    def stats(self) -> dict:
        return self._store.stats
