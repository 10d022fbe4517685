"""ParquetDataset — image/ndarray/scalar records in parquet.

Counterpart of ``analytics_zoo_tpu/data/image/parquet_dataset.py`` (ref
``pyzoo/zoo/orca/data/image/parquet_dataset.py:31-232`` ParquetDataset
.write/_read_as_xshards/read_as_tf/read_as_torch, ``write_from_directory``,
``write_mnist``; schema fields in ``pyzoo/zoo/orca/data/image/utils.py``).
Chunks go straight to parquet files through pandas and pyarrow, and reads
come back as ``HostXShards`` or a ``ShardedDataset``. The files and the
``_orca_metadata`` schema are the JAX package's, so each package reads
the other's datasets.

Schema field types (the reference's trio):
- ``Scalar(dtype)``  — int/float/str, stored as a native parquet column;
- ``NDarray(dtype, shape=None)`` — ndarray stored as raw bytes + shape;
- ``Image()``        — a path string whose FILE CONTENT bytes are stored
  (decoded at read time with ``decode_images=True``, which needs PIL).

Writing or reading needs pyarrow and decoding images PIL; where either is
missing the call raises an ``ImportError`` naming the package.
"""

from __future__ import annotations

import importlib.util
import io
import json
import os
import shutil
from dataclasses import dataclass
from itertools import islice
from typing import Dict, Iterator

import numpy as np

_META = "_orca_metadata"


@dataclass
class Scalar:
    dtype: str = "float32"
    kind: str = "scalar"


@dataclass
class NDarray:
    dtype: str = "float32"
    kind: str = "ndarray"


@dataclass
class Image:
    dtype: str = "uint8"
    kind: str = "image"


_KINDS = {"scalar": Scalar, "ndarray": NDarray, "image": Image}


def _require(package: str, what: str) -> None:
    """The typed error where this host lacks ``package``."""
    if importlib.util.find_spec(package) is None:
        raise ImportError(f"{what} needs {package}, which is not installed "
                          "on this host")


def _encode_schema(schema: Dict) -> str:
    return json.dumps({k: {"kind": v.kind, "dtype": v.dtype}
                       for k, v in schema.items()})


def _decode_schema(text: str) -> Dict:
    raw = json.loads(text)
    return {k: _KINDS[v["kind"]](dtype=v["dtype"]) for k, v in raw.items()}


def _chunks(gen: Iterator, size: int):
    it = iter(gen)
    while True:
        block = list(islice(it, size))
        if not block:
            return
        yield block


class ParquetDataset:
    @staticmethod
    def write(path: str, generator: Iterator[dict], schema: Dict,
              block_size: int = 1000, write_mode: str = "overwrite"):
        """Write generator records (dicts matching ``schema``) to
        ``path/chunk=i/part.parquet`` + a ``_orca_metadata`` schema file
        (ref ParquetDataset.write, parquet_dataset.py:33-72)."""
        _require("pyarrow", "ParquetDataset.write")
        import pandas as pd

        if os.path.exists(path):
            if write_mode == "overwrite":
                shutil.rmtree(path)
            elif write_mode == "errorifexists":
                raise FileExistsError(path)
        os.makedirs(path, exist_ok=True)
        for i, block in enumerate(_chunks(generator, block_size)):
            cols: Dict[str, list] = {k: [] for k in schema}
            shape_cols: Dict[str, list] = {}
            for rec in block:
                for k, field in schema.items():
                    v = rec[k]
                    if field.kind == "ndarray":
                        arr = np.asarray(v, dtype=field.dtype)
                        cols[k].append(arr.tobytes())
                        shape_cols.setdefault(k + "__shape", []).append(
                            json.dumps(list(arr.shape)))
                    elif field.kind == "image":
                        with open(v, "rb") as fh:
                            cols[k].append(fh.read())
                    else:
                        cols[k].append(v)
            cols.update(shape_cols)
            chunk_dir = os.path.join(path, f"chunk={i}")
            os.makedirs(chunk_dir, exist_ok=True)
            pd.DataFrame(cols).to_parquet(
                os.path.join(chunk_dir, "part.parquet"), index=False)
        with open(os.path.join(path, _META), "w") as fh:
            fh.write(_encode_schema(schema))

    # ------------------------------------------------------------- reads
    @staticmethod
    def _chunk_files(path: str):
        files = []
        for root, _, names in os.walk(path):
            files.extend(os.path.join(root, n) for n in names
                         if n.endswith(".parquet"))
        return sorted(files)

    @staticmethod
    def _decode_frame(df, schema, decode_images):
        out = {}
        for k, field in schema.items():
            if field.kind == "ndarray":
                shapes = [json.loads(s) for s in df[k + "__shape"]]
                arrs = [np.frombuffer(b, dtype=field.dtype).reshape(s)
                        for b, s in zip(df[k], shapes)]
                out[k] = (np.stack(arrs) if len({tuple(s) for s in shapes})
                          == 1 else np.asarray(arrs, dtype=object))
            elif field.kind == "image":
                if decode_images:
                    _require("PIL", "decoding an Image field")
                    from PIL import Image as PILImage
                    arrs = [np.asarray(PILImage.open(io.BytesIO(b)))
                            for b in df[k]]
                    shapes = {a.shape for a in arrs}
                    out[k] = (np.stack(arrs) if len(shapes) == 1
                              else np.asarray(arrs, dtype=object))
                else:
                    out[k] = np.asarray(list(df[k]), dtype=object)
            else:
                out[k] = df[k].to_numpy()
        return out

    @staticmethod
    def read_as_xshards(path: str, decode_images: bool = True):
        """One shard per written chunk (ref _read_as_xshards,
        parquet_dataset.py:90-112)."""
        _require("pyarrow", "ParquetDataset.read_as_xshards")
        import pandas as pd
        from analytics_zoo_tpu_torch.data.shard import HostXShards

        with open(os.path.join(path, _META)) as fh:
            schema = _decode_schema(fh.read())
        shards = []
        for f in ParquetDataset._chunk_files(path):
            df = pd.read_parquet(f)
            shards.append(ParquetDataset._decode_frame(df, schema,
                                                       decode_images))
        if not shards:
            raise FileNotFoundError(f"no parquet chunks under {path}")
        return HostXShards(shards)

    @staticmethod
    def read_as_dataset(path: str, feature_cols, label_cols,
                        decode_images: bool = True):
        """Directly to the training feed: a ShardedDataset whose x/y come
        from the named columns."""
        from analytics_zoo_tpu_torch.data.dataset import ShardedDataset

        shards = ParquetDataset.read_as_xshards(path, decode_images)

        def to_xy(s):
            def cols(names):
                if isinstance(names, str):
                    names = [names]
                arrs = [np.asarray(s[c]) for c in names]
                return arrs[0] if len(arrs) == 1 else tuple(arrs)

            return {"x": cols(feature_cols), "y": cols(label_cols)}

        return ShardedDataset.from_xshards(shards.transform_shard(to_xy))

    @staticmethod
    def read_as_torch(path: str, decode_images: bool = True):
        """Row-dict iterator factory (ref read_as_torch — there a torch
        IterableDataset; the consumer wraps it)."""
        return ParquetDataset._row_iter(path, decode_images)

    @staticmethod
    def read_as_tf(path: str, decode_images: bool = True):
        return ParquetDataset._row_iter(path, decode_images)

    @staticmethod
    def _row_iter(path, decode_images):
        shards = ParquetDataset.read_as_xshards(path, decode_images)

        def gen():
            for shard in shards.collect():
                n = len(next(iter(shard.values())))
                for i in range(n):
                    yield {k: v[i] for k, v in shard.items()}

        return gen


def write_from_directory(directory: str, label_map: Dict[str, int],
                         output_path: str, shuffle: bool = True,
                         **kwargs):
    """Class-per-subdirectory image tree → parquet
    (ref write_from_directory, parquet_dataset.py:168-198)."""
    records = []
    for label_dir in sorted(os.listdir(directory)):
        full = os.path.join(directory, label_dir)
        if not os.path.isdir(full) or label_dir not in label_map:
            continue
        for name in sorted(os.listdir(full)):
            records.append({"image": os.path.join(full, name),
                            "label": label_map[label_dir]})
    if shuffle:
        np.random.default_rng(0).shuffle(records)
    schema = {"image": Image(), "label": Scalar("int64")}
    ParquetDataset.write(output_path, iter(records), schema, **kwargs)


def write_ndarrays(images: np.ndarray, labels: np.ndarray,
                   output_path: str, **kwargs):
    """(ref _write_ndarrays, parquet_dataset.py:200-216)"""
    schema = {"image": NDarray(str(images.dtype)),
              "label": NDarray(str(labels.dtype))}

    def gen():
        for i in range(len(images)):
            yield {"image": images[i], "label": labels[i]}

    ParquetDataset.write(output_path, gen(), schema, **kwargs)


def write_mnist(image_file: str, label_file: str, output_path: str,
                **kwargs):
    """IDX-format MNIST → parquet (ref write_mnist + _extract_mnist_*,
    parquet_dataset.py:134-232)."""
    def read32(f):
        return int.from_bytes(f.read(4), "big")

    with open(image_file, "rb") as f:
        magic = read32(f)
        if magic != 2051:
            raise ValueError(f"bad MNIST image magic {magic}")
        n, rows, cols = read32(f), read32(f), read32(f)
        images = np.frombuffer(f.read(n * rows * cols), np.uint8).reshape(
            n, rows, cols)
    with open(label_file, "rb") as f:
        magic = read32(f)
        if magic != 2049:
            raise ValueError(f"bad MNIST label magic {magic}")
        n = read32(f)
        labels = np.frombuffer(f.read(n), np.uint8)
    write_ndarrays(images, labels, output_path, **kwargs)
