"""File readers into XShards of pandas DataFrames.

The port's copy of ``analytics_zoo_tpu/data/pandas/preprocessing.py``
(ref ``pyzoo/zoo/orca/data/pandas/preprocessing.py:24-308``): one shard
per file (a path may be a comma-separated list, a directory or a glob),
then ``num_shards`` shards if given, else ``ceil(rows /
OrcaContext.shard_size)`` when that knob is set. One process reads every
file (the JAX package stripes files over its processes). pandas is
imported inside the readers, never at import time.
"""

from __future__ import annotations

import glob
import math
import os
from typing import List, Optional

from analytics_zoo_tpu_torch.common.context import OrcaContext
from analytics_zoo_tpu_torch.data.shard import HostXShards


def _expand(file_path: str) -> List[str]:
    paths = []
    for p in file_path.split(","):
        p = p.strip()
        if not p:
            continue
        if os.path.isdir(p):
            paths.extend(sorted(
                f for f in glob.glob(os.path.join(p, "*"))
                if os.path.isfile(f)
                and not os.path.basename(f).startswith(("_", "."))))
        else:
            hits = sorted(glob.glob(p))
            if not hits:
                raise FileNotFoundError(p)
            paths.extend(hits)
    if not paths:
        raise FileNotFoundError(f"no files matched {file_path!r}")
    return paths


def _post(shards, num_shards: Optional[int]) -> HostXShards:
    out = HostXShards(shards)
    if num_shards is not None:
        out = out.repartition(num_shards)
    elif OrcaContext.shard_size is not None:
        out = out.repartition(max(1, math.ceil(len(out)
                                               / OrcaContext.shard_size)))
    return out


def read_csv(file_path: str, num_shards: Optional[int] = None,
             **kwargs) -> HostXShards:
    """(ref preprocessing.py:24-35)"""
    import pandas as pd
    return _post([pd.read_csv(p, **kwargs) for p in _expand(file_path)],
                 num_shards)


def read_json(file_path: str, num_shards: Optional[int] = None,
              **kwargs) -> HostXShards:
    """(ref preprocessing.py:37-48)"""
    import pandas as pd
    return _post([pd.read_json(p, **kwargs) for p in _expand(file_path)],
                 num_shards)


def read_parquet(file_path: str, columns: Optional[List[str]] = None,
                 num_shards: Optional[int] = None,
                 **options) -> HostXShards:
    """(ref preprocessing.py:271-306)"""
    import pandas as pd
    return _post([pd.read_parquet(p, columns=columns, **options)
                  for p in _expand(file_path)], num_shards)
