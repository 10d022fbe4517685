"""Elasticsearch <-> XShards/pandas bridge.

Counterpart of ``analytics_zoo_tpu/data/elastic_search.py`` (ref
``pyzoo/zoo/orca/data/elastic_search.py:27-117`` EsTable: read_df /
flatten_df / write_df / read_rdd through the es-hadoop Spark connector).
It speaks Elasticsearch's REST API directly over urllib, as the JAX
package does: search with the scroll cursor for whole-index reads (the
scroll context released after the read), ``_bulk`` in chunks for writes
(per-column dtypes kept, NaN as JSON null). Results land as
pandas-DataFrame ``HostXShards``.
"""

from __future__ import annotations

import json
import urllib.request
from typing import Dict, List, Optional

import numpy as np


def _http(method: str, url: str, body: Optional[dict] = None,
          ndjson: Optional[str] = None, timeout: float = 30.0) -> dict:
    data = None
    headers = {"Content-Type": "application/json"}
    if ndjson is not None:
        data = ndjson.encode()
        headers["Content-Type"] = "application/x-ndjson"
    elif body is not None:
        data = json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers=headers,
                                 method=method)
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read().decode() or "{}")


def _base_url(es_config: Dict) -> str:
    host = es_config.get("host", "localhost")
    port = es_config.get("port", 9200)
    scheme = es_config.get("scheme", "http")
    return f"{scheme}://{host}:{port}"


class EsTable:
    """(ref EsTable) static read/write helpers keyed by an es_config dict:
    ``{"host": ..., "port": ..., "scheme": ...}``."""

    @staticmethod
    def read_df(es_config: Dict, es_resource: str, schema=None,
                query: Optional[dict] = None, batch_size: int = 1000,
                num_shards: Optional[int] = None):
        """Read an index into pandas-DataFrame XShards via the scroll API
        (ref read_df: full-resource read through es-hadoop)."""
        import pandas as pd
        from analytics_zoo_tpu_torch.data.shard import HostXShards

        base = _base_url(es_config)
        body = {"size": int(batch_size)}
        if query:
            body["query"] = query
        out = _http("POST", f"{base}/{es_resource}/_search?scroll=2m", body)
        rows: List[dict] = []
        frames: List[pd.DataFrame] = []

        def drain(resp):
            hits = resp.get("hits", {}).get("hits", [])
            for h in hits:
                rec = dict(h.get("_source", {}))
                rec.setdefault("_id", h.get("_id"))
                rows.append(rec)
            return len(hits)

        n = drain(out)
        scroll_id = out.get("_scroll_id")
        try:
            while n and scroll_id:
                frames.append(pd.DataFrame(rows))
                rows = []
                out = _http("POST", f"{base}/_search/scroll",
                            {"scroll": "2m", "scroll_id": scroll_id})
                scroll_id = out.get("_scroll_id", scroll_id)
                n = drain(out)
        finally:
            if scroll_id:
                # release the server-side search context (ES caps open
                # scrolls; leaking them starves later reads)
                try:
                    _http("DELETE", f"{base}/_search/scroll",
                          {"scroll_id": scroll_id})
                except OSError:
                    pass
        if rows:
            frames.append(pd.DataFrame(rows))
        if not frames:
            frames = [pd.DataFrame()]
        if num_shards:
            big = pd.concat(frames, ignore_index=True)
            idx = np.array_split(np.arange(len(big)), num_shards)
            frames = [big.iloc[i] for i in idx]
        return HostXShards(frames)

    @staticmethod
    def flatten_df(df):
        """Flatten dict-valued columns into dotted scalar columns
        (ref flatten_df/flatten: nested StructType → leaf columns)."""
        import pandas as pd

        out = {}
        for col in df.columns:
            values = list(df[col])
            has_dict = any(isinstance(v, dict) for v in values)
            if not has_dict:
                out[col] = df[col]
                continue
            if not all(isinstance(v, dict) or v is None for v in values):
                # heterogeneous docs: keep the raw column too so non-dict
                # values are not silently lost
                out[col] = df[col]
            keys = set()
            for v in values:
                if isinstance(v, dict):
                    keys.update(v.keys())
            for k in sorted(keys):
                # dict-typed JSON cells: object traversal, not numeric rows —
                # there is no vectorized form of nested-doc flattening
                out[f"{col}.{k}"] = df[col].map(  # zoolint: disable=rowwise-map-in-data-plane
                    lambda v, kk=k: v.get(kk) if isinstance(v, dict)
                    else None)
        return pd.DataFrame(out)

    @staticmethod
    def write_df(es_config: Dict, es_resource: str, df,
                 chunk_size: int = 1000) -> int:
        """Bulk-index a DataFrame (ref write_df; the es-hadoop connector
        also chunks bulk writes); returns the indexed count. Per-column
        dtypes are preserved (no iterrows row-upcast) and NaN serializes
        as JSON null."""
        base = _base_url(es_config)

        def clean(v):
            if isinstance(v, np.generic):
                v = v.item()
            if isinstance(v, float) and (v != v):   # NaN → null: ES's
                return None                          # parser rejects NaN
            return v

        records = df.to_dict(orient="records")
        total = 0
        for start in range(0, len(records), int(chunk_size)):
            lines = []
            for rec in records[start:start + int(chunk_size)]:
                _id = clean(rec.pop("_id", None))
                action: Dict = {"index": {}}
                if _id is not None:
                    action["index"]["_id"] = _id
                lines.append(json.dumps(action))
                lines.append(json.dumps({k: clean(v)
                                         for k, v in rec.items()}))
            resp = _http("POST", f"{base}/{es_resource}/_bulk",
                         ndjson="\n".join(lines) + "\n")
            if resp.get("errors"):
                failed = [i["index"] for i in resp.get("items", [])
                          if i.get("index", {}).get("error")]
                raise IOError(f"bulk index reported errors: {failed[:3]}")
            total += len(lines) // 2
        return total

    @staticmethod
    def read_rdd(es_config: Dict, es_resource: str,
                 query: Optional[dict] = None, **kw):
        """Record-dict shards (ref read_rdd: RDD of raw hits)."""
        shards = EsTable.read_df(es_config, es_resource, query=query, **kw)
        return shards.transform_shard(
            lambda df: df.to_dict(orient="records"))
