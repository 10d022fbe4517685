"""Seeded data-plane violations: row-at-a-time pandas under a ``data/``
path segment. Never imported — exists so the zoolint lane proves
``rowwise-map-in-data-plane`` fires (docs/zoolint.md)."""

import numpy as np


def slow_shard_transform(d, seq_len):
    d = d.copy()
    d["hist"] = d["hist"].map(
        lambda h: list(h)[:seq_len])  # VIOLATION rowwise-map-in-data-plane

    def pad_one(h):
        return list(h) + [0] * (seq_len - len(h))

    d["hist"] = d["hist"].map(pad_one)  # VIOLATION rowwise-map-in-data-plane
    d["total"] = d.apply(
        lambda r: np.sum(r.values),
        axis=1)  # VIOLATION rowwise-map-in-data-plane
    # NOT flagged: vectorized column ops and dict-valued map
    d["ok"] = d["hist"].map({1: 2})
    return d
