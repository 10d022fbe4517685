"""Recommender base + user/item feature types.

Counterpart of ``analytics_zoo_tpu/models/recommendation/recommender.py``
(ref ``pyzoo/zoo/models/recommendation/__init__.py``):
``predict_user_item_pair``, ``recommend_for_user`` and
``recommend_for_item`` over XShards of ``UserItemFeature`` (the port's
``data/shard.py``). ``predict_user_item_pair`` also takes a plain list
of features, as one shard, and returns HostXShards either way.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Union

import numpy as np

from analytics_zoo_tpu_torch.common.device import DeviceLike
from analytics_zoo_tpu_torch.data.shard import HostXShards, XShards
from analytics_zoo_tpu_torch.models.common import ZooModel


@dataclass
class UserItemFeature:
    user_id: int
    item_id: int
    sample: np.ndarray  # model input row, e.g. [user_id, item_id]


@dataclass
class UserItemPrediction:
    user_id: int
    item_id: int
    prediction: int
    probability: float


class Recommender(ZooModel):
    """Shared ranking utilities over XShards (or lists) of
    UserItemFeature."""

    def _pairs_to_batch(self, features: List[UserItemFeature]):
        return np.stack([np.asarray(f.sample, np.float32) for f in features])

    def _predict_shard(self, shard: List[UserItemFeature], batch_size: int,
                       device: DeviceLike) -> List[UserItemPrediction]:
        x = self._pairs_to_batch(shard)
        probs = np.asarray(self.predict(x, batch_size=batch_size,
                                        device=device))
        cls = probs.argmax(-1)
        return [UserItemPrediction(f.user_id, f.item_id, int(c) + 1,
                                   float(p[c]))
                for f, c, p in zip(shard, cls, probs)]

    def predict_user_item_pair(
            self, feature_shards: Union[XShards, List[UserItemFeature]],
            batch_size: int = 1024, device: DeviceLike = None
    ) -> HostXShards:
        """(ref Recommender.predictUserItemPair): the most likely class
        (1-based) and its probability for every pair, as HostXShards of
        lists, one per input shard (a plain list is one shard)."""
        shards = (feature_shards.collect()
                  if isinstance(feature_shards, XShards)
                  else [list(feature_shards)])
        return HostXShards([self._predict_shard(shard, batch_size, device)
                            for shard in shards])

    def _top(self, feature_shards, key: str, limit: int,
             device: DeviceLike) -> HostXShards:
        preds = self.predict_user_item_pair(feature_shards, device=device)
        groups: Dict[int, List[UserItemPrediction]] = {}
        for shard in preds.collect():
            for p in shard:
                groups.setdefault(getattr(p, key), []).append(p)
        out = []
        for plist in groups.values():
            plist.sort(key=lambda p: (-p.prediction, -p.probability))
            out.append(plist[:limit])
        return HostXShards(out)

    def recommend_for_user(self, feature_shards, max_items: int,
                           device: DeviceLike = None) -> HostXShards:
        """Top-``max_items`` items per user by predicted class, then
        probability (ref Recommender.recommendForUser): one shard per
        user, in order of first appearance."""
        return self._top(feature_shards, "user_id", max_items, device)

    def recommend_for_item(self, feature_shards, max_users: int,
                           device: DeviceLike = None) -> HostXShards:
        """Top-``max_users`` users per item (ref
        Recommender.recommendForItem)."""
        return self._top(feature_shards, "item_id", max_users, device)
