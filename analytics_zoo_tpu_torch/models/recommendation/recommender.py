"""Recommender base + user/item feature types.

Counterpart of ``analytics_zoo_tpu/models/recommendation/recommender.py``
(ref ``pyzoo/zoo/models/recommendation/__init__.py``). The port takes and
returns plain lists: the sharded data layer and ``recommend_for_user`` /
``recommend_for_item`` wait for a later slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

from analytics_zoo_tpu_torch.common.device import DeviceLike
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
    """Shared ranking utilities over lists of UserItemFeature."""

    def _pairs_to_batch(self, features: List[UserItemFeature]):
        return np.stack([np.asarray(f.sample, np.float32) for f in features])

    def predict_user_item_pair(self, features: List[UserItemFeature],
                               batch_size: int = 1024,
                               device: DeviceLike = None
                               ) -> List[UserItemPrediction]:
        """(ref Recommender.predictUserItemPair): the most likely class
        (1-based) and its probability for every pair."""
        x = self._pairs_to_batch(features)
        probs = np.asarray(self.predict(x, batch_size=batch_size,
                                        device=device))
        cls = probs.argmax(-1)
        return [UserItemPrediction(f.user_id, f.item_id, int(c) + 1,
                                   float(p[c]))
                for f, c, p in zip(features, cls, probs)]
