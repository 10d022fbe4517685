"""SessionRecommender — GRU session-based recommendation.

Counterpart of
``analytics_zoo_tpu/models/recommendation/session_recommender.py`` (ref
``pyzoo/zoo/models/recommendation/session_recommender.py:44-121``, Scala
``SessionRecommender.scala``). Same signature, same graph, same parameter
names: the session's items through an ``Embedding`` and stacked ``GRU``
layers into a ``Dense`` over the catalog, plus (``include_history``) the
history's embeddings summed by a ``Lambda`` through an MLP, the two
summed and a softmax over the items.
"""

from __future__ import annotations

import numpy as np

from analytics_zoo_tpu_torch.keras import Input, Model
from analytics_zoo_tpu_torch.keras import layers as zl
from analytics_zoo_tpu_torch.models.common import registry
from analytics_zoo_tpu_torch.models.recommendation.recommender import (
    Recommender,
)


@registry.register
class SessionRecommender(Recommender):
    """(ref session_recommender.py:44: item_count, item_embed,
    rnn_hidden_layers, session_length, include_history,
    mlp_hidden_layers, history_length)"""

    def __init__(self, item_count, item_embed, rnn_hidden_layers=(40, 20),
                 session_length=0, include_history=False,
                 mlp_hidden_layers=(40, 20), history_length=0):
        super().__init__()
        if session_length <= 0:
            raise ValueError("session_length should align with input "
                             "features")
        if include_history and history_length <= 0:
            raise ValueError("history_length should align with input "
                             "features")
        self.item_count = int(item_count)
        self.item_embed = int(item_embed)
        self.rnn_hidden_layers = [int(u) for u in rnn_hidden_layers]
        self.mlp_hidden_layers = [int(u) for u in mlp_hidden_layers]
        self.include_history = include_history
        self.session_length = int(session_length)
        self.history_length = int(history_length)
        self.model = self.build_model()

    def build_model(self):
        # (ref session_recommender.py:69-94)
        input_rnn = Input(shape=(self.session_length,))
        table = zl.Embedding(self.item_count + 1, self.item_embed,
                             init="uniform", name="session_embed")(input_rnn)
        gru = table
        for units in self.rnn_hidden_layers[:-1]:
            gru = zl.GRU(units, return_sequences=True)(gru)
        gru_last = zl.GRU(self.rnn_hidden_layers[-1],
                          return_sequences=False)(gru)
        rnn = zl.Dense(self.item_count)(gru_last)

        if self.include_history:
            input_mlp = Input(shape=(self.history_length,))
            his = zl.Embedding(self.item_count + 1, self.item_embed,
                               init="uniform", name="history_embed")(input_mlp)
            summed = zl.Lambda(lambda x: x.sum(axis=1))(his)
            mlp = summed
            for units in self.mlp_hidden_layers:
                mlp = zl.Dense(units, activation="relu")(mlp)
            mlp_last = zl.Dense(self.item_count)(mlp)
            merged = zl.merge([rnn, mlp_last], mode="sum")
            out = zl.Activation("softmax")(merged)
            return Model(input=[input_rnn, input_mlp], output=out)
        out = zl.Activation("softmax")(rnn)
        return Model(input=input_rnn, output=out)

    def recommend_for_session(self, sessions, max_items: int,
                              zero_based_label: bool = True,
                              batch_size: int = 1024, **kwargs):
        """(ref session_recommender.py:103-121) The ``max_items`` most
        likely items of each session as ``[(item, probability)]``;
        ``kwargs`` go to ``predict`` (``device=`` before ``compile``)."""
        probs = np.asarray(self.predict(sessions, batch_size=batch_size,
                                        **kwargs))
        top = np.argsort(-probs, axis=-1)[:, :max_items]
        offset = 0 if zero_based_label else 1
        return [[(int(i) + offset, float(p[i])) for i in row]
                for row, p in zip(top, probs)]

    def recommend_for_user(self, feature_rdd, max_items, **kwargs):
        raise Exception("recommend_for_user: Unsupported for "
                        "SessionRecommender")

    def recommend_for_item(self, feature_rdd, max_users, **kwargs):
        raise Exception("recommend_for_item: Unsupported for "
                        "SessionRecommender")

    def _config(self):
        return dict(item_count=self.item_count, item_embed=self.item_embed,
                    rnn_hidden_layers=self.rnn_hidden_layers,
                    session_length=self.session_length,
                    include_history=self.include_history,
                    mlp_hidden_layers=self.mlp_hidden_layers,
                    history_length=self.history_length)
