"""NeuralCF — neural collaborative filtering.

Counterpart of ``analytics_zoo_tpu/models/recommendation/neuralcf.py``
(ref ``pyzoo/zoo/models/recommendation/neuralcf.py:30-117``). Same
signature, same graph, same parameter names: an MLP tower over the
concatenated user/item embeddings, an optional GMF branch (elementwise
product of a second pair of embeddings), a softmax head. The input is one
``[batch, 2]`` tensor of ``[user_id, item_id]``; each branch's two tables
are looked up by ONE fused lookup (``FusedEmbeddings``, the CUDA kernel of
ops/csrc/embedding_bag.cu on the card): ``concat`` for the MLP tower,
``mul`` for GMF.
"""

from __future__ import annotations

from analytics_zoo_tpu_torch.keras import Input, Model
from analytics_zoo_tpu_torch.keras import layers as zl
from analytics_zoo_tpu_torch.models.common import registry
from analytics_zoo_tpu_torch.models.recommendation.recommender import (
    Recommender,
)


@registry.register
class NeuralCF(Recommender):
    """(ref neuralcf.py:45: user_count, item_count, class_num, user_embed,
    item_embed, hidden_layers, include_mf, mf_embed)"""

    def __init__(self, user_count, item_count, class_num, user_embed=20,
                 item_embed=20, hidden_layers=(40, 20, 10), include_mf=True,
                 mf_embed=20):
        super().__init__()
        self.user_count = int(user_count)
        self.item_count = int(item_count)
        self.class_num = int(class_num)
        self.user_embed = int(user_embed)
        self.item_embed = int(item_embed)
        self.hidden_layers = [int(u) for u in hidden_layers]
        self.include_mf = include_mf
        self.mf_embed = int(mf_embed)
        self.model = self.build_model()

    def build_model(self):
        inp = Input(shape=(2,))
        latent = zl.FusedEmbeddings(
            [("mlp_user_embed", self.user_count + 1, self.user_embed),
             ("mlp_item_embed", self.item_count + 1, self.item_embed)],
            combine="concat", init="uniform", name="mlp_embed_bag")(inp)
        linear = zl.Dense(self.hidden_layers[0], activation="relu")(latent)
        for units in self.hidden_layers[1:]:
            linear = zl.Dense(units, activation="relu")(linear)
        if self.include_mf:
            if self.mf_embed <= 0:
                raise ValueError("include_mf needs mf_embed > 0")
            mf_latent = zl.FusedEmbeddings(
                [("mf_user_embed", self.user_count + 1, self.mf_embed),
                 ("mf_item_embed", self.item_count + 1, self.mf_embed)],
                combine="mul", init="uniform", name="mf_embed_bag")(inp)
            concated = zl.merge([linear, mf_latent], mode="concat")
            out = zl.Dense(self.class_num, activation="softmax")(concated)
        else:
            out = zl.Dense(self.class_num, activation="softmax")(linear)
        return Model(input=inp, output=out)

    @staticmethod
    def tp_param_rules():
        """JAX's tensor-parallel layout: the embedding tables and the dense
        kernels shard over the model axis (a tables' columns, a kernel's
        output features; the head of 5 classes does not divide and stays
        whole). Give them to ``set_strategy`` / ``Estimator.from_keras``
        with a ``tp`` strategy."""
        return [(r"embed.*/embedding$", (None, "model")),
                (r"dense_\d+/kernel$", (None, "model"))]

    def _config(self):
        return dict(user_count=self.user_count, item_count=self.item_count,
                    class_num=self.class_num, user_embed=self.user_embed,
                    item_embed=self.item_embed,
                    hidden_layers=self.hidden_layers,
                    include_mf=self.include_mf, mf_embed=self.mf_embed)
