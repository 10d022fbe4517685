"""Wide & Deep recommender.

Counterpart of ``analytics_zoo_tpu/models/recommendation/wide_and_deep.py``
(ref ``pyzoo/zoo/models/recommendation/wide_and_deep.py:60-200``, Scala
``WideAndDeep.scala:101``). Same signature, same three variants ("wide",
"deep", "wide_n_deep"), same four inputs (the wide one-hot block, the
indicator block, the embedding ids, the continuous columns) and the same
parameter names. The wide part is a dense product over the one-hot block;
the deep part looks every categorical column up in ONE
``FusedEmbeddings("embed_columns", combine="concat")`` (tables
``embed_{i}`` of ``in_dim + 1`` rows): one launch of the fused lookup
kernel a forward on the card, and one scatter-add launch per table a
backward (ops/csrc/embedding_bag.cu).
"""

from __future__ import annotations

from analytics_zoo_tpu_torch.keras import Input, Model
from analytics_zoo_tpu_torch.keras import layers as zl
from analytics_zoo_tpu_torch.models.common import registry
from analytics_zoo_tpu_torch.models.recommendation.recommender import (
    Recommender,
)


class ColumnFeatureInfo:
    """(ref wide_and_deep.py:60-93: the feature-column schema object)"""

    def __init__(self, wide_base_cols=None, wide_base_dims=None,
                 wide_cross_cols=None, wide_cross_dims=None,
                 indicator_cols=None, indicator_dims=None,
                 embed_cols=None, embed_in_dims=None, embed_out_dims=None,
                 continuous_cols=None, label="label"):
        self.wide_base_cols = wide_base_cols or []
        self.wide_base_dims = wide_base_dims or []
        self.wide_cross_cols = wide_cross_cols or []
        self.wide_cross_dims = wide_cross_dims or []
        self.indicator_cols = indicator_cols or []
        self.indicator_dims = indicator_dims or []
        self.embed_cols = embed_cols or []
        self.embed_in_dims = embed_in_dims or []
        self.embed_out_dims = embed_out_dims or []
        self.continuous_cols = continuous_cols or []
        self.label = label


@registry.register
class WideAndDeep(Recommender):
    """(ref wide_and_deep.py:94-200: class_num, column_info, model_type,
    hidden_layers)"""

    def __init__(self, class_num, column_info=None, model_type="wide_n_deep",
                 hidden_layers=(40, 20, 10), **cfg_kwargs):
        super().__init__()
        if column_info is None:         # the reload path: config given flat
            column_info = ColumnFeatureInfo(**cfg_kwargs)
        info = column_info
        if not (len(info.wide_base_cols) == len(info.wide_base_dims)
                and len(info.wide_cross_cols) == len(info.wide_cross_dims)
                and len(info.indicator_cols) == len(info.indicator_dims)
                and len(info.embed_cols) == len(info.embed_in_dims)
                == len(info.embed_out_dims)):
            raise ValueError("each column list needs its dims, one for one")
        self.class_num = int(class_num)
        self.column_info = column_info
        self.model_type = model_type
        self.hidden_layers = [int(u) for u in hidden_layers]
        self.model = self.build_model()

    # ---- graph (ref wide_and_deep.py:141-200, layer for layer) ----
    def build_model(self):
        info = self.column_info
        wide_dims = sum(info.wide_base_dims) + sum(info.wide_cross_dims)
        input_wide = Input(shape=(wide_dims,), name="wide")
        input_ind = Input(shape=(sum(info.indicator_dims),),
                          name="indicator")
        input_emb = Input(shape=(len(info.embed_cols),), name="embed")
        input_con = Input(shape=(len(info.continuous_cols),),
                          name="continuous")

        wide_linear = zl.Dense(self.class_num, name="wide_linear")(input_wide)

        if self.model_type == "wide":
            out = zl.Activation("softmax")(wide_linear)
            return Model(input=input_wide, output=out)
        if self.model_type == "deep":
            deep_inputs, merge_list = self._deep_merge(input_ind, input_emb,
                                                       input_con)
            out = zl.Activation("softmax")(self._deep_hidden(merge_list))
            return Model(input=deep_inputs, output=out)
        if self.model_type == "wide_n_deep":
            deep_inputs, merge_list = self._deep_merge(input_ind, input_emb,
                                                       input_con)
            deep_linear = self._deep_hidden(merge_list)
            merged = zl.merge([wide_linear, deep_linear], mode="sum")
            out = zl.Activation("softmax")(merged)
            return Model(input=[input_wide] + deep_inputs, output=out)
        raise TypeError(f"Unsupported model_type: {self.model_type}")

    def _deep_hidden(self, merge_list):
        merged = merge_list[0] if len(merge_list) == 1 else \
            zl.merge(merge_list, mode="concat")
        linear = zl.Dense(self.hidden_layers[0], activation="relu")(merged)
        for units in self.hidden_layers[1:]:
            linear = zl.Dense(units, activation="relu")(linear)
        return zl.Dense(self.class_num, activation="relu")(linear)

    def _deep_merge(self, input_ind, input_emb, input_con):
        info = self.column_info
        inputs, merged = [], []
        if info.indicator_dims:
            inputs.append(input_ind)
            merged.append(input_ind)
        if info.embed_cols:
            inputs.append(input_emb)
            merged.append(zl.FusedEmbeddings(
                [(f"embed_{i}", in_dim + 1, out_dim)
                 for i, (in_dim, out_dim) in enumerate(
                     zip(info.embed_in_dims, info.embed_out_dims))],
                combine="concat", init="normal",
                name="embed_columns")(input_emb))
        if info.continuous_cols:
            inputs.append(input_con)
            merged.append(input_con)
        if not merged:
            raise ValueError("a deep model needs indicator, embed or "
                             "continuous columns")
        return inputs, merged

    @staticmethod
    def tp_param_rules():
        """The JAX package's tensor-parallel layout: the tables and the
        dense kernels shard over the model axis (a table's columns, a
        kernel's output features). Give them to ``set_strategy`` /
        ``Estimator.from_keras`` with a ``tp`` strategy."""
        return [(r"embed_\d+/embedding$", (None, "model")),
                (r"dense_\d+/kernel$", (None, "model"))]

    def _config(self):
        info = self.column_info
        return dict(class_num=self.class_num, model_type=self.model_type,
                    hidden_layers=self.hidden_layers,
                    wide_base_cols=info.wide_base_cols,
                    wide_base_dims=info.wide_base_dims,
                    wide_cross_cols=info.wide_cross_cols,
                    wide_cross_dims=info.wide_cross_dims,
                    indicator_cols=info.indicator_cols,
                    indicator_dims=info.indicator_dims,
                    embed_cols=info.embed_cols,
                    embed_in_dims=info.embed_in_dims,
                    embed_out_dims=info.embed_out_dims,
                    continuous_cols=info.continuous_cols)
