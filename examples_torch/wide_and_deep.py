"""Wide & Deep recommendation end-to-end on the PyTorch port (the
counterpart of examples/wide_and_deep.py; ref
apps/recommendation-wide-n-deep/wide_n_deep.ipynb: census-/ml-1m-style
tabular features engineered with Friesian, then a WideAndDeep model
trained, evaluated, and used for recommendations).

The feature path is Friesian's: a pandas-sharded ``FeatureTable``
(string-index + hash-cross, ref friesian table.py) feeds fixed-shape
batched arrays into the training step, whose user and item lookups run
the fused embedding kernel on the card.

    python examples_torch/wide_and_deep.py [--device cpu]
"""

import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse

import numpy as np
import pandas as pd


def make_interactions(n=6000, users=120, items=80, seed=0):
    """Synthetic (user, item, gender, age, occupation) interactions with a
    learnable rating structure, in the ml-1m joined-table shape."""
    rng = np.random.RandomState(seed)
    df = pd.DataFrame({
        "user": rng.randint(1, users + 1, n),
        "item": rng.randint(1, items + 1, n),
        "gender": rng.choice(["F", "M"], n),
        "age": rng.randint(18, 65, n).astype(np.float32),
        "occupation": rng.choice(["artist", "doctor", "engineer",
                                  "lawyer", "other"], n),
    })
    taste = ((df["user"] % 3) / 2.0 + (df["item"] % 3) / 2.0
             + (df["gender"] == "F") * 1.0
             + (df["occupation"].str.len() % 3) / 2.0
             + (df["age"] > 40) * 1.0)
    df["label"] = np.minimum(4, taste.round()).astype(np.int32)
    return df


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    device = ap.parse_args(argv).device

    from analytics_zoo_tpu_torch import init_orca_context, stop_orca_context
    from analytics_zoo_tpu_torch.friesian.feature import FeatureTable
    from analytics_zoo_tpu_torch.models.recommendation import (ColumnFeatureInfo,
                                                         WideAndDeep)

    init_orca_context(cluster_mode="local", device=device)
    try:
        users, items = 120, 80
        df = make_interactions(users=users, items=items)

        # --- Friesian feature engineering (ref FeatureTable surface) ---
        tbl = FeatureTable.from_pandas(df)
        idx = tbl.gen_string_idx(["gender", "occupation"])
        tbl = tbl.encode_string(["gender", "occupation"], idx)
        tbl = tbl.cross_columns([["gender", "occupation"]], [64])
        out = tbl.to_pandas()

        gender_dim = len(idx[0]) + 1
        occ_dim = len(idx[1]) + 1

        info = ColumnFeatureInfo(
            wide_base_cols=["gender", "occupation"],
            wide_base_dims=[gender_dim, occ_dim],
            wide_cross_cols=["gender_occupation"], wide_cross_dims=[64],
            indicator_cols=["gender"], indicator_dims=[gender_dim],
            embed_cols=["user", "item"],
            embed_in_dims=[users, items], embed_out_dims=[16, 16],
            continuous_cols=["age"])

        # one-hot the wide base + cross columns into the wide input block
        n = len(out)
        wide_dim = gender_dim + occ_dim + 64
        wide = np.zeros((n, wide_dim), np.float32)
        wide[np.arange(n), out["gender"].to_numpy()] = 1.0
        wide[np.arange(n), gender_dim + out["occupation"].to_numpy()] = 1.0
        wide[np.arange(n),
             gender_dim + occ_dim + out["gender_occupation"].to_numpy()] = 1.0
        indicator = np.zeros((n, gender_dim), np.float32)
        indicator[np.arange(n), out["gender"].to_numpy()] = 1.0
        embed = out[["user", "item"]].to_numpy(np.float32)
        cont = (out[["age"]].to_numpy(np.float32) - 40.0) / 12.0
        y = out["label"].to_numpy(np.int32)

        x = [wide, indicator, embed, cont]
        wnd = WideAndDeep(class_num=5, column_info=info,
                          model_type="wide_n_deep", hidden_layers=(40, 20))
        wnd.compile(optimizer="adam",
                    loss="sparse_categorical_crossentropy",
                    metrics=["accuracy"], device=device)
        history = wnd.fit(x, y, batch_size=256, nb_epoch=8,
                          validation_data=([v[:1000] for v in x], y[:1000]))
        print("train loss per epoch:",
              [round(v, 4) for v in history["loss"]])

        scores = wnd.evaluate([v[:1000] for v in x], y[:1000],
                              batch_size=256)
        print("eval:", {k: round(float(v), 4) for k, v in scores.items()})
        final_acc = scores.get("accuracy", 0.0)
        assert final_acc > 0.3, f"W&D failed to learn (acc={final_acc})"

        preds = np.asarray(wnd.predict([v[:8] for v in x]))
        print("predicted ratings:", preds.argmax(1).tolist())
        print("true ratings:     ", y[:8].tolist())
    finally:
        stop_orca_context()


if __name__ == "__main__":
    main()
