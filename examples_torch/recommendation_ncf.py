"""NCF recommendation end-to-end on the PyTorch port (the counterpart of
examples/recommendation_ncf.py; ref apps/recommendation-ncf/
ncf-explicit-feedback.ipynb): train NeuralCF on MovieLens-style ratings,
evaluate, predict, recommend, checkpoint round-trip.

Runs on the card by default; ``--device cpu`` runs it on the host:

    python examples_torch/recommendation_ncf.py [--device cpu]
"""

import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import os
import tempfile

import numpy as np


def make_ratings(n=20_000, users=200, items=100, seed=0):
    """Synthetic explicit feedback in the ml-1m (user, item, rating) shape."""
    rng = np.random.RandomState(seed)
    u = rng.randint(1, users + 1, n)
    i = rng.randint(1, items + 1, n)
    # latent structure so the model has something to learn
    taste = (u * 7 + i * 3) % 5
    return u, i, taste.astype(np.int32)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    device = ap.parse_args(argv).device

    from analytics_zoo_tpu_torch import init_orca_context, stop_orca_context
    from analytics_zoo_tpu_torch.models.recommendation import NeuralCF

    init_orca_context(cluster_mode="local", device=device)
    try:
        users, items = 200, 100
        u, i, y = make_ratings()
        x = np.stack([u, i], 1).astype(np.float32)

        ncf = NeuralCF(user_count=users, item_count=items, class_num=5)
        ncf.compile(optimizer="adam",
                    loss="sparse_categorical_crossentropy",
                    metrics=["accuracy"], device=device)
        history = ncf.fit(x, y, batch_size=800, nb_epoch=3,
                          validation_data=(x[:2000], y[:2000]))
        print("train loss per epoch:", [round(v, 4) for v in history["loss"]])

        scores = ncf.evaluate(x[:2000], y[:2000], batch_size=800)
        print("eval:", {k: round(v, 4) for k, v in scores.items()})

        probs = np.asarray(ncf.predict(x[:10]))
        print("first predictions:", probs.argmax(1).tolist())

        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "ncf")
            ncf.save_model(path)
            from analytics_zoo_tpu_torch.models.common import ZooModel
            restored = ZooModel.load_model(path)
            p2 = np.asarray(restored.predict(x[:10], device=device))
            assert np.allclose(probs, p2, atol=1e-5)
            print("checkpoint round-trip OK")
        assert history["loss"][-1] < history["loss"][0]
    finally:
        stop_orca_context()


if __name__ == "__main__":
    main()
