"""Image similarity search (mirrors ref apps/image-similarity: embed
images with a CNN, index the L2-normalized embeddings, retrieve nearest
neighbors by cosine similarity).

Synthetic image classes with distinct structure are embedded by a small
CNN's penultimate layer through InferenceModel; retrieval quality is
checked by same-class precision@3. The embedding batch predict runs on
the card and the cosine ranking is one matmul.

The counterpart of examples/image_similarity.py. Runs on the card by default;
``--device cpu`` runs it on the host:

    python examples_torch/image_similarity.py [--device cpu]
"""

import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse

import numpy as np


def make_images(per_class=24, seed=0):
    """Three 16x16 RGB classes: vertical stripes, horizontal stripes,
    center blob — plus noise."""
    rng = np.random.RandomState(seed)
    images, labels = [], []
    for cls in range(3):
        for _ in range(per_class):
            img = rng.rand(16, 16, 3).astype(np.float32) * 0.3
            if cls == 0:
                img[:, ::4, 0] += 0.8
            elif cls == 1:
                img[::4, :, 1] += 0.8
            else:
                img[4:12, 4:12, 2] += 0.8
            images.append(img)
            labels.append(cls)
    return np.stack(images), np.asarray(labels)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    device = ap.parse_args(argv).device

    import torch
    import torch.nn as nn
    import torch.nn.functional as F
    from analytics_zoo_tpu_torch import init_orca_context, stop_orca_context
    from analytics_zoo_tpu_torch.inference import InferenceModel

    init_orca_context(cluster_mode="local", device=device)
    images, labels = make_images()

    class Embedder(nn.Module):
        """Random-projection CNN: untrained conv features are a standard
        cheap embedding for structural similarity (the reference uses a
        pretrained backbone's penultimate layer; no download here).
        Takes NHWC images, as the JAX example's flax module does."""

        def __init__(self):
            super().__init__()
            self.conv1 = nn.Conv2d(3, 8, 3, padding=1)
            self.conv2 = nn.Conv2d(8, 16, 3, padding=1)
            self.dense = nn.Linear(16, 32)

        def forward(self, x):
            x = F.relu(self.conv1(x.permute(0, 3, 1, 2)))
            x = F.avg_pool2d(x, 2, 2)
            x = F.relu(self.conv2(x))
            x = x.mean(dim=(2, 3))
            return self.dense(x)

    torch.manual_seed(0)
    im = InferenceModel(device=device).load_torch(Embedder(), images[:1])
    emb = np.asarray(im.predict(images, batch_size=24))
    emb = emb / np.linalg.norm(emb, axis=1, keepdims=True)

    sims = emb @ emb.T                      # cosine similarity matrix
    np.fill_diagonal(sims, -np.inf)
    top3 = np.argsort(-sims, axis=1)[:, :3]
    precision = (labels[top3] == labels[:, None]).mean()
    print(f"image similarity: precision@3 = {precision:.2f} "
          f"({len(images)} images, 3 classes)")
    assert precision > 0.9, "same-class neighbors not retrieved"

    query = 0
    print(f"query image class {labels[query]} → neighbor classes "
          f"{labels[top3[query]].tolist()}")
    stop_orca_context()


if __name__ == "__main__":
    main()
