"""Sentiment analysis (mirrors ref apps/sentiment-analysis: embedding +
encoder text classifier on labelled reviews).

Synthetic reviews are built from positive/negative vocabularies, run
through the TextSet pipeline (tokenize → normalize → word2idx →
shape_sequence — ref TextSet.scala stages) and classified with the model
zoo's TextClassifier (CNN encoder) on the device.

The counterpart of examples/sentiment_analysis.py. Runs on the card by default;
``--device cpu`` runs it on the host:

    python examples_torch/sentiment_analysis.py [--device cpu]
"""

import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse

import numpy as np

POSITIVE = ["great", "wonderful", "loved", "amazing", "excellent",
            "delightful", "fantastic", "superb"]
NEGATIVE = ["terrible", "awful", "hated", "boring", "dreadful",
            "horrible", "worst", "disappointing"]
FILLER = ["the", "movie", "was", "plot", "acting", "scene", "film",
          "story", "and", "with", "really", "very"]


def make_reviews(n=240, seed=0):
    rng = np.random.RandomState(seed)
    texts, labels = [], []
    for i in range(n):
        label = int(rng.randint(0, 2))
        vocab = POSITIVE if label else NEGATIVE
        words = list(rng.choice(FILLER, 8)) + list(rng.choice(vocab, 3))
        rng.shuffle(words)
        texts.append(" ".join(words))
        labels.append(label)
    return texts, np.asarray(labels, np.int32)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    device = ap.parse_args(argv).device

    from analytics_zoo_tpu_torch import init_orca_context, stop_orca_context
    from analytics_zoo_tpu_torch.feature.text import TextSet
    from analytics_zoo_tpu_torch.models import TextClassifier

    init_orca_context(cluster_mode="local", device=device)
    texts, labels = make_reviews()
    ts = TextSet.from_texts(texts, labels=labels)
    ts = ts.tokenize().normalize().word2idx() \
           .shape_sequence(len=16).generate_sample()
    data = ts.to_dataset().collect()
    x = np.concatenate([d["x"] for d in data]).astype(np.float32)
    y = np.concatenate([d["y"] for d in data]).astype(np.int32)

    clf = TextClassifier(class_num=2, vocab_size=len(ts.get_word_index()),
                         token_length=16, sequence_length=16,
                         encoder="cnn", encoder_output_dim=16)
    clf.compile(optimizer="adam", loss="sparse_categorical_crossentropy",
                metrics=["accuracy"], device=device)
    split = 192
    clf.fit(x[:split], y[:split], batch_size=32, nb_epoch=10)
    res = clf.evaluate(x[split:], y[split:], batch_size=32)
    print(f"sentiment analysis: val accuracy {res['accuracy']:.2f}")
    assert res["accuracy"] > 0.8, "sentiment classifier failed to converge"
    stop_orca_context()


if __name__ == "__main__":
    main()
