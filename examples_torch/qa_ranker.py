"""QA ranking end-to-end (mirrors ref pyzoo/zoo/examples/qaranker/
qa_ranker.py: question/answer corpora read from csv, relation pairs for
pairwise KNRM training, relation lists scored with NDCG and MAP).

Synthetic corpora where the correct answer repeats the question's key
token, so kernel-pooled lexical overlap is learnable. Everything runs the
public pipeline: TextSet.read_csv → tokenize/normalize/word2idx/
shape_sequence → Relations.read → from_relation_pairs/lists → KNRM.

The counterpart of examples/qa_ranker.py. Runs on the card by default;
``--device cpu`` runs it on the host:

    python examples_torch/qa_ranker.py [--device cpu]
"""

import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import os
import tempfile

import numpy as np

Q_LEN, A_LEN = 6, 8
TOPICS = ["alpha", "bravo", "charlie", "delta", "echo", "foxtrot",
          "golf", "hotel"]


def write_corpora(d, n_questions=24, seed=0):
    """question/answer csvs + train/valid relation csvs in the reference's
    qaranker layout (id,text columns; id1,id2,label relations)."""
    rng = np.random.RandomState(seed)
    q_rows, a_rows, rels = [], [], []
    for i in range(n_questions):
        topic = TOPICS[i % len(TOPICS)]
        qid, good, bad = f"q{i}", f"a{i}g", f"a{i}b"
        wrong = TOPICS[(i + 3) % len(TOPICS)]
        q_rows.append(f'{qid},"what about {topic} topic number {i}"')
        a_rows.append(f'{good},"the {topic} answer covers {topic} fully"')
        a_rows.append(f'{bad},"unrelated {wrong} text about {wrong}"')
        rels.append((qid, good, 1))
        rels.append((qid, bad, 0))
    with open(os.path.join(d, "question_corpus.csv"), "w") as f:
        f.write("id,text\n" + "\n".join(q_rows))
    with open(os.path.join(d, "answer_corpus.csv"), "w") as f:
        f.write("id,text\n" + "\n".join(a_rows))
    cut = (n_questions * 3) // 4 * 2
    with open(os.path.join(d, "relation_train.csv"), "w") as f:
        f.write("\n".join(f"{a},{b},{c}" for a, b, c in rels[:cut]))
    with open(os.path.join(d, "relation_valid.csv"), "w") as f:
        f.write("\n".join(f"{a},{b},{c}" for a, b, c in rels[cut:]))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    device = ap.parse_args(argv).device

    from analytics_zoo_tpu_torch import init_orca_context, stop_orca_context
    from analytics_zoo_tpu_torch.feature.text import Relations, TextSet
    from analytics_zoo_tpu_torch.models.textmatching import KNRM
    from analytics_zoo_tpu_torch.models.textmatching.knrm import (evaluate_map,
                                                            evaluate_ndcg)

    init_orca_context(cluster_mode="local", device=device)
    try:
        with tempfile.TemporaryDirectory() as d:
            write_corpora(d)
            q_set = (TextSet.read_csv(os.path.join(d, "question_corpus.csv"))
                     .tokenize().normalize().word2idx()
                     .shape_sequence(Q_LEN))
            a_set = (TextSet.read_csv(os.path.join(d, "answer_corpus.csv"))
                     .tokenize().normalize()
                     .word2idx(existing_map=q_set.get_word_index())
                     .shape_sequence(A_LEN))

            train_rel = Relations.read(os.path.join(d, "relation_train.csv"))
            train_set = TextSet.from_relation_pairs(train_rel, q_set, a_set)
            valid_rel = Relations.read(os.path.join(d, "relation_valid.csv"))
            valid_set = TextSet.from_relation_lists(valid_rel, q_set, a_set)

            vocab = max(q_set.get_word_index().values())
            knrm = KNRM(text1_length=Q_LEN, text2_length=A_LEN,
                        vocab_size=vocab + 1, embed_dim=16, kernel_num=11)
            knrm.compile(optimizer="adam", loss="binary_crossentropy",
                         device=device)
            xs = np.concatenate([s["x"] for s in train_set.get_samples()])
            ys = np.concatenate([s["y"] for s in train_set.get_samples()])
            history = knrm.fit(xs.astype(np.float32), ys, batch_size=24,
                               nb_epoch=12)
            print("train loss per epoch:",
                  [round(v, 4) for v in history["loss"][-4:]])

            ndcgs, maps = [], []
            for s in valid_set.get_samples():
                scores = np.asarray(
                    knrm.predict(s["x"].astype(np.float32),
                                 distributed=False))[:, 0]
                ndcgs.append(evaluate_ndcg(s["y"][:, 0], scores, k=3))
                maps.append(evaluate_map(s["y"][:, 0], scores))
            print(f"validation NDCG@3 = {np.mean(ndcgs):.3f}, "
                  f"MAP = {np.mean(maps):.3f} over {len(ndcgs)} queries")
            assert np.mean(maps) > 0.6, "ranker failed to learn overlap"
    finally:
        stop_orca_context()


if __name__ == "__main__":
    main()
