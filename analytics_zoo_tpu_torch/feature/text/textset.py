"""TextSet: the text-classification and QA-ranking pipeline on the host.

The port's own copy of ``analytics_zoo_tpu/feature/text/textset.py`` (ref
``zoo/src/main/scala/com/intel/analytics/zoo/feature/text/TextSet.scala``:
read, tokenize, normalize, word2idx, shape, sample; relation pairs and
lists for QA ranking; and ``pyzoo/zoo/feature/text/text_set.py``). Every
stage runs on the host over the port's ``data/shard.HostXShards``, with
the JAX package's code, so the same texts give bitwise the same ids; the
output of ``to_dataset`` is fixed-length int32 id matrices (padded or
truncated by ``SequenceShaper``), which the estimator copies to the
device a batch at a time. ``Relations.read_parquet`` needs pyarrow and
raises an ``ImportError`` naming it where pyarrow is missing."""

from __future__ import annotations

import os
import re
import string
from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from analytics_zoo_tpu_torch.data.shard import HostXShards


class TextFeature(dict):
    """A text record: ``text``, optional ``label``, accumulating ``tokens``
    then ``indexed_tokens`` then ``sample`` (ref TextFeature.scala keys)."""

    @property
    def text(self):
        return self.get("text")


class Relation:
    """A (id1, id2, label) relationship between two corpus items
    (ref pyzoo/zoo/feature/common.py:30 Relation)."""

    __slots__ = ("id1", "id2", "label")

    def __init__(self, id1, id2, label):
        self.id1, self.id2, self.label = str(id1), str(id2), int(label)

    def to_tuple(self):
        return self.id1, self.id2, self.label

    def __repr__(self):
        return f"Relation [id1: {self.id1}, id2: {self.id2}, " \
               f"label: {self.label}]"

    def __eq__(self, other):
        return isinstance(other, Relation) and \
            self.to_tuple() == other.to_tuple()


class Relations:
    """Relation readers (ref pyzoo/zoo/feature/common.py:52 Relations.read /
    read_parquet — csv/txt rows are ``id1,id2,label`` without header)."""

    @staticmethod
    def read(path: str) -> List[Relation]:
        out = []
        with open(path, "r", errors="ignore") as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                id1, id2, label = line.split(",")[:3]
                out.append(Relation(id1, id2, int(label)))
        return out

    @staticmethod
    def read_parquet(path: str) -> List[Relation]:
        import importlib.util
        if importlib.util.find_spec("pyarrow") is None:
            raise ImportError(
                "Relations.read_parquet needs pyarrow, which is not "
                "installed; write the relations as csv rows (id1,id2,label) "
                "and use Relations.read")
        import pandas as pd
        df = pd.read_parquet(path)
        return [Relation(r.id1, r.id2, int(r.label))
                for r in df.itertuples(index=False)]


class TextTransformer:
    """Base stage (ref text/TextTransformer.scala)."""

    def transform(self, feature: TextFeature) -> TextFeature:  # pragma: no cover
        raise NotImplementedError

    def __call__(self, feature):
        return self.transform(feature)


class Tokenizer(TextTransformer):
    """Whitespace/word tokenizer (ref text/Tokenizer.scala)."""

    _PAT = re.compile(r"[\w']+")

    def transform(self, feature):
        feature = TextFeature(feature)
        feature["tokens"] = self._PAT.findall(feature["text"])
        return feature


class Normalizer(TextTransformer):
    """Lower-case and strip punctuation/digits from tokens
    (ref text/Normalizer.scala)."""

    _TABLE = str.maketrans("", "", string.punctuation)

    def transform(self, feature):
        feature = TextFeature(feature)
        toks = [t.lower().translate(self._TABLE) for t in feature["tokens"]]
        feature["tokens"] = [t for t in toks if t]
        return feature


class WordIndexer(TextTransformer):
    """tokens → int ids given a word→index map (1-based; 0 is the pad/OOV id,
    matching ref TextSet.word2idx semantics where index starts at 1)."""

    def __init__(self, vocab: Dict[str, int]):
        self.vocab = vocab

    def transform(self, feature):
        feature = TextFeature(feature)
        feature["indexed_tokens"] = [
            self.vocab.get(t, 0) for t in feature["tokens"]]
        return feature


class SequenceShaper(TextTransformer):
    """Pad/truncate to ``len`` (ref text/SequenceShaper.scala; trunc_mode
    pre|post)."""

    def __init__(self, len: int, trunc_mode: str = "pre", pad_element: int = 0):
        self.len, self.trunc_mode, self.pad = len, trunc_mode, pad_element

    def transform(self, feature):
        feature = TextFeature(feature)
        ids = feature["indexed_tokens"]
        if len(ids) > self.len:
            ids = ids[-self.len:] if self.trunc_mode == "pre" else ids[:self.len]
        else:
            ids = ids + [self.pad] * (self.len - len(ids))
        feature["indexed_tokens"] = ids
        return feature


class TextFeatureToSample(TextTransformer):
    """Pack ids (+label) into a sample (ref text/TextFeatureToSample.scala)."""

    def transform(self, feature):
        feature = TextFeature(feature)
        sample = {"x": np.asarray(feature["indexed_tokens"], np.int32)}
        if "label" in feature:
            sample["y"] = np.asarray(feature["label"])
        feature["sample"] = sample
        return feature


class TextSet:
    """Sharded collection of TextFeatures with the standard NLP pipeline.

    ``tokenize().normalize().word2idx().shape_sequence(l).generate_sample()``
    mirrors ref TextSet.scala's stage methods."""

    def __init__(self, shards: HostXShards,
                 word_index: Optional[Dict[str, int]] = None):
        self.shards = shards
        self._word_index = word_index

    # ---------- constructors ----------

    @classmethod
    def from_texts(cls, texts: Sequence[str], labels: Optional[Sequence] = None,
                   num_shards: Optional[int] = None,
                   ids: Optional[Sequence[str]] = None) -> "TextSet":
        feats = []
        for i, t in enumerate(texts):
            f = TextFeature(text=t)
            if labels is not None:
                f["label"] = labels[i]
            if ids is not None:
                f["id"] = str(ids[i])
            feats.append(f)
        return cls(HostXShards.from_records(feats, num_shards))

    @classmethod
    def read(cls, path: str, num_shards: Optional[int] = None) -> "TextSet":
        """Read a folder of ``<class>/<file>.txt`` (ref TextSet.read: text
        classification layout, subfolder name = category)."""
        texts, labels = [], []
        classes = sorted(d for d in os.listdir(path)
                         if os.path.isdir(os.path.join(path, d)))
        label_map = {c: i for i, c in enumerate(classes)}
        for c in classes:
            cdir = os.path.join(path, c)
            for fn in sorted(os.listdir(cdir)):
                fp = os.path.join(cdir, fn)
                if os.path.isfile(fp):
                    with open(fp, "r", errors="ignore") as fh:
                        texts.append(fh.read())
                    labels.append(label_map[c])
        return cls.from_texts(texts, labels, num_shards)

    @classmethod
    def read_csv(cls, path: str, num_shards: Optional[int] = None) -> "TextSet":
        """Read ``id,text[,label]`` csv (ref TextSet.readCSV used by QA —
        the id column keys relation joins)."""
        import pandas as pd
        df = pd.read_csv(path)
        cols = list(df.columns)
        labels = df[cols[2]].tolist() if len(cols) > 2 else None
        return cls.from_texts(df[cols[1]].astype(str).tolist(), labels,
                              num_shards,
                              ids=df[cols[0]].astype(str).tolist())

    # ---------- QA-ranking relation joins (ref TextSet.scala
    # fromRelationPairs/fromRelationLists; pyzoo text_set.py:369,401) ----------

    @staticmethod
    def _corpus_index(corpus: "TextSet", what: str) -> Dict[str, np.ndarray]:
        idx: Dict[str, np.ndarray] = {}
        for f in corpus._features():
            if "id" not in f or "indexed_tokens" not in f:
                raise ValueError(
                    f"{what} features need an 'id' and indexed tokens — "
                    "read with ids and run tokenize/word2idx/shape_sequence "
                    "first")
            idx[f["id"]] = np.asarray(f["indexed_tokens"], np.int32)
        return idx

    @classmethod
    def from_relation_pairs(cls, relations: Sequence["Relation | tuple"],
                            corpus1: "TextSet", corpus2: "TextSet",
                            num_shards: Optional[int] = None) -> "TextSet":
        """Pairwise-ranking TextSet: for each id1, every (positive id2,
        negative id2) combination becomes one feature whose sample is
        ``x: (2, len1+len2)`` int ids (positive row first) and
        ``y: (2, 1) = [[1],[0]]`` (ref text_set.py:369 — same join, minus
        the RDD machinery; corpora must be shaped to fixed lengths)."""
        c1 = cls._corpus_index(corpus1, "corpus1")
        c2 = cls._corpus_index(corpus2, "corpus2")
        pos: Dict[str, List[str]] = {}
        neg: Dict[str, List[str]] = {}
        for r in relations:
            id1, id2, label = r.to_tuple() if isinstance(r, Relation) else r
            (pos if int(label) > 0 else neg).setdefault(str(id1), []).append(
                str(id2))
        feats = []
        y = np.array([[1.0], [0.0]], np.float32)
        for id1 in sorted(pos):
            if id1 not in neg:
                continue
            t1 = c1[id1]
            for p in pos[id1]:
                for n in neg[id1]:
                    x = np.stack([np.concatenate([t1, c2[p]]),
                                  np.concatenate([t1, c2[n]])])
                    feats.append(TextFeature(
                        id=id1, sample={"x": x.astype(np.float32), "y": y}))
        return cls(HostXShards.from_records(feats, num_shards),
                   corpus1.get_word_index())

    @classmethod
    def from_relation_lists(cls, relations: Sequence["Relation | tuple"],
                            corpus1: "TextSet", corpus2: "TextSet",
                            num_shards: Optional[int] = None) -> "TextSet":
        """Listwise-ranking TextSet: group relations by id1; each feature's
        sample is ``x: (list_len, len1+len2)`` and ``y: (list_len, 1)``
        labels, for ranking metrics like NDCG/MAP (ref text_set.py:401)."""
        c1 = cls._corpus_index(corpus1, "corpus1")
        c2 = cls._corpus_index(corpus2, "corpus2")
        grouped: Dict[str, List[Tuple[str, int]]] = {}
        for r in relations:
            id1, id2, label = r.to_tuple() if isinstance(r, Relation) else r
            grouped.setdefault(str(id1), []).append((str(id2), int(label)))
        feats = []
        for id1 in sorted(grouped):
            t1 = c1[id1]
            rows = np.stack([np.concatenate([t1, c2[id2]])
                             for id2, _ in grouped[id1]])
            labels = np.asarray([[lab] for _, lab in grouped[id1]],
                                np.float32)
            feats.append(TextFeature(
                id=id1, sample={"x": rows.astype(np.float32), "y": labels}))
        return cls(HostXShards.from_records(feats, num_shards),
                   corpus1.get_word_index())

    # ---------- pipeline stages ----------

    def _map(self, fn, word_index=None) -> "TextSet":
        return TextSet(
            self.shards.transform_shard(lambda s: [fn(f) for f in s]),
            word_index if word_index is not None else self._word_index)

    def transform(self, transformer: TextTransformer) -> "TextSet":
        return self._map(transformer.transform)

    def tokenize(self) -> "TextSet":
        return self.transform(Tokenizer())

    def normalize(self) -> "TextSet":
        return self.transform(Normalizer())

    def word2idx(self, remove_topN: int = 0,
                 max_words_num: int = -1,
                 min_freq: int = 1,
                 existing_map: Optional[Dict[str, int]] = None) -> "TextSet":
        """Build the vocabulary and index tokens (ref TextSet.word2idx:
        frequency-sorted, optional drop of top-N most frequent, cap, floor)."""
        if existing_map is not None:
            vocab = dict(existing_map)
        else:
            counter: Counter = Counter()
            for shard in self.shards.collect():
                for f in shard:
                    counter.update(f["tokens"])
            items = [(w, c) for w, c in counter.items() if c >= min_freq]
            items.sort(key=lambda wc: (-wc[1], wc[0]))
            items = items[remove_topN:]
            if max_words_num > 0:
                items = items[:max_words_num]
            vocab = {w: i + 1 for i, (w, _) in enumerate(items)}
        out = self._map(WordIndexer(vocab).transform, word_index=vocab)
        return out

    def shape_sequence(self, len: int, trunc_mode: str = "pre") -> "TextSet":
        return self.transform(SequenceShaper(len, trunc_mode))

    def generate_sample(self) -> "TextSet":
        return self.transform(TextFeatureToSample())

    # ---------- accessors ----------

    def get_word_index(self) -> Optional[Dict[str, int]]:
        return self._word_index

    def get_texts(self) -> List[str]:
        return [f["text"] for f in self._features()]

    def get_labels(self) -> List:
        return [f.get("label") for f in self._features()]

    def get_samples(self) -> List[dict]:
        return [f["sample"] for f in self._features()]

    def _features(self) -> List[TextFeature]:
        out = []
        for shard in self.shards.collect():
            out.extend(shard)
        return out

    def to_dataset(self):
        """{'x','y'} ndarray shards for Estimator.fit."""
        def pack(shard):
            xs = np.stack([f["sample"]["x"] for f in shard])
            out = {"x": xs}
            if shard and "y" in shard[0]["sample"]:
                out["y"] = np.stack([f["sample"]["y"] for f in shard])
            return out
        return self.shards.transform_shard(pack)


def load_glove(path: str, vocab: Dict[str, int],
               dim: int) -> np.ndarray:
    """Load a GloVe-format embedding file into an (V+1, dim) matrix aligned
    to ``vocab`` ids (ref WordEmbedding.scala:49 glove loading; row 0 = pad)."""
    emb = np.random.RandomState(0).normal(0, 0.05,
                                          (len(vocab) + 1, dim)).astype(np.float32)
    emb[0] = 0.0
    with open(path, "r", errors="ignore") as fh:
        for line in fh:
            parts = line.rstrip().split(" ")
            if len(parts) != dim + 1:
                continue
            idx = vocab.get(parts[0])
            if idx is not None:
                emb[idx] = np.asarray(parts[1:], np.float32)
    return emb
