"""The text pipeline: ``TextSet``, its transformers, ``Relation`` /
``Relations`` and ``load_glove``."""

from analytics_zoo_tpu_torch.feature.text.textset import (  # noqa: F401
    Normalizer, Relation, Relations, SequenceShaper, TextFeature,
    TextFeatureToSample, TextSet, TextTransformer, Tokenizer, WordIndexer,
    load_glove,
)
