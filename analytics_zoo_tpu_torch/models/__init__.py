"""Model zoo (ref ``zoo/.../models/`` + ``pyzoo/zoo/models/``): the
models ported so far."""

from analytics_zoo_tpu_torch.models.anomalydetection import AnomalyDetector
from analytics_zoo_tpu_torch.models.common import ZooModel, registry
from analytics_zoo_tpu_torch.models.image import (
    ImageClassifier, ObjectDetector, SSD300VGG, SSDLite,
)
from analytics_zoo_tpu_torch.models.recommendation import (
    ColumnFeatureInfo, NeuralCF, SessionRecommender, WideAndDeep,
)
from analytics_zoo_tpu_torch.models.seq2seq import Seq2Seq
from analytics_zoo_tpu_torch.models.textclassification import TextClassifier
from analytics_zoo_tpu_torch.models.textmatching import KNRM

__all__ = ["ZooModel", "registry", "NeuralCF", "WideAndDeep",
           "ColumnFeatureInfo", "SessionRecommender", "AnomalyDetector",
           "Seq2Seq", "ImageClassifier", "TextClassifier", "KNRM",
           "ObjectDetector", "SSDLite", "SSD300VGG"]
