"""Feature pipelines (ref ``zoo/.../feature/``): the image pipeline,
``ImageSet`` and its transforms (``feature/image``), and the text
pipeline, ``TextSet`` (``feature/text``), and the 3-D volume transforms
(``feature/image3d``)."""

from analytics_zoo_tpu_torch.feature.image import ImageSet  # noqa: F401
from analytics_zoo_tpu_torch.feature.text import TextSet, TextFeature  # noqa: F401
