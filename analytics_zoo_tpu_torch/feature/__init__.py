"""Feature pipelines (ref ``zoo/.../feature/``): the image pipeline,
``ImageSet`` and its transforms (``feature/image``), and the text
pipeline, ``TextSet`` (``feature/text``). 3-D image features wait for a
later slice (ROADMAP A11)."""

from analytics_zoo_tpu_torch.feature.image import ImageSet  # noqa: F401
from analytics_zoo_tpu_torch.feature.text import TextSet  # noqa: F401
