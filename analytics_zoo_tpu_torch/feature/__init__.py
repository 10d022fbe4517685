"""Feature pipelines (ref ``zoo/.../feature/``): the image pipeline,
``ImageSet`` and its transforms (``feature/image``). Text and 3-D image
features wait for later slices (ROADMAP A11)."""

from analytics_zoo_tpu_torch.feature.image import ImageSet  # noqa: F401
