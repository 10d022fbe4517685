"""The image pipeline: ``ImageSet``, ``ImageFeature``, ``chained`` and
every transform of ``transforms.py``."""

from analytics_zoo_tpu_torch.feature.image.imageset import (  # noqa: F401
    ImageFeature, ImageSet, chained,
)
from analytics_zoo_tpu_torch.feature.image.transforms import (  # noqa: F401
    ImagePreprocessing, ChainedPreprocessing, ImageResize, ImageAspectScale,
    ImageRandomAspectScale, ImageCenterCrop, ImageRandomCrop, ImageFixedCrop,
    ImageHFlip, ImageRandomFlip, ImageChannelNormalize, ImagePixelNormalizer,
    ImageChannelScaledNormalizer, ImageBrightness, ImageContrast,
    ImageSaturation, ImageHue, ImageColorJitter, ImageExpand, ImageFiller,
    ImageRandomPreprocessing, ImageBytesToArray, ImageSetToSample,
    ImageMatToTensor, ImageMirror, ImageChannelOrder, PerImageNormalize,
    ImageBytesToMat, ImagePixelBytesToMat, ImagePixelNormalize,
    ImageFeatureToTensor, ImageFeatureToSample, RowToImageFeature,
)
