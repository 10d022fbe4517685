"""3-D image (volume) transforms (ref ``feature/image3d``)."""

from analytics_zoo_tpu_torch.feature.image3d.transforms import (  # noqa: F401
    AffineTransform3D,
    CenterCrop3D,
    Crop3D,
    ImagePreprocessing3D,
    RandomCrop3D,
    Rotate3D,
    Warp3D,
    rotation_matrix,
)
