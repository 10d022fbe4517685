"""Object detection (ref ``models/image/objectdetection``): SSD models, the
multibox loss, the host's box utilities and evaluation."""

from analytics_zoo_tpu_torch.models.image.objectdetection.bbox_util import (
    decode_boxes,
    encode_targets,
    generate_anchors,
    iou_matrix,
    nms,
)
from analytics_zoo_tpu_torch.models.image.objectdetection.evaluation import (
    Visualizer,
    average_precision,
    mean_average_precision,
)
from analytics_zoo_tpu_torch.models.image.objectdetection.multibox_loss \
    import MultiBoxLoss
from analytics_zoo_tpu_torch.models.image.objectdetection.object_detector \
    import ObjectDetector, SSD300VGG, SSDLite

__all__ = [
    "generate_anchors", "iou_matrix", "encode_targets", "decode_boxes",
    "nms", "MultiBoxLoss", "SSDLite", "SSD300VGG", "ObjectDetector",
    "mean_average_precision", "average_precision", "Visualizer",
]
