"""Object detection of the port (counterpart of
analytics_zoo_tpu/models/image/objectdetection/): SSD and a two-stage
Faster-RCNN-style detector, and their box utilities."""

from analytics_zoo_tpu_torch.models.image.objectdetection.box_utils import (  # noqa: F401,E501
    decode_boxes,
    encode_boxes,
    generate_anchors,
    iou_matrix,
    nms,
)
from analytics_zoo_tpu_torch.models.image.objectdetection.faster_rcnn import (  # noqa: F401,E501
    FasterRCNNDetector,
    roi_align,
)
from analytics_zoo_tpu_torch.models.image.objectdetection.ssd import (  # noqa: F401,E501
    SSDDetector,
)

__all__ = ["SSDDetector", "FasterRCNNDetector", "roi_align",
           "generate_anchors", "iou_matrix", "encode_boxes",
           "decode_boxes", "nms"]
