"""Image pipeline of the port (counterpart of
analytics_zoo_tpu/feature/image/): ImageSet and the numpy/OpenCV
transforms."""

from analytics_zoo_tpu_torch.feature.image.imageset import ImageSet
from analytics_zoo_tpu_torch.feature.image.transforms import (
    ImageBrightness,
    ImageCenterCrop,
    ImageChannelNormalize,
    ImageHFlip,
    ImageMatToTensor,
    ImagePixelNormalize,
    ImageRandomCrop,
    ImageResize,
    ImageSetToSample,
)

__all__ = [
    "ImageSet", "ImageResize", "ImageBrightness", "ImageChannelNormalize",
    "ImagePixelNormalize", "ImageCenterCrop", "ImageRandomCrop",
    "ImageHFlip", "ImageMatToTensor", "ImageSetToSample",
]
