"""Image classification models of the port (counterpart of
analytics_zoo_tpu/models/image/imageclassification/): ResNet-18/50,
Inception-v1, MobileNetV2 and VGG-16, and the `ImageClassifier`
facade over them by name."""

from analytics_zoo_tpu_torch.models.image.imageclassification.resnet import (  # noqa: F401,E501
    BasicBlock,
    BottleneckBlock,
    ImageClassifier,
    ResNet,
    ResNet18,
    ResNet50,
)
from analytics_zoo_tpu_torch.models.image.imageclassification.inception import (  # noqa: F401,E501
    InceptionV1,
)
from analytics_zoo_tpu_torch.models.image.imageclassification.mobilenet import (  # noqa: F401,E501
    MobileNetV2,
)
from analytics_zoo_tpu_torch.models.image.imageclassification.vgg import (  # noqa: F401,E501
    VGG16,
)

ImageClassifier.BACKBONES.update({
    "inception-v1": InceptionV1,
    "mobilenet-v2": MobileNetV2,
    "vgg-16": VGG16,
})
