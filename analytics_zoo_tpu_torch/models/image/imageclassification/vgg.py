"""VGG-16 (counterpart of analytics_zoo_tpu/models/image/
imageclassification/vgg.py): configuration D with BatchNorm after each
bf16 3x3 conv, 2x2 max pools, two bf16 dense layers with dropout and an
f32 head.  `width` scales the channels and `fc_dim` the dense layers.
The flatten before `fc0` is NHWC's, as flax reshapes, so `fc0`'s
weight is the flax kernel transposed; its input width depends on the
image size, which torch must know when it builds the layer
(`image_size`, square or (h, w)).  Dropout draws from the `generator`
given to `forward` in training mode.
"""

from __future__ import annotations

import torch
from torch import nn

from analytics_zoo_tpu_torch.device import resolve_device
from analytics_zoo_tpu_torch.keras.layers.self_attention import dropout
from analytics_zoo_tpu_torch.models.common.zoo_model import ZooModel
from analytics_zoo_tpu_torch.models.image.imageclassification.layers import (
    RGB,
    BatchNorm,
    Conv,
    Dense,
    image_layout,
    max_pool,
    to_nchw,
    to_nhwc,
)

#: channels per conv, "M" = 2x2 maxpool (VGG-16 configuration D)
_VGG16 = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
          512, 512, 512, "M", 512, 512, 512, "M")


class VGG16(ZooModel, nn.Module):
    """NHWC images [b, h, w, 3] -> logits [b, num_classes] f32."""

    def __init__(self, num_classes: int = 1000, width: float = 1.0,
                 fc_dim: int = 4096, dropout: float = 0.5,
                 dtype: torch.dtype = torch.bfloat16, image_size=224,
                 device=None):
        nn.Module.__init__(self)
        self._config = dict(num_classes=num_classes, width=width,
                            fc_dim=fc_dim, dropout=dropout, dtype=dtype,
                            image_size=image_size)
        self.device_ = dev = resolve_device(device)
        self.dropout, self.dtype = dropout, dtype
        h, w = ((image_size, image_size) if isinstance(image_size, int)
                else tuple(image_size))
        ch, n_conv = RGB, 0
        for spec in _VGG16:
            if spec == "M":
                h, w = h // 2, w // 2
                continue
            out = max(1, int(round(spec * width)))
            self.add_module(f"conv{n_conv}", Conv(ch, out, 3, bias=False,
                                                  dtype=dtype, device=dev))
            self.add_module(f"bn{n_conv}", BatchNorm(out, device=dev))
            ch, n_conv = out, n_conv + 1
        self.n_conv = n_conv
        self.fc0 = Dense(h * w * ch, fc_dim, dtype=dtype, device=dev)
        self.fc1 = Dense(fc_dim, fc_dim, dtype=dtype, device=dev)
        self.head = Dense(fc_dim, num_classes, device=dev)
        self.to(memory_format=torch.channels_last)

    def flax_layout(self):
        """(to_flax, from_flax) of the JAX module's param tree."""
        return image_layout()

    def forward(self, x, generator=None):
        x, i = to_nchw(x), 0
        for spec in _VGG16:
            if spec == "M":
                x = max_pool(x, 2, 2)
                continue
            conv, bn = getattr(self, f"conv{i}"), getattr(self, f"bn{i}")
            x = torch.relu(bn(conv(x)))
            i += 1
        x = to_nhwc(x).reshape(x.shape[0], -1)
        for fc in (self.fc0, self.fc1):
            x = dropout(torch.relu(fc(x)), self.dropout, self.training,
                        generator)
        return self.head(x.float())
