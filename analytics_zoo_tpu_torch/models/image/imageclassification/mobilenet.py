"""MobileNetV2 (counterpart of analytics_zoo_tpu/models/image/
imageclassification/mobilenet.py): inverted residuals with linear
bottlenecks, ReLU6 as a clamp to [0, 6] of f32 BatchNorm outputs, the
depthwise 3x3 a grouped conv (`groups = hidden`), dropout and an f32
head.  `width` scales the channels (`_make_divisible`, as JAX).
Dropout draws from the `generator` given to `forward` in training
mode.
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
    to_nchw,
)


def _make_divisible(v: float, divisor: int = 8) -> int:
    out = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if out < 0.9 * v:  # never round down more than 10%
        out += divisor
    return out


def _relu6(x):
    return torch.clamp(x, 0.0, 6.0)


class InvertedResidual(nn.Module):

    def __init__(self, in_ch: int, filters: int, strides: int = 1,
                 expand: int = 6, dtype=torch.bfloat16, device=None):
        super().__init__()
        hidden = in_ch * expand
        if expand != 1:
            self.expand = Conv(in_ch, hidden, 1, bias=False, dtype=dtype,
                               device=device)
            self.expand_bn = BatchNorm(hidden, device=device)
        self.depthwise = Conv(hidden, hidden, 3, strides, bias=False,
                              groups=hidden, dtype=dtype, device=device)
        self.depthwise_bn = BatchNorm(hidden, device=device)
        self.project = Conv(hidden, filters, 1, bias=False, dtype=dtype,
                            device=device)
        self.project_bn = BatchNorm(filters, device=device)
        self.residual = strides == 1 and in_ch == filters

    def forward(self, x):
        y = x
        if hasattr(self, "expand"):
            y = _relu6(self.expand_bn(self.expand(y)))
        y = _relu6(self.depthwise_bn(self.depthwise(y)))
        y = self.project_bn(self.project(y))  # linear bottleneck
        return y + x if self.residual else y


#: (expand, channels, repeats, first-stride)
_V2_STAGES = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2),
              (6, 64, 4, 2), (6, 96, 3, 1), (6, 160, 3, 2),
              (6, 320, 1, 1))


class MobileNetV2(ZooModel, nn.Module):
    """NHWC images [b, h, w, 3] -> logits [b, num_classes] f32."""

    def __init__(self, num_classes: int = 1000, width: float = 1.0,
                 dropout: float = 0.2, dtype: torch.dtype = torch.bfloat16,
                 device=None):
        nn.Module.__init__(self)
        self._config = dict(num_classes=num_classes, width=width,
                            dropout=dropout, dtype=dtype)
        self.device_ = dev = resolve_device(device)
        self.dropout = dropout
        ch = _make_divisible(32 * width)
        self.stem = Conv(RGB, ch, 3, 2, bias=False, dtype=dtype, device=dev)
        self.stem_bn = BatchNorm(ch, device=dev)
        self.blocks = []
        for si, (t, c, n, s) in enumerate(_V2_STAGES):
            out = _make_divisible(c * width)
            for j in range(n):
                name = f"stage{si}_block{j}"
                self.add_module(name, InvertedResidual(
                    ch, out, s if j == 0 else 1, t, dtype, dev))
                self.blocks.append(name)
                ch = out
        last = _make_divisible(1280 * max(1.0, width))
        self.head_conv = Conv(ch, last, 1, bias=False, dtype=dtype,
                              device=dev)
        self.head_bn = BatchNorm(last, device=dev)
        self.head = Dense(last, num_classes, device=dev)
        self.to(memory_format=torch.channels_last)

    def flax_layout(self):
        """(to_flax, from_flax) of the JAX module's param tree."""
        return image_layout()

    def forward(self, x, generator=None):
        x = _relu6(self.stem_bn(self.stem(to_nchw(x))))
        for name in self.blocks:
            x = getattr(self, name)(x)
        x = _relu6(self.head_bn(self.head_conv(x)))
        x = x.mean(dim=(2, 3)).float()
        x = dropout(x, self.dropout, self.training, generator)
        return self.head(x)
