"""Inception-v1 (GoogLeNet; counterpart of analytics_zoo_tpu/models/image/
imageclassification/inception.py): BatchNorm in place of LRN as in the
JAX module, f32 BatchNorm after every bf16 conv, the four branches
concatenated on the channel axis, dropout and an f32 head.  `width`
scales every channel count.  Dropout draws from the `generator` given
to `forward` in training mode (`keras/layers/self_attention.dropout`).
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
)


def _scaled(c: int, width: float) -> int:
    return max(1, int(round(c * width)))


class InceptionBlock(nn.Module):
    """Four parallel branches concatenated channelwise:
    1x1 | 1x1 -> 3x3 | 1x1 -> 5x5 | maxpool -> 1x1."""

    def __init__(self, in_ch, c1, c3r, c3, c5r, c5, cp,
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        for name, cin, cout, k in (("b1", in_ch, c1, 1),
                                   ("b3_reduce", in_ch, c3r, 1),
                                   ("b3", c3r, c3, 3),
                                   ("b5_reduce", in_ch, c5r, 1),
                                   ("b5", c5r, c5, 5),
                                   ("bpool", in_ch, cp, 1)):
            self.add_module(name, Conv(cin, cout, k, bias=False, dtype=dtype,
                                       device=device))
            self.add_module(f"{name}_bn", BatchNorm(cout, device=device))
        self.out_ch = c1 + c3 + c5 + cp

    def _conv_bn(self, x, name):
        conv, bn = getattr(self, name), getattr(self, f"{name}_bn")
        return torch.relu(bn(conv(x)))

    def forward(self, x):
        b1 = self._conv_bn(x, "b1")
        b3 = self._conv_bn(self._conv_bn(x, "b3_reduce"), "b3")
        b5 = self._conv_bn(self._conv_bn(x, "b5_reduce"), "b5")
        bp = self._conv_bn(max_pool(x, 3, 1, "SAME"), "bpool")
        return torch.cat([b1, b3, b5, bp], dim=1)


#: (c1, c3r, c3, c5r, c5, cp) per block, grouped by stage
_V1_BLOCKS = {
    "3a": (64, 96, 128, 16, 32, 32),
    "3b": (128, 128, 192, 32, 96, 64),
    "4a": (192, 96, 208, 16, 48, 64),
    "4b": (160, 112, 224, 24, 64, 64),
    "4c": (128, 128, 256, 24, 64, 64),
    "4d": (112, 144, 288, 32, 64, 64),
    "4e": (256, 160, 320, 32, 128, 128),
    "5a": (256, 160, 320, 32, 128, 128),
    "5b": (384, 192, 384, 48, 128, 128),
}


class InceptionV1(ZooModel, nn.Module):
    """NHWC images [b, h, w, 3] -> logits [b, num_classes] f32."""

    def __init__(self, num_classes: int = 1000, width: float = 1.0,
                 dropout: float = 0.4, dtype: torch.dtype = torch.bfloat16,
                 device=None):
        nn.Module.__init__(self)
        self._config = dict(num_classes=num_classes, width=width,
                            dropout=dropout, dtype=dtype)
        self.device_ = dev = resolve_device(device)
        self.dropout = dropout
        ch = RGB
        for name, out, k in (("stem1", 64, 7), ("stem2_reduce", 64, 1),
                             ("stem2", 192, 3)):
            out = _scaled(out, width)
            self.add_module(name, Conv(ch, out, k, 2 if k == 7 else 1,
                                       bias=False, dtype=dtype, device=dev))
            self.add_module(f"{name}_bn", BatchNorm(out, device=dev))
            ch = out
        for name, cfg in _V1_BLOCKS.items():
            blk = InceptionBlock(ch, *(_scaled(c, width) for c in cfg),
                                 dtype=dtype, device=dev)
            self.add_module(f"inception_{name}", blk)
            ch = blk.out_ch
        self.head = Dense(ch, num_classes, device=dev)
        self.to(memory_format=torch.channels_last)

    def _conv_bn(self, x, name):
        return torch.relu(getattr(self, f"{name}_bn")(getattr(self, name)(x)))

    def flax_layout(self):
        """(to_flax, from_flax) of the JAX module's param tree."""
        return image_layout()

    def forward(self, x, generator=None):
        x = self._conv_bn(to_nchw(x), "stem1")
        x = max_pool(x, 3, 2, "SAME")
        x = self._conv_bn(self._conv_bn(x, "stem2_reduce"), "stem2")
        x = max_pool(x, 3, 2, "SAME")
        for name in _V1_BLOCKS:
            x = getattr(self, f"inception_{name}")(x)
            if name in ("3b", "4e"):
                x = max_pool(x, 3, 2, "SAME")
        x = x.mean(dim=(2, 3)).float()
        x = dropout(x, self.dropout, self.training, generator)
        return self.head(x)
