"""ResNet (counterpart of analytics_zoo_tpu/models/image/imageclassification/
resnet.py:22-129; the Orca torch path fine-tunes ResNet-50 in the
reference's `apps/dogs-vs-cats/`, BASELINE config #3).

The JAX modules' arithmetic: convs in the model's `dtype` (bf16 by
default), BatchNorm in f32 with flax's statistics, the global average
pool and the head in f32 (`layers.py`).  The modules are named as the
flax ones, so `convert.image_from_flax` maps a flax tree onto them.
Images are NHWC [b, h, w, 3]; a skipped projection follows flax's
`residual.shape != y.shape` (channels or stride differ).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from analytics_zoo_tpu_torch.device import resolve_device
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


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_ch: int, filters: int, strides: int = 1,
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        self.conv1 = Conv(in_ch, filters, 3, strides, bias=False,
                          dtype=dtype, device=device)
        self.bn1 = BatchNorm(filters, device=device)
        self.conv2 = Conv(filters, filters, 3, bias=False, dtype=dtype,
                          device=device)
        self.bn2 = BatchNorm(filters, device=device)
        if strides != 1 or in_ch != filters:
            self.proj = Conv(in_ch, filters, 1, strides, bias=False,
                             dtype=dtype, device=device)
            self.proj_bn = BatchNorm(filters, device=device)

    def forward(self, x):
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        if hasattr(self, "proj"):
            x = self.proj_bn(self.proj(x))
        return torch.relu(y + x)


class BottleneckBlock(nn.Module):
    expansion = 4

    def __init__(self, in_ch: int, filters: int, strides: int = 1,
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        out = 4 * filters
        self.conv1 = Conv(in_ch, filters, 1, bias=False, dtype=dtype,
                          device=device)
        self.bn1 = BatchNorm(filters, device=device)
        self.conv2 = Conv(filters, filters, 3, strides, bias=False,
                          dtype=dtype, device=device)
        self.bn2 = BatchNorm(filters, device=device)
        self.conv3 = Conv(filters, out, 1, bias=False, dtype=dtype,
                          device=device)
        self.bn3 = BatchNorm(out, device=device)
        if strides != 1 or in_ch != out:
            self.proj = Conv(in_ch, out, 1, strides, bias=False, dtype=dtype,
                             device=device)
            self.proj_bn = BatchNorm(out, device=device)

    def forward(self, x):
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        if hasattr(self, "proj"):
            x = self.proj_bn(self.proj(x))
        return torch.relu(y + x)


class ResNet(ZooModel, nn.Module):
    """NHWC images [b, h, w, 3] -> logits [b, num_classes] f32."""

    def __init__(self, stage_sizes: Sequence[int] = (2, 2, 2, 2),
                 block: str = "basic", num_classes: int = 1000,
                 dtype: torch.dtype = torch.bfloat16, device=None):
        nn.Module.__init__(self)
        if block not in ("basic", "bottleneck"):
            raise ValueError(f"unknown block {block!r}; use 'basic' or "
                             "'bottleneck'")
        self._config = dict(stage_sizes=tuple(stage_sizes), block=block,
                            num_classes=num_classes, dtype=dtype)
        self.device_ = dev = resolve_device(device)
        block_cls = BasicBlock if block == "basic" else BottleneckBlock
        self.stem = Conv(RGB, 64, 7, 2, ((3, 3), (3, 3)), bias=False,
                         dtype=dtype, device=dev)
        self.stem_bn = BatchNorm(64, device=dev)
        ch = 64
        for i, n_blocks in enumerate(stage_sizes):
            for j in range(n_blocks):
                strides = 2 if i > 0 and j == 0 else 1
                blk = block_cls(ch, 64 * 2 ** i, strides, dtype, dev)
                self.add_module(f"stage{i}_block{j}", blk)
                ch = 64 * 2 ** i * block_cls.expansion
        self.head = Dense(ch, num_classes, device=dev)
        self.to(memory_format=torch.channels_last)

    def flax_layout(self):
        """(to_flax, from_flax) of the JAX module's param tree."""
        return image_layout()

    def forward(self, x, generator=None):
        """`generator` is the dropout generator the other backbones
        take; a ResNet has no dropout."""
        x = torch.relu(self.stem_bn(self.stem(to_nchw(x))))
        x = max_pool(x, 3, 2, "SAME")
        for name, blk in self.named_children():
            if name.startswith("stage"):
                x = blk(x)
        return self.head(x.mean(dim=(2, 3)).float())


def ResNet18(num_classes: int = 1000, **kw) -> ResNet:
    return ResNet(stage_sizes=(2, 2, 2, 2), block="basic",
                  num_classes=num_classes, **kw)


def ResNet50(num_classes: int = 1000, **kw) -> ResNet:
    return ResNet(stage_sizes=(3, 4, 6, 3), block="bottleneck",
                  num_classes=num_classes, **kw)


class ImageClassifier(ZooModel, nn.Module):
    """The reference's `ImageClassifier` facade: a backbone by name
    (`BACKBONES`, which `imageclassification/__init__.py` completes),
    held as `self.backbone`.  `save_model` / `load_model` carry its
    BatchNorm running statistics with the weights (they are buffers of
    its state_dict).  `dtype` and `device` go to the backbone."""

    BACKBONES = {"resnet-18": ResNet18, "resnet-50": ResNet50}

    def __init__(self, model_name: str = "resnet-18", num_classes: int = 2,
                 dtype: torch.dtype = torch.bfloat16, device=None):
        nn.Module.__init__(self)
        key = model_name.lower()
        if key not in self.BACKBONES:
            raise ValueError(f"unknown backbone '{model_name}'; "
                             f"known: {sorted(self.BACKBONES)}")
        self._config = dict(model_name=model_name, num_classes=num_classes,
                            dtype=dtype)
        self.device_ = resolve_device(device)
        self.backbone = self.BACKBONES[key](num_classes=num_classes,
                                            dtype=dtype, device=self.device_)
        self.model_name = model_name
        self.num_classes = num_classes

    def flax_layout(self):
        """(to_flax, from_flax) of the JAX module's param tree."""
        return image_layout("backbone.")

    def forward(self, x, generator=None):
        return self.backbone(x, generator=generator)
