"""ImageSet — sharded image records with augmentation pipelines (a port
of analytics_zoo_tpu/feature/image/imageset.py over the port's
XShards; PIL is imported when a file is decoded).

Reference: `pyzoo/zoo/feature/image/imageset.py` (`ImageSet.read`,
class-folder labeling, `transform`, `get_image/get_label`), scala
`feature/image/ImageSet.scala` (OpenCVMat-backed distributed transforms).

A record is a plain dict
  {"image": HWC uint8/float ndarray, "label": int, "uri": str}
held in `XShards` (list-of-records shards).  Transforms are
`Preprocessing` chains running on the shard thread pool (PIL/numpy release
the GIL for decode/resize).  `to_dataset()` lowers to the training
convention `{"x": stacked NHWC, "y": labels}`: NHWC, the layout the
image models take (they run NCHW with channels-last strides inside,
the layout cuDNN's NHWC kernels read), unlike the reference's NCHW
OpenCVMat tensors.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from analytics_zoo_tpu_torch.orca.data.shard import XShards

_IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".ppm", ".npy")


def _decode(path: str) -> np.ndarray:
    """Read one image file to an HWC uint8 array (RGB)."""
    if path.endswith(".npy"):
        return np.load(path)
    from PIL import Image
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


class ImageSet:
    """Sharded images.  Build with `read` (files / class folders) or
    `from_arrays`."""

    def __init__(self, shards: XShards, label_map: Optional[Dict] = None):
        self.shards = shards
        self._label_map = label_map

    # -- construction ---------------------------------------------------

    @classmethod
    def read(cls, path: str, with_label: bool = False,
             num_shards: Optional[int] = None,
             resize_height: int = -1, resize_width: int = -1) -> "ImageSet":
        """Read a directory of images.  With `with_label=True` the first
        directory level is class folders (reference imageset.py:54-87:
        each image labeled by its folder; labels are sorted folder names,
        ids start at 0)."""
        records: List[Dict[str, Any]] = []
        label_map = None
        if with_label:
            classes = sorted(
                d for d in os.listdir(path)
                if os.path.isdir(os.path.join(path, d)))
            label_map = {c: i for i, c in enumerate(classes)}
            for c in classes:
                for f in sorted(os.listdir(os.path.join(path, c))):
                    if f.lower().endswith(_IMG_EXTS):
                        records.append({"uri": os.path.join(path, c, f),
                                        "label": label_map[c]})
        else:
            for f in sorted(os.listdir(path)):
                if f.lower().endswith(_IMG_EXTS):
                    records.append({"uri": os.path.join(path, f)})
        if not records:
            raise FileNotFoundError(f"no images under {path}")
        shards = XShards.from_records(records, num_shards)

        def load(shard):
            out = []
            for r in shard:
                img = _decode(r["uri"])
                if resize_height > 0 and resize_width > 0:
                    from analytics_zoo_tpu_torch.feature.image.transforms \
                        import _resize
                    img = _resize(img, resize_height, resize_width)
                out.append({**r, "image": img})
            return out

        return cls(shards.transform_shard(load), label_map)

    @classmethod
    def from_arrays(cls, images: Sequence[np.ndarray],
                    labels: Optional[Sequence] = None,
                    num_shards: Optional[int] = None) -> "ImageSet":
        records = [{"image": np.asarray(im), "uri": str(i)}
                   for i, im in enumerate(images)]
        if labels is not None:
            for r, y in zip(records, labels):
                r["label"] = y
        return cls(XShards.from_records(records, num_shards))

    # -- api ------------------------------------------------------------

    @property
    def label_map(self) -> Optional[Dict]:
        return self._label_map

    def transform(self, transformer) -> "ImageSet":
        return ImageSet(
            self.shards.transform_shard(
                lambda shard: [transformer.apply(r) for r in shard]),
            self._label_map)

    def get_image(self) -> List[np.ndarray]:
        return [r["image"] for s in self.shards.collect() for r in s]

    def get_label(self) -> List:
        return [r.get("label") for s in self.shards.collect() for r in s]

    def get_uri(self) -> List[str]:
        return [r.get("uri") for s in self.shards.collect() for r in s]

    def __len__(self) -> int:
        return sum(len(s) for s in self.shards.collect())

    def to_dataset(self) -> XShards:
        """Lower to training-convention XShards of {"x": NHWC float32
        stack, "y": labels} — streams straight into `Estimator.fit`."""
        def pack(shard):
            xs = np.stack([np.asarray(r["image"], np.float32)
                           for r in shard])
            out = {"x": xs}
            if shard and "label" in shard[0]:
                out["y"] = np.asarray([r["label"] for r in shard])
            return out
        return self.shards.transform_shard(pack)
