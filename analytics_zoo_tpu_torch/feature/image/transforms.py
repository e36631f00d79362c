"""Image Preprocessing transforms (numpy/OpenCV, HWC records): a copy
of analytics_zoo_tpu/feature/image/transforms.py, so a seeded chain
gives the JAX package's arrays.  cv2 is imported by the resizing
transforms only, when they run.

Reference vocabulary: `pyzoo/zoo/feature/image/imagePreprocessing.py`
(ImageResize:53, ImageBrightness:71, ImageChannelNormalize:81,
ImagePixelNormalize:244, ImageRandomCrop:255, ImageCenterCrop:270,
ImageHFlip:334, ImageMatToTensor:120, ImageSetToSample:133, ...).

Each transform edits the record's "image" (HWC).  Randomized transforms
draw from a per-instance Generator seeded at construction, so pipelines
are reproducible without global RNG state.
"""

from __future__ import annotations

import threading
import zlib
from typing import Optional, Sequence

import numpy as np

from analytics_zoo_tpu_torch.feature.common import Preprocessing


def _resize(img: np.ndarray, h: int, w: int) -> np.ndarray:
    import cv2
    out = cv2.resize(np.ascontiguousarray(img), (w, h),
                     interpolation=cv2.INTER_LINEAR)
    if out.ndim == 2 and img.ndim == 3:  # cv2 drops a size-1 channel
        out = out[:, :, None]
    return out


class ImagePreprocessing(Preprocessing):
    """Base: applies `apply_image` to the record's "image" key (records
    are dicts; a bare ndarray is treated as the image itself)."""

    def apply(self, record):
        if isinstance(record, dict):
            out = dict(record)
            out["image"] = self.apply_image(record["image"])
            return out
        return self.apply_image(record)

    def apply_image(self, img: np.ndarray) -> np.ndarray:
        raise NotImplementedError


class RandomImagePreprocessing(ImagePreprocessing):
    """Base for randomized transforms.  Shard transforms run on a thread
    pool, so a shared Generator would be neither thread-safe nor
    reproducible.  Records that carry a "uri" get a Generator derived
    from (seed, uri) — deterministic per record no matter how shards
    interleave; bare arrays fall back to a lock-protected stream."""

    def __init__(self, seed: int = 0):
        self.seed = seed
        self._lock = threading.Lock()
        self._fallback = np.random.default_rng(seed)

    def apply(self, record):
        if isinstance(record, dict):
            if "uri" in record:
                key = zlib.crc32(str(record["uri"]).encode())
                rng = np.random.default_rng(
                    np.random.SeedSequence([self.seed, key]))
            else:
                rng = self._spawn()
            out = dict(record)
            out["image"] = self.apply_image(record["image"], rng)
            return out
        return self.apply_image(record, self._spawn())

    def _spawn(self):
        with self._lock:
            return np.random.default_rng(
                int(self._fallback.integers(0, 2**63)))

    def apply_image(self, img: np.ndarray,
                    rng: Optional[np.random.Generator] = None
                    ) -> np.ndarray:
        raise NotImplementedError


class ImageResize(ImagePreprocessing):
    def __init__(self, resize_h: int, resize_w: int):
        self.h, self.w = resize_h, resize_w

    def apply_image(self, img):
        return _resize(img, self.h, self.w)


class ImageAspectScale(ImagePreprocessing):
    """Scale the short side to min_size, capping the long side at max_size
    (reference imagePreprocessing.py:211)."""

    def __init__(self, min_size: int, max_size: int = 1000,
                 scale_multiple_of: int = 1):
        self.min_size, self.max_size = min_size, max_size
        self.mult = scale_multiple_of

    def apply_image(self, img):
        h, w = img.shape[:2]
        scale = self.min_size / min(h, w)
        if max(h, w) * scale > self.max_size:
            scale = self.max_size / max(h, w)
        nh, nw = int(round(h * scale)), int(round(w * scale))
        if self.mult > 1:
            nh = ((nh + self.mult - 1) // self.mult) * self.mult
            nw = ((nw + self.mult - 1) // self.mult) * self.mult
        return _resize(img, nh, nw)


class ImageBrightness(RandomImagePreprocessing):
    """Add a uniform delta in [delta_low, delta_high]."""

    def __init__(self, delta_low: float, delta_high: float, seed: int = 0):
        super().__init__(seed)
        self.lo, self.hi = delta_low, delta_high

    def apply_image(self, img, rng=None):
        rng = rng or self._spawn()
        delta = rng.uniform(self.lo, self.hi)
        return np.clip(img.astype(np.float32) + delta, 0, 255)


class ImageChannelNormalize(ImagePreprocessing):
    """(x - mean) / std per channel (reference :81)."""

    def __init__(self, mean_r, mean_g, mean_b, std_r=1.0, std_g=1.0,
                 std_b=1.0):
        self.mean = np.asarray([mean_r, mean_g, mean_b], np.float32)
        self.std = np.asarray([std_r, std_g, std_b], np.float32)

    def apply_image(self, img):
        return (img.astype(np.float32) - self.mean) / self.std


class ImagePixelNormalize(ImagePreprocessing):
    """Subtract a per-pixel mean image (reference :244)."""

    def __init__(self, means: np.ndarray):
        self.means = np.asarray(means, np.float32)

    def apply_image(self, img):
        return img.astype(np.float32) - self.means


class ImageCenterCrop(ImagePreprocessing):
    def __init__(self, crop_width: int, crop_height: int):
        self.cw, self.ch = crop_width, crop_height

    def apply_image(self, img):
        h, w = img.shape[:2]
        y0 = max(0, (h - self.ch) // 2)
        x0 = max(0, (w - self.cw) // 2)
        return img[y0:y0 + self.ch, x0:x0 + self.cw]


class ImageRandomCrop(RandomImagePreprocessing):
    def __init__(self, crop_width: int, crop_height: int, seed: int = 0):
        super().__init__(seed)
        self.cw, self.ch = crop_width, crop_height

    def apply_image(self, img, rng=None):
        rng = rng or self._spawn()
        h, w = img.shape[:2]
        y0 = int(rng.integers(0, max(1, h - self.ch + 1)))
        x0 = int(rng.integers(0, max(1, w - self.cw + 1)))
        return img[y0:y0 + self.ch, x0:x0 + self.cw]


class ImageHFlip(RandomImagePreprocessing):
    """Horizontal flip with probability p (p=1.0 matches the reference's
    deterministic ImageHFlip; ImageMirror == p=1 too)."""

    def __init__(self, p: float = 1.0, seed: int = 0):
        super().__init__(seed)
        self.p = p

    def apply_image(self, img, rng=None):
        if self.p >= 1.0 or (rng or self._spawn()).random() < self.p:
            return img[:, ::-1]
        return img


class ImageExpand(RandomImagePreprocessing):
    """Place the image on a larger mean-filled canvas at a random offset
    (reference :301; SSD-style zoom-out augmentation)."""

    def __init__(self, means=(123, 117, 104), max_expand_ratio: float = 4.0,
                 seed: int = 0):
        super().__init__(seed)
        self.means = np.asarray(means, np.float32)
        self.max_ratio = max_expand_ratio

    def apply_image(self, img, rng=None):
        rng = rng or self._spawn()
        ratio = rng.uniform(1.0, self.max_ratio)
        h, w = img.shape[:2]
        nh, nw = int(h * ratio), int(w * ratio)
        canvas = np.broadcast_to(
            self.means, (nh, nw, img.shape[2])).astype(np.float32).copy()
        y0 = int(rng.integers(0, nh - h + 1))
        x0 = int(rng.integers(0, nw - w + 1))
        canvas[y0:y0 + h, x0:x0 + w] = img
        return canvas


class ImageMatToTensor(ImagePreprocessing):
    """Finalize to float32; `format="NHWC"` (the models' layout) or
    "NCHW" for reference parity (imagePreprocessing.py:120 emits CHW)."""

    def __init__(self, format: str = "NHWC"):
        if format not in ("NHWC", "NCHW"):
            raise ValueError("format must be 'NHWC' or 'NCHW'")
        self.format = format

    def apply_image(self, img):
        img = np.asarray(img, np.float32)
        if self.format == "NCHW":
            img = np.transpose(img, (2, 0, 1))
        return img


class ImageSetToSample(ImagePreprocessing):
    """record -> {"x": image, "y": label} training sample (reference
    :133 ImageSetToSample)."""

    def apply(self, record):
        if not isinstance(record, dict):
            return {"x": np.asarray(record)}
        out = {"x": np.asarray(record["image"])}
        if "label" in record:
            out["y"] = np.asarray(record["label"])
        return out

    def apply_image(self, img):  # pragma: no cover - unused
        return img
