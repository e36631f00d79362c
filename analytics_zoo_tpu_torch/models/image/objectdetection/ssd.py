"""SSD object detection (counterpart of analytics_zoo_tpu/models/image/
objectdetection/ssd.py).

The JAX design kept: a stride-2 conv backbone with per-scale heads,
(class logits [b, N, C+1], box deltas [b, N, 4]) over a static anchor
grid in one forward; the whole MultiBox loss (IoU matching, per-GT
force-matching, 3:1 hard negatives by rank mask, smooth-L1 on encoded
offsets) in torch inside the train step; padded GT (labels 0 =
padding); decode and NMS on the host at predict.  The heads' outputs
are permuted back to NHWC before the per-anchor reshape, so anchors
are ordered (h, w, k) as JAX's.  Convs compute in `compute_dtype`, the
heads in f32, as the flax module does.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from analytics_zoo_tpu_torch.device import resolve_device
from analytics_zoo_tpu_torch.models.common.zoo_model import ZooModel
from analytics_zoo_tpu_torch.models.image.imageclassification.layers import (
    RGB,
    Conv,
    image_layout,
    to_nchw,
    to_nhwc,
)
from analytics_zoo_tpu_torch.models.image.objectdetection.box_utils import (
    decode_boxes,
    detections,
    encode_boxes,
    generate_anchors,
    iou_matrix,
    pad_ground_truth,
)


class _SSDNet(nn.Module):

    def __init__(self, num_classes: int, n_anchors_per_cell: int,
                 n_maps: int, channels: Sequence[int] = (16, 32, 64, 128),
                 compute_dtype=torch.bfloat16, device=None):
        super().__init__()
        self.k, self.c = n_anchors_per_cell, num_classes + 1
        self.n_conv, self.n_maps = len(channels), n_maps
        ch = RGB
        for i, out in enumerate(channels):
            self.add_module(f"conv{i}", Conv(
                ch, out, 3, 2, dtype=compute_dtype, device=device))
            ch = out
        for i, ch in enumerate(channels[len(channels) - n_maps:]):
            self.add_module(f"cls_head{i}", Conv(
                ch, self.k * self.c, 3, dtype=torch.float32, device=device))
            self.add_module(f"box_head{i}", Conv(
                ch, self.k * 4, 3, dtype=torch.float32, device=device))

    def forward(self, x):
        x = to_nchw(x)
        feats = []
        for i in range(self.n_conv):
            x = torch.relu(getattr(self, f"conv{i}")(x))
            if i >= self.n_conv - self.n_maps:
                feats.append(x)   # trailing scales carry heads
        cls_out, box_out = [], []
        b = x.shape[0]
        for i, f in enumerate(feats):
            cls = to_nhwc(getattr(self, f"cls_head{i}")(f))
            box = to_nhwc(getattr(self, f"box_head{i}")(f))
            cls_out.append(cls.reshape(b, -1, self.c))
            box_out.append(box.reshape(b, -1, 4))
        return torch.cat(cls_out, dim=1), torch.cat(box_out, dim=1)


def multibox_loss(anchors: torch.Tensor, iou_thresh: float = 0.5,
                  neg_pos_ratio: float = 3.0):
    """The per-example loss fn(preds, labels) -> [b] for the engine.
    labels = (gt_boxes [b, M, 4] normalized xyxy, gt_labels [b, M],
    1-based classes, 0 = padding)."""

    def loss_fn(preds, labels):
        cls_logits, deltas = preds
        gt_boxes, gt_labels = labels[0].float(), labels[1].long()
        b, n_anchors = cls_logits.shape[0], anchors.shape[0]
        m = gt_boxes.shape[1]
        valid = gt_labels > 0                                  # [b, M]
        iou = torch.where(valid[:, None, :],
                          iou_matrix(anchors, gt_boxes), -1.0)  # [b, N, M]
        # argmax: the first of equal maxima, as jnp.argmax
        best_gt, best_iou = iou.argmax(dim=2), iou.amax(dim=2)  # [b, N]
        # force-match: each valid gt claims its best anchor; padding gts
        # scatter to a sentinel slot N
        best_anchor = torch.where(valid, iou.argmax(dim=1), n_anchors)
        slots = torch.zeros(b, n_anchors + 1, dtype=torch.bool,
                            device=anchors.device)
        forced = slots.scatter(1, best_anchor, True)[:, :n_anchors]
        gt_ids = torch.arange(m, device=anchors.device).expand(b, m)
        forced_gt = torch.zeros(b, n_anchors + 1, dtype=torch.long,
                                device=anchors.device).scatter(
            1, best_anchor, gt_ids)[:, :n_anchors]

        positive = (best_iou >= iou_thresh) | forced
        match_gt = torch.where(forced, forced_gt, best_gt)
        target_cls = torch.where(positive,
                                 gt_labels.gather(1, match_gt), 0)
        per_anchor_ce = -torch.log_softmax(cls_logits, dim=-1).gather(
            2, target_cls[..., None])[..., 0]

        n_pos = positive.sum(dim=1)
        # hard negative mining by rank: a negative counts iff its loss is
        # among the top ratio * n_pos of the negatives (jnp.argsort's
        # stable order)
        neg_losses = torch.where(positive, -torch.inf, per_anchor_ce)
        order = torch.argsort(-neg_losses, dim=1, stable=True)
        rank = torch.empty_like(order).scatter_(
            1, order, torch.arange(n_anchors, device=anchors.device
                                   ).expand(b, n_anchors))
        neg_keep = ~positive & (rank < neg_pos_ratio * n_pos[:, None])
        cls_loss = torch.where(positive | neg_keep, per_anchor_ce,
                               0.0).sum(dim=1)

        matched = gt_boxes.gather(1, match_gt[..., None].expand(b, n_anchors,
                                                                4))
        diff = (deltas - encode_boxes(matched, anchors)).abs()
        smooth_l1 = torch.where(diff < 1.0, 0.5 * diff ** 2, diff - 0.5)
        box_loss = torch.where(positive[..., None], smooth_l1, 0.0).sum(
            dim=(1, 2))
        return (cls_loss + box_loss) / torch.clamp_min(n_pos.float(), 1.0)

    return loss_fn


class SSDDetector(ZooModel, nn.Module):
    """fit on {"x": images [b, S, S, 3], "y": [boxes [b, M, 4], labels
    [b, M]]} (labels 1-based, 0-padded); `detect(images)` returns
    per-image (boxes, scores, classes) after decode and NMS.  The
    network is `self.net`; `device` as the port's rule (None = the
    card)."""

    default_metrics = ()

    def __init__(self, num_classes: int, image_size: int = 64,
                 channels: Sequence[int] = (16, 32, 64, 128),
                 scales: Sequence[float] = (0.25, 0.5),
                 ratios: Sequence[float] = (1.0, 2.0, 0.5),
                 iou_thresh: float = 0.5, lr: float = 1e-3,
                 compute_dtype=torch.bfloat16, seed: int = 0, device=None):
        nn.Module.__init__(self)
        if len(scales) > len(channels):
            raise ValueError("need at least one backbone stage per scale")
        self._config = dict(num_classes=num_classes, image_size=image_size,
                            channels=tuple(channels), scales=tuple(scales),
                            ratios=tuple(ratios), iou_thresh=iou_thresh,
                            lr=lr, compute_dtype=compute_dtype, seed=seed)
        self.device_ = resolve_device(device)
        self.lr, self.seed = lr, seed
        n_maps = len(scales)
        strides = [2 ** (len(channels) - n_maps + 1 + i)
                   for i in range(n_maps)]
        # SAME-padded stride-2 convs give ceil-sized maps
        feature_sizes = [-(-image_size // s) for s in strides]
        self.anchors = generate_anchors(image_size, feature_sizes, scales,
                                        ratios)
        self.net = _SSDNet(num_classes, len(ratios), n_maps, channels,
                           compute_dtype, self.device_)
        self.default_loss = multibox_loss(
            torch.from_numpy(self.anchors).to(self.device_), iou_thresh)

    def flax_layout(self):
        """(to_flax, from_flax) of the JAX module's param tree."""
        return image_layout("net.")

    def forward(self, x):
        return self.net(x)

    def estimator(self, **kwargs):
        kwargs.setdefault("learning_rate", self.lr)
        kwargs.setdefault("seed", self.seed)
        return super().estimator(**kwargs)

    def fit(self, data, epochs: int = 1, batch_size: int = 16, **kw):
        self._require_estimator().fit(data, epochs=epochs,
                                      batch_size=batch_size, **kw)
        return self

    def evaluate(self, data, batch_size: int = 16):
        return self._require_estimator().evaluate(data,
                                                  batch_size=batch_size)

    def detect(self, images: np.ndarray, score_threshold: float = 0.5,
               nms_iou: float = 0.45, max_det: int = 20
               ) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Per image: (boxes [k, 4] normalized xyxy, scores [k], classes
        [k] 1-based)."""
        cls_logits, deltas = self._require_estimator().predict(
            {"x": images}, batch_size=16)
        probs = torch.softmax(torch.from_numpy(cls_logits), dim=-1).numpy()
        boxes = decode_boxes(torch.from_numpy(deltas),
                             torch.from_numpy(self.anchors)).numpy()
        return detections(probs, boxes, score_threshold, nms_iou, max_det)

    # shared static-GT padding helper (box_utils.pad_ground_truth)
    pad_ground_truth = staticmethod(pad_ground_truth)

