"""Faster-RCNN-style two-stage detection (counterpart of
analytics_zoo_tpu/models/image/objectdetection/faster_rcnn.py).

The JAX design kept, every stage static-shaped: a stride-2 conv
backbone to one feature map; an RPN head (objectness and deltas over a
static anchor grid) whose top `num_proposals` anchors by objectness
(`torch.topk`, JAX's `lax.top_k`; the order of tied scores may differ)
are decoded into proposals, clipped, held to a minimum size and
detached (JAX's `stop_gradient`); bilinear ROIAlign of a pool x pool
grid per proposal, gathered from the NHWC feature map; a two-layer
head into class logits and box deltas.  Both stages train jointly in
one step (`faster_rcnn_loss`).  The RPN outputs are permuted back to
NHWC before their reshape, so anchors are ordered (h, w, k) as JAX's.
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
    Dense,
    image_layout,
    to_nchw,
    to_nhwc,
)
from analytics_zoo_tpu_torch.models.image.objectdetection.box_utils import (
    decode_boxes,
    detections,
    encode_boxes,
    iou_matrix,
    pad_ground_truth,
)


def roi_align(feat, boxes, pool: int):
    """Bilinear ROIAlign.  feat [H, W, C] and boxes [K, 4] normalized
    xyxy -> [K, pool, pool, C]; or batched, feat [b, H, W, C] and boxes
    [b, K, 4] -> [b, K, pool, pool, C].  Pure gathers."""
    if feat.dim() == 3:
        return roi_align(feat[None], boxes[None], pool)[0]
    b, h, w = feat.shape[:3]
    x0, y0, x1, y1 = boxes.unbind(-1)                      # [b, K]
    steps = (torch.arange(pool, dtype=torch.float32,
                          device=feat.device) + 0.5) / pool
    ys = (y0[..., None] + steps * (y1 - y0)[..., None]) * h - 0.5
    xs = (x0[..., None] + steps * (x1 - x0)[..., None]) * w - 0.5
    ys, xs = ys.clamp(0.0, h - 1.0), xs.clamp(0.0, w - 1.0)   # [b, K, P]
    yf, xf = torch.floor(ys), torch.floor(xs)
    yi0, xi0 = yf.long(), xf.long()
    yi1, xi1 = (yi0 + 1).clamp_max(h - 1), (xi0 + 1).clamp_max(w - 1)
    wy = (ys - yf)[..., :, None, None]                     # [b, K, P, 1, 1]
    wx = (xs - xf)[..., None, :, None]                     # [b, K, 1, P, 1]
    bi = torch.arange(b, device=feat.device)[:, None, None, None]

    def g(yi, xi):                                         # [b, K, P, P, C]
        return feat[bi, yi[..., :, None], xi[..., None, :]]

    return ((1 - wy) * (1 - wx) * g(yi0, xi0)
            + (1 - wy) * wx * g(yi0, xi1)
            + wy * (1 - wx) * g(yi1, xi0)
            + wy * wx * g(yi1, xi1))


class _FasterRCNNNet(nn.Module):

    def __init__(self, num_classes: int, n_anchors_per_cell: int,
                 num_proposals: int, pool_size: int, anchors: np.ndarray,
                 channels: Sequence[int] = (16, 32, 64), head_dim: int = 128,
                 compute_dtype=torch.bfloat16, device=None):
        super().__init__()
        self.k, self.num_proposals, self.pool_size = (
            n_anchors_per_cell, num_proposals, pool_size)
        self.n_conv = len(channels)
        self.anchors = torch.from_numpy(anchors).to(device)
        ch = RGB
        for i, out in enumerate(channels):
            self.add_module(f"conv{i}", Conv(
                ch, out, 3, 2, dtype=compute_dtype, device=device))
            ch = out
        k = n_anchors_per_cell
        self.rpn = Conv(ch, head_dim, 3, dtype=compute_dtype, device=device)
        self.rpn_obj = Conv(head_dim, k, 1, dtype=torch.float32,
                            device=device)
        self.rpn_box = Conv(head_dim, k * 4, 1, dtype=torch.float32,
                            device=device)
        self.roi_fc1 = Dense(pool_size * pool_size * ch, head_dim,
                             dtype=compute_dtype, device=device)
        self.roi_fc2 = Dense(head_dim, head_dim, dtype=compute_dtype,
                             device=device)
        self.roi_cls = Dense(head_dim, num_classes + 1, device=device)
        self.roi_box = Dense(head_dim, 4, device=device)

    def forward(self, x):
        x = to_nchw(x)
        for i in range(self.n_conv):
            x = torch.relu(getattr(self, f"conv{i}")(x))
        feat, b = x, x.shape[0]                              # [b, C, H, W]

        # stage 1: the RPN over the static anchor grid
        rpn = torch.relu(self.rpn(feat))
        obj = to_nhwc(self.rpn_obj(rpn)).reshape(b, -1)         # [b, N]
        rpn_deltas = to_nhwc(self.rpn_box(rpn)).reshape(b, -1, 4)
        # the top `num_proposals` anchors by objectness: the static-shape
        # stand-in for NMS proposal selection
        top_idx = torch.topk(obj, self.num_proposals, dim=1).indices
        sel_deltas = rpn_deltas.gather(
            1, top_idx[..., None].expand(-1, -1, 4))
        proposals = decode_boxes(sel_deltas, self.anchors[top_idx])
        proposals = proposals.clamp(0.0, 1.0)
        # a minimum size: a proposal clipped to zero area would give
        # encode_boxes inf/NaN targets
        lo = torch.clamp_max(proposals[..., :2], 1.0 - 1e-3)
        hi = torch.maximum(proposals[..., 2:], lo + 1e-3)
        # the ROI head must not backprop into the RPN through the boxes
        proposals = torch.cat([lo, hi], dim=-1).detach()

        # stage 2: ROIAlign + the detection head
        pooled = roi_align(to_nhwc(feat).float(), proposals, self.pool_size)
        pooled = pooled.reshape(b, self.num_proposals, -1)
        hdn = torch.relu(self.roi_fc1(pooled))
        hdn = torch.relu(self.roi_fc2(hdn))
        return obj, rpn_deltas, proposals, self.roi_cls(hdn), \
            self.roi_box(hdn)


def _smooth_l1(diff):
    return torch.where(diff < 1.0, 0.5 * diff ** 2, diff - 0.5)


def _take(boxes, idx):
    """boxes [b, M, 4] at idx [b, N] -> [b, N, 4]."""
    return boxes.gather(1, idx[..., None].expand(*idx.shape, 4))


def faster_rcnn_loss(anchors: torch.Tensor, rpn_pos_iou: float = 0.5,
                     rpn_neg_iou: float = 0.3, roi_pos_iou: float = 0.5):
    """The joint two-stage per-example loss fn(preds, labels) -> [b].
    labels = (gt_boxes [b, M, 4] normalized xyxy, gt_labels [b, M]
    1-based, 0 = pad)."""

    def loss_fn(preds, labels):
        obj, rpn_deltas, proposals, roi_cls, roi_deltas = preds
        gt_boxes, gt_labels = labels[0].float(), labels[1].long()
        b, n_anchors = obj.shape[0], anchors.shape[0]
        valid = gt_labels > 0
        n_gt = torch.clamp_min(valid.sum(dim=1), 1)

        # RPN: binary objectness + box regression on anchors
        iou = torch.where(valid[:, None, :], iou_matrix(anchors, gt_boxes),
                          -1.0)                                # [b, N, M]
        best_gt, best_iou = iou.argmax(dim=2), iou.amax(dim=2)
        best_anchor = torch.where(valid, iou.argmax(dim=1), n_anchors)
        forced = torch.zeros(b, n_anchors + 1, dtype=torch.bool,
                             device=obj.device).scatter(
            1, best_anchor, True)[:, :n_anchors]
        pos = (best_iou >= rpn_pos_iou) | forced
        neg = (best_iou < rpn_neg_iou) & ~forced
        softplus = torch.nn.functional.softplus
        obj_ce = torch.where(pos, softplus(-obj),
                             torch.where(neg, softplus(obj), 0.0))
        rpn_cls_loss = obj_ce.sum(dim=1) / torch.clamp_min(
            pos.sum(dim=1) + neg.sum(dim=1), 1)
        rpn_targets = encode_boxes(_take(gt_boxes, best_gt), anchors)
        rpn_box_loss = torch.where(
            pos[..., None], _smooth_l1((rpn_deltas - rpn_targets).abs()),
            0.0).sum(dim=(1, 2)) / n_gt

        # ROI head: classify and refine the selected proposals
        piou = torch.where(valid[:, None, :],
                           iou_matrix(proposals, gt_boxes), -1.0)  # [b, P, M]
        p_best_gt, p_best_iou = piou.argmax(dim=2), piou.amax(dim=2)
        p_pos = p_best_iou >= roi_pos_iou
        target_cls = torch.where(p_pos, gt_labels.gather(1, p_best_gt), 0)
        roi_ce = -torch.log_softmax(roi_cls, dim=-1).gather(
            2, target_cls[..., None])[..., 0]
        roi_targets = encode_boxes(_take(gt_boxes, p_best_gt), proposals)
        roi_box_loss = torch.where(
            p_pos[..., None], _smooth_l1((roi_deltas - roi_targets).abs()),
            0.0).sum(dim=(1, 2)) / torch.clamp_min(p_pos.sum(dim=1), 1)
        return rpn_cls_loss + rpn_box_loss + roi_ce.mean(dim=1) \
            + roi_box_loss

    return loss_fn


class FasterRCNNDetector(ZooModel, nn.Module):
    """Two-stage detector with the SSDDetector surface: fit on {"x":
    images, "y": [gt_boxes, gt_labels]} (padded, 0 = pad label);
    `detect(images)` -> per-image (boxes, scores, classes).  The network
    is `self.net`."""

    default_metrics = ()

    def __init__(self, num_classes: int, image_size: int = 64,
                 channels: Sequence[int] = (16, 32, 64),
                 scales: Sequence[float] = (0.25, 0.5),
                 ratios: Sequence[float] = (1.0, 2.0, 0.5),
                 num_proposals: int = 32, pool_size: int = 4,
                 lr: float = 1e-3, compute_dtype=torch.bfloat16,
                 seed: int = 0, device=None):
        nn.Module.__init__(self)
        self._config = dict(num_classes=num_classes, image_size=image_size,
                            channels=tuple(channels), scales=tuple(scales),
                            ratios=tuple(ratios),
                            num_proposals=num_proposals, pool_size=pool_size,
                            lr=lr, compute_dtype=compute_dtype, seed=seed)
        self.device_ = resolve_device(device)
        self.lr, self.seed = lr, seed
        fmap = -(-image_size // 2 ** len(channels))
        # every (scale, ratio) anchor on the one feature map, cell-major
        # with (scale, ratio) innermost: the RPN head's (h, w, k) reshape
        cy, cx = np.meshgrid((np.arange(fmap) + 0.5) / fmap,
                             (np.arange(fmap) + 0.5) / fmap, indexing="ij")
        per = []
        for s in scales:
            for r in ratios:
                w, h = s * np.sqrt(r), s / np.sqrt(r)
                per.append(np.stack([cx - w / 2, cy - h / 2,
                                     cx + w / 2, cy + h / 2],
                                    axis=-1).reshape(-1, 4))
        self.anchors = np.clip(np.stack(per, axis=1).reshape(-1, 4), 0.0,
                               1.0).astype(np.float32)
        self.net = _FasterRCNNNet(num_classes, len(scales) * len(ratios),
                                  num_proposals, pool_size, self.anchors,
                                  channels, compute_dtype=compute_dtype,
                                  device=self.device_)
        self.default_loss = faster_rcnn_loss(self.net.anchors)

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

    def detect(self, images: np.ndarray, score_threshold: float = 0.5,
               nms_iou: float = 0.45, max_det: int = 20
               ) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Per image: (boxes [k, 4] normalized xyxy, scores [k], classes
        [k] 1-based) from the refined second-stage outputs."""
        _, _, proposals, roi_cls, roi_deltas = \
            self._require_estimator().predict({"x": images}, batch_size=16)
        probs = torch.softmax(torch.from_numpy(roi_cls), dim=-1).numpy()
        boxes = decode_boxes(torch.from_numpy(roi_deltas),
                             torch.from_numpy(proposals)).numpy()
        return detections(probs, boxes, score_threshold, nms_iou, max_det)

    # shared static-GT padding helper (box_utils.pad_ground_truth)
    pad_ground_truth = staticmethod(pad_ground_truth)
