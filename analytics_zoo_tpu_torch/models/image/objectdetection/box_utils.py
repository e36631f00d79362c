"""Anchor and box utilities for detection (counterpart of
analytics_zoo_tpu/models/image/objectdetection/box_utils.py).

The training-path math (`iou_matrix`, `encode_boxes`, `decode_boxes`)
is torch with static shapes, inside the train step; the anchor grid,
`pad_ground_truth` and `nms` are host numpy, a copy of the JAX
module's (NMS runs at predict time, on the host, as there).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch


def generate_anchors(image_size: int,
                     feature_sizes: Sequence[int],
                     scales: Sequence[float],
                     ratios: Sequence[float] = (1.0, 2.0, 0.5)
                     ) -> np.ndarray:
    """Multi-scale anchor grid in normalized xyxy, [N, 4].  One scale per
    feature map; `ratios` anchors per cell (the SSD priorbox layout)."""
    assert len(feature_sizes) == len(scales)
    out = []
    for fs, scale in zip(feature_sizes, scales):
        cy, cx = np.meshgrid(
            (np.arange(fs) + 0.5) / fs, (np.arange(fs) + 0.5) / fs,
            indexing="ij")
        # cell-major with ratios innermost: the conv heads' (h, w, k)
        # reshape
        per_ratio = []
        for r in ratios:
            w = scale * np.sqrt(r)
            h = scale / np.sqrt(r)
            per_ratio.append(np.stack([cx - w / 2, cy - h / 2,
                                       cx + w / 2, cy + h / 2],
                                      axis=-1).reshape(-1, 4))
        cells = np.stack(per_ratio, axis=1)        # [fs*fs, k, 4]
        out.append(cells.reshape(-1, 4))
    return np.clip(np.concatenate(out, axis=0), 0.0, 1.0) \
        .astype(np.float32)


def iou_matrix(a, b):
    """IoU between [..., N, 4] and [..., M, 4] xyxy boxes -> [..., N, M]."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp_min(rb - lt, 0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = ((a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1]))[..., :, None]
    area_b = ((b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1]))[..., None, :]
    return inter / torch.clamp_min(area_a + area_b - inter, 1e-8)


_VAR = (0.1, 0.2)  # SSD center/size variances


def encode_boxes(gt_xyxy, anchors_xyxy):
    """GT boxes -> regression targets relative to anchors ([..., 4])."""
    a_wh = anchors_xyxy[..., 2:] - anchors_xyxy[..., :2]
    a_c = anchors_xyxy[..., :2] + a_wh / 2
    g_wh = torch.clamp_min(gt_xyxy[..., 2:] - gt_xyxy[..., :2], 1e-6)
    g_c = gt_xyxy[..., :2] + g_wh / 2
    d_c = (g_c - a_c) / (a_wh * _VAR[0])
    d_wh = torch.log(g_wh / a_wh) / _VAR[1]
    return torch.cat([d_c, d_wh], dim=-1)


def decode_boxes(deltas, anchors_xyxy):
    """Regression deltas -> xyxy boxes."""
    a_wh = anchors_xyxy[..., 2:] - anchors_xyxy[..., :2]
    a_c = anchors_xyxy[..., :2] + a_wh / 2
    c = deltas[..., :2] * _VAR[0] * a_wh + a_c
    wh = torch.exp(deltas[..., 2:] * _VAR[1]) * a_wh
    return torch.cat([c - wh / 2, c + wh / 2], dim=-1)


def pad_ground_truth(boxes_list: Sequence[np.ndarray],
                     labels_list: Sequence[np.ndarray],
                     max_boxes: int) -> Tuple[np.ndarray, np.ndarray]:
    """Pad per-image variable GT to static [n, max_boxes, ...] (labels
    0 = padding) — the static-shape GT convention both detectors train
    on."""
    n = len(boxes_list)
    boxes = np.zeros((n, max_boxes, 4), np.float32)
    labels = np.zeros((n, max_boxes), np.int32)
    for i, (bx, lb) in enumerate(zip(boxes_list, labels_list)):
        k = min(len(lb), max_boxes)
        if k:
            boxes[i, :k] = bx[:k]
            labels[i, :k] = lb[:k]
    return boxes, labels


def nms(boxes: np.ndarray, scores: np.ndarray,
        iou_threshold: float = 0.45, max_det: int = 100
        ) -> List[int]:
    """Greedy non-maximum suppression (host numpy; predict-time only)."""
    order = np.argsort(-scores)
    keep: List[int] = []
    while order.size and len(keep) < max_det:
        i = order[0]
        keep.append(int(i))
        if order.size == 1:
            break
        rest = order[1:]
        lt = np.maximum(boxes[i, :2], boxes[rest, :2])
        rb = np.minimum(boxes[i, 2:], boxes[rest, 2:])
        wh = np.clip(rb - lt, 0, None)
        inter = wh[:, 0] * wh[:, 1]
        area_i = (boxes[i, 2] - boxes[i, 0]) * (boxes[i, 3] - boxes[i, 1])
        area_r = ((boxes[rest, 2] - boxes[rest, 0])
                  * (boxes[rest, 3] - boxes[rest, 1]))
        iou = inter / np.clip(area_i + area_r - inter, 1e-8, None)
        order = rest[iou <= iou_threshold]
    return keep


def detections(probs: np.ndarray, boxes_all: np.ndarray,
               score_threshold: float, nms_iou: float, max_det: int
               ) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Per image: (boxes [k, 4] clipped to [0, 1], scores [k], classes
    [k] 1-based) from class probabilities [b, N, C+1] (0 = background)
    and decoded boxes [b, N, 4]: each box's best foreground class, the
    scores under `score_threshold` dropped, class-wise `nms`, the best
    `max_det` kept (the JAX detectors' `detect`)."""
    out = []
    for b in range(len(probs)):
        scores = probs[b, :, 1:]              # drop background
        cls_ids = scores.argmax(axis=1)
        cls_scores = scores.max(axis=1)
        m = cls_scores >= score_threshold
        boxes, sc, cid = (boxes_all[b][m], cls_scores[m], cls_ids[m] + 1)
        keep: List[int] = []
        for c in np.unique(cid):              # class-wise NMS
            idx = np.flatnonzero(cid == c)
            kept = nms(boxes[idx], sc[idx], nms_iou, max_det)
            keep.extend(idx[kept].tolist())
        keep = sorted(keep, key=lambda i: -sc[i])[:max_det]
        out.append((np.clip(boxes[keep], 0, 1), sc[keep], cid[keep]))
    return out
