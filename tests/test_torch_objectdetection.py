"""The port's object detection (analytics_zoo_tpu_torch/models/image/
objectdetection/) held against the JAX package's on the CPU:

* `box_utils`: the anchor grid and `pad_ground_truth` bitwise, IoU,
  encode and decode to 1e-6, `nms` the same indices;
* `roi_align`, `multibox_loss` and `faster_rcnn_loss` on the same
  inputs, within 1e-5 in f32;
* the SSD and Faster R-CNN networks from converted flax params, in f32,
  within 1e-5 (Faster R-CNN's top-k of the objectness has no tie here:
  `torch.topk` and `lax.top_k` may order tied scores differently);
* fit, detect, save and load through the ZooModel surface.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.models.image.objectdetection import (
    box_utils as jbu,
    faster_rcnn as jfr,
    ssd as jssd,
)
from analytics_zoo_tpu_torch.convert import image_from_flax
from analytics_zoo_tpu_torch.models.image.objectdetection import (
    box_utils as bu,
    faster_rcnn as fr,
    ssd,
)
from analytics_zoo_tpu_torch.serving import InferenceModel

TOL = 1e-5
SSD_KW = dict(num_classes=2, image_size=32, channels=(8, 16, 32),
              scales=(0.3, 0.6))
FRCNN_KW = dict(num_classes=2, image_size=32, channels=(8, 16),
                num_proposals=8)


def _boxes(rng, n):
    c, s = rng.uniform(0.2, 0.8, (n, 2)), rng.uniform(0.1, 0.4, (n, 2))
    return np.clip(np.concatenate([c - s / 2, c + s / 2], 1), 0, 1).astype(
        np.float32)


def _ground_truth(rng, b, m=4):
    """b images of 1-3 boxes each, padded to m (labels 0 = padding)."""
    boxes = [_boxes(rng, int(rng.integers(1, 4))) for _ in range(b)]
    labels = [rng.integers(1, 3, len(bx)) for bx in boxes]
    return bu.pad_ground_truth(boxes, labels, m)


def _images(rng, b):
    return rng.uniform(size=(b, 32, 32, 3)).astype(np.float32)


def _t(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def test_box_utils_match_jax():
    rng = np.random.default_rng(0)
    args = (64, (8, 4), (0.2, 0.5), (1.0, 2.0, 0.5))
    assert np.array_equal(bu.generate_anchors(*args),
                          jbu.generate_anchors(*args))
    a, b = _boxes(rng, 7), _boxes(rng, 5)
    np.testing.assert_allclose(bu.iou_matrix(*_t(a, b)).numpy(),
                               np.asarray(jbu.iou_matrix(a, b)), atol=1e-6)
    # batched, as the losses call it
    np.testing.assert_allclose(
        bu.iou_matrix(*_t(a, np.stack([b, b[::-1]]))).numpy()[1],
        np.asarray(jbu.iou_matrix(a, b[::-1])), atol=1e-6)
    anchors = bu.generate_anchors(32, (4,), (0.4,))[:5]
    enc = bu.encode_boxes(*_t(b, anchors))
    np.testing.assert_allclose(enc.numpy(), np.asarray(
        jbu.encode_boxes(b, anchors)), atol=1e-6)
    deltas = rng.normal(size=(5, 4)).astype(np.float32)
    np.testing.assert_allclose(
        bu.decode_boxes(*_t(deltas, anchors)).numpy(),
        np.asarray(jbu.decode_boxes(deltas, anchors)), atol=1e-6)
    boxes = [_boxes(rng, 3), _boxes(rng, 0), _boxes(rng, 6)]
    labels = [np.array([1, 2, 1]), np.zeros(0, int), np.arange(1, 7)]
    for got, want in zip(bu.pad_ground_truth(boxes, labels, 4),
                         jbu.pad_ground_truth(boxes, labels, 4)):
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_nms_gives_jax_indices():
    rng = np.random.default_rng(1)
    # overlapping clusters, so suppression happens
    centres = np.repeat(_boxes(rng, 6), 5, axis=0)
    boxes = np.clip(centres + rng.normal(0, 0.03, centres.shape), 0, 1
                    ).astype(np.float32)
    scores = rng.permutation(30).astype(np.float32) / 30
    for thr, max_det in ((0.45, 100), (0.3, 4), (0.9, 100)):
        got = bu.nms(boxes, scores, thr, max_det)
        assert got == jbu.nms(boxes, scores, thr, max_det)
    assert len(bu.nms(boxes, scores, 0.45)) < 30


def test_roi_align_matches_jax():
    rng = np.random.default_rng(2)
    feat = rng.normal(size=(2, 6, 5, 3)).astype(np.float32)
    lo = rng.uniform(0, 0.6, (2, 7, 2))
    boxes = np.concatenate([lo, lo + rng.uniform(0.05, 0.5, (2, 7, 2))],
                           -1).astype(np.float32)
    boxes[0, 0] = [-0.2, 0.9, 1.3, 1.4]      # outside: clipped samples
    got = fr.roi_align(*_t(feat, boxes), 3).numpy()
    want = np.asarray(jax.vmap(jfr.roi_align, in_axes=(0, 0, None))(
        feat, boxes, 3))
    assert got.shape == (2, 7, 3, 3, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    np.testing.assert_allclose(fr.roi_align(*_t(feat[1], boxes[1]), 3),
                               want[1], rtol=0, atol=TOL)


def _ssd_pair(seed=0):
    jd = jssd.SSDDetector(**SSD_KW, compute_dtype=jnp.float32)
    pd = ssd.SSDDetector(**SSD_KW, compute_dtype=torch.float32,
                         device="cpu")
    x = _images(np.random.default_rng(seed), 3)
    variables = jax.tree_util.tree_map(
        np.asarray, jax.jit(jd.module().init)(jax.random.PRNGKey(seed), x))
    pd.load_state_dict(image_from_flax(variables["params"], None, "net."))
    return jd, pd, variables, x


def test_ssd_forward_and_multibox_loss_match_jax():
    jd, pd, variables, x = _ssd_pair()
    assert np.array_equal(pd.anchors, jd.anchors)
    want = jax.jit(jd.module().apply)(variables, x)
    with torch.no_grad():
        got = pd(torch.from_numpy(x))
    assert got[0].shape == (3, len(pd.anchors), 3)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=TOL)
    gt = _ground_truth(np.random.default_rng(3), 3)
    # the loss of the same predictions, and of trained-looking ones
    cls = np.asarray(want[0]) * 4
    jax_loss = jax.jit(jd.default_loss)
    for preds in (want, (cls, want[1])):
        jl = np.asarray(jax_loss(preds, gt))
        pl = pd.default_loss(_t(*preds), _t(*gt)).numpy()
        np.testing.assert_allclose(pl, jl, rtol=0, atol=TOL)


def test_faster_rcnn_forward_and_loss_match_jax():
    jd = jfr.FasterRCNNDetector(**FRCNN_KW, compute_dtype=jnp.float32)
    pd = fr.FasterRCNNDetector(**FRCNN_KW, compute_dtype=torch.float32,
                               device="cpu")
    assert np.array_equal(pd.anchors, jd.anchors)
    x = _images(np.random.default_rng(4), 3)
    variables = jax.tree_util.tree_map(
        np.asarray, jax.jit(jd.module().init)(jax.random.PRNGKey(1), x))
    pd.load_state_dict(image_from_flax(variables["params"], None, "net."))
    want = jax.jit(jd.module().apply)(variables, x)
    # no tie among the objectness scores the top-k ranks
    obj = np.sort(np.asarray(want[0]), axis=1)
    assert (np.diff(obj, axis=1) > 0).all()
    with torch.no_grad():
        got = pd(torch.from_numpy(x))
    names = ("obj", "rpn_deltas", "proposals", "roi_cls", "roi_deltas")
    for name, g, w in zip(names, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=TOL, err_msg=name)
    gt = _ground_truth(np.random.default_rng(5), 3)
    jl = np.asarray(jax.jit(jd.default_loss)(want, gt))
    pl = pd.default_loss(_t(*want), _t(*gt)).numpy()
    np.testing.assert_allclose(pl, jl, rtol=0, atol=TOL)
    # the proposals carry no gradient into the RPN
    pd.train()
    out = pd(torch.from_numpy(x))
    assert not out[2].requires_grad and out[0].requires_grad


def _squares(n=32, size=32, seed=0):
    rng = np.random.default_rng(seed)
    imgs = np.zeros((n, size, size, 3), np.float32)
    boxes, labels = [], []
    for i in range(n):
        w = int(rng.integers(8, 16))
        x0, y0 = rng.integers(0, size - w, 2)
        imgs[i, y0:y0 + w, x0:x0 + w] = 1.0
        boxes.append(np.array([[x0, y0, x0 + w, y0 + w]], np.float32) / size)
        labels.append(np.array([1]))
    return imgs, bu.pad_ground_truth(boxes, labels, 4)


@pytest.mark.parametrize("cls,kw", [(ssd.SSDDetector, SSD_KW),
                                    (fr.FasterRCNNDetector, FRCNN_KW)],
                         ids=["ssd", "faster_rcnn"])
def test_detector_fits_detects_and_reloads(cls, kw, tmp_path):
    imgs, (gt_boxes, gt_labels) = _squares()
    torch.manual_seed(0)
    det = cls(**{**kw, "num_classes": 1}, lr=5e-3,
              compute_dtype=torch.float32, device="cpu")
    det.fit({"x": imgs, "y": [gt_boxes, gt_labels]}, epochs=4,
            batch_size=16)
    losses = [s["loss"] for s in det._require_estimator().train_summary]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    results = det.detect(imgs[:6], score_threshold=0.0, max_det=5)
    assert len(results) == 6
    for boxes, scores, classes in results:
        assert len(boxes) <= 5 and boxes.shape[1:] == (4,)
        assert ((boxes >= 0) & (boxes <= 1)).all()
        assert (np.diff(scores) <= 0).all() and (classes == 1).all()
    path = det.save_model(str(tmp_path / "det"))
    back = cls.load_model(path, device="cpu")
    assert set(back.state_dict()) == set(det.state_dict())
    served = InferenceModel().load_model(path, device="cpu").predict(imgs[:3])
    with torch.no_grad():
        direct = det.eval()(torch.from_numpy(imgs[:3]))
    for s, d in zip(served, direct):
        np.testing.assert_array_equal(s, d.numpy())
