"""The port's InferenceModel (analytics_zoo_tpu_torch/serving/
inference_model.py) serving a small BERTClassifier, held against the
JAX package's InferenceModel serving the same weights through
`load_flax`, and against direct calls of the module: bucket padding,
chunking above max_batch_size, concurrent callers, records_served,
tuple outputs, and the raises.

Tolerances: against the JAX InferenceModel at the default bf16, 0.05
absolute on logits (as tests/test_torch_bert.py states); against direct
calls of the same f32 module, 1e-5 absolute (padding rows cannot reach
real rows; only the batch size of the matmuls differs)."""

import threading

import numpy as np
import pytest
import torch

from analytics_zoo_tpu.models.bert import BERTClassifier as JaxClassifier
from analytics_zoo_tpu.serving.inference_model import (
    InferenceModel as JaxInferenceModel,
)
from analytics_zoo_tpu_torch.convert import bert_from_flax, init_bert_params
from analytics_zoo_tpu_torch.models.bert import BERTClassifier, BERTSQuAD
from analytics_zoo_tpu_torch.serving.inference_model import (
    InferenceModel,
    _bucket,
)

CFG = dict(vocab=41, hidden_size=32, n_head=2, n_block=2,
           intermediate_size=64, max_position_len=32, num_classes=3)
TOL, BF16_TOL = 1e-5, 0.05


def _model(compute_dtype=torch.bfloat16, seed=0):
    tree = init_bert_params(CFG, seed=seed)
    m = BERTClassifier(**CFG, compute_dtype=compute_dtype, device="cpu")
    m.load_state_dict(bert_from_flax(tree, CFG))
    return m, tree


def _requests(n, t=16, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, CFG["vocab"], (n, t)).astype(np.int32)
    seg = np.zeros((n, t), np.int32)
    lens = rng.integers(t // 4, t + 1, n)
    mask = (np.arange(t)[None] < lens[:, None]).astype(np.int32)
    return ids, seg, mask


def _direct(model, ids, seg, mask):
    with torch.no_grad():
        return model(*(torch.from_numpy(a) for a in (ids, seg, mask))
                     ).numpy()


def test_matches_jax_inference_model():
    model, tree = _model()
    reqs = _requests(5, seed=1)
    want = JaxInferenceModel(max_batch_size=8).load_flax(
        JaxClassifier(**CFG),
        tree).predict(*reqs)
    got = InferenceModel(max_batch_size=8).load_module(model).predict(*reqs)
    assert got.shape == want.shape == (5, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(want), atol=BF16_TOL, rtol=0)


def test_bucket_padding_gives_the_unpadded_rows():
    assert [_bucket(n, 8) for n in (1, 3, 5, 8)] == [1, 4, 8, 8]
    model, _ = _model(torch.float32)
    im = InferenceModel(max_batch_size=8).load_module(model)
    reqs = _requests(5, seed=2)               # padded to a bucket of 8
    np.testing.assert_allclose(im.predict(*reqs), _direct(model, *reqs),
                               atol=TOL, rtol=0)


def test_chunks_above_max_batch_size():
    model, _ = _model(torch.float32)
    im = InferenceModel(max_batch_size=4).load_module(model)
    reqs = _requests(11, seed=3)               # chunks of 4, 4 and 3
    got = im.predict(*reqs)
    assert got.shape == (11, 3)
    np.testing.assert_allclose(got, _direct(model, *reqs), atol=TOL, rtol=0)
    assert im.records_served == 11


def test_concurrent_callers_and_records_served():
    model, _ = _model(torch.float32)
    im = InferenceModel(supported_concurrent_num=2,
                        max_batch_size=4).load_module(model)
    reqs = [_requests(n, seed=10 + i) for i, n in enumerate((1, 3, 4, 6))]
    want = [_direct(model, *r) for r in reqs]
    results = {}

    def caller(i):
        for rep in range(3):
            results[(i, rep)] = im.predict(*reqs[i])

    threads = [threading.Thread(target=caller, args=(i,))
               for i in range(len(reqs))]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    for (i, _), got in results.items():
        np.testing.assert_allclose(got, want[i], atol=TOL, rtol=0)
    assert len(results) == 12
    assert im.records_served == 3 * (1 + 3 + 4 + 6)


def test_tuple_outputs_padded_and_chunked():
    """A module returning a tuple (BERTSQuAD's start and end logits)
    gives a tuple of [n, t] arrays through bucket padding and through
    chunking, each equal to a direct call's."""
    cfg = {k: v for k, v in CFG.items() if k != "num_classes"}
    m = BERTSQuAD(**cfg, compute_dtype=torch.float32, device="cpu")
    m.load_state_dict(bert_from_flax(
        init_bert_params(cfg, seed=4, head="span_head"), cfg))
    im = InferenceModel(max_batch_size=4).load_module(m)
    for n in (3, 7):                # a bucket of 4; chunks of 4 and 3
        reqs = _requests(n, seed=20 + n)
        got = im.predict(*reqs)
        with torch.no_grad():
            want = m(*(torch.from_numpy(a) for a in reqs))
        assert isinstance(got, tuple) and len(got) == 2
        for g, w in zip(got, want):
            assert g.shape == (n, 16)
            np.testing.assert_allclose(g, w.numpy(), atol=TOL, rtol=0)
    assert im.records_served == 10


def test_raises_without_card_model_or_quantizer(monkeypatch):
    with pytest.raises(RuntimeError, match="no model loaded"):
        InferenceModel().predict(np.zeros((1, 4), np.int32))
    model, _ = _model()
    with pytest.raises(NotImplementedError, match="quantize"):
        InferenceModel().load_module(model, quantize=True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BERTClassifier(**CFG)
