"""The Caffe importer of the port
(analytics_zoo_tpu_torch/pipeline/caffe_graph.py) held against the JAX
package's on the CPU: every case of tests/test_caffe_import.py, and a
net of every other supported layer type, as the same caffemodel bytes
(written by that file's encoder) and the same seeded NCHW inputs
through both `Net.load_caffe`s.

Tolerances: f32 outputs within 1e-5 x max(1, |JAX|) per element (the
same f32 arithmetic in other orders: XLA's NHWC convs against torch's
NCHW ones); decoded blobs bitwise."""

import numpy as np
import pytest
import torch

from analytics_zoo_tpu.pipeline import caffe_graph as jax_caffe
from analytics_zoo_tpu.pipeline.net import Net as JaxNet
from analytics_zoo_tpu.utils.tf_example import _len_delim, _tag, _varint
from analytics_zoo_tpu_torch.pipeline import caffe_graph
from analytics_zoo_tpu_torch.pipeline.net import Net
from tests.test_caffe_import import _params, layer, netparam

TOL = 1e-5


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale)


def _both(def_path, model, *xs):
    jnet = JaxNet.load_caffe(def_path, model)
    net = Net.load_caffe(def_path, model, device="cpu")
    assert net.input_names == jnet.input_names
    assert net.output_names == jnet.output_names
    got, want = net.predict(*xs), jnet.predict(*xs)
    if isinstance(want, tuple):
        for g, w in zip(got, want):
            _close(g, w)
    else:
        _close(got, want)
    return got


def _conv_relu_ip_softmax(rng):
    k = rng.normal(size=(4, 3, 3, 3)).astype(np.float32)
    kb = rng.normal(size=(4,)).astype(np.float32)
    w = rng.normal(size=(5, 4 * 8 * 8)).astype(np.float32) * 0.1
    wb = rng.normal(size=(5,)).astype(np.float32)
    model = netparam([
        layer("conv", "Convolution", ["data"], ["c1"], [k, kb],
              _params(106, {1: 4, 4: [3], 3: [1]})),   # pad 1
        layer("relu", "ReLU", ["c1"], ["c1"]),          # in-place
        layer("fc", "InnerProduct", ["c1"], ["fc"], [w, wb],
              _params(117, {1: 5})),
        layer("prob", "Softmax", ["fc"], ["prob"]),
    ], inputs=["data"])
    return model, [rng.normal(size=(2, 3, 8, 8)).astype(np.float32)]


def _ceil_pooling(rng):
    """MAX and AVE at k 3 s 2 on 8 (ceil adds a window), at k 3 s 2 p 1
    on 7 (the far window that would start in the padding is clipped),
    and at k 2 s 2 on 5 (JAX's golden case)."""
    layers = []
    for i, (pool, k, s, p) in enumerate(((0, 3, 2, 0), (1, 3, 2, 0),
                                         (0, 3, 2, 1), (1, 3, 2, 1),
                                         (0, 2, 2, 0), (1, 2, 2, 0))):
        layers.append(layer(f"p{i}", "Pooling", ["data"], [f"p{i}"], [],
                            _params(121, {1: pool, 2: k, 3: s, 4: p})))
    layers.append(layer("g", "Pooling", ["data"], ["gmax"], [],
                        _params(121, {1: 0, 12: 1})))
    layers.append(layer("ga", "Pooling", ["data"], ["gave"], [],
                        _params(121, {1: 1, 12: 1})))
    return netparam(layers, inputs=["data"]), [
        rng.normal(size=(2, 3, 8, 7)).astype(np.float32)]


def _bn_scale_eltwise_concat(rng):
    mean = rng.normal(size=3).astype(np.float32)
    var = rng.uniform(0.5, 2.0, 3).astype(np.float32)
    sf = np.array([2.0], np.float32)
    gamma = rng.uniform(0.5, 1.5, 3).astype(np.float32)
    beta = rng.normal(size=3).astype(np.float32)
    model = netparam([
        layer("bn", "BatchNorm", ["data"], ["bn"], [mean, var, sf],
              _params(139, {3: 1e-5})),
        layer("sc", "Scale", ["bn"], ["sc"], [gamma, beta],
              _params(142, {4: 1})),
        layer("sum", "Eltwise", ["sc", "data"], ["sum"], [],
              _params(110, {1: 1})),
        layer("cat", "Concat", ["sum", "data"], ["cat"], [],
              _params(104, {2: 1})),
    ], inputs=["data"])
    return model, [rng.normal(size=(2, 3, 4, 4)).astype(np.float32)]


def _lrn(rng):
    model = netparam([
        layer("lrn1", "LRN", ["data"], ["l1"], [],
              _params(118, {1: 1, 2: 0.5, 3: 1.0})),   # JAX's golden
        layer("lrn5", "LRN", ["data"], ["l5"], [],
              _params(118, {1: 5, 2: 1e-4, 3: 0.75})),  # CaffeNet's
        layer("lrnw", "LRN", ["data"], ["lw"], [],
              _params(118, {1: 3, 2: 0.1, 3: 0.5, 4: 1, 5: 2.0})),
        layer("cat", "Concat", ["l1", "l5", "lw"], ["cat"], [],
              _params(104, {2: 1})),
    ], inputs=["data"])
    return model, [rng.normal(size=(2, 7, 5, 6)).astype(np.float32) * 3]


def _train_phase_and_loss_head(rng):
    w = np.eye(4, dtype=np.float32)
    model = netparam([
        layer("fc", "InnerProduct", ["data"], ["fc"], [w],
              _params(117, {1: 4, 2: 0})),
        layer("drop", "Dropout", ["fc"], ["fc"]),
        layer("trainonly", "SomeTrainThing", ["fc"], ["t"], [],
              phase=0),
        layer("loss", "SoftmaxWithLoss", ["fc"], ["loss"]),
    ], inputs=["data"])
    return model, [rng.normal(size=(2, 4)).astype(np.float32)]


def _inplace_terminal(rng):
    w = np.array([[1.0, -1.0], [-1.0, 1.0]], np.float32)
    model = netparam([
        layer("fc", "InnerProduct", ["data"], ["fc"], [w],
              _params(117, {1: 2, 2: 0})),
        layer("relu", "ReLU", ["fc"], ["fc"]),   # in-place terminal
    ], inputs=["data"])
    return model, [np.array([[2.0, -3.0]], np.float32)]


def _layer_zoo(rng):
    """Every other layer type: grouped / strided / dilated conv, the
    activations, Power, PReLU, Flatten, Eltwise PROD / MAX / weighted
    SUM, two-bottom Scale, InnerProduct with transpose, two inputs."""
    k = rng.normal(size=(6, 2, 3, 3)).astype(np.float32) * 0.3
    kb = rng.normal(size=6).astype(np.float32)
    slope = rng.uniform(0.1, 0.3, 6).astype(np.float32)
    w = rng.normal(size=(6 * 2 * 4, 3)).astype(np.float32) * 0.1
    layers = [
        layer("conv", "Convolution", ["data"], ["c"], [k, kb],
              _params(106, {1: 6, 5: 2, 11: 3, 12: 3, 13: 2, 14: 1,
                            9: 1, 10: 0, 18: [2]})),
        layer("prelu", "PReLU", ["c"], ["pr"], [slope]),
        layer("elu", "ELU", ["c"], ["elu"]),
        layer("sig", "Sigmoid", ["c"], ["sig"]),
        layer("tanh", "TanH", ["c"], ["tanh"]),
        layer("abs", "AbsVal", ["c"], ["abs"]),
        layer("exp", "Exp", ["tanh"], ["exp"]),
        layer("log", "Log", ["exp"], ["log"]),
        layer("pow", "Power", ["sig"], ["pow"], [],
              _params(122, {1: 2.0, 2: 0.5, 3: 1.0})),
        layer("prod", "Eltwise", ["pr", "elu", "abs"], ["prod"], [],
              _params(110, {1: 0})),
        layer("max", "Eltwise", ["prod", "log"], ["max"], [],
              _params(110, {1: 2})),
        layer("wsum", "Eltwise", ["max", "pow"], ["wsum"], [],
              _len_delim(110, _tag(1, 0) + _varint(1) + b"".join(
                  _tag(2, 5) + np.float32(c).tobytes()
                  for c in (0.5, -2.0)))),    # SUM, coeff 0.5, -2
        layer("sc2", "Scale", ["wsum", "gate"], ["sc2"]),
        layer("flat", "Flatten", ["sc2"], ["flat"]),
        layer("fc", "InnerProduct", ["flat"], ["fc"], [w],
              _params(117, {1: 3, 2: 0, 6: 1})),
    ]
    xs = [rng.normal(size=(2, 4, 5, 8)).astype(np.float32),
          rng.normal(size=(2, 6, 2, 4)).astype(np.float32)]
    return netparam(layers, inputs=["data", "gate"]), xs


CASES = {"conv_relu_ip_softmax": _conv_relu_ip_softmax,
         "ceil_pooling": _ceil_pooling,
         "bn_scale_eltwise_concat": _bn_scale_eltwise_concat,
         "lrn": _lrn, "train_phase_and_loss_head": _train_phase_and_loss_head,
         "inplace_terminal": _inplace_terminal, "layer_zoo": _layer_zoo}


@pytest.mark.parametrize("case", sorted(CASES))
def test_net_matches_jax(case):
    rng = np.random.default_rng(sorted(CASES).index(case))
    model, xs = CASES[case](rng)
    _both(None, model, *xs)


def test_ceil_mode_golden_values():
    """JAX's pinned values: ceil((5 - 2) / 2) + 1 = 3 windows; AVE
    divides by the window clipped to the image."""
    x = np.arange(25, dtype=np.float32).reshape(1, 1, 5, 5)
    for pool, want in ((0, [[6, 8, 9], [16, 18, 19], [21, 23, 24]]),
                       (1, None)):
        got = _both(None, netparam([
            layer("pool", "Pooling", ["data"], ["p"], [],
                  _params(121, {1: pool, 2: 2, 3: 2}))],
            inputs=["data"]), x)
        assert got.shape == (1, 1, 3, 3)
        if want is not None:
            np.testing.assert_array_equal(got[0, 0], want)
        else:
            assert got[0, 0, 0, 0] == (0 + 1 + 5 + 6) / 4
            assert got[0, 0, 0, 2] == (4 + 9) / 2
            assert got[0, 0, 2, 2] == 24


def test_prototxt_input_declaration(tmp_path):
    w = np.eye(2, dtype=np.float32) * 3.0
    proto = tmp_path / "deploy.prototxt"
    proto.write_text('name: "n"\ninput: "data"\n'
                     'input_dim: 1\ninput_dim: 2\n')
    model = netparam([
        layer("fc", "InnerProduct", ["data"], ["fc"], [w],
              _params(117, {1: 2, 2: 0})),
    ])
    got = _both(str(proto), model, np.ones((1, 2), np.float32))
    np.testing.assert_allclose(got, 3.0)


@pytest.mark.parametrize("kind", ["unknown_layer", "deconvolution", "v1"])
def test_refusals_match_jax(kind):
    if kind == "v1":
        v1 = _len_delim(1, b"old") + _len_delim(2, b"\x00")
        for load in (lambda: JaxNet.load_caffe(None, v1),
                     lambda: Net.load_caffe(None, v1, device="cpu")):
            with pytest.raises(NotImplementedError, match="upgrade"):
                load()
        return
    typ = "Exotic" if kind == "unknown_layer" else "Deconvolution"
    model = netparam([layer("z", typ, ["data"], ["z"])], inputs=["data"])
    for net in (JaxNet.load_caffe(None, model),
                Net.load_caffe(None, model, device="cpu")):
        with pytest.raises(NotImplementedError, match=typ):
            net.predict(np.ones((1, 2), np.float32))


def _blob_fields(vals, wire):
    shape = _len_delim(7, _tag(1, 0) + _varint(len(vals)))
    if wire == "f32_packed":
        return shape + _len_delim(5, vals.astype("<f4").tobytes())
    if wire == "f32_unpacked":
        return shape + b"".join(_tag(5, 5) + v.astype("<f4").tobytes()
                                for v in vals)
    if wire == "f64_packed":
        return shape + _len_delim(8, vals.astype("<f8").tobytes())
    return shape + b"".join(_tag(8, 1) + v.astype("<f8").tobytes()
                            for v in vals)


@pytest.mark.parametrize("wire", ["f32_packed", "f32_unpacked",
                                  "f64_packed", "f64_unpacked"])
def test_blob_decodes_bitwise_as_jax(wire):
    """Packed and unpacked float and double data (doubles rounded to
    f32 as JAX's list decoder rounds them), with double_diff (solver
    state) ignored."""
    rng = np.random.default_rng(5)
    vals = rng.normal(size=7) * 10 ** rng.uniform(-30, 30, 7)
    vals[0] = 1.0 + 2.0 ** -30        # rounds to 1.0 in f32
    buf = _blob_fields(vals, wire) + _len_delim(
        9, np.full(7, 9.0).astype("<f8").tobytes())
    got = caffe_graph._parse_blob(memoryview(buf))
    want = jax_caffe._parse_blob(buf)
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape == (7,)
    assert got.tobytes() == want.tobytes()


def test_mixed_chunks_and_legacy_shape_decode_as_jax():
    rng = np.random.default_rng(6)
    a = rng.normal(size=6).astype(np.float32)
    # legacy num/channels/height/width and two data chunks
    buf = (_tag(1, 0) + _varint(1) + _tag(2, 0) + _varint(2)
           + _tag(3, 0) + _varint(3) + _tag(4, 0) + _varint(2)
           + _len_delim(5, a[:4].tobytes())
           + b"".join(_tag(5, 5) + v.tobytes() for v in a[4:])
           + _len_delim(5, a.tobytes()))
    got = caffe_graph._parse_blob(memoryview(buf))
    want = jax_caffe._parse_blob(buf)
    assert got.shape == want.shape == (1, 2, 3, 2)
    assert got.tobytes() == want.tobytes()


def test_parse_caffemodel_matches_jax():
    model, _ = _layer_zoo(np.random.default_rng(2))
    got, want = caffe_graph.parse_caffemodel(model), \
        jax_caffe.parse_caffemodel(model)
    assert got["inputs"] == want["inputs"]
    assert len(got["layers"]) == len(want["layers"])
    for g, w in zip(got["layers"], want["layers"]):
        assert {k: g[k] for k in ("name", "type", "bottoms", "tops",
                                  "params", "phase")} == \
            {k: w[k] for k in ("name", "type", "bottoms", "tops",
                               "params", "phase")}
        assert [b.tobytes() for b in g["blobs"]] == \
            [b.tobytes() for b in w["blobs"]]


def test_no_device_raises(monkeypatch):
    model, _ = _inplace_terminal(None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Net.load_caffe(None, model)
