"""The TF1 frozen-graph importer of the port
(analytics_zoo_tpu_torch/pipeline/tf_graph.py) held against the JAX
package's on the CPU: the same GraphDef bytes (written by
tests/tf_graphdef_builder.py, the JAX tests' encoder) and the same
seeded numpy inputs through both `Net.load_tf`s.

Tolerances: f32 outputs within 1e-5 x max(1, |JAX|) per element (the
same f32 arithmetic in other orders: XLA's NHWC convs against cuDNN's /
oneDNN's NCHW ones); output dtypes equal to JAX's; decoded constants
bitwise."""

import numpy as np
import pytest
import torch

import ml_dtypes

from analytics_zoo_tpu.pipeline import tf_graph as jax_tf
from analytics_zoo_tpu.pipeline.net import Net as JaxNet
from analytics_zoo_tpu.serving.inference_model import (
    InferenceModel as JaxInferenceModel,
)
from analytics_zoo_tpu.utils import tf_example as jax_wire
from analytics_zoo_tpu_torch.pipeline import tf_graph
from analytics_zoo_tpu_torch.pipeline.net import Net
from analytics_zoo_tpu_torch.serving.inference_model import InferenceModel
from analytics_zoo_tpu_torch.utils import tf_example
from tests.tf_graphdef_builder import (
    _len_delim,
    _tag,
    _varint,
    attr_b,
    attr_f,
    attr_i,
    attr_ints,
    attr_s,
    const,
    graphdef,
    node,
    placeholder,
)

TOL = 1e-5


def _both(gd, *xs, outputs=None):
    want = JaxNet.load_tf(gd, outputs=outputs).predict(*xs)
    net = Net.load_tf(gd, outputs=outputs, device="cpu")
    got = net.predict(*xs)
    return got, want, net


def _close(got, want):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w)
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (
        got.shape, want.shape, got.dtype, want.dtype)
    scale = max(1.0, float(np.abs(want.astype(np.float64)).max(
        initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale)


def _dense():
    rng = np.random.default_rng(0)
    w = rng.normal(size=(4, 3)).astype(np.float32)
    b = rng.normal(size=(3,)).astype(np.float32)
    gd = graphdef([
        placeholder("x"),
        const("w", w), const("b", b),
        node("mm", "MatMul", ["x", "w"]),
        node("ba", "BiasAdd", ["mm", "b"]),
        node("out", "Relu", ["ba"]),
    ])
    return gd, [rng.normal(size=(5, 4)).astype(np.float32)], None


def _conv_bn_pool():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 9, 9, 3)).astype(np.float32)
    k = rng.normal(size=(3, 3, 3, 4)).astype(np.float32)
    k2 = rng.normal(size=(3, 3, 4, 5)).astype(np.float32)
    nodes = [placeholder("x"), const("k", k), const("k2", k2)]
    for n, v in (("scale", rng.uniform(0.5, 1.5, 4)),
                 ("offset", rng.normal(size=4)),
                 ("mean", rng.normal(size=4)),
                 ("var", rng.uniform(0.5, 2.0, 4))):
        nodes.append(const(n, v.astype(np.float32)))
    nodes += [
        node("conv", "Conv2D", ["x", "k"],
             {"strides": attr_ints([1, 1, 1, 1]),
              "padding": attr_s("SAME"), "data_format": attr_s("NHWC")}),
        node("bn", "FusedBatchNormV3",
             ["conv", "scale", "offset", "mean", "var"],
             {"epsilon": attr_f(1e-3), "is_training": attr_b(False)}),
        node("relu", "Relu6", ["bn:0"]),
        # stride 2 SAME on 9: TF's asymmetric padding (0 before, 1 after)
        node("conv2", "Conv2D", ["relu", "k2"],
             {"strides": attr_ints([1, 2, 2, 1]),
              "padding": attr_s("SAME")}),
        node("pool", "MaxPool", ["conv2"],
             {"ksize": attr_ints([1, 2, 2, 1]),
              "strides": attr_ints([1, 2, 2, 1]),
              "padding": attr_s("SAME")}),
        node("avg", "AvgPool", ["conv2"],
             {"ksize": attr_ints([1, 3, 3, 1]),
              "strides": attr_ints([1, 2, 2, 1]),
              "padding": attr_s("SAME")}),
        node("avgv", "AvgPool", ["relu"],
             {"ksize": attr_ints([1, 2, 2, 1]),
              "strides": attr_ints([1, 2, 2, 1]),
              "padding": attr_s("VALID")}),
    ]
    return graphdef(nodes), [x], ["pool", "avg", "avgv"]


def _depthwise_concat():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(1, 7, 7, 2)).astype(np.float32)
    dk = rng.normal(size=(3, 3, 2, 3)).astype(np.float32)
    gd = graphdef([
        placeholder("x"),
        const("dk", dk),
        node("dkr", "Identity", ["dk"]),
        node("dw", "DepthwiseConv2dNative", ["x", "dkr"],
             {"strides": attr_ints([1, 2, 2, 1]),
              "padding": attr_s("SAME")}),
        node("dw1", "DepthwiseConv2dNative", ["x", "dk"],
             {"strides": attr_ints([1, 1, 1, 1]),
              "padding": attr_s("VALID"),
              "dilations": attr_ints([1, 2, 2, 1])}),
        const("cax", np.array(3, np.int32)),
        node("cat", "ConcatV2", ["dw1", "dw1", "cax"], {"N": attr_i(2)}),
        node("sig", "Sigmoid", ["cat"]),
    ])
    return gd, [x], ["dw", "sig"]


def _reductions_shapes():
    x = np.arange(24, dtype=np.float32).reshape(2, 3, 4) / 10
    nodes = [placeholder("x"), const("axes", np.array([1], np.int32)),
             const("ax02", np.array([0, 2], np.int32)),
             node("m", "Mean", ["x", "axes"], {"keep_dims": attr_b(True)}),
             const("newshape", np.array([2, 4], np.int32)),
             node("sq", "Squeeze", ["m"], {"squeeze_dims": attr_ints([1])}),
             node("r", "Reshape", ["sq", "newshape"]),
             node("sm", "Softmax", ["r"])]
    outs = ["sm"]
    for op in ("Sum", "Max", "Min", "Prod"):
        nodes.append(node(op.lower(), op, ["x", "ax02"]))
        outs.append(op.lower())
    nodes += [
        const("one", np.array(1, np.int32)),
        node("ed", "ExpandDims", ["x", "one"]),
        const("perm", np.array([2, 0, 1], np.int32)),
        node("tr", "Transpose", ["x", "perm"]),
        const("pads", np.array([[0, 0], [1, 2], [0, 1]], np.int32)),
        node("pad", "Pad", ["x", "pads"]),
        const("pv", np.float32(-1.5)),
        node("pad2", "PadV2", ["x", "pads", "pv"]),
        node("am", "ArgMax", ["x", "one"]),
        node("shape", "Shape", ["x"]),
        node("addn", "AddN", ["x", "x", "x"]),
        node("sd", "SquaredDifference", ["x", "neg"]),
        node("rd", "RealDiv", ["x", "addn"]),
        node("neg", "Neg", ["x"]),
        node("mx", "Maximum", ["x", "neg"]),
        node("mn", "Minimum", ["x", "neg"]),
        node("lr", "LeakyRelu", ["neg"], {"alpha": attr_f(0.1)}),
        node("rs", "Rsqrt", ["addn"]),
        node("er", "Erf", ["neg"]),
        node("sqr", "Square", ["neg"]),
    ]
    outs += ["ed", "tr", "pad", "pad2", "am", "shape", "sd", "rd", "mx", "mn",
             "lr", "rs", "er", "sqr"]
    return graphdef(nodes), [x], outs


def _control_edges():
    w = np.eye(3, dtype=np.float32) * 2.0
    gd = graphdef([
        placeholder("x"),
        const("w", w),
        node("init", "NoOp"),
        node("wi", "Identity", ["w", "^init"]),
        node("mm", "MatMul", ["x", "wi"], {"transpose_b": attr_b(True)}),
    ])
    return gd, [np.ones((2, 3), np.float32)], None


def _feeds_by_name():
    gd = graphdef([
        node("out", "Sub", ["b", "a"]),
        placeholder("a"),
        placeholder("b"),
    ])
    return gd, [np.full((2,), 10.0, np.float32),
                np.full((2,), 1.0, np.float32)], None


def _deep():
    nodes = [placeholder("x"), const("one", np.float32(1.0))]
    prev = "x"
    for i in range(1500):
        nodes.append(node(f"a{i}", "AddV2", [prev, "one"]))
        prev = f"a{i}"
    return graphdef(nodes), [np.zeros((2,), np.float32)], None


def _const_folding():
    """Operators on two constants stay on the host (static), as JAX's:
    the Reshape target is a Mul of constants."""
    x = np.arange(12, dtype=np.float32)
    gd = graphdef([
        placeholder("x"),
        const("s", np.array([2, 3], np.int32)),
        const("two", np.array([1, 2], np.int32)),
        node("shape", "Mul", ["s", "two"]),
        node("r", "Reshape", ["x", "shape"]),
        node("out", "Tanh", ["r"]),
    ])
    return gd, [x], None


CASES = {"dense": _dense, "conv_bn_pool": _conv_bn_pool,
         "depthwise_concat_outputs": _depthwise_concat,
         "reductions_shapes": _reductions_shapes,
         "control_edges": _control_edges, "feeds_by_name": _feeds_by_name,
         "deep_graph": _deep, "const_folding": _const_folding}


@pytest.mark.parametrize("case", sorted(CASES))
def test_graph_matches_jax(case):
    gd, xs, outputs = CASES[case]()
    got, want, net = _both(gd, *xs, outputs=outputs)
    jnet = JaxNet.load_tf(gd, outputs=outputs)
    assert net.input_names == jnet.input_names
    assert net.output_names == jnet.output_names
    _close(got, want)


def test_default_outputs_and_feed_count():
    gd, xs, _ = _depthwise_concat()
    net = Net.load_tf(gd, device="cpu")
    assert net.output_names == ["dw", "sig"] == JaxNet.load_tf(
        gd).output_names
    with pytest.raises(ValueError, match="placeholders"):
        net.predict()


def test_bfloat16_and_half_val_consts():
    """A DT_BFLOAT16 constant becomes a torch.bfloat16 tensor from its
    bits; a DT_HALF one written as half_val int32 bit patterns a
    float16 array; both decode bitwise as JAX's, and the graphs'
    outputs have JAX's dtypes."""
    bf = np.asarray([1.0, -2.5, 0.375, 3.1415], ml_dtypes.bfloat16)
    gd = graphdef([placeholder("x"), const("w", bf),
                   node("y", "Mul", ["x", "w"])])
    w = tf_graph.parse_graphdef(gd)[1]["attrs"]["value"]["tensor"]
    jw = jax_tf.parse_graphdef(gd)[1]["attrs"]["value"]["tensor"]
    assert w.dtype == torch.bfloat16
    assert np.array_equal(w.view(torch.int16).numpy().view(np.uint16),
                          jw.view(np.uint16))
    x = np.ones(4, np.float32)
    got, want, _ = _both(gd, x)
    _close(got, want)

    fp16 = np.asarray([1.5, -0.25], np.float16)
    bits = fp16.view(np.uint16)
    for dtype_enum, values in ((19, bits), (14, np.asarray(
            [1.0, -2.5], ml_dtypes.bfloat16).view(np.uint16))):
        tensor = (_tag(1, 0) + _varint(dtype_enum)
                  + _len_delim(2, _len_delim(2, _tag(1, 0) + _varint(2)))
                  + b"".join(_tag(13, 0) + _varint(int(b)) for b in values))
        entry = _len_delim(1, b"value") + _len_delim(2, _len_delim(8, tensor))
        cnode = (_len_delim(1, b"h") + _len_delim(2, b"Const")
                 + _len_delim(5, entry))
        gd = graphdef([placeholder("x"), cnode,
                       node("y", "Mul", ["x", "h"])])
        h = tf_graph.parse_graphdef(gd)[1]["attrs"]["value"]["tensor"]
        jh = jax_tf.parse_graphdef(gd)[1]["attrs"]["value"]["tensor"]
        hb = h.view(torch.int16).numpy() if isinstance(h, torch.Tensor) \
            else h
        assert hb.tobytes() == jh.tobytes()
        got, want, _ = _both(gd, np.ones(2, np.float32))
        _close(got, want)


def test_unsupported_and_dynamic_shapes_raise():
    gd = graphdef([placeholder("x"),
                   node("bad", "SparseTensorDenseMatMul", ["x"])])
    for net in (JaxNet.load_tf(gd), Net.load_tf(gd, device="cpu")):
        with pytest.raises(NotImplementedError, match="SparseTensorDense"):
            net.predict(np.zeros((2, 2), np.float32))
    # a Reshape target computed at run time (Shape of the input)
    gd = graphdef([placeholder("x"), node("s", "Shape", ["x"]),
                   node("r", "Reshape", ["x", "s"])])
    for net in (JaxNet.load_tf(gd), Net.load_tf(gd, device="cpu")):
        with pytest.raises(NotImplementedError, match="dynamic shape"):
            net.predict(np.zeros((2, 2), np.float32))


def test_training_batchnorm_refused():
    rng = np.random.default_rng(4)
    nodes = [placeholder("x")] + [
        const(n, rng.uniform(0.5, 1.5, 2).astype(np.float32))
        for n in ("s", "o", "m", "v")]
    nodes.append(node("bn", "FusedBatchNorm", ["x", "s", "o", "m", "v"],
                      {"is_training": attr_b(True)}))
    net = Net.load_tf(graphdef(nodes), device="cpu")
    with pytest.raises(NotImplementedError, match="is_training"):
        net.predict(np.ones((1, 2, 2, 2), np.float32))


def test_load_tf_served_through_inference_model():
    rng = np.random.default_rng(3)
    w = rng.normal(size=(6, 2)).astype(np.float32)
    gd = graphdef([
        placeholder("x"),
        const("w", w),
        node("mm", "MatMul", ["x", "w"]),
        node("out", "Softmax", ["mm"]),
    ])
    im = InferenceModel(max_batch_size=16).load_tf(gd, device="cpu")
    x = rng.normal(size=(21, 6)).astype(np.float32)
    got = im.predict(x)   # 16 + 5 (padded to 8), depadded back
    want = JaxInferenceModel(max_batch_size=16).load_tf(gd).predict(x)
    _close(got, np.asarray(want))
    assert im.records_served == 21


def test_constants_reach_the_device_once():
    gd, xs, _ = _conv_bn_pool()
    net = Net.load_tf(gd, outputs=["pool"], device="cpu")
    net.predict(*xs)
    cached = dict(net._cache)
    net.predict(*xs)
    assert net._cache.keys() == cached.keys()
    assert all(net._cache[k] is cached[k] for k in cached)
    assert ("k", "Conv2D") in cached


def test_shared_packed_decoders_match_jax():
    two = np.asarray([1.5, -2.0], "<f4").tobytes()
    for fn, args in ((tf_example.packed_bools, [(b"\x00\x01\x00", 2),
                                                (1, 0)]),
                     (tf_example.packed_ints, [(b"\x03\x7f", 2),
                                               ((1 << 64) - 2, 0)]),
                     (tf_example.packed_floats, [(two, 2), (two[:4], 5)])):
        for a in args:
            assert fn(*a) == getattr(jax_wire, fn.__name__)(*a)


def test_no_device_raises(monkeypatch):
    gd, _, _ = _dense()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Net.load_tf(gd)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceModel().load_tf(gd)
