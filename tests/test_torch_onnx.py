"""The ONNX importer of the port (analytics_zoo_tpu_torch/pipeline/onnx/)
held against the JAX package's (analytics_zoo_tpu/pipeline/onnx/) on the
CPU: the same ModelProto bytes, written by the JAX package's encoder
and by the port's (bitwise the same), the same seeded numpy inputs.
The JAX module runs eagerly (`init` + `apply`) unless a case says jit.

Tolerances:
  * f32 outputs: 1e-5 x max(1, |JAX|) per element (the same f32
    arithmetic, summed in other orders by XLA and by torch);
  * integer, boolean and index outputs, decoded constants, Resize's
    nearest conventions: exact;
  * `Estimator.from_onnx`'s first fit step: the loss and every
    parameter after the step within 1e-5 x max(1, |JAX|).
"""

import numpy as np
import pytest
import torch

import jax

from analytics_zoo_tpu import init_orca_context
from analytics_zoo_tpu.orca.learn import Estimator as JaxEstimator
from analytics_zoo_tpu.pipeline.onnx import load_onnx as jax_load_onnx
from analytics_zoo_tpu.pipeline.onnx import onnx_loader as jax_loader
from analytics_zoo_tpu.pipeline.onnx import onnx_proto as jax_proto
from analytics_zoo_tpu_torch.convert import onnx_from_flax, onnx_to_flax
from analytics_zoo_tpu_torch.orca.learn import Estimator
from analytics_zoo_tpu_torch.pipeline.onnx import load_onnx, onnx_loader
from analytics_zoo_tpu_torch.pipeline.onnx import onnx_proto
from analytics_zoo_tpu_torch.pipeline.onnx.onnx_proto import encode_model

TOL = 1e-5


def _jax(data, *xs, jit=False):
    module, _ = jax_load_onnx(data)
    variables = module.init(jax.random.PRNGKey(0), *xs)
    apply = jax.jit(module.apply) if jit else module.apply
    out = apply(variables, *xs)
    return out, variables


def _port(data, *xs, variables=None, **kw):
    module, _ = load_onnx(data, device="cpu", **kw)
    if variables is not None:
        module.load_state_dict(onnx_from_flax(module, variables))
    with torch.no_grad():
        out = module(*xs)
    return out, module


def _np(v):
    if isinstance(v, (tuple, list)):
        return [_np(o) for o in v]
    return v.detach().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


def _close(got, want, what=""):
    got, want = _np(got), _np(want)
    if isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{what}[{i}]")
        return
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if want.dtype.kind in "biu" or got.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale,
                               err_msg=what)


def test_op_table_is_jax_s():
    assert sorted(onnx_loader._OPS) == sorted(jax_loader._OPS)
    assert len(onnx_loader._OPS) == 87


def test_codec_matches_jax_bitwise():
    rng = np.random.default_rng(0)
    spec = dict(
        nodes=[("Gemm", ["x", "w", "b"], ["y"],
                {"transB": 1, "alpha": 1.0, "mode": b"ab",
                 "fs": [1.0, 2.5], "strs": [b"p", b"q"], "neg": -3,
                 "t": np.arange(3, dtype=np.float32)}),
               ("Relu", ["y"], ["z"])],
        initializers={"w": rng.normal(size=(3, 4)).astype(np.float32),
                      "b": np.zeros(3, np.float32),
                      "i": np.array([5, -7], np.int64),
                      "h": np.ones((2, 2), np.float16),
                      "u8": np.arange(4, dtype=np.uint8),
                      "bool": np.array([True, False]),
                      "f64": np.array([1.5], np.float64)},
        inputs=[("x", [1, 4])], outputs=["z"])
    data = encode_model(**spec)
    assert data == jax_proto.encode_model(**spec)
    got, want = onnx_proto.decode_model(data), jax_proto.decode_model(data)
    assert (got.ir_version, got.opset, got.producer) == (
        want.ir_version, want.opset, want.producer)
    assert got.graph.inputs == want.graph.inputs
    assert got.graph.outputs == want.graph.outputs
    for g, w in zip(got.graph.nodes, want.graph.nodes):
        assert (g.op_type, g.inputs, g.outputs) == (w.op_type, w.inputs,
                                                    w.outputs)
        assert set(g.attrs) == set(w.attrs)
        for k in g.attrs:
            gv, wv = g.attrs[k].value, w.attrs[k].value
            if isinstance(wv, np.ndarray):
                assert gv.tobytes() == wv.tobytes() and gv.dtype == wv.dtype
            else:
                assert gv == wv, k
    assert list(got.graph.initializers) == list(want.graph.initializers)
    for k, w in want.graph.initializers.items():
        g = got.graph.initializers[k]
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


# -- one case per op family -------------------------------------------------

_UNARY = ["Relu", "Sigmoid", "Tanh", "Exp", "Neg", "Abs", "Floor", "Ceil",
          "Erf", "Softplus", "Softsign", "Identity", "Sign", "Sin", "Cos",
          "Round", "Selu"]


def _fam_unary(rng):
    x = rng.normal(size=(3, 5)).astype(np.float32) * 2
    x[0, 0] = 0.5      # a tie of Round (half to even)
    nodes = [(op, ["x"], [f"o{i}"]) for i, op in enumerate(_UNARY)]
    nodes += [("Abs", ["x"], ["ax"]), ("Add", ["ax", "one"], ["pos"]),
              ("Log", ["pos"], ["log"]), ("Sqrt", ["pos"], ["sqrt"]),
              ("Reciprocal", ["pos"], ["rec"]),
              ("LeakyRelu", ["x"], ["lr"], {"alpha": 0.3}),
              ("Elu", ["x"], ["elu"], {"alpha": 0.7}),
              ("HardSigmoid", ["x"], ["hs"], {"alpha": 0.3, "beta": 0.4}),
              ("Softmax", ["x"], ["sm"], {"axis": 0}),
              ("LogSoftmax", ["x"], ["lsm"]),
              ("Gelu", ["x"], ["ge"]),
              ("Gelu", ["x"], ["get"], {"approximate": b"tanh"})]
    outs = [f"o{i}" for i in range(len(_UNARY))] + [
        "log", "sqrt", "rec", "lr", "elu", "hs", "sm", "lsm", "ge", "get"]
    return nodes, {"one": np.array([1.0], np.float32)}, [x], outs


def _fam_binary(rng):
    a = rng.normal(size=(2, 3, 4)).astype(np.float32)
    b = rng.normal(size=(3, 4)).astype(np.float32)
    c = np.abs(rng.normal(size=(4,))).astype(np.float32) + 0.5
    nodes = [(op, ["a", "b"], [op.lower()]) for op in
             ("Add", "Sub", "Mul", "Div", "Max", "Min", "Equal", "Greater",
              "Less", "GreaterOrEqual", "LessOrEqual")]
    nodes += [("Abs", ["a"], ["aa"]), ("Pow", ["aa", "c"], ["pow"]),
              ("Greater", ["a", "zero"], ["ga"]),
              ("Less", ["b", "zero"], ["lb"]),
              ("And", ["ga", "lb"], ["and"]), ("Or", ["ga", "lb"], ["or"]),
              ("Not", ["ga"], ["not"]),
              ("Where", ["ga", "a", "b"], ["where"]),
              ("PRelu", ["a", "slope"], ["prelu"]),
              ("Clip", ["a"], ["clip_attr"], {"min": -0.5, "max": 0.25}),
              ("Clip", ["a", "lo", "hi"], ["clip_in"]),
              ("Clip", ["a", "", "hi"], ["clip_hi"])]
    outs = [n[2][0] for n in nodes if n[2][0] not in ("aa", "ga", "lb")]
    inits = {"c": c, "zero": np.array(0.0, np.float32),
             "slope": np.array([0.1, 0.2, 0.3, 0.4], np.float32),
             "lo": np.array(-0.3, np.float32),
             "hi": np.array(0.6, np.float32)}
    return nodes, inits, [a, b], outs


def _fam_linear(rng):
    x = rng.normal(size=(4, 6)).astype(np.float32)
    x3 = rng.normal(size=(2, 4, 6)).astype(np.float32)
    w = rng.normal(size=(6, 5)).astype(np.float32)
    wt = rng.normal(size=(5, 6)).astype(np.float32)
    c = rng.normal(size=(5,)).astype(np.float32)
    nodes = [("MatMul", ["x3", "w"], ["mm"]),
             ("Gemm", ["x", "wt", "c"], ["g1"],
              {"transB": 1, "alpha": 0.5, "beta": 2.0}),
             ("Transpose", ["x"], ["xt"]),
             ("Gemm", ["xt", "w"], ["g2"], {"transA": 1}),
             # all-constant Gemm: computed on the host, as JAX's numpy
             ("Gemm", ["k1", "k2"], ["g3"], {"transB": 1})]
    inits = {"w": w, "wt": wt, "c": c,
             "k1": rng.normal(size=(2, 3)).astype(np.float32),
             "k2": rng.normal(size=(4, 3)).astype(np.float32)}
    return nodes, inits, [x, x3], ["mm", "g1", "g2", "g3"]


def _fam_conv_pool(rng):
    x = rng.normal(size=(2, 4, 9, 9)).astype(np.float32)
    x1 = rng.normal(size=(2, 3, 11)).astype(np.float32)
    w = rng.normal(size=(6, 2, 3, 3)).astype(np.float32) * 0.3
    b = rng.normal(size=(6,)).astype(np.float32)
    w1 = rng.normal(size=(5, 3, 4)).astype(np.float32) * 0.3
    nodes = [
        ("Conv", ["x", "w", "b"], ["c_grp"],
         {"pads": [1, 0, 2, 1], "strides": [2, 1], "group": 2,
          "dilations": [1, 2]}),
        ("Conv", ["x", "w"], ["c_up"],
         {"auto_pad": b"SAME_UPPER", "strides": [2, 2], "group": 2}),
        ("Conv", ["x", "w"], ["c_lo"],
         {"auto_pad": b"SAME_LOWER", "strides": [2, 2], "group": 2}),
        ("Conv", ["x1", "w1"], ["c_1d"], {"pads": [2, 1]}),
        ("MaxPool", ["x"], ["mp"],
         {"kernel_shape": [3, 3], "strides": [2, 2],
          "pads": [1, 1, 0, 1]}),
        ("AveragePool", ["x"], ["ap"],
         {"kernel_shape": [3, 2], "strides": [2, 2],
          "pads": [1, 0, 1, 1]}),
        ("AveragePool", ["x"], ["ap_in"],
         {"kernel_shape": [3, 3], "strides": [2, 2],
          "pads": [1, 1, 1, 1], "count_include_pad": 1}),
        ("MaxPool", ["x1"], ["mp_1d"], {"kernel_shape": [3]}),
        ("AveragePool", ["x1"], ["ap_1d"],
         {"kernel_shape": [2], "strides": [1], "pads": [1, 0]}),
        ("GlobalAveragePool", ["x"], ["gap"]),
        ("GlobalMaxPool", ["x"], ["gmp"])]
    outs = [n[2][0] for n in nodes]
    return nodes, {"w": w, "b": b, "w1": w1}, [x, x1], outs


def _fam_norm(rng):
    x = rng.normal(size=(2, 5, 4, 3)).astype(np.float32)
    ch = {k: rng.normal(size=(5,)).astype(np.float32)
          for k in ("scale", "bias", "mean")}
    ch["var"] = np.abs(rng.normal(size=(5,))).astype(np.float32) + 0.5
    nodes = [("BatchNormalization", ["x", "scale", "bias", "mean", "var"],
              ["bn"], {"epsilon": 1e-3}),
             ("InstanceNormalization", ["x", "scale", "bias"], ["inorm"]),
             ("LRN", ["x"], ["lrn"],
              {"size": 3, "alpha": 0.01, "beta": 0.5, "bias": 2.0}),
             ("LRN", ["x"], ["lrn4"], {"size": 4}),
             ("Dropout", ["x", "ratio"], ["drop"])]
    ch["ratio"] = np.array(0.5, np.float32)
    return nodes, ch, [x], ["bn", "inorm", "lrn", "lrn4", "drop"]


def _fam_shape(rng):
    x = rng.normal(size=(2, 3, 4)).astype(np.float32)
    nodes = [
        ("Reshape", ["x", "shp"], ["rs"]),
        ("Flatten", ["x"], ["fl0"], {"axis": 0}),
        ("Flatten", ["x"], ["fl2"], {"axis": 2}),
        ("Transpose", ["x"], ["tr"], {"perm": [2, 0, 1]}),
        ("Transpose", ["x"], ["trr"]),
        ("Unsqueeze", ["x", "uax"], ["us"]),
        ("Squeeze", ["us", "uax"], ["sq_in"]),
        ("Unsqueeze", ["x"], ["us_attr"], {"axes": [0, -1]}),
        ("Squeeze", ["us_attr"], ["sq_all"]),
        ("Concat", ["x", "x"], ["cat"], {"axis": -2}),
        ("Split", ["x"], ["sp0", "sp1"], {"axis": 2}),
        ("Split", ["x", "sizes"], ["sz0", "sz1"], {"axis": 1}),
        ("Slice", ["x", "st", "en", "sax", "sst"], ["sl"]),
        ("Slice", ["x", "st0", "big"], ["sl_big"]),
        ("Gather", ["x", "gidx"], ["ga"], {"axis": 2}),
        ("Gather", ["x", "gi0"], ["ga0"]),
        ("Pad", ["x", "pads", "pval"], ["pad"]),
        ("Pad", ["x", "rpads"], ["pad_r"], {"mode": b"reflect"}),
        ("Pad", ["x", "rpads"], ["pad_e"], {"mode": b"edge"}),
        ("Expand", ["col", "eshape"], ["ex"]),
        ("Shape", ["x"], ["shape"]),
        ("Cast", ["x"], ["cast_i"], {"to": 6}),
        ("Cast", ["shape"], ["cast_f"], {"to": 1}),
        ("Tile", ["x", "reps"], ["tile"]),
        ("ConstantOfShape", ["cshape"], ["cos"],
         {"value": np.array([1.5], np.float32)}),
        ("ConstantOfShape", ["cshape"], ["cos0"]),
        ("Range", ["r0", "r1", "r2"], ["rng_f"]),
        ("Range", ["i0", "i1", "i2"], ["rng_i"]),
        ("Constant", [], ["k"], {"value": np.array([[2.0, -1.0]],
                                                   np.float32)}),
        ("Sum", ["x", "x", "x"], ["sum3"]),
        ("Mean", ["x", "k3"], ["mean2"]),
        ("Identity", ["shp"], ["idc"]),
        ("Reshape", ["x", "idc"], ["rs_id"]),
        ("Cast", ["fshape"], ["ishape"], {"to": 7}),
        ("Reshape", ["x", "ishape"], ["rs_cast"])]
    inits = {"shp": np.array([0, -1, 2], np.int64),
             "uax": np.array([1], np.int64),
             "sizes": np.array([1, 2], np.int64),
             "st": np.array([3, -1], np.int64),
             "en": np.array([0, -4], np.int64),
             "sax": np.array([2, 1], np.int64),
             "sst": np.array([-2, -1], np.int64),
             "st0": np.array([1], np.int64),
             "big": np.array([2 ** 63 - 1], np.int64),
             "gidx": np.array([[3, -1], [0, 2]], np.int64),
             "gi0": np.array([1], np.int64),
             "pads": np.array([0, 1, -1, 1, 0, 2], np.int64),
             "pval": np.array(-2.0, np.float32),
             "rpads": np.array([0, 2, 1, 0, 1, 2], np.int64),
             "col": rng.normal(size=(3, 1)).astype(np.float32),
             "eshape": np.array([2, 3, 4], np.int64),
             "reps": np.array([1, 2, 1], np.int64),
             "cshape": np.array([2, 3], np.int64),
             "r0": np.array(0.5, np.float32),
             "r1": np.array(2.0, np.float32),
             "r2": np.array(0.25, np.float32),
             "i0": np.array(7, np.int64), "i1": np.array(-2, np.int64),
             "i2": np.array(-3, np.int64),
             "k3": np.full((1, 1, 4), 3.0, np.float32),
             "fshape": np.array([4.0, 6.0], np.float32)}
    outs = ["rs", "fl0", "fl2", "tr", "trr", "us", "sq_in", "us_attr",
            "sq_all", "cat", "sp0", "sp1", "sz0", "sz1", "sl", "sl_big",
            "ga", "ga0", "pad", "pad_r", "pad_e", "ex", "shape", "cast_i",
            "cast_f", "tile", "cos", "cos0", "rng_f", "rng_i", "k",
            "sum3", "mean2", "rs_id", "rs_cast"]
    return nodes, inits, [x], outs


def _fam_reduce(rng):
    x = rng.normal(size=(2, 3, 4)).astype(np.float32)
    nodes = []
    outs = []
    for op in ("ReduceMean", "ReduceSum", "ReduceMax", "ReduceMin",
               "ReduceProd", "ReduceL1", "ReduceL2", "ReduceLogSumExp"):
        low = op[6:].lower()
        nodes += [(op, ["x"], [f"{low}_a"], {"axes": [1, -1]}),
                  (op, ["x"], [f"{low}_k"], {"axes": [0], "keepdims": 0}),
                  (op, ["x"], [f"{low}_all"]),
                  (op, ["x", "ax"], [f"{low}_in"], {"keepdims": 0})]
        outs += [f"{low}_a", f"{low}_k", f"{low}_all", f"{low}_in"]
    nodes += [("ArgMax", ["x"], ["amax"], {"axis": 1}),
              ("ArgMin", ["x"], ["amin"], {"axis": -1, "keepdims": 0})]
    return nodes, {"ax": np.array([2], np.int64)}, [x], outs + [
        "amax", "amin"]


def _fam_resize(rng):
    x = rng.normal(size=(1, 2, 5, 6)).astype(np.float32)
    nodes, outs = [], []
    for ct in (b"asymmetric", b"half_pixel", b"pytorch_half_pixel",
               b"align_corners"):
        for nm in (b"floor", b"ceil", b"round_prefer_floor",
                   b"round_prefer_ceil"):
            o = f"n_{ct.decode()}_{nm.decode()}"
            nodes.append(("Resize", ["x", "", "", "sz_mixed"], [o],
                          {"mode": b"nearest",
                           "coordinate_transformation_mode": ct,
                           "nearest_mode": nm}))
            outs.append(o)
    nodes += [
        ("Resize", ["x", "", "up"], ["lin_up"], {"mode": b"linear"}),
        ("Resize", ["x", "", "", "sz_down"], ["lin_down"],
         {"mode": b"linear"}),
        ("Resize", ["x", "", "", "sz_down"], ["lin_aa"],
         {"mode": b"linear", "antialias": 1,
          "coordinate_transformation_mode": b"pytorch_half_pixel"}),
        ("Resize", ["x", "up"], ["opset10"], {"mode": b"nearest"}),
        ("Resize", ["x", "", "", "sz_axes"], ["axes"],
         {"mode": b"linear", "axes": [3]})]
    inits = {"sz_mixed": np.array([1, 2, 8, 4], np.int64),
             "up": np.array([1, 1, 1.5, 2], np.float32),
             "sz_down": np.array([1, 2, 3, 4], np.int64),
             "sz_axes": np.array([9], np.int64)}
    return nodes, inits, [x], outs + ["lin_up", "lin_down", "lin_aa",
                                      "opset10", "axes"]


def _onnx_weights(rng, gates, d, hid, inp):
    return ((rng.normal(size=(d, gates * hid, inp)) * 0.4).astype(np.float32),
            (rng.normal(size=(d, gates * hid, hid)) * 0.4).astype(np.float32),
            (rng.normal(size=(d, 2 * gates * hid)) * 0.4).astype(np.float32))


def _fam_rnn(rng):
    seq, batch, inp, hid = 4, 3, 5, 4
    x = rng.normal(size=(seq, batch, inp)).astype(np.float32)
    nodes, inits, outs = [], {}, []
    for direction, d in ((b"forward", 1), (b"reverse", 1),
                         (b"bidirectional", 2)):
        tag = direction.decode()[:3]
        w, r, b = _onnx_weights(rng, 4, d, hid, inp)
        h0 = rng.normal(size=(d, batch, hid)).astype(np.float32)
        c0 = rng.normal(size=(d, batch, hid)).astype(np.float32)
        inits.update({f"lw_{tag}": w, f"lr_{tag}": r, f"lb_{tag}": b,
                      f"lh_{tag}": h0, f"lc_{tag}": c0})
        ys = [f"ly_{tag}", f"lyh_{tag}", f"lyc_{tag}"]
        nodes.append(("LSTM", ["x", f"lw_{tag}", f"lr_{tag}", f"lb_{tag}",
                               "", f"lh_{tag}", f"lc_{tag}"], ys,
                      {"hidden_size": hid, "direction": direction}))
        outs += ys
        for lbr in (0, 1):
            w, r, b = _onnx_weights(rng, 3, d, hid, inp)
            key = f"{tag}{lbr}"
            inits.update({f"gw_{key}": w, f"gr_{key}": r, f"gb_{key}": b})
            ins = ["x", f"gw_{key}", f"gr_{key}", f"gb_{key}"]
            if lbr:
                inits[f"gh_{key}"] = rng.normal(
                    size=(d, batch, hid)).astype(np.float32)
                ins += ["", f"gh_{key}"]
            ys = [f"gy_{key}", f"gyh_{key}"]
            nodes.append(("GRU", ins, ys,
                          {"hidden_size": hid, "direction": direction,
                           "linear_before_reset": lbr}))
            outs += ys
    # no bias, no initial state
    w, r, _ = _onnx_weights(rng, 4, 1, hid, inp)
    inits.update({"lw_nb": w, "lr_nb": r})
    nodes.append(("LSTM", ["x", "lw_nb", "lr_nb"], ["ly_nb"],
                  {"hidden_size": hid}))
    return nodes, inits, [x], outs + ["ly_nb"]


FAMILIES = {"unary": _fam_unary, "binary_logic": _fam_binary,
            "linear": _fam_linear, "conv_pool": _fam_conv_pool,
            "normalization": _fam_norm, "shape": _fam_shape,
            "reductions": _fam_reduce, "resize": _fam_resize,
            "recurrent": _fam_rnn}


def test_families_cover_the_op_table():
    rng = np.random.default_rng(0)
    used = {spec[0] for fam in FAMILIES.values() for spec in fam(rng)[0]}
    assert used == set(jax_loader._OPS)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_op_family_matches_jax(family):
    rng = np.random.default_rng(sorted(FAMILIES).index(family))
    nodes, inits, xs, outs = FAMILIES[family](rng)
    feeds = {"binary_logic": ["a", "b"], "linear": ["x", "x3"],
             "conv_pool": ["x", "x1"]}.get(family, ["x"])
    data = encode_model(
        nodes=nodes, initializers=inits,
        inputs=[(n, list(x.shape)) for n, x in zip(feeds, xs)],
        outputs=outs)
    want, variables = _jax(data, *xs)
    got, module = _port(data, *xs, variables=variables)
    for name, g, w in zip(outs, got, want):
        _close(g, w, f"{family}: {name}")


def test_weights_are_parameters_and_stats_buffers():
    """Weight-slot initializers become parameters under JAX's safe
    names, BatchNorm statistics buffers, the rest host constants; each
    constant a compute op reads is copied to the device once."""
    rng = np.random.default_rng(1)
    data = encode_model(
        nodes=[("Conv", ["x", "conv.w", "conv/b"], ["c"],
                {"pads": [1, 1, 1, 1]}),
               ("BatchNormalization", ["c", "s", "b", "m", "v"], ["bn"]),
               ("Relu", ["bn"], ["r"]),
               ("MaxPool", ["r"], ["p"], {"kernel_shape": [2, 2]}),
               ("Flatten", ["p"], ["f"]),
               ("MatMul", ["f", "fc"], ["mm"]),
               ("Add", ["mm", "fc_b"], ["y"])],
        initializers={"conv.w": rng.normal(size=(4, 3, 3, 3)).astype(
                          np.float32) * 0.2,
                      "conv/b": np.zeros(4, np.float32),
                      "s": np.ones(4, np.float32),
                      "b": np.zeros(4, np.float32),
                      "m": rng.normal(size=4).astype(np.float32),
                      "v": np.ones(4, np.float32) * 2,
                      "fc": rng.normal(size=(64, 2)).astype(np.float32),
                      "fc_b": np.ones(2, np.float32)},
        inputs=[("x", [1, 3, 8, 8])], outputs=["y"])
    x = rng.normal(size=(2, 3, 8, 8)).astype(np.float32)
    want, variables = _jax(data, x)
    assert set(variables["params"]) == {"conv_w", "conv_b", "s", "b", "fc"}
    assert set(variables["batch_stats"]) == {"m", "v"}
    got, module = _port(data, x, variables=variables)
    _close(got, want)
    assert {n for n, _ in module.named_parameters()} == set(
        variables["params"])
    assert set(module.state_dict()) == {"conv_w", "conv_b", "s", "b", "fc",
                                        "m", "v"}
    back = onnx_to_flax(module)
    for coll in ("params", "batch_stats"):
        assert set(back[coll]) == set(variables[coll])
        for k, v in variables[coll].items():
            np.testing.assert_array_equal(back[coll][k], np.asarray(v))
    # fc_b is a host constant, copied once and reused
    before = dict(module.named_buffers())
    with torch.no_grad():
        module(x)
    after = dict(module.named_buffers())
    assert before.keys() == after.keys()
    assert all(before[k] is after[k] for k in before)


def test_resize_nearest_conventions_exact():
    """JAX's pinned values: half_pixel ties part round_prefer_floor from
    round_prefer_ceil; align_corners exact."""
    x = np.arange(4, dtype=np.float32)[None]   # [1, 4]

    def run(ct, nm, sizes):
        data = encode_model(
            nodes=[("Resize", ["x", "", "", "sizes"], ["y"],
                    {"mode": b"nearest",
                     "coordinate_transformation_mode": ct,
                     "nearest_mode": nm})],
            initializers={"sizes": np.array(sizes, np.int64)},
            inputs=[("x", [1, 4])], outputs=["y"])
        got = _np(_port(data, x)[0])[0]
        np.testing.assert_array_equal(got, np.asarray(_jax(data, x)[0])[0])
        return got

    np.testing.assert_array_equal(
        run(b"half_pixel", b"round_prefer_floor", [1, 2]), [0.0, 2.0])
    np.testing.assert_array_equal(
        run(b"half_pixel", b"round_prefer_ceil", [1, 2]), [1.0, 3.0])
    np.testing.assert_array_equal(
        run(b"align_corners", b"round_prefer_floor", [1, 3]),
        [0.0, 1.0, 3.0])
    np.testing.assert_array_equal(
        run(b"align_corners", b"ceil", [1, 3]), [0.0, 2.0, 3.0])


def test_pad_negative_crops_and_axes():
    x = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    data = encode_model(
        nodes=[("Pad", ["x", "pads"], ["y"])],
        initializers={"pads": np.array([0, 1, -1, 0, -1, 1], np.int64)},
        inputs=[("x", [2, 3, 4])], outputs=["y"])
    got = _np(_port(data, x)[0])
    np.testing.assert_array_equal(
        got, np.pad(x, [(0, 0), (1, 0), (0, 1)])[:, :-1, 1:])
    np.testing.assert_array_equal(got, np.asarray(_jax(data, x)[0]))
    data = encode_model(
        nodes=[("Pad", ["x", "pads", "", "axes"], ["y"])],
        initializers={"pads": np.array([2, 2], np.int64),
                      "axes": np.array([2], np.int64)},
        inputs=[("x", [2, 3, 4])], outputs=["y"])
    got = _np(_port(data, x)[0])
    assert got.shape == (2, 3, 8)
    np.testing.assert_array_equal(got, np.asarray(_jax(data, x)[0]))


def test_maxpool_binds_only_its_first_output():
    """A single-array result binds the node's first output only: a
    consumer of MaxPool's optional Indices raises JAX's ValueError."""
    x = np.ones((1, 1, 4, 4), np.float32)
    data = encode_model(
        nodes=[("MaxPool", ["x"], ["y", "idx"], {"kernel_shape": [2, 2]}),
               ("Cast", ["idx"], ["z"], {"to": 1})],
        initializers={}, inputs=[("x", [1, 1, 4, 4])], outputs=["z"])
    with pytest.raises(ValueError, match="never produced"):
        _jax(data, x)
    with pytest.raises(ValueError, match="never produced"):
        _port(data, x)


# -- refusals ---------------------------------------------------------------

def _refusal(kind):
    x = np.ones((2, 3, 4), np.float32)
    if kind == "unknown_op":
        return encode_model(nodes=[("NonMaxSuppression", ["x"], ["y"])],
                            initializers={}, inputs=[("x", [2, 3, 4])],
                            outputs=["y"]), (x,), NotImplementedError, \
            "NonMaxSuppression"
    if kind == "missing_tensor":
        return encode_model(nodes=[("Add", ["x", "nowhere"], ["y"])],
                            initializers={}, inputs=[("x", [2, 3, 4])],
                            outputs=["y"]), (x,), ValueError, \
            "never produced"
    if kind == "feed_count":
        return encode_model(nodes=[("Add", ["x", "z"], ["y"])],
                            initializers={},
                            inputs=[("x", [2, 3, 4]), ("z", [2, 3, 4])],
                            outputs=["y"]), (x,), ValueError, \
            "expects 2 inputs"
    acts = {"rnn_activations": {"activations": [b"HardSigmoid", b"Tanh",
                                                b"Tanh"]},
            "rnn_clip": {"clip": 3.0}}.get(kind, {})
    hid = 3
    ins = ["x", "W", "R"] + (["", "lens"] if kind == "rnn_seq_lens" else [])
    data = encode_model(
        nodes=[("LSTM", ins, ["y", "y_h", "y_c"],
                {"hidden_size": hid, **acts})],
        initializers={"W": np.zeros((1, 4 * hid, 4), np.float32),
                      "R": np.zeros((1, 4 * hid, hid), np.float32),
                      "lens": np.full(3, 2, np.int32)},
        inputs=[("x", [2, 3, 4])], outputs=["y", "y_h", "y_c"])
    return data, (x,), NotImplementedError, {
        "rnn_activations": "activations", "rnn_clip": "clip",
        "rnn_seq_lens": "sequence_lens"}[kind]


@pytest.mark.parametrize("kind", ["unknown_op", "missing_tensor",
                                  "feed_count", "rnn_activations",
                                  "rnn_clip", "rnn_seq_lens"])
def test_refusals_match_jax(kind):
    data, xs, exc, match = _refusal(kind)
    with pytest.raises(exc, match=match):
        _jax(data, *xs)
    with pytest.raises(exc, match=match):
        _port(data, *xs)


def _data_dependent(kind):
    """Graphs whose Reshape target is computed: from the input's values
    (`values`), from its shape (`shape_chain`: Shape -> Gather ->
    Concat), or from a constant through a jnp op (`const_add`); and one
    whose target stays a host constant through Cast (`cast`)."""
    inits = {"i0": np.array([0], np.int64), "m1": np.array([-1], np.int64),
             "c": np.array([1, 6], np.int64),
             "f": np.array([-1.0, 12.0], np.float32)}
    chains = {
        "values": [("ReduceMax", ["x"], ["mx"], {"keepdims": 0}),
                   ("Cast", ["mx"], ["mi"], {"to": 7}),
                   ("Unsqueeze", ["mi", "i0"], ["mu"]),
                   ("Concat", ["mu", "m1"], ["shp"], {"axis": 0})],
        "shape_chain": [("Shape", ["x"], ["s"]),
                        ("Gather", ["s", "i0"], ["b"], {"axis": 0}),
                        ("Concat", ["b", "m1"], ["shp"], {"axis": 0})],
        "const_add": [("Add", ["c", "c"], ["shp"])],
        "cast": [("Cast", ["f"], ["shp"], {"to": 7})]}
    return encode_model(
        nodes=chains[kind] + [("Reshape", ["x", "shp"], ["y"])],
        initializers=inits, inputs=[("x", [2, 3, 4])], outputs=["y"])


@pytest.mark.parametrize("kind", ["values", "shape_chain", "const_add",
                                  "cast"])
def test_shape_like_inputs_as_jax_eager_and_jitted(kind):
    """Eagerly both packages read any shape-like value; under JAX's jit
    and the port's `static_shapes` (what each Estimator runs) only a
    host constant passes, else NotImplementedError."""
    x = np.zeros((2, 3, 4), np.float32)
    x[0, 0, 0] = 2.0     # "values": max 2 -> shape [2, -1]
    data = _data_dependent(kind)
    want, _ = _jax(data, x)
    got, _ = _port(data, x)
    _close(got, want)
    if kind == "cast":
        _close(_port(data, x, static_shapes=True)[0],
               _jax(data, x, jit=True)[0])
        return
    with pytest.raises(NotImplementedError, match="data-dependent"):
        _jax(data, x, jit=True)
    with pytest.raises(NotImplementedError, match="data-dependent"):
        _port(data, x, static_shapes=True)


@pytest.mark.parametrize("kind", ["shape_chain", "cast"])
def test_estimators_predict_shape_chains_as_jax(kind):
    """Through each package's Estimator: JAX's jitted predict step and
    the port's `from_onnx` module agree (both raise on the Shape chain,
    both predict through the Cast one)."""
    init_orca_context(cluster_mode="local")
    data = _data_dependent(kind)
    x = np.random.default_rng(3).normal(size=(4, 3, 4)).astype(np.float32)
    jest = JaxEstimator.from_onnx(data, loss="mse", optimizer="sgd")
    est = Estimator.from_onnx(data, loss="mse", optimizer="sgd",
                              device="cpu")
    if kind == "shape_chain":
        with pytest.raises(NotImplementedError, match="data-dependent"):
            jest.predict({"x": x}, batch_size=4)
        with pytest.raises(NotImplementedError, match="data-dependent"):
            est.predict({"x": x}, batch_size=4)
        return
    _close(est.predict({"x": x}, batch_size=4),
           np.asarray(jest.predict({"x": x}, batch_size=4)))


def _mlp_bn(rng):
    """Gemm -> BatchNormalization (over features) -> Relu -> Gemm."""
    return encode_model(
        nodes=[("Gemm", ["x", "w1", "b1"], ["h"], {"transB": 1}),
               ("Unsqueeze", ["h", "ax"], ["h3"]),
               ("BatchNormalization", ["h3", "g", "be", "m", "v"], ["hb"]),
               ("Squeeze", ["hb", "ax"], ["hs"]),
               ("Relu", ["hs"], ["hr"]),
               ("Gemm", ["hr", "w2", "b2"], ["y"], {"transB": 1})],
        initializers={
            "w1": (rng.normal(size=(16, 6)) * 0.5).astype(np.float32),
            "b1": (rng.normal(size=16) * 0.1).astype(np.float32),
            "ax": np.array([2], np.int64),
            "g": (1 + 0.1 * rng.normal(size=16)).astype(np.float32),
            "be": (0.1 * rng.normal(size=16)).astype(np.float32),
            "m": (0.1 * rng.normal(size=16)).astype(np.float32),
            "v": (1 + 0.1 * np.abs(rng.normal(size=16))).astype(np.float32),
            "w2": (rng.normal(size=(3, 16)) * 0.5).astype(np.float32),
            "b2": np.zeros(3, np.float32)},
        inputs=[("x", [1, 6])], outputs=["y"])


def test_from_onnx_first_fit_step_matches_jax():
    """One Adam step of `Estimator.from_onnx` on both packages, the
    port's weights carried from the JAX module's variables (what the JAX
    Estimator starts from) by `onnx_from_flax`: the loss and every
    parameter after the step; the BatchNorm statistics unchanged."""
    init_orca_context(cluster_mode="local")
    rng = np.random.default_rng(7)
    data = _mlp_bn(rng)
    x = rng.normal(size=(16, 6)).astype(np.float32)
    y = rng.integers(0, 3, 16).astype(np.int32)
    kw = dict(loss="sparse_categorical_crossentropy", optimizer="adam",
              learning_rate=1e-2)
    jest = JaxEstimator.from_onnx(data, **kw)
    jest.fit({"x": x, "y": y}, epochs=1, batch_size=16, shuffle=False)
    _, start = _jax(data, x[:1])
    est = Estimator.from_onnx(data, device="cpu", **kw)
    est.get_model().load_state_dict(onnx_from_flax(est.get_model(), start))
    est.fit({"x": x, "y": y}, epochs=1, batch_size=16, shuffle=False)
    assert est.engine.host_step == 1
    _close(np.float32(est.train_summary[-1]["loss"]),
           np.float32(jest.train_summary[-1]["loss"]))
    got = onnx_to_flax(est.get_model())
    want = jax.device_get(jest.get_model())
    assert set(got["params"]) == set(want)
    for k in want:
        _close(got["params"][k], np.asarray(want[k]), k)
    for k, v in start["batch_stats"].items():
        np.testing.assert_array_equal(got["batch_stats"][k], np.asarray(v))


def test_onnx_from_flax_refuses_unknown_and_missing():
    data = _mlp_bn(np.random.default_rng(0))
    module, model = load_onnx(data, device="cpu")
    good = onnx_to_flax(module)
    with pytest.raises(ValueError, match="unknown"):
        onnx_from_flax(module, {"params": dict(good["params"], extra=0.0),
                                "batch_stats": good["batch_stats"]})
    with pytest.raises(ValueError, match="missing"):
        onnx_from_flax(module, {"params": good["params"]})
    # copies, never views
    sd = onnx_from_flax(module, good)
    good["params"]["w1"][...] = 0
    assert float(sd["w1"].abs().sum()) > 0


def test_entry_points_need_a_card_without_device(monkeypatch):
    data = _mlp_bn(np.random.default_rng(0))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_onnx(data)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Estimator.from_onnx(data, loss="mse")
