"""The port's `Net` loaders, `GraphNet` surgery and the `tfpark`
namespace (analytics_zoo_tpu_torch/pipeline/net.py, tfpark/) held
against the JAX package's on the CPU: the same ONNX / GraphDef /
caffemodel bytes and `torch.save` files, the same seeded inputs.

Tolerance: f32 outputs within 1e-5 x max(1, |JAX|) per element."""

import numpy as np
import pytest
import torch

import jax

from analytics_zoo_tpu import init_orca_context
from analytics_zoo_tpu import tfpark as jax_tfpark
from analytics_zoo_tpu.pipeline.net import GraphNet as JaxGraphNet
from analytics_zoo_tpu.pipeline.net import Net as JaxNet
from analytics_zoo_tpu_torch import tfpark
from analytics_zoo_tpu_torch.models import bert
from analytics_zoo_tpu_torch.orca.learn.gan import GANEstimator
from analytics_zoo_tpu_torch.pipeline import caffe_graph, tf_graph
from analytics_zoo_tpu_torch.pipeline.net import GraphNet, Net
from analytics_zoo_tpu_torch.pipeline.onnx import OnnxModule
from analytics_zoo_tpu_torch.pipeline.onnx.onnx_proto import encode_model
from analytics_zoo_tpu_torch.serving.inference_model import InferenceModel

TOL = 1e-5


def _close(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale)


def _mlp():
    rng = np.random.default_rng(0)
    data = encode_model(
        nodes=[("Gemm", ["x", "w1"], ["h"], {"transB": 1}),
               ("Relu", ["h"], ["hr"]),
               ("Gemm", ["hr", "w2"], ["y"], {"transB": 1})],
        initializers={"w1": rng.normal(size=(8, 4)).astype(np.float32),
                      "w2": rng.normal(size=(2, 8)).astype(np.float32)},
        inputs=[("x", [1, 4])], outputs=["y"])
    return data, rng.normal(size=(3, 4)).astype(np.float32)


def test_load_onnx_and_graph_surgery_match_jax():
    init_orca_context(cluster_mode="local")
    data, x = _mlp()
    module, model = Net.load_onnx(data, device="cpu")
    jmodule, jmodel = JaxNet.load_onnx(data)
    assert isinstance(module, OnnxModule)
    with torch.no_grad():
        _close(module(x), jmodule.apply(jmodule.init(
            jax.random.PRNGKey(0), x), x))

    feat = GraphNet(model).new_graph(["hr"])
    jfeat = JaxGraphNet(jmodel).new_graph(["hr"])
    assert [n.op_type for n in feat.model.graph.nodes] == \
        [n.op_type for n in jfeat.model.graph.nodes] == ["Gemm", "Relu"]
    assert set(feat.model.graph.initializers) == \
        set(jfeat.model.graph.initializers) == {"w1"}
    sub = feat.to_module(device="cpu")
    jsub = jfeat.to_module()
    want = jsub.apply(jsub.init(jax.random.PRNGKey(0), x), x)
    with torch.no_grad():
        _close(sub(x), want)
    assert [n for n, _ in sub.named_parameters()] == ["w1"]

    # frozen: every initializer a constant, no nn.Parameter
    frozen = GraphNet(model).new_graph(["hr"]).freeze().to_module(
        device="cpu")
    assert list(frozen.parameters()) == []
    _close(frozen(x), JaxGraphNet(jmodel).new_graph(["hr"]).freeze()
           .to_module()(x))
    assert not hasattr(Net, "load_bigdl")
    with pytest.raises(ValueError, match="unknown tensor"):
        GraphNet(model).new_graph(["nowhere"])


def _torch_net():
    torch.manual_seed(0)
    m = torch.nn.Sequential(torch.nn.Linear(4, 8), torch.nn.BatchNorm1d(8),
                            torch.nn.ReLU(), torch.nn.Linear(8, 2))
    with torch.no_grad():
        m[1].running_mean.uniform_(-0.5, 0.5)
        m[1].running_var.uniform_(0.5, 1.5)
    return m.eval()


@pytest.mark.parametrize("source", ["module", "file"])
def test_load_torch_returns_jax_s_triple(source, tmp_path):
    """(module on the device, parameters, buffers), from a module or a
    `torch.save`d module file that JAX's `load_torch` loads too; the
    outputs agree with JAX's imported module on the same weights."""
    init_orca_context(cluster_mode="local")
    m = _torch_net()
    arg = m
    if source == "file":
        arg = str(tmp_path / "net.pt")
        torch.save(m, arg)
    module, params, buffers = Net.load_torch(arg, device="cpu")
    assert set(params) == {n for n, _ in m.named_parameters()}
    assert set(buffers) == {n for n, _ in m.named_buffers()}
    assert all(p.device.type == "cpu" for p in params.values())
    x = np.random.default_rng(1).normal(size=(5, 4)).astype(np.float32)
    jmodule, jparams, jstate = JaxNet.load_torch(arg)
    variables = jmodule.init(jax.random.PRNGKey(0), x)
    want = jmodule.apply(variables, x)
    with torch.no_grad():
        _close(module.eval()(torch.from_numpy(x)), want)


def test_caffe_and_tf_loaders_return_the_port_s_nets():
    from tests.test_caffe_import import _params, layer, netparam
    from tests.tf_graphdef_builder import const, graphdef, node, placeholder
    w = np.eye(2, dtype=np.float32) * 3.0
    model = netparam([layer("fc", "InnerProduct", ["data"], ["fc"], [w],
                            _params(117, {1: 2, 2: 0}))], inputs=["data"])
    x = np.ones((1, 2), np.float32)
    net = Net.load_caffe(None, model, device="cpu")
    assert isinstance(net, caffe_graph.CaffeNet)
    _close(net.predict(x), JaxNet.load_caffe(None, model).predict(x))
    gd = graphdef([placeholder("x"), const("w", w),
                   node("y", "MatMul", ["x", "w"])])
    tnet = Net.load_tf(gd, device="cpu")
    assert isinstance(tnet, tf_graph.TFNet)
    _close(tnet.predict(x), JaxNet.load_tf(gd).predict(x))


def test_tfpark_reexports_the_port_s_classes():
    assert tfpark.TFNet is tf_graph.TFNet
    assert tfpark.load_tf_graph is tf_graph.load_tf_graph
    assert tfpark.TFPredictor is InferenceModel
    assert tfpark.GANEstimator is GANEstimator
    for name in ("BERTClassifier", "BERTNER", "BERTSQuAD"):
        assert getattr(tfpark, name) is getattr(bert, name)
    exported = {n for n in dir(jax_tfpark) if not n.startswith("_")}
    assert exported <= set(dir(tfpark))


@pytest.mark.parametrize("name", sorted(jax_tfpark._REPLACED))
def test_tfpark_replaced_names_raise_as_jax(name):
    assert set(tfpark._REPLACED) == set(jax_tfpark._REPLACED)
    with pytest.raises(AttributeError,
                       match=rf"tfpark\.{name} is TF1-runtime machinery"):
        getattr(jax_tfpark, name)
    with pytest.raises(AttributeError, match=(
            rf"tfpark\.{name} is TF1-runtime machinery.*"
            r"analytics_zoo_tpu_torch\.orca\.")):
        getattr(tfpark, name)


def test_tfpark_unknown_name():
    with pytest.raises(AttributeError):
        tfpark.NoSuchThing


def test_loaders_need_a_card_without_device(monkeypatch):
    data, _ = _mlp()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for load in (lambda: Net.load_onnx(data),
                 lambda: Net.load_torch(_torch_net()),
                 lambda: GraphNet(Net.load_onnx(data, device="cpu")[1])
                 .freeze().to_module()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            load()


# -- chip_smoke.py phase 20's fixture writers, rehearsed at toy widths ------

#: CaffeNet's layers at toy widths
TOY_CAFFENET = dict(conv1=8, conv2=16, conv3=24, conv4=24, conv5=16, fc6=32,
                    fc7=32, fc8=10)


@pytest.mark.parametrize("fixture", ["mobilenet_v1_graphdef",
                                     "caffenet_model", "bert_onnx"])
def test_chip_smoke_writers_decode_as_jax(fixture):
    """Phase 20 writes its fixtures with the writers in chip_smoke.py:
    at toy widths, JAX's decoders and the port's read the same graph
    and weights (bitwise), and the imported nets agree with JAX's (and
    the ONNX BERT with the port's native BERTClassifier) on the CPU."""
    import chip_smoke
    rng = np.random.default_rng(0)
    if fixture == "mobilenet_v1_graphdef":
        from analytics_zoo_tpu.pipeline import tf_graph as jax_tf
        gd = chip_smoke.mobilenet_v1_graphdef(rng, 0.125, 64, 11)
        got, want = tf_graph.parse_graphdef(gd), jax_tf.parse_graphdef(gd)
        assert [(n["name"], n["op"], n["inputs"]) for n in got] == \
            [(n["name"], n["op"], n["inputs"]) for n in want]
        ops = {n["op"] for n in got}
        assert ops == {"Placeholder", "Const", "Conv2D",
                       "DepthwiseConv2dNative", "FusedBatchNormV3", "Relu6",
                       "AvgPool", "Squeeze", "MatMul", "BiasAdd", "Softmax"}
        for g, w in zip(got, want):
            for key, attr in w["attrs"].items():
                if "tensor" in attr:
                    assert g["attrs"][key]["tensor"].tobytes() == \
                        attr["tensor"].tobytes()
                else:
                    assert g["attrs"][key] == attr
        x = rng.standard_normal((2, 64, 64, 3), dtype=np.float32)
        outs = ["logits", "predictions"]
        for g, w in zip(Net.load_tf(gd, outputs=outs, device="cpu")
                        .predict(x), JaxNet.load_tf(gd, outputs=outs)
                        .predict(x)):
            _close(g, w)
        return
    if fixture == "caffenet_model":
        from analytics_zoo_tpu.pipeline import caffe_graph as jax_caffe
        data = chip_smoke.caffenet_model(rng, TOY_CAFFENET, 67)
        got = caffe_graph.parse_caffemodel(data)
        want = jax_caffe.parse_caffemodel(data)
        assert got["inputs"] == want["inputs"] == ["data"]
        assert got["input_shapes"] == want["input_shapes"] == [[1, 3, 67,
                                                                67]]
        keys = ("name", "type", "bottoms", "tops", "params", "phase")
        assert [{k: ly[k] for k in keys} for ly in got["layers"]] == \
            [{k: ly[k] for k in keys} for ly in want["layers"]]
        assert [b.tobytes() for ly in got["layers"] for b in ly["blobs"]] \
            == [b.tobytes() for ly in want["layers"] for b in ly["blobs"]]
        assert [ly["type"] for ly in got["layers"]].count("LRN") == 2
        x = rng.standard_normal((2, 3, 67, 67), dtype=np.float32)
        outs = ["fc8", "prob"]
        for g, w in zip(Net.load_caffe(None, data, outputs=outs,
                                       device="cpu").predict(x),
                        JaxNet.load_caffe(None, data, outputs=outs)
                        .predict(x)):
            _close(g, w)
        return
    from analytics_zoo_tpu.pipeline.onnx import load_onnx as jax_load
    from analytics_zoo_tpu_torch.convert import (
        bert_from_flax, init_bert_params)
    cfg = dict(vocab=50, hidden_size=32, n_head=4, n_block=2,
               intermediate_size=64, max_position_len=16, num_classes=3)
    native = bert.BERTClassifier(**cfg, compute_dtype=torch.float32,
                                 attn_impl="einsum", device="cpu").eval()
    native.load_state_dict(bert_from_flax(init_bert_params(cfg, 0), cfg))
    data = chip_smoke.bert_onnx(
        {k: v.numpy() for k, v in native.state_dict().items()}, 4, 16)
    rows = chip_smoke.import_bert_rows(rng, 4, 16, 50)
    module, _ = Net.load_onnx(data, device="cpu")
    jmodule, _ = jax_load(data)
    want = jmodule.apply(jmodule.init(jax.random.PRNGKey(0), *rows), *rows)
    with torch.no_grad():
        got = module(*rows)
        _close(got, want)
        _close(got, native(*(torch.from_numpy(a) for a in rows)))


_FRESH = r"""
import sys
import numpy as np
import chip_smoke
from analytics_zoo_tpu_torch.pipeline.net import GraphNet, Net
from analytics_zoo_tpu_torch import tfpark
from analytics_zoo_tpu_torch.orca.learn import Estimator
rng = np.random.default_rng(0)
gd = chip_smoke.mobilenet_v1_graphdef(rng, 0.125, 32, 5)
assert Net.load_tf(gd, device="cpu").predict(
    np.zeros((1, 32, 32, 3), np.float32)).shape == (1, 5)
cm = chip_smoke.caffenet_model(rng, dict(conv1=8, conv2=8, conv3=8, conv4=8,
                               conv5=8, fc6=8, fc7=8, fc8=3), 67)
assert Net.load_caffe(None, cm, device="cpu").predict(
    np.zeros((1, 3, 67, 67), np.float32)).shape == (1, 3)
from analytics_zoo_tpu_torch.pipeline.onnx.onnx_proto import encode_model
data = encode_model(nodes=[("Gemm", ["x", "w"], ["y"], {"transB": 1})],
                    initializers={"w": np.ones((2, 3), np.float32)},
                    inputs=[("x", [1, 3])], outputs=["y"])
est = Estimator.from_onnx(data, loss="mse", device="cpu")
est.fit({"x": np.ones((4, 3), np.float32),
         "y": np.zeros((4, 2), np.float32)}, batch_size=4)
module, model = Net.load_onnx(data, device="cpu")
GraphNet(model).freeze().to_module(device="cpu")
assert tfpark.TFNet is not None
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "flax", "ml_dtypes",
                                    "analytics_zoo_tpu"))
print("FORBIDDEN", bad)
"""


def test_importers_load_no_jax_nor_ml_dtypes():
    """The importers, tfpark and phase 20's writers run in a fresh
    interpreter that never loads jax, flax, ml_dtypes or the JAX
    package (the card machine has none of them)."""
    import os
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo)
    env.pop("PYTHONSTARTUP", None)
    proc = subprocess.run([sys.executable, "-c", _FRESH], cwd=repo, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "FORBIDDEN []" in proc.stdout, proc.stdout
