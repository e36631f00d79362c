"""The port's int8 weight serving (analytics_zoo_tpu_torch/serving/
quantize.py and `InferenceModel(quantize=True)`) held against the JAX
package's `quantize_params` and `load_flax(..., quantize=True)` on the
same weights.

* The int8 values, the scales and the byte counts of the flax-layout
  tree are bitwise JAX's for a scan-stacked BERT (whose every 2-D leaf,
  biases and LayerNorm scales included, gets one scale per channel
  shared by its layers), NeuralCF, a ResNet and a plain MLP.
* After `quantize_module` each parameter of the port's module reads as
  JAX's dequantized leaf mapped through the converter: bf16(q * scale),
  an embedding table as bf16, the rest as f32 holding those values.
* Predicts: a quantized BERT within 0.05 of JAX's (bf16 compute, as
  `test_torch_bert.py`'s gate), an f32 MLP and an f32 ResNet within
  1e-5 (f32 arithmetic on the same bf16-rounded weights, summed in
  other orders), the recommendation family within 1e-5 (f32 compute).
* `start_serving` with `quantize: true` serves a saved NeuralCF whose
  /predict rows equal a direct quantized predict to 1e-5.
"""

import urllib.request

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from analytics_zoo_tpu.models import recommendation as jrec
from analytics_zoo_tpu.models.bert import BERTClassifier as JaxClassifier
from analytics_zoo_tpu.models.image.imageclassification import (
    ResNet as JaxResNet,
)
from analytics_zoo_tpu.serving import quantize as jq
from analytics_zoo_tpu.serving.inference_model import (
    InferenceModel as JaxInferenceModel,
)
from analytics_zoo_tpu_torch import convert
from analytics_zoo_tpu_torch.models import recommendation as rec
from analytics_zoo_tpu_torch.models.bert import BERTClassifier
from analytics_zoo_tpu_torch.models.image.imageclassification import ResNet
from analytics_zoo_tpu_torch.serving import (
    InferenceModel,
    InputQueue,
    ServingConfig,
    start_serving,
    stop_serving,
)
from analytics_zoo_tpu_torch.serving import quantize as q

TOL, BF16_TOL = 1e-5, 0.05
HTTP_TIMEOUT = 30.0
#: wide enough that the stacked biases and LayerNorm scales pass
#: min_size (2 x 256 = 512 elements), as BERT-base's do
BERT = dict(vocab=64, hidden_size=256, n_head=4, n_block=2,
            intermediate_size=512, max_position_len=16, num_classes=3)
NCF = dict(user_count=60, item_count=50, class_num=2, user_embed=16,
           item_embed=16, hidden_layers=(32, 16), mf_embed=16)
RESNET = dict(stage_sizes=(1, 1), block="bottleneck", num_classes=3)


def _jax_params(module, *inputs):
    return jax.tree_util.tree_map(
        np.asarray, jax.jit(module.init)(jax.random.PRNGKey(0), *inputs))


class _FlaxMLP(fnn.Module):
    @fnn.compact
    def __call__(self, x):
        x = fnn.relu(fnn.Dense(64)(x))
        x = fnn.relu(fnn.Dense(64)(x))
        return fnn.Dense(4)(x)


def _mlp():
    x = np.random.default_rng(2).normal(size=(24, 16)).astype(np.float32)
    params = _jax_params(_FlaxMLP(), x[:1])["params"]
    port = nn.Sequential(nn.Linear(16, 64), nn.ReLU(), nn.Linear(64, 64),
                         nn.ReLU(), nn.Linear(64, 4))
    with torch.no_grad():
        for j, i in enumerate((0, 2, 4)):
            port[i].weight.copy_(torch.from_numpy(
                params[f"Dense_{j}"]["kernel"].T.copy()))
            port[i].bias.copy_(torch.from_numpy(
                params[f"Dense_{j}"]["bias"].copy()))
    # the port's flax-layout tree is keyed by parameter name
    names = {f"{i}.{leaf}": (f"Dense_{j}", "kernel" if leaf == "weight"
                             else leaf)
             for j, i in enumerate((0, 2, 4)) for leaf in ("weight", "bias")}
    tree = {k: params[m][leaf] for k, (m, leaf) in names.items()}
    return _FlaxMLP(), params, port, tree, x


def _bert():
    tree = convert.init_bert_params(BERT, seed=0)
    port = BERTClassifier(**BERT, device="cpu")
    port.load_state_dict(convert.bert_from_flax(tree, BERT))
    return JaxClassifier(**BERT), tree, port


def _ncf(dtype=torch.bfloat16, jdtype=jnp.bfloat16):
    rng = np.random.default_rng(1)
    u = rng.integers(1, NCF["user_count"] + 1, 20).astype(np.int32)
    i = rng.integers(1, NCF["item_count"] + 1, 20).astype(np.int32)
    jm = jrec.NeuralCF(**NCF, compute_dtype=jdtype)
    params = _jax_params(jm, u, i)["params"]
    port = rec.NeuralCF(**NCF, compute_dtype=dtype, device="cpu")
    port.load_state_dict(convert.ncf_from_flax(params))
    return jm, params, port, (u, i)


def _resnet():
    x = np.random.default_rng(3).normal(size=(4, 32, 32, 3)).astype(
        np.float32)
    jm = JaxResNet(**RESNET, dtype=jnp.float32)
    variables = _jax_params(jm, x)
    # running statistics away from their init, as after training
    stats = jax.tree_util.tree_map(lambda a: a + 0.25,
                                   variables["batch_stats"])
    port = ResNet(**RESNET, dtype=torch.float32, device="cpu").eval()
    port.load_state_dict(convert.image_from_flax(variables["params"], stats))
    return jm, variables["params"], stats, port, x


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if q.is_quantized_leaf(v) or not isinstance(v, dict):
            yield prefix + k, v
        else:
            yield from _leaves(v, f"{prefix}{k}/")


def _assert_bitwise(got_tree, want_tree):
    got, want = dict(_leaves(got_tree)), dict(_leaves(want_tree))
    assert set(got) == set(want)
    for path, w in want.items():
        g = got[path]
        assert q.is_quantized_leaf(g) == jq.is_quantized_leaf(w), path
        if jq.is_quantized_leaf(w):
            for key in (q._QKEY, "scale"):
                assert g[key].dtype == w[key].dtype, path
                assert np.array_equal(g[key], w[key]), path
        else:
            assert np.array_equal(np.asarray(g), np.asarray(w)), path


@pytest.mark.parametrize("family", ["bert", "ncf", "resnet", "mlp"])
def test_int8_values_and_scales_are_bitwise_jax(family):
    if family == "bert":
        _, want_tree, port = _bert()
    elif family == "ncf":
        _, want_tree, port, _ = _ncf()
    elif family == "resnet":
        _, want_tree, _, port, _ = _resnet()
    else:
        _, _, port, want_tree, _ = _mlp()
    to_flax, _ = q.flax_layout(port)
    got, got_stats = q.quantize_params(to_flax(port.state_dict()))
    want, want_stats = jq.quantize_params(want_tree)
    _assert_bitwise(got, want)
    assert got_stats == want_stats
    assert q.quantized_size_bytes(got) == want_stats["quant_bytes"]
    if family == "bert":
        # every stacked 2-D leaf is quantized, one scale per channel for
        # all the layers; the 1-D leaves stay f32
        blocks = got["bert"]["blocks"]
        assert blocks["fc1"]["kernel"]["scale"].shape == (1, 1, 512)
        assert blocks["ln1"]["scale"]["scale"].shape == (1, 256)
        assert q.is_quantized_leaf(blocks["attn"]["qkv"]["bias"])
        assert not q.is_quantized_leaf(got["bert"]["embed_ln"]["scale"])


def test_module_weights_read_as_jax_dequantized_leaves():
    _, tree, port = _bert()
    qtree, _ = jq.quantize_params(tree)
    deq = jax.tree_util.tree_map(
        lambda a: np.asarray(a.astype(jnp.float32)),
        jq.dequantize_params(qtree, dtype=jnp.bfloat16))
    want = convert.bert_from_flax(deq, BERT)
    stats = q.quantize_module(port)
    assert stats == jq.quantize_params(tree)[1]
    for name, w in want.items():
        owner, _, leaf = name.rpartition(".")
        got = getattr(port.get_submodule(owner), leaf)
        assert torch.equal(got.float(), w), name
        embed = isinstance(port.get_submodule(owner), nn.Embedding)
        assert got.dtype == (torch.bfloat16 if embed else torch.float32)
    # the layers of a stacked leaf hold their own int8 slice and share
    # the leaf's scale tensor
    fc1 = [port.bert.blocks[i].fc1.parametrizations.weight for i in (0, 1)]
    assert all(p.original.dtype == torch.int8 for p in fc1)
    assert fc1[0][0].scale is fc1[1][0].scale
    assert tuple(fc1[0][0].scale.shape) == (512, 1)
    # 1-D leaves keep their parameters
    assert isinstance(port.bert.embed_ln.weight, nn.Parameter)
    assert not hasattr(port.bert.embed_ln, "parametrizations")


def test_quantized_bert_predict_matches_jax():
    jm, tree, port = _bert()
    rng = np.random.default_rng(4)
    ids = rng.integers(0, BERT["vocab"], (5, 12)).astype(np.int32)
    seg = (np.arange(12)[None] >= 6).astype(np.int32).repeat(5, 0)
    mask = (np.arange(12)[None] < rng.integers(4, 13, 5)[:, None]).astype(
        np.int32)
    jim = JaxInferenceModel(max_batch_size=8).load_flax(jm, tree,
                                                        quantize=True)
    want = np.asarray(jim.predict(ids, seg, mask))
    im = InferenceModel(max_batch_size=8).load_module(port, quantize=True)
    got = im.predict(ids, seg, mask)
    assert got.shape == want.shape == (5, 3)
    np.testing.assert_allclose(got, want, atol=BF16_TOL, rtol=0)
    assert im.quantize_stats == jim.quantize_stats
    # the caller's module keeps its f32 weights
    assert port.bert.blocks[0].fc1.weight.dtype == torch.float32
    assert not hasattr(port.bert.blocks[0].fc1, "parametrizations")
    # resident: the int8 values, one copy of each distinct scale and the
    # f32 leaves, no more than JAX's count of its quantized tree
    assert q.resident_bytes(im._module) <= im.quantize_stats["quant_bytes"]


def test_quantized_mlp_predict_matches_jax_f32():
    jm, params, port, _, x = _mlp()
    want = JaxInferenceModel().load_flax(jm, params, quantize=True
                                         ).predict(x)
    got = InferenceModel().load_module(port, quantize=True).predict(x)
    np.testing.assert_allclose(got, np.asarray(want), atol=TOL, rtol=0)
    unquantized = InferenceModel().load_module(port).predict(x)
    assert np.abs(got - unquantized).max() > 10 * TOL


def test_quantized_resnet_predict_matches_jax_f32():
    jm, params, stats, port, x = _resnet()
    want = JaxInferenceModel().load_flax(
        jm, params, {"batch_stats": stats}, quantize=True).predict(x)
    im = InferenceModel().load_module(port, quantize=True)
    got = im.predict(x)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * np.abs(want).max())
    # BatchNorm's scale, bias and running statistics stay f32
    bn = im._module.stem_bn
    assert bn.weight.dtype == bn.running_var.dtype == torch.float32
    assert not hasattr(bn, "parametrizations")


@pytest.mark.parametrize("family", ["ncf", "wide_and_deep",
                                    "session_recommender"])
def test_quantized_recommenders_match_jax(family):
    rng = np.random.default_rng(5)
    if family == "ncf":
        jm, params, port, inputs = _ncf(torch.float32, jnp.float32)
    elif family == "wide_and_deep":
        ci = dict(wide_base_cols=["a"], wide_base_dims=[600],
                  embed_cols=["u"], embed_in_dims=[300],
                  embed_out_dims=[8], continuous_cols=["c"])
        ids = np.stack([rng.integers(0, 600, 16), rng.integers(0, 300, 16)],
                       1)
        inputs = (np.concatenate([ids, rng.normal(size=(16, 1))], 1
                                 ).astype(np.float32),)
        jm = jrec.WideAndDeep(column_info=jrec.ColumnFeatureInfo(**ci),
                              hidden_layers=(64, 16),
                              compute_dtype=jnp.float32)
        params = _jax_params(jm, *inputs)["params"]
        port = rec.WideAndDeep(rec.ColumnFeatureInfo(**ci),
                               hidden_layers=(64, 16),
                               compute_dtype=torch.float32, device="cpu")
        port.load_state_dict(convert.wide_and_deep_from_flax(params))
    else:
        kw = dict(item_count=60, item_embed=16, rnn_hidden_layers=(32, 8),
                  session_length=5, mlp_hidden_layers=(4,),
                  history_length=3, include_history=True)
        inputs = (rng.integers(0, 61, (16, 5)).astype(np.int32),
                  rng.integers(0, 61, (16, 3)).astype(np.int32))
        jm = jrec.SessionRecommender(**kw)
        params = _jax_params(jm, *inputs)["params"]
        port = rec.SessionRecommender(**kw, device="cpu")
        port.load_state_dict(convert.session_recommender_from_flax(params))
    to_flax, _ = q.flax_layout(port)
    _assert_bitwise(q.quantize_params(to_flax(port.state_dict()))[0],
                    jq.quantize_params(params)[0])
    want = JaxInferenceModel().load_flax(jm, params, quantize=True
                                         ).predict(*inputs)
    got = InferenceModel().load_module(port, quantize=True).predict(*inputs)
    np.testing.assert_allclose(got, np.asarray(want), atol=TOL, rtol=0)


def test_to_flax_inverts_from_flax():
    _, params, port, _ = _ncf()
    got = convert.ncf_to_flax(port.state_dict())
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(
        np.array_equal, got, params))
    _, _, stats, resnet, _ = _resnet()
    p, s = convert.image_to_flax(resnet.state_dict())
    sd = convert.image_from_flax(p, s)
    assert all(torch.equal(sd[k], v) for k, v in resnet.state_dict().items())


def test_dequantize_params_rounds_as_jax():
    rng = np.random.default_rng(6)
    tree = {"d": {"kernel": rng.normal(size=(64, 32)).astype(np.float32),
                  "bias": rng.normal(size=32).astype(np.float32)}}
    qtree, _ = q.quantize_params(tree)
    got = q.dequantize_params(qtree, dtype=torch.bfloat16)
    want = jq.dequantize_params(jq.quantize_params(tree)[0],
                                dtype=jnp.bfloat16)
    assert got["d"]["kernel"].dtype == torch.bfloat16
    assert np.array_equal(got["d"]["kernel"].float().numpy(),
                          np.asarray(want["d"]["kernel"].astype(jnp.float32)))
    assert got["d"]["bias"] is tree["d"]["bias"]


def test_start_serving_serves_int8_weights(tmp_path, monkeypatch):
    real = urllib.request.urlopen

    def urlopen(*args, timeout=HTTP_TIMEOUT, **kw):
        # the client's default timeout is 60 s
        return real(*args, timeout=min(timeout, HTTP_TIMEOUT), **kw)
    monkeypatch.setattr(urllib.request, "urlopen", urlopen)
    _, _, port, (u, i) = _ncf()
    path = port.save_model(str(tmp_path / "ncf"))
    direct = InferenceModel().load_model(path, quantize=True, device="cpu")
    want = direct.predict(u, i)
    assert direct.quantize_stats["compression"] > 2.0
    servers = start_serving(ServingConfig(modelPath=path, port=0,
                                          quantize=True,
                                          batchTimeoutMs=1.0),
                            device="cpu")
    try:
        srv = servers["http"]
        got = InputQueue(srv.host, srv.port).predict(u, i, batched=True)
        np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
        assert servers["model"].quantize_stats == direct.quantize_stats
    finally:
        stop_serving(servers)
