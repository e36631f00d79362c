"""The port's recurrent and text models (TextClassifier, AnomalyDetector,
Seq2Seq and the shared flax cells of models/common/recurrent.py) held
against the JAX package's on the same weights (carried across by
`convert.*_from_flax`) and the same numpy inputs, on the CPU.

Tolerances, each with its reason:
  * forwards, `Seq2Seq.infer` and one SGD step's parameters: 1e-5
    absolute, the same f32 arithmetic summed in other orders (cuDNN-free
    torch CPU kernels against XLA's);
  * converters, `unroll` and `detect_anomalies`: exact."""

import functools

import numpy as np
import pytest
import torch

import jax
import optax

from _torch_chronos_cases import one_torch_thread  # noqa: F401
from analytics_zoo_tpu.models.anomalydetection import (
    AnomalyDetector as JaxAnomalyDetector,
    detect_anomalies as jax_detect_anomalies,
)
from analytics_zoo_tpu.models.seq2seq import Seq2Seq as JaxSeq2Seq
from analytics_zoo_tpu.models.textclassification import (
    TextClassifier as JaxTextClassifier,
)
from analytics_zoo_tpu_torch import convert
from analytics_zoo_tpu_torch.models.anomalydetection import (
    AnomalyDetector,
    detect_anomalies,
)
from analytics_zoo_tpu_torch.models.common import recurrent
from analytics_zoo_tpu_torch.models.seq2seq import Seq2Seq
from analytics_zoo_tpu_torch.models.textclassification import TextClassifier
from analytics_zoo_tpu_torch.orca.learn import Estimator

TOL = 1e-5
TC_KW = dict(class_num=3, vocab_size=64, embed_dim=8, sequence_length=12,
             encoder_output_dim=16)
AD_KW = dict(hidden_layers=(4, 6), dropouts=(0.2, 0.2))


def _params(module, *inputs, seed=0):
    return jax.tree_util.tree_map(
        np.array, module.init(jax.random.PRNGKey(seed), *inputs)["params"])


def _leaves_equal(a, b):
    ta, tb = jax.tree_util.tree_structure(a), jax.tree_util.tree_structure(b)
    assert ta == tb
    for x, y in zip(jax.tree_util.tree_leaves(a),
                    jax.tree_util.tree_leaves(b)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def _close(a, b, tol=TOL):
    for x, y in zip(jax.tree_util.tree_leaves(a),
                    jax.tree_util.tree_leaves(b)):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), rtol=0,
                                   atol=tol)


def _token_ids(rng, n):
    # ids below 0 and past the vocab: both sides clip them
    return rng.integers(-3, TC_KW["vocab_size"] + 5,
                        (n, TC_KW["sequence_length"])).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _text_classifier(enc):
    """(JAX module, its params, token ids, labels) of an encoder, made
    once a process on first use (an xdist worker makes only those its
    tests need)."""
    rng = np.random.default_rng(0)
    ids = _token_ids(rng, 8)
    y = rng.integers(0, TC_KW["class_num"], 8).astype(np.int32)
    jm = JaxTextClassifier(**TC_KW, encoder=enc, dropout=0.0)
    return jm, _params(jm, ids), ids, y


def _port_text_classifier(enc, params):
    m = TextClassifier(**TC_KW, encoder=enc, dropout=0.0, device="cpu")
    m.load_state_dict(convert.text_classifier_from_flax(params))
    return m


def _forward_and_step(jm, p, inputs, loss, lr):
    """JAX's forward outputs and its SGD step of `loss(outputs)` from
    one program (`value_and_grad` with the outputs as aux)."""
    def f(params):
        out = jm.apply({"params": params}, *inputs)
        return loss(out), out
    (_, out), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(p)
    return np.asarray(out), jax.tree_util.tree_map(
        lambda a, g: np.asarray(a - lr * g), p, grads)


@pytest.mark.parametrize("enc", ["cnn", "lstm", "gru"])
def test_text_classifier_matches_jax(enc):
    """The forward, and one SGD step through the port's Estimator against
    the update from JAX's gradient of the same masked-mean cross
    entropy."""
    jm, p, ids, y = _text_classifier(enc)
    lr = 0.5
    want, stepped = _forward_and_step(
        jm, p, (ids,), lambda logits: optax.
        softmax_cross_entropy_with_integer_labels(logits, y).mean(), lr)
    m = _port_text_classifier(enc, p).eval()
    got = m(torch.from_numpy(ids)).detach().numpy()
    assert got.shape == (8, TC_KW["class_num"]) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    _leaves_equal(convert.text_classifier_to_flax(m.state_dict()), p)
    est = Estimator.from_torch(m, loss="sparse_categorical_crossentropy",
                               optimizer="sgd", learning_rate=lr)
    est.fit({"x": ids, "y": y}, epochs=1, batch_size=8, shuffle=False)
    _close(convert.text_classifier_to_flax(m.state_dict()), stepped)
    # the biases torch has and flax lacks stay at zero
    if enc == "lstm":
        assert not m.cell.bias_ih_l0.detach().any()
    if enc == "gru":
        assert not m.cell.bias_hh_l0.detach()[:2 * 16].any()


def test_text_classifier_dropout_draws_from_the_generator():
    m = TextClassifier(**TC_KW, encoder="cnn", dropout=0.5, device="cpu")
    ids = torch.from_numpy(_token_ids(np.random.default_rng(1), 4))
    outs = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(3)
        outs.append(m.train()(ids, generator=gen))
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
    assert not torch.equal(outs[0], m.eval()(ids))
    with pytest.raises(ValueError):
        TextClassifier(**TC_KW, encoder="transformer", device="cpu")


def test_anomaly_detector_matches_jax():
    rng = np.random.default_rng(2)
    series = np.sin(np.arange(40) / 3.0).astype(np.float32) \
        + rng.normal(0, 0.05, 40).astype(np.float32)
    x, y = AnomalyDetector.unroll(series, 6)
    jx, jy = JaxAnomalyDetector.unroll(series, 6)
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)
    with pytest.raises(ValueError):
        AnomalyDetector.unroll(series[:5], 6)
    jm = JaxAnomalyDetector(**AD_KW)
    p = _params(jm, x)
    # the forward and one SGD step of the default mse (JAX's apply is
    # deterministic: no dropout, so the port's rates are 0)
    want, stepped = _forward_and_step(
        jm, p, (x,), lambda out: ((out - y[:, None]) ** 2).mean(), 0.5)
    m = AnomalyDetector(AD_KW["hidden_layers"], (0.0, 0.0), feature_dim=1,
                        device="cpu").eval()
    m.load_state_dict(convert.anomaly_detector_from_flax(p))
    got = m(torch.from_numpy(x)).detach().numpy()
    assert got.shape == (len(x), 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    np.testing.assert_array_equal(detect_anomalies(y, got, 4),
                                  jax_detect_anomalies(y, got, 4))
    np.testing.assert_array_equal(detect_anomalies(y[:3], got[:3], 9),
                                  jax_detect_anomalies(y[:3], got[:3], 9))
    _leaves_equal(convert.anomaly_detector_to_flax(m.state_dict()), p)
    est = Estimator.from_torch(m, optimizer="sgd", learning_rate=0.5)
    est.fit({"x": x, "y": y}, epochs=1, batch_size=len(x), shuffle=False)
    _close(convert.anomaly_detector_to_flax(m.state_dict()), stepped)


S2S_ENC = np.random.default_rng(3).normal(size=(4, 5, 6)).astype(np.float32)
S2S_DEC = np.random.default_rng(4).normal(size=(4, 4, 6)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _seq2seq_tree(cell_type, bridge):
    """The 2-layer JAX module's params, made once a process on first
    use: a 1-layer model's tree is its layer-0 subset (layer 0's shapes
    do not depend on the depth).  The passthrough models have no
    generator head, so `infer` feeds the hidden state back (input width
    = hidden)."""
    return _params(JaxSeq2Seq(**_s2s_kw(cell_type, bridge, 2)),
                   *_s2s_inputs(bridge))


def _s2s_inputs(bridge):
    """(encoder, decoder) inputs: a dense model's decoder reads 3 of the
    6 features (its generator's width, which `infer` feeds back)."""
    return (S2S_ENC, S2S_DEC) if bridge == "passthrough" else \
        (S2S_ENC, S2S_DEC[..., :3])


def _s2s_kw(cell_type, bridge, num_layers):
    return dict(hidden_size=6, num_layers=num_layers, bridge=bridge,
                cell_type=cell_type,
                output_dim=3 if bridge == "dense" else None)


def _layers(tree, num_layers):
    """The entries of `tree` a `num_layers` model has."""
    return {k: v for k, v in tree.items()
            if not k[-1].isdigit() or int(k.split("_")[2]) < num_layers}


@pytest.mark.parametrize("num_layers", [1, 2])
@pytest.mark.parametrize("bridge", ["dense", "passthrough"])
@pytest.mark.parametrize("cell_type", ["lstm", "gru"])
def test_seq2seq_forward_and_infer_match_jax(cell_type, bridge, num_layers):
    kw = _s2s_kw(cell_type, bridge, num_layers)
    jm = JaxSeq2Seq(**kw)
    p = _layers(_seq2seq_tree(cell_type, bridge), num_layers)
    enc, dec = _s2s_inputs(bridge)
    m = Seq2Seq(**kw, input_dim=6, decoder_input_dim=dec.shape[-1],
                device="cpu")
    m.load_state_dict(convert.seq2seq_from_flax(p))
    y = np.random.default_rng(5).normal(size=dec.shape).astype(np.float32)
    # one layer: the forward and one SGD step of the default mse from one
    # program; two: the forward (the stacking), the backward's compile
    # left out (twice a layer's)
    if num_layers == 1:
        want, stepped = _forward_and_step(
            jm, p, (enc, dec), lambda out: ((out - y) ** 2).mean(), 0.5)
    else:
        want, stepped = np.asarray(jm.apply({"params": p}, enc, dec)), None
    got = m(torch.from_numpy(enc), torch.from_numpy(dec)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    steps = 6
    want = np.asarray(jm.apply({"params": p}, enc, dec[:, 0], steps,
                               method=JaxSeq2Seq.infer))
    got = m.infer(torch.from_numpy(enc), torch.from_numpy(dec[:, 0]),
                  steps).numpy()
    assert got.shape == (4, steps, dec.shape[-1])
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    _leaves_equal(convert.seq2seq_to_flax(m.state_dict()), p)
    if stepped is not None:
        est = Estimator.from_torch(m, optimizer="sgd", learning_rate=0.5)
        est.fit({"x": [enc, dec], "y": y}, epochs=1, batch_size=len(y),
                shuffle=False)
        _close(convert.seq2seq_to_flax(m.state_dict()), stepped)
    with pytest.raises(ValueError, match="bridge"):
        Seq2Seq(bridge="attention", device="cpu")


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_cell_converters_round_trip_bitwise(cell):
    import flax.linen as fnn
    flax_cell = (fnn.OptimizedLSTMCell if cell == "lstm"
                 else fnn.GRUCell)(5)
    x = np.zeros((2, 3), np.float32)
    carry = flax_cell.initialize_carry(jax.random.PRNGKey(0), x.shape)
    tree = jax.tree_util.tree_map(
        np.array, flax_cell.init(jax.random.PRNGKey(1), carry, x)["params"])
    # biases that are not zero, so their placement shows
    tree = jax.tree_util.tree_map(
        lambda a: a + np.float32(0.25) if a.ndim == 1 else a, tree)
    weights = recurrent.cell_from_flax(tree)
    _leaves_equal(recurrent.cell_to_flax(weights), tree)
    rnn = recurrent.make(cell, 3, 5, "cpu")
    rnn.load_state_dict({k: torch.from_numpy(v) for k, v in weights.items()})
    _leaves_equal(recurrent.cell_to_flax(
        {k: v.detach().numpy() for k, v in rnn.state_dict().items()}), tree)
    # one step of the cell: flax's carry (c, h) is torch's state (h, c)
    xs = np.random.default_rng(5).normal(size=(2, 3)).astype(np.float32)
    if cell == "lstm":
        c0 = np.full((2, 5), 0.3, np.float32)
        h0 = np.full((2, 5), -0.2, np.float32)
        (c1, h1), _ = flax_cell.apply({"params": tree}, (c0, h0), xs)
        _, (th, tc) = rnn(torch.from_numpy(xs)[:, None],
                          (torch.from_numpy(h0)[None],
                           torch.from_numpy(c0)[None]))
        np.testing.assert_allclose(tc[0].detach().numpy(), c1, atol=TOL)
    else:
        h0 = np.full((2, 5), -0.2, np.float32)
        h1, _ = flax_cell.apply({"params": tree}, h0, xs)
        _, th = rnn(torch.from_numpy(xs)[:, None], torch.from_numpy(h0)[None])
    np.testing.assert_allclose(th[0].detach().numpy(), h1, atol=TOL)
    with pytest.raises(ValueError, match="dec_cells_0"):
        del tree[next(iter(tree))]
        recurrent.cell_from_flax(tree, "dec_cells_0")


def test_package_exports_the_jax_names():
    from analytics_zoo_tpu_torch.models import anomalydetection, seq2seq
    from analytics_zoo_tpu_torch.models import textclassification
    assert anomalydetection.AnomalyDetector is AnomalyDetector
    assert anomalydetection.detect_anomalies is detect_anomalies
    assert seq2seq.Seq2Seq is Seq2Seq
    assert textclassification.TextClassifier is TextClassifier


@pytest.mark.parametrize("enc", ["cnn", "lstm"])
def test_quantized_serving_takes_the_layout(enc):
    """`InferenceModel.load_module(quantize=True)` quantizes the model in
    its flax layout: the stats are JAX's `quantize_params` of the same
    tree (the 64 x 8 table and `fc` quantize, the small cells stay
    float), and the served logits those of the dequantized weights."""
    from analytics_zoo_tpu.serving.quantize import (
        quantize_params as jax_quantize_params,
    )
    from analytics_zoo_tpu_torch.serving.inference_model import (
        InferenceModel,
    )
    _, p, ids, _ = _text_classifier(enc)
    im = InferenceModel().load_module(_port_text_classifier(enc, p),
                                      quantize=True)
    _, want = jax_quantize_params(p)
    assert im.quantize_stats == want and want["quant_bytes"] < \
        want["orig_bytes"]
    served = im.predict(ids)
    plain = TextClassifier(**TC_KW, encoder=enc, dropout=0.0, device="cpu")
    plain.load_state_dict(_dequantized(im._module))
    with torch.no_grad():
        ref = plain.eval()(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(served, ref, rtol=0, atol=TOL)


def _dequantized(module):
    """{name: the weight a forward reads} of a quantized module."""
    out = {}
    for name, value in module.state_dict().items():
        if ".parametrizations." not in name:
            out[name] = value
        elif name.endswith(".original"):
            owner, leaf = name.split(".parametrizations.")
            leaf = leaf.split(".")[0]
            out[f"{owner}.{leaf}"] = getattr(
                module.get_submodule(owner), leaf).detach().float()
    return out
