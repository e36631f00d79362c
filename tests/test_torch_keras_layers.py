"""The port's Keras layer vocabulary (analytics_zoo_tpu_torch/keras/
layers/) held against the JAX package's, layer by layer.

`test_layer_matches_jax` runs one case per class and function that
`analytics_zoo_tpu.keras.layers` exports: the same graph is built in
both packages (the layer names must come out equal), the flax weights
of JAX's `init` are carried into the port by `convert.keras_from_flax`,
and both run on the same seeded numpy inputs in eval mode.  The outputs
are compared, and for a layer with parameters the gradients of the sum
of its outputs, brought back to flax's layout by `convert.keras_to_flax`.
Random layers are exact in eval mode; in training their statistics are
compared (keep rates, noise moments, slopes), each on a fixed generator.
The port-only tests mirror `test_keras_layer_breadth.py` and
`test_keras_layer_vocab_r4.py` on the port.

Tolerances, each with its reason:
  * f32 layers: outputs within 1e-5 and gradients within 1e-4 of
    max(1, |JAX's|), the same f32 arithmetic summed in other orders
    (the gradients through reductions over the batch and positions);
  * the bf16 transformer layers (BERT, TransformerLayer; JAX's default
    compute dtype): outputs and gradients within 0.05 of max(1, |JAX's|),
    `test_torch_bert.py`'s bf16 gate;
  * random layers in training: each statistic within 5 standard errors
    of its expectation over n draws (a false alarm about once in 3.5
    million runs).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_chronos_cases import one_torch_thread  # noqa: F401
from analytics_zoo_tpu.keras import engine as jax_engine
from analytics_zoo_tpu.keras import layers as JL
from analytics_zoo_tpu.keras.models import Model as JaxModel
from analytics_zoo_tpu_torch.convert import keras_from_flax, keras_to_flax
from analytics_zoo_tpu_torch.keras import engine as port_engine
from analytics_zoo_tpu_torch.keras import layers as PL
from analytics_zoo_tpu_torch.keras.models import Model, Sequential

F32_OUT, F32_GRAD, BF16_TOL, SIGMAS = 1e-5, 1e-4, 0.05, 5.0

_RNG = np.random.default_rng(0)


def _normal(*shape):
    return _RNG.normal(size=shape).astype(np.float32)


X2 = _normal(3, 6)
X3 = _normal(3, 5, 4)
IMG = _normal(2, 7, 8, 3)
VOL = _normal(2, 4, 5, 6, 2)
SEQ_IMG = _normal(2, 3, 6, 6, 2)
SEQ_VOL = _normal(2, 3, 4, 4, 5, 2)
POS = np.abs(_normal(3, 6)) + 0.1
IDS = _RNG.integers(0, 20, (3, 5)).astype(np.int32)
BAG_IDS = np.array([[0, 3, -1], [1, -1, -1], [5, 2, 4]], np.int32)
BAG_VALS = np.array([[1.0, 2.0, 99.0], [0.5, 99.0, 99.0], [1.0, -1.0, 3.0]],
                    np.float32)
TABLE = _normal(20, 4)
T_IDS = _RNG.integers(0, 30, (2, 8)).astype(np.int32)
MASKED = X3.copy()
MASKED[0, 1] = 0.0
MASKED[2, 3] = 0.0


def single(layer_fn, x, **kw):
    def build(L, Input):
        i = Input()
        return [i], layer_fn(L)(i)
    return dict(build=build, inputs=[x], **kw)


def multi(layer_fn, xs, **kw):
    def build(L, Input):
        ins = [Input() for _ in xs]
        return ins, layer_fn(L)(ins)
    return dict(build=build, inputs=list(xs), **kw)


def _glove(L, tmp_path):
    path = tmp_path / "vec.txt"
    path.write_text("cat 1.0 2.0 3.0\ndog -1.0 0.5 2.0\nemu 0 0 1\n")
    return L.glove_word_embedding(str(path), {"cat": 1, "dog": 2, "yak": 3},
                                  trainable=True)


def _functional(fn, xs, **kw):
    def build(L, Input):
        ins = [Input() for _ in xs]
        return ins, fn(L, ins)
    return dict(build=build, inputs=list(xs), **kw)


CASES = {
    # core
    "Activation": single(lambda L: L.Activation("gelu"), X2),
    "Dense": single(lambda L: L.Dense(5, activation="tanh"), X3),
    "Dropout": single(lambda L: L.Dropout(0.3), X2),
    "Flatten": single(lambda L: L.Flatten(), X3),
    "GaussianNoise": single(lambda L: L.GaussianNoise(0.5), X2),
    "Highway": single(lambda L: L.Highway(), X2),
    "Lambda": single(lambda L: L.Lambda(lambda a: a[:, 0] * 2.0), X3),
    "Permute": single(lambda L: L.Permute((2, 1)), X3),
    "SparseDense": multi(lambda L: L.SparseDense(4, input_dim=6),
                         (BAG_IDS, BAG_VALS)),
    "RepeatVector": single(lambda L: L.RepeatVector(3), X2),
    "Reshape": single(lambda L: L.Reshape((2, 10)), X3),
    # embeddings
    "Embedding": single(lambda L: L.Embedding(20, 4), IDS),
    "SparseEmbedding": multi(
        lambda L: L.SparseEmbedding(6, 4, combiner="sqrtn", max_norm=0.05),
        (BAG_IDS, np.abs(BAG_VALS))),
    "WordEmbedding": single(lambda L: L.WordEmbedding(TABLE, trainable=True),
                            IDS),
    "glove_word_embedding": dict(glove=True, inputs=[
        np.array([[1, 2, 3, 0]], np.int32)]),
    "read_glove_vectors": dict(read_glove=True),
    # normalization
    "LRN2D": single(lambda L: L.LRN2D(alpha=1e-2, n=3), IMG),
    "BatchNormalization": single(lambda L: L.BatchNormalization(), X3),
    "LayerNormalization": single(lambda L: L.LayerNormalization(), X3),
    "WithinChannelLRN2D": single(lambda L: L.WithinChannelLRN2D(size=3),
                                 IMG),
    # conv
    "AtrousConvolution1D": single(
        lambda L: L.AtrousConvolution1D(3, 2, atrous_rate=2,
                                        border_mode="same"), X3),
    "AtrousConvolution2D": single(
        lambda L: L.AtrousConvolution2D(3, 3, 3, atrous_rate=2), IMG),
    "Conv1D": single(lambda L: L.Conv1D(3, 3, subsample=2,
                                        border_mode="same"), X3),
    "Conv2D": single(lambda L: L.Conv2D(4, 3, border_mode="same",
                                        subsample=2, activation="relu"), IMG),
    "Conv3D": single(lambda L: L.Conv3D(3, 2, border_mode="same"), VOL),
    "Convolution1D": single(lambda L: L.Convolution1D(3, 2), X3),
    "Convolution2D": single(lambda L: L.Convolution2D(3, 2, 3,
                                                      use_bias=False), IMG),
    "Convolution3D": single(lambda L: L.Convolution3D(2, (2, 3, 2)), VOL),
    "Cropping2D": single(lambda L: L.Cropping2D(((1, 2), (0, 1))), IMG),
    "Deconvolution2D": single(lambda L: L.Deconvolution2D(
        3, 3, subsample=2, border_mode="same"), IMG),
    "SeparableConv2D": single(lambda L: L.SeparableConv2D(
        4, 3, depth_multiplier=2, border_mode="same"), IMG),
    "ShareConvolution2D": single(lambda L: L.ShareConvolution2D(3, 2, 2),
                                 IMG),
    "UpSampling1D": single(lambda L: L.UpSampling1D(3), X3),
    "UpSampling2D": single(lambda L: L.UpSampling2D((2, 3)), IMG),
    "ZeroPadding1D": single(lambda L: L.ZeroPadding1D((1, 2)), X3),
    "ZeroPadding2D": single(lambda L: L.ZeroPadding2D((2, 1)), IMG),
    "Cropping1D": single(lambda L: L.Cropping1D((2, 1)), X3),
    "Cropping3D": single(lambda L: L.Cropping3D(), VOL),
    "UpSampling3D": single(lambda L: L.UpSampling3D((1, 2, 2)), VOL),
    "ZeroPadding3D": single(lambda L: L.ZeroPadding3D((1, 0, 2)), VOL),
    # pooling
    "AveragePooling1D": single(lambda L: L.AveragePooling1D(
        2, border_mode="same"), X3),
    "AveragePooling2D": single(lambda L: L.AveragePooling2D(
        3, strides=2, border_mode="same"), IMG),
    "AveragePooling3D": single(lambda L: L.AveragePooling3D(2), VOL),
    "GlobalAveragePooling1D": single(lambda L: L.GlobalAveragePooling1D(), X3),
    "GlobalAveragePooling2D": single(lambda L: L.GlobalAveragePooling2D(),
                                     IMG),
    "GlobalAveragePooling3D": single(lambda L: L.GlobalAveragePooling3D(),
                                     VOL),
    "GlobalMaxPooling1D": single(lambda L: L.GlobalMaxPooling1D(), X3),
    "GlobalMaxPooling2D": single(lambda L: L.GlobalMaxPooling2D(), IMG),
    "GlobalMaxPooling3D": single(lambda L: L.GlobalMaxPooling3D(), VOL),
    "MaxPooling1D": single(lambda L: L.MaxPooling1D(2), X3),
    "MaxPooling2D": single(lambda L: L.MaxPooling2D(
        3, strides=2, border_mode="same"), IMG),
    "MaxPooling3D": single(lambda L: L.MaxPooling3D(
        2, border_mode="same"), VOL),
    # recurrent
    "GRU": single(lambda L: L.GRU(4, return_sequences=True), X3),
    "LSTM": single(lambda L: L.LSTM(4, activation="relu",
                                    go_backwards=True), X3),
    "Bidirectional": single(lambda L: L.Bidirectional(L.LSTM(3),
                                                      merge_mode="sum"), X3),
    "SimpleRNN": single(lambda L: L.SimpleRNN(4, return_sequences=True),
                        X3),
    "TimeDistributed": single(lambda L: L.TimeDistributed(L.Dense(3)), X3),
    # merge
    "Add": multi(lambda L: L.Add(), (X2, X2 * 2)),
    "Average": multi(lambda L: L.Average(), (X2, X2 * 3, -X2)),
    "Concat": multi(lambda L: L.Concat(axis=1), (X3, X3[:, :2])),
    "Dot": multi(lambda L: L.Dot(), (X2, X2[::-1].copy())),
    "Maximum": multi(lambda L: L.Maximum(), (X2, X2[::-1].copy())),
    "Merge": multi(lambda L: L.Merge(mode="cos"), (X2, X2[::-1].copy())),
    "Minimum": multi(lambda L: L.Minimum(), (X2, X2[::-1].copy())),
    "Multiply": multi(lambda L: L.Multiply(), (X2, X2[::-1].copy())),
    "merge": _functional(lambda L, ins: L.merge(ins, mode="concat"),
                         (X2, X2)),
    # transformers (bf16 on both sides)
    "BERT": dict(build=lambda L, Input: (
        lambda ins: (ins, list(L.BERT(vocab=30, hidden_size=16, n_block=2,
                                      n_head=2, intermediate_size=32,
                                      seq_len=8)(ins))))(
        [Input() for _ in range(4)]),
        inputs=[T_IDS, (T_IDS % 2).astype(np.int32),
                np.tile(np.arange(8, dtype=np.int32), (2, 1)),
                np.array([[1] * 8, [1] * 5 + [0] * 3], np.int32)],
        tol=BF16_TOL),
    "TransformerLayer": single(lambda L: L.TransformerLayer(
        vocab=30, hidden_size=16, n_head=2, seq_len=8, n_block=2), T_IDS,
        tol=BF16_TOL),
    # advanced activations
    "ELU": single(lambda L: L.ELU(0.7), X2),
    "LeakyReLU": single(lambda L: L.LeakyReLU(0.1), X2),
    "RReLU": single(lambda L: L.RReLU(0.1, 0.3), X2),
    "PReLU": single(lambda L: L.PReLU(), X2),
    "SReLU": single(lambda L: L.SReLU(), X2 * 2),
    "ThresholdedReLU": single(lambda L: L.ThresholdedReLU(0.5), X2),
    # elementwise
    "AddConstant": single(lambda L: L.AddConstant(2.5), X2),
    "BinaryThreshold": single(lambda L: L.BinaryThreshold(0.2), X2),
    "CAdd": single(lambda L: L.CAdd(), X2),
    "CMul": single(lambda L: L.CMul(), X2),
    "Exp": single(lambda L: L.Exp(), X2),
    "Expand": single(lambda L: L.Expand((-1, 4, -1)), X2[:, None, :]),
    "ExpandDim": single(lambda L: L.ExpandDim(1), X2),
    "GetShape": single(lambda L: L.GetShape(), X3),
    "GaussianSampler": multi(lambda L: L.GaussianSampler(), (X2, X2 * 0.1)),
    "HardShrink": single(lambda L: L.HardShrink(0.5), X2),
    "HardTanh": single(lambda L: L.HardTanh(-0.5, 0.7), X2),
    "Identity": single(lambda L: L.Identity(), X2),
    "Log": single(lambda L: L.Log(), POS),
    "Masking": single(lambda L: L.Masking(0.0), MASKED),
    "Max": single(lambda L: L.Max(dim=1), X3),
    "MaxoutDense": single(lambda L: L.MaxoutDense(3, nb_feature=4), X2),
    "Mul": single(lambda L: L.Mul(), X2),
    "MulConstant": single(lambda L: L.MulConstant(-1.5), X2),
    "Narrow": single(lambda L: L.Narrow(1, 1, 3), X3),
    "Negative": single(lambda L: L.Negative(), X2),
    "Power": single(lambda L: L.Power(2.0, 0.5, 1.0), X2),
    "ResizeBilinear": single(lambda L: L.ResizeBilinear(5, 12), IMG),
    "Scale": single(lambda L: L.Scale(), X2),
    "Select": single(lambda L: L.Select(2, -1), X3),
    "SelectTable": multi(lambda L: L.SelectTable(1), (X2, X2 * 3)),
    "SoftShrink": single(lambda L: L.SoftShrink(0.3), X2),
    "SplitTensor": dict(build=lambda L, Input: (
        lambda i: ([i], list(L.SplitTensor(1, 3)(i))))(Input()),
        inputs=[X2]),
    "Sqrt": single(lambda L: L.Sqrt(), POS),
    "Square": single(lambda L: L.Square(), X2),
    "Squeeze": single(lambda L: L.Squeeze(1), X2[:, None, :]),
    "Threshold": single(lambda L: L.Threshold(0.1, -2.0), X2),
    # local
    "LocallyConnected1D": single(lambda L: L.LocallyConnected1D(
        3, 2, strides=2), X3),
    "LocallyConnected2D": single(lambda L: L.LocallyConnected2D(
        3, (2, 3), strides=(2, 1), activation="relu"), IMG),
    # convolutional recurrent
    "ConvLSTM2D": single(lambda L: L.ConvLSTM2D(3, (3, 3),
                                                return_sequences=True),
                         SEQ_IMG),
    "ConvLSTM3D": single(lambda L: L.ConvLSTM3D(2, 2), SEQ_VOL),
    # noise
    "GaussianDropout": single(lambda L: L.GaussianDropout(0.4), X2),
    "SpatialDropout1D": single(lambda L: L.SpatialDropout1D(0.4), X3),
    "SpatialDropout2D": single(lambda L: L.SpatialDropout2D(0.4), IMG),
    "SpatialDropout3D": single(lambda L: L.SpatialDropout3D(0.4), VOL),
}


def _exported(mod):
    """The classes and functions a package module defines and exports."""
    return sorted(n for n in dir(mod) if not n.startswith("_")
                  and (isinstance(getattr(mod, n), type)
                       or callable(getattr(mod, n)))
                  and getattr(getattr(mod, n), "__module__", "").startswith(
                      mod.__name__.rsplit(".keras", 1)[0]))


def test_every_exported_layer_has_a_case():
    assert _exported(JL) == _exported(PL)
    assert sorted(CASES) == _exported(JL)


def _outputs(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()) if want.size else 1.0)
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= tol * scale, f"{what}: max |diff| {err} > {tol} x {scale}"


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flat(dict(v), f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _graphs(case, tmp_path=None):
    """(JAX model, port model) of a case, built with both name scopes
    reset."""
    models = []
    for L, eng, M, kw in ((JL, jax_engine, JaxModel, {}),
                          (PL, port_engine, Model, {"device": "cpu"})):
        eng.reset_name_scope()
        if case.get("glove"):
            i = eng.Input()
            ins, out = [i], _glove(L, tmp_path)(i)
        else:
            ins, out = case["build"](L, eng.Input)
        models.append(M(ins, out, **kw))
    return models


@pytest.mark.parametrize("name", sorted(CASES))
def test_layer_matches_jax(name, tmp_path):
    _match_jax(name, CASES[name], tmp_path)


#: cases beyond one per class: options that take another route in the
#: port (a SimpleRNN of relu goes through torch's relu RNN, not the loop)
OPTION_CASES = {
    "SimpleRNN_relu": single(lambda L: L.SimpleRNN(
        4, activation="relu", return_sequences=True), X3),
}


@pytest.mark.parametrize("name", sorted(OPTION_CASES))
def test_layer_option_matches_jax(name, tmp_path):
    _match_jax(name, OPTION_CASES[name], tmp_path)


def test_relu_simple_rnn_runs_the_fused_rnn():
    port_engine.reset_name_scope()
    gm = Sequential([PL.SimpleRNN(4, activation="relu")],
                    device="cpu").to_torch().build(X3[:1])
    rnn = gm.simplernn_1
    assert rnn.activation is None and rnn.cell.nonlinearity == "relu"


def _match_jax(name, case, tmp_path):
    """The case's graph in both packages, on the JAX weights carried by
    `keras_from_flax`: eval outputs within `tol` (F32_OUT) and the
    gradients of the outputs' sum within `tol` (F32_GRAD), each of
    max(1, |JAX|)."""
    if case.get("read_glove"):
        path = tmp_path / "w2v.txt"
        path.write_text("3 2\nup 1 2\ndown -1 0.5\nleft 0.25 4\n")
        jv, jd = JL.read_glove_vectors(str(path))
        pv, pd = PL.read_glove_vectors(str(path))
        assert jd == pd == 2 and sorted(jv) == sorted(pv)
        for w in jv:
            np.testing.assert_array_equal(jv[w], pv[w])
        return
    tol = case.get("tol", F32_OUT)
    grad_tol = case.get("tol", F32_GRAD)
    jm, pm = _graphs(case, tmp_path)
    assert [l.name for l in jm.layers()] == [l.name for l in pm.layers()]
    xs = case["inputs"]
    fm = jm.to_flax()
    v = jax.jit(fm.init)({"params": jax.random.PRNGKey(0),
                          "dropout": jax.random.PRNGKey(1)}, *xs)
    params, stats = v.get("params", {}), v.get("batch_stats", {})
    want = _outputs(jax.jit(fm.apply)(v, *xs))

    gm = pm.to_torch().build(*[a[:1] for a in xs])
    gm.load_state_dict(keras_from_flax(gm, params, stats))
    gm.eval()
    txs = [torch.from_numpy(a) for a in xs]
    got = _outputs(gm(*txs))
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g.detach().float().numpy(), w, tol, f"{name} output {i}")

    if not jax.tree_util.tree_leaves(params):
        assert not list(gm.parameters()), name
        return

    def loss(p):
        outs = _outputs(fm.apply({**v, "params": p}, *xs))
        return sum(jnp.sum(o.astype(jnp.float32)) for o in outs)

    jgrads = _flat(jax.jit(jax.grad(loss))(params))
    sum(o.float().sum() for o in got).backward()
    sd = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
          for k, p in gm.named_parameters()}
    sd.update({k: b for k, b in gm.named_buffers()
               if k in gm.state_dict()})
    pgrads = _flat(keras_to_flax(gm, sd)[0])
    assert sorted(pgrads) == sorted(jgrads)
    for k in jgrads:
        _close(pgrads[k], jgrads[k], grad_tol, f"{name} grad {k}")


def test_layer_names_match_jax_across_a_graph():
    """Auto-names come out letter for letter as JAX's for the same graph
    built in the same order, counters shared across layers of a class
    and the operator sugar's ops and constants included."""
    names = []
    for L, eng, M, kw in ((JL, jax_engine, JaxModel, {}),
                          (PL, port_engine, Model, {"device": "cpu"})):
        eng.reset_name_scope()
        a, b = eng.Input(), eng.Input()
        h = L.Dense(4)(a) + L.Dense(4)(b) * 2.0
        h = 1.0 - L.Embedding(10, 4)(b)
        h = L.Add()([h, L.Maximum()([h, h]), L.Max(1)(h)])
        out = L.Concat()([L.Dense(2)(h), -h])
        m = M([a, b], out, **kw)
        names.append([l.name for l in m.layers()])
    assert names[0] == names[1]
    assert "sum_1" in names[1] and "max_2" in names[1], names[1]


# ----------------------------------------------------------------------
# random layers in training: statistics on a fixed generator
# ----------------------------------------------------------------------

N_DRAWS = 20000


def _train_out(layer, xs):
    """The port layer applied in training mode with a seeded generator."""
    gm = Sequential([layer], device="cpu") if len(xs) == 1 else None
    if gm is None:
        ins = [port_engine.Input() for _ in xs]
        gm = Model(ins, layer(ins), device="cpu")
    g = gm.to_torch().build(*[a[:1] for a in xs])
    g.train()
    gen = torch.Generator().manual_seed(123)
    return g(*[torch.from_numpy(a) for a in xs], generator=gen).numpy()


def _jax_train_out(layer, xs):
    ins = [jax_engine.Input() for _ in xs]
    out = layer(ins if len(xs) > 1 else ins[0])
    fm = JaxModel(ins, out).to_flax()
    v = fm.init({"params": jax.random.PRNGKey(0),
                 "dropout": jax.random.PRNGKey(1)}, *xs)
    return np.asarray(fm.apply(v, *xs, training=True,
                               rngs={"dropout": jax.random.PRNGKey(7)},
                               mutable=False))


def _within(stat, expect, se, what):
    assert abs(stat - expect) <= SIGMAS * se, \
        f"{what}: {stat} vs {expect} (se {se})"


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_dropout_keep_rate_in_training(pkg):
    x = np.ones((N_DRAWS // 100, 100), np.float32)
    rate = 0.3
    out = (_jax_train_out(JL.Dropout(rate), [x]) if pkg == "jax"
           else _train_out(PL.Dropout(rate), [x]))
    kept = out != 0
    _within(kept.mean(), 1 - rate, np.sqrt(rate * (1 - rate) / x.size),
            "keep rate")
    np.testing.assert_allclose(out[kept], 1 / (1 - rate), rtol=1e-6)


@pytest.mark.parametrize("pkg", ["jax", "port"])
@pytest.mark.parametrize("cls,shape,shared", [
    ("SpatialDropout1D", (50, 40, 8), (1,)),
    ("SpatialDropout2D", (20, 5, 6, 10), (1, 2)),
    ("SpatialDropout3D", (20, 3, 4, 5, 10), (1, 2, 3))])
def test_spatial_dropout_drops_whole_channels(pkg, cls, shape, shared):
    rate = 0.4
    x = np.ones(shape, np.float32)
    L = JL if pkg == "jax" else PL
    out = (_jax_train_out if pkg == "jax" else _train_out)(
        getattr(L, cls)(rate), [x])
    # one draw per (batch, channel), shared over the spatial axes
    assert np.all(out.max(axis=shared) == out.min(axis=shared))
    kept = out.mean(axis=shared) != 0
    _within(kept.mean(), 1 - rate, np.sqrt(rate * (1 - rate) / kept.size),
            "channel keep rate")


@pytest.mark.parametrize("pkg", ["jax", "port"])
@pytest.mark.parametrize("cls,arg", [("GaussianNoise", 0.5),
                                     ("GaussianDropout", 0.2)])
def test_gaussian_noise_moments_in_training(pkg, cls, arg):
    x = np.full((N_DRAWS // 100, 100), 2.0, np.float32)
    L = JL if pkg == "jax" else PL
    out = (_jax_train_out if pkg == "jax" else _train_out)(
        getattr(L, cls)(arg), [x])
    # GaussianNoise: 2 + 0.5 N; GaussianDropout: 2 (1 + sqrt(p/(1-p)) N)
    std = arg if cls == "GaussianNoise" else 2.0 * np.sqrt(arg / (1 - arg))
    n = x.size
    _within(out.mean(), 2.0, std / np.sqrt(n), "mean")
    _within(out.std(), std, std / np.sqrt(2 * n) * 1.5, "std")


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_rrelu_slopes_in_training(pkg):
    lower, upper = 0.1, 0.3
    x = np.full((N_DRAWS // 100, 100), -1.0, np.float32)
    L = JL if pkg == "jax" else PL
    out = (_jax_train_out if pkg == "jax" else _train_out)(
        L.RReLU(lower, upper), [x])
    slopes = -out
    assert slopes.min() >= lower - 1e-6 and slopes.max() <= upper + 1e-6
    se = (upper - lower) / np.sqrt(12 * slopes.size)
    _within(slopes.mean(), (lower + upper) / 2, se, "mean slope")


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_gaussian_sampler_moments_in_training(pkg):
    mean = np.full((N_DRAWS // 100, 100), 1.0, np.float32)
    log_var = np.full_like(mean, np.log(0.25))
    L = JL if pkg == "jax" else PL
    out = (_jax_train_out if pkg == "jax" else _train_out)(
        L.GaussianSampler(), [mean, log_var])
    n = mean.size
    _within(out.mean(), 1.0, 0.5 / np.sqrt(n), "mean")
    _within(out.std(), 0.5, 0.5 / np.sqrt(2 * n) * 1.5, "std")


def test_random_layer_in_training_needs_a_generator():
    g = Sequential([PL.GaussianNoise(0.1)], device="cpu").to_torch()
    g.build(X2[:1]).train()
    with pytest.raises(ValueError, match="Generator"):
        g(torch.from_numpy(X2))


def test_same_generator_state_draws_the_same():
    g = Sequential([PL.SpatialDropout1D(0.5)], device="cpu").to_torch()
    g.build(X3[:1]).train()
    outs = [g(torch.from_numpy(X3),
              generator=torch.Generator().manual_seed(5)) for _ in range(2)]
    assert torch.equal(*outs)


# ----------------------------------------------------------------------
# test_keras_layer_breadth.py and test_keras_layer_vocab_r4.py, on the
# port (plain forward passes, as those files' `_run`)
# ----------------------------------------------------------------------

def _run(layer_list, x, training=False):
    gm = Sequential(layer_list, device="cpu").to_torch().build(x[:1])
    gm.train(training)
    gen = torch.Generator().manual_seed(2) if training else None
    with torch.no_grad():
        return gm(torch.as_tensor(np.asarray(x)), generator=gen).numpy()


def test_advanced_activations():
    x = np.array([[-2.0, -0.5, 0.5, 2.0]], np.float32)
    assert np.allclose(_run([PL.LeakyReLU(0.1)], x),
                       [[-0.2, -0.05, 0.5, 2.0]])
    assert np.allclose(_run([PL.ThresholdedReLU(1.0)], x), [[0, 0, 0, 2.0]])
    assert np.allclose(_run([PL.PReLU()], x), [[-0.5, -0.125, 0.5, 2.0]])
    assert np.isfinite(_run([PL.SReLU()], x)).all()
    assert np.isfinite(_run([PL.ELU(1.0)], x)).all()


def test_elementwise_layers():
    x = np.array([[1.0, 4.0]], np.float32)
    assert np.allclose(_run([PL.Sqrt()], x), [[1.0, 2.0]])
    assert np.allclose(_run([PL.Square()], x), [[1.0, 16.0]])
    assert np.allclose(_run([PL.AddConstant(2.0)], x), [[3.0, 6.0]])
    assert np.allclose(_run([PL.MulConstant(0.5)], x), [[0.5, 2.0]])
    assert np.allclose(_run([PL.Negative()], x), [[-1.0, -4.0]])
    assert np.allclose(_run([PL.Power(2.0)], x), [[1.0, 16.0]])
    assert np.allclose(_run([PL.HardTanh()], np.array([[-3.0, 0.5]],
                                                      np.float32)),
                       [[-1.0, 0.5]])
    assert np.allclose(_run([PL.HardShrink(0.5)],
                            np.array([[0.3, 0.8]], np.float32)), [[0.0, 0.8]])
    assert np.allclose(_run([PL.SoftShrink(0.5)],
                            np.array([[0.3, 0.8]], np.float32)), [[0.0, 0.3]])
    for layer in (PL.Scale(), PL.CMul(), PL.CAdd()):
        assert np.allclose(_run([layer], x), x)


def test_shape_utility_layers():
    x = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    assert _run([PL.ExpandDim(1)], x).shape == (2, 1, 3, 4)
    assert _run([PL.Narrow(1, 1, 2)], x).shape == (2, 2, 4)
    assert _run([PL.Select(1, 0)], x).shape == (2, 4)
    sq = np.arange(8, dtype=np.float32).reshape(2, 1, 4)
    assert _run([PL.Squeeze(1)], sq).shape == (2, 4)


def test_masking_zeroes_padded_steps():
    x = np.ones((2, 3, 4), np.float32)
    x[0, 1] = 0.0
    out = _run([PL.Masking(0.0)], x)
    assert np.all(out[0, 1] == 0) and np.all(out[0, 0] == 1)


def test_maxout_and_locally_connected_shapes():
    x = np.random.default_rng(0).normal(size=(4, 6)).astype(np.float32)
    assert _run([PL.MaxoutDense(3, nb_feature=4)], x).shape == (4, 3)
    seq = np.random.default_rng(1).normal(size=(2, 10, 3)).astype(np.float32)
    assert _run([PL.LocallyConnected1D(5, kernel_size=3)], seq).shape == \
        (2, 8, 5)
    img = np.random.default_rng(2).normal(
        size=(2, 8, 8, 3)).astype(np.float32)
    assert _run([PL.LocallyConnected2D(4, kernel_size=3)], img).shape == \
        (2, 6, 6, 4)


def test_locally_connected_weights_unshared():
    x = np.zeros((1, 6, 2), np.float32)
    x[0, 0] = x[0, 3] = 1.0
    out = _run([PL.LocallyConnected1D(4, kernel_size=2)], x)
    assert not np.allclose(out[0, 0], out[0, 3])


def test_conv_lstm_shapes_and_gradient():
    x = np.random.default_rng(0).normal(size=(2, 4, 6, 6, 3)).astype(
        np.float32)
    assert _run([PL.ConvLSTM2D(5, kernel_size=(3, 3),
                               return_sequences=True)], x).shape == \
        (2, 4, 6, 6, 5)
    assert _run([PL.ConvLSTM2D(5, kernel_size=(3, 3))], x).shape == \
        (2, 6, 6, 5)
    v = np.random.default_rng(0).normal(size=(2, 3, 4, 5, 6, 2)).astype(
        np.float32)
    assert _run([PL.ConvLSTM3D(3, (2, 2, 2), return_sequences=True)],
                v).shape == (2, 3, 4, 5, 6, 3)
    gm = Sequential([PL.ConvLSTM3D(2, 2)], device="cpu").to_torch()
    gm.build(v[:1])
    (gm(torch.from_numpy(v)) ** 2).sum().backward()
    assert any(float(p.grad.abs().max()) > 0 for p in gm.parameters())


def test_noise_layers_train_vs_inference():
    x = np.ones((4, 8, 3), np.float32)
    assert np.allclose(_run([PL.SpatialDropout1D(0.5)], x), x)
    assert np.allclose(_run([PL.GaussianDropout(0.5)], x), x)
    out = _run([PL.SpatialDropout1D(0.5)], x, training=True)
    assert np.allclose(out.std(axis=1), 0.0)


def test_3d_pooling_padding_resize_shapes():
    vol = np.random.default_rng(0).normal(
        size=(2, 4, 4, 4, 3)).astype(np.float32)
    assert _run([PL.GlobalAveragePooling3D()], vol).shape == (2, 3)
    assert _run([PL.GlobalMaxPooling3D()], vol).shape == (2, 3)
    assert _run([PL.ZeroPadding3D(1)], vol).shape == (2, 6, 6, 6, 3)
    assert _run([PL.UpSampling3D((2, 2, 2))], vol).shape == (2, 8, 8, 8, 3)
    assert _run([PL.Cropping3D()], vol).shape == (2, 2, 2, 2, 3)
    assert _run([PL.Cropping1D((2, 3))], np.ones((2, 10, 3), np.float32)
                ).shape == (2, 5, 3)
    assert _run([PL.ResizeBilinear(8, 12)], np.ones((2, 4, 6, 3), np.float32)
                ).shape == (2, 8, 12, 3)


def test_word_embedding_frozen_and_from_word_index():
    table = np.asarray([[0, 0], [1.0, 2.0], [3.0, 4.0]], np.float32)
    out = _run([PL.WordEmbedding(table)], np.asarray([[1, 2, 0]]))
    np.testing.assert_allclose(out[0], [[1, 2], [3, 4], [0, 0]])
    we = PL.WordEmbedding.from_word_index({"cat": 1, "dog": 2},
                                          {"cat": [9.0, 9.0]}, dim=2)
    np.testing.assert_allclose(_run([we], np.asarray([[1, 2]]))[0],
                               [[9, 9], [0, 0]])
    # frozen: a buffer outside the state_dict, nothing to train
    gm = Sequential([PL.WordEmbedding(table)], device="cpu").to_torch()
    gm.build(np.asarray([[1]]))
    assert not list(gm.parameters()) and not gm.state_dict()


def test_atrous_and_shared_convolutions():
    x = np.random.default_rng(0).normal(size=(2, 16, 3)).astype(np.float32)
    assert _run([PL.AtrousConvolution1D(4, 3, atrous_rate=2)], x).shape == \
        (2, 12, 4)
    xi = np.random.default_rng(1).normal(size=(2, 10, 10, 3)).astype(
        np.float32)
    assert _run([PL.AtrousConvolution2D(4, 3, 3, atrous_rate=2)],
                xi).shape == (2, 6, 6, 4)
    assert _run([PL.ShareConvolution2D(4, 3, 3)], xi).shape == (2, 8, 8, 4)


def test_lrn_layers_golden():
    x = np.random.default_rng(0).normal(size=(2, 6, 6, 8)).astype(np.float32)
    out = _run([PL.LRN2D(alpha=1e-2, k=1.0, beta=0.75, n=3)], x)
    assert np.all(np.abs(out) <= np.abs(x) + 1e-6)
    assert np.all(np.sign(out) == np.sign(x))
    x1 = np.array([[[[2.0]]]], np.float32)
    assert np.allclose(_run([PL.LRN2D(alpha=0.5, k=1.0, beta=1.0, n=1)], x1),
                       2.0 / (1.0 + 0.5 * 4.0))
    assert np.allclose(_run([PL.WithinChannelLRN2D(size=3, alpha=9.0,
                                                   beta=1.0)], x1),
                       2.0 / (1.0 + 1.0 * 4.0))


def test_binary_threshold_mul_max_expand_getshape():
    x = np.array([[-1.0, 0.5, 2.0]], np.float32)
    assert np.allclose(_run([PL.BinaryThreshold(0.6)], x), [[0, 0, 1]])
    assert np.allclose(_run([PL.Mul()], x), x)
    xm = np.array([[[1.0, 5.0], [3.0, 2.0]]], np.float32)
    assert np.allclose(_run([PL.Max(dim=1)], xm), [[[3.0, 5.0]]])
    assert _run([PL.Expand((-1, 4, -1))], np.ones((2, 1, 3), np.float32)
                ).shape == (2, 4, 3)
    assert np.array_equal(_run([PL.GetShape()], np.ones((2, 1, 3),
                                                        np.float32)),
                          [2, 1, 3])


def test_split_tensor_select_table():
    x = np.arange(12, dtype=np.float32).reshape(2, 6)
    inp = port_engine.Input((6,))
    parts = PL.SplitTensor(dim=1, num_splits=3)(inp)
    assert len(parts) == 3
    m = Model(inp, PL.SelectTable(1)(list(parts)), device="cpu")
    assert np.allclose(m.predict(x, batch_size=2), x[:, 2:4])


def test_rrelu_modes():
    x = np.array([[-4.0, -1.0, 2.0]], np.float32)
    assert np.allclose(_run([PL.RReLU(0.1, 0.3)], x), [[-0.8, -0.2, 2.0]])
    out = _run([PL.RReLU(0.1, 0.3)], x, training=True)
    slopes = out[0, :2] / x[0, :2]
    assert out[0, 2] == 2.0
    assert np.all(slopes >= 0.1 - 1e-6) and np.all(slopes <= 0.3 + 1e-6)


def test_sparse_dense_ignores_padding():
    ids = np.array([[0, 3, -1], [1, -1, -1]], np.int32)
    vals = np.array([[1.0, 2.0, 99.0], [0.5, 99.0, 99.0]], np.float32)
    i1, i2 = port_engine.Input((3,)), port_engine.Input((3,))
    m = Model([i1, i2], PL.SparseDense(4, input_dim=6, name="sd")([i1, i2]),
              device="cpu")
    gm = m.to_torch().build(ids, vals)
    out = gm(torch.from_numpy(ids), torch.from_numpy(vals)).detach().numpy()
    w, b = gm.sd.kernel.detach().numpy(), gm.sd.bias.detach().numpy()
    np.testing.assert_allclose(out, np.stack([w[0] + 2 * w[3] + b,
                                              0.5 * w[1] + b]), atol=1e-5)


@pytest.mark.parametrize("combiner", ["sum", "mean", "sqrtn"])
def test_sparse_embedding_combiners(combiner):
    ids = np.array([[2, 5, -1], [7, -1, -1]], np.int32)
    inp = port_engine.Input((3,))
    m = Model(inp, PL.SparseEmbedding(10, 4, combiner=combiner,
                                      name="se")(inp), device="cpu")
    gm = m.to_torch().build(ids)
    out = gm(torch.from_numpy(ids)).detach().numpy()
    table = gm.se.embedding.detach().numpy()
    n0 = {"sum": 1.0, "mean": 2.0, "sqrtn": np.sqrt(2.0)}[combiner]
    np.testing.assert_allclose(out[0], (table[2] + table[5]) / n0, atol=1e-6)
    np.testing.assert_allclose(out[1], table[7], atol=1e-6)
