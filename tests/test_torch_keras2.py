"""The port's keras2 namespace (analytics_zoo_tpu_torch/keras2/): the
keras-2 signature adapters over the port's keras-1 layers.

The public names of `keras2` and `keras2.layers` equal the JAX
package's; each adapter class, built with keras-2 arguments, is held
against JAX's on the same weights (`convert.keras_from_flax`) and
seeded numpy inputs, outputs within 1e-5 of max(1, |JAX's|) (f32, the
same arithmetic summed in other orders); and the three tests of
`test_keras2.py` run on the port with their thresholds."""

import types

import numpy as np
import pytest
import torch

import jax

import analytics_zoo_tpu.keras2 as jax_keras2
from analytics_zoo_tpu.keras import engine as jax_engine
from analytics_zoo_tpu.keras2 import layers as J2
import analytics_zoo_tpu_torch.keras2 as port_keras2
from analytics_zoo_tpu_torch.convert import keras_from_flax
from analytics_zoo_tpu_torch.keras import engine as port_engine
from analytics_zoo_tpu_torch.keras.models import Sequential as K1Sequential
from analytics_zoo_tpu_torch.keras2 import Input, Model, Sequential
from analytics_zoo_tpu_torch.keras2 import layers as L2

TOL = 1e-5
CPU = dict(device="cpu")


@pytest.fixture(autouse=True)
def _no_persistent_compile_cache():
    """The JAX Estimator's predicts compile without `.jax_cache_tests`,
    as in `test_torch_estimator.py` (a program loaded back from the
    cache in a contended run has aborted a worker)."""
    from jax._src import compilation_cache

    prev = jax.config.jax_compilation_cache_dir
    jax.config.update("jax_compilation_cache_dir", None)
    compilation_cache.reset_cache()
    yield
    jax.config.update("jax_compilation_cache_dir", prev)
    compilation_cache.reset_cache()


def _public(mod):
    return {n for n in dir(mod) if not n.startswith("_")
            and not isinstance(getattr(mod, n), types.ModuleType)}


def test_public_names_match_jax():
    assert _public(jax_keras2) == _public(port_keras2) == {
        "Input", "Model", "Sequential"}
    assert "layers" in dir(jax_keras2) and "layers" in dir(port_keras2)
    assert _public(J2) == _public(L2)


_RNG = np.random.default_rng(0)
SEQ = _RNG.normal(size=(3, 12, 4)).astype(np.float32)
IMG = _RNG.normal(size=(2, 9, 8, 3)).astype(np.float32)

CASES = {
    "Dense": (lambda L: [L.Dense(units=5, activation="relu")], SEQ),
    "Dropout": (lambda L: [L.Dropout(rate=0.5)], SEQ),
    "Conv1D": (lambda L: [L.Conv1D(filters=3, kernel_size=3, strides=2,
                                   padding="same", dilation_rate=1)], SEQ),
    "Conv1D_dilated": (lambda L: [L.Conv1D(3, 2, dilation_rate=2,
                                           use_bias=False)], SEQ),
    "Conv2D": (lambda L: [L.Conv2D(filters=4, kernel_size=(3, 2),
                                   strides=(2, 1), padding="same")], IMG),
    "Activation": (lambda L: [L.Activation("sigmoid")], SEQ),
    "Flatten": (lambda L: [L.Flatten()], SEQ),
    "Cropping1D": (lambda L: [L.Cropping1D((1, 2))], SEQ),
    "LocallyConnected1D": (lambda L: [L.LocallyConnected1D(2, 3)], SEQ),
    "MaxPooling1D": (lambda L: [L.MaxPooling1D(2)], SEQ),
    "AveragePooling1D": (lambda L: [L.AveragePooling1D(3)], SEQ),
    "GlobalMaxPooling1D": (lambda L: [L.GlobalMaxPooling1D()], SEQ),
    "GlobalAveragePooling1D": (lambda L: [L.GlobalAveragePooling1D()], SEQ),
    "GlobalAveragePooling2D": (lambda L: [L.GlobalAveragePooling2D()], IMG),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_adapter_matches_jax(name):
    make, x = CASES[name]
    jax_engine.reset_name_scope()
    jm = jax_keras2.Sequential(make(J2))
    port_engine.reset_name_scope()
    pm = Sequential(make(L2), **CPU)
    assert [l.name for l in jm.layers()] == [l.name for l in pm.layers()]
    fm = jm.to_flax()
    v = fm.init(jax.random.PRNGKey(0), x)
    want = np.asarray(fm.apply(v, x))
    gm = pm.to_torch().build(x[:1])
    gm.load_state_dict(keras_from_flax(gm, v.get("params", {})))
    got = gm.eval()(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= TOL * max(1.0, np.abs(want).max())


@pytest.mark.parametrize("fn", ["maximum", "minimum", "average"])
def test_functional_merges_match_jax(fn):
    a = _RNG.normal(size=(3, 4)).astype(np.float32)
    b = _RNG.normal(size=(3, 4)).astype(np.float32)
    ja, jb = jax_engine.Input(), jax_engine.Input()
    want = jax_keras2.Model([ja, jb], getattr(J2, fn)([ja, jb])).predict(
        [a, b], batch_size=3)
    pa, pb = Input(), Input()
    got = Model([pa, pb], getattr(L2, fn)([pa, pb]), **CPU).predict(
        [a, b], batch_size=3)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6)


# ----------------------------------------------------------------------
# test_keras2.py on the port
# ----------------------------------------------------------------------

def test_keras2_mlp_trains():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(512, 8)).astype(np.float32)
    y = (x.sum(axis=1) > 0).astype(np.int32)
    m = Sequential([L2.Dense(16, activation="relu"), L2.Dropout(rate=0.0),
                    L2.Dense(2)], **CPU)
    assert isinstance(m, K1Sequential)  # one engine serves both namespaces
    m.compile(optimizer="adam", loss="sparse_categorical_crossentropy",
              metrics=["accuracy"])
    m.fit(x, y, batch_size=64, nb_epoch=40)
    acc = m.evaluate(x, y, batch_size=128)["accuracy"]
    assert acc > 0.85, acc


def test_keras2_conv_signatures():
    x = np.random.default_rng(0).normal(size=(2, 16, 3)).astype(np.float32)
    gm = Sequential([L2.Conv1D(4, 3, strides=2, padding="same")],
                    **CPU).to_torch().build(x)
    assert gm(torch.from_numpy(x)).shape == (2, 8, 4)
    xi = np.random.default_rng(1).normal(size=(2, 8, 8, 3)).astype(
        np.float32)
    gm = Sequential([L2.Conv2D(5, (3, 3), padding="valid"),
                     L2.GlobalAveragePooling2D()], **CPU).to_torch().build(xi)
    assert gm(torch.from_numpy(xi)).shape == (2, 5)


def test_keras2_merge_functional():
    a, b = Input((4,)), Input((4,))
    xa = np.full((3, 4), 2.0, np.float32)
    xb = np.full((3, 4), 1.0, np.float32)
    assert np.allclose(Model([a, b], L2.minimum([a, b]), **CPU).predict(
        [xa, xb], batch_size=3), 1.0)
    assert np.allclose(Model([a, b], L2.maximum([a, b]), **CPU).predict(
        [xa, xb], batch_size=3), 2.0)
    assert np.allclose(Model([a, b], L2.average([a, b]), **CPU).predict(
        [xa, xb], batch_size=3), 1.5)
