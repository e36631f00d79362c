"""The port's VAE (models/vae.py) and the engine's aux loss
(`aux_loss_weight`, orca/learn/spmd.py) held against the JAX package's
on the CPU, on the same weights and the same numpy inputs.

The VAE's eval forward, `decode` and `recon_bce` at the JAX defaults'
28x28x1 and at 27x27x3, where the encoder's "SAME" padding is (1, 1)
instead of (0, 1) and the decoder's 28x28 output is cropped.  The aux
loss on a plain module returning (predictions, per-example aux): one
epoch of 2 SGD steps with a ragged tail (10 rows at batch 6, so the
second step has 2 padding rows that the masked mean must drop), on the
DRAM and DEVICE stores, the port's module also under remat
(`torch.utils.checkpoint`).

Tolerances: 1e-5 absolute for f32 forwards, losses, aux terms and
parameters after the steps (the same f32 arithmetic in other orders)."""

import functools

import numpy as np
import pytest
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

import flax.linen as fnn
import jax

from analytics_zoo_tpu.common.context import OrcaContext as JaxContext
from analytics_zoo_tpu.models import VAE as JaxVAE
from analytics_zoo_tpu.orca.learn.estimator import Estimator as JaxEstimator
from analytics_zoo_tpu_torch import convert
from analytics_zoo_tpu_torch.common.context import OrcaContext
from analytics_zoo_tpu_torch.models import VAE
from analytics_zoo_tpu_torch.models.vae import transpose_padding
from analytics_zoo_tpu_torch.orca.learn import Estimator

TOL = 1e-5
ENC = (4, 8)
AUX_W = 0.3


@pytest.fixture(autouse=True)
def _stores():
    prev = OrcaContext.train_data_store, JaxContext.train_data_store
    yield
    OrcaContext.train_data_store, JaxContext.train_data_store = prev


def _images(shape, n, seed):
    return np.random.default_rng(seed).uniform(
        size=(n,) + shape).astype(np.float32)


ODD = (27, 27, 3)


@functools.lru_cache(maxsize=None)
def _vae(shape):
    """(JAX module, its params, the port's VAE) at an image shape (the
    JAX default 28x28x1, the odd 27x27x3), made once a process on first
    use."""
    jm = JaxVAE(image_shape=shape, enc_features=ENC)
    p = jax.tree_util.tree_map(np.array, jm.init(
        jax.random.PRNGKey(0), _images(shape, 2, 0))["params"])
    m = VAE(image_shape=shape, enc_features=ENC, device="cpu").eval()
    m.load_state_dict(convert.vae_from_flax(p))
    return jm, p, m


@pytest.mark.parametrize("shape", [(28, 28, 1), ODD],
                         ids=["28x28x1", "27x27x3"])
def test_eval_forward_and_step_match_jax(shape):
    """The eval forward (recon, kl), and one SGD step of the ELBO (summed
    BCE + beta * KL, batch means) at the posterior mean (no noise: JAX's
    draws cannot be replayed in torch), from one JAX program.  The
    output bias is moved off 0: at init a pixel that no live unit
    reaches has a logit of exactly 0, where autograd through JAX's BCE
    terms is 0.5 off the derivative (the port's `recon_bce` docstring)."""
    jm, p, _ = _vae(shape)
    p = jax.tree_util.tree_map(np.copy, p)
    p["dec_out"]["bias"] += np.float32(0.25)
    x = _images(shape, 5, 1)
    jest, lr, beta = jm.estimator(), 0.01, 0.5

    def loss(params):
        recon, kl = jm.apply({"params": params}, x)
        return jest._loss(recon, (x,)).mean() + beta * kl.mean(), (recon, kl)
    (_, (want_r, want_kl)), grads = jax.jit(
        jax.value_and_grad(loss, has_aux=True))(p)
    m = VAE(image_shape=shape, enc_features=ENC, device="cpu").eval()
    m.load_state_dict(convert.vae_from_flax(p))
    xt = torch.from_numpy(x)
    got_r, got_kl = m(xt)
    assert got_r.shape == (5, int(np.prod(shape))) and got_kl.shape == (5,)
    np.testing.assert_allclose(got_r.detach().numpy(), np.asarray(want_r),
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(got_kl.detach().numpy(), np.asarray(want_kl),
                               rtol=0, atol=TOL)
    (m.recon_bce(got_r, (xt,)).mean() + beta * got_kl.mean()).backward()
    torch.optim.SGD(m.parameters(), lr=lr).step()
    want = jax.tree_util.tree_map(lambda a, g: np.asarray(a - lr * g), p,
                                  grads)
    for a, b in zip(jax.tree_util.tree_leaves(convert.vae_to_flax(
            m.state_dict())), jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL)


@pytest.mark.parametrize("shape", [(28, 28, 1), ODD],
                         ids=["28x28x1", "27x27x3"])
def test_decode_and_recon_bce_match_jax(shape):
    jm, p, m = _vae(shape)
    z = np.random.default_rng(2).normal(size=(4, 2)).astype(np.float32)
    want = np.asarray(jm.apply({"params": p}, z, method=JaxVAE.decode))
    got = m.decode(torch.from_numpy(z)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    jest = jm.estimator()
    x = _images(shape, 4, 3)
    logits = np.random.default_rng(4).normal(
        0, 5, (4, int(np.prod(shape)))).astype(np.float32)
    np.testing.assert_allclose(
        m.recon_bce(torch.from_numpy(logits), (torch.from_numpy(x),)).numpy(),
        np.asarray(jest._loss(logits, (x,))), rtol=1e-6, atol=TOL)
    # at a logit of exactly 0 the gradient is sigmoid(0) - target
    zero = torch.zeros(4, int(np.prod(shape)), requires_grad=True)
    m.recon_bce(zero, (torch.from_numpy(x),)).sum().backward()
    np.testing.assert_allclose(zero.grad.numpy(), 0.5 - x.reshape(4, -1),
                               rtol=0, atol=1e-7)
    for a, b in zip(jax.tree_util.tree_leaves(convert.vae_to_flax(
            m.state_dict())), jax.tree_util.tree_leaves(p)):
        np.testing.assert_array_equal(a, b)


def test_transpose_padding_is_lax_rule():
    from jax._src.lax.convolution import _conv_transpose_padding
    for k in (1, 2, 3, 4, 5):
        for s in (1, 2, 3):
            assert transpose_padding(k, s) == \
                _conv_transpose_padding(k, s, "SAME")


def test_vae_trains_generates_and_reconstructs():
    shape = ODD
    m = VAE(image_shape=shape, enc_features=ENC, beta=0.5, device="cpu")
    x = _images(shape, 20, 5)
    est = m.estimator()
    assert est.engine.aux_loss_weight == 0.5
    m.fit({"x": x, "y": x}, epochs=2, batch_size=8)
    row = est.train_summary[-1]
    assert np.isfinite(row["loss"]) and row["aux_loss"] > 0
    ev = m.evaluate({"x": x, "y": x}, batch_size=8)
    assert set(ev) == {"loss", "aux_loss"}
    imgs = m.generate(6, seed=1)
    assert imgs.shape == (6,) + shape and imgs.min() >= 0 and imgs.max() <= 1
    np.testing.assert_array_equal(imgs, m.generate(6, seed=1))
    np.testing.assert_array_equal(
        imgs, m.generate(6, seed=1, params=m.state_dict()))
    rec = m.reconstruct(x[:5])
    assert rec.shape == (5,) + shape
    np.testing.assert_array_equal(rec, m.reconstruct(x[:5]))
    # training draws its noise from the generator: two same-seeded
    # training forwards agree, eval (the posterior mean) differs
    outs = [m.train()(torch.from_numpy(x[:3]),
                      generator=torch.Generator().manual_seed(7))[0]
            for _ in range(2)]
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], m.eval()(torch.from_numpy(x[:3]))[0])


# ----------------------------------------------------------------------
# the engine's aux loss
# ----------------------------------------------------------------------

class _JaxAuxNet(fnn.Module):
    @fnn.compact
    def __call__(self, x):
        h = fnn.Dense(3, name="dense")(x)
        return h, (h ** 2).sum(-1)


class _AuxNet(nn.Module):
    def __init__(self, remat: bool):
        super().__init__()
        self.remat = remat
        self.dense = nn.Linear(4, 3)

    def forward(self, x):
        h = checkpoint(self.dense, x, use_reentrant=False) if self.remat \
            else self.dense(x)
        return h, (h ** 2).sum(-1)


def _aux_data():
    rng = np.random.default_rng(8)
    x = rng.normal(size=(10, 4)).astype(np.float32)
    return x, rng.integers(0, 3, 10).astype(np.int32)


@pytest.fixture(scope="module")
def aux_init():
    x, _ = _aux_data()
    return jax.tree_util.tree_map(np.array, _JaxAuxNet().init(
        jax.random.PRNGKey(9), x)["params"])


@pytest.fixture(scope="module")
def jax_aux_runs(aux_init):
    """{store: (train_summary row, evaluate, params)} of JAX's
    Estimator."""
    x, y = _aux_data()
    out = {}
    prev = JaxContext.train_data_store
    try:
        for store in ("DRAM", "DEVICE"):
            JaxContext.train_data_store = store
            est = JaxEstimator.from_flax(
                _JaxAuxNet(), loss="sparse_categorical_crossentropy",
                optimizer="sgd", learning_rate=0.1, metrics=[],
                aux_loss_weight=AUX_W)
            est.set_params(aux_init)
            est.fit({"x": x, "y": y}, epochs=1, batch_size=6, shuffle=False)
            ev = est.evaluate({"x": x, "y": y}, batch_size=6)
            out[store] = (est.train_summary[-1], ev, jax.tree_util.tree_map(
                np.array, est.get_model()))
    finally:
        JaxContext.train_data_store = prev
    return out


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("store", ["DRAM", "DEVICE"])
def test_aux_loss_matches_the_jax_estimator(aux_init, jax_aux_runs, store,
                                            remat):
    x, y = _aux_data()
    want_row, want_ev, want_params = jax_aux_runs[store]
    OrcaContext.train_data_store = store
    m = _AuxNet(remat)
    m.load_state_dict({"dense.weight": torch.from_numpy(
        aux_init["dense"]["kernel"].T.copy()),
        "dense.bias": torch.from_numpy(aux_init["dense"]["bias"])})
    est = Estimator.from_torch(m, loss="sparse_categorical_crossentropy",
                               optimizer="sgd", learning_rate=0.1, metrics=[],
                               aux_loss_weight=AUX_W)
    est.fit({"x": x, "y": y}, epochs=1, batch_size=6, shuffle=False)
    row = est.train_summary[-1]
    steps = est.engine.last_steps
    assert len(steps) == 2 and steps[1]["_count"] == 4.0
    for key in ("loss", "aux_loss"):
        np.testing.assert_allclose(row[key], want_row[key], rtol=0, atol=TOL)
    np.testing.assert_allclose(m.dense.weight.detach().numpy().T,
                               want_params["dense"]["kernel"], atol=TOL)
    np.testing.assert_allclose(m.dense.bias.detach().numpy(),
                               want_params["dense"]["bias"], atol=TOL)
    ev = est.evaluate({"x": x, "y": y}, batch_size=6)
    assert set(ev) == {"loss", "aux_loss"}
    for key in ev:
        np.testing.assert_allclose(ev[key], want_ev[key], rtol=0, atol=TOL)
    # predict drops the aux term
    pred = est.predict({"x": x}, batch_size=6)
    assert isinstance(pred, np.ndarray) and pred.shape == (10, 3)


def test_aux_loss_is_the_masked_mean_of_the_real_rows(aux_init):
    """The first step's objective is loss + w * mean(aux over the real
    rows): a padded row (zeros in, the bias's aux out) never counts."""
    x, y = _aux_data()
    m = _AuxNet(False)
    est = Estimator.from_torch(m, loss="sparse_categorical_crossentropy",
                               optimizer="sgd", learning_rate=0.0, metrics=[],
                               aux_loss_weight=AUX_W)
    with torch.no_grad():
        m.dense.bias.fill_(3.0)
    est.fit({"x": x[:4], "y": y[:4]}, epochs=1, batch_size=6, shuffle=False)
    with torch.no_grad():
        h = m.dense(torch.from_numpy(x[:4]))
    want = float((h ** 2).sum(-1).mean())
    np.testing.assert_allclose(est.engine.last_steps[0]["aux_loss"], want,
                               rtol=1e-6)
